"""Self-calibration gram kernels: CUDA wrappers and their plain twins.

Counterpart of the self-calibration part of
``pycamset_tpu/optim/pallas_grams.py``, for the chain Projection +
Extrinsic3D + RigidTform3d + FreePoint (the K target points are unknowns
beside the cameras and the poses). Two hand-written Hopper kernels replace
its two Pallas kernels: the key width 3 instantiation of the multi-target
kernels of ``csrc/mixed_grams.cu`` (the free point's three columns, no
group pose), built at the five camera models' widths as the JAX kernels
are (``TEMPLATE_WIDTHS``: a = 15 standard, entry points
``pct_selfcal_gram{,_fused}``; a = 14 fisheye, 18 rational, 22 thin-prism,
24 tilted through ``pct_selfcal_gram{,_fused}_model``):

- Kernel C, ``selfcal_gram_fused`` <- ``make_pallas_selfcal_grams_fused``:
  hcc, gc and the point couplings wck = Jc^T Jk summed over each camera's
  images; per block wik = Ji^T Jk, wci, gii, gi and the cost; hkk = Jk^T Jk
  and gk = Jk^T r over all blocks. The pose columns see imask in the kernel;
  the camera columns are masked after the reduction, by the builder.
- Kernel D, ``selfcal_gram`` <- ``make_pallas_selfcal_grams``: the per-block
  extended gram (W x W, W = a + 7) with every camera and pose column masked
  in the kernel, the per-(block, key) couplings wck_b and wik_b, and
  hkk/gk over all blocks.

Each wrapper takes the same tensors on either device. A CPU tensor runs the
plain PyTorch twin (``selfcal_gram_plain``, ``selfcal_gram_fused_plain``:
``analytic.block_rj_selfcal``, ``losses.irls_weigh`` and batched products).
A CUDA tensor launches the kernel or raises: there is no fallback, and a
camera width outside ``TEMPLATE_WIDTHS`` raises. Each wrapper counts its
launches in ``<wrapper>.launches``, and by camera width in
``<wrapper>.launches_by_width``.

The builders ``make_cuda_selfcal_grams`` and ``make_cuda_selfcal_grams_fused``
keep the JAX builders' contracts (the 10-tuple of ``make_block_grams``, and
the ten reduced NormalEq fields), at each of those widths.

``scaled_errors_selfcal`` and ``scaled_errors_selfcal_fused`` hold a
kernel's outputs against its twin's entry by entry, in the Jacobi scaling
the solver applies.

The pose-free free-point chain (Projection + Extrinsic3D + FreePoint: b = 0,
c = 3) has no kernel of its own, as in the JAX package: its two wrappers
run C and D with identity poses (``im_b`` zeros: Rp = I, tp = 0) and every
pose column masked, and strip the zero-width pose outputs, as
``make_pallas_freepoint_grams`` (``pallas_grams.py:1113``) and
``make_pallas_freepoint_grams_fused`` (``:1147``) reach ``pl.pallas_call``
only through D's and C's Pallas twins:

- ``freepoint_gram`` (over Kernel D): per block gcc_b, gc_b and the cost,
  the per-(block, key) couplings wck_b, and hkk/gk over all blocks;
- ``freepoint_gram_fused`` (over Kernel C): hcc, gc and wck summed over
  each camera's images, per-block costs, hkk and gk.

Their plain twins (``freepoint_gram_plain``, ``freepoint_gram_fused_plain``)
are the self-cal twins at identity poses. Both wrappers go through the
self-cal operators (``pycamset_tpu_torch::selfcal_gram{,_fused}``), so under
``torch.func.vmap`` (the free-point fleet) R rigs fold into one launch as
the self-cal fleet's do; each wrapper counts its own launches (not in the
self-cal wrappers' counts: ``_counted_as``). The kernels still compute,
and D and C still write, the pose columns and C's per-block wik, which the
wrappers discard; ``scaled_errors_freepoint{,_fused}`` hold the kept
outputs in the Jacobi scaling.
"""
from __future__ import annotations

import contextlib

import torch
from torch import Tensor

from pycamset_tpu_torch.optim.cuda_grams import (
    NO_KERNEL_WIDTH, TEMPLATE_WIDTHS, _check_cuda_inputs, _jacobi_scale,
    _loss_args, _ptr, _raise_on, _rig_entry, _worst, pack_block_params,
    reduce_grams, scaled_errors, scaled_errors_fused)

SELFCAL_CHUNK = 10    # images of one camera per thread block in Kernel C
SELFCAL_CHUNK_D = 6   # blocks per thread block in Kernel D
KEY_TILE = 128        # keys per thread block (csrc NT)


def gram_entries(a: int) -> int:
    """The (a + 7)-wide extended gram's upper-triangle entries: 253 at the
    standard model's a = 15."""
    return (a + 7) * (a + 8) // 2


def _check_widths(widths, b: int = 6):
    """The self-calibration chain (b=6, c=3), or with ``b=0`` the pose-free
    free-point chain (b=0, c=3), at a camera width a in
    ``TEMPLATE_WIDTHS``."""
    if (widths.b, widths.c) != (b, 3) or widths.a not in TEMPLATE_WIDTHS:
        chain = "self-calibration" if b else "free-point"
        raise NotImplementedError(
            f"widths {widths} have no kernel: the self-cal kernels serve "
            f"the {chain} chain (b={b}, c=3) at the camera widths "
            f"{TEMPLATE_WIDTHS}; {NO_KERNEL_WIDTH}")


def selfcal_gram_plain(cam_b, im_b, keyp, uv, mask, cmask_b, imask_b, kmask,
                       loss: str = "linear", f_scale: float = 1.0,
                       loss_semantics: str = "component"):
    """Plain twin of Kernel D.

    :return: (g (B, W, W) extended grams of [Jc | Ji | r], W = a + 7,
        IRLS-weighted rows, camera columns masked by cmask_b and pose
        columns by imask_b, corner = the block's (robust) cost;
        wck_b (B, K, a, 3); wik_b (B, K, 6, 3); hkk (K, 3, 3); gk (K, 3)),
        Jk masked by kmask.
    """
    from pycamset_tpu_torch.optim.analytic import block_rj_selfcal
    return weighted_grams(*block_rj_selfcal(cam_b, im_b, keyp, uv), mask,
                          cmask_b, imask_b, kmask, loss, f_scale,
                          loss_semantics)


def weighted_grams(r, jc, ji, jk, mask, cmask_b, imask_b, kmask,
                   loss: str = "linear", f_scale: float = 1.0,
                   loss_semantics: str = "component"):
    """The per-block grams of a chain with key columns, from its closed-form
    (r, Jc, Ji, Jk) over the (B, K) grid: IRLS-weighted rows, the camera,
    pose and key columns masked, the extended (B, W, W) gram (W = a + b + 1)
    with the (robust) cost in its corner, and the key couplings (the
    outputs of ``selfcal_gram_plain``, with c = Jk's width)."""
    from pycamset_tpu_torch.optim.losses import irls_weigh
    r, sw, cost_b = irls_weigh(r, mask, loss, f_scale, loss_semantics)
    jc = jc * sw[..., None] * cmask_b[:, None, None, :]
    ji = ji * sw[..., None] * imask_b[:, None, None, :]
    jk = jk * sw[..., None] * kmask[None, :, None, :]
    ext = torch.cat([jc, ji, r[..., None]], dim=-1)
    gw = ext.shape[-1]
    ext = ext.reshape(ext.shape[0], -1, gw)
    g = ext.transpose(1, 2) @ ext
    g[:, gw - 1, gw - 1] = cost_b
    return (g, torch.einsum("bkti,bktj->bkij", jc, jk),
            torch.einsum("bkti,bktj->bkij", ji, jk),
            torch.einsum("bkti,bktj->kij", jk, jk),
            torch.einsum("bkti,bkt->ki", jk, r))


def selfcal_gram_fused_plain(cam_b, im_b, keyp, uv, mask, imask_b, kmask,
                             n_cams: int, n_ims: int, loss: str = "linear",
                             f_scale: float = 1.0,
                             loss_semantics: str = "component"):
    """Plain twin of Kernel C: Kernel D's twin with no camera mask, reduced.

    :return: (hcc (C,a,a), gc (C,a), wck (C,K,a,3), wik_b (B,K,6,3),
        wci (B,a,6), gii (B,6,6), gi (B,6), corner (B,), hkk (K,3,3),
        gk (K,3)).
    """
    ones = cam_b.new_ones(cam_b.shape)
    g, wck_b, wik_b, hkk, gk = selfcal_gram_plain(
        cam_b, im_b, keyp, uv, mask, ones, imask_b, kmask, loss, f_scale,
        loss_semantics)
    hcc, gc, wci, gii, gi, corner = reduce_grams(g, n_cams, n_ims)
    wck = wck_b.reshape((n_cams, n_ims) + wck_b.shape[1:]).sum(dim=1)
    return hcc, gc, wck, wik_b, wci, gii, gi, corner, hkk, gk


def _key_errors(hkk, gk, ref_hkk, ref_gk, cost) -> dict:
    """hkk in its own diagonal's scaling, gk by sqrt(hkk_pp cost)."""
    s_k = _jacobi_scale(torch.diagonal(ref_hkk, dim1=1, dim2=2))
    return {"hkk": _worst((hkk - ref_hkk) / (s_k[:, :, None]
                                             * s_k[:, None, :])),
            "gk": _worst((gk - ref_gk) / (s_k * torch.sqrt(cost)))}


def scaled_errors_selfcal(got, ref) -> dict:
    """Worst error of Kernel D's outputs against reference outputs, per
    piece, in the Jacobi scaling: the gram as ``cuda_grams.scaled_errors``;
    wck_b by sqrt(gcc_ii hkk_pp) and wik_b by sqrt(gii_bb hkk_pp), with the
    block's own gram diagonal; hkk and gk as ``_key_errors``."""
    ref = [r.double() for r in ref]
    got = [g.double().to(r.device) for g, r in zip(got, ref)]
    out = scaled_errors(got[0], ref[0])
    a = ref[0].shape[-1] - 7
    s_b = _jacobi_scale(torch.diagonal(ref[0], dim1=1, dim2=2))
    s_k = _jacobi_scale(torch.diagonal(ref[3], dim1=1, dim2=2))
    out["wck"] = _worst((got[1] - ref[1]) / (s_b[:, None, :a, None]
                                             * s_k[None, :, None, :]))
    out["wik"] = _worst((got[2] - ref[2]) / (s_b[:, None, a:a + 6, None]
                                             * s_k[None, :, None, :]))
    out.update(_key_errors(got[3], got[4], ref[3], ref[4],
                           ref[0][:, -1, -1].sum()))
    return out


def scaled_errors_selfcal_fused(got, ref, ref_gram: torch.Tensor,
                                n_cams: int, n_ims: int) -> dict:
    """Worst error of Kernel C's outputs against reference outputs, per
    output, in the Jacobi scaling: hcc, gc and the per-block pose pieces as
    ``cuda_grams.scaled_errors_fused`` (``ref_gram``: the reference (B, W,
    W) grams of the same inputs, camera columns unmasked); wck by
    sqrt(hcc_ii hkk_pp) with the camera's reduced diagonal; wik by
    sqrt(gii_bb hkk_pp) with the block's; hkk and gk as ``_key_errors``."""
    ref = [r.double() for r in ref]
    got = [g.double().to(r.device) for g, r in zip(got, ref)]
    (hcc, gc, wck, wik, wci, gii, gi, corner, hkk, gk) = got
    (r_hcc, r_gc, r_wck, r_wik, r_wci, r_gii, r_gi, r_corner, r_hkk,
     r_gk) = ref
    out = scaled_errors_fused((hcc, gc, wci, gii, gi, corner),
                              (r_hcc, r_gc, r_wci, r_gii, r_gi, r_corner),
                              ref_gram, n_cams, n_ims)
    s_c = _jacobi_scale(torch.diagonal(r_hcc, dim1=1, dim2=2))
    s_b = _jacobi_scale(torch.diagonal(ref_gram.double(), dim1=1, dim2=2))
    s_k = _jacobi_scale(torch.diagonal(r_hkk, dim1=1, dim2=2))
    a = r_hcc.shape[-1]
    out["wck"] = _worst((wck - r_wck) / (s_c[:, None, :, None]
                                         * s_k[None, :, None, :]))
    out["wik"] = _worst((wik - r_wik) / (s_b[:, None, a:a + 6, None]
                                         * s_k[None, :, None, :]))
    out.update(_key_errors(hkk, gk, r_hkk, r_gk, r_corner.sum()))
    return out


# the wrapper whose counters an operator's launch adds to (None: the
# operator's own wrapper; the free-point wrappers set themselves)
_COUNT_AS = [None]


@contextlib.contextmanager
def _counted_as(wrapper):
    """Launches of the self-cal operators inside count as ``wrapper``'s."""
    _COUNT_AS[0] = wrapper
    try:
        yield
    finally:
        _COUNT_AS[0] = None


def _count(own, width: int):
    """One launch at camera width ``width``, on ``own``'s counters or the
    wrapper's that ``_counted_as`` names."""
    wrapper = _COUNT_AS[0] or own
    wrapper.launches += 1
    wrapper.launches_by_width[width] += 1


def _empty_like_grid(mask):
    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=mask.device)
    return empty


def _grid_dims(mask, group: int, chunk: int):
    k = mask.shape[1]
    if k == 0:
        raise ValueError("the key-column gram kernels need at least one "
                         "key")
    return k, -(-k // KEY_TILE), -(-group // chunk)


def selfcal_gram(cam_b, im_b, keyp, uv, mask, cmask_b, imask_b, kmask,
                 loss: str = "linear", f_scale: float = 1.0,
                 loss_semantics: str = "component"):
    """Kernel D: (g (B,W,W), wck_b (B,K,a,3), wik_b (B,K,6,3),
    hkk (K,3,3), gk (K,3)), the outputs of ``selfcal_gram_plain``.

    :param cam_b: (B, a), a in ``TEMPLATE_WIDTHS``. :param im_b: (B, 6).
        :param keyp: (K, 3) free points. :param uv: (B, K, 2).
        :param mask: (B, K). :param cmask_b: (B, a). :param imask_b: (B, 6).
        :param kmask: (K, 3).

    Under ``torch.func.vmap`` over a leading rig axis (the fleet) the R
    rigs fold into ONE launch (``_fold_rig_operands``): R rigs' blocks,
    rig-major, and their free points and key masks, each rig's outputs
    those of a launch of its own.
    """
    g, wck_b, wik_b, hkk, gk = _selfcal_gram_op(
        cam_b, im_b, keyp[None], uv, mask, cmask_b, imask_b, kmask[None],
        loss, float(f_scale), loss_semantics)
    return g, wck_b, wik_b, hkk[0], gk[0]


selfcal_gram.launches = 0
selfcal_gram.launches_by_width = dict.fromkeys(TEMPLATE_WIDTHS, 0)


def _fold_rig_operands(r: int, in_dims, *xs):
    """The operands of R rigs with their rig axis folded into each one's
    leading axis, rig-major: (R, N, ...) -> (R*N, ...), contiguous. A
    per-key operand arrives as (1, K, ...) a rig (the wrappers add the
    axis), so it folds to (R, K, ...). An operand that arrives without a
    rig axis is every rig's."""
    out = []
    for x, d in zip(xs, in_dims):
        x = x.expand(r, *x.shape) if d is None else x.movedim(d, 0)
        out.append(x.reshape(r * x.shape[1], *x.shape[2:]).contiguous())
    return out


def _unfold_rigs(r: int, outs) -> tuple:
    """(R*N, ...) outputs -> (R, N, ...), each with its rig axis at 0."""
    return tuple(x.reshape(r, x.shape[0] // r, *x.shape[1:]) for x in outs)


def _rig_rows(n_rigs: int, r: int, *xs) -> tuple:
    """Rig r's rows of (R*N, ...) operands held rig-major."""
    return tuple(x.reshape(n_rigs, -1, *x.shape[1:])[r] for x in xs)


def _per_rig(n_rigs: int, one) -> tuple:
    """A plain twin over R rigs, rig by rig (``one(r)``: rig r's outputs).
    The outputs' rows are concatenated rig-major, but for the last two,
    the per-key hkk and gk ((K, ...) a rig), which stack to (R, K, ...).
    The outputs are copies (an operator's outputs may not alias each
    other)."""
    runs = [one(r) for r in range(n_rigs)]
    n_out = len(runs[0])
    return tuple(torch.cat([run[j] for run in runs]) if j < n_out - 2
                 else torch.stack([run[j] for run in runs])
                 for j in range(n_out))


def _check_rig_operands(cam_b, im_b, keyp, uv, mask, kmask, **masks):
    """Raise unless a kernel takes these R rigs' tensors as they are: keyp
    and kmask (R, K, 3) with R rigs' blocks in the others (the one-rig
    checks of ``_check_cuda_inputs`` on rig 0's slices)."""
    n_rigs = keyp.shape[0]
    if kmask.shape[0] != n_rigs or mask.shape[0] % n_rigs:
        raise ValueError(f"{mask.shape[0]} blocks and {kmask.shape[0]} key "
                         f"masks for {n_rigs} rigs")
    for name, x in (("keyp", keyp), ("kmask", kmask)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    bb = mask.shape[0] // n_rigs
    _check_cuda_inputs(cam_b[:bb], im_b[:bb], keyp[0], uv[:bb], mask[:bb],
                       kmask=kmask[0], **{k: v[:bb] for k, v in
                                          masks.items()})
    for name, x in (("cam_b", cam_b), ("im_b", im_b), ("uv", uv),
                    *masks.items()):
        if x.shape[0] != mask.shape[0]:
            raise ValueError(f"{name} has {x.shape[0]} blocks, mask "
                             f"{mask.shape[0]}")


@torch.library.custom_op("pycamset_tpu_torch::selfcal_gram",
                         mutates_args=())
def _selfcal_gram_op(cam_b: Tensor, im_b: Tensor, keyp: Tensor, uv: Tensor,
                     mask: Tensor, cmask_b: Tensor, imask_b: Tensor,
                     kmask: Tensor, loss: str, f_scale: float,
                     loss_semantics: str) -> tuple[Tensor, Tensor, Tensor,
                                                   Tensor, Tensor]:
    """Kernel D over R rigs: keyp and kmask (R, K, 3), the others R rigs'
    blocks, rig-major -> (g (R B, W, W), wck_b (R B, K, a, 3), wik_b (R B,
    K, 6, 3), hkk (R, K, 3, 3), gk (R, K, 3))."""
    n_rigs = keyp.shape[0]
    if cam_b.device.type == "cpu":
        return _per_rig(n_rigs, lambda r: selfcal_gram_plain(
            *_rig_rows(n_rigs, r, cam_b, im_b), keyp[r],
            *_rig_rows(n_rigs, r, uv, mask, cmask_b, imask_b), kmask[r],
            loss, f_scale, loss_semantics))
    loss_id, component = _loss_args(loss, loss_semantics)
    _check_rig_operands(cam_b, im_b, keyp, uv, mask, kmask, cmask_b=cmask_b,
                        imask_b=imask_b)
    with torch.cuda.device(cam_b.device):
        out = _launch_selfcal(pack_block_params(cam_b, im_b), keyp, uv, mask,
                              cmask_b, imask_b, kmask, loss_id, component,
                              f_scale, cam_b.shape[1] - 6)
    _count(selfcal_gram, cam_b.shape[1])
    return out


@_selfcal_gram_op.register_vmap
def _selfcal_gram_vmap(info, in_dims, cam_b, im_b, keyp, uv, mask, cmask_b,
                       imask_b, kmask, loss, f_scale, loss_semantics):
    r = info.batch_size
    out = _selfcal_gram_op(*_fold_rig_operands(
        r, in_dims[:8], cam_b, im_b, keyp, uv, mask, cmask_b, imask_b,
        kmask), loss, f_scale, loss_semantics)
    return _unfold_rigs(r, out), (0,) * len(out)


def _launch_selfcal(packed, keyp, uv, mask, cmask_b, imask_b, kmask, loss_id,
                    component, f_scale, intr_w: int = 9):
    """Allocate Kernel D's outputs and scratch and launch its two passes on
    the current stream (inputs already checked; ``packed`` from
    pack_block_params at ``intr_w``). ``keyp`` and ``kmask`` (K, 3) for one
    rig, or (R, K, 3) for R rigs whose blocks the others hold rig-major:
    one launch, hkk and gk then (R, K, ...)."""
    from pycamset_tpu_torch._build import load
    n_rigs = keyp.shape[0] if keyp.dim() == 3 else 1
    bb = mask.shape[0] // n_rigs
    a = intr_w + 6
    gw = a + 7
    chunk = SELFCAL_CHUNK_D
    k, n_tiles, n_chunks = _grid_dims(mask, bb, chunk)
    rb = n_rigs * bb
    empty = _empty_like_grid(mask)
    g, wck, wik = empty(rb, gw, gw), empty(rb, 3 * a, k), empty(rb, 18, k)
    hkk, gk = empty(n_rigs, k, 3, 3), empty(n_rigs, k, 3)
    blk_part = empty(n_tiles, rb, gram_entries(a))
    hk_part = empty(n_rigs * n_chunks, 9, k)
    rc = _rig_entry(load().lib, "pct_selfcal_gram", intr_w,
                    n_rigs)(
        _ptr(packed), _ptr(keyp), _ptr(uv), _ptr(mask),
        _ptr(cmask_b), _ptr(imask_b), _ptr(kmask), bb, k, loss_id,
        component, float(f_scale), chunk, _ptr(g), _ptr(wck), _ptr(wik),
        _ptr(hkk), _ptr(gk), _ptr(blk_part), _ptr(hk_part),
        torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "selfcal_gram")
    if keyp.dim() == 2:
        hkk, gk = hkk[0], gk[0]
    # (B, 3a | 18, K) rows, written coalesced -> (B, K, a | 6, 3) views
    return (g, wck.transpose(1, 2).reshape(rb, k, a, 3),
            wik.transpose(1, 2).reshape(rb, k, 6, 3), hkk, gk)


def selfcal_gram_fused(cam_b, im_b, keyp, uv, mask, imask_b, kmask,
                       n_cams: int, n_ims: int, loss: str = "linear",
                       f_scale: float = 1.0,
                       loss_semantics: str = "component"):
    """Kernel C: the outputs of ``selfcal_gram_fused_plain`` over
    B = n_cams * n_ims camera-major blocks; any n_ims, no padding; a in
    ``TEMPLATE_WIDTHS``.

    Under ``torch.func.vmap`` over a leading rig axis (the fleet) the R
    rigs' cameras fold into ONE launch over R * n_cams cameras, rig-major,
    each rig reading its own free points and key masks
    (``_fold_rig_operands``); its outputs unfold to (R, C, ...), (R, B,
    ...) and (R, K, ...).
    """
    (hcc, gc, wck, wik_b, wci, gii, gi, corner, hkk,
     gk) = _selfcal_gram_fused_op(cam_b, im_b, keyp[None], uv, mask,
                                  imask_b, kmask[None], n_cams, n_ims, loss,
                                  float(f_scale), loss_semantics)
    return hcc, gc, wck, wik_b, wci, gii, gi, corner, hkk[0], gk[0]


selfcal_gram_fused.launches = 0
selfcal_gram_fused.launches_by_width = dict.fromkeys(TEMPLATE_WIDTHS, 0)


@torch.library.custom_op("pycamset_tpu_torch::selfcal_gram_fused",
                         mutates_args=())
def _selfcal_gram_fused_op(
        cam_b: Tensor, im_b: Tensor, keyp: Tensor, uv: Tensor, mask: Tensor,
        imask_b: Tensor, kmask: Tensor, n_cams: int, n_ims: int, loss: str,
        f_scale: float, loss_semantics: str) -> tuple[
            Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor,
            Tensor, Tensor]:
    """Kernel C over R rigs of n_cams x n_ims blocks: keyp and kmask (R, K,
    3), the others R rigs' blocks, rig-major -> (hcc (R C, a, a), gc, wck
    (R C, K, a, 3), wik_b (R B, K, 6, 3), wci, gii, gi, corner, hkk (R, K,
    3, 3), gk (R, K, 3))."""
    n_rigs = keyp.shape[0]
    if cam_b.device.type == "cpu":
        return _per_rig(n_rigs, lambda r: selfcal_gram_fused_plain(
            *_rig_rows(n_rigs, r, cam_b, im_b), keyp[r],
            *_rig_rows(n_rigs, r, uv, mask, imask_b), kmask[r], n_cams,
            n_ims, loss, f_scale, loss_semantics))
    loss_id, component = _loss_args(loss, loss_semantics)
    _check_rig_operands(cam_b, im_b, keyp, uv, mask, kmask, imask_b=imask_b)
    if mask.shape[0] != n_rigs * n_cams * n_ims:
        raise ValueError(f"{mask.shape[0]} blocks, expected {n_rigs} x "
                         f"{n_cams} x {n_ims}")
    with torch.cuda.device(cam_b.device):
        out = _launch_selfcal_fused(pack_block_params(cam_b, im_b), keyp, uv,
                                    mask, imask_b, kmask, n_cams, n_ims,
                                    loss_id, component, f_scale,
                                    cam_b.shape[1] - 6)
    _count(selfcal_gram_fused, cam_b.shape[1])
    return out


@_selfcal_gram_fused_op.register_vmap
def _selfcal_gram_fused_vmap(info, in_dims, cam_b, im_b, keyp, uv, mask,
                             imask_b, kmask, n_cams, n_ims, loss, f_scale,
                             loss_semantics):
    r = info.batch_size
    out = _selfcal_gram_fused_op(*_fold_rig_operands(
        r, in_dims[:7], cam_b, im_b, keyp, uv, mask, imask_b, kmask),
        n_cams, n_ims, loss, f_scale, loss_semantics)
    return _unfold_rigs(r, out), (0,) * len(out)


def _launch_selfcal_fused(packed, keyp, uv, mask, imask_b, kmask, n_cams,
                          n_ims, loss_id, component, f_scale,
                          intr_w: int = 9):
    """Allocate Kernel C's outputs and scratch and launch its two passes on
    the current stream (inputs already checked; ``packed`` from
    pack_block_params at ``intr_w``). ``keyp`` and ``kmask`` (K, 3) for one
    rig, or (R, K, 3) for R rigs of n_cams cameras, rig-major: one launch,
    hkk and gk then (R, K, ...)."""
    from pycamset_tpu_torch._build import load
    n_rigs = keyp.shape[0] if keyp.dim() == 3 else 1
    bb = mask.shape[0]
    cams = n_rigs * n_cams
    a = intr_w + 6
    n_entries = gram_entries(a)
    chunk = SELFCAL_CHUNK
    k, n_tiles, n_chunks = _grid_dims(mask, n_ims, chunk)
    empty = _empty_like_grid(mask)
    hcc, gc, wck = empty(cams, a, a), empty(cams, a), empty(cams, 3 * a, k)
    wik, wci, gii = empty(bb, 18, k), empty(bb, a, 6), empty(bb, 6, 6)
    gi, corner = empty(bb, 6), empty(bb)
    hkk, gk = empty(n_rigs, k, 3, 3), empty(n_rigs, k, 3)
    blk_part = empty(n_tiles, bb, n_entries)
    cam_part = empty(cams, n_chunks, n_tiles, n_entries)
    wck_part = empty(cams, n_chunks, 3 * a, k)
    hk_part = empty(cams * n_chunks, 9, k)
    rc = _rig_entry(load().lib, "pct_selfcal_gram_fused", intr_w,
                    n_rigs)(
        _ptr(packed), _ptr(keyp), _ptr(uv), _ptr(mask),
        _ptr(imask_b), _ptr(kmask), n_cams, n_ims, k, loss_id, component,
        float(f_scale), chunk, _ptr(hcc), _ptr(gc), _ptr(wck), _ptr(wik),
        _ptr(wci), _ptr(gii), _ptr(gi), _ptr(corner), _ptr(hkk), _ptr(gk),
        _ptr(blk_part), _ptr(cam_part), _ptr(wck_part), _ptr(hk_part),
        torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "selfcal_gram_fused")
    if keyp.dim() == 2:
        hkk, gk = hkk[0], gk[0]
    return (hcc, gc, wck.transpose(1, 2).reshape(cams, k, a, 3),
            wik.transpose(1, 2).reshape(bb, k, 6, 3), wci, gii, gi, corner,
            hkk, gk)


def make_cuda_selfcal_grams(widths, loss: str = "linear",
                            f_scale: float = 1.0,
                            loss_semantics: str = "component"):
    """Per-block gram builder on Kernel D; the contract of
    make_block_grams for the self-calibration chain:
    grams(cam_b, im_b, keyp, tpl, uv, mask, cmask_b, imask_b, kmask) ->
    (gcc_b, gii_b, wci_b, hkk, wck_b, wik_b, gc_b, gi_b, gk, cost); every
    column mask is applied in the kernel (tpl is not read).
    """
    _check_widths(widths)
    a = widths.a
    w = a + 6

    def grams(cam_b, im_b, keyp, tpl, uv, mask, cmask_b, imask_b, kmask):
        g, wck_b, wik_b, hkk, gk = selfcal_gram(
            cam_b, im_b, keyp, uv, mask, cmask_b, imask_b, kmask, loss=loss,
            f_scale=f_scale, loss_semantics=loss_semantics)
        return (g[:, :a, :a], g[:, a:w, a:w], g[:, :a, a:w], hkk, wck_b,
                wik_b, g[:, :a, w], g[:, a:w, w], gk, torch.sum(g[:, w, w]))

    return grams


def make_cuda_selfcal_grams_fused(widths, n_cams: int, n_ims: int,
                                  loss: str = "linear", f_scale: float = 1.0,
                                  loss_semantics: str = "component"):
    """Fused-reduction self-cal gram builder on Kernel C; the contract of
    make_pallas_selfcal_grams_fused:
    grams(cam_b, im_b, keyp, uv, mask, cmask_b, imask_b, kmask) ->
    (hcc (C,a,a), hii (I,6,6), hkk (K,3,3), wci (C,I,a,6), wck (C,K,a,3),
     wik (I,K,6,3), gc (C,a), gi (I,6), gk (K,3), cost).
    """
    _check_widths(widths)
    a = widths.a

    def grams(cam_b, im_b, keyp, uv, mask, cmask_b, imask_b, kmask):
        (hcc, gc, wck, wik_b, wci, gii, gi, corner, hkk,
         gk) = selfcal_gram_fused(cam_b, im_b, keyp, uv, mask, imask_b,
                                  kmask, n_cams, n_ims, loss=loss,
                                  f_scale=f_scale,
                                  loss_semantics=loss_semantics)
        # camera columns masked on the reduced pieces (cmask is constant
        # over a camera's images); the pose columns saw imask in the kernel
        cm = cmask_b.reshape(n_cams, n_ims, a)[:, 0]
        hcc = hcc * cm[:, :, None] * cm[:, None, :]
        wci = wci.reshape(n_cams, n_ims, a, 6) * cm[:, None, :, None]
        wck = wck * cm[:, None, :, None]
        hii = gii.reshape(n_cams, n_ims, 6, 6).sum(dim=0)
        gi_r = gi.reshape(n_cams, n_ims, 6).sum(dim=0)
        wik = wik_b.reshape((n_cams, n_ims) + wik_b.shape[1:]).sum(dim=0)
        return (hcc, hii, hkk, wci, wck, wik, gc * cm, gi_r, gk,
                torch.sum(corner))

    return grams


# --------------------------------------------- the pose-free free-point chain

def _identity_poses(cam_b):
    """(B, 6) zero poses (Rp = I, tp = 0) and their (B, 6) zero column
    mask, in cam_b's dtype and device."""
    z = cam_b.new_zeros((cam_b.shape[0], 6))
    return z, z


def freepoint_gram_plain(cam_b, keyp, uv, mask, cmask_b, kmask,
                         loss: str = "linear", f_scale: float = 1.0,
                         loss_semantics: str = "component"):
    """Plain twin of ``freepoint_gram``: ``selfcal_gram_plain`` at identity
    poses with every pose column masked, the pose outputs stripped.

    :return: (gcc_b (B,a,a), gc_b (B,a), corner (B,) the block's
        (robust) cost, wck_b (B,K,a,3), hkk (K,3,3), gk (K,3)).
    """
    im0, imask0 = _identity_poses(cam_b)
    g, wck_b, _, hkk, gk = selfcal_gram_plain(
        cam_b, im0, keyp, uv, mask, cmask_b, imask0, kmask, loss, f_scale,
        loss_semantics)
    return _strip_pose(g, wck_b, hkk, gk)


def _strip_pose(g, wck_b, hkk, gk):
    """Kernel D's outputs without the pose columns (views of g)."""
    w = g.shape[-1] - 1
    a = w - 6
    return g[:, :a, :a], g[:, :a, w], g[:, w, w], wck_b, hkk, gk


def freepoint_gram_fused_plain(cam_b, keyp, uv, mask, kmask, n_cams: int,
                               n_ims: int, loss: str = "linear",
                               f_scale: float = 1.0,
                               loss_semantics: str = "component"):
    """Plain twin of ``freepoint_gram_fused``: ``selfcal_gram_fused_plain``
    at identity poses with every pose column masked, the pose outputs
    stripped.

    :return: (hcc (C,a,a), gc (C,a), wck (C,K,a,3), corner (B,),
        hkk (K,3,3), gk (K,3)), camera columns unmasked.
    """
    im0, imask0 = _identity_poses(cam_b)
    (hcc, gc, wck, _, _, _, _, corner, hkk,
     gk) = selfcal_gram_fused_plain(cam_b, im0, keyp, uv, mask, imask0,
                                    kmask, n_cams, n_ims, loss, f_scale,
                                    loss_semantics)
    return hcc, gc, wck, corner, hkk, gk


def freepoint_gram(cam_b, keyp, uv, mask, cmask_b, kmask,
                   loss: str = "linear", f_scale: float = 1.0,
                   loss_semantics: str = "component"):
    """Kernel D at identity poses: the outputs of ``freepoint_gram_plain``
    (a CPU tensor runs that twin, through the operator).

    :param cam_b: (B, a), a in ``TEMPLATE_WIDTHS``. :param keyp: (K, 3)
        free points. :param uv: (B, K, 2). :param mask: (B, K).
        :param cmask_b: (B, a). :param kmask: (K, 3).

    Under ``torch.func.vmap`` over a leading rig axis R rigs fold into one
    launch of D, each rig's outputs those of its own launch.
    """
    im0, imask0 = _identity_poses(cam_b)
    with _counted_as(freepoint_gram):
        g, wck_b, _, hkk, gk = selfcal_gram(
            cam_b, im0, keyp, uv, mask, cmask_b, imask0, kmask, loss,
            f_scale, loss_semantics)
    return _strip_pose(g, wck_b, hkk, gk)


freepoint_gram.launches = 0
freepoint_gram.launches_by_width = dict.fromkeys(TEMPLATE_WIDTHS, 0)


def freepoint_gram_fused(cam_b, keyp, uv, mask, kmask, n_cams: int,
                         n_ims: int, loss: str = "linear",
                         f_scale: float = 1.0,
                         loss_semantics: str = "component"):
    """Kernel C at identity poses: the outputs of
    ``freepoint_gram_fused_plain`` over B = n_cams * n_ims camera-major
    blocks (a CPU tensor runs that twin, through the operator). Under
    ``torch.func.vmap`` R rigs fold into one launch of C."""
    im0, imask0 = _identity_poses(cam_b)
    with _counted_as(freepoint_gram_fused):
        (hcc, gc, wck, _, _, _, _, corner, hkk,
         gk) = selfcal_gram_fused(cam_b, im0, keyp, uv, mask, imask0, kmask,
                                  n_cams, n_ims, loss, f_scale,
                                  loss_semantics)
    return hcc, gc, wck, corner, hkk, gk


freepoint_gram_fused.launches = 0
freepoint_gram_fused.launches_by_width = dict.fromkeys(TEMPLATE_WIDTHS, 0)


def make_cuda_freepoint_grams(widths, loss: str = "linear",
                              f_scale: float = 1.0,
                              loss_semantics: str = "component"):
    """Per-block gram builder of the pose-free free-point chain on Kernel D
    (``freepoint_gram``); the contract of make_pallas_freepoint_grams:
    grams(cam_b, im_b, keyp, tpl, uv, mask, cmask_b, imask_b, kmask) ->
    (gcc_b, gii_b (B,0,0), wci_b (B,a,0), hkk, wck_b, wik_b (B,K,0,3), gc_b,
    gi_b (B,0), gk, cost); im_b, tpl and imask_b are not read.
    """
    _check_widths(widths, b=0)
    a = widths.a

    def grams(cam_b, im_b, keyp, tpl, uv, mask, cmask_b, imask_b, kmask):
        gcc_b, gc_b, corner, wck_b, hkk, gk = freepoint_gram(
            cam_b, keyp, uv, mask, cmask_b, kmask, loss=loss,
            f_scale=f_scale, loss_semantics=loss_semantics)
        bb, k_pad = mask.shape
        z = mask.new_zeros
        return (gcc_b, z((bb, 0, 0)), z((bb, a, 0)), hkk, wck_b,
                z((bb, k_pad, 0, 3)), gc_b, z((bb, 0)), gk,
                torch.sum(corner))

    return grams


def make_cuda_freepoint_grams_fused(widths, n_cams: int, n_ims: int,
                                    loss: str = "linear",
                                    f_scale: float = 1.0,
                                    loss_semantics: str = "component"):
    """Fused-reduction builder of the pose-free free-point chain on Kernel C
    (``freepoint_gram_fused``); the contract of
    make_pallas_freepoint_grams_fused:
    grams(cam_b, im_b, keyp, uv, mask, cmask_b, imask_b, kmask) ->
    (hcc (C,a,a), hkk (K,3,3), wck (C,K,a,3), gc (C,a), gk (K,3), cost);
    im_b and imask_b are not read.
    """
    _check_widths(widths, b=0)
    a = widths.a

    def grams(cam_b, im_b, keyp, uv, mask, cmask_b, imask_b, kmask):
        hcc, gc, wck, corner, hkk, gk = freepoint_gram_fused(
            cam_b, keyp, uv, mask, kmask, n_cams, n_ims, loss=loss,
            f_scale=f_scale, loss_semantics=loss_semantics)
        # camera columns masked on the reduced pieces, as the self-cal
        # fused builder masks them
        cm = cmask_b.reshape(n_cams, n_ims, a)[:, 0]
        return (hcc * cm[:, :, None] * cm[:, None, :], hkk,
                wck * cm[:, None, :, None], gc * cm, gk, torch.sum(corner))

    return grams


def scaled_errors_freepoint(got, ref) -> dict:
    """Worst error of ``freepoint_gram``'s outputs against reference
    outputs, per output, in the Jacobi scaling: gcc_b by sqrt(g_ii g_jj),
    gc_b by sqrt(g_ii cost_b) and the cost relative, with the block's own
    diagonal; wck_b by sqrt(gcc_ii hkk_pp); hkk and gk as ``_key_errors``."""
    ref = [r.double() for r in ref]
    got = [g.double().to(r.device) for g, r in zip(got, ref)]
    gcc, gc, corner, wck = (g - r for g, r in zip(got[:4], ref[:4]))
    a = ref[0].shape[-1]
    s_b = _jacobi_scale(torch.cat([torch.diagonal(ref[0], dim1=1, dim2=2),
                                   ref[2][:, None]], dim=1))
    s_k = _jacobi_scale(torch.diagonal(ref[4], dim1=1, dim2=2))
    out = {"gcc": _worst(gcc / (s_b[:, :a, None] * s_b[:, None, :a])),
           "gc": _worst(gc / (s_b[:, :a] * s_b[:, a:])),
           "cost": _worst(corner / s_b[:, a] ** 2),
           "wck": _worst(wck / (s_b[:, None, :a, None]
                                * s_k[None, :, None, :]))}
    out.update(_key_errors(got[4], got[5], ref[4], ref[5], ref[2].sum()))
    return out


def scaled_errors_freepoint_fused(got, ref, n_cams: int,
                                  n_ims: int) -> dict:
    """Worst error of ``freepoint_gram_fused``'s outputs against reference
    outputs, per output, in the Jacobi scaling: hcc and gc by each camera's
    reduced diagonal and cost, the per-block costs relative, wck by
    sqrt(hcc_ii hkk_pp); hkk and gk as ``_key_errors``."""
    ref = [r.double() for r in ref]
    got = [g.double().to(r.device) for g, r in zip(got, ref)]
    hcc, gc, wck, corner = (g - r for g, r in zip(got[:4], ref[:4]))
    a = ref[0].shape[-1]
    cost_c = ref[3].reshape(n_cams, n_ims).sum(dim=1)
    s_c = _jacobi_scale(torch.cat(
        [torch.diagonal(ref[0], dim1=1, dim2=2), cost_c[:, None]], dim=1))
    s_k = _jacobi_scale(torch.diagonal(ref[4], dim1=1, dim2=2))
    out = {"hcc": _worst(hcc / (s_c[:, :a, None] * s_c[:, None, :a])),
           "gc": _worst(gc / (s_c[:, :a] * s_c[:, a:])),
           "corner": _worst(corner / _jacobi_scale(ref[3]) ** 2),
           "wck": _worst(wck / (s_c[:, None, :a, None]
                                * s_k[None, :, None, :]))}
    out.update(_key_errors(got[4], got[5], ref[4], ref[5], ref[3].sum()))
    return out
