"""Multi-target gram kernels: CUDA wrappers and their plain twins.

Counterpart of the mixed/grouped part of
``pycamset_tpu/optim/pallas_grams.py``, for the chains that put a per-GROUP
SE(3) between the image pose and the point,
Xc = Re (Rp (Rg Xp + tg) + tp) + te. The key axis carries cw columns in
chain order [group pose 6 | point 3]: cw = 9 for the mixed chain
(``GroupRigidTform3d + FreePoint``, ``with_key_cols=True``), cw = 6 for the
grouped template chain (``GroupTemplatePoints``, the point from the
template table, ``with_key_cols=False``). The group pose arrives expanded
per key (the caller's one-hot), so its columns are per-key columns here.
Two hand-written Hopper kernels (``csrc/mixed_grams.cu``) replace the two
Pallas kernels:

- Kernel E, ``mixed_gram_fused`` <- ``make_pallas_mixed_grams_fused``:
  hcc, gc and the key couplings wcc = Jc^T Jk summed over each camera's
  images; per block wic = Ji^T Jk, wci, gii, gi and the cost; hkk = Jk^T Jk
  and gk = Jk^T r over all blocks.
- Kernel F, ``mixed_gram`` <- ``_mixed_grams_factory`` (reached through
  ``make_pallas_mixed_grams`` and ``make_pallas_grouped_grams``): the
  per-block extended gram (W x W, W = a + 7), the per-(block, key)
  couplings wcc_b and wic_b, and hkk/gk over all blocks.

Both serve the five camera models the JAX kernels serve (``TEMPLATE_WIDTHS``:
a = 15 standard, entry points ``pct_mixed_gram{,_fused}``; 14 fisheye, 18
rational, 22 thin-prism and 24 tilted through
``pct_mixed_gram{,_fused}_model``, ``csrc/mixed_models_{e,f}.cu``) at both
key widths; a CUDA tensor at another camera width raises. Both mask every
camera, pose and key column in the kernel, as the Pallas kernels do. Each
wrapper takes the same tensors on either device. A CPU tensor runs the
plain PyTorch twin (``mixed_gram_plain``, ``mixed_gram_fused_plain``: the
closed forms of ``analytic`` at any camera width, and batched products). A
CUDA tensor launches the kernel or raises: there is no fallback. Each
wrapper counts its launches in ``<wrapper>.launches``, per key width in
``<wrapper>.launches_by_cw`` and per (camera width, key width) in
``<wrapper>.launches_by_width``.

The builders ``make_cuda_mixed_grams``, ``make_cuda_grouped_grams`` and
``make_cuda_mixed_grams_fused`` keep the JAX builders' contracts (the
10-tuple of ``make_block_grams``, and the ten reduced pieces of
``make_pallas_mixed_grams_fused``).

``pack_key_group_data`` builds the kernels' per-key operand in plain torch,
as the JAX package builds it outside its Pallas call.
``scaled_errors_mixed`` and ``scaled_errors_mixed_fused`` hold a kernel's
outputs against its twin's entry by entry, in the Jacobi scaling the solver
applies (their layouts are the self-cal kernels' with c = cw), and
``scaled_errors_groups`` the per-group sums the solver builds from them.
"""
from __future__ import annotations

import torch
from torch import Tensor

from pycamset_tpu_torch.ops.rotations import (rodrigues_jacobian,
                                              rodrigues_to_matrix)
from pycamset_tpu_torch.optim.cuda_grams import (
    NO_KERNEL_WIDTH, TEMPLATE_WIDTHS, _check_cuda_inputs, _jacobi_scale,
    _loss_args, _ptr, _raise_on, _rig_entry, _worst, pack_block_params,
    reduce_grams)
from pycamset_tpu_torch.optim.cuda_selfcal_grams import (
    _empty_like_grid, _fold_rig_operands, _grid_dims, _per_rig, _rig_rows,
    _unfold_rigs, gram_entries, scaled_errors_selfcal,
    scaled_errors_selfcal_fused, weighted_grams)

KD_ROWS = 48        # pack_key_group_data rows (the JAX layout)
MIXED_CHUNK = 12    # images of one camera per thread block in Kernel E
MIXED_CHUNK_F = 8   # blocks per thread block in Kernel F
N_HK = 9            # per-key sums of g for hkk and gk (csrc N_HK)
# Kernel E's per-key sums of g over a chunk at camera width a are 3a (csrc
# Mix::N_GC: 45 at the standard model), its gram entries gram_entries(a)

# the outputs of Kernels E/F have the self-cal kernels' layouts (c = cw)
scaled_errors_mixed = scaled_errors_selfcal
scaled_errors_mixed_fused = scaled_errors_selfcal_fused


def scaled_errors_groups(got, ref, onehot: torch.Tensor, n_cams: int,
                         n_ims: int) -> dict:
    """Worst error of the per-GROUP pieces that the solver builds from a
    kernel's outputs (Kernel E's 10-tuple, or Kernel F's 5-tuple, against
    the same kind of reference): hgg, wcg, wig and gg, each key's group
    columns summed over the group's keys through the (K, G) ``onehot``, in
    the Jacobi scaling: hgg by its own diagonal, wcg by sqrt(hcc_ii hgg_pp),
    wig by sqrt(hii_bb hgg_pp), gg by sqrt(hgg_pp cost). Each entry sums
    float32 products over every real detection of a group (about 180 keys x
    1600 blocks at 16 x 100)."""
    from pycamset_tpu_torch.optim.structured import group_reduce

    def pieces(out):
        out = [x.double() for x in out]
        if len(out) == 10:       # Kernel E: hcc, gc, wcc, wic_b, ..., hkk, gk
            hcc, wck, wic_b, gii, hkk, gk = (out[0], out[2], out[3], out[5],
                                             out[8], out[9])
            cost = out[7].sum()
        else:                    # Kernel F: gram, wcc_b, wic_b, hkk, gk
            g, wcc_b, wic_b, hkk, gk = out
            a = g.shape[-1] - 7
            hcc = g[:, :a, :a].reshape(n_cams, n_ims, a, a).sum(dim=1)
            gii = g[:, a:a + 6, a:a + 6]
            wck = wcc_b.reshape((n_cams, n_ims) + wcc_b.shape[1:]).sum(dim=1)
            cost = g[:, -1, -1].sum()
        hii = gii.reshape(n_cams, n_ims, 6, 6).sum(dim=0)
        wik = wic_b.reshape((n_cams, n_ims) + wic_b.shape[1:]).sum(dim=0)
        oh = onehot.double().to(hkk.device)
        return (hcc, hii, cost) + group_reduce(
            oh, hkk[:, :6, :6], wck[..., :6], wik[..., :6], gk[:, :6])

    _, _, _, *g_grp = pieces(got)
    r_hcc, r_hii, r_cost, *r_grp = pieces(ref)
    g_grp = [x.to(r.device) for x, r in zip(g_grp, r_grp)]
    s_c = _jacobi_scale(torch.diagonal(r_hcc, dim1=1, dim2=2))
    s_i = _jacobi_scale(torch.diagonal(r_hii, dim1=1, dim2=2))
    s_g = _jacobi_scale(torch.diagonal(r_grp[0], dim1=1, dim2=2))
    (hgg, wcg, wig, gg), (r_hgg, r_wcg, r_wig, r_gg) = g_grp, r_grp
    return {"hgg": _worst((hgg - r_hgg) / (s_g[:, :, None]
                                           * s_g[:, None, :])),
            "wcg": _worst((wcg - r_wcg) / (s_c[:, None, :, None]
                                           * s_g[None, :, None, :])),
            "wig": _worst((wig - r_wig) / (s_i[:, None, :, None]
                                           * s_g[None, :, None, :])),
            "gg": _worst((gg - r_gg) / (s_g * torch.sqrt(r_cost)))}


def key_width(with_key_cols: bool) -> int:
    """cw: the group pose (6), plus the free point (3) for the mixed
    chain."""
    return 9 if with_key_cols else 6


def first_pass_occupancy(a: int, cw: int, fused: bool) -> dict:
    """What the current CUDA device makes of the first pass of Kernel C/E
    (``fused``) or D/F at camera width a and key width cw (3: C/D; 9, 6:
    E/F), read from the runtime through ``pct_mixed_occupancy``: the blocks
    of 128 threads an SM holds at the dynamic shared memory the launcher
    passes, that dynamic and the static shared memory in bytes, registers
    and local (spill) bytes a thread, and the blocks an SM the kernel's
    launch bounds ask for. Builds the kernels if needed; launches nothing.
    """
    import ctypes

    from pycamset_tpu_torch._build import load
    if a not in TEMPLATE_WIDTHS or cw not in (3, 6, 9):
        raise ValueError(f"no first pass is built at a = {a}, cw = {cw}")
    out = (ctypes.c_int * 6)()
    _raise_on(load().lib.pct_mixed_occupancy(
        a - 6, cw, int(fused), ctypes.cast(out, ctypes.c_void_p)),
        "pct_mixed_occupancy")
    return dict(zip(("blocks_per_sm", "dynamic_smem_bytes",
                     "static_smem_bytes", "registers", "local_bytes",
                     "launch_bound_blocks"), out))


def _check_widths(widths, with_key_cols: bool):
    cw = key_width(with_key_cols)
    if (widths.b, widths.c) != (6, cw) or widths.a not in TEMPLATE_WIDTHS:
        raise NotImplementedError(
            f"widths {widths} have no kernel: the multi-target kernels "
            f"serve the mixed (b=6, c=9) and grouped (b=6, c=6) chains at "
            f"the camera widths {TEMPLATE_WIDTHS}; {NO_KERNEL_WIDTH}")


def pack_key_group_data(grp6: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(..., K, 6) per-key group poses + (..., K, 3) points -> (...,
    KD_ROWS, K) operand: rows [Xg = Rg Xp + tg 3 | Rg 9 | dRg/drvg 27 | Xp 3
    | 0 6], the JAX layout. Element by element, so that a rig's rows of R
    rigs' operand are the bits of its own."""
    lead = grp6.shape[:-1]
    rg = rodrigues_to_matrix(grp6[..., :3])
    xg = (rg[..., 0] * pts[..., :1] + rg[..., 1] * pts[..., 1:2]
          + rg[..., 2] * pts[..., 2:3]) + grp6[..., 3:]
    rows = torch.cat([xg, rg.reshape(*lead, 9),
                      rodrigues_jacobian(grp6[..., :3]).reshape(*lead, 27),
                      pts, pts.new_zeros((*lead, KD_ROWS - 42))], dim=-1)
    return rows.transpose(-1, -2).contiguous()


def _points(keyp, tpl, with_key_cols: bool):
    return keyp[..., 6:9] if with_key_cols else tpl


def mixed_gram_plain(cam_b, im_b, keyp, tpl, uv, mask, cmask_b, imask_b,
                     kmask, with_key_cols: bool = True, loss: str = "linear",
                     f_scale: float = 1.0,
                     loss_semantics: str = "component"):
    """Plain twin of Kernel F.

    :param keyp: (K, cw) c-axis rows [group pose 6 | point 3]; the grouped
        chain (``with_key_cols=False``) reads its points from tpl (K, 3).
    :return: (g (B, W, W) extended grams of [Jc | Ji | r], W = a + 7,
        IRLS-weighted rows, camera columns masked by cmask_b and pose
        columns by imask_b, corner = the block's (robust) cost;
        wcc_b (B, K, a, cw);
        wic_b (B, K, 6, cw); hkk (K, cw, cw); gk (K, cw)), Jk masked by kmask.
    """
    from pycamset_tpu_torch.optim.analytic import (block_rj_grouped_template,
                                                   block_rj_mixed_selfcal)
    if with_key_cols:
        rj = block_rj_mixed_selfcal(cam_b, im_b, keyp, uv)
    else:
        rj = block_rj_grouped_template(cam_b, im_b, keyp, tpl, uv)
    return weighted_grams(*rj, mask, cmask_b, imask_b, kmask, loss, f_scale,
                          loss_semantics)


def mixed_gram_fused_plain(cam_b, im_b, keyp, tpl, uv, mask, cmask_b,
                           imask_b, kmask, n_cams: int, n_ims: int,
                           with_key_cols: bool = True, loss: str = "linear",
                           f_scale: float = 1.0,
                           loss_semantics: str = "component"):
    """Plain twin of Kernel E: Kernel F's twin, reduced.

    :return: (hcc (C,a,a), gc (C,a), wcc (C,K,a,cw), wic_b (B,K,6,cw),
        wci (B,a,6), gii (B,6,6), gi (B,6), corner (B,), hkk (K,cw,cw),
        gk (K,cw)).
    """
    g, wcc_b, wic_b, hkk, gk = mixed_gram_plain(
        cam_b, im_b, keyp, tpl, uv, mask, cmask_b, imask_b, kmask,
        with_key_cols, loss, f_scale, loss_semantics)
    hcc, gc, wci, gii, gi, corner = reduce_grams(g, n_cams, n_ims)
    wcc = wcc_b.reshape((n_cams, n_ims) + wcc_b.shape[1:]).sum(dim=1)
    return hcc, gc, wcc, wic_b, wci, gii, gi, corner, hkk, gk


def _check_mixed_inputs(cam_b, im_b, keyp, tpl, uv, mask, cmask_b, imask_b,
                        kmask, with_key_cols: bool):
    """Raise unless Kernels E/F take these tensors as they are (a camera
    width in ``TEMPLATE_WIDTHS``)."""
    _check_cuda_inputs(cam_b, im_b, tpl, uv, mask, cmask_b=cmask_b,
                       imask_b=imask_b)
    want = (mask.shape[1], key_width(with_key_cols))
    for name, x in (("keyp", keyp), ("kmask", kmask)):
        if x.device != cam_b.device:
            raise ValueError(f"{name} is on {x.device}, cam_b on "
                             f"{cam_b.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} is {x.dtype}; the CUDA kernels take "
                            f"torch.float32")
        if tuple(x.shape) != want:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"{want}")
    if not kmask.is_contiguous():
        raise ValueError("kmask must be contiguous")


def _count(wrapper, a: int, cw: int):
    wrapper.launches += 1
    wrapper.launches_by_cw[cw] += 1
    wrapper.launches_by_width[(a, cw)] += 1


def _by_width() -> dict:
    """A zero launch count per (camera width, key width)."""
    return {(a, cw): 0 for a in TEMPLATE_WIDTHS for cw in (9, 6)}


def mixed_gram(cam_b, im_b, keyp, tpl, uv, mask, cmask_b, imask_b, kmask,
               with_key_cols: bool = True, loss: str = "linear",
               f_scale: float = 1.0, loss_semantics: str = "component"):
    """Kernel F: (g (B,W,W), wcc_b (B,K,a,cw), wic_b (B,K,6,cw),
    hkk (K,cw,cw), gk (K,cw)), the outputs of ``mixed_gram_plain``.

    :param cam_b: (B, a), a in ``TEMPLATE_WIDTHS``. :param im_b: (B, 6).
        :param keyp: (K, cw). :param tpl: (K, 3). :param uv: (B, K, 2).
        :param mask: (B, K). :param cmask_b: (B, a). :param imask_b: (B, 6).
        :param kmask: (K, cw).

    Under ``torch.func.vmap`` over a leading rig axis (the fleet) the R
    rigs fold into ONE launch (``_fold_rig_operands``), each rig reading
    its own per-key rows, key masks and points.
    """
    g, wcc_b, wic_b, hkk, gk = _mixed_gram_op(
        cam_b, im_b, keyp[None], tpl[None], uv, mask, cmask_b, imask_b,
        kmask[None], with_key_cols, loss, float(f_scale), loss_semantics)
    return g, wcc_b, wic_b, hkk[0], gk[0]


mixed_gram.launches = 0
mixed_gram.launches_by_cw = {6: 0, 9: 0}
mixed_gram.launches_by_width = _by_width()


def _check_rig_mixed(cam_b, im_b, keyp, tpl, uv, mask, cmask_b, imask_b,
                     kmask, with_key_cols: bool):
    """Raise unless Kernels E/F take these R rigs' tensors as they are:
    keyp, kmask (R, K, cw) and tpl (R, K, 3) beside R rigs' blocks (the
    one-rig checks on rig 0's slices)."""
    n_rigs = keyp.shape[0]
    if ({kmask.shape[0], tpl.shape[0]} != {n_rigs}
            or mask.shape[0] % n_rigs):
        raise ValueError(f"{mask.shape[0]} blocks, {kmask.shape[0]} key "
                         f"masks and {tpl.shape[0]} point tables for "
                         f"{n_rigs} rigs")
    bb = mask.shape[0] // n_rigs
    _check_mixed_inputs(cam_b[:bb], im_b[:bb], keyp[0], tpl[0], uv[:bb],
                        mask[:bb], cmask_b[:bb], imask_b[:bb], kmask[0],
                        with_key_cols)
    for name, x in (("cam_b", cam_b), ("im_b", im_b), ("uv", uv),
                    ("cmask_b", cmask_b), ("imask_b", imask_b)):
        if x.shape[0] != mask.shape[0]:
            raise ValueError(f"{name} has {x.shape[0]} blocks, mask "
                             f"{mask.shape[0]}")
    if not kmask.is_contiguous():
        raise ValueError("kmask must be contiguous")


@torch.library.custom_op("pycamset_tpu_torch::mixed_gram", mutates_args=())
def _mixed_gram_op(cam_b: Tensor, im_b: Tensor, keyp: Tensor, tpl: Tensor,
                   uv: Tensor, mask: Tensor, cmask_b: Tensor, imask_b: Tensor,
                   kmask: Tensor, with_key_cols: bool, loss: str,
                   f_scale: float, loss_semantics: str) -> tuple[
                       Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Kernel F over R rigs: keyp, kmask (R, K, cw) and tpl (R, K, 3), the
    others R rigs' blocks, rig-major -> (g (R B, W, W), wcc_b (R B, K, a,
    cw), wic_b (R B, K, 6, cw), hkk (R, K, cw, cw), gk (R, K, cw))."""
    n_rigs = keyp.shape[0]
    if cam_b.device.type == "cpu":
        return _per_rig(n_rigs, lambda r: mixed_gram_plain(
            *_rig_rows(n_rigs, r, cam_b, im_b), keyp[r], tpl[r],
            *_rig_rows(n_rigs, r, uv, mask, cmask_b, imask_b), kmask[r],
            with_key_cols, loss, f_scale, loss_semantics))
    loss_id, component = _loss_args(loss, loss_semantics)
    _check_rig_mixed(cam_b, im_b, keyp, tpl, uv, mask, cmask_b, imask_b,
                     kmask, with_key_cols)
    with torch.cuda.device(cam_b.device):
        kd = pack_key_group_data(keyp[..., :6],
                                 _points(keyp, tpl, with_key_cols))
        out = _launch_mixed(pack_block_params(cam_b, im_b), kd, uv, mask,
                            cmask_b, imask_b, kmask, loss_id, component,
                            f_scale, cam_b.shape[1] - 6)
    _count(mixed_gram, cam_b.shape[1], kmask.shape[2])
    return out


@_mixed_gram_op.register_vmap
def _mixed_gram_vmap(info, in_dims, cam_b, im_b, keyp, tpl, uv, mask,
                     cmask_b, imask_b, kmask, with_key_cols, loss, f_scale,
                     loss_semantics):
    r = info.batch_size
    out = _mixed_gram_op(*_fold_rig_operands(
        r, in_dims[:9], cam_b, im_b, keyp, tpl, uv, mask, cmask_b, imask_b,
        kmask), with_key_cols, loss, f_scale, loss_semantics)
    return _unfold_rigs(r, out), (0,) * len(out)


def _launch_mixed(packed, kd, uv, mask, cmask_b, imask_b, kmask, loss_id,
                  component, f_scale, intr_w: int = 9):
    """Allocate Kernel F's outputs and scratch and launch its two passes on
    the current stream (inputs already checked; ``packed`` from
    pack_block_params at ``intr_w``). ``kd`` (KD_ROWS, K) and ``kmask``
    (K, cw) for one rig, or (R, KD_ROWS, K) and (R, K, cw) for R rigs whose
    blocks the others hold rig-major: one launch, hkk and gk then (R, K,
    ...)."""
    from pycamset_tpu_torch._build import load
    n_rigs = kmask.shape[0] if kmask.dim() == 3 else 1
    bb = mask.shape[0] // n_rigs
    rb = mask.shape[0]
    cw = kmask.shape[-1]
    a = intr_w + 6
    gw = a + 7
    chunk = MIXED_CHUNK_F
    k, n_tiles, n_chunks = _grid_dims(mask, bb, chunk)
    empty = _empty_like_grid(mask)
    g, wcc, wic = (empty(rb, gw, gw), empty(rb, a * cw, k),
                   empty(rb, 6 * cw, k))
    hkk, gk = empty(n_rigs, k, cw, cw), empty(n_rigs, k, cw)
    blk_part, hk_part = (empty(n_tiles, rb, gram_entries(a)),
                         empty(n_rigs * n_chunks, N_HK, k))
    rc = _rig_entry(load().lib, "pct_mixed_gram", intr_w, n_rigs)(
        _ptr(packed), _ptr(kd), _ptr(uv), _ptr(mask),
        _ptr(cmask_b), _ptr(imask_b), _ptr(kmask), cw, bb, k, loss_id,
        component, float(f_scale), chunk, _ptr(g), _ptr(wcc), _ptr(wic),
        _ptr(hkk), _ptr(gk), _ptr(blk_part), _ptr(hk_part),
        torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "mixed_gram")
    if kmask.dim() == 2:
        hkk, gk = hkk[0], gk[0]
    # (B, a cw | 6 cw, K) rows, written coalesced -> (B, K, a | 6, cw)
    return (g, wcc.transpose(1, 2).reshape(rb, k, a, cw),
            wic.transpose(1, 2).reshape(rb, k, 6, cw), hkk, gk)


def mixed_gram_fused(cam_b, im_b, keyp, tpl, uv, mask, cmask_b, imask_b,
                     kmask, n_cams: int, n_ims: int,
                     with_key_cols: bool = True, loss: str = "linear",
                     f_scale: float = 1.0,
                     loss_semantics: str = "component"):
    """Kernel E: the outputs of ``mixed_gram_fused_plain`` over
    B = n_cams * n_ims camera-major blocks; any n_ims, no padding; a in
    ``TEMPLATE_WIDTHS``.

    Under ``torch.func.vmap`` over a leading rig axis (the fleet) the R
    rigs' cameras fold into ONE launch over R * n_cams cameras, rig-major,
    each rig reading its own per-key rows, key masks and points; the
    outputs unfold to (R, C, ...), (R, B, ...) and (R, K, ...).
    """
    (hcc, gc, wcc, wic_b, wci, gii, gi, corner, hkk,
     gk) = _mixed_gram_fused_op(cam_b, im_b, keyp[None], tpl[None], uv, mask,
                                cmask_b, imask_b, kmask[None], n_cams, n_ims,
                                with_key_cols, loss, float(f_scale),
                                loss_semantics)
    return hcc, gc, wcc, wic_b, wci, gii, gi, corner, hkk[0], gk[0]


mixed_gram_fused.launches = 0
mixed_gram_fused.launches_by_cw = {6: 0, 9: 0}
mixed_gram_fused.launches_by_width = _by_width()


@torch.library.custom_op("pycamset_tpu_torch::mixed_gram_fused",
                         mutates_args=())
def _mixed_gram_fused_op(
        cam_b: Tensor, im_b: Tensor, keyp: Tensor, tpl: Tensor, uv: Tensor,
        mask: Tensor, cmask_b: Tensor, imask_b: Tensor, kmask: Tensor,
        n_cams: int, n_ims: int, with_key_cols: bool, loss: str,
        f_scale: float, loss_semantics: str) -> tuple[
            Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor,
            Tensor, Tensor]:
    """Kernel E over R rigs of n_cams x n_ims blocks: keyp, kmask (R, K,
    cw) and tpl (R, K, 3), the others R rigs' blocks, rig-major -> (hcc
    (R C, a, a), gc, wcc (R C, K, a, cw), wic_b (R B, K, 6, cw), wci, gii,
    gi, corner, hkk (R, K, cw, cw), gk (R, K, cw))."""
    n_rigs = keyp.shape[0]
    if cam_b.device.type == "cpu":
        return _per_rig(n_rigs, lambda r: mixed_gram_fused_plain(
            *_rig_rows(n_rigs, r, cam_b, im_b), keyp[r], tpl[r],
            *_rig_rows(n_rigs, r, uv, mask, cmask_b, imask_b), kmask[r],
            n_cams, n_ims, with_key_cols, loss, f_scale, loss_semantics))
    loss_id, component = _loss_args(loss, loss_semantics)
    _check_rig_mixed(cam_b, im_b, keyp, tpl, uv, mask, cmask_b, imask_b,
                     kmask, with_key_cols)
    if mask.shape[0] != n_rigs * n_cams * n_ims:
        raise ValueError(f"{mask.shape[0]} blocks, expected {n_rigs} x "
                         f"{n_cams} x {n_ims}")
    with torch.cuda.device(cam_b.device):
        kd = pack_key_group_data(keyp[..., :6],
                                 _points(keyp, tpl, with_key_cols))
        out = _launch_mixed_fused(pack_block_params(cam_b, im_b), kd, uv,
                                  mask, cmask_b, imask_b, kmask, n_cams,
                                  n_ims, loss_id, component, f_scale,
                                  cam_b.shape[1] - 6)
    _count(mixed_gram_fused, cam_b.shape[1], kmask.shape[2])
    return out


@_mixed_gram_fused_op.register_vmap
def _mixed_gram_fused_vmap(info, in_dims, cam_b, im_b, keyp, tpl, uv, mask,
                           cmask_b, imask_b, kmask, n_cams, n_ims,
                           with_key_cols, loss, f_scale, loss_semantics):
    r = info.batch_size
    out = _mixed_gram_fused_op(*_fold_rig_operands(
        r, in_dims[:9], cam_b, im_b, keyp, tpl, uv, mask, cmask_b, imask_b,
        kmask), n_cams, n_ims, with_key_cols, loss, f_scale, loss_semantics)
    return _unfold_rigs(r, out), (0,) * len(out)


def _launch_mixed_fused(packed, kd, uv, mask, cmask_b, imask_b, kmask,
                        n_cams, n_ims, loss_id, component, f_scale,
                        intr_w: int = 9):
    """Allocate Kernel E's outputs and scratch and launch its two passes on
    the current stream (inputs already checked; ``packed`` from
    pack_block_params at ``intr_w``). ``kd`` and ``kmask`` for one rig or
    R rigs of n_cams cameras, as ``_launch_mixed``."""
    from pycamset_tpu_torch._build import load
    n_rigs = kmask.shape[0] if kmask.dim() == 3 else 1
    bb = mask.shape[0]
    cams = n_rigs * n_cams
    cw = kmask.shape[-1]
    a = intr_w + 6
    n_entries = gram_entries(a)
    chunk = MIXED_CHUNK
    k, n_tiles, n_chunks = _grid_dims(mask, n_ims, chunk)
    empty = _empty_like_grid(mask)
    hcc, gc, wcc = (empty(cams, a, a), empty(cams, a),
                    empty(cams, a * cw, k))
    wic, wci, gii = empty(bb, 6 * cw, k), empty(bb, a, 6), empty(bb, 6, 6)
    gi, corner = empty(bb, 6), empty(bb)
    hkk, gk = empty(n_rigs, k, cw, cw), empty(n_rigs, k, cw)
    blk_part = empty(n_tiles, bb, n_entries)
    cam_part = empty(cams, n_chunks, n_tiles, n_entries)
    wcc_part = empty(cams, n_chunks, 3 * a, k)
    hk_part = empty(cams * n_chunks, N_HK, k)
    rc = _rig_entry(load().lib, "pct_mixed_gram_fused", intr_w,
                    n_rigs)(
        _ptr(packed), _ptr(kd), _ptr(uv), _ptr(mask),
        _ptr(cmask_b), _ptr(imask_b), _ptr(kmask), cw, n_cams, n_ims, k,
        loss_id, component, float(f_scale), chunk, _ptr(hcc), _ptr(gc),
        _ptr(wcc), _ptr(wic), _ptr(wci), _ptr(gii), _ptr(gi), _ptr(corner),
        _ptr(hkk), _ptr(gk), _ptr(blk_part), _ptr(cam_part), _ptr(wcc_part),
        _ptr(hk_part), torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "mixed_gram_fused")
    if kmask.dim() == 2:
        hkk, gk = hkk[0], gk[0]
    return (hcc, gc, wcc.transpose(1, 2).reshape(cams, k, a, cw),
            wic.transpose(1, 2).reshape(bb, k, 6, cw), wci, gii, gi, corner,
            hkk, gk)


def _make_block_grams(widths, with_key_cols: bool, loss: str,
                      f_scale: float, loss_semantics: str):
    _check_widths(widths, with_key_cols)
    a = widths.a
    w = a + 6

    def grams(cam_b, im_b, keyp, tpl, uv, mask, cmask_b, imask_b, kmask):
        g, wcc_b, wic_b, hkk, gk = mixed_gram(
            cam_b, im_b, keyp, tpl, uv, mask, cmask_b, imask_b, kmask,
            with_key_cols, loss=loss, f_scale=f_scale,
            loss_semantics=loss_semantics)
        return (g[:, :a, :a], g[:, a:w, a:w], g[:, :a, a:w], hkk, wcc_b,
                wic_b, g[:, :a, w], g[:, a:w, w], gk, torch.sum(g[:, w, w]))

    return grams


def make_cuda_mixed_grams(widths, loss: str = "linear", f_scale: float = 1.0,
                          loss_semantics: str = "component"):
    """Per-block gram builder on Kernel F for the MIXED chain (c-axis =
    [group pose 6 | free point 3]); the contract of make_block_grams:
    grams(cam_b, im_b, keyp, tpl, uv, mask, cmask_b, imask_b, kmask) ->
    (gcc_b, gii_b, wci_b, hkk, wck_b, wik_b, gc_b, gi_b, gk, cost); every
    column mask is applied in the kernel."""
    return _make_block_grams(widths, True, loss, f_scale, loss_semantics)


def make_cuda_grouped_grams(widths, loss: str = "linear",
                            f_scale: float = 1.0,
                            loss_semantics: str = "component"):
    """Per-block gram builder on Kernel F for the grouped template chain
    (c-axis = the 6 group-pose columns, the point from tpl); same contract
    as make_cuda_mixed_grams."""
    return _make_block_grams(widths, False, loss, f_scale, loss_semantics)


def make_cuda_mixed_grams_fused(widths, n_cams: int, n_ims: int,
                                loss: str = "linear", f_scale: float = 1.0,
                                loss_semantics: str = "component",
                                with_key_cols: bool = True):
    """Fused-reduction mixed/grouped gram builder on Kernel E; the contract
    of make_pallas_mixed_grams_fused:
    grams(cam_b, im_b, keyp, tpl, uv, mask, cmask_b, imask_b, kmask) ->
    (hcc (C,a,a), hii (I,6,6), hkk_f (K,cw,cw), wci (C,I,a,6),
     wck_f (C,K,a,cw), wik_f (I,K,6,cw), gc (C,a), gi (I,6), gk_f (K,cw),
     cost); every column mask is applied in the kernel.
    """
    _check_widths(widths, with_key_cols)
    a = widths.a

    def grams(cam_b, im_b, keyp, tpl, uv, mask, cmask_b, imask_b, kmask):
        (hcc, gc, wcc, wic_b, wci, gii, gi, corner, hkk,
         gk) = mixed_gram_fused(cam_b, im_b, keyp, tpl, uv, mask, cmask_b,
                                imask_b, kmask, n_cams, n_ims, with_key_cols,
                                loss=loss, f_scale=f_scale,
                                loss_semantics=loss_semantics)
        hii = gii.reshape(n_cams, n_ims, 6, 6).sum(dim=0)
        gi_r = gi.reshape(n_cams, n_ims, 6).sum(dim=0)
        wik = wic_b.reshape((n_cams, n_ims) + wic_b.shape[1:]).sum(dim=0)
        return (hcc, hii, hkk, wci.reshape(n_cams, n_ims, a, 6), wcc, wik,
                gc, gi_r, gk, torch.sum(corner))

    return grams

