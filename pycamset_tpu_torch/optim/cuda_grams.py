"""Template-chain gram kernels: CUDA wrappers and their plain twins.

Counterpart of the template part of ``pycamset_tpu/optim/pallas_grams.py``.
Two hand-written Hopper kernels (``csrc/template_grams.cu``) replace the two
Pallas kernels of the template chain:

- Kernel A, ``template_gram`` <- ``template_gram_pallas``: the extended
  per-block gram [J | r]^T [J | r] (W x W, W = a + 7), corner = (robust)
  cost.
- Kernel B, ``template_gram_fused`` <- ``make_pallas_template_grams_fused``:
  hcc/gc summed over each camera's images, per-block wci/gii/gi/cost.

Each wrapper takes the same tensors on either device. A CPU tensor runs the
plain PyTorch twin (``template_gram_plain``, ``template_gram_fused_plain``:
the closed-form Jacobian of ``analytic.block_rj_template`` and batched
matrix products). A CUDA tensor launches the kernel or raises: there is no
fallback. Each wrapper counts its launches in ``<wrapper>.launches``, and
by camera width in ``<wrapper>.launches_by_width``. The
wrappers call ``torch.library.custom_op``s
(``pycamset_tpu_torch::template_gram{,_fused}``) whose vmap rule folds a
leading rig axis (the fleet, ``optim/fleet.py``) into the block or camera
axis: one launch for every rig.

The builders ``make_cuda_template_grams`` and
``make_cuda_template_grams_fused`` keep the JAX builders' contracts (the
10-tuple of ``make_block_grams``, and the reduced pieces), with the column
masks applied to the kernel outputs in plain torch as the JAX package does.
They serve the camera widths of the JAX kernels (``TEMPLATE_WIDTHS``): a =
15 standard, 14 fisheye, 18 rational, 22 thin-prism, 24 tilted; the kernel
is built at each (``csrc/template_grams.cu``) and the packed row follows the
JAX layout of that width (``pack_block_params``). Another width raises.

``scaled_errors`` and ``scaled_errors_fused`` hold a kernel's outputs
against its twin's entry by entry, in the Jacobi scaling the solver applies.
"""
from __future__ import annotations

import torch
from torch import Tensor

from pycamset_tpu_torch.ops.distortion import (tilt_matrix,
                                               tilt_matrix_jacobian)
from pycamset_tpu_torch.ops.rotations import (rodrigues_jacobian,
                                              rodrigues_to_matrix)
from pycamset_tpu_torch.optim.losses import LOSSES, check_loss_semantics

PPB = 96            # packed per-block row, standard model
GRAM_W = 22         # 15 cam + 6 pose + 1 residual column, standard model
# the camera widths a = intr_w + 6 Kernels A and B serve: fisheye 14,
# standard 15, rational 18, thin-prism 22, tilted 24
TEMPLATE_WIDTHS = (14, 15, 18, 22, 24)
# the end of every kernel's width refusal: the one other width a chain
# reaches, a heterogeneous rig's selector row, has no kernel
NO_KERNEL_WIDTH = ("a heterogeneous rig's selector row (a = 16) takes "
                   "structured.make_het_grams: the JAX package has no "
                   "kernel for it either")
FUSED_CHUNK = 4     # images of one camera per thread block in Kernel B
_LOSS_IDS = {name: i for i, name in enumerate(LOSSES)}  # csrc loss enum


def packed_width(intr_w: int) -> int:
    """PPB of the JAX ``_layout(intr_w)``: 96, 96, 104, 104, 136 at intr_w
    8, 9, 12, 16, 18 (the tilted row appends Mt and its two derivatives)."""
    return -(-(intr_w + (114 if intr_w >= 18 else 87)) // 8) * 8


def pack_block_params(cam_b: torch.Tensor,
                      im_b: torch.Tensor) -> torch.Tensor:
    """(B, intr_w + 6) cam params + (B, 6) poses -> the packed (B, PPB)
    operand of the JAX layout at that intrinsic width: [intr | Re 9 |
    dRe 27 | te 3 | Rp 9 | dRp 27 | tp 3 | ReRp 9], and for the tilted
    model (intr_w 18) [Mt 9 | dMt/dtaux 9 | dMt/dtauy 9], zero-padded to a
    multiple of 8; dR and dMt in closed form (they run inside the captured
    LM step)."""
    bb, a = cam_b.shape
    if a not in TEMPLATE_WIDTHS:
        raise NotImplementedError(
            f"camera width {a} is not a camera model's: the kernels serve "
            f"{TEMPLATE_WIDTHS}; {NO_KERNEL_WIDTH}")
    iw = a - 6
    re = rodrigues_to_matrix(cam_b[:, iw:iw + 3])
    rp = rodrigues_to_matrix(im_b[:, :3])
    parts = [
        cam_b[:, :iw], re.reshape(bb, 9),
        rodrigues_jacobian(cam_b[:, iw:iw + 3]).reshape(bb, 27),
        cam_b[:, iw + 3:iw + 6], rp.reshape(bb, 9),
        rodrigues_jacobian(im_b[:, :3]).reshape(bb, 27), im_b[:, 3:6],
        (re @ rp).reshape(bb, 9)]
    if iw >= 18:
        taux, tauy = cam_b[:, 16], cam_b[:, 17]
        parts += [tilt_matrix(taux, tauy).reshape(bb, 9),
                  *(d.reshape(bb, 9) for d in tilt_matrix_jacobian(taux,
                                                                   tauy))]
    pad = packed_width(iw) - sum(p.shape[1] for p in parts)
    if pad:
        parts.append(cam_b.new_zeros((bb, pad)))
    return torch.cat(parts, dim=1)


def template_gram_plain(cam_b, im_b, tpl, uv, mask, loss: str = "linear",
                        f_scale: float = 1.0,
                        loss_semantics: str = "component") -> torch.Tensor:
    """Plain twin of Kernel A: (B, W, W) extended grams of
    [Jc | Ji | r], W = a + 7, with IRLS-weighted rows and the corner set to
    the block's (robust) cost."""
    from pycamset_tpu_torch.optim.analytic import block_rj_template
    from pycamset_tpu_torch.optim.losses import irls_weigh
    gw = cam_b.shape[-1] + 7
    r, jc, ji, _ = block_rj_template(cam_b, im_b, tpl, uv)
    r, sw, cost_b = irls_weigh(r, mask, loss, f_scale, loss_semantics)
    ext = torch.cat([jc * sw[..., None], ji * sw[..., None], r[..., None]],
                    dim=-1)
    ext = ext.reshape(ext.shape[0], -1, gw)
    g = ext.transpose(1, 2) @ ext
    g[:, gw - 1, gw - 1] = cost_b
    return g


def template_gram_fused_plain(cam_b, im_b, tpl, uv, mask, n_cams: int,
                              n_ims: int, loss: str = "linear",
                              f_scale: float = 1.0,
                              loss_semantics: str = "component"):
    """Plain twin of Kernel B: the per-block grams reduced over images.

    :return: (hcc (C,a,a), gc (C,a), wci (B,a,6), gii (B,6,6),
        gi (B,6), corner (B,)), unmasked.
    """
    return reduce_grams(template_gram_plain(cam_b, im_b, tpl, uv, mask, loss,
                                            f_scale, loss_semantics),
                        n_cams, n_ims)


def reduce_grams(g: torch.Tensor, n_cams: int, n_ims: int):
    """(B, W, W) extended per-block grams -> Kernel B's outputs."""
    w = g.shape[-1] - 1
    a = w - 6
    hcc = g[:, :a, :a].reshape(n_cams, n_ims, a, a).sum(dim=1)
    gc = g[:, :a, w].reshape(n_cams, n_ims, a).sum(dim=1)
    return (hcc, gc, g[:, :a, a:w], g[:, a:w, a:w], g[:, a:w, w],
            g[:, w, w])


def _jacobi_scale(diag: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(diag, min=torch.finfo(diag.dtype).tiny))


def _worst(err: torch.Tensor) -> float:
    return float(err.abs().max()) if err.numel() else 0.0


def scaled_errors(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """Worst error of Kernel A's grams against reference grams, per piece.

    Each entry is measured in the Jacobi scaling the solver applies:
    |g_ij - r_ij| / (s_i s_j) with s = sqrt(diag(ref)), whose last entry is
    sqrt(cost). So a Jacobian entry reads |g_ij - r_ij| / sqrt(r_ii r_jj), a
    gradient entry |g_i - r_i| / sqrt(r_ii cost), the cost |g - r| / cost.
    A column of small entries (the principal point, the distortion) is held
    to its own size, not to the largest entry of the gram.
    """
    ref = ref.double()
    s = _jacobi_scale(torch.diagonal(ref, dim1=1, dim2=2))
    e = (got.double().to(ref.device) - ref) / (s[:, :, None] * s[:, None, :])
    w = ref.shape[-1] - 1
    a = w - 6
    return {"gcc": _worst(e[:, :a, :a]), "gii": _worst(e[:, a:w, a:w]),
            "wci": _worst(e[:, :a, a:w]), "gc": _worst(e[:, :a, w]),
            "gi": _worst(e[:, a:w, w]), "cost": _worst(e[:, w, w])}


def scaled_errors_fused(got, ref, ref_gram: torch.Tensor, n_cams: int,
                        n_ims: int) -> dict:
    """Worst error of Kernel B's outputs against reference outputs, per
    output, in the Jacobi scaling of ``scaled_errors``: hcc and gc by each
    camera's reduced diagonal and cost, the per-block pieces by the
    block's own, read from ``ref_gram`` (the reference (B, W, W) grams
    of the same inputs)."""
    ref = [r.double() for r in ref]
    got = [g.double().to(r.device) for g, r in zip(got, ref)]
    hcc, gc, wci, gii, gi, corner = (g - r for g, r in zip(got, ref))
    cost_c = ref[5].reshape(n_cams, n_ims).sum(dim=1)
    s_c = _jacobi_scale(torch.cat(
        [torch.diagonal(ref[0], dim1=1, dim2=2), cost_c[:, None]], dim=1))
    s_b = _jacobi_scale(torch.diagonal(ref_gram.double(), dim1=1, dim2=2))
    w = ref_gram.shape[-1] - 1
    a = w - 6
    return {
        "hcc": _worst(hcc / (s_c[:, :a, None] * s_c[:, None, :a])),
        "gc": _worst(gc / (s_c[:, :a] * s_c[:, a:])),
        "wci": _worst(wci / (s_b[:, :a, None] * s_b[:, None, a:w])),
        "gii": _worst(gii / (s_b[:, a:w, None] * s_b[:, None, a:w])),
        "gi": _worst(gi / (s_b[:, a:w] * s_b[:, w:])),
        "corner": _worst(corner / s_b[:, w] ** 2)}


def _check_cuda_inputs(cam_b, im_b, tpl, uv, mask, **masks):
    """Raise unless the kernel takes these tensors as they are. ``tpl`` is
    the (K, 3) point table (the template, or the free points); the camera
    width must be one the kernels are built at (``TEMPLATE_WIDTHS``);
    ``masks`` are column masks among cmask_b (B, a), imask_b (B, 6),
    kmask (K, 3)."""
    tensors = {"cam_b": cam_b, "im_b": im_b, "tpl": tpl, "uv": uv,
               "mask": mask, **masks}
    dev = cam_b.device
    for name, x in tensors.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, cam_b on {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} is {x.dtype}; the CUDA kernels take "
                            f"torch.float32")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    bb, k = mask.shape
    a = cam_b.shape[1]
    if a not in TEMPLATE_WIDTHS:
        raise NotImplementedError(
            f"camera width {a} has no kernel: it serves the camera widths "
            f"{TEMPLATE_WIDTHS}; {NO_KERNEL_WIDTH}")
    want = {"cam_b": (bb, a), "im_b": (bb, 6), "tpl": (k, 3),
            "uv": (bb, k, 2), "cmask_b": (bb, a), "imask_b": (bb, 6),
            "kmask": (k, 3)}
    for name in tensors.keys() - {"mask"}:
        shape = want[name]
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(tensors[name].shape)}"
                             f", expected {shape}")


def _ptr(x: torch.Tensor) -> int:
    return x.data_ptr()


def _loss_args(loss: str, loss_semantics: str):
    if loss not in _LOSS_IDS:
        raise ValueError(f"unknown loss {loss!r}; options: {tuple(_LOSS_IDS)}")
    check_loss_semantics(loss_semantics)
    return _LOSS_IDS[loss], int(loss_semantics == "component")


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def template_gram(cam_b, im_b, tpl, uv, mask, loss: str = "linear",
                  f_scale: float = 1.0,
                  loss_semantics: str = "component") -> torch.Tensor:
    """Kernel A: (B, W, W) extended per-block grams (corner = cost),
    W = a + 7.

    :param cam_b: (B, a), a in ``TEMPLATE_WIDTHS``. :param im_b: (B, 6).
    :param tpl: (K, 3).
    :param uv: (B, K, 2). :param mask: (B, K).

    Under ``torch.func.vmap`` over a leading rig axis (the fleet) the rigs'
    blocks fold into one launch of (R*B) blocks (``_fold_rigs``).
    """
    return _template_gram_op(cam_b, im_b, tpl, uv, mask, loss,
                             float(f_scale), loss_semantics)


template_gram.launches = 0
template_gram.launches_by_width = dict.fromkeys(TEMPLATE_WIDTHS, 0)


@torch.library.custom_op("pycamset_tpu_torch::template_gram",
                         mutates_args=())
def _template_gram_op(cam_b: Tensor, im_b: Tensor, tpl: Tensor, uv: Tensor,
                      mask: Tensor, loss: str, f_scale: float,
                      loss_semantics: str) -> Tensor:
    if cam_b.device.type == "cpu":
        return template_gram_plain(cam_b, im_b, tpl, uv, mask, loss,
                                   f_scale, loss_semantics)
    loss_id, component = _loss_args(loss, loss_semantics)
    _check_cuda_inputs(cam_b, im_b, tpl, uv, mask)
    intr_w = cam_b.shape[1] - 6
    with torch.cuda.device(cam_b.device):
        out = _launch_gram(pack_block_params(cam_b, im_b), tpl, uv, mask,
                           loss_id, component, f_scale, intr_w)
    template_gram.launches += 1
    template_gram.launches_by_width[intr_w + 6] += 1
    return out


@_template_gram_op.register_vmap
def _template_gram_vmap(info, in_dims, cam_b, im_b, tpl, uv, mask, loss,
                        f_scale, loss_semantics):
    r = info.batch_size
    cam_b, im_b, uv, mask = _fold_rigs(r, in_dims, cam_b, im_b, tpl, uv,
                                       mask)
    out = _template_gram_op(cam_b, im_b, tpl, uv, mask, loss, f_scale,
                            loss_semantics)
    return _unfold(r, out), 0


def _fold_rigs(r: int, in_dims, cam_b, im_b, tpl, uv, mask):
    """The per-block operands of R rigs with their rig axis folded into the
    block axis, rig-major: (R, B, ...) -> (R*B, ...), contiguous. An
    operand that arrives without a rig axis is shared by every rig. The
    point table must arrive without one: the rigs of a fleet share one
    calibration target (a structure check, no device read)."""
    if in_dims[2] is not None:
        raise ValueError(
            "the point table arrived with a rig axis: the rigs of a fleet "
            "must share one calibration target (pass it unbatched)")
    out = []
    for x, d in zip((cam_b, im_b, uv, mask), in_dims[:2] + in_dims[3:5]):
        x = x.expand(r, *x.shape) if d is None else x.movedim(d, 0)
        out.append(x.reshape(r * x.shape[1], *x.shape[2:]).contiguous())
    return out


def _unfold(r: int, x: Tensor) -> Tensor:
    """(R*N, ...) -> (R, N, ...)."""
    return x.reshape(r, x.shape[0] // r, *x.shape[1:])


def _model_entry(lib, name: str, intr_w: int):
    """The C entry of a kernel at intrinsic width ``intr_w``: the standard
    model's own (``name``), or ``name + "_model"`` with the width as its
    first argument."""
    if intr_w == 9:
        return getattr(lib, name)
    fn = getattr(lib, name + "_model")
    return lambda *args: fn(intr_w, *args)


def _rig_entry(lib, name: str, intr_w: int, n_rigs: int):
    """The C entry of a key-column kernel (C-F) at intrinsic width
    ``intr_w`` over ``n_rigs`` rigs: the one-rig entry (``_model_entry``)
    for one rig, else ``name + "_rigs"`` with the width and the rig count
    as its first arguments (one launch over every rig)."""
    if n_rigs == 1:
        return _model_entry(lib, name, intr_w)
    fn = getattr(lib, name + "_rigs")
    return lambda *args: fn(intr_w, n_rigs, *args)


def _launch_gram(packed, tpl, uv, mask, loss_id, component, f_scale,
                 intr_w: int = 9):
    """Allocate Kernel A's output and launch it on the current stream
    (inputs already checked; ``packed`` from pack_block_params at
    ``intr_w``)."""
    from pycamset_tpu_torch._build import load
    bb, k = mask.shape
    gw = intr_w + 13
    out = torch.empty((bb, gw, gw), dtype=torch.float32, device=mask.device)
    rc = _model_entry(load().lib, "pct_template_gram", intr_w)(
        _ptr(packed), _ptr(tpl), _ptr(uv), _ptr(mask), _ptr(out), bb, k,
        loss_id, component, float(f_scale),
        torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "template_gram")
    return out


def template_gram_fused(cam_b, im_b, tpl, uv, mask, n_cams: int, n_ims: int,
                        loss: str = "linear", f_scale: float = 1.0,
                        loss_semantics: str = "component"):
    """Kernel B: (hcc (C,a,a), gc (C,a), wci (B,a,6), gii (B,6,6),
    gi (B,6), corner (B,)), unmasked, over B = n_cams * n_ims
    camera-major blocks; any n_ims, no padding; a in ``TEMPLATE_WIDTHS``.

    Under ``torch.func.vmap`` over a leading rig axis (the fleet) the R
    rigs' cameras fold into Kernel B's camera axis, camera-major within
    each rig: ONE launch over R * n_cams cameras (``_fold_rigs``), its
    outputs unfolded to (R, C, ...) and (R, B, ...).
    """
    return _template_gram_fused_op(cam_b, im_b, tpl, uv, mask, n_cams,
                                   n_ims, loss, float(f_scale),
                                   loss_semantics)


template_gram_fused.launches = 0
template_gram_fused.launches_by_width = dict.fromkeys(TEMPLATE_WIDTHS, 0)


@torch.library.custom_op("pycamset_tpu_torch::template_gram_fused",
                         mutates_args=())
def _template_gram_fused_op(
        cam_b: Tensor, im_b: Tensor, tpl: Tensor, uv: Tensor, mask: Tensor,
        n_cams: int, n_ims: int, loss: str, f_scale: float,
        loss_semantics: str) -> tuple[Tensor, Tensor, Tensor, Tensor,
                                      Tensor, Tensor]:
    if cam_b.device.type == "cpu":
        # an operator's outputs may not alias each other: the per-block
        # pieces are views of one gram
        return tuple(t.clone() for t in template_gram_fused_plain(
            cam_b, im_b, tpl, uv, mask, n_cams, n_ims, loss, f_scale,
            loss_semantics))
    loss_id, component = _loss_args(loss, loss_semantics)
    _check_cuda_inputs(cam_b, im_b, tpl, uv, mask)
    if mask.shape[0] != n_cams * n_ims:
        raise ValueError(f"{mask.shape[0]} blocks, expected {n_cams} x "
                         f"{n_ims}")
    with torch.cuda.device(cam_b.device):
        out = _launch_gram_fused(pack_block_params(cam_b, im_b), tpl, uv,
                                 mask, n_cams, n_ims, loss_id, component,
                                 f_scale, cam_b.shape[1] - 6)
    template_gram_fused.launches += 1
    template_gram_fused.launches_by_width[cam_b.shape[1]] += 1
    return out


@_template_gram_fused_op.register_vmap
def _template_gram_fused_vmap(info, in_dims, cam_b, im_b, tpl, uv, mask,
                              n_cams, n_ims, loss, f_scale, loss_semantics):
    r = info.batch_size
    cam_b, im_b, uv, mask = _fold_rigs(r, in_dims, cam_b, im_b, tpl, uv,
                                       mask)
    out = _template_gram_fused_op(cam_b, im_b, tpl, uv, mask, r * n_cams,
                                  n_ims, loss, f_scale, loss_semantics)
    return tuple(_unfold(r, t) for t in out), (0,) * len(out)


def _launch_gram_fused(packed, tpl, uv, mask, n_cams, n_ims, loss_id,
                       component, f_scale, intr_w: int = 9):
    """Allocate Kernel B's outputs and scratch and launch its two passes
    on the current stream (inputs already checked)."""
    from pycamset_tpu_torch._build import load
    bb, k = mask.shape
    a = intr_w + 6

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=mask.device)

    hcc, gc = empty(n_cams, a, a), empty(n_cams, a)
    wci, gii, gi, corner = (empty(bb, a, 6), empty(bb, 6, 6), empty(bb, 6),
                            empty(bb))
    # the chunks' hcc upper triangles and gc: 135 at the standard model
    cam_part = empty(n_cams, -(-n_ims // FUSED_CHUNK), a * (a + 1) // 2 + a)
    rc = _model_entry(load().lib, "pct_template_gram_fused", intr_w)(
        _ptr(packed), _ptr(tpl), _ptr(uv), _ptr(mask), n_cams, n_ims, k,
        loss_id, component, float(f_scale), FUSED_CHUNK, _ptr(hcc), _ptr(gc),
        _ptr(wci), _ptr(gii), _ptr(gi), _ptr(corner), _ptr(cam_part),
        torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "template_gram_fused")
    return hcc, gc, wci, gii, gi, corner


def _check_template_widths(widths):
    if (widths.b, widths.c) != (6, 0) or widths.a not in TEMPLATE_WIDTHS:
        raise NotImplementedError(
            f"widths {widths} have no kernel: the kernels serve the "
            f"template chain (b=6, c=0) at the camera widths "
            f"{TEMPLATE_WIDTHS}; {NO_KERNEL_WIDTH}")


def make_cuda_template_grams(widths, loss: str = "linear",
                             f_scale: float = 1.0,
                             loss_semantics: str = "component"):
    """Per-block gram builder on Kernel A; the contract of
    make_block_grams for the template chain:
    grams(cam_b, im_b, keyp, tpl, uv, mask, cmask_b, imask_b, kmask) ->
    (gcc_b, gii_b, wci_b, hkk, wck_b, wik_b, gc_b, gi_b, gk, cost).
    """
    a, bw = widths.a, widths.b
    _check_template_widths(widths)

    def grams(cam_b, im_b, keyp, tpl, uv, mask, cmask_b, imask_b, kmask):
        g = template_gram(cam_b, im_b, tpl, uv, mask, loss=loss,
                          f_scale=f_scale, loss_semantics=loss_semantics)
        w = a + bw
        cost = torch.sum(g[:, w, w])
        gcc_b = g[:, :a, :a] * cmask_b[:, :, None] * cmask_b[:, None, :]
        gii_b = g[:, a:w, a:w] * imask_b[:, :, None] * imask_b[:, None, :]
        wci_b = g[:, :a, a:w] * cmask_b[:, :, None] * imask_b[:, None, :]
        gc_b = g[:, :a, w] * cmask_b
        gi_b = g[:, a:w, w] * imask_b
        bb, k_pad = mask.shape
        z = uv.new_zeros
        return (gcc_b, gii_b, wci_b, z((k_pad, 0, 0)), z((bb, k_pad, a, 0)),
                z((bb, k_pad, bw, 0)), gc_b, gi_b, z((k_pad, 0)), cost)

    return grams


def make_cuda_template_grams_fused(widths, n_cams: int, n_ims: int,
                                   loss: str = "linear", f_scale: float = 1.0,
                                   loss_semantics: str = "component"):
    """Fused-reduction template gram builder on Kernel B; the contract of
    make_pallas_template_grams_fused:
    grams(cam_b, im_b, tpl, uv, mask, cmask_b, imask_b) ->
    (hcc (C,a,a), hii (I,6,6), wci (C,I,a,6), gc (C,a), gi (I,6), cost).
    """
    a = widths.a
    _check_template_widths(widths)

    def grams(cam_b, im_b, tpl, uv, mask, cmask_b, imask_b):
        hcc, gc, wci, gii, gi, corner = template_gram_fused(
            cam_b, im_b, tpl, uv, mask, n_cams, n_ims, loss=loss,
            f_scale=f_scale, loss_semantics=loss_semantics)
        # column masks on the reduced pieces (cmask is constant over a
        # camera's images, imask over an image's cameras)
        cm = cmask_b.reshape(n_cams, n_ims, a)[:, 0]
        imk = imask_b.reshape(n_cams, n_ims, 6)
        hcc = hcc * cm[:, :, None] * cm[:, None, :]
        wci = (wci.reshape(n_cams, n_ims, a, 6)
               * cm[:, None, :, None] * imk[:, :, None, :])
        hii = torch.sum(gii.reshape(n_cams, n_ims, 6, 6)
                        * imk[:, :, :, None] * imk[:, :, None, :], dim=0)
        gi_r = torch.sum(gi.reshape(n_cams, n_ims, 6) * imk, dim=0)
        return hcc, hii, wci, gc * cm, gi_r, torch.sum(corner)

    return grams
