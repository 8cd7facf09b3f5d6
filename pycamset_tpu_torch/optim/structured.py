"""Structured (block) normal equations + Schur step: the template,
self-calibration, pose-free free-point and grouped multi-target chains.

Counterpart of the template (c = 0), self-calibration (c = 3), free-point
(b = 0, c = 3) and grouped (c = 6, PER_GROUP) slices of
``pycamset_tpu/optim/structured.py``; the names and contracts are the
same. Detections lie on a dense (B, K) grid, B = n_cams * n_ims blocks (one
per camera-image pair, camera-major) and K padded keys. Every slot of a
block shares the same camera and pose parameters, so the Jacobian splits by
link into Jc (camera columns) and Ji (pose columns), and the normal
equations assemble as per-block grams:

    Hcc (C,a,a)   = sum over a camera's blocks of Jc^T Jc
    Hii (I,b,b)   = sum over an image's blocks of Ji^T Ji
    Wci (C,I,a,b) = per-block Jc^T Ji  (a block IS one (c,i) pair)

and, for the self-calibration chain (free target points, c = 3 per key),

    Hkk (K,c,c)   = sum over a key's blocks of Jk^T Jk
    Wck (C,K,a,c) = sum over a camera's blocks of Jc^T Jk, per key
    Wik (I,K,b,c) = sum over an image's blocks of Ji^T Jk, per key

For the grouped chain (one SE(3) per rigid target, c = 6 per GROUP) the
same pieces come per key, with the group poses expanded onto the key grid
by a (K, G) one-hot, and reduce back to per-group blocks through it. The
mixed chain (per-key points AND per-group poses) has its own normal
equations in ``optim/structured_mixed.py``.

The grams come from hand-written CUDA kernels on a card
(``optim/cuda_grams.py``, ``optim/cuda_selfcal_grams.py``,
``optim/cuda_mixed_grams.py``) and from their plain PyTorch twins on the
CPU; the choice between the per-block kernel and the fused-reduction kernel
of a chain follows the JAX package's padding rule (``resolve_fused_grams``),
on either device.

Without point blocks the Schur step eliminates the exactly block-diagonal
pose system in batch and solves the dense (C*a) camera system. With them it
eliminates the points first and solves the dense (C*a + I*b) system (C*a
for the pose-free chain, whose image piece is zero-width). Above 4096
reduced dimensions (``auto_reduced_solver``) the reduced system is solved
matrix-free instead, by block-Jacobi preconditioned conjugate gradients
(``schur_solve(method="cg")``: plain torch, ``cg_maxiter`` masked
iterations, so the loop captures in the LM step's CUDA graph and batches
under ``torch.func.vmap``). The
dense solve (``_psd_solve``) goes through ``torch.linalg.cholesky_ex`` by
default, or, opted in with ``PYCAMSET_PALLAS_CHOL=1`` on a card, through the
hand-written one-launch kernel of ``ops/cuda_cholesky.py``. Fixed
parameters are handled by zeroing Jacobian COLUMNS (the column masks); a
damping floor keeps the eliminated blocks invertible and gives exact zero
steps for them.

A heterogeneous rig (``ProjectionHet``: fisheye beside Brown cameras) on
the template, self-calibration or free-point chain takes the plain closed
form (``make_het_grams``) on either device: neither package has a kernel
for its selector row. A Brown rig of several widths runs the widest
model's chain, on its kernels, with the pinned columns in the column
masks.

Every other chain that ``chain_widths`` accepts (the rolling-shutter chain
``Projection + Extrinsic3D + RSPoseVel + RSTemplateTime``, whose observation
grid carries the normalised image row after [u, v]; the heterogeneous
grouped chain; a chain with a block of the caller's own) takes the
forward-mode route, ``make_block_grams``: the JAX package's ``jax.jacfwd``
route, here ``torch.func.jvp`` over the chain, contracted into the same
per-block grams by library products. The JAX package computes it in XLA,
outside any Pallas kernel, so no hand-written kernel serves it here either.
``chain_family`` names the closed form of a chain, or None: it selects, it
does not refuse.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from pycamset_tpu_torch.ops.cuda_cholesky import psd_solve, use_cuda_psd
from pycamset_tpu_torch.optim.blocks import key_type
from pycamset_tpu_torch.optim.chain import OptimFunction
from pycamset_tpu_torch.optim.cuda_grams import TEMPLATE_WIDTHS

# The JAX package's fused-kernel tiles: the selection rule below pads the
# image axis to them (pycamset_tpu/optim/pallas_grams.py BLOCK_TILE; the
# self-cal family takes 16 or 8, whichever pads less). The CUDA fused
# kernels need no padding; the rule is kept so both packages choose the same
# kernel family on the same rig.
FUSED_PAD_TILE = 16
FUSED_PAD_FRAC = 0.05
SELFCAL_PAD_TILES = (16, 8)
SELFCAL_PAD_FRAC = 0.25
# the multi-target (grouped and mixed) family: tile 8, 25%
MIXED_PAD_TILE = 8
MIXED_PAD_FRAC = 0.25
# the projection blocks of the five camera models (a chain's first block)
_PROJS = ("Projection", "ProjectionRational", "ProjectionThinPrism",
          "ProjectionTilted", "ProjectionFisheye")
# chain family by block names (the projection block read as "Projection"),
# with its (b, c) widths
_FAMILIES = {
    ("Projection", "Extrinsic3D", "TemplatePoints"): ("template", (6, 0)),
    ("Projection", "Extrinsic3D", "RigidTform3d", "FreePoint"):
        ("selfcal", (6, 3)),
    ("Projection", "Extrinsic3D", "FreePoint"): ("freepoint", (0, 3)),
    ("Projection", "Extrinsic3D", "RigidTform3d", "GroupTemplatePoints"):
        ("grouped", (6, 6)),
}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class GroupWidths:
    """Per-link local Jacobian column widths for a chain."""
    a: int  # cam-linked params per camera (9 intr + 6 extr = 15)
    b: int  # image-linked params per image (6)
    c: int  # key-linked params per point (0 for the template chain)
    key_link: key_type = key_type.PER_KEY

    @property
    def local(self):
        return self.a + self.b + self.c


class UnsupportedChain(ValueError):
    """The chain does not fit the structured block layout."""


def chain_widths(op_fun: OptimFunction) -> GroupWidths:
    """Column widths by link."""
    a = b = c = 0
    key_link = key_type.PER_KEY
    for g in op_fun.groups:
        if g.link == key_type.PER_CAM:
            a += g.n
        elif g.link == key_type.PER_IMG:
            b += g.n
        elif g.link in (key_type.PER_KEY, key_type.PER_GROUP):
            c += g.n
            if g.link == key_type.PER_GROUP:
                key_link = key_type.PER_GROUP
        else:
            raise UnsupportedChain(
                f"{g.link.name} groups unsupported on the structured path")
    if (key_link == key_type.PER_GROUP
            and any(g.link == key_type.PER_KEY for g in op_fun.groups)):
        raise UnsupportedChain(
            "chains mixing PER_KEY and PER_GROUP use the generic path")
    return GroupWidths(a, b, c, key_link)


def is_het_chain(op_fun: OptimFunction) -> bool:
    """Whether the chain projects through ``ProjectionHet`` (a rig mixing
    fisheye with Brown cameras)."""
    return bool(op_fun.blocks) and type(op_fun.blocks[0]).__name__ == (
        "ProjectionHet")


def chain_family(op_fun: OptimFunction, widths: GroupWidths) -> str | None:
    """The closed form that serves a chain: 'template', 'selfcal',
    'freepoint' or 'grouped', by the chain's block names (any camera
    model's projection block first) and widths, as the JAX package's
    ``analytic_block_rj_for_chain`` selects; or None, and the chain takes
    the forward-mode route (``make_block_grams``). The kernels (A-F) serve
    the five camera widths (``TEMPLATE_WIDTHS``); a ``ProjectionHet``
    chain of the template, self-cal or free-point family takes its plain
    closed form (``make_het_grams``), its grouped chain the forward-mode
    route (the JAX package has no closed form for it). A chain reaches a
    kernel by its names, never by its width alone."""
    names = tuple(type(bk).__name__ for bk in op_fun.blocks)
    het = is_het_chain(op_fun)
    key = (("Projection",) + names[1:]
           if names and (names[0] in _PROJS or het) else names)
    family, bc = _FAMILIES.get(key, (None, None))
    if family is None or (widths.b, widths.c) != bc:
        return None
    if het:
        return None if family == "grouped" else family
    return family if widths.a in TEMPLATE_WIDTHS else None


@dataclass
class BlockArrays:
    """Dense (B, K) observation grid. B = n_cams * n_ims row-major blocks."""
    uv: np.ndarray        # (B, K, 2 + A): [u, v | aux channels]
    mask: np.ndarray      # (B, K)
    n_cams: int
    n_ims: int
    n_keys: int           # true key count (K may be padded)
    n_real: int           # real observation count

    def as_device(self, device, dtype):
        return (torch.as_tensor(self.uv, dtype=dtype, device=device),
                torch.as_tensor(self.mask, dtype=dtype, device=device))


def build_block_arrays(dd: np.ndarray, n_cams: int, n_ims: int,
                       n_keys: int, k_pad_multiple: int = 128,
                       aux: np.ndarray | None = None) -> BlockArrays:
    """Pack a flat detection table [cam, im, key, u, v] onto the block grid.

    :param aux: optional (N, A) per-detection auxiliary channels (the
        rolling-shutter normalised row), stored as trailing columns of the
        uv grid ((B, K, 2 + A)); the forward-mode builder splits them off.
    """
    k_pad = _round_up(max(n_keys, 1), k_pad_multiple)
    b = n_cams * n_ims
    width = 2 + (aux.shape[1] if aux is not None else 0)
    uv = np.zeros((b, k_pad, width))
    mask = np.zeros((b, k_pad))
    cam = dd[:, 0].astype(int)
    im = dd[:, 1].astype(int)
    key = dd[:, 2].astype(int)
    blk = cam * n_ims + im
    uv[blk, key, :2] = dd[:, 3:5]
    if aux is not None:
        uv[blk, key, 2:] = aux
    mask[blk, key] = 1.0
    return BlockArrays(uv=uv, mask=mask, n_cams=n_cams, n_ims=n_ims,
                       n_keys=n_keys, n_real=dd.shape[0])


class ParamPieces(NamedTuple):
    """Parameters grouped by link. Absent groups are zero-width tensors."""
    cam: torch.Tensor   # (C, a)
    im: torch.Tensor    # (I, b)
    key: torch.Tensor   # (K, c)


class NormalEq(NamedTuple):
    """Structured damped-Newton system pieces (see module docstring)."""
    hcc: torch.Tensor   # (C, a, a)
    hii: torch.Tensor   # (I, b, b)
    hkk: torch.Tensor   # (K, c, c)
    wci: torch.Tensor   # (C, I, a, b)
    wck: torch.Tensor   # (C, K, a, c)
    wik: torch.Tensor   # (I, K, b, c)
    gc: torch.Tensor    # (C, a)
    gi: torch.Tensor    # (I, b)
    gk: torch.Tensor    # (K, c)
    cost: torch.Tensor  # scalar


def split_full_params(full: torch.Tensor, op_fun: OptimFunction,
                      struct, n_cams: int, n_ims: int, n_keys: int,
                      widths: GroupWidths) -> ParamPieces:
    """Full [group-major] parameter vector -> per-link (count, width) pieces."""
    cam_parts, im_parts, key_parts = [], [], []
    for gi_, g in enumerate(op_fun.groups):
        sl = struct.group_slice(gi_)
        chunk = full[sl.start:sl.stop]
        if g.link == key_type.PER_CAM:
            cam_parts.append(chunk.reshape(n_cams, g.n))
        elif g.link == key_type.PER_IMG:
            im_parts.append(chunk.reshape(n_ims, g.n))
        elif g.link in (key_type.PER_KEY, key_type.PER_GROUP):
            key_parts.append(chunk.reshape(struct.counts[gi_], g.n))
    z = full[:0]
    cam = torch.cat(cam_parts, dim=1) if cam_parts else z.reshape(n_cams, 0)
    im = torch.cat(im_parts, dim=1) if im_parts else z.reshape(n_ims, 0)
    key = torch.cat(key_parts, dim=1) if key_parts else z.reshape(n_keys, 0)
    return ParamPieces(cam, im, key)


def merge_pieces_to_full(pieces: ParamPieces, op_fun: OptimFunction, struct,
                         n_cams: int, n_ims: int,
                         n_keys: int) -> torch.Tensor:
    """Inverse of split_full_params."""
    chunks = []
    cam_off = im_off = key_off = 0
    for g in op_fun.groups:
        if g.link == key_type.PER_CAM:
            chunks.append(pieces.cam[:, cam_off:cam_off + g.n].reshape(-1))
            cam_off += g.n
        elif g.link == key_type.PER_IMG:
            chunks.append(pieces.im[:, im_off:im_off + g.n].reshape(-1))
            im_off += g.n
        elif g.link in (key_type.PER_KEY, key_type.PER_GROUP):
            chunks.append(pieces.key[:, key_off:key_off + g.n].reshape(-1))
            key_off += g.n
    return torch.cat(chunks)


def pad_template_table(tpl_tab, templated: bool, n_keys: int,
                       k_pad: int) -> np.ndarray:
    """(k_pad, 3) host template table; pad rows REPLICATE a real point (a
    zero pad point can project at z=0 -> inf*0 = NaN poisons the grams;
    replicated rows stay finite and are killed by the slot mask)."""
    tpl_pad = np.zeros((k_pad, 3))
    if tpl_tab is not None and templated:
        flat = np.asarray(tpl_tab).reshape(-1, 3)
        tpl_pad[:n_keys] = flat
        tpl_pad[n_keys:] = flat[0]
    return tpl_pad


def pad_pieces_to_grid(p: ParamPieces, widths: GroupWidths, grouped: bool,
                       n_keys: int, k_pad: int, n_ims: int,
                       n_ims_grid: int) -> ParamPieces:
    """A rig's pieces on the (k_pad, n_ims_grid) device grid: pad key rows
    replicate key 0 and pad image rows image 0 (their masks are zero, but
    a real value keeps the projection finite); PER_GROUP key pieces keep
    their (G, c) shape."""
    if widths.c and not grouped:
        key = torch.cat([p.key, p.key[:1].expand(k_pad - n_keys, -1)])
    elif widths.c:
        key = p.key
    else:
        key = p.cam.new_zeros((k_pad, 0))
    if widths.b:
        im = torch.cat([p.im, p.im[:1].expand(n_ims_grid - n_ims, -1)])
    else:
        im = p.cam.new_zeros((n_ims_grid, 0))
    return ParamPieces(p.cam, im, key)


def auto_reduced_solver(widths: GroupWidths, n_cams: int,
                        n_ims_grid: int) -> str:
    """The reduced_solver='auto' rule: dense Cholesky up to 4096 reduced
    dims, matrix-free CG above. Chains without point blocks count only the
    camera system (their pose system is eliminated in batch)."""
    dim = n_cams * widths.a + n_ims_grid * widths.b
    if widths.c == 0 and widths.b:
        dim = n_cams * widths.a
    return "cg" if dim > 4096 else "dense"


def fused_tile_pad_ok(n_ims: int, tile: int = FUSED_PAD_TILE,
                      frac: float = FUSED_PAD_FRAC) -> bool:
    """The JAX package's fused-kernel acceptance rule: pad the image axis
    to the block tile only when the padding stays under ``frac`` of the
    real images."""
    i_pad = -(-n_ims // tile) * tile
    return (i_pad - n_ims) <= frac * n_ims


def selfcal_pad_tile(n_ims: int) -> int:
    """The self-cal family's tile: 16, or 8 where that pads less."""
    return min(SELFCAL_PAD_TILES, key=lambda t: -(-n_ims // t) * t)


def resolve_block_grams(op_fun: OptimFunction, widths: GroupWidths,
                        loss: str = "linear", f_scale: float = 1.0,
                        loss_semantics: str = "component"):
    """Per-BLOCK gram builder (the 10-tuple contract of the JAX package's
    make_block_grams): Kernel A's (template), Kernel D's (self-cal; the
    free-point wrapper over it for the pose-free chain) or Kernel F's
    (grouped) builder, which launches the CUDA kernel for CUDA tensors and
    runs its plain twin for CPU tensors. A ``ProjectionHet`` chain of
    those families takes ``make_het_grams``, and every other chain the
    forward-mode route ``make_block_grams``, on either device (no kernel:
    the JAX package runs both in XLA)."""
    kw = dict(loss=loss, f_scale=f_scale, loss_semantics=loss_semantics)
    family = chain_family(op_fun, widths)
    if family is None:
        return make_block_grams(op_fun, widths, **kw)
    if is_het_chain(op_fun):
        return make_het_grams(family, op_fun.blocks[0].brown_n_dist, **kw)
    if family in ("selfcal", "freepoint"):
        from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
        if family == "freepoint":
            return sg.make_cuda_freepoint_grams(widths, **kw)
        return sg.make_cuda_selfcal_grams(widths, **kw)
    if family == "grouped":
        from pycamset_tpu_torch.optim import cuda_mixed_grams as mg
        return mg.make_cuda_grouped_grams(widths, **kw)
    from pycamset_tpu_torch.optim import cuda_grams as cg
    return cg.make_cuda_template_grams(widths, **kw)


def resolve_fused_grams(op_fun: OptimFunction, widths: GroupWidths,
                        n_cams: int, n_ims: int, loss: str = "linear",
                        f_scale: float = 1.0,
                        loss_semantics: str = "component"):
    """The FUSED-reduction gram builder, or None when the JAX package's
    padding rule declines it: the template image axis would pad past 5% at
    tile 16, the self-cal and free-point ones past 25% at their tile
    (``selfcal_pad_tile``), the grouped one past 25% at tile 8; and for a
    chain no kernel family serves (``chain_family`` None, or a
    ``ProjectionHet`` chain), which has no fused kernel in either package.

    :return: (family, grams) or None.
        "template": grams(cam_b, im_b, tpl, uv, mask, cmask_b, imask_b)
                    -> (hcc, hii, wci, gc, gi, cost)
        "selfcal":  grams(cam_b, im_b, keyp, uv, mask, cmask_b, imask_b,
                    kmask) -> the 10 NormalEq fields
        "freepoint": the same signature (im_b and imask_b not read) ->
                    (hcc, hkk, wck, gc, gk, cost)
        "grouped":  grams(cam_b, im_b, keyp, tpl, uv, mask, cmask_b,
                    imask_b, kmask) -> the 10 reduced pieces per KEY (the
                    caller reduces the key-axis pieces with the group
                    one-hot)
    """
    kw = dict(loss=loss, f_scale=f_scale, loss_semantics=loss_semantics)
    family = chain_family(op_fun, widths)
    if family is None or is_het_chain(op_fun):
        return None
    if family == "grouped":
        from pycamset_tpu_torch.optim import cuda_mixed_grams as mg
        if not fused_tile_pad_ok(n_ims, MIXED_PAD_TILE, MIXED_PAD_FRAC):
            return None
        return "grouped", mg.make_cuda_mixed_grams_fused(
            widths, n_cams, n_ims, with_key_cols=False, **kw)
    if family in ("selfcal", "freepoint"):
        from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
        if not fused_tile_pad_ok(n_ims, selfcal_pad_tile(n_ims),
                                 SELFCAL_PAD_FRAC):
            return None
        if family == "freepoint":
            return "freepoint", sg.make_cuda_freepoint_grams_fused(
                widths, n_cams, n_ims, **kw)
        return "selfcal", sg.make_cuda_selfcal_grams_fused(
            widths, n_cams, n_ims, **kw)
    from pycamset_tpu_torch.optim import cuda_grams as cg
    if not fused_tile_pad_ok(n_ims):
        return None
    return "template", cg.make_cuda_template_grams_fused(
        widths, n_cams, n_ims, **kw)


def _grams_of_rj(rj, loss: str, f_scale: float, loss_semantics: str):
    """The per-block 10-tuple of ``make_block_grams``' contract from a
    block residual-and-Jacobian function ``rj(cam_b, im_b, keyp, tpl, uv)
    -> (r (B,K,2), Jc (B,K,2,a), Ji (B,K,2,b), Jk (B,K,2,c))``: the rows
    IRLS-weighted, the columns masked, the grams contracted in plain torch
    (``cuda_selfcal_grams.weighted_grams``). No host read: a captured LM
    step holds it."""
    from pycamset_tpu_torch.optim.cuda_selfcal_grams import weighted_grams

    def grams(cam_b, im_b, keyp, tpl, uv, mask, cmask_b, imask_b, kmask):
        g, wck_b, wik_b, hkk, gk = weighted_grams(
            *rj(cam_b, im_b, keyp, tpl, uv), mask, cmask_b, imask_b, kmask,
            loss, f_scale, loss_semantics)
        a = cam_b.shape[1]
        w = g.shape[-1] - 1
        return (g[:, :a, :a], g[:, a:w, a:w], g[:, :a, a:w], hkk, wck_b,
                wik_b, g[:, :a, w], g[:, a:w, w], gk, torch.sum(g[:, w, w]))

    return grams


def make_block_grams(op_fun: OptimFunction, widths: GroupWidths,
                     loss: str = "linear", f_scale: float = 1.0,
                     loss_semantics: str = "component"):
    """Per-BLOCK gram builder of the forward-mode route: the JAX package's
    ``make_block_grams`` on a chain with no closed form (its ``jax.jacfwd``
    branch, ``pycamset_tpu/optim/structured.py:324-376``), for any chain
    that ``chain_widths`` accepts, groups in any link order.

    Each parameter group's rows come from its link's piece, as views that
    broadcast: a camera or pose group (B, 1, n), a key group (1, K, n), so a
    block's own work (its camera's rotation) is done once a block. The chain
    is evaluated and differentiated in forward mode, group by group
    (``residuals._residual_and_jacobian(by_group=True)``: one
    ``torch.func.jvp`` a parameter, vmapped over the group's basis
    directions), the groups' Jacobians joined into the camera, pose and key
    pieces, and the grams contracted by library products. A chain with aux
    channels (``aux_width``) reads them from uv's trailing columns ([u, v |
    aux]). Every intermediate carries its group's directions, so one
    evaluation holds several times the chain's own working set.

    :return: grams(cam_b, im_b, keyp, tpl, uv, mask, cmask_b, imask_b,
        kmask) -> (gcc_b, gii_b, wci_b, hkk, wck_b, wik_b, gc_b, gi_b,
        gk, cost), the contract of ``resolve_block_grams``' builders."""
    from pycamset_tpu_torch.optim.losses import check_loss_semantics
    from pycamset_tpu_torch.optim.residuals import _residual_and_jacobian
    check_loss_semantics(loss_semantics)
    chain_rj = _residual_and_jacobian(op_fun, by_group=True)
    aux_w = op_fun.aux_width
    # each group's (link, first column in its link's piece, width)
    links = (key_type.PER_CAM, key_type.PER_IMG, key_type.PER_KEY)
    plan, cursor = [], dict.fromkeys(links, 0)
    for g in op_fun.groups:
        link = key_type.PER_KEY if g.link == key_type.PER_GROUP else g.link
        plan.append((link, cursor[link], g.n))
        cursor[link] += g.n

    def rj(cam_b, im_b, keyp, tpl, uv):
        rows = {key_type.PER_CAM: cam_b[:, None], key_type.PER_IMG:
                im_b[:, None], key_type.PER_KEY: keyp[None]}
        params = [rows[link][..., s:s + n] for link, s, n in plan]
        r, jacs = chain_rj(params, tpl, uv[..., :2],
                           uv[..., 2:2 + aux_w] if aux_w else None)
        return (r, *(torch.cat([j for j, (lk, _, _) in zip(jacs, plan)
                                if lk == link]
                               or [r.new_zeros(r.shape + (0,))], dim=-1)
                     for link in links))

    return _grams_of_rj(rj, loss, f_scale, loss_semantics)


def make_het_grams(family: str, brown_n_dist: int, loss: str = "linear",
                   f_scale: float = 1.0, loss_semantics: str = "component"):
    """Per-BLOCK gram builder of a heterogeneous rig's chain (fisheye
    beside Brown cameras, ``ProjectionHet``): the closed form
    ``analytic.block_rj_het`` of the ``family`` ("template", "selfcal" or
    "freepoint") and its weighted grams in plain torch, on either device.
    Neither package has a kernel for it (the JAX package's
    ``resolve_block_grams`` gives it ``make_block_grams``' closed form:
    XLA); this is the chain's route, chosen by its block names, not a
    fallback. Same contract as ``resolve_block_grams``' builders."""
    from pycamset_tpu_torch.optim.analytic import block_rj_het
    het_rj = block_rj_het(family, brown_n_dist)

    def rj(cam_b, im_b, keyp, tpl, uv):
        return het_rj(cam_b, im_b, tpl if family == "template" else keyp, uv)

    return _grams_of_rj(rj, loss, f_scale, loss_semantics)


def _block_params(pieces: ParamPieces, colmask: ParamPieces, n_cams: int,
                  n_ims: int):
    """Per-block (camera-major) parameter and column-mask broadcasts."""
    return (torch.repeat_interleave(pieces.cam, n_ims, dim=0),
            pieces.im.repeat(n_cams, 1),
            torch.repeat_interleave(colmask.cam, n_ims, dim=0),
            colmask.im.repeat(n_cams, 1))


def make_structured_neq(op_fun: OptimFunction, widths: GroupWidths,
                        n_cams: int, n_ims: int, loss: str = "linear",
                        f_scale: float = 1.0,
                        group_of_key: np.ndarray | None = None,
                        n_groups: int | None = None,
                        loss_semantics: str = "component"):
    """Structured normal-equation builder over the (B, K) grid.

    :param group_of_key: (k_pad,) int key -> group map, required iff the
        chain binds its c-axis PER_GROUP (the grouped chain). The per-group
        parameter rows expand onto the key grid through a small (K, G)
        one-hot, and the per-key gram pieces reduce back to per-group blocks
        with its transpose: every residual touches exactly one key, hence
        one group.
    :param n_groups: G (default: the largest group index + 1), so a group
        with no observed keys still gets its parameter rows.
    :return: neq(pieces, uv, mask, tpl, colmask) -> NormalEq, where tpl is
        the (K,3) template table (zeros when the chain has key params) and
        colmask a ParamPieces of 0/1 unfixed masks.
    """
    a, b = widths.a, widths.b
    fused = resolve_fused_grams(op_fun, widths, n_cams, n_ims, loss=loss,
                                f_scale=f_scale,
                                loss_semantics=loss_semantics)
    if fused is not None and fused[0] == "selfcal":
        fused_sc = fused[1]

        def neq_fused_sc(pieces: ParamPieces, uv, mask, tpl,
                         colmask: ParamPieces):
            cam_b, im_b, cmask_b, imask_b = _block_params(
                pieces, colmask, n_cams, n_ims)
            return NormalEq(*fused_sc(cam_b, im_b, pieces.key, uv, mask,
                                      cmask_b, imask_b, colmask.key))

        return neq_fused_sc
    if fused is not None and fused[0] == "freepoint":
        fused_fp = fused[1]

        def neq_fused_fp(pieces: ParamPieces, uv, mask, tpl,
                         colmask: ParamPieces):
            cam_b = torch.repeat_interleave(pieces.cam, n_ims, dim=0)
            cmask_b = torch.repeat_interleave(colmask.cam, n_ims, dim=0)
            hcc, hkk, wck, gc, gk, cost = fused_fp(
                cam_b, None, pieces.key, uv, mask, cmask_b, None,
                colmask.key)
            k_pad, c = mask.shape[1], widths.c
            z = uv.new_zeros
            return NormalEq(hcc, z((n_ims, 0, 0)), hkk,
                            z((n_cams, n_ims, a, 0)), wck,
                            z((n_ims, k_pad, 0, c)), gc, z((n_ims, 0)), gk,
                            cost)

        return neq_fused_fp
    if fused is not None and fused[0] == "template":
        _, fused_fn = fused

        def neq_fused(pieces: ParamPieces, uv, mask, tpl,
                      colmask: ParamPieces):
            cam_b, im_b, cmask_b, imask_b = _block_params(
                pieces, colmask, n_cams, n_ims)
            hcc, hii, wci, gc, gi, cost = fused_fn(
                cam_b, im_b, tpl, uv, mask, cmask_b, imask_b)
            k_pad = mask.shape[1]
            z = uv.new_zeros
            return NormalEq(hcc, hii, z((k_pad, 0, 0)), wci,
                            z((n_cams, k_pad, a, 0)), z((n_ims, k_pad, b, 0)),
                            gc, gi, z((k_pad, 0)), cost)

        return neq_fused

    grouped = widths.key_link == key_type.PER_GROUP
    if grouped:
        if group_of_key is None:
            raise ValueError(
                "group_of_key is required for PER_GROUP-keyed chains")
        onehot_kg = device_onehot(group_onehot(group_of_key, n_groups))

    def expand(pieces: ParamPieces, colmask: ParamPieces, dtype, device):
        """(one-hot, c-axis rows, their masks) on the key grid: the
        grouped chain's per-group rows expanded by the one-hot."""
        kg = onehot_kg(dtype, device)
        return kg, kg @ pieces.key, kg @ colmask.key

    if fused is not None:  # "grouped": the fused builder's pieces per key
        fused_grp = fused[1]

        def neq_fused_grp(pieces: ParamPieces, uv, mask, tpl,
                          colmask: ParamPieces):
            cam_b, im_b, cmask_b, imask_b = _block_params(
                pieces, colmask, n_cams, n_ims)
            kg, keyp, kmask = expand(pieces, colmask, uv.dtype, uv.device)
            (hcc, hii, hkk, wci, wck, wik, gc, gi, gk,
             cost) = fused_grp(cam_b, im_b, keyp, tpl, uv, mask, cmask_b,
                               imask_b, kmask)
            hkk, wck, wik, gk = group_reduce(kg, hkk, wck, wik, gk)
            return NormalEq(hcc, hii, hkk, wci, wck, wik, gc, gi, gk, cost)

        return neq_fused_grp

    grams = resolve_block_grams(op_fun, widths, loss=loss, f_scale=f_scale,
                                loss_semantics=loss_semantics)

    def neq(pieces: ParamPieces, uv, mask, tpl, colmask: ParamPieces):
        cam_b, im_b, cmask_b, imask_b = _block_params(
            pieces, colmask, n_cams, n_ims)
        if grouped:
            kg, keyp, kmask = expand(pieces, colmask, uv.dtype, uv.device)
        else:
            keyp, kmask = pieces.key, colmask.key
        hcc, hii, hkk, wci, wck, wik, gc, gi, gk, cost = sum_block_grams(
            grams(cam_b, im_b, keyp, tpl, uv, mask, cmask_b, imask_b, kmask),
            n_cams, n_ims)
        if grouped:
            hkk, wck, wik, gk = group_reduce(kg, hkk, wck, wik, gk)
        return NormalEq(hcc, hii, hkk, wci, wck, wik, gc, gi, gk, cost)

    return neq


def sum_block_grams(out, n_cams: int, n_ims: int):
    """A per-block builder's 10-tuple (make_block_grams' contract) summed
    over each camera's images and each image's cameras (camera-major
    blocks): the NormalEq fields (hcc, hii, hkk, wci, wck, wik, gc, gi, gk,
    cost), the key axis still per key."""
    gcc_b, gii_b, wci_b, hkk, wck_b, wik_b, gc_b, gi_b, gk, cost = out

    def grid(x):
        return x.reshape((n_cams, n_ims) + x.shape[1:])

    return (grid(gcc_b).sum(dim=1), grid(gii_b).sum(dim=0), hkk, grid(wci_b),
            grid(wck_b).sum(dim=1), grid(wik_b).sum(dim=0),
            grid(gc_b).sum(dim=1), grid(gi_b).sum(dim=0), gk, cost)


def group_onehot(group_of_key, n_groups: int | None = None) -> np.ndarray:
    """(K, G) host one-hot of a key -> group map."""
    gok = np.asarray(group_of_key, dtype=np.int64)
    if n_groups is None:
        n_groups = int(gok.max()) + 1
    onehot = np.zeros((gok.size, n_groups))
    onehot[np.arange(gok.size), gok] = 1.0
    return onehot


def device_onehot(onehot: np.ndarray):
    """(dtype, device) -> ``onehot`` as a tensor there, copied from the host
    at its first request for that dtype and device and kept: the LM step
    then makes no host-to-device copy (which a CUDA graph cannot capture).
    The LM's first step runs uncaptured, so the copy happens outside any
    capture."""
    made = {}

    def get(dtype, device) -> torch.Tensor:
        key = (dtype, torch.device(device))
        if key not in made:
            made[key] = torch.as_tensor(onehot, dtype=dtype, device=device)
        return made[key]

    return get


def group_reduce(kg, hkk, wck, wik, gk):
    """(hkk, wck, wik, gk) with the key axis reduced to groups by the
    (K, G) one-hot ``kg``: each key belongs to one group, so a per-group
    block is the sum of its keys' blocks and cross-group couplings vanish
    identically."""
    return (torch.einsum("kg,kij->gij", kg, hkk),
            torch.einsum("kg,ckap->cgap", kg, wck),
            torch.einsum("kg,ikbp->igbp", kg, wik),
            torch.einsum("kg,ki->gi", kg, gk))


def neq_diag(neq: NormalEq) -> ParamPieces:
    """Diagonals of the H blocks (for Jacobi scaling / damping)."""
    return ParamPieces(
        torch.diagonal(neq.hcc, dim1=1, dim2=2),
        torch.diagonal(neq.hii, dim1=1, dim2=2),
        torch.diagonal(neq.hkk, dim1=1, dim2=2))


def neq_matvec(neq: NormalEq, dx: ParamPieces) -> ParamPieces:
    """H @ dx in structured form (for the LM model-reduction term)."""
    oc = torch.einsum("cij,cj->ci", neq.hcc, dx.cam)
    oc = oc + torch.einsum("ciab,ib->ca", neq.wci, dx.im)
    oc = oc + torch.einsum("ckap,kp->ca", neq.wck, dx.key)
    oi = torch.einsum("iab,ib->ia", neq.hii, dx.im)
    oi = oi + torch.einsum("ciab,ca->ib", neq.wci, dx.cam)
    oi = oi + torch.einsum("ikbp,kp->ib", neq.wik, dx.key)
    ok = torch.einsum("kpq,kq->kp", neq.hkk, dx.key)
    ok = ok + torch.einsum("ckap,ca->kp", neq.wck, dx.cam)
    ok = ok + torch.einsum("ikbp,ib->kp", neq.wik, dx.im)
    return ParamPieces(oc, oi, ok)


def schur_solve(neq: NormalEq, damp: ParamPieces, method: str = "dense",
                cg_tol: float = 1e-6, cg_maxiter: int = 250) -> ParamPieces:
    """Solve (H + diag(damp)) dx = -g by Schur elimination.

    Without point blocks (the template chain) the pose system is exactly
    block-diagonal (hii): the poses are eliminated in batch and only the
    dense (C*a) camera system is factored. With point blocks (the self-cal
    chain) the points are eliminated first, then the dense (C*a + I*b)
    camera-and-pose system is solved and the points back-substituted; the
    pose-free chain (b = 0, the free-point chain) takes the same branch
    with the camera system alone.

    :param method: 'dense' factors the reduced system (``_psd_solve``);
        'cg' solves the whole (cam + pose) system matrix-free by block-Jacobi
        preconditioned conjugate gradients (``_reduced_cg``, to ``cg_tol``
        or ``cg_maxiter`` iterations), the point term applied as
        W (K^-1 (W^T x)) without forming any (C, C) or (I, I) block: memory
        O(C*K + I*K), the route for rigs with thousands of poses.
    """
    c_, k_ = neq.hcc.shape[0], neq.hkk.shape[0]
    a, c = neq.hcc.shape[2], neq.hkk.shape[2]
    if method not in ("dense", "cg"):
        raise ValueError(
            f"reduced_solver={method!r}: the reduced solvers are 'dense' "
            f"and 'cg'")

    hcc = neq.hcc + torch.diag_embed(damp.cam)
    hii = neq.hii + torch.diag_embed(damp.im)
    if method == "cg":
        return _schur_cg(neq, damp, hcc, hii, cg_tol, cg_maxiter)
    if c:
        return _schur_solve_points(neq, damp, hcc, hii)
    iinv = _normalized_inv(hii)                                   # (I,b,b)
    uci = torch.einsum("ciab,ibq->ciaq", neq.wci, iinv)           # (C,I,a,b)
    scc = -torch.einsum("ciaq,dizq->cdaz", uci, neq.wci)          # (C,C,a,a)
    scc = _block_diag_add(scc, hcc)
    rc = neq.gc - torch.einsum("ciaq,iq->ca", uci, neq.gi)
    amat = scc.permute(0, 2, 1, 3).reshape(c_ * a, c_ * a)
    dxc = _psd_solve(amat, -rc.reshape(-1)).reshape(c_, a)
    ri = -neq.gi - torch.einsum("ciab,ca->ib", neq.wci, dxc)
    dxi = torch.einsum("ibq,iq->ib", iinv, ri)
    return ParamPieces(dxc, dxi, neq.gk.new_zeros((k_, c)))


def _eliminate_points(neq: NormalEq, damp: ParamPieces):
    """The point elimination both reduced solvers share: (kinv, uck, uik,
    gc, gi), the reduced gradients and the points' couplings through their
    damped inverse blocks; uik is None and gi the raw one for the
    pose-free chain (b = 0)."""
    kinv = _normalized_inv(neq.hkk + torch.diag_embed(damp.key))  # (K,c,c)
    uck = torch.einsum("ckap,kpq->ckaq", neq.wck, kinv)           # (C,K,a,c)
    gc = neq.gc - torch.einsum("ckaq,kq->ca", uck, neq.gk)
    if not neq.hii.shape[2]:
        return kinv, uck, None, gc, neq.gi
    uik = torch.einsum("ikbp,kpq->ikbq", neq.wik, kinv)           # (I,K,b,c)
    gi = neq.gi - torch.einsum("ikbq,kq->ib", uik, neq.gk)
    return kinv, uck, uik, gc, gi


def _back_substitute(neq: NormalEq, kinv, dxc, dxi) -> torch.Tensor:
    """The points' step from the reduced one."""
    rk = -neq.gk - torch.einsum("ckap,ca->kp", neq.wck, dxc)
    if neq.hii.shape[2]:
        rk = rk - torch.einsum("ikbp,ib->kp", neq.wik, dxi)
    return torch.einsum("kpq,kq->kp", kinv, rk)


def _schur_solve_points(neq: NormalEq, damp: ParamPieces, hcc, hii):
    """The point-block (c > 0) branch of schur_solve: with poses (b > 0)
    the reduced system is the (C*a + I*b) camera-and-pose one; without
    them (b = 0, the pose-free chain) it is the (C*a) camera system, and
    the image piece of the step is zero-width (JAX
    ``pycamset_tpu/optim/structured.py:699-795``, its general branch with
    ``amat = block_diag_dense(hcc)``)."""
    c_, i_, k_ = neq.hcc.shape[0], neq.hii.shape[0], neq.hkk.shape[0]
    a, b, c = neq.hcc.shape[2], neq.hii.shape[2], neq.hkk.shape[2]
    kinv, _, _, gc, gi = _eliminate_points(neq, damp)

    # direct couplings + damped block diagonals, flat (R, R), R = C*a + I*b;
    # the point-elimination correction as one stacked product: per point,
    # V(k) (c, R) gathers every reduced column it couples to, and
    # sum_k V(k)^T Hkk(k)^-1 V(k) is one (K*c, R) x (K*c, R) product
    na, nb = c_ * a, i_ * b
    v = neq.wck.permute(1, 3, 0, 2).reshape(k_, c, na)
    if b:
        wci_f = neq.wci.permute(0, 2, 1, 3).reshape(na, nb)
        amat = torch.cat([
            torch.cat([block_diag_dense(hcc), wci_f], dim=1),
            torch.cat([wci_f.T, block_diag_dense(hii)], dim=1)], dim=0)
        rhs = -torch.cat([gc.reshape(-1), gi.reshape(-1)])
        v = torch.cat([v, neq.wik.permute(1, 3, 0, 2).reshape(k_, c, nb)],
                      dim=2)
    else:
        amat = block_diag_dense(hcc)
        rhs = -gc.reshape(-1)
    t = torch.einsum("kpq,kqr->kpr", kinv, v)
    amat = amat - torch.einsum("kpr,kps->rs", v, t)
    sol = _psd_solve(amat, rhs)
    dxc = sol[:na].reshape(c_, a)
    dxi = sol[na:].reshape(i_, b) if b else neq.gi.new_zeros((i_, b))
    return ParamPieces(dxc, dxi, _back_substitute(neq, kinv, dxc, dxi))


def _schur_cg(neq: NormalEq, damp: ParamPieces, hcc, hii, tol: float,
              maxiter: int) -> ParamPieces:
    """The CG branch of schur_solve (JAX ``structured.py:699-735``): the
    points eliminated as the dense branch eliminates them, the (cam + pose)
    system (the camera system alone on the pose-free chain; the whole
    cam + pose one through wci on the template chain, which has no points)
    solved by ``_reduced_cg``, the points back-substituted."""
    if not neq.hkk.shape[2]:
        dxc, dxi = _reduced_cg(neq, hcc, hii, None, None, neq.gc, neq.gi,
                               tol, maxiter)
        return ParamPieces(dxc, dxi,
                           neq.gk.new_zeros((neq.hkk.shape[0], 0)))
    kinv, uck, uik, gc, gi = _eliminate_points(neq, damp)
    dxc, dxi = _reduced_cg(neq, hcc, hii, uck, uik, gc, gi, tol, maxiter)
    return ParamPieces(dxc, dxi, _back_substitute(neq, kinv, dxc, dxi))


def _reduced_cg(neq: NormalEq, hcc, hii, uck, uik, gc, gi, tol: float,
                maxiter: int):
    """Matrix-free preconditioned CG on the reduced (cam + pose) system
    (JAX ``structured.py:797-837``): the matvec applies hcc, hii and wci,
    and the point term as uck / uik of W^T x; the preconditioner is the
    block-Jacobi inverse of the damped hcc and hii. -> (dxc, dxi); dxi is
    (I, 0) on the pose-free chain."""
    b = hii.shape[2]
    hcc_inv = _normalized_inv(hcc)
    hii_inv = _normalized_inv(hii) if b else None

    def matvec(x):
        xc, xi = x
        yc = torch.einsum("cab,cb->ca", hcc, xc)
        yi = (torch.einsum("iab,ib->ia", hii, xi) if b
              else torch.zeros_like(xi))
        if b:
            yc = yc + torch.einsum("ciab,ib->ca", neq.wci, xi)
            yi = yi + torch.einsum("ciab,ca->ib", neq.wci, xc)
        if uck is not None:
            t = torch.einsum("ckap,ca->kp", neq.wck, xc)
            if b:
                t = t + torch.einsum("ikbp,ib->kp", neq.wik, xi)
            yc = yc - torch.einsum("ckaq,kq->ca", uck, t)
            if b:
                yi = yi - torch.einsum("ikbq,kq->ib", uik, t)
        return yc, yi

    def precond(x):
        xc, xi = x
        return (torch.einsum("cab,cb->ca", hcc_inv, xc),
                torch.einsum("iab,ib->ia", hii_inv, xi) if b else xi)

    return pcg(matvec, precond, (-gc, -gi), tol, maxiter)[0]


def _tdot(x: tuple, y: tuple) -> torch.Tensor:
    """<x, y> over tuples of tensors: each leaf's dot product, summed in
    leaf order (``jax._src.scipy.sparse.linalg._vdot_real_tree``)."""
    return sum(torch.sum(a * b) for a, b in zip(x, y))


def pcg(matvec, precond, b: tuple, tol: float, maxiter: int):
    """Preconditioned conjugate gradients on a tuple of tensors, the
    iteration of ``jax.scipy.sparse.linalg.cg`` (``_cg_solve``): x0 = 0,
    r0 = b, p0 = z0 = M(r0), gamma = <r, z>, the dot products over every
    leaf together, continued while |r|^2 > max(tol^2 |b|^2, 0) (|r|^2, not
    gamma: M is given) and k < maxiter.

    JAX's loop exits on the data; this one runs ``maxiter`` iterations and
    freezes the state (``torch.where``) from the first whose condition
    fails, so it gives the early-exit loop's bits, makes no host read (a
    CUDA graph captures it) and batches under ``torch.func.vmap`` (each
    system stops where its own loop would, as ``jax.vmap`` of the while
    loop selects). alpha and beta divide by 1 in a frozen state, so it
    stays finite.

    :return: (x, k): the solution (a tuple like b) and the iterations
        taken (0-d int32)."""
    bs = _tdot(b, b)
    atol2 = torch.clamp(tol ** 2 * bs, min=0.0)
    x = tuple(torch.zeros_like(t) for t in b)
    r = b
    z = precond(r)
    p = z
    gamma = _tdot(r, z)
    rs = _tdot(r, r)
    k = torch.zeros((), dtype=torch.int32, device=bs.device)
    one = torch.ones_like(bs)

    def keep(active, new, old):
        return tuple(torch.where(active, n, o) for n, o in zip(new, old))

    for _ in range(maxiter):
        active = rs > atol2
        ap = matvec(p)
        alpha = gamma / torch.where(active, _tdot(p, ap), one)
        x_new = tuple(xl + alpha * pl for xl, pl in zip(x, p))
        r_new = tuple(rl - alpha * al for rl, al in zip(r, ap))
        z = precond(r_new)
        gamma_new = _tdot(r_new, z)
        beta = gamma_new / torch.where(active, gamma, one)
        p_new = tuple(zl + beta * pl for zl, pl in zip(z, p))
        x, r, p = (keep(active, x_new, x), keep(active, r_new, r),
                   keep(active, p_new, p))
        gamma = torch.where(active, gamma_new, gamma)
        rs = torch.where(active, _tdot(r_new, r_new), rs)
        k = k + active.to(torch.int32)
    return x, k


def _block_diag_add(full: torch.Tensor,
                    diag_blocks: torch.Tensor) -> torch.Tensor:
    """full (N,N,a,a) += diag_blocks (N,a,a) on its block diagonal."""
    n = diag_blocks.shape[0]
    eye = torch.eye(n, dtype=diag_blocks.dtype, device=diag_blocks.device)
    return full + eye[:, :, None, None] * diag_blocks[:, None, :, :]


def block_diag_dense(blocks: torch.Tensor) -> torch.Tensor:
    """(N, a, a) -> (N*a, N*a) block diagonal in one broadcast product."""
    n, a, _ = blocks.shape
    eye = torch.eye(n, dtype=blocks.dtype, device=blocks.device)
    return (eye[:, None, :, None]
            * blocks[:, :, None, :]).reshape(n * a, n * a)


def _cho_refine_solve(a_n: torch.Tensor, rhs_n: torch.Tensor) -> torch.Tensor:
    """Library Cholesky + two iterative-refinement steps on the (already
    Jacobi-normalized) system; refinement recovers step accuracy lost to
    the finite-precision factorisation (matters in float32).

    ``cholesky_ex`` does not check the factorisation on the host (no device
    sync); a non-SPD system gives NaNs, which the LM rejects as a failed
    step, as the JAX path does."""
    with _batches_on_cusolver(a_n):
        chol, _ = torch.linalg.cholesky_ex(a_n)
        rhs = rhs_n[:, None]
        sol = torch.cholesky_solve(rhs, chol)
        for _ in range(2):
            resid = rhs - a_n @ sol
            sol = sol + torch.cholesky_solve(resid, chol)
    return sol[:, 0]


@contextlib.contextmanager
def _batches_on_cusolver(a: torch.Tensor):
    """A batch of library solves on a card (``a`` batched by
    ``torch.func.vmap``: the fleet) goes through cuSOLVER's batched
    routines. PyTorch's default takes MAGMA's for a batch of
    ``cholesky_solve``, which allocates device memory inside the call: a
    CUDA graph cannot capture it. One system, or the CPU, keeps PyTorch's
    choice."""
    if not (a.is_cuda and torch._C._functorch.is_batchedtensor(a)):
        yield
        return
    old = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(old)


def _psd_solve(amat: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Jacobi-normalized dense SPD solve.

    Symmetric diagonal scaling maps the system to unit diagonal, removing
    the fx^2-vs-rotation scale disparity that makes the raw system cond
    ~1e10 (essential in float32). The ridge is relative to the unit diagonal
    and scaled to the dtype's precision.

    OPT-IN (``PYCAMSET_PALLAS_CHOL=1``, CUDA, float32, n <= 2048, the JAX
    package's switch): the factor and solve run in ONE launch of the
    hand-written kernel (``ops/cuda_cholesky.py``), with its residual check
    falling back to the library route. The default is the library route,
    ``cholesky_ex`` + ``cholesky_solve``, as in the JAX package. Under
    ``torch.func.vmap`` (the fleet) the library route solves the batch;
    opted in, the kernel with a batch axis solves it in one launch
    (``psd_solve_raw_batched``), and each system whose residual misses
    takes the library route's x, selected on the device as ``jax.vmap``
    selects the branches of ``lax.cond``.
    """
    n = amat.shape[0]
    d = torch.sqrt(torch.clamp(torch.diagonal(amat), min=1e-30))
    a_n = amat / d[:, None] / d[None, :]
    ridge = 10.0 * torch.finfo(amat.dtype).eps
    a_n = a_n + ridge * torch.eye(n, dtype=amat.dtype, device=amat.device)
    rhs_n = rhs / d
    if use_cuda_psd(n, amat.dtype, amat.device):
        sol = psd_solve(a_n, rhs_n, fallback=_cho_refine_solve)
    else:
        sol = _cho_refine_solve(a_n, rhs_n)
    return sol / d


def _sym3_inv(m: torch.Tensor) -> torch.Tensor:
    """Closed adjugate inverse of batched SYMMETRIC 3x3 blocks."""
    a00, a01, a02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    a11, a12, a22 = m[..., 1, 1], m[..., 1, 2], m[..., 2, 2]
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    det = a00 * c00 + a01 * c01 + a02 * c02
    return torch.stack([
        torch.stack([c00, c01, c02], -1),
        torch.stack([c01, c11, c12], -1),
        torch.stack([c02, c12, c22], -1)], -2) / det[..., None, None]


def _normalized_inv(blocks: torch.Tensor) -> torch.Tensor:
    """Batched inverse of small SPD blocks with Jacobi normalization.

    1x1/2x2/3x3 blocks invert by the closed adjugate form, 6x6 blocks (the
    pose widths) by 2x2-of-3x3 block inversion built on it plus one
    Newton-Schulz step, exactly as the JAX function does."""
    d = torch.sqrt(torch.clamp(torch.diagonal(blocks, dim1=-2, dim2=-1),
                               min=1e-30))
    b_n = blocks / d[..., :, None] / d[..., None, :]
    n = blocks.shape[-1]
    if n == 1:
        inv_n = 1.0 / b_n
    elif n == 2:
        a00, a01 = b_n[..., 0, 0], b_n[..., 0, 1]
        a10, a11 = b_n[..., 1, 0], b_n[..., 1, 1]
        det = a00 * a11 - a01 * a10
        inv_n = torch.stack([
            torch.stack([a11, -a01], -1),
            torch.stack([-a10, a00], -1)], -2) / det[..., None, None]
    elif n == 3:
        inv_n = _sym3_inv(b_n)
    elif n == 6:
        # SPD block inversion: M = [[A B],[B^T D]], S = D - B^T A^-1 B,
        # M^-1 = [[A^-1 + E S^-1 E^T, -E S^-1], [-S^-1 E^T, S^-1]] with
        # E = A^-1 B
        a_ = b_n[..., :3, :3]
        b_ = b_n[..., :3, 3:]
        d_ = b_n[..., 3:, 3:]
        ainv = _sym3_inv(a_)
        e = ainv @ b_
        s = d_ - b_.transpose(-1, -2) @ e
        sinv = _sym3_inv(s)
        es = e @ sinv
        tl = ainv + es @ e.transpose(-1, -2)
        inv_n = torch.cat([
            torch.cat([tl, -es], dim=-1),
            torch.cat([-es.transpose(-1, -2), sinv], dim=-1),
        ], dim=-2)
        # one Newton-Schulz step squares the residual of the nested form
        eye6 = torch.eye(6, dtype=b_n.dtype, device=b_n.device)
        inv_n = inv_n @ (2.0 * eye6 - b_n @ inv_n)
    else:
        # inv_ex: no host check of the factorisation (a captured LM step
        # makes no host read; a singular block gives inf / NaN, as JAX's)
        inv_n = torch.linalg.inv_ex(b_n).inverse
    return inv_n / d[..., :, None] / d[..., None, :]
