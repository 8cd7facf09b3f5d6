"""Structured normal equations for MIXED PER_KEY + PER_GROUP chains.

Counterpart of ``pycamset_tpu/optim/structured_mixed.py``; the names and
contracts are the same. The mixed formulation is multi-target
SELF-calibration: free per-key target geometry AND a free per-group
relative pose for each of several rigidly-coupled targets,

    Xc = Re (Rp (Rg Xk + tg) + tp) + te
         cam   image  group  free point

(chain Projection + Extrinsic3D + RigidTform3d + GroupRigidTform3d +
FreePoint). The key axis carries two couplings, per-key blocks and
per-group blocks tied across every key of the group, so the damped system
has arrow structure

    [ Hcc  Wci  Wcg | Wck ]
    [  .   Hii  Wig | Wik ]
    [  .    .   Hgg | Wkg']      (Hkk block-diagonal per key; Wkg per key,
    [  .    .    .  | Hkk ]       each key couples to exactly ONE group)

Eliminating the per-key blocks first folds Wkg into the group rows and
leaves a small dense [cam | pose | group] system. Everything assembles from
ONE gram computation over the (B, K) grid with the c-axis = [group pose 6 |
point 3] in chain order: the group columns hold the group pose EXPANDED per
key by the (K, G) one-hot, and the per-group blocks reduce back through it.
The grams come from Kernel E (fused reduction) or Kernel F (per block),
``optim/cuda_mixed_grams.py``, chosen by the JAX package's padding rule
(tile 8, at most 25% padding); on the CPU their plain twins.

The canonical chain at any of the five camera models' projection blocks (a
in ``TEMPLATE_WIDTHS``, the c-axis [group pose 6 | point 3]) takes Kernels
E and F; every other chain that ``mixed_chain_widths`` accepts (the
heterogeneous rig's ``ProjectionHet`` in front, a block of the caller's
own, another c-axis order) takes the forward-mode route,
``structured.make_block_grams``, as the JAX package's ``resolve_mixed_grams``
gives it ``make_block_grams``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pycamset_tpu_torch.optim.blocks import key_type
from pycamset_tpu_torch.optim.chain import OptimFunction
from pycamset_tpu_torch.optim.cuda_grams import TEMPLATE_WIDTHS
from pycamset_tpu_torch.optim.structured import (
    _PROJS, MIXED_PAD_FRAC, MIXED_PAD_TILE, GroupWidths, UnsupportedChain,
    _block_params, _normalized_inv, _psd_solve, block_diag_dense,
    device_onehot, fused_tile_pad_ok, group_onehot, group_reduce,
    make_block_grams, sum_block_grams)

MIXED_CHAIN = ("Projection", "Extrinsic3D", "RigidTform3d",
               "GroupRigidTform3d", "FreePoint")


class MixedWidths(NamedTuple):
    """Column widths and c-axis layout of a mixed chain.

    key_cols / grp_cols index the PER_KEY / PER_GROUP columns within the
    chain-ordered c-axis (c = ck + cg).
    """
    a: int
    b: int
    ck: int
    cg: int
    key_cols: tuple
    grp_cols: tuple

    @property
    def c(self):
        return self.ck + self.cg


def mixed_chain_widths(op_fun: OptimFunction) -> MixedWidths:
    """Widths/layout for a chain mixing PER_KEY and PER_GROUP params.

    Requires group order cam*, im*, then any mix of key/group-linked
    groups; raises UnsupportedChain otherwise (or if the chain is not
    actually mixed: pure chains belong on make_structured_neq).
    """
    a = b = 0
    c_links = []
    phase = 0  # 0 = cams, 1 = images, 2 = key axis
    for g in op_fun.groups:
        if g.link == key_type.PER_CAM:
            if phase > 0:
                raise UnsupportedChain("cam groups must come first")
            a += g.n
        elif g.link == key_type.PER_IMG:
            if phase > 1:
                raise UnsupportedChain("image groups must precede key axis")
            phase = 1
            b += g.n
        elif g.link in (key_type.PER_KEY, key_type.PER_GROUP):
            phase = 2
            c_links.append((g.link, g.n))
        else:
            raise UnsupportedChain(
                f"{g.link.name} groups unsupported on the structured path")
    if {lk for lk, _ in c_links} != {key_type.PER_KEY, key_type.PER_GROUP}:
        raise UnsupportedChain(
            "mixed path needs BOTH PER_KEY and PER_GROUP groups")
    key_cols, grp_cols = [], []
    off = 0
    for lk, n in c_links:
        cols = list(range(off, off + n))
        (key_cols if lk == key_type.PER_KEY else grp_cols).extend(cols)
        off += n
    return MixedWidths(a, b, len(key_cols), len(grp_cols),
                       tuple(key_cols), tuple(grp_cols))


class MixedPieces(NamedTuple):
    cam: torch.Tensor   # (C, a)
    im: torch.Tensor    # (I, b)
    key: torch.Tensor   # (K, ck)
    grp: torch.Tensor   # (G, cg)


class MixedNormalEq(NamedTuple):
    hcc: torch.Tensor   # (C, a, a)
    hii: torch.Tensor   # (I, b, b)
    hkk: torch.Tensor   # (K, ck, ck)
    hgg: torch.Tensor   # (G, cg, cg)
    wci: torch.Tensor   # (C, I, a, b)
    wck: torch.Tensor   # (C, K, a, ck)
    wik: torch.Tensor   # (I, K, b, ck)
    wcg: torch.Tensor   # (C, G, a, cg)
    wig: torch.Tensor   # (I, G, b, cg)
    wkg: torch.Tensor   # (K, ck, cg): key vs ITS OWN group only
    gc: torch.Tensor
    gi: torch.Tensor
    gk: torch.Tensor
    gg: torch.Tensor
    cost: torch.Tensor


def split_full_mixed(full: torch.Tensor, op_fun: OptimFunction, struct,
                     n_cams: int, n_ims: int, n_keys: int,
                     n_groups: int) -> MixedPieces:
    """Full [group-major] parameter vector -> unpadded MixedPieces."""
    parts = {key_type.PER_CAM: [], key_type.PER_IMG: [],
             key_type.PER_KEY: [], key_type.PER_GROUP: []}
    count = {key_type.PER_CAM: n_cams, key_type.PER_IMG: n_ims,
             key_type.PER_KEY: n_keys, key_type.PER_GROUP: n_groups}
    for gi_, g in enumerate(op_fun.groups):
        sl = struct.group_slice(gi_)
        parts[g.link].append(full[sl.start:sl.stop].reshape(count[g.link],
                                                            g.n))
    return MixedPieces(*(torch.cat(parts[lk], dim=1) for lk in (
        key_type.PER_CAM, key_type.PER_IMG, key_type.PER_KEY,
        key_type.PER_GROUP)))


def pad_mixed_pieces(p: MixedPieces, n_keys: int, k_pad: int, n_ims: int,
                     n_ims_grid: int) -> MixedPieces:
    """Pad key rows (replicating key 0: NaN-safety, masks kill them) and
    image rows (replicating row 0) onto the device grid."""
    key = p.key[:1].repeat(k_pad, 1)
    key[:n_keys] = p.key
    im = p.im[:1].repeat(n_ims_grid, 1)
    im[:n_ims] = p.im
    return MixedPieces(p.cam, im, key, p.grp)


def merge_mixed_to_full(p: MixedPieces, op_fun: OptimFunction, struct,
                        n_cams: int, n_ims: int, n_keys: int,
                        n_groups: int) -> np.ndarray:
    """Inverse of split_full_mixed (padding rows ignored), on the host."""
    out = np.zeros(struct.total)
    rows = {key_type.PER_CAM: (p.cam, n_cams), key_type.PER_IMG: (p.im, n_ims),
            key_type.PER_KEY: (p.key, n_keys),
            key_type.PER_GROUP: (p.grp, n_groups)}
    off = dict.fromkeys(rows, 0)
    for gi_, g in enumerate(op_fun.groups):
        sl = struct.group_slice(gi_)
        piece, n = rows[g.link]
        o = off[g.link]
        out[sl.start:sl.stop] = piece[:n, o:o + g.n].detach().cpu().numpy(
        ).ravel()
        off[g.link] = o + g.n
    return out


def kernel_chain(op_fun: OptimFunction, widths: MixedWidths) -> bool:
    """Whether Kernels E and F serve the mixed chain: any camera model's
    projection block (``structured._PROJS``) in front of
    ``MIXED_CHAIN[1:]``, the c-axis [group pose 6 | point 3], a camera
    width in ``TEMPLATE_WIDTHS`` (the JAX package's Pallas rule). Any other
    mixed chain takes the forward-mode route."""
    names = tuple(type(bk).__name__ for bk in op_fun.blocks)
    return bool(names and names[0] in _PROJS
                and names[1:] == MIXED_CHAIN[1:] and widths.b == 6
                and (widths.ck, widths.cg) == (3, 6)
                and widths.grp_cols == (0, 1, 2, 3, 4, 5)
                and widths.key_cols == (6, 7, 8)
                and widths.a in TEMPLATE_WIDTHS)


def resolve_mixed_grams(op_fun: OptimFunction, widths: MixedWidths,
                        loss: str = "linear", f_scale: float = 1.0,
                        loss_semantics: str = "component"):
    """The per-block gram builder of a mixed chain (the 10-tuple contract
    of make_block_grams): Kernel F's for the canonical chain
    (``kernel_chain``), which runs its plain twin for CPU tensors; the
    forward-mode route (``structured.make_block_grams``) for any other."""
    kw = dict(loss=loss, f_scale=f_scale, loss_semantics=loss_semantics)
    gw = GroupWidths(widths.a, widths.b, widths.c)
    if not kernel_chain(op_fun, widths):
        return make_block_grams(op_fun, gw, **kw)
    from pycamset_tpu_torch.optim.cuda_mixed_grams import (
        make_cuda_mixed_grams)
    return make_cuda_mixed_grams(gw, **kw)


def resolve_mixed_grams_fused(op_fun: OptimFunction, widths: MixedWidths,
                              n_cams: int, n_ims: int, loss: str = "linear",
                              f_scale: float = 1.0,
                              loss_semantics: str = "component"):
    """The FUSED-reduction mixed gram builder (Kernel E's), or None when
    the chain is not Kernel E's (``kernel_chain``) or the JAX package's
    rule declines it: the image axis would pad past 25% at tile 8."""
    if not (kernel_chain(op_fun, widths)
            and fused_tile_pad_ok(n_ims, MIXED_PAD_TILE, MIXED_PAD_FRAC)):
        return None
    from pycamset_tpu_torch.optim.cuda_mixed_grams import (
        make_cuda_mixed_grams_fused)
    return make_cuda_mixed_grams_fused(
        GroupWidths(widths.a, widths.b, widths.c), n_cams, n_ims, loss=loss,
        f_scale=f_scale, loss_semantics=loss_semantics, with_key_cols=True)


def _runs(cols) -> list:
    """Column indices as a list of (start, stop) runs of consecutive
    indices, in order."""
    runs = []
    for c in cols:
        if runs and runs[-1][1] == c:
            runs[-1][1] = c + 1
        else:
            runs.append([c, c + 1])
    return [tuple(r) for r in runs]


def c_axis_layout(widths: MixedWidths):
    """(pack, take_key, take_grp) of a mixed chain's chain-ordered c-axis,
    all by slices (no index tensor: a captured LM step makes no
    host-to-device copy). ``pack(key_rows, grp_rows)`` interleaves the
    PER_KEY and (expanded) PER_GROUP columns into chain order;
    ``take_key(t, dim)`` / ``take_grp(t, dim)`` gather one kind's columns
    of a c-axis tensor along ``dim``."""
    key_runs, grp_runs = _runs(widths.key_cols), _runs(widths.grp_cols)
    order = sorted([(s, e, "key") for s, e in key_runs]
                   + [(s, e, "grp") for s, e in grp_runs])

    def pack(key_rows, grp_rows):
        parts, offs = [], {"key": 0, "grp": 0}
        for s, e, kind in order:
            src = key_rows if kind == "key" else grp_rows
            parts.append(src[:, offs[kind]:offs[kind] + e - s])
            offs[kind] += e - s
        return torch.cat(parts, dim=1)

    def taker(runs):
        def take(t, dim):
            if len(runs) == 1:                  # a view, no copy
                return t.narrow(dim, runs[0][0], runs[0][1] - runs[0][0])
            return torch.cat([t.narrow(dim, s, e - s) for s, e in runs],
                             dim=dim)
        return take

    return pack, taker(key_runs), taker(grp_runs)


def pack_c_axis(oh, pieces: MixedPieces, colmask: MixedPieces,
                widths: MixedWidths):
    """(keyp, kmask) on the key grid, the gram builders' operands: the
    chain-ordered c-axis of the point columns and the group pose columns
    (expanded per key by the (K, G) one-hot)."""
    pack = c_axis_layout(widths)[0]
    return (pack(pieces.key, oh @ pieces.grp),
            pack(colmask.key, oh @ colmask.grp))


def make_mixed_structured_neq(op_fun: OptimFunction, widths: MixedWidths,
                              n_cams: int, n_ims: int,
                              group_of_key: np.ndarray,
                              n_groups: int, loss: str = "linear",
                              f_scale: float = 1.0,
                              loss_semantics: str = "component"):
    """Mixed normal-equation builder over the (B, K) grid.

    :param group_of_key: (k_pad,) key -> group map (pad keys may map to any
        valid group; their masks are zero).
    :return: neq(pieces: MixedPieces, uv, mask, tpl, colmask) ->
        MixedNormalEq; ``neq.onehot`` is the host (K, G) one-hot.
    """
    fused = resolve_mixed_grams_fused(op_fun, widths, n_cams, n_ims,
                                      loss=loss, f_scale=f_scale,
                                      loss_semantics=loss_semantics)
    grams = None if fused is not None else resolve_mixed_grams(
        op_fun, widths, loss=loss, f_scale=f_scale,
        loss_semantics=loss_semantics)
    onehot_np = group_onehot(group_of_key, n_groups)
    onehot = device_onehot(onehot_np)
    _, tk, tg = c_axis_layout(widths)

    def split_c_axis(oh, hcc, hii, hkk_f, wci, wck_f, wik_f, gc, gi, gk_f,
                     cost):
        # the c-axis split into per-key and (one-hot-reduced) per-group
        hgg, wcg, wig, gg = group_reduce(
            oh, tg(tg(hkk_f, 1), 2), tg(wck_f, 3), tg(wik_f, 3), tg(gk_f, 1))
        return MixedNormalEq(
            hcc, hii, tk(tk(hkk_f, 1), 2), hgg, wci, tk(wck_f, 3),
            tk(wik_f, 3), wcg, wig, tg(tk(hkk_f, 1), 2), gc, gi, tk(gk_f, 1),
            gg, cost)

    def neq(pieces: MixedPieces, uv, mask, tpl, colmask: MixedPieces):
        cam_b, im_b, cmask_b, imask_b = _block_params(pieces, colmask,
                                                      n_cams, n_ims)
        oh = onehot(uv.dtype, uv.device)
        keyp, kmask = pack_c_axis(oh, pieces, colmask, widths)
        if fused is not None:
            return split_c_axis(oh, *fused(cam_b, im_b, keyp, tpl, uv, mask,
                                           cmask_b, imask_b, kmask))
        return split_c_axis(oh, *sum_block_grams(
            grams(cam_b, im_b, keyp, tpl, uv, mask, cmask_b, imask_b, kmask),
            n_cams, n_ims))

    neq.onehot = onehot_np
    return neq


def mixed_diag(neq: MixedNormalEq) -> MixedPieces:
    return MixedPieces(*(torch.diagonal(h, dim1=1, dim2=2)
                         for h in (neq.hcc, neq.hii, neq.hkk, neq.hgg)))


def mixed_grad(neq: MixedNormalEq) -> MixedPieces:
    return MixedPieces(neq.gc, neq.gi, neq.gk, neq.gg)


def make_mixed_ops(onehot_np: np.ndarray):
    """(diag, matvec, solve, grad) ops for structured_lm_solve."""
    onehot = device_onehot(onehot_np)

    def matvec(neq: MixedNormalEq, dx: MixedPieces) -> MixedPieces:
        oh = onehot(dx.cam.dtype, dx.cam.device)
        dg_k = oh @ dx.grp                                     # (K, cg)
        oc = torch.einsum("cij,cj->ci", neq.hcc, dx.cam)
        oc = oc + torch.einsum("ciab,ib->ca", neq.wci, dx.im)
        oc = oc + torch.einsum("ckap,kp->ca", neq.wck, dx.key)
        oc = oc + torch.einsum("cgaq,gq->ca", neq.wcg, dx.grp)
        oi = torch.einsum("iab,ib->ia", neq.hii, dx.im)
        oi = oi + torch.einsum("ciab,ca->ib", neq.wci, dx.cam)
        oi = oi + torch.einsum("ikbp,kp->ib", neq.wik, dx.key)
        oi = oi + torch.einsum("igbq,gq->ib", neq.wig, dx.grp)
        ok = torch.einsum("kpq,kq->kp", neq.hkk, dx.key)
        ok = ok + torch.einsum("ckap,ca->kp", neq.wck, dx.cam)
        ok = ok + torch.einsum("ikbp,ib->kp", neq.wik, dx.im)
        ok = ok + torch.einsum("kpq,kq->kp", neq.wkg, dg_k)
        og = torch.einsum("gpq,gq->gp", neq.hgg, dx.grp)
        og = og + torch.einsum("cgaq,ca->gq", neq.wcg, dx.cam)
        og = og + torch.einsum("igbq,ib->gq", neq.wig, dx.im)
        og = og + torch.einsum("kg,kpq,kp->gq", oh, neq.wkg, dx.key)
        return MixedPieces(oc, oi, ok, og)

    def solve(neq: MixedNormalEq, damp: MixedPieces, method: str = "dense",
              cg_tol: float = 1e-6, cg_maxiter: int = 250) -> MixedPieces:
        """(H + diag(damp)) dx = -g: eliminate keys, dense-solve
        [cam | pose | group], back-substitute. Group counts are tiny, so
        the dense reduced solve always applies (``method``, ``cg_tol`` and
        ``cg_maxiter`` are accepted for the LM's signature and, as in the
        JAX package, it solves dense).

        The key-elimination correction is ONE stacked product: per key,
        V(k) (ck, R) gathers every reduced column the key couples to (cam
        blocks, pose blocks, its group's block via the one-hot), and the
        correction is sum_k V(k)^T Hkk(k)^-1 V(k), a single
        (K*ck, R) x (K*ck, R) product.
        """
        oh = onehot(neq.gc.dtype, neq.gc.device)
        c_, i_, g_ = neq.hcc.shape[0], neq.hii.shape[0], neq.hgg.shape[0]
        a, b, cg = neq.hcc.shape[2], neq.hii.shape[2], neq.hgg.shape[2]
        k_, ck = neq.hkk.shape[0], neq.hkk.shape[2]
        na, nb, ng = c_ * a, i_ * b, g_ * cg

        hcc = neq.hcc + torch.diag_embed(damp.cam)
        hii = neq.hii + torch.diag_embed(damp.im)
        hkk = neq.hkk + torch.diag_embed(damp.key)
        hgg = neq.hgg + torch.diag_embed(damp.grp)
        kinv = _normalized_inv(hkk)                            # (K,ck,ck)

        # V: (K, ck, R), every reduced-system column each key couples to
        vc = neq.wck.permute(1, 3, 0, 2).reshape(k_, ck, na)
        vi = neq.wik.permute(1, 3, 0, 2).reshape(k_, ck, nb)
        vg = (oh[:, None, :, None]
              * neq.wkg[:, :, None, :]).reshape(k_, ck, ng)
        v = torch.cat([vc, vi, vg], dim=2)
        t = torch.einsum("kpq,kqr->kpr", kinv, v)
        s_corr = torch.einsum("kpr,kps->rs", v, t)             # one product

        # direct (non-key) couplings of the reduced system
        wci_f = neq.wci.permute(0, 2, 1, 3).reshape(na, nb)
        wcg_f = neq.wcg.permute(0, 2, 1, 3).reshape(na, ng)
        wig_f = neq.wig.permute(0, 2, 1, 3).reshape(nb, ng)
        amat = torch.cat([
            torch.cat([block_diag_dense(hcc), wci_f, wcg_f], dim=1),
            torch.cat([wci_f.T, block_diag_dense(hii), wig_f], dim=1),
            torch.cat([wcg_f.T, wig_f.T, block_diag_dense(hgg)], dim=1),
        ], dim=0) - s_corr

        tk = torch.einsum("kpq,kq->kp", kinv, neq.gk)
        g_base = torch.cat([neq.gc.reshape(-1), neq.gi.reshape(-1),
                            neq.gg.reshape(-1)])
        rhs = -(g_base - torch.einsum("kpr,kp->r", v, tk))
        sol = _psd_solve(amat, rhs)
        dxc = sol[:na].reshape(c_, a)
        dxi = sol[na:na + nb].reshape(i_, b)
        dxg = sol[na + nb:].reshape(g_, cg)
        rk = -neq.gk - torch.einsum("kpr,r->kp", v, sol)
        dxk = torch.einsum("kpq,kq->kp", kinv, rk)
        return MixedPieces(dxc, dxi, dxk, dxg)

    return (mixed_diag, matvec, solve, mixed_grad)
