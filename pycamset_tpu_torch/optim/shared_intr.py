"""Shared-intrinsics (tied) bundle adjustment: one lens model per lens group.

Counterpart of ``pycamset_tpu/optim/shared_intr.py``. Production rigs are
often built from identical cameras and lenses; ``shared_intrinsics=True``
ties every camera to one lens (focal, principal point, distortion), and a
per-camera label list (e.g. ``["a", "a", "b", "b"]``) or a dict {camera
name: label} ties each labelled group to its own lens.

The tied system is another arrow structure, on the camera axis. The untied
structured normal equations (Kernel A or B, nothing new on the device's
hot path) are folded exactly into tied space through the tying map
p_c = [shared[g(c)] | e_c]:

    H_ss[g] = sum_{c in g} Hcc[c][:s, :s]   (per-group shared blocks)
    H_se[c] =              Hcc[c][:s, s:]   (group g(c) x extrinsic c)
    H_ee[c] =              Hcc[c][s:, s:]
    W_si[g] = sum_{c in g} Wci[c][:, :s, :]
    W_ei[c] =              Wci[c][:, s:, :]

and the damped solve eliminates the block-diagonal pose system first,
leaving a small dense (G*s + 6C) system (33 for four cameras and one
standard lens), solved by ``structured._psd_solve``: the library route, or
opted in (``PYCAMSET_PALLAS_CHOL=1``) the one-launch SPD kernel, and under
``torch.func.vmap`` (the tied fleet) its batched form. The LM runs through
``structured_lm_solve``'s ``ops=`` (``make_tied_ops``), so on a card each
step is one CUDA graph replay. Template chains only, at every camera
model the template chain serves (a = 14, 15, 18, 22, 24: s = 8 to 18).

``build_shared_structured_problem`` returns the structured driver's
contract; its problem is a ``problem.TiedProblem``. Its solved free vector
broadcasts each group's lens into every camera of the group, so the
grouped cameras come back with bit-identical rows.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pycamset_tpu_torch.config import default_device_dtype, resolve_device
from pycamset_tpu_torch.optim.structured import (
    ParamPieces, UnsupportedChain, _block_diag_add, _normalized_inv,
    _psd_solve, build_block_arrays, chain_widths, device_onehot,
    pad_pieces_to_grid, pad_template_table, split_full_params)


class TiedPieces(NamedTuple):
    """Parameters of the tied system."""
    shared: torch.Tensor   # (G, s)  one intrinsic vector per lens group
    cam: torch.Tensor      # (C, 6)  per-camera extrinsics
    im: torch.Tensor       # (I, b)  per-image target poses


class TiedNormalEq(NamedTuple):
    hss: torch.Tensor      # (G, s, s)
    hse: torch.Tensor      # (C, s, 6)   row group g(c), column extr c
    hee: torch.Tensor      # (C, 6, 6)
    hii: torch.Tensor      # (I, b, b)
    wsi: torch.Tensor      # (G, I, s, b)
    wei: torch.Tensor      # (C, I, 6, b)
    gs: torch.Tensor       # (G, s)
    ge: torch.Tensor       # (C, 6)
    gi: torch.Tensor       # (I, b)
    cost: torch.Tensor


def resolve_lens_groups(opt, cam_names) -> np.ndarray:
    """The ``shared_intrinsics`` option -> per-camera group ids (C,).

    True ties every camera to one lens; a list or tuple of per-camera
    labels (length C, any hashables) ties each label to its own lens; a
    dict {camera name: label} does the same by name. Groups are numbered
    in the order of their labels' ``str``.
    """
    if opt is True:
        return np.zeros(len(cam_names), dtype=np.int64)
    if isinstance(opt, dict):
        missing = [n for n in cam_names if n not in opt]
        if missing:
            raise ValueError(
                f"shared_intrinsics dict misses cameras {missing}")
        labels = [opt[n] for n in cam_names]
    else:
        labels = list(opt)
        if len(labels) != len(cam_names):
            raise ValueError(
                f"shared_intrinsics needs one label per camera "
                f"({len(cam_names)}); got {len(labels)}")
    uniq = sorted(set(labels), key=str)
    lut = {lb: i for i, lb in enumerate(uniq)}
    return np.asarray([lut[lb] for lb in labels], dtype=np.int64)


def fold_tied(n, s: int, oh: torch.Tensor) -> TiedNormalEq:
    """Exact fold of an untied NormalEq through the tying map.

    :param oh: (C, G) one-hot camera -> lens-group matrix.
    """
    return TiedNormalEq(
        hss=torch.einsum("cg,cst->gst", oh, n.hcc[:, :s, :s]),
        hse=n.hcc[:, :s, s:],
        hee=n.hcc[:, s:, s:],
        hii=n.hii,
        wsi=torch.einsum("cg,cisb->gisb", oh, n.wci[:, :, :s, :]),
        wei=n.wci[:, :, s:, :],
        gs=torch.einsum("cg,cs->gs", oh, n.gc[:, :s]),
        ge=n.gc[:, s:],
        gi=n.gi,
        cost=n.cost)


def tied_diag(n: TiedNormalEq) -> TiedPieces:
    return TiedPieces(*(torch.diagonal(h, dim1=1, dim2=2)
                        for h in (n.hss, n.hee, n.hii)))


def tied_grad(n: TiedNormalEq) -> TiedPieces:
    return TiedPieces(n.gs, n.ge, n.gi)


def make_tied_ops(oh_np: np.ndarray):
    """(diag, matvec, solve, grad) over TiedPieces for structured_lm_solve.
    The (C, G) one-hot stays host numpy until a step first asks for it on
    a device (``device_onehot``: no host-to-device copy in a captured
    step)."""
    onehot = device_onehot(oh_np)

    def tied_matvec(n: TiedNormalEq, dx: TiedPieces) -> TiedPieces:
        oh = onehot(dx.cam.dtype, dx.cam.device)
        sh_c = oh @ dx.shared                                   # (C, s)
        os_ = torch.einsum("gst,gt->gs", n.hss, dx.shared)
        os_ = os_ + torch.einsum("cg,csu,cu->gs", oh, n.hse, dx.cam)
        os_ = os_ + torch.einsum("gisb,ib->gs", n.wsi, dx.im)
        oe = torch.einsum("csu,cs->cu", n.hse, sh_c)
        oe = oe + torch.einsum("cuv,cv->cu", n.hee, dx.cam)
        oe = oe + torch.einsum("ciub,ib->cu", n.wei, dx.im)
        oi = torch.einsum("gisb,gs->ib", n.wsi, dx.shared)
        oi = oi + torch.einsum("ciub,cu->ib", n.wei, dx.cam)
        oi = oi + torch.einsum("ibq,iq->ib", n.hii, dx.im)
        return TiedPieces(os_, oe, oi)

    def tied_solve(n: TiedNormalEq, damp: TiedPieces, method: str = "dense",
                   cg_tol: float = 1e-6,
                   cg_maxiter: int = 250) -> TiedPieces:
        """(H + diag(damp)) dx = -g: eliminate the block-diagonal poses,
        dense solve of the (G*s + 6C) reduced system, back-substitute.
        The reduced system is tiny for any real rig, so it is always
        dense (``method``, ``cg_tol`` and ``cg_maxiter`` are accepted for
        the LM's signature, as in the JAX package)."""
        g_, s = n.hss.shape[0], n.hss.shape[2]
        c_ = n.hee.shape[0]
        ns, ne = g_ * s, c_ * 6
        oh = onehot(n.gs.dtype, n.gs.device)

        hss = n.hss + torch.diag_embed(damp.shared)
        hee = n.hee + torch.diag_embed(damp.cam)
        hii = n.hii + torch.diag_embed(damp.im)

        iinv = _normalized_inv(hii)                             # (I,b,b)
        t_si = torch.einsum("gisb,ibq->gisq", n.wsi, iinv)      # (G,I,s,b)
        t_ei = torch.einsum("ciub,ibq->ciuq", n.wei, iinv)      # (C,I,6,b)

        a_ss = -torch.einsum("gisq,hiuq->ghsu", t_si, n.wsi)    # (G,G,s,s)
        a_ss = _block_diag_add(a_ss, hss)
        a_se = (torch.einsum("cg,csu->gcsu", oh, n.hse)
                - torch.einsum("gisq,ciuq->gcsu", t_si, n.wei))  # (G,C,s,6)
        a_ee = -torch.einsum("ciuq,divq->cduv", t_ei, n.wei)    # (C,C,6,6)
        a_ee = _block_diag_add(a_ee, hee)
        r_s = n.gs - torch.einsum("gisq,iq->gs", t_si, n.gi)
        r_e = n.ge - torch.einsum("ciuq,iq->cu", t_ei, n.gi)

        se_flat = a_se.permute(0, 2, 1, 3).reshape(ns, ne)
        amat = torch.cat([
            torch.cat([a_ss.permute(0, 2, 1, 3).reshape(ns, ns), se_flat],
                      dim=1),
            torch.cat([se_flat.T, a_ee.permute(0, 2, 1, 3).reshape(ne, ne)],
                      dim=1)], dim=0)
        rhs = -torch.cat([r_s.reshape(-1), r_e.reshape(-1)])
        sol = _psd_solve(amat, rhs)
        dxs = sol[:ns].reshape(g_, s)
        dxe = sol[ns:].reshape(c_, 6)

        ri = (-n.gi - torch.einsum("gisb,gs->ib", n.wsi, dxs)
              - torch.einsum("ciub,cu->ib", n.wei, dxe))
        dxi = torch.einsum("ibq,iq->ib", iinv, ri)
        return TiedPieces(dxs, dxe, dxi)

    return (tied_diag, tied_matvec, tied_solve, tied_grad)


class TiedLayout:
    """The tying map of one rig layout: group ids, the shared width s, and
    the conversions between the untied pieces on the grid and TiedPieces.

    :param gid: (C,) lens group of each camera.
    :param s: the intrinsic columns a camera's row starts with (a - 6).
    :param k_pad: the key grid (the template chain's key piece is (k_pad,
        0)).
    """

    def __init__(self, gid: np.ndarray, s: int, k_pad: int):
        self.gid = np.asarray(gid, dtype=np.int64)
        self.s = s
        self.k_pad = k_pad
        # (C, G) camera -> lens group, host float64
        self.onehot = np.eye(int(self.gid.max()) + 1)[self.gid]
        self._gid_dev = device_onehot(self.gid)

    def expand(self, tp: TiedPieces) -> ParamPieces:
        """TiedPieces -> the untied pieces: each camera's row its group's
        lens then its extrinsics (a gather: the rows of one group are the
        same bits)."""
        idx = self._gid_dev(torch.int64, tp.shared.device)
        cam = torch.cat([tp.shared.index_select(0, idx), tp.cam], dim=1)
        return ParamPieces(cam, tp.im, tp.cam.new_zeros((self.k_pad, 0)))

    def tie(self, p: ParamPieces) -> TiedPieces:
        """Untied pieces -> TiedPieces, each group's lens the mean of its
        cameras' (in the pieces' dtype, as the JAX package)."""
        oh = torch.as_tensor(self.onehot, dtype=p.cam.dtype,
                             device=p.cam.device)
        counts = torch.as_tensor(self.onehot.sum(axis=0), dtype=p.cam.dtype,
                                 device=p.cam.device)
        shared = (oh.T @ p.cam[:, :self.s]) / counts[:, None]
        return TiedPieces(shared, p.cam[:, self.s:], p.im)

    def make_neq(self, neq_raw):
        """The tied builder neq(tp, uv, mask, tpl, colmask) over the untied
        one: expand, the untied normal equations, fold."""
        onehot = device_onehot(self.onehot)

        def neq(tp: TiedPieces, uv, mask, tpl, colmask) -> TiedNormalEq:
            return fold_tied(neq_raw(self.expand(tp), uv, mask, tpl, colmask),
                             self.s, onehot(tp.cam.dtype, tp.cam.device))

        return neq


def check_tied_chain(op_fun, widths) -> int:
    """The shared width s of a chain the tied backend takes; raises
    ``UnsupportedChain`` for any other (the JAX package's checks)."""
    if widths.c != 0 or not op_fun.templated or widths.b != 6:
        raise UnsupportedChain(
            "shared_intrinsics supports template chains only "
            "(projection + extrinsic + template points)")
    s = widths.a - 6
    if s <= 0:
        raise UnsupportedChain("chain has no intrinsic columns to tie")
    return s


def check_no_fixed_intrinsics(colmask: ParamPieces, s: int):
    """Raise ``UnsupportedChain`` unless every camera's intrinsic columns
    are free (pin all or none: a per-camera pin contradicts the tying)."""
    if not bool((colmask.cam[:, :s] == 1.0).all()):
        raise UnsupportedChain(
            "shared_intrinsics cannot honour per-camera fixed intrinsics "
            "(fix none; a fully-pinned shared lens needs no tying — pin "
            "every camera's int/dst instead and solve untied)")


def build_shared_structured_problem(param_handler, dtype=None, device="cuda",
                                    k_pad_multiple: int = 128):
    """A handler's problem on the tied (shared-intrinsics) backend, on
    ``device`` (the card unless the caller names another; dtype as
    ``config.default_device_dtype``).

    Same contract as ``structured_driver.build_structured_problem``:
    (solve_fn(x0_free) -> (x_free, SLMResult), residual_fn, x0_free), with
    ``solve_fn`` a ``StructuredSolve`` whose ``problem`` is a
    ``problem.TiedProblem``. The solved free vector broadcasts each lens
    into every camera of its group.

    Raises UnsupportedChain for a chain other than the template chain, a
    chain without intrinsic columns, or any camera's intrinsic columns
    fixed on their own.
    """
    from pycamset_tpu_torch.optim.problem import TiedProblem
    from pycamset_tpu_torch.optim.structured_driver import (
        StructuredSolve, build_colmask_pieces, detection_residuals,
        image_grid, merge_structured)
    device = resolve_device(device)
    dtype = dtype or default_device_dtype(device)
    op_fun = param_handler.op_fun
    widths = chain_widths(op_fun)
    s = check_tied_chain(op_fun, widths)
    opts = param_handler.problem_opts
    gid = resolve_lens_groups(opts.get("shared_intrinsics"),
                              param_handler.cam_names)

    x0 = np.asarray(param_handler.get_initial_params(), dtype=np.float64)
    n_cams = len(param_handler.cam_names)
    n_ims = int(param_handler.bundlePrimitive.poses.shape[0])
    n_keys = param_handler.n_keys()
    n_ims_grid = image_grid(n_ims, opts.get("im_bucket", 8))

    dd = param_handler.get_detection_data(flatten=True)
    blocks = build_block_arrays(dd, n_cams, n_ims_grid, n_keys,
                                k_pad_multiple=k_pad_multiple)
    k_pad = blocks.uv.shape[1]
    struct = op_fun.param_struct(n_cams, n_ims, n_keys)
    base_full = param_handler.bundlePrimitive.base_full()
    unfixed = param_handler.bundlePrimitive.unfixed_full()
    base_full[unfixed] = x0
    free_idx = np.where(unfixed)[0]

    colmask = build_colmask_pieces(base_full, unfixed, op_fun, struct,
                                   widths, n_cams, n_ims, n_keys, k_pad,
                                   n_ims_grid)
    check_no_fixed_intrinsics(colmask, s)
    layout = TiedLayout(gid, s, k_pad)

    def to_tied(full: np.ndarray) -> TiedPieces:
        p = split_full_params(torch.as_tensor(full), op_fun, struct, n_cams,
                              n_ims, n_keys, widths)
        p = pad_pieces_to_grid(p, widths, False, n_keys, k_pad, n_ims,
                               n_ims_grid)
        return layout.tie(ParamPieces(*(t.to(device=device, dtype=dtype)
                                        for t in p)))

    merge = merge_structured(op_fun, struct, n_cams, n_ims, n_keys, n_keys)
    uv, mask = blocks.as_device(device, dtype)
    tpl = torch.as_tensor(pad_template_table(
        param_handler.template_table(), True, n_keys, k_pad), dtype=dtype,
        device=device)
    problem = TiedProblem(
        op_fun, widths, struct, blocks, to_tied(base_full), uv, mask, tpl,
        ParamPieces(*(t.to(device=device, dtype=dtype) for t in colmask)),
        opts.get("loss", "linear"), float(opts.get("f_scale", 1.0)),
        opts.get("loss_semantics", "component"),
        max_nfev=int(opts.get("max_nfev", 100)), layout=layout)
    solve_fn = StructuredSolve(problem, to_tied,
                               lambda tp: merge(layout.expand(tp)),
                               base_full, free_idx)
    residuals = detection_residuals(op_fun, dd, tpl,
                                    lambda p, key: p.key[key], device, dtype)

    def residual_fn(x_free: np.ndarray) -> np.ndarray:
        return residuals(layout.expand(solve_fn.pieces(x_free)))

    return solve_fn, residual_fn, x0
