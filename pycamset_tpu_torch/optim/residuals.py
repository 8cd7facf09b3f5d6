"""Residual evaluation and normal-equation assembly of the generic backend.

Counterpart of ``pycamset_tpu/optim/residuals.py``: the per-detection
chain (``OptimFunction.make_point_fn``) over the padded detection table,
its local Jacobians (2 x L, L the chain's local parameter count: 21 for
the template chain, 24 for the self-calibration one) in forward mode
(``torch.func.jvp`` vmapped over the L directions), and the global damped
normal equations assembled by scatter-add of the local J^T J / J^T r
(``index_add_``; on a card its sums are atomic, so their order varies
from run to run), or, where detections share their
whole gather row, as batched matmuls over a dense (U, M) grid and one small
scatter (``build_grouped_detection_arrays``, the same rule and layout as
the JAX package). No TPU kernel computes any of this in the JAX package
(XLA does), and none is written here: plain PyTorch on the tensors'
device.

Padding convention: pad rows REPLICATE a real detection row with mask 0,
so every lane computes a finite value and contributes exactly zero.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.func import vmap

from pycamset_tpu_torch.optim.blocks import key_type
from pycamset_tpu_torch.optim.chain import OptimFunction, ParamStruct
from pycamset_tpu_torch.optim.losses import check_loss_semantics, make_loss


@dataclass
class DetectionArrays:
    """Statically-shaped detection table.

    cols: (N, L) int32 gather indices into the full parameter vector.
    template: (N, 3) per-detection template point (zeros if untemplated).
    uv: (N, 2) measured pixels. mask: (N,) 1.0 real / 0.0 padding.
    n_real: number of unpadded rows.
    """
    cols: np.ndarray
    template: np.ndarray
    uv: np.ndarray
    mask: np.ndarray
    n_real: int

    def as_device(self, device, dtype):
        return (torch.as_tensor(self.cols, dtype=torch.int64, device=device),
                torch.as_tensor(self.template, dtype=dtype, device=device),
                torch.as_tensor(self.uv, dtype=dtype, device=device),
                torch.as_tensor(self.mask, dtype=dtype, device=device))


def pad_to_bucket(n: int, multiple: int = 512) -> int:
    """Round a detection count up to a bucket size (the JAX package's rule,
    which stabilises its compiled shapes)."""
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def build_detection_arrays(op_fun: OptimFunction, struct: ParamStruct,
                           dd: np.ndarray, template_table: np.ndarray | None,
                           pad_multiple: int = 512,
                           group_of_key: np.ndarray | None = None
                           ) -> DetectionArrays:
    """Pack a flattened detection table [cam, im, key, u, v] into padded
    arrays for the device residual.

    :param group_of_key: optional key -> PER_GROUP index mapping for chains
        with group-linked parameters (multi-target rigs).
    """
    cam_idx = dd[:, 0].astype(np.int64)
    im_idx = dd[:, 1].astype(np.int64)
    key_idx = dd[:, 2].astype(np.int64)
    uv = dd[:, 3:5].astype(np.float64)
    n = dd.shape[0]

    group_idx = None
    if group_of_key is not None:
        group_idx = np.asarray(group_of_key, dtype=np.int64)[key_idx]
    cols = struct.build_cols(cam_idx, im_idx, key_idx, group_idx)
    if cols.size and int(cols.max()) >= struct.total:
        # a row gathering past the parameter vector (on a card an
        # out-of-bounds gather is a device fault, not an exception)
        n_groups = [c for g, c in zip(struct.groups, struct.counts)
                    if g.link == key_type.PER_GROUP]
        if n_groups and int(group_idx.max()) >= n_groups[0]:
            raise ValueError(
                f"group_of_key() indices out of range [0, {n_groups[0]})")
        raise ValueError(f"the detections' gather rows reach past the "
                         f"{struct.total} parameters of the layout")
    if template_table is not None and op_fun.templated:
        tpl = template_table.reshape(-1, 3)[key_idx]
    else:
        tpl = np.zeros((n, 3))

    n_pad = pad_to_bucket(n, pad_multiple)
    mask = np.zeros(n_pad)
    mask[:n] = 1.0

    def pad(a):
        reps = np.repeat(a[:1], n_pad - n, axis=0)
        return np.concatenate([a, reps], axis=0)

    return DetectionArrays(cols=pad(cols), template=pad(tpl), uv=pad(uv),
                           mask=mask, n_real=n)


@dataclass
class GroupedDetectionArrays:
    """Detections regrouped by identical parameter-gather rows.

    Every detection whose ``cols`` row matches shares ALL its parameters
    (one (cam, image) pair of the template chain), so the table sorts into
    a dense (U, M) grid: U unique rows, M the largest group rounded up,
    short groups padded with replicas under mask 0. The normal equations
    assemble as U batched matmuls over M and ONE (U, L, L) scatter.

    u_rows: (U, L) unique gather rows. template: (U, M, 3). uv: (U, M, 2).
    mask: (U, M). n_real: unpadded detection count.
    """
    u_rows: np.ndarray
    template: np.ndarray
    uv: np.ndarray
    mask: np.ndarray
    n_real: int

    def as_device(self, device, dtype):
        return (torch.as_tensor(self.u_rows, dtype=torch.int64,
                                device=device),
                torch.as_tensor(self.template, dtype=dtype, device=device),
                torch.as_tensor(self.uv, dtype=dtype, device=device),
                torch.as_tensor(self.mask, dtype=dtype, device=device))


def build_grouped_detection_arrays(op_fun: OptimFunction, struct: ParamStruct,
                                   dd: np.ndarray,
                                   template_table: np.ndarray | None,
                                   group_of_key: np.ndarray | None = None,
                                   m_pad_multiple: int = 8,
                                   max_blowup: float = 3.0,
                                   precomputed: DetectionArrays | None = None
                                   ) -> GroupedDetectionArrays | None:
    """Group a detection table by identical gather rows, or None if the
    grouping would not pay (U*M exceeds max_blowup * N: chains whose rows
    are unique per detection keep the scatter layout).

    :param precomputed: an already-built flat DetectionArrays for the same
        problem (only its first n_real rows are read)."""
    flat = (precomputed if precomputed is not None else
            build_detection_arrays(op_fun, struct, dd, template_table,
                                   pad_multiple=1,
                                   group_of_key=group_of_key))
    n = flat.n_real
    if n == 0:
        return None
    u_rows, inv = np.unique(flat.cols[:n], axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    u = u_rows.shape[0]
    counts = np.bincount(inv, minlength=u)
    m = int(counts.max())
    m = ((m + m_pad_multiple - 1) // m_pad_multiple) * m_pad_multiple
    if u * m > max_blowup * n:
        return None
    order = np.argsort(inv, kind="stable")
    tpl = np.zeros((u, m, 3))
    uv = np.zeros((u, m, 2))
    mask = np.zeros((u, m))
    slot = np.concatenate([np.arange(c) for c in counts])
    gi = inv[order]
    tpl[gi, slot] = flat.template[:n][order]
    uv[gi, slot] = flat.uv[:n][order]
    mask[gi, slot] = 1.0
    # pad slots replicate the group's first real row (every lane finite;
    # the mask kills its contribution)
    pad = mask == 0.0
    tpl[pad] = np.repeat(tpl[:, 0], m, axis=0).reshape(u, m, 3)[pad]
    uv[pad] = np.repeat(uv[:, 0], m, axis=0).reshape(u, m, 2)[pad]
    return GroupedDetectionArrays(u_rows=u_rows, template=tpl, uv=uv,
                                  mask=mask, n_real=n)


def _jacobian_columns(fn, x: torch.Tensor):
    """(fn(x), dfn/dx (..., out, n)): one ``torch.func.jvp`` a coordinate of
    x's last axis (n of them), vmapped over the n basis directions of the
    whole batch. Forward mode, as the JAX package's ``jacfwd`` under
    ``vmap``. A per-detection ``jacfwd`` under ``vmap`` gives the same
    numbers in float64, but in float32 PyTorch (2.13) carries the tangent
    of a 0-dim intermediate times a Python float in float64, and the
    Jacobian comes out float64; batched, no intermediate is 0-dim."""
    n = x.shape[-1]
    basis = torch.eye(n, dtype=x.dtype, device=x.device)
    basis = basis.reshape(n, *([1] * (x.dim() - 1)), n)

    def column(t):
        return torch.func.jvp(fn, (x,), (t.expand_as(x),))

    return vmap(column, out_dims=(None, -1))(basis)


def _residual_and_jacobian(op_fun: OptimFunction, by_group: bool = False):
    """The residual and its forward-mode Jacobian (``_jacobian_columns``).

    rj(local (..., L), tpl (..., 3), uv (..., 2)[, aux (..., A)]) ->
    (r (..., 2), dr/dlocal (..., 2, L)), the parameter rows broadcasting
    against the points (a grouped row (U, 1, L) over its (U, M)
    detections). ``aux`` is read by a chain with aux channels
    (``aux_width > 0``) only.

    ``by_group``: rj(params (list: one tensor a parameter group, as
    ``make_group_point_fn`` takes them), tpl, uv[, aux]) -> (r, [dr/dparams
    of each group (..., 2, n_g)]): one vmapped jvp a group, so that work
    the other groups' parameters alone decide (a block's camera rotation
    under the pose's directions) is not carried along its directions."""
    aux_w = op_fun.aux_width
    if by_group:
        point_fn = op_fun.make_group_point_fn()

        def rj_groups(params, tpl, uv, aux=None):
            params = list(params)
            r, jacs = None, []
            for gi, p in enumerate(params):
                def res(x, gi=gi):
                    return point_fn(params[:gi] + [x] + params[gi + 1:], tpl,
                                    aux) - uv
                r, jac = _jacobian_columns(res, p)
                jacs.append(jac)
            return r, jacs

        return rj_groups
    point_fn = op_fun.make_point_fn()

    def rj(local, tpl, uv, aux=None):
        if aux_w:
            return _jacobian_columns(lambda lp: point_fn(lp, tpl, aux) - uv,
                                     local)
        return _jacobian_columns(lambda lp: point_fn(lp, tpl) - uv, local)

    return rj


def _irls(r, jac, mask, loss, rho_fn, weight_fn, semantics):
    """Mask r (..., 2) and jac (..., 2, L) and fold the robust loss's
    sqrt-weights into both; returns (r, jac, cost)."""
    m = mask[..., None]
    r = r * m
    if loss != "linear" and semantics == "component":
        s = r * r
        cost = torch.sum(rho_fn(s) * m)
        sw = torch.sqrt(weight_fn(s)) * m
        return r * sw, jac * sw[..., None], cost
    if loss != "linear":
        s = torch.sum(r * r, dim=-1)
        cost = torch.sum(rho_fn(s) * mask)
        sw = torch.sqrt(weight_fn(s)) * mask
        return r * sw[..., None], jac * sw[..., None, None], cost
    return r, jac * mask[..., None, None], torch.sum(r * r)


def _scatter_system(p_total: int, rows, gram, g):
    """(P, P) and (P,) sums of the per-row (L, L) grams and (L,) gradients
    at their gather rows (``index_add_`` on the flat system: atomic adds
    on a card)."""
    jtj = torch.zeros(p_total * p_total, dtype=gram.dtype,
                      device=gram.device)
    flat = rows[:, :, None] * p_total + rows[:, None, :]
    jtj.index_add_(0, flat.reshape(-1), gram.reshape(-1))
    grad = torch.zeros(p_total, dtype=g.dtype, device=g.device)
    grad.index_add_(0, rows.reshape(-1), g.reshape(-1))
    return jtj.reshape(p_total, p_total), grad


def make_grouped_neq_fn(op_fun: OptimFunction, loss: str = "linear",
                        f_scale: float = 1.0,
                        loss_semantics: str = "component"):
    """Normal-equation builder over the (U, M) grouped grid.

    neq(params_full, u_rows, tpl, uv, mask) -> (JtJ, grad, cost):
    parameters gather once per group, residual and Jacobian over the dense
    grid, grams contracted over M, and only the (U, L, L) / (U, L) group
    results scattered into the global system. Robust losses as
    ``make_neq_fn``.
    """
    check_loss_semantics(loss_semantics)
    rj = _residual_and_jacobian(op_fun)
    rho_fn, weight_fn = make_loss(loss, f_scale)

    def neq(params_full, u_rows, tpl, uv, mask):
        local_u = params_full[u_rows]                  # (U, L)
        r, jac = rj(local_u[:, None, :], tpl, uv)      # (U,M,2), (U,M,2,L)
        r, jac, cost = _irls(r, jac, mask, loss, rho_fn, weight_fn,
                             loss_semantics)
        gram_u = torch.einsum("umki,umkj->uij", jac, jac)
        g_u = torch.einsum("umki,umk->ui", jac, r)
        jtj, grad = _scatter_system(params_full.shape[0], u_rows, gram_u,
                                    g_u)
        return jtj, grad, cost

    return neq


def make_residual_fn(op_fun: OptimFunction):
    """residual(params_full, cols, tpl, uv, mask) -> (N, 2) masked
    residuals."""
    point_fn = op_fun.make_point_fn()

    def residual(params_full, cols, tpl, uv, mask):
        pred = point_fn(params_full[cols], tpl)
        return (pred - uv) * mask[:, None]

    return residual


def make_cost_fn(op_fun: OptimFunction):
    """cost(params_full, ...) -> sum of squared masked residuals."""
    residual = make_residual_fn(op_fun)

    def cost(params_full, cols, tpl, uv, mask):
        r = residual(params_full, cols, tpl, uv, mask)
        return torch.sum(r * r)

    return cost


def make_local_jac_fn(op_fun: OptimFunction):
    """(params_full, ...) -> (residuals (N, 2), local Jacobians (N, 2, L)),
    masked: the raw per-detection pieces of the host sparse Jacobian
    (``driver.make_optimisation_function``)."""
    rj = _residual_and_jacobian(op_fun)

    def local_jac(params_full, cols, tpl, uv, mask):
        r, jac = rj(params_full[cols], tpl, uv)
        return r * mask[:, None], jac * mask[:, None, None]

    return local_jac


def make_neq_fn(op_fun: OptimFunction, loss: str = "linear",
                f_scale: float = 1.0,
                loss_semantics: str = "component"):
    """Normal-equation builder over the flat table.

    neq(params_full, cols, tpl, uv, mask) ->
        (JtJ (P, P), grad (P,) = J^T r, cost)

    assembled by scatter-add of per-detection (L, L) / (L,) pieces. Robust
    losses apply IRLS weights per residual component or per 2-D
    observation (``loss_semantics``), as the structured backend does.
    """
    check_loss_semantics(loss_semantics)
    rj = _residual_and_jacobian(op_fun)
    rho_fn, weight_fn = make_loss(loss, f_scale)

    def neq(params_full, cols, tpl, uv, mask):
        r, jac = rj(params_full[cols], tpl, uv)        # (N,2), (N,2,L)
        r, jac, cost = _irls(r, jac, mask, loss, rho_fn, weight_fn,
                             loss_semantics)
        gram = torch.einsum("nki,nkj->nij", jac, jac)
        jtr = torch.einsum("nki,nk->ni", jac, r)
        jtj, grad = _scatter_system(params_full.shape[0], cols, gram, jtr)
        return jtj, grad, cost

    return neq
