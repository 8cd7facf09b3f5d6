"""The generic backend's Levenberg–Marquardt solver.

Counterpart of ``pycamset_tpu/optim/lm.py`` (``LMState``, ``LMResult``,
``lm_solve``, ``lm_solve_masked``), with the same rules:

- x_scale='jac' column scaling as a running-max Jacobi scale
  D_j^2 = max over accepted iterates of diag(J^T J), applied as the
  Marquardt damping (J^T J + lam diag(D^2)) dx = -g;
- Nielsen's update of lam: accepted steps shrink it by
  max(1/3, 1 - (2 rho - 1)^3), rejected steps multiply it by a doubling nu;
- ftol on the relative cost reduction, xtol on the step norm, gtol on the
  scaled gradient's infinity norm (each at least 50 eps of the dtype),
  max_nfev on evaluations; status 0 running, 1 ftol, 2 xtol (and the stall
  rules), 3 gtol, 4 max_nfev.

JAX's ``lax.while_loop`` becomes a host loop: the step is computed on the
state's device and the loop reads its status once a step (one host read,
counted in ``host_reads``). The dense solve is ``torch.linalg.solve_ex``,
which checks nothing on the host (``torch.linalg.solve`` would read its
info every step); like ``jnp.linalg.solve``, a singular system gives a
non-finite step, which the gain test rejects.

``lm_solve_device`` is the form with no host read: ``max_nfev - 1`` masked
steps, each lane frozen once its status is non-zero. That is what
``lax.while_loop`` does under ``jax.vmap`` (it runs until every lane is
done and holds each finished lane by select), so each lane ends with the
same x, cost, nit, nfev and status as JAX's vmapped ``lm_solve``. It takes
any leading batch dims on x0 (the tracker's frames) or runs under
``torch.func.vmap``; on one 1-D problem each step is the host loop's step,
op for op, so the two agree bit for bit.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

# status reads made by lm_solve's loop (one a step); zero it before a solve
host_reads = 0


class LMState(NamedTuple):
    x: torch.Tensor          # free parameter vector
    jtj: torch.Tensor        # (F, F) at x
    grad: torch.Tensor       # (F,) at x
    cost: torch.Tensor       # scalar at x
    scale2: torch.Tensor     # running max of diag(JtJ) (= max ||J_j||^2)
    lam: torch.Tensor
    nu: torch.Tensor
    nfev: torch.Tensor
    it: torch.Tensor
    status: torch.Tensor     # 0 running, 1 ftol, 2 xtol, 3 gtol, 4 max_nfev
    history: torch.Tensor    # cost per iteration (padded with -1)


class LMResult(NamedTuple):
    x: torch.Tensor
    cost: torch.Tensor
    grad: torch.Tensor
    nfev: torch.Tensor
    nit: torch.Tensor
    status: torch.Tensor
    history: torch.Tensor


def lm_solve(neq_fn: Callable, x0: torch.Tensor, *, max_nfev: int = 100,
             ftol: float = 1e-8, xtol: float = 1e-8, gtol: float = 1e-8,
             lam0: float = 1e-4, scale_floor: float = 1e-8) -> LMResult:
    """Minimise 0.5 ||r(x)||^2 given a normal-equation oracle.

    :param neq_fn: x -> (JtJ, grad, cost) on the free parameter vector.
    :param x0: initial free parameters (their device and dtype are the
        solve's).

    One evaluation per iteration; a rejected step keeps the state.
    """
    global host_reads
    dtype, dev = x0.dtype, x0.device
    hist_len = max_nfev + 2
    # scipy's 1e-8 defaults assume float64; clamp to the dtype's resolution
    finfo = torch.finfo(dtype)
    ftol = max(ftol, 50 * finfo.eps)
    xtol = max(xtol, 50 * finfo.eps)
    gtol = max(gtol, 50 * finfo.eps)

    def const(v, dt=dtype):
        return torch.tensor(v, dtype=dt, device=dev)

    jtj0, grad0, cost0 = neq_fn(x0)
    scale20 = torch.clamp(torch.diagonal(jtj0), min=scale_floor)
    history0 = torch.full((hist_len,), -1.0, dtype=dtype, device=dev)
    history0[0] = cost0
    s = LMState(x=x0, jtj=jtj0, grad=grad0, cost=cost0, scale2=scale20,
                lam=const(lam0), nu=const(2.0),
                nfev=const(1, torch.int32), it=const(0, torch.int32),
                status=const(0, torch.int32), history=history0)
    # the loop's constants, made once: no host-to-device copy in a step
    one_third, lam_floor, two = const(1.0 / 3.0), const(1e-12), const(2.0)
    tiny = const(finfo.tiny)
    running, out_of_budget = const(0, torch.int32), const(4, torch.int32)
    nfev_host, it_host = 1, 0

    while True:
        damp = s.lam * s.scale2
        a = s.jtj + torch.diag(damp)
        dx = torch.linalg.solve_ex(a, -s.grad)[0]
        x_new = s.x + dx

        jtj_new, grad_new, cost_new = neq_fn(x_new)
        nfev_host += 1
        it_host += 1

        # model reduction: m(0) - m(dx) = -(g.dx + 0.5 dx JtJ dx)
        pred_red = -(torch.dot(dx, s.grad) + 0.5 * dx @ (s.jtj @ dx))
        act_red = s.cost - cost_new
        rho = act_red / torch.maximum(pred_red, tiny)
        ok = torch.isfinite(cost_new) & (act_red > 0)

        # Nielsen lam update
        shrink = torch.maximum(one_third, 1.0 - (2.0 * rho - 1.0) ** 3)
        lam_acc = torch.maximum(s.lam * shrink, lam_floor)
        lam_rej = s.lam * s.nu
        lam = torch.where(ok, lam_acc, lam_rej)
        nu = torch.where(ok, two, s.nu * 2.0)

        x = torch.where(ok, x_new, s.x)
        jtj = torch.where(ok, jtj_new, s.jtj)
        grad = torch.where(ok, grad_new, s.grad)
        cost = torch.where(ok, cost_new, s.cost)
        scale2 = torch.where(
            ok, torch.maximum(s.scale2, torch.diagonal(jtj_new)), s.scale2)

        history = s.history
        history[min(it_host, hist_len - 1)] = cost

        # termination
        step_small = (torch.linalg.norm(dx)
                      < xtol * (xtol + torch.linalg.norm(s.x)))
        cost_small = ok & (act_red < ftol * s.cost)
        g_small = torch.max(torch.abs(grad) / torch.sqrt(scale2)) < gtol
        status = out_of_budget if nfev_host >= max_nfev else running
        status = torch.where(g_small, 3, status)
        status = torch.where(ok & step_small, 2, status)
        status = torch.where(step_small & ~ok & (s.nu > 64), 2, status)
        # stall: many consecutive rejections = at the dtype's noise floor
        status = torch.where(~ok & (s.nu > 1024), 2, status)
        status = torch.where(cost_small, 1, status).to(torch.int32)

        s = LMState(x, jtj, grad, cost, scale2, lam, nu, s.nfev + 1,
                    s.it + 1, status, history)
        host_reads += 1
        if int(status) != 0:
            break

    return LMResult(x=s.x, cost=s.cost, grad=s.grad, nfev=s.nfev, nit=s.it,
                    status=s.status, history=s.history)


def _dot(a, b):
    return torch.dot(a, b) if a.dim() == 1 else torch.sum(a * b, dim=-1)


def _mv(m, v):
    return m @ v if v.dim() == 1 else (m @ v[..., None])[..., 0]


def _diag(v):
    return torch.diag(v) if v.dim() == 1 else torch.diag_embed(v)


def _norm(v):
    return (torch.linalg.norm(v) if v.dim() == 1
            else torch.linalg.norm(v, dim=-1))


def _max(v):
    return torch.max(v) if v.dim() == 1 else torch.amax(v, dim=-1)


def _sel(cond, a, b):
    """torch.where with ``cond`` (the batch shape) broadcast over a's
    trailing dims."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.dim()
                                                         - cond.dim())), a, b)


def lm_run_device(neq_fn: Callable, x0: torch.Tensor, *, max_nfev: int = 100,
                  ftol: float = 1e-8, xtol: float = 1e-8, gtol: float = 1e-8,
                  lam0: float = 1e-4, scale_floor: float = 1e-8,
                  as_scan: bool = False) -> LMState:
    """``lm_solve``'s iteration as ``max_nfev - 1`` masked steps with no
    host read; returns the final ``LMState`` (its ``jtj`` is the normal
    matrix at x).

    :param neq_fn: x (..., F) -> (JtJ (..., F, F), grad (..., F),
        cost (...)).
    :param x0: (..., F) initial parameters; the leading dims are
        independent problems.
    :param as_scan: run the steps through torch's ``scan`` operator (one
        step body, for ``torch.export``: an unrolled loop would trace
        every step) instead of a Python loop; the same ops either way.
    """
    dtype, dev = x0.dtype, x0.device
    batch = x0.shape[:-1]
    hist_len = max_nfev + 2
    finfo = torch.finfo(dtype)
    ftol = max(ftol, 50 * finfo.eps)
    xtol = max(xtol, 50 * finfo.eps)
    gtol = max(gtol, 50 * finfo.eps)

    def const(v, dt=dtype):
        return torch.full(batch, v, dtype=dt, device=dev)

    jtj0, grad0, cost0 = neq_fn(x0)
    scale20 = torch.clamp(torch.diagonal(jtj0, dim1=-2, dim2=-1),
                          min=scale_floor)
    slot = torch.arange(hist_len, device=dev)
    history0 = torch.where(slot == 0, cost0[..., None],
                           torch.full(batch + (hist_len,), -1.0, dtype=dtype,
                                      device=dev))
    s = LMState(x=x0, jtj=jtj0, grad=grad0, cost=cost0, scale2=scale20,
                lam=const(lam0), nu=const(2.0),
                nfev=const(1, torch.int32), it=const(0, torch.int32),
                status=const(0, torch.int32), history=history0)
    # factory constants (torch.full): an exported program keeps them
    one_third, lam_floor, two, tiny = (
        torch.full((), v, dtype=dtype, device=dev)
        for v in (1.0 / 3.0, 1e-12, 2.0, finfo.tiny))

    def step(s: LMState) -> LMState:
        damp = s.lam[..., None] * s.scale2
        a = s.jtj + _diag(damp)
        dx = torch.linalg.solve_ex(a, -s.grad)[0]
        x_new = s.x + dx

        jtj_new, grad_new, cost_new = neq_fn(x_new)
        nfev = s.nfev + 1
        it = s.it + 1

        pred_red = -(_dot(dx, s.grad) + 0.5 * _dot(dx, _mv(s.jtj, dx)))
        act_red = s.cost - cost_new
        rho = act_red / torch.maximum(pred_red, tiny)
        ok = torch.isfinite(cost_new) & (act_red > 0)

        shrink = torch.maximum(one_third, 1.0 - (2.0 * rho - 1.0) ** 3)
        lam_acc = torch.maximum(s.lam * shrink, lam_floor)
        lam_rej = s.lam * s.nu
        lam = torch.where(ok, lam_acc, lam_rej)
        nu = torch.where(ok, two, s.nu * 2.0)

        x = _sel(ok, x_new, s.x)
        jtj = _sel(ok, jtj_new, s.jtj)
        grad = _sel(ok, grad_new, s.grad)
        cost = torch.where(ok, cost_new, s.cost)
        scale2 = _sel(ok, torch.maximum(
            s.scale2, torch.diagonal(jtj_new, dim1=-2, dim2=-1)), s.scale2)
        history = torch.where(slot == torch.clamp(it, max=hist_len - 1)[
            ..., None], cost[..., None], s.history)

        step_small = _norm(dx) < xtol * (xtol + _norm(s.x))
        cost_small = ok & (act_red < ftol * s.cost)
        g_small = _max(torch.abs(grad) / torch.sqrt(scale2)) < gtol
        status = torch.where(nfev >= max_nfev, 4, 0).to(torch.int32)
        status = torch.where(g_small, 3, status)
        status = torch.where(ok & step_small, 2, status)
        status = torch.where(step_small & ~ok & (s.nu > 64), 2, status)
        status = torch.where(~ok & (s.nu > 1024), 2, status)
        status = torch.where(cost_small, 1, status).to(torch.int32)

        # a lane whose status is set holds its state (lax.while_loop
        # under vmap)
        live = s.status == 0
        return LMState(*(_sel(live, new, old) for new, old in zip(
            (x, jtj, grad, cost, scale2, lam, nu, nfev, it, status,
             history), s)))

    if not as_scan:
        for _ in range(max_nfev - 1):
            s = step(s)
        return s
    from torch._higher_order_ops.scan import scan

    def body(carry, _):
        new = step(LMState(*carry))
        return tuple(new), new.status.clone()
    final, _ = scan(body, tuple(t.clone() for t in s),
                    torch.zeros(max(max_nfev - 1, 0), device=dev))
    return LMState(*final)


def lm_solve_device(neq_fn: Callable, x0: torch.Tensor, **kwargs) -> LMResult:
    """``lm_run_device`` as an ``LMResult`` (``lm_solve``'s keywords)."""
    s = lm_run_device(neq_fn, x0, **kwargs)
    return LMResult(x=s.x, cost=s.cost, grad=s.grad, nfev=s.nfev, nit=s.it,
                    status=s.status, history=s.history)


def lm_solve_masked(neq_full_fn: Callable, base_full: torch.Tensor,
                    free_idx: np.ndarray, x0_free: torch.Tensor,
                    **kwargs) -> LMResult:
    """LM over the free sub-vector of a full parameter vector.

    :param neq_full_fn: params_full -> (JtJ_full, grad_full, cost).
    :param base_full: the full parameter vector holding fixed values.
    :param free_idx: indices of the free parameters.
    """
    free_idx = torch.as_tensor(np.asarray(free_idx), dtype=torch.int64,
                               device=base_full.device)

    def neq_free(x_free):
        full = base_full.index_put((free_idx,), x_free)
        jtj, grad, cost = neq_full_fn(full)
        return jtj[free_idx][:, free_idx], grad[free_idx], cost

    return lm_solve(neq_free, x0_free, **kwargs)
