"""Levenberg–Marquardt over the structured (Schur) normal equations.

Counterpart of ``pycamset_tpu/optim/structured_lm.py``: running-max Jacobi
scaling, Nielsen damping, scipy-style termination, the same iteration
sequence. The JAX ``lax.while_loop`` becomes a host loop. Every quantity
stays on the device; the loop reads ``status`` once per iteration (one
device sync per iteration). ``nfev`` and ``it`` advance by one per
iteration whatever happens, so they are host integers.

The linear algebra is the dense structured path (neq_diag, schur_solve)
by default. ``ops=(diag, matvec, solve, grad)`` replaces it, as in the JAX
package: the LM loop is generic over any (pieces, neq) pair of NamedTuples,
e.g. the mixed PER_KEY + PER_GROUP system of ``optim/structured_mixed.py``.
The matrix-free CG reduced solver is not ported yet (ROADMAP Queue A
item 6).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from pycamset_tpu_torch.optim.structured import (
    NormalEq, ParamPieces, neq_diag, neq_matvec, schur_solve)


class SLMState(NamedTuple):
    x: ParamPieces
    neq: NormalEq
    scale2: ParamPieces
    lam: torch.Tensor
    nu: torch.Tensor
    nfev: int
    it: int
    status: torch.Tensor
    history: torch.Tensor


class SLMResult(NamedTuple):
    x: ParamPieces
    cost: torch.Tensor
    nfev: int
    nit: int
    status: torch.Tensor
    history: torch.Tensor


def _pdot(p1, p2) -> torch.Tensor:
    return sum(torch.sum(a * b) for a, b in zip(p1, p2))


def _pnorm(p) -> torch.Tensor:
    return torch.sqrt(_pdot(p, p))


def _pmap(fn, *ps):
    return type(ps[0])(*(fn(*leaves) for leaves in zip(*ps)))


def _grad(neq: NormalEq) -> ParamPieces:
    return ParamPieces(neq.gc, neq.gi, neq.gk)


def _resolve_ops(ops):
    """(diag, matvec, solve, grad): the structured defaults, or ``ops``
    (whose grad may be None: the NormalEq gradient pieces)."""
    if ops is None:
        return neq_diag, neq_matvec, schur_solve, _grad
    diag_fn, matvec_fn, solve_fn, grad_fn = ops
    return diag_fn, matvec_fn, solve_fn, grad_fn or _grad


def slm_init(neq_fn: Callable[[ParamPieces], NormalEq], x0: ParamPieces,
             *, max_nfev: int = 100, lam0: float = 1e-4,
             scale_floor: float = 1e-8, ops=None) -> SLMState:
    """The LM state at x0 (first eval counted); run it with slm_run."""
    diag_fn = _resolve_ops(ops)[0]
    dtype, device = x0.cam.dtype, x0.cam.device
    neq0 = neq_fn(x0)
    sc0 = _pmap(lambda d: torch.clamp(d, min=scale_floor), diag_fn(neq0))
    history0 = torch.full((max_nfev + 2,), -1.0, dtype=dtype, device=device)
    history0[0] = neq0.cost
    return SLMState(
        x=x0, neq=neq0, scale2=sc0,
        lam=torch.tensor(lam0, dtype=dtype, device=device),
        nu=torch.tensor(2.0, dtype=dtype, device=device),
        nfev=1, it=0,
        status=torch.tensor(0, dtype=torch.int32, device=device),
        history=history0)


def slm_result(state: SLMState) -> SLMResult:
    return SLMResult(x=state.x, cost=state.neq.cost, nfev=state.nfev,
                     nit=state.it, status=state.status,
                     history=state.history)


def structured_lm_solve(neq_fn: Callable[[ParamPieces], NormalEq],
                        x0: ParamPieces, *, max_nfev: int = 100,
                        ftol: float = 1e-8, xtol: float = 1e-8,
                        gtol: float = 1e-8, lam0: float = 1e-4,
                        scale_floor: float = 1e-8,
                        reduced_solver: str = "dense",
                        ops=None) -> SLMResult:
    """Minimise the structured BA cost.

    :param reduced_solver: 'dense' (exact Cholesky); the structured
        solver's 'cg' is not ported yet and raises.
    :param ops: optional (diag_fn, matvec_fn, solve_fn, grad_fn) in place
        of the structured linear algebra; solve_fn receives (neq, damp,
        method=reduced_solver).
    """
    init = slm_init(neq_fn, x0, max_nfev=max_nfev, lam0=lam0,
                    scale_floor=scale_floor, ops=ops)
    final = slm_run(neq_fn, init, max_nfev=max_nfev, ftol=ftol, xtol=xtol,
                    gtol=gtol, reduced_solver=reduced_solver, ops=ops)
    return slm_result(final)


def _slm_step(neq_fn, s: SLMState, *, max_nfev, ftol, xtol, gtol,
              reduced_solver, ops) -> SLMState:
    """One LM iteration: the body of the JAX while_loop."""
    diag_fn, matvec_fn, solve_fn, grad_fn = ops
    dtype = s.lam.dtype
    hist_len = s.history.shape[-1]

    damp = _pmap(lambda sc: s.lam * sc, s.scale2)
    dx = solve_fn(s.neq, damp, method=reduced_solver)
    x_new = _pmap(torch.add, s.x, dx)
    neq_new = neq_fn(x_new)
    nfev = s.nfev + 1

    g = grad_fn(s.neq)
    if reduced_solver == "dense":
        # the refined dense solve makes (H + D)dx = -g hold closely, so
        # H dx = -g - D dx and the model reduction needs no H matvec:
        # pred_red = (dx'D dx - dx'g)/2 (scipy's formula)
        pred_red = 0.5 * (_pdot(dx, _pmap(torch.mul, damp, dx))
                          - _pdot(dx, g))
    else:
        pred_red = -(_pdot(dx, g) + 0.5 * _pdot(dx, matvec_fn(s.neq, dx)))
    act_red = s.neq.cost - neq_new.cost
    rho = act_red / torch.clamp(pred_red, min=torch.finfo(dtype).tiny)
    ok = torch.isfinite(neq_new.cost) & (act_red > 0)

    shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    lam = torch.where(ok, torch.clamp(s.lam * shrink, min=1e-12),
                      s.lam * s.nu)
    nu = torch.where(ok, torch.full_like(s.nu, 2.0), s.nu * 2.0)

    x = _pmap(lambda a, b: torch.where(ok, a, b), x_new, s.x)
    neq = _pmap(lambda a, b: torch.where(ok, a, b), neq_new, s.neq)
    d_new = diag_fn(neq_new)
    scale2 = _pmap(lambda a, b: torch.where(ok, a, b),
                   _pmap(torch.maximum, s.scale2, d_new), s.scale2)

    it = s.it + 1
    history = s.history.clone()
    history[min(it, hist_len - 1)] = neq.cost

    g_now = grad_fn(neq)
    scaled_g = torch.zeros((), dtype=dtype, device=lam.device)
    for gl, sl in zip(g_now, scale2):
        if gl.numel():
            scaled_g = torch.maximum(
                scaled_g, torch.max(torch.abs(gl) / torch.sqrt(sl)))
    step_small = _pnorm(dx) < xtol * (xtol + _pnorm(s.x))
    cost_small = ok & (act_red < ftol * s.neq.cost)
    status = torch.full_like(s.status, 4 if nfev >= max_nfev else 0)
    status = torch.where(scaled_g < gtol, 3, status)
    status = torch.where(ok & step_small, 2, status)
    status = torch.where(step_small & ~ok & (s.nu > 64), 2, status)
    # stall: many consecutive rejections = at the dtype's noise floor
    status = torch.where(~ok & (s.nu > 1024), 2, status)
    status = torch.where(cost_small, 1, status).to(torch.int32)
    return SLMState(x, neq, scale2, lam, nu, nfev, it, status, history)


def slm_run(neq_fn: Callable[[ParamPieces], NormalEq], state: SLMState, *,
            max_nfev: int = 100, nfev_cap: int | None = None,
            ftol: float = 1e-8, xtol: float = 1e-8, gtol: float = 1e-8,
            reduced_solver: str = "dense", ops=None) -> SLMState:
    """Advance an LM state until convergence — or PAUSE at ``nfev_cap``
    evaluations (status stays 0; resuming with a later slm_run continues
    the exact same iteration sequence). ``max_nfev`` is the true budget:
    reaching it sets status 4."""
    # scipy's 1e-8 defaults assume float64; clamp to the dtype's resolution
    eps = torch.finfo(state.lam.dtype).eps
    kw = dict(max_nfev=max_nfev, ftol=max(ftol, 50 * eps),
              xtol=max(xtol, 50 * eps), gtol=max(gtol, 50 * eps),
              reduced_solver=reduced_solver, ops=_resolve_ops(ops))
    s = state
    while int(s.status) == 0 and (nfev_cap is None or s.nfev < nfev_cap):
        s = _slm_step(neq_fn, s, **kw)
    return s
