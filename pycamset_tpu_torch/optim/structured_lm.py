"""Levenberg–Marquardt over the structured (Schur) normal equations.

Counterpart of ``pycamset_tpu/optim/structured_lm.py``: running-max Jacobi
scaling, Nielsen damping, scipy-style termination, the same iteration
sequence. The JAX ``lax.while_loop`` becomes a loop on the host that reads
``status`` once per iteration; every other quantity stays on the device.
``nfev`` and ``it`` are device counters, as in the JAX state, which the
step reads (``nfev_dev``, ``it_dev``); they advance by one per iteration
whatever happens, so the host keeps them as integers too (``nfev``, ``it``),
which the API returns.

On a card the step is one CUDA graph (``SLMGraph``): captured once, then
replayed once per iteration, with ``status`` and the dense solve's residual
flag read together. ``graph=False`` runs the uncaptured step from the host,
the reference the graph is held to bit for bit. A CPU state runs the host
loop.

The batched LM (``slm_init_batch``, ``slm_run_batch``: the fleet of
``optim/fleet.py``) steps R rigs of one structure at once, with the
semantics of ``jax.vmap`` of the JAX loop: ``torch.func.vmap`` of the
one-rig step, a rig's state kept once its loop condition fails.

The linear algebra is the structured path (neq_diag, schur_solve) by
default, its reduced system solved dense or, with ``reduced_solver="cg"``,
matrix-free by conjugate gradients (``cg_tol``, ``cg_maxiter``: a fixed
count of masked iterations, inside the captured step).
``ops=(diag, matvec, solve, grad)`` replaces it, as in the JAX
package: the LM loop is generic over any (pieces, neq) pair of NamedTuples,
e.g. the mixed PER_KEY + PER_GROUP system of ``optim/structured_mixed.py``.
"""
from __future__ import annotations

import functools
import gc
import itertools
import time
from typing import Callable, NamedTuple

import torch

from pycamset_tpu_torch.ops import cuda_cholesky as cc
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
    nfev_dev: torch.Tensor   # 0-d int32: nfev on the device
    it_dev: torch.Tensor     # 0-d int32: it on the device


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
    # out of place, so that torch.func.vmap can batch it (slm_init_batch)
    history0 = torch.cat([neq0.cost.reshape(1), torch.full(
        (max_nfev + 1,), -1.0, dtype=dtype, device=device)])
    return SLMState(
        x=x0, neq=neq0, scale2=sc0,
        lam=torch.tensor(lam0, dtype=dtype, device=device),
        nu=torch.tensor(2.0, dtype=dtype, device=device),
        nfev=1, it=0,
        status=torch.tensor(0, dtype=torch.int32, device=device),
        history=history0,
        nfev_dev=torch.tensor(1, dtype=torch.int32, device=device),
        it_dev=torch.tensor(0, dtype=torch.int32, device=device))


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
                        cg_tol: float = 1e-6, cg_maxiter: int = 250,
                        ops=None,
                        graph: bool | SLMGraph = True) -> SLMResult:
    """Minimise the structured BA cost.

    :param reduced_solver: 'dense' (exact Cholesky) or 'cg' (matrix-free
        conjugate gradients to ``cg_tol`` or ``cg_maxiter`` iterations, for
        rigs whose (a C + b I) reduced system is too large to form).
    :param ops: optional (diag_fn, matvec_fn, solve_fn, grad_fn) in place
        of the structured linear algebra; solve_fn receives (neq, damp,
        method=reduced_solver, cg_tol=, cg_maxiter=).
    :param graph: as ``slm_run``'s.
    """
    init = slm_init(neq_fn, x0, max_nfev=max_nfev, lam0=lam0,
                    scale_floor=scale_floor, ops=ops)
    final = slm_run(neq_fn, init, max_nfev=max_nfev, ftol=ftol, xtol=xtol,
                    gtol=gtol, reduced_solver=reduced_solver, cg_tol=cg_tol,
                    cg_maxiter=cg_maxiter, ops=ops, graph=graph)
    return slm_result(final)


def _slm_step(neq_fn, s: SLMState, *, max_nfev, ftol, xtol, gtol,
              reduced_solver, cg_tol, cg_maxiter, ops) -> SLMState:
    """One LM iteration: the body of the JAX while_loop."""
    diag_fn, matvec_fn, solve_fn, grad_fn = ops
    dtype = s.lam.dtype
    hist_len = s.history.shape[-1]

    damp = _pmap(lambda sc: s.lam * sc, s.scale2)
    dx = solve_fn(s.neq, damp, method=reduced_solver, cg_tol=cg_tol,
                  cg_maxiter=cg_maxiter)
    x_new = _pmap(torch.add, s.x, dx)
    neq_new = neq_fn(x_new)
    nfev, nfev_dev = s.nfev + 1, s.nfev_dev + 1

    g = grad_fn(s.neq)
    if reduced_solver == "dense":
        # the refined dense solve makes (H + D)dx = -g hold closely, so
        # H dx = -g - D dx and the model reduction needs no H matvec:
        # pred_red = (dx'D dx - dx'g)/2 (scipy's formula)
        pred_red = 0.5 * (_pdot(dx, _pmap(torch.mul, damp, dx))
                          - _pdot(dx, g))
    else:
        # the CG step can be inexact (cg_tol, cg_maxiter) enough to corrupt
        # rho through the identity: the exact H matvec
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

    it, it_dev = s.it + 1, s.it_dev + 1
    slot = torch.clamp(it_dev, max=hist_len - 1)
    history = torch.where(torch.arange(hist_len, device=slot.device) == slot,
                          neq.cost, s.history)

    g_now = grad_fn(neq)
    scaled_g = torch.zeros((), dtype=dtype, device=lam.device)
    for gl, sl in zip(g_now, scale2):
        if gl.numel():
            scaled_g = torch.maximum(
                scaled_g, torch.max(torch.abs(gl) / torch.sqrt(sl)))
    step_small = _pnorm(dx) < xtol * (xtol + _pnorm(s.x))
    cost_small = ok & (act_red < ftol * s.neq.cost)
    status = torch.where(nfev_dev >= max_nfev, 4, 0).to(s.status.dtype)
    status = torch.where(scaled_g < gtol, 3, status)
    status = torch.where(ok & step_small, 2, status)
    status = torch.where(step_small & ~ok & (s.nu > 64), 2, status)
    # stall: many consecutive rejections = at the dtype's noise floor
    status = torch.where(~ok & (s.nu > 1024), 2, status)
    status = torch.where(cost_small, 1, status).to(torch.int32)
    return SLMState(x, neq, scale2, lam, nu, nfev, it, status, history,
                    nfev_dev, it_dev)


def slm_run(neq_fn: Callable[[ParamPieces], NormalEq], state: SLMState, *,
            max_nfev: int = 100, nfev_cap: int | None = None,
            ftol: float = 1e-8, xtol: float = 1e-8, gtol: float = 1e-8,
            reduced_solver: str = "dense", cg_tol: float = 1e-6,
            cg_maxiter: int = 250, ops=None,
            graph: bool | SLMGraph = True) -> SLMState:
    """Advance an LM state until convergence — or PAUSE at ``nfev_cap``
    evaluations (status stays 0; resuming with a later slm_run continues
    the exact same iteration sequence). ``max_nfev`` is the true budget:
    reaching it sets status 4.

    :param graph: on a CUDA state, True (the default) runs each step as one
        replay of a CUDA graph captured for this call; an ``SLMGraph``
        runs it through that runner, which keeps its capture for later
        calls (``optim.problem.BAProblem`` owns one per dense-solve route);
        False runs the uncaptured step from the host, the reference. A CPU
        state runs the host loop, unless it is given an ``SLMGraph``, which
        then runs its step body uncaptured.
    """
    kw = _step_config(state.lam.dtype, max_nfev, ftol, xtol, gtol,
                      reduced_solver, cg_tol, cg_maxiter)
    step = functools.partial(_slm_step, neq_fn, ops=_resolve_ops(ops), **kw)
    if graph is True:
        graph = SLMGraph() if state.lam.device.type == "cuda" else False
    if graph is not False:
        return graph.run(step, state, kw, nfev_cap)
    s = state
    while int(s.status) == 0 and (nfev_cap is None or s.nfev < nfev_cap):
        s = step(s)
    return s


def _step_config(dtype, max_nfev, ftol=1e-8, xtol=1e-8, gtol=1e-8,
                 reduced_solver="dense", cg_tol=1e-6,
                 cg_maxiter=250) -> dict:
    """The step's keyword configuration; scipy's 1e-8 defaults assume
    float64, so the LM's tolerances are clamped to the dtype's resolution
    (the CG tolerance is passed on as given, as in the JAX package)."""
    eps = torch.finfo(dtype).eps
    return dict(max_nfev=max_nfev, ftol=max(ftol, 50 * eps),
                xtol=max(xtol, 50 * eps), gtol=max(gtol, 50 * eps),
                reduced_solver=reduced_solver, cg_tol=cg_tol,
                cg_maxiter=cg_maxiter)


def _leaves(tree) -> list[torch.Tensor]:
    """The tensors of an SLMState (nested NamedTuples), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in _leaves(t)]
    return []


def _rebuild(tree, leaves):
    """``tree`` with its tensors taken in order from the iterator
    ``leaves`` (its host ints kept)."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if isinstance(tree, tuple):
        return type(tree)(*(_rebuild(t, leaves) for t in tree))
    return tree


class SLMGraph:
    """One LM step as a CUDA graph: captured once, then replayed once per
    iteration with one read.

    It holds two sets of state buffers: ``inp``, which the step reads, and
    ``res``, which it writes. The step's body (``body``) copies ``res``
    into ``inp``, steps from ``inp``, writes the new state into ``res``
    and stacks its ``status`` with each dense solve's residual flag
    (``cuda_cholesky.deferred_residual_checks``) into ``read``, which the
    host reads once. A false flag (the one-launch SPD kernel missed the
    residual rule) makes the host run that step again, uncaptured, from
    ``inp`` (which the body only reads) with the library fallback, and
    write its result into ``res``: the step the host loop takes.

    On a CUDA state the first step of the runner's first run is
    uncaptured, on the side stream of the capture; it advances the state
    and runs the kernels' one-time set-up outside the capture. Then the
    body is captured, and every later step, in this run and later ones,
    is a replay. A capture that fails raises. On a CPU state the body
    runs uncaptured: the same buffers, reads and reruns.

    A runner serves one problem (its data are baked into the graph), one
    dense-solve route and one configuration; a run with another route,
    state shapes or configuration raises.
    """

    def __init__(self):
        self.graph: torch.cuda.CUDAGraph | None = None
        self.config = None
        self.step = None
        self.like = None        # an SLMState over the ``inp`` buffers
        self.inp = self.res = self.read = None
        self.stream = None
        self.capture_ms = None
        self.steps = self.replays = self.reruns = self.reads = 0

    def run(self, step, s: SLMState, kw: dict, nfev_cap) -> SLMState:
        """slm_run's loop through this runner (``step``: state -> state,
        kept from the first run; ``kw``: its configuration)."""
        config = (cc.psd_opted_in(), kw,
                  [(t.shape, t.dtype, t.device) for t in _leaves(s)])
        if self.config is None:
            self.config, self.step = config, step
        elif config != self.config:
            raise ValueError("this SLMGraph was made for another dense-solve "
                             "route, state or configuration")
        cuda = s.lam.device.type == "cuda"
        # slm_init's state has status 0: no read for it
        status = 0 if s.it == 0 else self._read(s.status)[0]
        loaded = False
        while status == 0 and (nfev_cap is None or s.nfev < nfev_cap):
            self.steps += 1
            if self.inp is None:
                s, status = self._first_step(s, cuda)
                continue
            if not loaded:
                torch._foreach_copy_(self.res, _leaves(s))
                loaded = True
            if cuda and self.graph is None:
                self._capture()
            if self.graph is not None:
                self.graph.replay()
                self.replays += 1
            else:
                self.body()
            status, *flags = self._read(self.read)
            if not all(flags):
                new, status = self._eager(self.like, take_fallback=True)
                torch._foreach_copy_(self.res, _leaves(new))
                self.reruns += 1
            s = s._replace(nfev=s.nfev + 1, it=s.it + 1)
        if not loaded:
            return s
        return _rebuild(s, iter([t.clone() for t in self.res]))

    def body(self):
        """The captured step: res -> inp, one step from inp, its state into
        res and [status, residual flags...] into ``read``. Makes no host
        read, copy or sync."""
        torch._foreach_copy_(self.inp, self.res)
        with cc.deferred_residual_checks() as flags:
            new = self.step(self.like)
        torch._foreach_copy_(self.res, _leaves(new))
        read = torch.stack([new.status,
                            *(f.to(new.status.dtype) for f in flags)])
        if self.read is None:       # the capture's output, kept from then
            self.read = read
        else:
            self.read.copy_(read)

    def _read(self, t: torch.Tensor) -> list[int]:
        self.reads += 1
        return t.reshape(-1).tolist()

    def _eager(self, s: SLMState, take_fallback: bool = False):
        """One uncaptured step from s with its flags deferred and read with
        its status; a false flag repeats it with the fallback taken.
        Returns (state, status)."""
        with cc.deferred_residual_checks(take_fallback) as flags:
            new = self.step(s)
        status, *ok = self._read(torch.stack(
            [new.status, *(f.to(new.status.dtype) for f in flags)]))
        if all(ok):
            return new, status
        self.reruns += 1
        return self._eager(s, take_fallback=True)

    def _first_step(self, s: SLMState, cuda: bool):
        """The runner's first step, uncaptured (on the capture's side
        stream on a card); then its buffers are made."""
        if cuda:
            self.stream = torch.cuda.Stream(s.lam.device)
            self.stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.stream):
                new, status = self._eager(s)
            torch.cuda.current_stream().wait_stream(self.stream)
        else:
            new, status = self._eager(s)
        leaves = _leaves(new)
        self.inp = [torch.empty_like(t) for t in leaves]
        self.res = [torch.empty_like(t) for t in leaves]
        self.like = _rebuild(new, iter(self.inp))
        return new, status

    def _capture(self):
        self.graph, self.capture_ms = capture(self.body, self.stream)


def capture(body, stream) -> tuple[torch.cuda.CUDAGraph, float]:
    """``body`` captured as a CUDA graph on ``stream`` (a runner's side
    stream), and the host ms it took; raises if it cannot.

    Python's cyclic collector is kept off during the capture: a dead
    problem holds its graphs in a reference cycle (problem -> runner ->
    step -> problem), and a collection inside the capture would free that
    graph's memory pool, whose ``cudaFree`` invalidates the capture in
    progress."""
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, stream=stream):
            body()
    finally:
        if enabled:
            gc.enable()
    return graph, (time.perf_counter() - t0) * 1e3


# The batched LM (the fleet): R rigs of one structure, each SLMState tensor
# with a leading rig axis. ``neq_fn(pieces, *data)`` is ONE rig's builder,
# ``data`` its per-rig tensors (uv, mask, column masks), each batched on
# axis 0 as well.
# The host ints of a batched state (``nfev``, ``it``) stay slm_init's and
# have no per-rig meaning: each rig counts on the device (``nfev_dev``,
# ``it_dev``).

# nfev_cap's stand-in for "no cap": nfev_dev never reaches it
NO_CAP = 2 ** 31 - 1


def slm_init_batch(neq_fn, x0s, data: tuple, *, max_nfev: int = 100,
                   ops=None) -> SLMState:
    """``slm_init`` of every rig at once (``torch.func.vmap``): one
    evaluation of the batch. ``ops`` as ``slm_init``'s (the mixed chain's
    MixedPieces and MixedNormalEq ride the rig axis as ParamPieces do)."""
    skeleton = []

    def one(x0, *d):
        s = slm_init(lambda p: neq_fn(p, *d), x0, max_nfev=max_nfev,
                     ops=ops)
        # the state's structure and host ints, its tensors left behind
        skeleton.append(_rebuild(s, itertools.repeat(torch.empty(0))))
        return _leaves(s)

    leaves = torch.func.vmap(one)(x0s, *data)
    # the constants come out of vmap as broadcast views: own their rows
    return _rebuild(skeleton[0], iter([t.contiguous() for t in leaves]))


def active_rigs(s: SLMState, cap: torch.Tensor) -> torch.Tensor:
    """(R,) bool: the rigs whose while-loop condition holds, on the
    device: (status == 0) & (nfev_dev < cap)."""
    return (s.status == 0) & (s.nfev_dev < cap)


def batch_step(neq_fn, step, s: SLMState, data: tuple, cap: torch.Tensor):
    """One LM iteration of a batch, with the semantics of ``jax.vmap`` of
    the step of a ``lax.while_loop``: every rig steps (``torch.func.vmap``
    of ``step``), and each state tensor takes the new value where its rig
    was active before the step and keeps the old one elsewhere. Makes no
    host read.

    :param step: fn(neq_fn_r, state_r) -> state_r, one rig's step.
    :return: (state, 0-d bool: any rig still active)."""
    active = active_rigs(s, cap)

    def one(leaves, *d):
        return _leaves(step(lambda p: neq_fn(p, *d),
                            _rebuild(s, iter(leaves))))

    new = torch.func.vmap(one)(_leaves(s), *data)
    old = _leaves(s)
    s = _rebuild(s, iter(
        [torch.where(active.reshape(-1, *(1,) * (o.dim() - 1)), n, o)
         for n, o in zip(new, old)]))
    return s, active_rigs(s, cap).any()


def gather_rigs(s: SLMState, sel: torch.Tensor) -> SLMState:
    """The rows ``sel`` (device indices) of every tensor of a batched
    state."""
    return _rebuild(s, iter([t.index_select(0, sel) for t in _leaves(s)]))


def scatter_rigs(s: SLMState, sel: torch.Tensor, part: SLMState) -> SLMState:
    """``s`` with the rows ``sel`` replaced by ``part``'s (out of place)."""
    return _rebuild(s, iter([t.index_copy(0, sel, p)
                             for t, p in zip(_leaves(s), _leaves(part))]))


def slm_run_batch(neq_fn, state: SLMState, data: tuple, *,
                  max_nfev: int = 100, nfev_cap: int | None = None,
                  sel: torch.Tensor | None = None,
                  reduced_solver: str = "dense", ops=None,
                  graph=False) -> SLMState:
    """``slm_run`` over a leading rig axis, with the semantics of
    ``jax.vmap`` of its ``lax.while_loop``: a rig is active while
    ``(status == 0) & (nfev_dev < nfev_cap)``, computed on the device
    before each step; the loop steps the batch while any rig is active,
    and an inactive rig's state is kept as it was (``batch_step``). Each
    rig takes the iteration sequence of its own ``slm_run`` (the default
    tolerances, ``reduced_solver``; the structured linear algebra, or
    ``ops`` as ``slm_run``'s).

    :param sel: (n,) device indices: advance only those rigs (their rows
        of the state and the data gathered first) and return their state.
    :param graph: False runs the host loop (one read a step: whether any
        rig is still active, and one at entry); a
        ``fleet.FleetGraph`` runs each step as one replay of its CUDA
        graph (on a CPU state: its step body, uncaptured).
    """
    kw = _step_config(state.lam.dtype, max_nfev,
                      reduced_solver=reduced_solver)
    step = functools.partial(
        batch_step, neq_fn,
        functools.partial(_slm_step, ops=_resolve_ops(ops), **kw))
    cap = NO_CAP if nfev_cap is None else nfev_cap
    if graph is not False:
        return graph.run(step, state, data, cap, sel, kw)
    if sel is not None:
        state = gather_rigs(state, sel)
        data = tuple(d.index_select(0, sel) for d in data)
    cap = torch.tensor(cap, dtype=torch.int32, device=state.lam.device)
    more = bool(active_rigs(state, cap).any())
    while more:
        state, more = step(state, data, cap)
        more = bool(more)
    return state


def slm_result_batch(state: SLMState) -> SLMResult:
    """The batched result: per-rig tensors, and each rig's nfev and nit
    (lists of ints) from its device counters, in one read."""
    nfev, nit = torch.stack([state.nfev_dev, state.it_dev]).tolist()
    return SLMResult(x=state.x, cost=state.neq.cost, nfev=nfev, nit=nit,
                     status=state.status, history=state.history)
