"""Fleet bundle adjustment: R same-target rigs in ONE batched LM solve.

Counterpart of the optim-level fleet of ``pycamset_tpu/optim/fleet.py``:
the convergence-cohort cascade ``make_cascade_solve`` (``:145-187``) that
``bench.py::fleet_problem`` solves. The rigs share one structure (chain,
camera and image counts) and one calibration target. Each LM step of the
batch is ``torch.func.vmap`` of the one-rig step
(``structured_lm.slm_run_batch``), where ``jax.vmap`` batched the JAX
step; under vmap Kernels A and B fold the rig axis into their block and
camera axes (``cuda_grams._fold_rigs``), so one launch serves every rig of
an evaluation, as the rig axis of the vmapped ``pallas_call``'s grid did.

On a card each step of a cohort is one replay of a CUDA graph
(``FleetGraph``, one per cohort size: R, R/2 and R/8 rigs) and one read.
``graph=False`` runs the uncaptured batched step from the host, the
reference the graphs are held to bit for bit.

Not ported yet (ROADMAP Queue A item 6): the handler-level
``build_fleet_problem`` / ``run_fleet_bundle_adjustment``, the tied fleet
(``:465``) and the mixed fleet (``:701``), the sharded fleet (``mesh=``)
and the CG reduced solver.
"""
from __future__ import annotations

import numpy as np
import torch

from pycamset_tpu_torch.ops import cuda_cholesky as cc
from pycamset_tpu_torch.optim.structured import ParamPieces
from pycamset_tpu_torch.optim.structured_lm import (
    SLMResult, SLMState, _leaves, _rebuild, active_rigs, capture,
    scatter_rigs, slm_init_batch, slm_result_batch, slm_run_batch)


def shared_template(tpls) -> np.ndarray:
    """The one (K, 3) point table of a fleet's rigs (host numpy, one per
    rig); raises ``ValueError`` unless every rig's is the same: fleet
    rigs must share one calibration target (``pycamset_tpu/optim/
    fleet.py:128``), so one table serves the whole batch."""
    tpls = [np.asarray(t) for t in tpls]
    for r, t in enumerate(tpls[1:], start=1):
        if t.shape != tpls[0].shape or not np.array_equal(t, tpls[0]):
            raise ValueError(
                f"rig {r}'s target points differ from rig 0's (fleet rigs "
                f"must share one calibration target)")
    return tpls[0]


def make_cascade_solve(init, run, n_rigs: int, cap1: int = 9,
                       cap2: int = 13):
    """Convergence-cohort cascade over a batch of same-structure solves.

    The full batch runs to ``cap1`` evaluations (about the median rig's),
    then the least-converged HALF (``argsort(stable=True)`` of
    ``status != 0``, on the device) runs on to ``cap2``, then an EIGHTH to
    the end, then the full batch again (the polish pass, a no-op when
    every rig has converged). A cohort's rows are gathered from the batch
    and scattered back. Each rig takes exactly its own iteration sequence
    (``slm_run_batch`` pauses and resumes it), so the results are a
    lockstep run's.

    :param init: fn(x0s, data) -> the batched SLMState.
    :param run: fn(state, data, cap, sel) -> the state of the rigs ``sel``
        (device indices; all when None) advanced to ``cap`` evaluations
        (None: to convergence or the budget).
    :return: solve(x0s, data) -> the batched SLMState.
    """
    def solve(x0s, data):
        st = run(init(x0s, data), data, cap1, None)
        for frac, cap in ((2, cap2), (8, None)):
            r_sub = max(n_rigs // frac, 1)
            # least-converged first, the original order kept among ties
            key = (st.status != 0).to(torch.int32)
            sel = torch.argsort(key, stable=True)[:r_sub]
            st = scatter_rigs(st, sel, run(st, data, cap, sel))
        return run(st, data, None, None)

    return solve


def fleet_solve(neq_fn, x0s: ParamPieces, data: tuple, *,
                max_nfev: int = 100, graph: bool | dict = False) -> SLMResult:
    """The cascade solve of a fleet from its starts.

    :param neq_fn: fn(pieces, *data_r) -> NormalEq, one rig's builder.
    :param x0s: the starts, each piece with a leading rig axis.
    :param data: the per-rig tensors neq_fn takes, each with a leading rig
        axis.
    :param graph: False runs the host loop; a dict {cohort size:
        FleetGraph} runs each step of a cohort as a replay of its graph,
        the runners made on first use and kept in the dict for later
        solves.
    :return: the batched SLMResult (nfev and nit: lists of ints).
    """
    n_rigs = x0s.cam.shape[0]

    def init(x0s, data):
        return slm_init_batch(neq_fn, x0s, data, max_nfev=max_nfev)

    def run(st, data, cap, sel):
        n = n_rigs if sel is None else sel.shape[0]
        runner = False if graph is False else graph.setdefault(n, FleetGraph())
        return slm_run_batch(neq_fn, st, data, max_nfev=max_nfev,
                             nfev_cap=cap, sel=sel, graph=runner)

    solve = make_cascade_solve(init, run, n_rigs)
    return slm_result_batch(solve(x0s, data))


class FleetGraph:
    """The batched LM step of one cohort size as a CUDA graph: captured
    once, then replayed once per step with one read (whether any rig of
    the cohort is still active).

    The step reads and writes one set of state buffers (``st``), and reads
    the cohort's data (``dat``) and its evaluation cap (``cap``) from fixed
    buffers. Before each run the host fills them on the device: a copy of
    the batch, or a gather of the cohort's rows (``sel``). The cascade's
    cohorts change from stage to stage and from solve to solve, so no
    state and no data of a cohort is baked into the graph: only the
    problem's shared tensors (the target, the column masks).

    On a CUDA state the runner's first step is uncaptured, on the side
    stream of the capture (it advances the state and runs the kernels'
    one-time set-up outside the capture); the next step is captured, and
    every later step, in this run and later ones, is a replay. A capture
    that fails raises. On a CPU state the body runs uncaptured: the same
    buffers and reads.
    """

    def __init__(self):
        self.graph: torch.cuda.CUDAGraph | None = None
        self.config = None
        self.step = None
        self.like = None        # an SLMState over the ``st`` buffers
        self.st = self.dat = self.cap = self.read = None
        self.stream = None
        self.capture_ms = None
        self.steps = self.replays = self.reads = 0

    def run(self, step, s: SLMState, data: tuple, cap: int, sel,
            kw: dict) -> SLMState:
        """slm_run_batch's loop through this runner (``step``: (state,
        data, cap) -> (state, any active), kept from the first run;
        ``kw``: its configuration)."""
        rows = [t.shape[1:] for t in _leaves(s)] + [d.shape[1:] for d in data]
        config = (cc.psd_opted_in(), kw, rows, s.lam.dtype, s.lam.device)
        if self.config is None:
            self.config, self.step = config, step
            self._buffers(s, data, s.lam.shape[0] if sel is None
                          else sel.shape[0])
        elif config != self.config:
            raise ValueError("this FleetGraph was made for another "
                             "dense-solve route, problem or configuration")
        if sel is None:
            torch._foreach_copy_(self.st + self.dat, _leaves(s) + list(data))
        else:
            for buf, t in zip(self.st + self.dat, _leaves(s) + list(data)):
                torch.index_select(t, 0, sel, out=buf)
        self.cap.fill_(cap)
        cuda = s.lam.device.type == "cuda"
        more = self._read(active_rigs(self.like, self.cap).any())
        while more:
            self.steps += 1
            if cuda and self.stream is None:
                self._first_step(s.lam.device)
            else:
                if cuda and self.graph is None:
                    self._capture()
                if self.graph is not None:
                    self.graph.replay()
                    self.replays += 1
                else:
                    self.body()
            more = self._read(self.read)
        return _rebuild(s, iter([t.clone() for t in self.st]))

    def body(self):
        """The captured step: one batched step from the ``st`` buffers on
        the ``dat`` buffers, its state back into ``st`` and whether any rig
        is still active into ``read``. Makes no host read, copy or sync."""
        new, more = self.step(self.like, tuple(self.dat), self.cap)
        torch._foreach_copy_(self.st, _leaves(new))
        if self.read is None:       # kept from the first (uncaptured) step
            self.read = more
        else:
            self.read.copy_(more)

    def _buffers(self, s: SLMState, data: tuple, n: int):
        def rows(t):
            return torch.empty((n, *t.shape[1:]), dtype=t.dtype,
                               device=t.device)

        self.st = [rows(t) for t in _leaves(s)]
        self.dat = [rows(d) for d in data]
        self.cap = torch.zeros((), dtype=torch.int32, device=s.lam.device)
        self.like = _rebuild(s, iter(self.st))

    def _read(self, t: torch.Tensor) -> bool:
        self.reads += 1
        return bool(t)

    def _first_step(self, device):
        """The runner's first step, uncaptured, on the capture's side
        stream."""
        self.stream = torch.cuda.Stream(device)
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            self.body()
        torch.cuda.current_stream().wait_stream(self.stream)

    def _capture(self):
        self.graph, self.capture_ms = capture(self.body, self.stream)
