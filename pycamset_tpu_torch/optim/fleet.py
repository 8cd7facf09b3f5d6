"""Fleet bundle adjustment: R same-target rigs in ONE batched LM solve.

Counterpart of ``pycamset_tpu/optim/fleet.py``: the convergence-cohort
cascade ``make_cascade_solve`` (``:145-187``) that ``bench.py::
fleet_problem`` solves, and the handler-level fleet
(``build_fleet_problem``, ``run_fleet_bundle_adjustment``, ``:49-918``):
R handlers of one structure (chain, camera count, key count and
key->group map, solver options) solved as one batch, each rig's
``OptimizeResult`` and ``CameraSet`` returned in handler order. Image
counts may differ per rig (the pose axis pads to the fleet's grid with
fully-masked images, as the single-rig bucket pads), and so may the
fixed-parameter patterns (the 0/1 column masks ride the rig axis). The
rigs share one calibration target: the point table is every rig's. The
template, self-calibration and grouped chains take the structured
normal equations, the mixed chain (PER_KEY + PER_GROUP) the mixed ones,
with the mixed LM ops.

Each LM step of the batch is ``torch.func.vmap`` of the one-rig step
(``structured_lm.slm_run_batch``), where ``jax.vmap`` batched the JAX
step. Under vmap every gram kernel folds the rig axis into one launch, as
the rig axis of the vmapped ``pallas_call``'s grid did: Kernels A and B
into their block and camera axes (``cuda_grams._fold_rigs``), Kernels C-F
with a rig axis of their own (each rig's free points, group poses and key
masks; ``cuda_selfcal_grams._fold_rig_operands``). The cascade runs every
fleet, where the JAX package runs it from 16 rigs and steps smaller
fleets in lockstep: each rig takes its own iteration sequence either way.

On a card each step of a cohort is one replay of a CUDA graph
(``FleetGraph``, one per cohort size: R, R/2 and R/8 rigs) and one read.
``graph=False`` runs the uncaptured batched step from the host, the
reference the graphs are held to bit for bit.

The tied fleet (``shared_intrinsics``, ``_build_tied_fleet``; JAX ``:465-640``)
carries TiedPieces with the tied LM ops (``optim/shared_intr.py``), Kernel B
folded over the rigs as in the template fleet. Opted in to the SPD kernel
(``PYCAMSET_PALLAS_CHOL=1``), every fleet's dense reduced solves go to its
batched form: one launch a batch step (``structured._psd_solve``).

The reduced solver follows the rigs' shared ``reduced_solver`` option as
the one-rig builder's does ("auto": CG above 4096 reduced dimensions,
``structured.auto_reduced_solver``): the CG loop's fixed count of masked
iterations runs under ``torch.func.vmap`` like every other part of the
step, each rig stopping where its own loop would (JAX ``:360-383``). The
pose-free free-point chain (a wand's rigs) takes the fleet too: its image
grid counts each rig's ``detection.max_ims`` (JAX ``:280-282``), and its
wrappers over Kernels C and D fold the rigs into one launch through the
same operators.

Rigs of mixed camera models take the fleet as they take
``build_structured_problem``. Brown models of several widths run the widest model's chain and
its kernels, each rig's narrower cameras' extra columns pinned in that
rig's column masks (which ride the rig axis; the rigs may map models to
cameras differently). A heterogeneous rig (fisheye beside Brown cameras,
``ProjectionHet``) takes ``structured.make_het_grams`` under the vmap: its
selector and pad slots are pinned parameters of each rig's own pieces,
chosen by select. A chain that no closed form serves (a block of the
caller's own; the heterogeneous grouped and mixed chains) takes the
forward-mode route (``structured.make_block_grams``: one
``torch.func.jvp`` a parameter, vmapped over a group's directions), the
fleet's vmap over it. As in the JAX fleet, the rigs' chains and widths
must agree (``FleetMismatch``), and a chain with aux channels (rolling
shutter) is refused. Not ported yet: the sharded fleet (``mesh=``),
raising ``NotImplementedError`` with its ROADMAP item (Queue A item 11).
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from pycamset_tpu_torch.config import default_device_dtype, resolve_device
from pycamset_tpu_torch.ops import cuda_cholesky as cc
from pycamset_tpu_torch.optim.blocks import key_type
from pycamset_tpu_torch.optim.structured import (
    ParamPieces, UnsupportedChain, auto_reduced_solver, build_block_arrays,
    chain_widths, make_structured_neq, pad_pieces_to_grid,
    pad_template_table, split_full_params)
from pycamset_tpu_torch.optim.structured_lm import (
    SLMGraph, SLMResult, SLMState, _leaves, _rebuild, active_rigs, capture,
    scatter_rigs, slm_init_batch, slm_result_batch, slm_run_batch,
    structured_lm_solve)


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


def fleet_solve(neq_fn, x0s, data: tuple, *, max_nfev: int = 100,
                reduced_solver: str = "dense", ops=None,
                graph: bool | dict = False) -> SLMResult:
    """The cascade solve of a fleet from its starts.

    :param neq_fn: fn(pieces, *data_r) -> NormalEq, one rig's builder.
    :param x0s: the starts (ParamPieces, or the mixed chain's
        MixedPieces), each piece with a leading rig axis.
    :param data: the per-rig tensors neq_fn takes, each with a leading rig
        axis.
    :param reduced_solver: "dense" or "cg", as ``slm_run``'s.
    :param ops: the LM's linear algebra, as ``slm_run``'s (None: the
        structured defaults; the mixed chain's ``make_mixed_ops``).
    :param graph: False runs the host loop; a dict {cohort size:
        FleetGraph} runs each step of a cohort as a replay of its graph,
        the runners made on first use and kept in the dict for later
        solves.
    :return: the batched SLMResult (nfev and nit: lists of ints).
    """
    n_rigs = x0s.cam.shape[0]

    def init(x0s, data):
        return slm_init_batch(neq_fn, x0s, data, max_nfev=max_nfev,
                              ops=ops)

    def run(st, data, cap, sel):
        n = n_rigs if sel is None else sel.shape[0]
        runner = False if graph is False else graph.setdefault(n, FleetGraph())
        return slm_run_batch(neq_fn, st, data, max_nfev=max_nfev,
                             nfev_cap=cap, sel=sel,
                             reduced_solver=reduced_solver, ops=ops,
                             graph=runner)

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


# ------------------------------------------------------ the handler fleet

class FleetMismatch(ValueError):
    """The handlers do not describe one common problem structure."""


# solver-relevant options that must agree across the fleet (the one batch
# every rig shares is built from them)
_SHARED_OPTS = ("loss", "f_scale", "loss_semantics", "max_nfev",
                "reduced_solver", "im_bucket", "shared_intrinsics")
_UNSET = object()  # distinguishes "option not set" from an explicit None


def _opt(opts, key, default):
    v = opts[key]
    return default if v is _UNSET or v is None else v


def _chain_names(handler) -> tuple:
    return tuple(type(bk).__name__ for bk in handler.op_fun.blocks)


def _shared_checks(handlers, widths_of, names, widths, n_cams, n_keys,
                   opts, gok=None, n_groups=0):
    """The checks every rig after the first must pass: rig 0's chain,
    widths, camera and key counts, key->group map (``gok``, if any) and
    solver options; raises FleetMismatch naming the first difference."""
    for i, h in enumerate(handlers[1:], start=1):
        if _chain_names(h) != names:
            raise FleetMismatch(
                f"rig {i} chain {_chain_names(h)} != rig 0 chain {names}")
        if widths_of(h.op_fun) != widths:
            raise FleetMismatch(f"rig {i} chain widths differ from rig 0")
        if len(h.cam_names) != n_cams:
            raise FleetMismatch(
                f"rig {i} has {len(h.cam_names)} cameras, rig 0 {n_cams}")
        if h.n_keys() != n_keys:
            raise FleetMismatch(
                f"rig {i} has {h.n_keys()} keys, rig 0 {n_keys} "
                "(fleet rigs must share one calibration target)")
        if gok is not None:
            gok_i = np.asarray(h.group_of_key(), dtype=np.int64)
            if int(h.n_groups()) != n_groups or not np.array_equal(gok_i,
                                                                   gok):
                raise FleetMismatch(
                    f"rig {i} key->group map differs from rig 0")
        opts_i = {k: h.problem_opts.get(k, _UNSET) for k in _SHARED_OPTS}
        if opts_i != opts:
            diff = {k: (opts[k], opts_i[k]) for k in _SHARED_OPTS
                    if opts[k] != opts_i[k]}
            raise FleetMismatch(
                f"rig {i} solver options differ from rig 0: {diff} "
                "(the fleet shares one batched solve)")


def _validate_fleet(handlers):
    """Check every handler shares the structure of handlers[0]; return
    (widths, grouped, gok, n_groups, opts). Raises UnsupportedChain for a
    chain outside the structured layout (the mixed chain:
    ``_validate_mixed_fleet``)."""
    if not handlers:
        raise FleetMismatch("empty fleet")
    h0 = handlers[0]
    names = _chain_names(h0)
    widths = chain_widths(h0.op_fun)
    if getattr(h0.op_fun, "aux_width", 0):
        raise UnsupportedChain(
            "chains with per-detection aux inputs (rolling shutter) have "
            "no fleet path — solve the rigs individually")
    links = [g.link for g in h0.op_fun.groups]
    order = [key_type.PER_CAM, key_type.PER_IMG, key_type.PER_KEY,
             key_type.PER_GROUP]
    if links != sorted(links, key=order.index):
        raise UnsupportedChain(
            "fleet residuals assume cam*,im*,key*-ordered parameter "
            "groups; this chain's are interleaved")
    n_cams, n_keys = len(h0.cam_names), h0.n_keys()
    opts = {k: h0.problem_opts.get(k, _UNSET) for k in _SHARED_OPTS}
    grouped = widths.key_link == key_type.PER_GROUP
    gok, n_groups = None, 0
    if grouped:
        gok = np.asarray(h0.group_of_key(), dtype=np.int64)
        n_groups = int(h0.n_groups())
        # build_structured_problem's diagnostics
        if gok.shape != (n_keys,):
            raise ValueError(
                f"group_of_key() must return one group index per key "
                f"({n_keys},); got shape {gok.shape}")
        if gok.min() < 0 or gok.max() >= n_groups:
            raise ValueError(
                f"group_of_key() indices out of range [0, {n_groups})")
    _shared_checks(handlers, chain_widths, names, widths, n_cams, n_keys,
                   opts, gok, n_groups)
    return widths, grouped, gok, n_groups, opts


def _validate_mixed_fleet(handlers):
    """Mixed-chain (PER_KEY + PER_GROUP) counterpart of _validate_fleet;
    returns (widths, gok, n_groups, opts)."""
    from pycamset_tpu_torch.optim.structured_mixed import mixed_chain_widths
    h0 = handlers[0]
    names = _chain_names(h0)
    widths = mixed_chain_widths(h0.op_fun)  # raises UnsupportedChain
    n_cams, n_keys = len(h0.cam_names), h0.n_keys()
    opts = {k: h0.problem_opts.get(k, _UNSET) for k in _SHARED_OPTS}
    raw_gok = getattr(h0, "group_of_key", lambda: None)()
    n_groups = int(getattr(h0, "n_groups", lambda: 0)() or 0)
    if raw_gok is None or n_groups <= 0:
        raise UnsupportedChain(
            "mixed PER_KEY + PER_GROUP fleet needs the handlers to "
            "implement group_of_key() and n_groups() (see "
            "structured_driver.build_mixed_structured_problem)")
    gok = np.asarray(raw_gok, dtype=np.int64)
    if gok.shape != (n_keys,) or gok.min() < 0 or gok.max() >= n_groups:
        raise ValueError("group_of_key() must map every key into "
                         f"[0, {n_groups})")
    _shared_checks(handlers, mixed_chain_widths, names, widths, n_cams,
                   n_keys, opts, gok, n_groups)
    return widths, gok, n_groups, opts


@dataclass
class RigHost:
    """One rig's host data: its layout, full start vector, free indices,
    the detection table of its residuals and its true image count."""
    struct: object
    base_full: np.ndarray
    free_idx: np.ndarray
    dd: np.ndarray
    n_ims: int
    n_real: int


@dataclass
class HandlerFleet:
    """R handlers' problems of one structure on one device, solved as one
    batch: the handler-level counterpart of the JAX ``FleetProblem``
    (``solve``, ``residual``, ``x0s``, ``residuals_from_pieces``,
    ``x0_pieces``). The per-rig tensors carry a leading rig axis, the
    column masks among them; the point table is every rig's.

    ``solve()`` -> (list of (x_free, the rig's SLMResult), the batched
    SLMResult). On a card each step of a cohort of the cascade is one
    replay of this fleet's graph for that cohort size (``graph``);
    ``solve(graph=False)`` runs the uncaptured batched step, the
    reference. On the CPU, the host loop. ``solo(r)``: rig r alone."""
    op_fun: object
    widths: object
    mixed: bool
    n_cams: int
    n_ims_grid: int
    n_keys: int
    x0_pieces: tuple           # ParamPieces or MixedPieces, rig axis first
    uv: torch.Tensor           # (R, B, K, 2)
    mask: torch.Tensor         # (R, B, K)
    tpl: torch.Tensor          # (K, 3), every rig's
    colmask: tuple             # 0/1 unfixed masks, rig axis first
    neq_raw: Callable          # one rig's neq(p, uv, mask, tpl, colmask)
    ops: tuple | None          # the LM's linear algebra (None: structured)
    max_nfev: int
    rigs: list                 # RigHost per rig
    x0s: list                  # per-rig initial free parameters
    merge: Callable            # (r, a rig's pieces) -> full numpy vector
    residuals_of: list         # per rig: pieces -> (n_real, 2) numpy
    to_pieces: Callable        # (r, full numpy) -> that rig's pieces
    group_of_key: np.ndarray | None = None   # (K,) of the grouped chains
    n_groups: int = 0
    reduced_solver: str = "dense"  # or "cg"; mixed and tied fleets: dense
    graphs: dict = field(default_factory=dict, repr=False, compare=False)
    solos: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def n_rigs(self) -> int:
        return self.uv.shape[0]

    @property
    def n_real(self) -> np.ndarray:
        """(R,) real detections per rig."""
        return np.array([h.n_real for h in self.rigs])

    def neq_fn(self):
        """neq(pieces, uv, mask, *colmask pieces) -> one rig's normal
        equations, on its data."""
        pieces = type(self.colmask)
        return lambda p, uv, mask, *cm: self.neq_raw(p, uv, mask, self.tpl,
                                                     pieces(*cm))

    def key_operands(self, pieces, colmask):
        """(keyp, kmask) of every rig (rig axis first): the c-axis rows on
        the key grid and their column masks, as the gram kernels take
        them (a grouped chain's per-group rows expanded by the group
        one-hot; the mixed chain's [group pose | point])."""
        if self.group_of_key is None:
            return pieces.key, colmask.key
        from pycamset_tpu_torch.optim.structured import group_onehot
        oh = torch.as_tensor(group_onehot(self.group_of_key, self.n_groups),
                             dtype=self.uv.dtype, device=self.uv.device)
        if self.mixed:
            return (torch.cat([oh @ pieces.grp, pieces.key], dim=-1),
                    torch.cat([oh @ colmask.grp, colmask.key], dim=-1))
        return oh @ pieces.key, oh @ colmask.key

    def data(self) -> tuple:
        """The per-rig tensors the batched step reads: uv, mask and the
        column masks."""
        return (self.uv, self.mask, *self.colmask)

    def graph(self, max_nfev: int | None = None) -> dict:
        """This fleet's step runners ({cohort size: FleetGraph}) for the
        dense-solve route in force, its dtype, ``max_nfev`` and reduced
        solver: captured by the first solve, replayed by the later ones."""
        key = (cc.psd_opted_in(), self.uv.dtype, max_nfev or self.max_nfev,
               self.reduced_solver)
        return self.graphs.setdefault(key, {})

    def solve_batch(self, graph: bool = True) -> SLMResult:
        """The cascade solve of every rig from its start: the batched
        SLMResult (nfev and nit per rig, lists of ints)."""
        graph = (self.graph() if graph and self.uv.device.type == "cuda"
                 else False)
        return fleet_solve(self.neq_fn(), self.x0_pieces, self.data(),
                           max_nfev=self.max_nfev,
                           reduced_solver=self.reduced_solver, ops=self.ops,
                           graph=graph)

    def rig_result(self, res: SLMResult, r: int) -> SLMResult:
        """Rig r's SLMResult of a batched one."""
        return SLMResult(
            x=type(res.x)(*(p[r] for p in res.x)), cost=res.cost[r],
            nfev=res.nfev[r], nit=res.nit[r], status=res.status[r],
            history=res.history[r])

    def extract_free(self, r: int, x) -> np.ndarray:
        """Rig r's free parameter vector (float64 numpy) of its pieces."""
        return self.merge(r, x)[self.rigs[r].free_idx]

    def solve(self, graph: bool = True):
        """-> (list of (x_free, SLMResult) per rig, the batched
        SLMResult)."""
        res = self.solve_batch(graph)
        out = []
        for r in range(self.n_rigs):
            res_r = self.rig_result(res, r)
            out.append((self.extract_free(r, res_r.x), res_r))
        return out, res

    def residual(self, r: int, x_free: np.ndarray) -> np.ndarray:
        """Rig r's (n_real, 2) residuals at its free vector x_free, in its
        detection table's row order (float64 numpy, computed on the
        device)."""
        h = self.rigs[r]
        full = h.base_full.copy()
        full[h.free_idx] = np.asarray(x_free, dtype=np.float64)
        return self.residuals_of[r](self.to_pieces(r, full))

    def residuals_from_pieces(self, pieces_b) -> list:
        """Every rig's residuals at batched pieces (rig axis first)."""
        return [self.residuals_of[r](type(pieces_b)(*(p[r]
                                                      for p in pieces_b)))
                for r in range(self.n_rigs)]

    def rms_px(self, cost) -> np.ndarray:
        """(R,) sqrt(cost / (2 n_real)) per rig, as bench.py reports it."""
        cost = torch.as_tensor(cost).double().cpu().numpy()
        return np.sqrt(cost / (2 * self.n_real))

    def solo(self, r: int) -> "RigAlone":
        """Rig r as a problem of its own (kept, with its graphs), to solve
        it alone beside the fleet."""
        if r not in self.solos:
            self.solos[r] = RigAlone(self, r)
        return self.solos[r]


@dataclass
class RigAlone:
    """One rig of a HandlerFleet solved without the rig axis: the fleet's
    normal equations on the rig's start, data and column masks, through
    the one-rig LM (``structured_lm_solve``; on a card one replay of this
    rig's CUDA graph a step, as a one-rig problem's). The rig's iteration
    sequence in the fleet's cascade is this one up to the rounding of the
    batched operations: in a flat valley (float32 on a card) a late step's
    accept or stop can differ."""
    fleet: HandlerFleet
    r: int
    graphs: dict = field(default_factory=dict, repr=False, compare=False)

    def solve(self, graph: bool = True) -> SLMResult:
        f, r = self.fleet, self.r
        x0 = type(f.x0_pieces)(*(p[r] for p in f.x0_pieces))
        data = [d[r] for d in f.data()]
        neq = f.neq_fn()
        if graph and f.uv.device.type == "cuda":
            key = (cc.psd_opted_in(), f.uv.dtype, f.max_nfev)
            graph = self.graphs.setdefault(key, SLMGraph())
        return structured_lm_solve(lambda p: neq(p, *data), x0,
                                   max_nfev=f.max_nfev,
                                   reduced_solver=f.reduced_solver,
                                   ops=f.ops, graph=graph)


def _rig_hosts(handlers, x0s, op_fun, n_cams: int, n_ims_grid: int,
               n_keys: int, n_groups: int, k_pad_multiple: int):
    """Every rig's host data (RigHost: its layout, full start with x0 in
    place, free indices, detection table) and its block grid's uv and mask
    on the fleet's grid."""
    rigs, uvs, masks = [], [], []
    for h, x0 in zip(handlers, x0s):
        n_ims = int(h.bundlePrimitive.poses.shape[0])
        dd = h.get_detection_data(flatten=True)
        blocks = build_block_arrays(dd, n_cams, n_ims_grid, n_keys,
                                    k_pad_multiple=k_pad_multiple)
        base_full = h.bundlePrimitive.base_full()
        unfixed = h.bundlePrimitive.unfixed_full()
        base_full[unfixed] = x0
        rigs.append(RigHost(op_fun.param_struct(n_cams, n_ims, n_keys,
                                                n_groups=n_groups),
                            base_full, np.where(unfixed)[0], dd, n_ims,
                            blocks.n_real))
        uvs.append(blocks.uv)
        masks.append(blocks.mask)
    return rigs, uvs, masks


def _unfixed(h: RigHost) -> np.ndarray:
    """(full,) bool: a rig's free entries."""
    unfixed = np.zeros(h.base_full.shape, dtype=bool)
    unfixed[h.free_idx] = True
    return unfixed


def _fleet_grid(handlers, opts, true_ims):
    """The fleet's image grid: the largest true image count, padded to a
    multiple of ``im_bucket`` (explicit None: not padded; unset: 8)."""
    from pycamset_tpu_torch.optim.structured_driver import image_grid
    v = opts["im_bucket"]
    return image_grid(max(true_ims(h) for h in handlers),
                      8 if v is _UNSET else v)


def _shared_table(handlers, op_fun, n_keys: int, k_pad: int) -> np.ndarray:
    """The one (k_pad, 3) point table of the fleet; FleetMismatch unless
    every rig's is the same (the template and grouped chains read it; the
    free-point ones have zeros)."""
    tables = [pad_template_table(h.template_table(), op_fun.templated,
                                 n_keys, k_pad) for h in handlers]
    try:
        return shared_template(tables)
    except ValueError as e:
        raise FleetMismatch(str(e)) from e


def build_fleet_problem(handlers, dtype=None, device="cuda",
                        k_pad_multiple: int = 128, mesh=None) -> HandlerFleet:
    """R same-structure handlers on ONE batched structured solve, on
    ``device`` (the card unless the caller names another; dtype as
    ``config.default_device_dtype``).

    Single-rig counterpart: ``structured_driver.build_structured_problem``
    (the mixed chain: ``build_mixed_structured_problem``). Any chain those
    two take, per-camera model maps included, but one with
    aux channels (rolling shutter, ``UnsupportedChain`` as in the JAX
    fleet). Raises UnsupportedChain for a chain outside both structured
    layouts, FleetMismatch when the handlers' structures differ.
    """
    if mesh is not None:
        raise NotImplementedError(
            "a sharded fleet (mesh=) is not ported yet (ROADMAP Queue A "
            "item 11)")
    device = resolve_device(device)
    dtype = dtype or default_device_dtype(device)
    if not handlers:
        raise FleetMismatch("empty fleet")
    # pose seeding runs inside get_initial_params: it precedes every
    # primitive read, as in build_structured_problem
    x0s = [np.asarray(h.get_initial_params(), dtype=np.float64)
           for h in handlers]
    try:
        widths, grouped, gok, n_groups, opts = _validate_fleet(handlers)
    except UnsupportedChain:
        # mixed PER_KEY + PER_GROUP chains have their own fleet path;
        # anything else re-raises from mixed_chain_widths inside
        return _build_mixed_fleet(handlers, x0s, dtype, device,
                                  k_pad_multiple)
    if _opt(opts, "shared_intrinsics", None):
        # the tied fleet has its own pieces: the template path would
        # silently solve untied
        return _build_tied_fleet(handlers, x0s, widths, grouped, opts,
                                 dtype, device, k_pad_multiple)
    h0 = handlers[0]
    op_fun = h0.op_fun
    n_cams, n_keys = len(h0.cam_names), h0.n_keys()

    def true_ims(h):
        # the pose-free chain has no image parameters: every (cam, im) pair
        # of its table still indexes a block (build_structured_problem's)
        return (int(h.bundlePrimitive.poses.shape[0]) if widths.b
                else int(h.detection.max_ims))

    n_ims_grid = _fleet_grid(handlers, opts, true_ims)
    reduced_solver = _opt(opts, "reduced_solver", "auto")
    if reduced_solver == "auto":  # build_structured_problem's rule
        reduced_solver = auto_reduced_solver(widths, n_cams, n_ims_grid)
    from pycamset_tpu_torch.optim.structured_driver import (
        build_colmask_pieces, detection_residuals, merge_structured)
    k_pad = -(-max(n_keys, 1) // k_pad_multiple) * k_pad_multiple
    gok_pad = (np.concatenate([gok, np.full(k_pad - n_keys, gok[0],
                                            dtype=np.int64)])
               if grouped else None)
    tpl = torch.as_tensor(_shared_table(handlers, op_fun, n_keys, k_pad),
                          dtype=dtype, device=device)

    rigs, uvs, masks = _rig_hosts(handlers, x0s, op_fun, n_cams,
                                  n_ims_grid, n_keys, n_groups,
                                  k_pad_multiple)
    cms = [build_colmask_pieces(h.base_full, _unfixed(h), op_fun, h.struct,
                                widths, n_cams, h.n_ims, n_keys, k_pad,
                                n_ims_grid, grouped) for h in rigs]
    merges = [merge_structured(op_fun, h.struct, n_cams, h.n_ims, n_keys,
                               n_groups if grouped else n_keys)
              for h in rigs]

    def to_pieces(r: int, full: np.ndarray) -> ParamPieces:
        h = rigs[r]
        p = split_full_params(torch.as_tensor(full), op_fun, h.struct,
                              n_cams, h.n_ims, n_keys, widths)
        p = pad_pieces_to_grid(p, widths, grouped, n_keys, k_pad, h.n_ims,
                               n_ims_grid)
        return ParamPieces(*(t.to(device=device, dtype=dtype) for t in p))

    if grouped:
        gok_t = torch.as_tensor(gok_pad, device=device)

        def key_rows(p, key):
            return p.key[gok_t[key]]
    else:
        def key_rows(p, key):
            return p.key[key]

    neq_raw = make_structured_neq(
        op_fun, widths, n_cams, n_ims_grid,
        loss=_opt(opts, "loss", "linear"),
        f_scale=float(_opt(opts, "f_scale", 1.0)), group_of_key=gok_pad,
        n_groups=n_groups if grouped else None,
        loss_semantics=_opt(opts, "loss_semantics", "component"))
    return HandlerFleet(
        op_fun, widths, False, n_cams, n_ims_grid, n_keys,
        _stack(ParamPieces, [to_pieces(r, h.base_full)
                             for r, h in enumerate(rigs)]),
        _rows(uvs, dtype, device), _rows(masks, dtype, device), tpl,
        _stack(ParamPieces, [ParamPieces(*(t.to(device=device, dtype=dtype)
                                           for t in cm)) for cm in cms]),
        neq_raw, None, int(_opt(opts, "max_nfev", 100)), rigs, x0s,
        lambda r, x: merges[r](x),
        [detection_residuals(op_fun, h.dd, tpl, key_rows, device, dtype)
         for h in rigs], to_pieces, gok_pad, n_groups,
        reduced_solver=reduced_solver)


def _stack(kind, pieces: list):
    """Per-rig pieces -> pieces with a leading rig axis."""
    return kind(*(torch.stack(p) for p in zip(*pieces)))


def _rows(arrays: list, dtype, device) -> torch.Tensor:
    """Per-rig numpy arrays -> one tensor with a leading rig axis."""
    return torch.as_tensor(np.stack(arrays), dtype=dtype, device=device)


def _build_mixed_fleet(handlers, x0s, dtype, device,
                       k_pad_multiple: int) -> HandlerFleet:
    """Mixed-chain fleet: R multi-target self-calibrations in one batched
    arrow-structured solve, on Kernels E / F (the canonical chain) or the
    forward-mode route (every other chain ``mixed_chain_widths`` takes).
    Single-rig counterpart:
    ``structured_driver.build_mixed_structured_problem``."""
    from pycamset_tpu_torch.optim.structured_driver import (
        detection_residuals)
    from pycamset_tpu_torch.optim.structured_mixed import (
        MixedPieces, make_mixed_ops, make_mixed_structured_neq,
        merge_mixed_to_full, pad_mixed_pieces, split_full_mixed)
    widths, gok, n_groups, opts = _validate_mixed_fleet(handlers)
    if _opt(opts, "shared_intrinsics", None):
        # the single-rig tied backend's refusal (the JAX fleet would solve
        # this chain untied)
        raise UnsupportedChain(
            "shared_intrinsics supports template chains only "
            "(projection + extrinsic + template points)")
    h0 = handlers[0]
    op_fun = h0.op_fun
    n_cams, n_keys = len(h0.cam_names), h0.n_keys()
    n_ims_grid = _fleet_grid(handlers, opts,
                             lambda h: int(h.bundlePrimitive.poses.shape[0]))
    k_pad = -(-max(n_keys, 1) // k_pad_multiple) * k_pad_multiple
    gok_pad = np.concatenate([gok, np.full(k_pad - n_keys, gok[0],
                                           dtype=np.int64)])
    tpl = torch.as_tensor(_shared_table(handlers, op_fun, n_keys, k_pad),
                          dtype=dtype, device=device)

    rigs, uvs, masks = _rig_hosts(handlers, x0s, op_fun, n_cams,
                                  n_ims_grid, n_keys, n_groups,
                                  k_pad_multiple)

    def to_pieces(r: int, full: np.ndarray) -> MixedPieces:
        h = rigs[r]
        p = split_full_mixed(torch.as_tensor(full), op_fun, h.struct,
                             n_cams, h.n_ims, n_keys, n_groups)
        p = pad_mixed_pieces(p, n_keys, k_pad, h.n_ims, n_ims_grid)
        return MixedPieces(*(t.to(device=device, dtype=dtype) for t in p))

    def colmask(r: int) -> MixedPieces:
        h = rigs[r]
        cm = to_pieces(r, _unfixed(h).astype(np.float64))
        cm.key[n_keys:] = 0.0
        cm.im[h.n_ims:] = 0.0
        return cm

    neq_raw = make_mixed_structured_neq(
        op_fun, widths, n_cams, n_ims_grid, group_of_key=gok_pad,
        n_groups=n_groups, loss=_opt(opts, "loss", "linear"),
        f_scale=float(_opt(opts, "f_scale", 1.0)),
        loss_semantics=_opt(opts, "loss_semantics", "component"))
    gok_t = torch.as_tensor(gok_pad, device=device)

    def key_rows(p, key):
        return torch.cat([p.grp[gok_t[key]], p.key[key]], dim=1)

    def merge(r: int, x) -> np.ndarray:
        h = rigs[r]
        return merge_mixed_to_full(x, op_fun, h.struct, n_cams, h.n_ims,
                                   n_keys, n_groups)

    return HandlerFleet(
        op_fun, widths, True, n_cams, n_ims_grid, n_keys,
        _stack(MixedPieces, [to_pieces(r, h.base_full)
                             for r, h in enumerate(rigs)]),
        _rows(uvs, dtype, device), _rows(masks, dtype, device), tpl,
        _stack(MixedPieces, [colmask(r) for r in range(len(rigs))]),
        neq_raw, make_mixed_ops(neq_raw.onehot),
        int(_opt(opts, "max_nfev", 100)), rigs, x0s, merge,
        [detection_residuals(op_fun, h.dd, tpl, key_rows, device, dtype)
         for h in rigs], to_pieces, gok_pad, n_groups)


def _build_tied_fleet(handlers, x0s, widths, grouped, opts, dtype, device,
                      k_pad_multiple: int) -> HandlerFleet:
    """Shared-intrinsics (tied-lens) fleet: TiedPieces state, the folded
    normal equations and the tied LM ops, plugged in as the mixed fleet
    is. Single-rig counterpart: ``shared_intr.
    build_shared_structured_problem``. Every rig must have the same
    lens-group layout (FleetMismatch); per-camera fixed intrinsics raise
    UnsupportedChain."""
    from pycamset_tpu_torch.optim.shared_intr import (
        TiedLayout, TiedPieces, check_no_fixed_intrinsics, check_tied_chain,
        make_tied_ops, resolve_lens_groups)
    from pycamset_tpu_torch.optim.structured_driver import (
        build_colmask_pieces, detection_residuals, merge_structured)
    h0 = handlers[0]
    op_fun = h0.op_fun
    if grouped:
        raise UnsupportedChain(
            "shared_intrinsics supports template chains only "
            "(projection + extrinsic + template points)")
    s = check_tied_chain(op_fun, widths)
    n_cams, n_keys = len(h0.cam_names), h0.n_keys()
    gid = resolve_lens_groups(opts["shared_intrinsics"], h0.cam_names)
    for i, h in enumerate(handlers[1:], start=1):
        gid_i = resolve_lens_groups(opts["shared_intrinsics"], h.cam_names)
        if not np.array_equal(gid_i, gid):
            raise FleetMismatch(
                f"rig {i} lens-group layout differs from rig 0 (the fleet "
                f"shares one tied structure)")
    n_ims_grid = _fleet_grid(handlers, opts,
                             lambda h: int(h.bundlePrimitive.poses.shape[0]))
    k_pad = -(-max(n_keys, 1) // k_pad_multiple) * k_pad_multiple
    tpl = torch.as_tensor(_shared_table(handlers, op_fun, n_keys, k_pad),
                          dtype=dtype, device=device)
    rigs, uvs, masks = _rig_hosts(handlers, x0s, op_fun, n_cams, n_ims_grid,
                                  n_keys, 0, k_pad_multiple)
    cms = [build_colmask_pieces(h.base_full, _unfixed(h), op_fun, h.struct,
                                widths, n_cams, h.n_ims, n_keys, k_pad,
                                n_ims_grid) for h in rigs]
    for cm in cms:
        check_no_fixed_intrinsics(cm, s)
    layout = TiedLayout(gid, s, k_pad)
    merges = [merge_structured(op_fun, h.struct, n_cams, h.n_ims, n_keys,
                               n_keys) for h in rigs]

    def to_pieces(r: int, full: np.ndarray) -> TiedPieces:
        h = rigs[r]
        p = split_full_params(torch.as_tensor(full), op_fun, h.struct,
                              n_cams, h.n_ims, n_keys, widths)
        p = pad_pieces_to_grid(p, widths, False, n_keys, k_pad, h.n_ims,
                               n_ims_grid)
        return layout.tie(ParamPieces(*(t.to(device=device, dtype=dtype)
                                        for t in p)))

    def residuals_of(h: RigHost):
        res = detection_residuals(op_fun, h.dd, tpl,
                                  lambda p, key: p.key[key], device, dtype)
        return lambda tp: res(layout.expand(tp))

    neq_raw = make_structured_neq(
        op_fun, widths, n_cams, n_ims_grid,
        loss=_opt(opts, "loss", "linear"),
        f_scale=float(_opt(opts, "f_scale", 1.0)),
        loss_semantics=_opt(opts, "loss_semantics", "component"))
    return HandlerFleet(
        op_fun, widths, False, n_cams, n_ims_grid, n_keys,
        _stack(TiedPieces, [to_pieces(r, h.base_full)
                            for r, h in enumerate(rigs)]),
        _rows(uvs, dtype, device), _rows(masks, dtype, device), tpl,
        _stack(ParamPieces, [ParamPieces(*(t.to(device=device, dtype=dtype)
                                           for t in cm)) for cm in cms]),
        layout.make_neq(neq_raw), make_tied_ops(layout.onehot),
        int(_opt(opts, "max_nfev", 100)), rigs, x0s,
        lambda r, x: merges[r](layout.expand(x)),
        [residuals_of(h) for h in rigs], to_pieces)


def run_fleet_bundle_adjustment(handlers, dtype=None, device="cuda",
                                mesh=None, graph: bool = True):
    """Solve every handler's bundle adjustment in one batched device solve.

    Fleet counterpart of ``optim/driver.py::run_bundle_adjustment``, on
    ``device`` (the card unless the caller names another).

    :param mesh: a sharded fleet: not ported yet (ROADMAP Queue A item 11).
    :param graph: on a card, each step of the cascade a CUDA graph replay
        (the fleet's graphs captured by this solve); False: uncaptured.
    :return: (list[OptimizeResult], list[CameraSet]): one per rig, in
        handler order.
    """
    from pycamset_tpu_torch.optim.driver import OptimizeResult

    logging.info(f"Making a fleet optimisation problem ({len(handlers)} "
                 "rigs, one batched solve)")
    prob = build_fleet_problem(handlers, dtype=dtype, device=device,
                               mesh=mesh)
    for r, err in enumerate(prob.residuals_from_pieces(prob.x0_pieces)):
        e = float(np.mean(np.linalg.norm(err, axis=1)))
        logging.info(f"rig {r}: initial Euclidean error {e:.2f} px")
        if e > 150 or np.isnan(e):
            logging.critical(
                f"rig {r}: worryingly high/NaN initial error: check its "
                "seeding before trusting the fleet solve")

    start = time.time()
    solved, res_raw = prob.solve(graph=graph)
    logging.info(f"Fleet optimisation took {time.time() - start: .2f} "
                 "seconds.")
    final_errs = prob.residuals_from_pieces(res_raw.x)

    results, camsets = [], []
    for r, (handler, (x_final, res)) in enumerate(zip(handlers, solved)):
        final_res = final_errs[r]
        e = float(np.mean(np.linalg.norm(final_res, axis=1)))
        logging.info(f"rig {r}: final Euclidean error {e:.2f} px "
                     f"(nit={int(res.nit)}, status={int(res.status)})")
        if e > 5:
            logging.critical(f"rig {r}: remaining error is very large: "
                             "please check its output")
        hist = np.asarray(res.history.double().cpu())
        opt = OptimizeResult(
            x=x_final, fun=final_res.reshape(-1), jac=None,
            cost=float(res.cost) * 0.5, nfev=int(res.nfev),
            nit=int(res.nit), status=int(res.status),
            history=hist[hist >= 0])
        camset = handler.get_camset(x_final)
        camset.set_calibration_history(opt, handler)
        results.append(opt)
        camsets.append(camset)
    return results, camsets
