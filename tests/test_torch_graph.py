"""The LM loop as a device program, on the CPU: device counters and the
step runner.

The step keeps ``nfev`` and ``it`` as device counters (``nfev_dev``,
``it_dev``), computes status 4 and the history index from them, and the
host keeps the same counts as integers. ``SLMGraph`` (the runner a card
captures as a CUDA graph) runs its step body uncaptured on CPU tensors:
its two buffer sets, its one read a step, and its rerun of a step whose
dense solve missed the residual rule. Small rigs in float64:

- the device-counter step, through the host loop and through the runner,
  against the JAX package's ``structured_lm_solve`` (template and mixed
  chains): the same nit/nfev/status, the cost to 1e-9 relative;
- the runner gives the host loop's bits on all four chains;
- ``nfev_cap`` pause/resume and status 4 at ``max_nfev`` with the device
  counters, the runner and the host loop mixed;
- a residual flag injected to fail at a chosen LM step: the runner reruns
  that step with the library fallback and gives the bits of the host loop
  that takes the same fallback there.

The captured graph itself needs a card (``tests/test_torch_cuda.py``).
"""
import functools

import numpy as np
import pytest
import torch

import bench
import test_torch_slice
from pycamset_tpu_torch.ops import cuda_cholesky as cc
from pycamset_tpu_torch.optim import structured as ts
from pycamset_tpu_torch.optim.structured_lm import (SLMGraph, _leaves,
                                                    slm_init, slm_result,
                                                    slm_run)
from pycamset_tpu_torch.problems import (grouped_problem, mixed_problem,
                                         selfcal_problem, standard_problem)

N_CAMS, N_IMS, GRID = 4, 6, 5


def _problem(chain):
    if chain == "template":
        return standard_problem(N_CAMS, N_IMS, "cpu", grid=GRID,
                                k_pad_multiple=8)
    make = {"selfcal": selfcal_problem, "mixed": mixed_problem,
            "grouped": grouped_problem}[chain]
    return make(N_CAMS, N_IMS, "cpu", grid=GRID)


@functools.cache
def _jax_result(chain):
    """The JAX package's float64 solve of the chain's problem."""
    if chain == "template":
        return test_torch_slice._jax_solve(N_CAMS, N_IMS, GRID, "linear")
    solve, pieces, args, _ = bench.mixed_problem(N_CAMS, N_IMS, grid=GRID)
    return solve(pieces, *args)


def _run(prob, graph, state=None, **kw):
    """slm_run on the problem (from slm_init unless ``state`` is given)."""
    neq_fn, ops = prob.neq_fn(), prob.ops()
    kw.setdefault("max_nfev", prob.max_nfev)
    if state is None:
        state = slm_init(neq_fn, prob.x0, max_nfev=kw["max_nfev"], ops=ops)
    return slm_run(neq_fn, state, ops=ops, graph=graph, **kw)


def _assert_same_bits(a, b):
    assert (a.nfev, a.it) == (b.nfev, b.it)
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y)


def _assert_counters(state):
    assert (int(state.nfev_dev), int(state.it_dev)) == (state.nfev, state.it)


@pytest.mark.parametrize("mode", ["host", "runner"])
@pytest.mark.parametrize("chain", ["template", "mixed"])
def test_device_counter_lm_matches_jax_package(chain, mode):
    prob = _problem(chain)
    state = _run(prob, SLMGraph() if mode == "runner" else False)
    _assert_counters(state)
    got, ref = slm_result(state), _jax_result(chain)
    assert (got.nit, got.nfev, int(got.status)) == (
        int(ref.nit), int(ref.nfev), int(ref.status))
    assert int(got.status) in (1, 2)
    assert abs(float(got.cost) - float(ref.cost)) <= 1e-9 * float(ref.cost)
    n = got.nit + 1
    assert np.abs(got.history[:n].numpy() - np.asarray(ref.history)[:n]
                  ).max() <= 1e-9 * float(ref.history[0])
    assert bool((got.history[n:] == -1.0).all())


@pytest.mark.parametrize("chain", ["template", "selfcal", "mixed", "grouped"])
def test_runner_gives_the_host_loops_bits(chain):
    prob = _problem(chain)
    runner = SLMGraph()
    host, ran = _run(prob, False), _run(prob, runner)
    _assert_same_bits(ran, host)
    # one read a step, no rerun on the library route
    assert (runner.steps, runner.reads, runner.reruns) == (ran.it, ran.it, 0)
    # a second run of the same runner reloads its buffers
    _assert_same_bits(_run(prob, runner), host)


@pytest.mark.parametrize("pause,resume", [("runner", "runner"),
                                          ("runner", "host"),
                                          ("host", "runner")])
def test_nfev_cap_pause_resume_with_device_counters(pause, resume):
    prob = _problem("template")
    runner = SLMGraph()

    def graph(mode):
        return runner if mode == "runner" else False

    whole = _run(prob, False)
    paused = _run(prob, graph(pause), nfev_cap=3)
    assert paused.nfev == 3 and int(paused.status) == 0
    _assert_counters(paused)
    resumed = _run(prob, graph(resume), state=paused)
    _assert_counters(resumed)
    _assert_same_bits(resumed, whole)


@pytest.mark.parametrize("mode", ["host", "runner"])
def test_max_nfev_sets_status_4_from_the_device_counter(mode):
    prob = _problem("template")
    state = _run(prob, SLMGraph() if mode == "runner" else False, max_nfev=3)
    assert (state.nfev, int(state.status)) == (3, 4)
    _assert_counters(state)
    assert int(state.nfev_dev) == 3


def _fail_flag_at(monkeypatch, step):
    """The one-launch route forced (its plain twin on CPU tensors) and its
    residual flag false at the ``step``-th check (one check a step): the
    fallback is taken at that LM step."""
    monkeypatch.setattr(ts, "use_cuda_psd", lambda n, dtype, device: True)
    checks, orig = [], cc.residual_ok

    def residual_ok(res2, b2):
        checks.append(1)
        ok = orig(res2, b2)
        return ok & False if len(checks) == step else ok

    monkeypatch.setattr(cc, "residual_ok", residual_ok)
    return checks


# step 1 is the runner's uncaptured first step, later ones its step body
@pytest.mark.parametrize("chain,step", [("template", 1), ("template", 3),
                                        ("mixed", 2)])
def test_runner_reruns_the_step_whose_flag_fails(monkeypatch, chain, step):
    prob = _problem(chain)
    checks = _fail_flag_at(monkeypatch, step)
    cc.psd_solve.fallbacks = 0
    host = _run(prob, False)
    assert cc.psd_solve.fallbacks == 1 and len(checks) == host.it
    checks.clear()
    cc.psd_solve.fallbacks = 0
    runner = SLMGraph()
    ran = _run(prob, runner)
    assert cc.psd_solve.fallbacks == 1 and len(checks) == ran.it
    assert runner.reruns == 1
    # one read a step, and one for the rerun
    assert (runner.steps, runner.reads) == (ran.it, ran.it + 1)
    _assert_same_bits(ran, host)


def test_runner_refuses_another_route(monkeypatch):
    prob = _problem("template")
    runner = SLMGraph()
    monkeypatch.delenv("PYCAMSET_PALLAS_CHOL", raising=False)
    _run(prob, runner, nfev_cap=2)
    monkeypatch.setenv("PYCAMSET_PALLAS_CHOL", "1")
    with pytest.raises(ValueError, match="route"):
        _run(prob, runner, nfev_cap=2)
    # the problem keeps one runner per route
    kernel_route = prob.graph()
    assert prob.graph() is kernel_route
    monkeypatch.delenv("PYCAMSET_PALLAS_CHOL")
    assert prob.graph() is not kernel_route
