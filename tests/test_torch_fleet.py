"""Port parity: the fleet solve, R same-target rigs in one batched LM.

``bench.py::fleet_problem(6, 3, 16, grid=5)`` (16 images: the fused
family, Kernel B's twin) is solved in float64 on the CPU by the JAX
package (``jax.vmap`` of the structured LM under the convergence-cohort
cascade) and by the port (``problems.fleet_problem``: ``torch.func.vmap``
of the one-rig step, the same cascade):

- the same starts and data, then per rig the same nit, nfev and status,
  and the cost within 1e-9 relative;
- each port rig against the port's solo solve of that rig (``.solo(r)``):
  the same nit, nfev and status, the cost within 1e-9;
- the cascade against one lockstep run of the whole batch to convergence;
- Kernels A and B under vmap fold the rig axis into one call, whose rows
  equal per-rig calls of the plain twins exactly;
- the fleet's step runners (the CUDA graphs of a card) run uncaptured and
  give the host loop's bits;
- the shared-target rule, the opt-in SPD route on a batch (the batched
  kernel's op, its twin on the CPU), and the entry points' default device.

The captured graphs and the folded kernels themselves need a card
(``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

import bench
from pycamset_tpu_torch import problems
from pycamset_tpu_torch.from_jax import fleet_from_numpy
from pycamset_tpu_torch.optim import cuda_grams as cg
from pycamset_tpu_torch.optim import structured as ts
from pycamset_tpu_torch.optim.fleet import fleet_solve
from pycamset_tpu_torch.optim.structured_lm import (slm_init_batch,
                                                    slm_result_batch,
                                                    slm_run_batch)

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)

N_RIGS, N_CAMS, N_IMS, GRID = 6, 3, 16, 5


@pytest.fixture(scope="module")
def jax_fleet():
    """The JAX package's fleet: its stacked inputs (numpy) and its solve."""
    solve, pieces, args, n_real, _ = bench.fleet_problem(N_RIGS, N_CAMS,
                                                         N_IMS, grid=GRID)
    res = solve(pieces, *args)
    return ([np.asarray(p) for p in pieces], [np.asarray(a) for a in args],
            n_real, {k: np.asarray(getattr(res, k))
                     for k in ("nit", "nfev", "status", "cost")})


@pytest.fixture(scope="module")
def port_fleet():
    """The port's fleet on the CPU and its solve (the host loop)."""
    prob = problems.fleet_problem(N_RIGS, N_CAMS, N_IMS, "cpu", grid=GRID)
    return prob, prob.solve()


def _per_rig(res, r):
    return res.nit[r], res.nfev[r], int(res.status[r])


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def test_fleet_inputs_match_jax_package(jax_fleet, port_fleet):
    pieces, (uv, mask, tpl), n_real, _ = jax_fleet
    prob, _ = port_fleet
    x0, uv_t, mask_t, tpl_t = fleet_from_numpy(pieces, uv, mask, tpl, "cpu",
                                               torch.float64)
    # the same starts and detections, to the rounding of the port's own
    # copy of the synthetic rig (its numpy Rodrigues: about 1e-15)
    for got, want in [*zip(prob.x0[:2], x0[:2]), (prob.uv, uv_t)]:
        assert float((got - want).abs().max()) <= 1e-12 * float(
            want.abs().max())
    assert prob.x0.key.shape == x0.key.shape
    assert torch.equal(prob.mask, mask_t)
    assert torch.equal(prob.tpl, tpl_t)
    assert int(prob.n_real.sum()) == n_real


@pytest.mark.parametrize("r", range(N_RIGS))
def test_fleet_rig_matches_jax_package(jax_fleet, port_fleet, r):
    ref = jax_fleet[3]
    prob, res = port_fleet
    assert _per_rig(res, r) == (int(ref["nit"][r]), int(ref["nfev"][r]),
                                int(ref["status"][r]))
    assert int(res.status[r]) in (1, 2)
    assert _rel(res.cost[r], ref["cost"][r]) <= 1e-9
    assert prob.rms_px(res.cost)[r] <= 0.36


@pytest.mark.parametrize("r", range(N_RIGS))
def test_fleet_rig_matches_its_solo_solve(port_fleet, r):
    prob, res = port_fleet
    solo = prob.solo(r).solve()
    assert _per_rig(res, r) == (solo.nit, solo.nfev, int(solo.status))
    assert _rel(res.cost[r], solo.cost) <= 1e-9


def test_cascade_matches_lockstep(port_fleet):
    """nit, nfev and status are identical; x, cost and history agree to
    rounding only: a cohort's batched products sum in another order than
    the whole batch's."""
    prob, res = port_fleet
    neq, data = prob.neq_fn(), (prob.uv, prob.mask)
    lock = slm_result_batch(slm_run_batch(
        neq, slm_init_batch(neq, prob.x0, data), data))
    assert (lock.nit, lock.nfev) == (res.nit, res.nfev)
    assert torch.equal(lock.status, res.status)
    assert float(((lock.cost - res.cost).abs() / res.cost).max()) <= 1e-12


# (16 images, Kernel B) and (8 images, Kernel A: 8 pads past 5% at tile 16)
@pytest.mark.parametrize("kernel,n_ims", [("B", 16), ("A", 8)])
@pytest.mark.parametrize("loss,semantics", [("linear", "component"),
                                            ("cauchy", "observation")])
def test_folded_gram_op_equals_per_rig_twin(kernel, n_ims, loss, semantics):
    prob = problems.fleet_problem(4, 2, n_ims, "cpu", grid=4)
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    cam_b = torch.repeat_interleave(prob.x0.cam, n_ims, dim=1)
    im_b = prob.x0.im.repeat(1, 2, 1)
    operands = (cam_b, im_b, prob.uv, prob.mask)
    if kernel == "B":
        def one(c, i, u, m):
            return cg.template_gram_fused(c, i, prob.tpl, u, m, 2, n_ims,
                                          **kw)

        def twin(c, i, u, m):
            return cg.template_gram_fused_plain(c, i, prob.tpl, u, m, 2,
                                                n_ims, **kw)
    else:
        def one(c, i, u, m):
            return (cg.template_gram(c, i, prob.tpl, u, m, **kw),)

        def twin(c, i, u, m):
            return (cg.template_gram_plain(c, i, prob.tpl, u, m, **kw),)
    got = torch.func.vmap(one)(*operands)
    for r in range(4):
        for g, want in zip(got, twin(*(x[r] for x in operands))):
            assert torch.equal(g[r], want)


def test_fleet_runner_gives_the_host_loops_bits(port_fleet):
    prob, res = port_fleet
    runners = {}
    for _ in range(2):          # the second run reloads the same runners
        ran = fleet_solve(prob.neq_fn(), prob.x0, (prob.uv, prob.mask),
                          graph=runners)
        assert (ran.nit, ran.nfev) == (res.nit, res.nfev)
        for a, b in zip([*ran.x, ran.cost, ran.status, ran.history],
                        [*res.x, res.cost, res.status, res.history]):
            assert torch.equal(a, b)
    # one runner per cohort size: R, R/2, R/8 (at least one rig)
    assert sorted(runners) == [1, 3, 6]
    # two solves: each run reads once at entry and once a step; the
    # full batch runs twice a solve (to cap 9, then the polish pass)
    entries = {6: 4, 3: 2, 1: 2}
    for n, runner in runners.items():
        assert runner.reads == runner.steps + entries[n]
        assert runner.graph is None and runner.replays == 0
    # the whole batch steps until cap 9: 8 steps a solve
    assert runners[6].steps >= 2 * 8


def test_unequal_targets_raise(monkeypatch):
    make = problems.make_synthetic_rig

    def moved_target(**kw):
        rig = make(**kw)
        if kw["seed"] == 101:
            rig["template"] = rig["template"] + 1e-3
        return rig

    monkeypatch.setattr(problems, "make_synthetic_rig", moved_target)
    with pytest.raises(ValueError, match="share one calibration target"):
        problems.fleet_problem(3, 2, 4, "cpu", grid=4)
    tpl = np.zeros((2, 8, 3))
    tpl[1, 3] = 1.0
    with pytest.raises(ValueError, match="share one calibration target"):
        fleet_from_numpy([np.zeros((2, 1, 15))] * 3, np.zeros((2, 1, 8, 2)),
                         np.zeros((2, 1, 8)), tpl, "cpu", torch.float64)


def test_folded_op_refuses_a_batched_target():
    prob = problems.fleet_problem(2, 2, 4, "cpu", grid=4)
    cam_b = torch.repeat_interleave(prob.x0.cam, 4, dim=1)
    im_b = prob.x0.im.repeat(1, 2, 1)
    tpls = prob.tpl.expand(2, *prob.tpl.shape)
    with pytest.raises(ValueError, match="share one calibration target"):
        torch.func.vmap(cg.template_gram)(cam_b, im_b, tpls, prob.uv,
                                          prob.mask)


def test_fleet_per_block_family_matches_solo():
    """12 images pad past 5% at tile 16: every evaluation takes Kernel A's
    twin, folded."""
    prob = problems.fleet_problem(3, 2, 12, "cpu", grid=4)
    res = prob.solve()
    for r in range(3):
        solo = prob.solo(r).solve()
        assert _per_rig(res, r) == (solo.nit, solo.nfev, int(solo.status))
        assert _rel(res.cost[r], solo.cost) <= 1e-9


def test_opt_in_route_solves_the_batch_with_the_batched_kernel(
        monkeypatch):
    """A fleet opted in to the SPD kernel (the rule forced here, as on a
    card) solves each batch step's systems through one call of the
    batched op (on the CPU its twin, system by system) under vmap, the
    cascade's cohorts included: per rig the library
    route's nit, nfev and status, the cost within 1e-9, and no system
    missing the residual rule."""
    from pycamset_tpu_torch.ops import cuda_cholesky as cc
    prob = problems.fleet_problem(2, 2, 4, "cpu", grid=4)
    ref = prob.solve()
    calls = []
    op = cc.psd_solve_raw_batched

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return op(*args, **kw)

    from pycamset_tpu_torch.optim import structured_lm as sl
    steps = []
    step = sl.batch_step

    def counted_step(*args, **kw):
        steps.append(1)
        return step(*args, **kw)

    monkeypatch.setattr(ts, "use_cuda_psd", lambda n, dtype, device: True)
    monkeypatch.setattr(cc, "psd_solve_raw_batched", counted)
    monkeypatch.setattr(sl, "batch_step", counted_step)
    misses = int(cc.batch_misses("cpu"))
    got = prob.solve()
    assert len(calls) == len(steps) >= max(ref.nit)
    assert (got.nit, got.nfev) == (ref.nit, ref.nfev)
    assert torch.equal(got.status, ref.status)
    assert float((got.cost - ref.cost).abs().max()) <= 1e-9 * float(
        ref.cost.max())
    assert int(cc.batch_misses("cpu")) == misses


@pytest.mark.parametrize("make,args", [
    (problems.standard_problem, (3, 5)), (problems.selfcal_problem, (3, 5)),
    (problems.mixed_problem, (3, 5)), (problems.grouped_problem, (3, 5)),
    (problems.fleet_problem, (2, 3, 5))])
def test_entry_points_default_to_the_card(make, args):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        make(*args, grid=4)
