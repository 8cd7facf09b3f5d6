"""Port parity: the handler paths with the matrix-free CG reduced solver.

The JAX package's own handlers (``tests/test_fleet.py``'s template rig,
3 cameras x 6 images, grid 5, seed 5, and self-calibration rig, seed 29;
``tests/test_torch_freepoint.py``'s wand) carried to the port as numpy,
``{"reduced_solver": "cg"}`` on both, float64 on the CPU:

- ``run_bundle_adjustment``: the same nit, nfev and status, the cost within
  1e-9 relative, x within 1e-8 of its scale, the cameras within 1e-6 of
  each piece's (each CG step stops at a residual of 1e-6, so the weakly
  determined distortion coefficients carry the inputs' last bits further
  than the dense route's 1e-8);
- ``build_structured_problem`` takes "cg" as named and "auto" by the JAX
  rule, and a CG solve makes no dense solve;
- the CG fleet (``run_fleet_bundle_adjustment``, two template rigs) against
  the JAX fleet rig by rig, to the same bars.
"""
import numpy as np
import pytest
import torch

from pycamset_tpu.optim.driver import run_bundle_adjustment as jax_rba
from pycamset_tpu.optim.fleet import run_fleet_bundle_adjustment as jax_fleet
from pycamset_tpu_torch import problems
from pycamset_tpu_torch.optim import structured as ts
from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
from pycamset_tpu_torch.optim.fleet import run_fleet_bundle_adjustment
from test_fleet import _selfcal_handler, _template_handler
from test_torch_fleet_handlers import _jax_handler, _port_handler
from test_torch_freepoint import _jax_wand_handler, _port_of

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)


def _rel(got, ref):
    got, ref = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)


def _assert_same(jres, jcams, pres, pcams):
    assert (pres.nit, pres.nfev, pres.status) == (jres.nit, jres.nfev,
                                                  jres.status)
    assert pres.status in (1, 2, 3)
    assert abs(pres.cost - jres.cost) <= 1e-9 * jres.cost
    assert _rel(pres.x, jres.x) <= 1e-8
    for cj, cp in zip(jcams, pcams):
        assert cj.name == cp.name
        for attr in ("intrinsic", "distortion_coefs", "extrinsic"):
            assert _rel(getattr(cp, attr), getattr(cj, attr)) <= 1e-6


def _carry_over(chain):
    """A JAX handler of the chain and its port twin, {"reduced_solver":
    "cg"} on both (the start: each package's own PnP, or the JAX one)."""
    opts = {"reduced_solver": "cg"}
    if chain == "freepoint":
        jh, pin = _jax_wand_handler(opts)
        port = _port_of(jh, pin, opts)
        port.set_initial_params(np.array(jh.get_initial_params()))
        return jh, port
    if chain == "template":
        jh = _template_handler(n_cams=3, n_ims=6, grid=5, seed=5,
                               options=opts)[0]
    else:
        jh = _selfcal_handler(seed=29, **opts)[0]
    return jh, _port_handler(jh, chain, opts)


@pytest.mark.parametrize("chain", ["template", "selfcal", "freepoint"])
def test_user_path_with_cg_matches_jax(chain):
    jh, port = _carry_over(chain)
    jres, jcams = jax_rba(jh, backend="structured")
    _assert_same(jres, jcams, *run_bundle_adjustment(
        port, backend="structured", device="cpu"))


def test_user_path_takes_cg_where_the_rule_says():
    """build_structured_problem: "auto" resolves by the JAX rule, an
    explicit "cg" is taken, and the solve goes through no dense solve."""
    from pycamset_tpu_torch.optim.structured_driver import (
        build_structured_problem)
    handler, _ = problems.template_handler(3, 5, grid=6,
                                           options={"reduced_solver": "cg"})
    solve_fn, _, x0 = build_structured_problem(handler, device="cpu")
    assert solve_fn.problem.reduced_solver == "cg"
    calls = []
    real = ts._psd_solve
    ts._psd_solve = lambda *a: calls.append(1) or real(*a)
    try:
        _, res = solve_fn(x0)
    finally:
        ts._psd_solve = real
    assert calls == [] and int(res.status) in (1, 2, 3)
    handler, _ = problems.template_handler(3, 5, grid=6)
    assert build_structured_problem(
        handler, device="cpu")[0].problem.reduced_solver == "dense"


def test_cg_fleet_matches_jax_rig_by_rig():
    opts = {"reduced_solver": "cg"}
    jhs = [_jax_handler("template", s, options=opts) for s in (5, 6)]
    phs = [_port_handler(jh, "template", opts) for jh in jhs]
    (jr, jc), (pr, pc) = jax_fleet(jhs), run_fleet_bundle_adjustment(
        phs, device="cpu")
    assert len(jr) == len(pr) == 2
    for r in range(2):
        _assert_same(jr[r], jc[r], pr[r], pc[r])


def test_fleet_step_runners_are_kept_per_reduced_solver():
    """A fleet copied with another reduced solver shares the ``graphs``
    dict but gets step runners of its own, and both copies solve through
    them (uncaptured here)."""
    import dataclasses

    from pycamset_tpu_torch.optim.fleet import (build_fleet_problem,
                                                fleet_solve)
    dense = build_fleet_problem(
        problems.fleet_handlers("template", 2, 3, 5, grid=6), device="cpu")
    cg = dataclasses.replace(dense, reduced_solver="cg")
    assert dense.reduced_solver == "dense" and cg.graphs is dense.graphs
    assert dense.graph() is dense.graph() and cg.graph() is not dense.graph()
    for prob in (dense, cg):
        res = fleet_solve(prob.neq_fn(), prob.x0_pieces, prob.data(),
                          max_nfev=prob.max_nfev,
                          reduced_solver=prob.reduced_solver, ops=prob.ops,
                          graph=prob.graph())
        assert all(s in (1, 2) for s in res.status.tolist())
