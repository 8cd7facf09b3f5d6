"""Port parity: the multi-target handlers through ``run_bundle_adjustment``.

The JAX package's two-target rigs (``tests/test_fleet.py::
_grouped_handler``, seed 11, and ``_mixed_handler``, seed 17: 3 cameras x
6 images, grid 4, the second target moved by a known relative pose) are
carried to the port as numpy and solved by both packages in float64 on the
CPU, through the port's copies of ``TwoTargetCalibrator`` (the grouped
chain: ``build_structured_problem`` with a key->group map) and
``TwoTargetSelfCalibrator`` (the mixed chain: ``build_mixed_structured_
problem``, tried when the structured builder declines the chain), each
seeded by its own PnP (the relative pose averaged over the images):

- the start bit for bit; the same nit, nfev and status, the cost within
  1e-9 relative, x within 1e-8 of its scale, the residuals and the cameras
  within 1e-8 of theirs; the recovered relative pose and the targets;
- the key->group checks the JAX package makes (``UnsupportedChain``
  without groups, ``ValueError`` for an index out of range), and
  ``run_bundle_adjustment`` on a handler that counts no groups doing what
  the JAX package does (the grouped chain its ValueError, the mixed one
  the generic backend's solve);
- the mixed problem's LM step runner (a CUDA graph on a card) run
  uncaptured gives the host loop's bits; ``problems.multi_target_handler``
  (grouped) solves ``problems.grouped_problem``'s problem; a calibrated
  CameraSet of a multi-target handler written and loaded back.
"""
import logging

import numpy as np
import pytest
import torch

from pycamset_tpu.optim.driver import run_bundle_adjustment as jax_rba
from pycamset_tpu_torch import problems
from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
from pycamset_tpu_torch.optim.structured import UnsupportedChain
from pycamset_tpu_torch.optim.structured_driver import (
    build_mixed_structured_problem, build_structured_problem)
from pycamset_tpu_torch.optim.structured_lm import (SLMGraph,
                                                    structured_lm_solve)
from pycamset_tpu_torch.utils.saving import load_CameraSet
from test_fleet import _grouped_handler, _mixed_handler
from test_torch_fleet_handlers import _port_handler

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)

MAKE = {"grouped": (_grouped_handler, 11), "mixed": (_mixed_handler, 17)}


@pytest.fixture(scope="module", params=list(MAKE))
def solved(request):
    chain = request.param
    make, seed = MAKE[chain]
    jh = make(seed=seed)
    port = _port_handler(jh, chain)
    x_jax, x_port = jh.get_initial_params(), port.get_initial_params()
    jax_res, jax_cams = jax_rba(jh, backend="structured")
    port_res, port_cams = run_bundle_adjustment(port, device="cpu")
    return dict(chain=chain, jh=jh, port=port, x_jax=x_jax, x_port=x_port,
                jax=(jax_res, jax_cams), got=(port_res, port_cams))


def test_the_same_start(solved):
    assert np.array_equal(solved["x_jax"], solved["x_port"])


def test_the_same_solve(solved):
    (j, _), (p, _) = solved["jax"], solved["got"]
    assert (p.nit, p.nfev, p.status) == (j.nit, j.nfev, j.status)
    assert abs(p.cost - j.cost) <= 1e-9 * j.cost
    for name in ("x", "fun"):
        ref = np.asarray(j[name])
        assert np.abs(np.asarray(p[name]) - ref).max() <= (
            1e-8 * np.abs(ref).max())


def test_the_same_cameras(solved):
    for a, b in zip(solved["jax"][1], solved["got"][1]):
        assert a.name == b.name
        for attr in ("intrinsic", "distortion_coefs", "extrinsic"):
            ref = np.asarray(getattr(a, attr), dtype=float)
            got = np.asarray(getattr(b, attr), dtype=float)
            assert np.abs(got - ref).max() <= 1e-8 * max(np.abs(ref).max(),
                                                         1e-12)


def test_the_same_relative_pose_and_targets(solved):
    jh, port = solved["jh"], solved["port"]
    (j, _), (p, _) = solved["jax"], solved["got"]
    ref = jh.get_relative_pose(j.x)
    assert np.abs(port.get_relative_pose(p.x) - ref).max() <= 1e-8
    if solved["chain"] == "mixed":
        for a, b in zip(jh.get_updated_targets(j.x),
                        port.get_updated_targets(p.x)):
            assert np.abs(b - a).max() <= 1e-8 * np.abs(a).max()


@pytest.mark.parametrize("chain", list(MAKE))
@pytest.mark.parametrize("fault,error", [("no groups", UnsupportedChain),
                                         ("out of range", ValueError)])
def test_group_checks(chain, fault, error):
    make, seed = MAKE[chain]
    jh = make(seed=seed)
    port = _port_handler(jh, chain)
    if fault == "no groups":
        port.n_groups = lambda: 0
    else:
        gok = port.group_of_key()
        port.group_of_key = lambda: gok + 1
    build = (build_structured_problem if chain == "grouped"
             else build_mixed_structured_problem)
    with pytest.raises(error, match="group_of_key"):
        build(port, device="cpu")
    if fault == "no groups":
        # "auto" then does what the JAX package does with a handler that
        # counts no groups: the grouped chain raises the JAX package's
        # ValueError; the mixed chain falls back to the generic backend,
        # whose group rows alias the points, as in the JAX package (held
        # at a budget of 6 evaluations)
        jh.n_groups = lambda: 0
        for h in (jh, port):
            h.problem_opts["max_nfev"] = 6
        port.set_initial_params(np.array(jh.get_initial_params()))
        if chain == "grouped":
            with pytest.raises(ValueError) as ref:
                jax_rba(jh)
            with pytest.raises(ValueError) as got:
                run_bundle_adjustment(port, device="cpu")
            assert str(got.value) == str(ref.value)
            return
        ref, _ = jax_rba(jh)
        got, _ = run_bundle_adjustment(port, device="cpu")
        assert (got.nit, got.nfev, got.status) == (ref.nit, ref.nfev,
                                                   ref.status)
        assert abs(got.cost - ref.cost) <= 1e-9 * ref.cost


def test_mixed_step_runner_gives_the_host_loops_bits():
    handler, _ = problems.multi_target_handler(3, 6, True, grid=5)
    solve_fn, _, x0 = build_mixed_structured_problem(handler, device="cpu")
    prob = solve_fn.problem
    ref = prob.solve()
    runner = SLMGraph()
    got = structured_lm_solve(prob.neq_fn(), prob.x0, ops=prob.ops(),
                              max_nfev=prob.max_nfev, graph=runner)
    assert (got.nit, got.nfev) == (ref.nit, ref.nfev)
    assert runner.steps == ref.nit and int(ref.status) in (1, 2)
    for a, b in zip([*got.x, got.cost, got.history],
                    [*ref.x, ref.cost, ref.history]):
        assert torch.equal(a, b)


def test_grouped_handler_solves_the_grouped_problem():
    """At 8 images (no bucket padding) the grouped handler's problem is
    ``problems.grouped_problem``'s: the same start, gauge and data."""
    handler, _ = problems.multi_target_handler(3, 8, False, grid=5)
    solve_fn, _, _ = build_structured_problem(handler, device="cpu")
    got = solve_fn.problem.solve()
    ref = problems.grouped_problem(3, 8, "cpu", grid=5).solve()
    assert (got.nit, got.nfev, int(got.status)) == (ref.nit, ref.nfev,
                                                    int(ref.status))
    assert abs(float(got.cost) - float(ref.cost)) <= 1e-12 * float(ref.cost)


def test_multi_target_camset_written_and_loaded(tmp_path, caplog):
    """A calibrated CameraSet of the two-target handler writes; it loads
    back as its cameras (its handler takes two targets, which the file's
    one-target record cannot rebuild: the JAX package loads it bare too)."""
    handler, _ = problems.multi_target_handler(3, 6, True, grid=5)
    res, cams = run_bundle_adjustment(handler, device="cpu")
    assert res.status in (1, 2)
    cams.save(tmp_path / "two.camset")
    with caplog.at_level(logging.WARNING):
        back = load_CameraSet(tmp_path / "two.camset")
    assert back == cams


@pytest.mark.parametrize("mixed", [True, False])
def test_multi_target_entry_points_default_to_the_card(mixed):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    handler, _ = problems.multi_target_handler(2, 4, mixed, grid=4)
    build = (build_mixed_structured_problem if mixed
             else build_structured_problem)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        build(handler)
