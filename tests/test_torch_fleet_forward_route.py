"""Port parity: handler fleets of the forward-mode route's chains.

A chain that no closed form serves takes the structured backend's
forward-mode route (``structured.make_block_grams``: one
``torch.func.jvp`` a parameter, vmapped over a group's directions); in a
fleet it runs under a second ``torch.func.vmap``, over the rigs. Float64
on the CPU:

- the skew chain (``problems.skew_block`` in front of the template chain,
  ``problems.with_skew``) on three rigs of ``tests/test_fleet.py::
  _template_handler`` (3 cameras x 4 images, grid 5, seeds 5-7) in both
  packages' fleets (the JAX package's ``jacfwd`` route): per rig the same
  nit, nfev and status, the cost and x within 1e-9 of their scale;
- the heterogeneous grouped and mixed multi-target chains
  (``problems.multi_target_fleet``: two rigs of ``grouped_problem`` /
  ``mixed_problem`` with a fisheye / standard map a rig; both packages'
  two-target example handlers refuse maps, so these are held rig by rig
  against the port's one-rig solve, itself held to the JAX package's
  normal equations in ``tests/test_torch_forward_route.py``): the same
  nit, nfev and status, the cost within 1e-9;
- the route's normal equations under the fleet's vmap equal each rig's
  own call, and ``residuals._jacobian_columns`` under an outer vmap each
  row's own (the primal rides the direction axis);
- the refusals of both packages: a skew rig beside a plain one
  (``FleetMismatch``) and a rolling-shutter fleet (``UnsupportedChain``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycamset_tpu.optim import blocks as jb
from pycamset_tpu.optim.fleet import FleetMismatch as JFleetMismatch
from pycamset_tpu.optim.fleet import build_fleet_problem as jax_build
from pycamset_tpu.optim.fleet import run_fleet_bundle_adjustment as jax_fleet
from pycamset_tpu.optim.structured import UnsupportedChain as JUnsupported
from pycamset_tpu_torch import problems
from pycamset_tpu_torch.optim import structured as ts
from pycamset_tpu_torch.optim.fleet import (FleetMismatch,
                                            build_fleet_problem,
                                            run_fleet_bundle_adjustment)
from pycamset_tpu_torch.optim.residuals import _jacobian_columns
from test_fleet import _template_handler
from test_torch_fleet_handlers import _port_handler
from test_torch_rolling_shutter import _capture, _pair

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)

SKEW_SEEDS = (5, 6, 7)
HET_MAPS = [["fisheye", "standard", "fisheye"],
            ["standard", "fisheye", "standard"]]


def _plain_pair(seed):
    """The JAX test rig's template handler (PnP-seeded), its start, and
    the port's handler of the same data."""
    jhandler, _ = _template_handler(n_cams=3, n_ims=4, grid=5, seed=seed,
                                    options={"verbosity": 0})
    x0 = np.array(jhandler.get_initial_params())
    port = _port_handler(jhandler, "template", options={"verbosity": 0})
    port.missing_poses = jhandler.missing_poses
    return jhandler, port, x0


def _skew_pairs(seeds=SKEW_SEEDS):
    jhs, phs = [], []
    for seed in seeds:
        jhandler, port, x0 = _plain_pair(seed)
        jhs.append(problems.with_skew(jhandler, x0, jb, jnp))
        phs.append(problems.with_skew(port, x0))
    return jhs, phs


def test_skew_fleet_matches_jax():
    jhs, phs = _skew_pairs()
    prob = build_fleet_problem(phs, device="cpu")
    # the route a chain of the caller's own takes: no closed form
    assert ts.chain_family(prob.op_fun, prob.widths) is None
    (jr, _), (pr, pc) = jax_fleet(jhs), run_fleet_bundle_adjustment(
        phs, device="cpu")
    for j, p in zip(jr, pr):
        assert (p.nit, p.nfev, p.status) == (j.nit, j.nfev, j.status)
        assert p.status in (1, 2)
        assert abs(p.cost - j.cost) <= 1e-9 * j.cost
        assert np.abs(p.x - j.x).max() <= 1e-9 * np.abs(j.x).max()
    # each rig's skew is its own and its cameras keep the standard width
    skews = [p.x[:3] for p in pr]
    assert not np.allclose(skews[0], skews[1])
    assert all(np.ravel(c.distortion_coefs).size == 5 for cams in pc
               for c in cams)


@pytest.mark.parametrize("mixed", [False, True], ids=["grouped", "mixed"])
def test_het_multi_target_fleet_rigs_equal_their_solves_alone(mixed):
    fleet = problems.multi_target_fleet(mixed, 2, 3, 4, "cpu", grid=5,
                                        camera_model=HET_MAPS)
    p0 = fleet.rigs[0]
    assert ts.is_het_chain(p0.op_fun)
    res = fleet.solve()
    for r in range(fleet.n_rigs):
        alone = fleet.solo(r).solve()
        assert (res.nit[r], res.nfev[r], int(res.status[r])) == (
            int(alone.nit), int(alone.nfev), int(alone.status))
        assert abs(float(res.cost[r]) - float(alone.cost)) <= (
            1e-9 * float(alone.cost))
    assert all(s in (1, 2) for s in res.status.tolist())
    assert float(fleet.rms_px(res.cost).max()) <= 0.36


def test_route_under_the_fleet_vmap_equals_each_rigs_call():
    """The skew fleet's one-rig normal equations (the forward-mode route)
    under ``torch.func.vmap`` over three rigs, at starts with the skews
    moved off zero: each rig's pieces equal its own call's."""
    prob = build_fleet_problem(problems.skew_fleet_handlers(3, 3, 4, grid=5),
                               device="cpu")
    x0 = prob.x0_pieces
    cam = x0.cam.clone()
    cam[..., 0] = 1e-3 * torch.arange(1.0, 4.0, dtype=cam.dtype)[:, None]
    x0 = type(x0)(cam, *x0[1:])
    neq = prob.neq_fn()
    got = torch.func.vmap(neq)(x0, *prob.data())
    for r in range(3):
        one = neq(type(x0)(*(t[r] for t in x0)), *(d[r] for d in prob.data()))
        for a, b in zip(got, one):
            assert torch.allclose(a[r], b, rtol=1e-12, atol=1e-12)


def test_jacobian_columns_under_an_outer_vmap():
    """One jvp a direction, vmapped over the directions, inside a vmap
    over rows: each row's value and Jacobian are its own call's, and the
    Jacobian the analytic one."""
    w = torch.tensor([[0.5, -1.0, 2.0], [1.5, 0.25, -0.75]],
                     dtype=torch.float64)

    def fn(x):
        return torch.stack((x[..., 0] * x[..., 1] + torch.sin(x[..., 2]),
                            x[..., 2] ** 2), -1)

    r, jac = torch.func.vmap(lambda x: _jacobian_columns(fn, x))(w)
    for k in range(2):
        r1, j1 = _jacobian_columns(fn, w[k])
        assert torch.equal(r[k], r1) and torch.equal(jac[k], j1)
        x0, x1, x2 = w[k]
        want = torch.tensor([[x1, x0, torch.cos(x2)], [0.0, 0.0, 2 * x2]],
                            dtype=torch.float64)
        assert torch.allclose(jac[k], want, rtol=1e-14, atol=1e-14)


def test_a_skew_rig_beside_a_plain_rig_raises_as_jax():
    jhs, phs = _skew_pairs(SKEW_SEEDS[:1])
    jplain, pplain, _ = _plain_pair(SKEW_SEEDS[1])
    with pytest.raises(JFleetMismatch, match="chain"):
        jax_build([jhs[0], jplain])
    with pytest.raises(FleetMismatch, match="chain"):
        build_fleet_problem([phs[0], pplain], device="cpu")


def test_rolling_shutter_fleet_raises_as_jax():
    cams, tpl, dd, _, _ = _capture(4, 0.3, 3)
    jhandler, port = _pair(cams, tpl, dd)
    with pytest.raises(JUnsupported) as ref:
        jax_build([jhandler, jhandler])
    with pytest.raises(ts.UnsupportedChain) as got:
        build_fleet_problem([port, port], device="cpu")
    assert str(got.value) == str(ref.value)
    assert "item 7" not in str(got.value)
