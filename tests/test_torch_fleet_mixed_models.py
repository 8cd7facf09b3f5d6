"""Port parity: handler fleets of mixed-model rigs (per-camera
``camera_model`` maps).

Both packages' fleets (``run_fleet_bundle_adjustment``) in float64 on the
CPU, each package's handlers built from the same data (the JAX package's
``make_synthetic_rig`` rig as its CameraSet and TargetDetection, carried
over as numpy, ``tests/test_torch_het_rig.py``), the port started at the
JAX package's start:

- Brown rigs of several widths whose maps differ from rig to rig,
  (rational, standard, rational) and (standard, rational, rational), on
  the template and self-calibration chains at a budget of ``BUDGET``
  evaluations (the rational valley is flat: there the two packages'
  float64 roundings grow apart, ROADMAP Queue C 6), and as wand rigs
  (the pose-free free-point chain, lenses fixed);
- heterogeneous rigs (fisheye beside Brown cameras, ``ProjectionHet``)
  with maps (F, S, F, S) and (S, S, F, F), template and self-calibration;

per rig the same nit, nfev and status, the cost within 1e-9 relative, x
within 1e-9 of its scale, and each camera at its own model's distortion
width. The Brown fleets' x is held to ``BROWN_X_TOL`` of its scale: at the
budget their rational coefficients part by up to 2.1e-8 of it while the
costs agree to 1e-9, and the JAX package's own fleet and one-rig solves
of these rigs part by 1.7e-8. Each rig's ``.camset`` loads in both
packages. Also: the refusals of both packages (a het rig beside a
uniform one and rigs of different widest Brown models: ``FleetMismatch``;
``shared_intrinsics`` with a map: ``UnsupportedChain``; the port's sharded
fleet naming its ROADMAP item); each rig's pinned columns exact zeros in
its gradient and camera gram rows under the fleet's vmap;
``problems.fleet_handlers`` with per-rig maps; and the cascade (which the
port runs at every fleet size, the JAX package from 16 rigs) on 16 het
rigs, each rig equal to its solve alone.
"""
import numpy as np
import pytest
import torch

from pycamset_tpu.models.camera_set import CameraSet as JCameraSet
from pycamset_tpu.models.camera_set import make_cam_dict
from pycamset_tpu.models.detections import TargetDetection as JDetection
from pycamset_tpu.optim import handlers as jh
from pycamset_tpu.optim.fleet import FleetMismatch as JFleetMismatch
from pycamset_tpu.optim.fleet import build_fleet_problem as jax_build
from pycamset_tpu.optim.fleet import run_fleet_bundle_adjustment as jax_fleet
from pycamset_tpu.optim.structured import UnsupportedChain as JUnsupported
from pycamset_tpu.utils.general_utils import make_4x4h_tform
from pycamset_tpu.utils.saving import load_CameraSet as jax_load
from pycamset_tpu.utils.synthetic import make_synthetic_rig
from pycamset_tpu_torch import problems
from pycamset_tpu_torch.optim import handlers as ph
from pycamset_tpu_torch.optim.fleet import (FleetMismatch,
                                            build_fleet_problem,
                                            run_fleet_bundle_adjustment)
from pycamset_tpu_torch.optim.structured import UnsupportedChain
from pycamset_tpu_torch.utils.saving import load_CameraSet
from test_torch_freepoint import _port_of
from test_torch_het_rig import DIST_W, _jax_rig, _port

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)

BROWN = (("rational", "standard", "rational"),
         ("standard", "rational", "rational"))
HET = (("fisheye", "standard", "fisheye", "standard"),
       ("standard", "standard", "fisheye", "fisheye"))
# the Brown fleets' budget and their x tolerance (module docstring)
BUDGET = 12
BROWN_X_TOL = 5e-8
CLS = {"template": (jh.TemplateBundleHandler, ph.TemplateBundleHandler),
       "selfcal": (jh.SelfBundleHandler, ph.SelfBundleHandler)}


def _pairs(maps, chain, seeds=(11, 13), options=None):
    """Each package's handler of rig r (map ``maps[r]``, seed
    ``seeds[r]``, 6 images, grid 6), the port's at the JAX start."""
    jcls, pcls = CLS[chain]
    jhs, phs = [], []
    for models, seed in zip(maps, seeds):
        jhandler, _ = _jax_rig(models, seed=seed, n_ims=6, grid=6, cls=jcls,
                               options=options)
        port = _port(jhandler, pcls)
        port.set_initial_params(np.asarray(jhandler.get_initial_params()))
        jhs.append(jhandler)
        phs.append(port)
    return jhs, phs


def _assert_same_fleets(jax_out, port_out, maps, x_tol=1e-9):
    """Per rig: nit, nfev and status; the cost within 1e-9 relative and x
    within ``x_tol`` of its scale; every camera at its own model's
    distortion width in both packages."""
    (jr, jc), (pr, pc) = jax_out, port_out
    assert len(jr) == len(pr) == len(maps)
    for j, p in zip(jr, pr):
        assert (p.nit, p.nfev, p.status) == (j.nit, j.nfev, j.status)
        assert abs(p.cost - j.cost) <= 1e-9 * j.cost
        assert p.x.shape == j.x.shape
        assert np.abs(p.x - j.x).max() <= x_tol * np.abs(j.x).max()
    for cj, cp, models in zip(jc, pc, maps):
        want = [DIST_W[m] for m in models]
        assert [np.ravel(c.distortion_coefs).size for c in cp] == want
        assert [np.ravel(c.distortion_coefs).size for c in cj] == want


def _assert_files_both_ways(camsets, maps, het, tmp_path):
    """Each rig's ``.camset`` loads in both packages with the same
    cameras, each at its own model's width, and the same map."""
    for r, (cams, models) in enumerate(zip(camsets, maps)):
        path = tmp_path / f"rig{r}.camset"
        cams.save(path)
        a, b = load_CameraSet(path), jax_load(path)
        assert a.get_names() == b.get_names() == cams.get_names()
        for ca, cb, m in zip(a, b, models):
            assert np.ravel(ca.distortion_coefs).size == DIST_W[m]
            for attr in ("intrinsic", "distortion_coefs", "extrinsic"):
                assert np.array_equal(np.asarray(getattr(ca, attr)),
                                      np.asarray(getattr(cb, attr))), attr
        assert (a.calibration_handler.camera_models
                == b.calibration_handler.camera_models == list(models))
        assert a.calibration_handler.is_het == het
        assert np.array_equal(a.calibration_params, b.calibration_params)


@pytest.mark.parametrize("chain", ["template", "selfcal"])
def test_brown_fleet_of_per_rig_maps_matches_jax(chain, tmp_path):
    jhs, phs = _pairs(BROWN, chain, options={"max_nfev": BUDGET})
    port_out = run_fleet_bundle_adjustment(phs, device="cpu")
    _assert_same_fleets(jax_fleet(jhs), port_out, BROWN,
                        x_tol=BROWN_X_TOL)
    _assert_files_both_ways(port_out[1], BROWN, False, tmp_path)


@pytest.mark.parametrize("chain", ["template", "selfcal"])
def test_het_fleet_of_per_rig_maps_matches_jax(chain, tmp_path):
    jhs, phs = _pairs(HET, chain)
    port_out = run_fleet_bundle_adjustment(phs, device="cpu")
    _assert_same_fleets(jax_fleet(jhs), port_out, HET)
    assert all(r.status in (1, 2) for r in port_out[0])
    _assert_files_both_ways(port_out[1], HET, True, tmp_path)


def _jax_wand(models, seed):
    """``test_torch_fleet_freepoint._jax_wand``'s wand rig (3 cameras,
    one image of a 7 x 7 grid, every lens fixed, camera 0 at the origin,
    the largest coordinate pinned) with one camera model a camera, each
    camera's true distortion at its model's width."""
    rig = make_synthetic_rig(n_cams=3, n_ims=1, grid=7, visibility=1.0,
                             noise_px=0.1, seed=seed,
                             camera_model=list(models))
    names = ["a", "b", "c"]
    exts = [make_4x4h_tform(e[:3], e[3:]) for e in rig["extr"]]
    exts[0] = np.eye(4)
    kmats = [np.array([[i9[0], 0, i9[1]], [0, i9[2], i9[3]], [0, 0, 1]])
             for i9 in rig["intr"]]
    dists = [i9[4:4 + DIST_W[m]] for i9, m in zip(rig["intr"], models)]
    cams = JCameraSet(camera_dict=make_cam_dict(names, exts, kmats, dists,
                                                [[1600, 1200]] * 3))
    world = rig["template"] + [0.0, 0.0, 1.0]
    dd = rig["dd"].copy()
    for c in range(3):
        rows = dd[:, 0] == c
        dd[rows, 3:5] = cams[c].project_points(world[dd[rows, 2].astype(int)])
    dd[:, 3:5] += np.random.default_rng(seed + 2).normal(
        size=(len(dd), 2)) * 0.2
    pts0 = world + np.random.default_rng(seed + 1).normal(
        size=world.shape) * 1e-3
    start = [e @ make_4x4h_tform(d[:3], d[3:]) for e, d in zip(
        exts, np.random.default_rng(seed + 5).normal(size=(3, 6)) * 1e-2)]
    start[0] = np.eye(4)
    for name, e in zip(names, start):
        cams[name].extrinsic = e
        cams[name]._update_state()
    fixed = {n: {"int": np.asarray(cams[n].intrinsic, dtype=float),
                 "dst": np.ravel(cams[n].distortion_coefs)} for n in names}
    fixed[names[0]]["ext"] = np.eye(4)
    options = {"camera_model": dict(zip(names, models))}
    handler = jh.FreePointBundleHandler(
        cams, jh.FreePointTarget(pts0.reshape(1, -1, 3)),
        JDetection(cam_names=names, data=dd), fixed_params=fixed,
        options={"outliers": "n", "verbosity": 0, **options})
    pin = int(np.argmax(np.abs(pts0.reshape(-1))))
    handler.feat_unfixed[pin] = False
    handler.bundlePrimitive.calc_free_poses()
    return handler, pin, options


def test_brown_wand_fleet_of_per_rig_maps_matches_jax():
    """The JAX fleet takes the pose-free chain with maps: so does the
    port's (lenses fixed, so the pinned extra coefficients sit among the
    fixed columns)."""
    jhs, phs = [], []
    for models, seed in zip(BROWN, (31, 37)):
        jhandler, pin, options = _jax_wand(models, seed)
        port = _port_of(jhandler, pin, options)
        port.set_initial_params(np.array(jhandler.get_initial_params()))
        jhs.append(jhandler)
        phs.append(port)
    port_out = run_fleet_bundle_adjustment(phs, device="cpu")
    _assert_same_fleets(jax_fleet(jhs), port_out, BROWN, x_tol=BROWN_X_TOL)
    assert all(r.status in (1, 2) for r in port_out[0])


def _uniform(n_cams, model, cls=CLS["template"]):
    jhandler, _ = _jax_rig((model,) * n_cams, seed=17, n_ims=4, grid=5,
                           cls=cls[0])
    return jhandler, _port(jhandler, cls[1])


@pytest.mark.parametrize("case", ["het_beside_uniform",
                                  "rational_beside_thin_prism",
                                  "tied_with_map"])
def test_refusals_as_jax(case):
    """Each package raises its own exception of the same kind on the same
    handlers."""
    if case == "tied_with_map":
        opts = {"shared_intrinsics": True}
        pairs = [_jax_rig(m, seed=s, n_ims=4, grid=5, options=opts)[0]
                 for m, s in zip(BROWN, (11, 13))]
        jhs, phs = pairs, [_port(h) for h in pairs]
        want = (JUnsupported, UnsupportedChain)
    else:
        models = (HET[0] if case == "het_beside_uniform"
                  else ("thin_prism", "standard", "standard", "standard"))
        other = "standard" if case == "het_beside_uniform" else "rational"
        jhandler, _ = _jax_rig(models, seed=11, n_ims=4, grid=5)
        j1, p1 = _uniform(4, other)
        jhs, phs = [jhandler, j1], [_port(jhandler), p1]
        want = (JFleetMismatch, FleetMismatch)
    with pytest.raises(want[0]):
        jax_build(jhs)
    with pytest.raises(want[1]) as got:
        build_fleet_problem(phs, device="cpu")
    assert type(got.value) is want[1]
    assert "item 7" not in str(got.value)


def test_sharded_mixed_model_fleet_names_its_item():
    phs = problems.fleet_handlers("template", 2, 3, 4, grid=5,
                                  camera_model=[list(m) for m in BROWN])
    with pytest.raises(NotImplementedError, match="Queue A item 11"):
        build_fleet_problem(phs, device="cpu", mesh=object())


@pytest.mark.parametrize("chain", ["template", "selfcal", "freepoint"])
@pytest.mark.parametrize("kind", ["brown", "het"])
def test_each_rigs_pinned_columns_are_zero_under_the_fleet_vmap(chain,
                                                                kind):
    """``problems.fleet_handlers`` with a different map a rig: the fleet's
    one-rig normal equations under ``torch.func.vmap`` at the starts give
    every rig's pinned camera columns (its narrower Brown cameras' extra
    coefficients; the selector and a fisheye camera's pad slots) exact
    zeros in its gradient and its camera gram rows, and each rig's
    normal equations equal those of its own call."""
    maps = ([["standard", "rational", "thin_prism"],
             ["thin_prism", "standard", "rational"],
             ["rational", "thin_prism", "standard"]] if kind == "brown" else
            [["fisheye", "standard", "fisheye"],
             ["standard", "fisheye", "fisheye"],
             ["fisheye", "fisheye", "standard"]])
    n_ims = 2 if chain == "freepoint" else 4
    prob = build_fleet_problem(problems.fleet_handlers(
        chain, 3, 3, n_ims, grid=5, camera_model=maps), device="cpu")
    assert prob.widths.a == (22 if kind == "brown" else 16)
    neq = prob.neq_fn()
    got = torch.func.vmap(neq)(prob.x0_pieces, *prob.data())
    pinned = prob.colmask.cam == 0
    for r in range(3):
        assert pinned[r].any()
        gc, hcc = got.gc[r], got.hcc[r]
        assert torch.all(gc[pinned[r]] == 0)
        rows = hcc[pinned[r]]            # (n pinned, a): whole rows
        assert torch.all(rows == 0)
        one = neq(*(type(p)(*(t[r] for t in p)) if i == 0 else p[r]
                    for i, p in enumerate((prob.x0_pieces, *prob.data()))))
        for a, b in zip(got, one):
            assert torch.allclose(a[r], b, rtol=1e-12, atol=1e-12)
    # the rigs' maps differ, so do their pinned columns (a wand fixes
    # every lens: all its intrinsic columns are pinned)
    assert torch.equal(pinned[0], pinned[1]) == (chain == "freepoint")


def test_fleet_handlers_take_one_map_a_rig():
    maps = [["fisheye", "standard", "fisheye"],
            ["standard", "fisheye", "fisheye"]]
    hs = problems.fleet_handlers("template", 2, 3, 4, grid=5,
                                 camera_model=maps)
    for h, models in zip(hs, maps):
        assert h.camera_models == models and h.is_het
        assert [np.ravel(c.distortion_coefs).size for c in h.camset] == [
            DIST_W[m] for m in models]
    one = problems.fleet_handlers("template", 2, 3, 4, grid=5,
                                  camera_model=maps[0])
    assert all(h.camera_models == maps[0] for h in one)


def test_cascade_gives_each_het_rig_its_solve_alone():
    """16 het rigs of 2 cameras x 4 images, grid 6 (the JAX package's
    cascade threshold) at a budget of 30 evaluations: the cascade pauses the
    least-converged rigs at 9 and 13 evaluations and resumes them, and
    every rig ends as it does solved alone (``solo(r)``): the same nit,
    nfev and status, the cost within 1e-9."""
    maps = [["fisheye", "standard"] if r % 2 else ["standard", "fisheye"]
            for r in range(16)]
    prob = build_fleet_problem(problems.fleet_handlers(
        "template", 16, 2, 4, grid=6, options={"max_nfev": 30},
        camera_model=maps), device="cpu")
    res = prob.solve_batch()
    assert len(set(res.nit)) > 1          # the cohorts do differ
    for r in range(16):
        alone = prob.solo(r).solve()
        assert (res.nit[r], res.nfev[r], int(res.status[r])) == (
            int(alone.nit), int(alone.nfev), int(alone.status))
        assert abs(float(res.cost[r]) - float(alone.cost)) <= (
            1e-9 * float(alone.cost))
