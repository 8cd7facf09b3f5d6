"""Port parity: the tied (shared-intrinsics) backend and the tied fleet.

``pycamset_tpu_torch/optim/shared_intr.py`` against the JAX package's
``optim/shared_intr.py`` in float64 on the CPU, on the JAX tests' tied
rigs (``tests/test_fleet.py::_tied_handler``: 3 cameras x 6 images, grid
7, a true rig whose cameras share one lens), carried over as numpy
(``from_jax``), each package seeding by its own PnP:

- ``resolve_lens_groups``: True, a label list and a dict, equal to JAX's,
  and its errors;
- ``fold_tied`` and the four tied ops (diag, grad, matvec, the damped
  solve) on the same normal equations (the port's at the rig's start,
  handed to both), within 1e-12 of each output's scale;
- ``run_bundle_adjustment`` on the tied handler with one lens group, two
  (cameras 0 and 1 share), and the fisheye model once (budget 12): the
  same nit, nfev and status, the cost within 1e-9 relative, x within 1e-8
  of its scale, and each group's cameras bit-identical;
- the tied fleet against the JAX package's fleet, per rig, with ragged
  image counts and two lens groups;
- every refusal raising the JAX package's error type: the self-cal chain,
  per-camera fixed intrinsics (one rig and a fleet), the scipy and sharded
  backends, and a fleet whose rigs' lens-group layouts differ;
- ``problems.template_handler`` / ``fleet_handlers`` with
  ``shared_intrinsics``, and the tied entry points' default device.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycamset_tpu.models.camera_set import CameraSet as JCameraSet
from pycamset_tpu.models.camera_set import make_cam_dict as j_make_cam_dict
from pycamset_tpu.models.detections import TargetDetection as JDetection
from pycamset_tpu.optim import handlers as jh_mod
from pycamset_tpu.optim import shared_intr as js
from pycamset_tpu.optim import structured as jst
from pycamset_tpu.optim.driver import run_bundle_adjustment as jax_rba
from pycamset_tpu.optim.fleet import FleetMismatch as JFleetMismatch
from pycamset_tpu.optim.fleet import run_fleet_bundle_adjustment as jax_fleet
from pycamset_tpu.utils.general_utils import make_4x4h_tform
from pycamset_tpu.utils.synthetic import make_synthetic_rig
from pycamset_tpu_torch import problems
from pycamset_tpu_torch.from_jax import (tied_neq_from_numpy,
                                         tied_pieces_from_numpy)
from pycamset_tpu_torch.optim import shared_intr as ps
from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
from pycamset_tpu_torch.optim.fleet import (FleetMismatch,
                                            run_fleet_bundle_adjustment)
from pycamset_tpu_torch.optim.problem import BAProblem, TiedProblem
from pycamset_tpu_torch.optim.structured import NormalEq, UnsupportedChain
from test_fleet import _template_handler, _tied_handler
from test_torch_fleet_handlers import _assert_same_rigs, _port_handler

GROUPS = {"one": True, "two": ["a", "a", "b"]}


def _port_tied(jh, **extra):
    """The JAX tied handler's rig as the port's handler, the same
    options."""
    return _port_handler(jh, "template", {**jh.problem_opts, **extra})


def _same_group_rows(cams, gid):
    """Each lens group's cameras: bit-identical intrinsics and
    distortion."""
    for c in range(len(gid)):
        first = int(np.flatnonzero(gid == gid[c])[0])
        for attr in ("intrinsic", "distortion_coefs"):
            assert np.array_equal(np.asarray(getattr(cams[c], attr)),
                                  np.asarray(getattr(cams[first], attr)))


def _assert_same_solve(j, p):
    assert (p.nit, p.nfev, p.status) == (j.nit, j.nfev, j.status)
    assert abs(p.cost - j.cost) <= 1e-9 * j.cost
    assert p.x.shape == j.x.shape
    assert np.abs(p.x - j.x).max() <= 1e-8 * np.abs(j.x).max()


@pytest.mark.parametrize("opt,names,ids", [
    (True, ["a", "b", "c"], [0, 0, 0]),
    (["x", "y", "x"], ["a", "b", "c"], [0, 1, 0]),
    ([2, 10, 2, 1], list("abcd"), [2, 1, 2, 0]),   # str order
    ({"a": 1, "b": 1, "c": 2}, ["a", "b", "c"], [0, 0, 1])])
def test_resolve_lens_groups_matches_jax(opt, names, ids):
    got = ps.resolve_lens_groups(opt, names)
    assert got.tolist() == ids == js.resolve_lens_groups(opt, names).tolist()
    assert got.dtype == np.int64


@pytest.mark.parametrize("opt,match", [
    (["x"], "one label per camera"), ({"a": 1}, "misses cameras")])
def test_resolve_lens_groups_errors_match_jax(opt, match):
    for resolve in (ps.resolve_lens_groups, js.resolve_lens_groups):
        with pytest.raises(ValueError, match=match):
            resolve(opt, ["a", "b", "c"])


@pytest.fixture(scope="module", params=list(GROUPS))
def neq_case(request):
    """The port's tied problem at the rig's start, its untied normal
    equations there (numpy), and a damping and step to apply the ops to."""
    opt = GROUPS[request.param]
    jh = _tied_handler(seed=5, shared_opt=opt)[0]
    solve_fn, _, _ = ps.build_shared_structured_problem(
        _port_tied(jh), dtype=torch.float64, device="cpu")
    prob = solve_fn.problem
    raw = BAProblem.make_neq(prob)(prob.layout.expand(prob.x0), prob.uv,
                                   prob.mask, prob.tpl, prob.colmask)
    rng = np.random.default_rng(3)
    shapes = [tuple(t.shape) for t in prob.x0]
    damp = [rng.uniform(0.5, 2.0, size=sh) for sh in shapes]
    dx = [rng.normal(size=sh) for sh in shapes]
    return dict(prob=prob, neq=[t.numpy() for t in raw], damp=damp, dx=dx)


def _close_pieces(got, ref, tol=1e-12, what=""):
    for g, r in zip(got, ref):
        r = np.asarray(r)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == r.shape, what
        assert np.abs(g - r).max() <= tol * max(np.abs(r).max(), 1e-300), \
            what


def test_fold_tied_matches_jax(neq_case):
    prob = neq_case["prob"]
    s, oh = prob.layout.s, prob.layout.onehot
    ref = js.fold_tied(jst.NormalEq(*(jnp.asarray(f)
                                      for f in neq_case["neq"])),
                       s, jnp.asarray(oh))
    got = ps.fold_tied(NormalEq(*(torch.tensor(f) for f in neq_case["neq"])),
                       s, torch.tensor(oh))
    assert list(got._fields) == list(ref._fields)
    _close_pieces(got, ref, what="fold_tied")


@pytest.mark.parametrize("op", ["diag", "grad", "matvec", "solve"])
def test_tied_ops_match_jax(neq_case, op):
    prob = neq_case["prob"]
    s, oh = prob.layout.s, prob.layout.onehot
    jneq = js.fold_tied(jst.NormalEq(*(jnp.asarray(f)
                                       for f in neq_case["neq"])),
                        s, jnp.asarray(oh))
    pneq = tied_neq_from_numpy([np.asarray(f) for f in jneq], "cpu",
                               torch.float64)
    j_ops = dict(zip(("diag", "matvec", "solve", "grad"),
                     js.make_tied_ops(oh)))
    p_ops = dict(zip(("diag", "matvec", "solve", "grad"),
                     ps.make_tied_ops(oh)))
    if op in ("diag", "grad"):
        got, ref = p_ops[op](pneq), j_ops[op](jneq)
    else:
        arg = neq_case["dx" if op == "matvec" else "damp"]
        got = p_ops[op](pneq, tied_pieces_from_numpy(*arg, "cpu",
                                                     torch.float64))
        ref = j_ops[op](jneq, js.TiedPieces(*(jnp.asarray(a) for a in arg)))
    _close_pieces(got, ref, what=op)


@pytest.fixture(scope="module", params=["one", "two", "fisheye"])
def solved(request):
    """Both packages' tied solves of one rig, the port's handler and the
    lens groups."""
    if request.param == "fisheye":
        rig = make_synthetic_rig(n_cams=3, n_ims=6, grid=7, visibility=0.95,
                                 noise_px=0.2, seed=7, camera_model="fisheye",
                                 shared_intrinsics=True)
        names = ["a", "b", "c"]
        k = [np.array([[i[0], 0, i[1]], [0, i[2], i[3]], [0, 0, 1]])
             for i in rig["intr"]]
        ext = [make_4x4h_tform(e[:3], e[3:]) for e in rig["extr"]]
        jh = jh_mod.TemplateBundleHandler(
            JCameraSet(camera_dict=j_make_cam_dict(
                names, ext, k, [i[4:] for i in rig["intr"]],
                [[1600, 1200]] * 3)),
            jh_mod.FreePointTarget(rig["template"].reshape(1, -1, 3)),
            JDetection(cam_names=names, data=rig["dd"]),
            options={"outliers": "n", "camera_model": "fisheye",
                     "shared_intrinsics": True, "max_nfev": 12})
        opt = True
    else:
        opt = GROUPS[request.param]
        jh = _tied_handler(seed=5, shared_opt=opt)[0]
    port = _port_tied(jh)
    starts = (jh.get_initial_params(), port.get_initial_params())
    jax_out = jax_rba(jh, backend="structured")
    port_out = run_bundle_adjustment(port, device="cpu")
    return dict(starts=starts, jax=jax_out, port=port_out, handler=port,
                gid=ps.resolve_lens_groups(opt, port.cam_names))


def test_the_same_tied_start(solved):
    assert np.array_equal(*solved["starts"])


def test_the_same_tied_solve(solved):
    (j, jc), (p, pc) = solved["jax"], solved["port"]
    _assert_same_solve(j, p)
    for a, b in zip(jc, pc):
        for attr in ("intrinsic", "distortion_coefs", "extrinsic"):
            ref = np.asarray(getattr(a, attr), dtype=float)
            assert np.abs(np.asarray(getattr(b, attr)) - ref).max() <= (
                1e-8 * max(np.abs(ref).max(), 1e-12))


def test_each_lens_group_comes_back_bit_identical(solved):
    _same_group_rows(solved["port"][1], solved["gid"])
    _same_group_rows(solved["jax"][1], solved["gid"])


def test_the_tied_problem_is_a_tied_problem(solved):
    """The port's solve went through TiedProblem with the tied pieces:
    the group count's shared rows, each camera's extrinsics."""
    solve_fn, _, _ = ps.build_shared_structured_problem(
        solved["handler"], dtype=torch.float64, device="cpu")
    prob = solve_fn.problem
    assert isinstance(prob, TiedProblem)
    g, s = int(solved["gid"].max()) + 1, prob.layout.s
    assert tuple(prob.x0.shared.shape) == (g, s)
    assert tuple(prob.x0.cam.shape) == (3, 6)


def test_tied_fleet_matches_jax_with_groups_and_ragged_images():
    """Two rigs of 4 and 6 images on one grid (8), cameras 0 and 1 one
    lens, camera 2 its own, per rig against the JAX fleet."""
    groups = ["a", "a", "b"]
    jhs = [_tied_handler(seed=s, n_ims=n, shared_opt=groups)[0]
           for n, s in [(4, 11), (6, 12)]]
    ref = jax_fleet(jhs)
    got = run_fleet_bundle_adjustment([_port_tied(jh) for jh in jhs],
                                      device="cpu")
    _assert_same_rigs(ref, got)
    gid = np.array([0, 0, 1])
    for cams in got[1]:
        _same_group_rows(cams, gid)
        assert not np.array_equal(cams[1].intrinsic, cams[2].intrinsic)


def _fixed_lens(rig):
    i9 = rig["intr"][0]
    return {"cam0": {"int": np.array([[i9[0], 0, i9[1]], [0, i9[2], i9[3]],
                                      [0, 0, 1]]), "dst": i9[4:]}}


def _renamed(jh, names):
    """The JAX tied handler's rig with its cameras renamed."""
    c = jh.camset
    return jh_mod.TemplateBundleHandler(
        JCameraSet(camera_dict=j_make_cam_dict(
            names, [x.extrinsic for x in c], [x.intrinsic for x in c],
            [x.distortion_coefs for x in c], [x.res for x in c])),
        jh_mod.FreePointTarget(jh.target.point_data),
        JDetection(cam_names=names, data=jh.detection.get_data()),
        options=dict(jh.problem_opts))


def _refusal(what):
    """(JAX call, port call, the error type both raise)."""
    if what == "selfcal chain":
        jh = _template_handler(n_cams=3, n_ims=6, grid=7, seed=5,
                               shared_rig=True)[0]
        jself = jh_mod.SelfBundleHandler(
            detection=jh.detection, target=jh.target, camset=jh.camset,
            options={"outliers": "n", "shared_intrinsics": True})
        pself = _port_handler(jh, "selfcal", {"shared_intrinsics": True})
        return (lambda: jax_rba(jself),
                lambda: run_bundle_adjustment(pself, device="cpu"),
                (jst.UnsupportedChain, UnsupportedChain), "template chains")
    if what in ("fixed intrinsics", "fleet fixed intrinsics"):
        opts = {"shared_intrinsics": True}
        jh, rig = _template_handler(n_cams=3, n_ims=6, grid=7, seed=6,
                                    shared_rig=True,
                                    fixed_params=None, options=opts)
        fixed = _fixed_lens(rig)
        jfix = _template_handler(n_cams=3, n_ims=6, grid=7, seed=6,
                                 shared_rig=True, fixed_params=fixed,
                                 options=opts)[0]
        pfix = _port_handler(jfix, "template", opts, fixed_params=fixed)
        if what == "fixed intrinsics":
            return (lambda: jax_rba(jfix),
                    lambda: run_bundle_adjustment(pfix, device="cpu"),
                    (jst.UnsupportedChain, UnsupportedChain),
                    "fixed intrinsics")
        j0 = _tied_handler(seed=5)[0]
        return (lambda: jax_fleet([j0, jfix]),
                lambda: run_fleet_bundle_adjustment(
                    [_port_tied(j0), pfix], device="cpu"),
                (jst.UnsupportedChain, UnsupportedChain), "fixed intrinsics")
    if what.startswith("backend"):
        backend = what.split()[1]
        jh = _tied_handler(seed=5)[0]
        port = _port_tied(jh)
        return (lambda: jax_rba(jh, backend=backend),
                lambda: run_bundle_adjustment(port, backend=backend,
                                              device="cpu"),
                (ValueError, ValueError), "shared_intrinsics is not "
                "available")
    # a fleet whose rigs' lens-group layouts differ: one dict option, rig
    # 1's cameras named so that it groups them otherwise
    opt = {"cam0": 0, "cam1": 0, "cam2": 1, "x": 1, "y": 0, "z": 0}
    j0 = _tied_handler(seed=5, shared_opt=opt)[0]
    j1 = _renamed(_tied_handler(seed=6, shared_opt=opt)[0], ["x", "y", "z"])
    return (lambda: jax_fleet([j0, j1]),
            lambda: run_fleet_bundle_adjustment(
                [_port_tied(j0), _port_tied(j1)], device="cpu"),
            (JFleetMismatch, FleetMismatch), "lens-group layout")


@pytest.mark.parametrize("what", [
    "selfcal chain", "fixed intrinsics", "fleet fixed intrinsics",
    "backend scipy", "backend sharded", "fleet group layout"])
def test_refusals_raise_what_jax_raises(what):
    jax_call, port_call, (jax_err, port_err), match = _refusal(what)
    with pytest.raises(jax_err):
        jax_call()
    with pytest.raises(port_err, match=match):
        port_call()


def test_template_handler_ties_the_rig():
    """``problems.template_handler(shared_intrinsics=...)``: the rig's
    cameras share their group's true lens, the handler ties them, and the
    tied solve recovers the noise level with identical group rows."""
    gid = [0, 1, 0, 1]
    handler, rig = problems.template_handler(4, 8, grid=6,
                                             shared_intrinsics=gid)
    assert handler.problem_opts["shared_intrinsics"] == gid
    assert np.array_equal(rig["intr"][0], rig["intr"][2])
    res, cams = run_bundle_adjustment(handler, device="cpu")
    assert res.status in (1, 2)
    assert np.sqrt(np.mean(res.fun ** 2)) <= 0.36
    _same_group_rows(cams, np.array(gid))


def test_fleet_handlers_tie_every_rig():
    hs = problems.fleet_handlers("template", 3, 4, 8, grid=5,
                                 shared_intrinsics=True)
    results, camsets = run_fleet_bundle_adjustment(hs, device="cpu")
    for res, cams in zip(results, camsets):
        assert res.status in (1, 2)
        _same_group_rows(cams, np.zeros(4, dtype=int))
    with pytest.raises(ValueError, match="template chain"):
        problems.fleet_handlers("selfcal", 2, 2, 4, shared_intrinsics=True)


@pytest.mark.parametrize("entry", ["single", "fleet"])
def test_tied_entry_points_default_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        if entry == "single":
            handler, _ = problems.template_handler(3, 5, grid=6,
                                                   shared_intrinsics=True)
            run_bundle_adjustment(handler)
        else:
            run_fleet_bundle_adjustment(problems.fleet_handlers(
                "template", 2, 2, 4, grid=4, shared_intrinsics=True))
