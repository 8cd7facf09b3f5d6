"""Port parity: the user path from a CameraSet and its detections to a
calibrated, saved CameraSet.

The JAX package's own rig helper (``tests/test_fleet.py::_template_handler``:
3 cameras x 6 images, grid 5, seed 5) builds a ``TemplateBundleHandler``;
its CameraSet and TargetDetection are carried to the port as numpy
(``from_jax.camset_from_numpy``, ``detection_from_numpy``), and both
packages run ``run_bundle_adjustment(handler, backend="structured")`` in
float64 on the CPU, each seeded by its own PnP (the same OpenCV calls on
the same inputs):

- the start bit for bit, ``missing_poses`` equal (also with an image made an
  outlier and dropped under ``outliers: "y"``);
- ``nit``, ``nfev`` and ``status`` equal, the cost within 1e-9 relative,
  ``x``, the residuals and the returned cameras within 1e-7 of their scale;
- a ``.camset`` file written by either package loads in the other with
  equal cameras, detection table and handler options;
- at 8 images (no image-bucket padding) the handler path and
  ``problems.standard_problem`` solve the same problem: the same
  ``nit``/``nfev``, the cost within 1e-12 relative;
- every part of the JAX path the port does not have yet raises, naming its
  ROADMAP item (per-camera camera_model maps are ported: their parity is
  ``tests/test_torch_het_rig.py``'s); the two cases that met the generic
  and scipy backends' refusal, and the one that met the rolling-shutter
  option's, are held to the JAX package;
  ``CameraSet.multi_cam_triangulate`` and
  ``project_points_to_all_cams`` match the JAX package's within 1e-9;
- a non-minimal camera's sensor map, asked for on the CPU, matches the JAX
  package's (OpenCV's undistortion) within 1e-8, and asked for on the card
  (the default) raises where there is none.
"""
import sys

import numpy as np
import pytest
import torch

from pycamset_tpu.optim.driver import run_bundle_adjustment as jax_rba
from pycamset_tpu.utils.saving import load_CameraSet as jax_load
from pycamset_tpu_torch.calibration.camera_calibrator import (
    run_stereo_calibration)
from pycamset_tpu_torch.from_jax import (camset_from_numpy,
                                         detection_from_numpy)
from pycamset_tpu_torch.optim import handlers as ph
from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
from pycamset_tpu_torch.problems import standard_problem, template_handler
from pycamset_tpu_torch.utils.saving import load_CameraSet
from test_fleet import _template_handler

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)

# the image made an outlier (its detections moved by 40 px noise)
BAD_IM = 3


def _port_handler(jh, options):
    """The JAX handler's CameraSet, target and detection, carried over."""
    cams = jh.camset
    return ph.TemplateBundleHandler(
        camset_from_numpy(cams.get_names(), [c.extrinsic for c in cams],
                          [c.intrinsic for c in cams],
                          [c.distortion_coefs for c in cams],
                          [c.res for c in cams]),
        ph.FreePointTarget(jh.target.point_data),
        detection_from_numpy(jh.detection.cam_names, jh.detection.get_data(),
                             jh.detection.max_ims),
        options=options)


@pytest.fixture(scope="module", params=["n", "y"])
def solved(request):
    """Both packages' handlers and solves; under "y" one image is made an
    outlier first."""
    options = {"outliers": request.param}
    jh, _ = _template_handler(n_cams=3, n_ims=6, grid=5, seed=5,
                              options=options)
    if request.param == "y":
        data = jh.detection.get_data().copy()
        bad = data[:, 1] == BAD_IM
        data[bad, 3:5] += np.random.default_rng(3).normal(
            size=(bad.sum(), 2)) * 40.0
        jh.detection = type(jh.detection)(jh.detection.cam_names, data,
                                          jh.detection.max_ims)
    port = _port_handler(jh, {"outliers": request.param})
    x_jax = jh.get_initial_params()
    x_port = port.get_initial_params()
    jax_res, jax_cams = jax_rba(jh, backend="structured")
    port_res, port_cams = run_bundle_adjustment(port, backend="structured",
                                                device="cpu")
    return dict(option=request.param, jh=jh, port=port, x_jax=x_jax,
                x_port=x_port, jax_res=jax_res, jax_cams=jax_cams,
                port_res=port_res, port_cams=port_cams)


def test_the_same_start(solved):
    assert np.array_equal(solved["x_jax"], solved["x_port"])
    missing = np.asarray(solved["jh"].missing_poses)
    assert np.array_equal(missing, np.asarray(solved["port"].missing_poses))
    assert missing.sum() == (solved["option"] == "y")
    if solved["option"] == "y":
        assert missing[BAD_IM]


def test_the_same_solve(solved):
    j, p = solved["jax_res"], solved["port_res"]
    assert (p.nit, p.nfev, p.status) == (j.nit, j.nfev, j.status)
    assert p.status in (1, 2)
    assert abs(p.cost - j.cost) <= 1e-9 * j.cost
    for name in ("x", "fun"):
        ref = np.asarray(j[name])
        assert np.abs(np.asarray(p[name]) - ref).max() <= (
            1e-7 * np.abs(ref).max())


def test_the_same_cameras(solved):
    for cj, cp in zip(solved["jax_cams"], solved["port_cams"]):
        assert cj.name == cp.name
        for attr in ("intrinsic", "distortion_coefs", "extrinsic"):
            ref = np.asarray(getattr(cj, attr))
            assert np.abs(np.asarray(getattr(cp, attr)) - ref).max() <= (
                1e-7 * np.abs(ref).max())


def _same_cameras(a, b):
    """Two CameraSets (of either package) with equal cameras, in order."""
    assert a.get_names() == b.get_names()
    for ca, cb in zip(a, b):
        for attr in ("intrinsic", "distortion_coefs", "extrinsic", "res"):
            assert np.array_equal(np.asarray(getattr(ca, attr)),
                                  np.asarray(getattr(cb, attr))), attr


def _same_file_contents(a, b):
    _same_cameras(a, b)
    ha, hb = a.calibration_handler, b.calibration_handler
    assert np.array_equal(ha.detection.get_data(), hb.detection.get_data())
    assert ha.detection.max_ims == hb.detection.max_ims
    assert ha.problem_opts == hb.problem_opts
    assert np.array_equal(np.asarray(ha.missing_poses),
                          np.asarray(hb.missing_poses))
    assert np.array_equal(ha.target.point_data, hb.target.point_data)
    assert np.array_equal(a.calibration_params, b.calibration_params)
    assert np.array_equal(a.calibration_result, b.calibration_result)


def test_port_file_loads_in_jax_package(solved, tmp_path):
    path = tmp_path / "port.camset"
    solved["port_cams"].save(path)
    back = jax_load(path)
    assert type(back.calibration_handler).__module__ == (
        "pycamset_tpu.optim.handlers")
    _same_file_contents(back, load_CameraSet(path))
    _same_cameras(back, solved["port_cams"])


def test_jax_file_loads_in_port(solved, tmp_path):
    path = tmp_path / "jax.camset"
    solved["jax_cams"].save(path)
    back = load_CameraSet(path)
    assert isinstance(back.calibration_handler, ph.TemplateBundleHandler)
    _same_file_contents(back, jax_load(path))
    _same_cameras(back, solved["jax_cams"])


def test_handler_path_solves_the_bench_problem():
    """At 8 images (a multiple of the image bucket) the handler's problem
    is ``standard_problem``'s."""
    handler, _ = template_handler(3, 8, grid=6)
    got, _ = run_bundle_adjustment(handler, device="cpu")
    ref = standard_problem(3, 8, "cpu", grid=6).solve()
    assert (got.nit, got.nfev) == (ref.nit, ref.nfev)
    assert abs(2 * got.cost - float(ref.cost)) <= 1e-12 * float(ref.cost)


def test_run_stereo_calibration_saves_what_it_returns(tmp_path):
    handler, _ = template_handler(3, 5, grid=6)
    path = tmp_path / "cams.camset"
    cams = run_stereo_calibration(None, None, None, param_handler=handler,
                                  save_loc=path, device="cpu")
    back = load_CameraSet(path)
    _same_file_contents(back, cams)
    assert cams.calibration_result.shape == (
        2 * handler.detection.get_data().shape[0],)


def _refuse(what):
    """Drive the port's user path into one part it does not have yet."""
    handler, _ = template_handler(3, 5, grid=6)
    if what in ("mixed chain", "grouped chain"):
        from pycamset_tpu_torch.optim.blocks import (Extrinsic3D, FreePoint,
                                                     GroupRigidTform3d,
                                                     GroupTemplatePoints,
                                                     Projection, RigidTform3d)
        from pycamset_tpu_torch.optim.chain import OptimFunction
        last = ([GroupRigidTform3d(), FreePoint()] if what == "mixed chain"
                else [GroupTemplatePoints()])
        handler.op_fun = OptimFunction([Projection(), Extrinsic3D(),
                                        RigidTform3d(), *last])
    backend = what.split()[1] if what.startswith("backend") else "auto"
    run_bundle_adjustment(handler, backend=backend, device="cpu")


def _item8_parity(what):
    """The two inputs that met the generic backend's refusal before it was
    ported, given to both packages: scipy's TRF on the refusal's rig with
    its lenses fixed (with free lenses TRF stops at max_nfev here and its
    lsmr steps amplify rounding, ``tests/test_torch_generic.py``), and the
    mixed chain on a handler without groups, which both packages refuse
    with the same ValueError from the generic backend's gather rows."""
    from test_torch_fleet_handlers import _port_handler as carried
    rig = dict(n_cams=3, n_ims=5, grid=6, seed=5, options={"verbosity": 0})
    jh, _ = _template_handler(**rig)
    fixed = None
    if what == "backend scipy":
        fixed = {c.name: {"int": c.intrinsic,
                          "dst": np.ravel(c.distortion_coefs)}
                 for c in jh.camset}
        jh, _ = _template_handler(**rig, fixed_params=fixed)
    port = carried(jh, "template", options={"verbosity": 0},
                   fixed_params=fixed)
    port.set_initial_params(np.array(jh.get_initial_params()))
    if what == "backend scipy":
        ref, _ = jax_rba(jh, backend="scipy")
        got, _ = run_bundle_adjustment(port, backend="scipy", device="cpu")
        assert (got.nfev, got.status) == (ref.nfev, ref.status)
        assert abs(got.cost - ref.cost) <= 1e-8 * ref.cost
        return
    from pycamset_tpu.optim import blocks as jb
    from pycamset_tpu.optim.chain import OptimFunction as JaxChain
    from pycamset_tpu_torch.optim import blocks as pb
    from pycamset_tpu_torch.optim.chain import OptimFunction
    jh.op_fun = JaxChain([jb.Projection(), jb.Extrinsic3D(),
                          jb.RigidTform3d(), jb.GroupRigidTform3d(),
                          jb.FreePoint()])
    port.op_fun = OptimFunction([pb.Projection(), pb.Extrinsic3D(),
                                 pb.RigidTform3d(), pb.GroupRigidTform3d(),
                                 pb.FreePoint()])
    with pytest.raises(ValueError) as ref:
        jax_rba(jh)
    with pytest.raises(ValueError) as got:
        run_bundle_adjustment(port, device="cpu")
    assert str(ref.value) in str(got.value)


def _rs_parity():
    """The rolling-shutter option (item 7's handler, ported) given to both
    packages' ``run_stereo_calibration`` on a rolling-shutter capture:
    each builds its RS handler, PnP-seeds it and solves it alike."""
    from pycamset_tpu.calibration.camera_calibrator import (
        run_stereo_calibration as jax_rsc)
    from pycamset_tpu.models.detections import TargetDetection as JDetection
    from pycamset_tpu.optim.handlers import FreePointTarget as JTarget
    from pycamset_tpu_torch.from_jax import detection_from_numpy
    from test_torch_rolling_shutter import OPTS, _capture, _port_cams
    cams, tpl, dd, _p, _v = _capture(6, 0.1, 2)
    names = list(cams.get_names())
    opts = {**OPTS, "rolling_shutter": True}
    ref = jax_rsc(cams, JDetection(cam_names=names, data=dd),
                  JTarget(tpl.reshape(1, -1, 3)), save=False,
                  problem_options=dict(opts))
    got = run_stereo_calibration(
        _port_cams(cams), detection_from_numpy(names, dd, 6),
        ph.FreePointTarget(tpl.reshape(1, -1, 3)), save=False,
        problem_options=dict(opts), device="cpu")
    assert type(got.calibration_handler) is ph.RSTemplateBundleHandler
    assert got.calibration_handler.ref_readout == 1.0
    x_ref = np.asarray(ref.calibration_params)
    assert np.abs(got.calibration_params - x_ref).max() <= 1e-7 * np.abs(
        x_ref).max()


@pytest.mark.parametrize("what,item", [
    ("backend scipy", "item 8"), ("backend sharded", "item 11"),
    ("rolling_shutter", "item 7"),
    ("mixed chain", "group_of_key"), ("mixed chain", "item 8"),
    ("grouped chain", "group_of_key")])
def test_refusals_name_their_roadmap_item(what, item):
    """The parts of the JAX path the port has not got raise, naming their
    ROADMAP item. The two "item 8" cases (the scipy backend, and "auto"'s
    generic fallback on a chain neither structured builder takes) and the
    "item 7" one (the rolling-shutter option) are ported: they now do what
    the JAX package does with the same input. A multi-target chain on a
    handler without groups reaches the generic backend, whose gather rows
    need the handler's group_of_key."""
    if item == "item 8":
        _item8_parity(what)
        return
    if item == "item 7":
        _rs_parity()
        return
    error = ValueError if item == "group_of_key" else NotImplementedError
    with pytest.raises(error, match=item):
        _refuse(what)


def test_pnp_seed_without_cv2_names_the_way_around(monkeypatch):
    handler, _ = template_handler(3, 5, grid=6)
    handler.initial_params = None
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="set_initial_params"):
        handler.get_initial_params()


def test_entry_points_default_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    handler, _ = template_handler(3, 5, grid=6)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        run_bundle_adjustment(handler)


def test_triangulation_and_projection_match_jax(solved):
    jc, pc = solved["jh"].camset, solved["port"].camset
    table = solved["jh"].detection.get_data()
    got = pc.multi_cam_triangulate(table, device="cpu")
    ref = jc.multi_cam_triangulate(table)
    assert got.shape == ref.shape and len(got)
    assert np.abs(got - ref).max() <= 1e-9 * np.abs(ref).max()
    pts = ref[:20]
    for g, r in zip(pc.project_points_to_all_cams(pts, device="cpu"),
                    jc.project_points_to_all_cams(pts)):
        assert g.keys() == r.keys()
        for name in r:
            assert np.abs(g[name] - r[name]).max() <= 1e-9 * np.abs(
                r[name]).max()


def _sensor_cam(cls, **kw):
    """A small distorted camera with an eager sensor map."""
    kmat = np.array([[60.0, 0, 20.5], [0, 62.0, 14.2], [0, 0, 1]])
    ext = np.eye(4)
    ext[:3, 3] = [0.1, -0.2, 1.0]
    return cls(extrinsic=ext, intrinsic=kmat, res=[40, 30], minimal=False,
               distortion_coefs=[-0.12, 0.05, 1e-3, -2e-3, 0.01], **kw)


def test_sensor_map_on_the_cpu_matches_jax():
    from pycamset_tpu.models.camera import Camera as JaxCamera
    from pycamset_tpu_torch.models.camera import Camera
    ref = _sensor_cam(JaxCamera).world_sensor_map
    got = _sensor_cam(Camera, device="cpu")
    assert got.world_sensor_map.shape == ref.shape == (40, 30, 3)
    assert np.abs(got.world_sensor_map - ref).max() <= 1e-8 * np.abs(
        ref).max()
    got.set_extrinsic(np.eye(4))   # an update rebuilds it where it was asked
    assert got.device == "cpu" and got.world_sensor_map.shape == ref.shape


def test_sensor_map_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from pycamset_tpu_torch.models.camera import Camera, sensor_map
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _sensor_cam(Camera)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        sensor_map("linear", np.eye(3), (4, 3), dist_coefs=np.zeros(5))
