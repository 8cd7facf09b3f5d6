"""Port parity: the rolling-shutter user path (float64, CPU).

``RSTemplateBundleHandler`` (per-image [pose | velocity] rows, per-camera
readouts, the normalised image row an aux channel of the detections) and
its chain ``Projection + Extrinsic3D + RSPoseVel + RSTemplateTime`` on the
structured backend's forward-mode route, against the JAX package on the
rig of its own tests (``tests/test_rolling_shutter.py``: three ring cameras,
a 7 x 7 grid, readouts 0.7 / 0.9 / 0.5):

- ``utils.synthetic.rs_capture`` against the JAX test's generator;
- the chain's residual at the generating parameters (JAX
  ``test_rs_chain_residual_at_truth``), the local assembler of the
  out-of-order chain against JAX's, the gauge columns;
- ``run_stereo_calibration(problem_options={"rolling_shutter": r})`` and
  ``run_bundle_adjustment`` against the JAX package's solve of the same
  handler: the same nit, nfev and status, the cost within 1e-9 relative,
  the same readouts and velocities; the global-shutter handler on the same
  data left with the smear;
- the refusals of the generic, scipy, fleet and uncertainty paths, with
  the JAX package's error types and messages;
- a rolling-shutter ``.camset`` written by each package loads in the other.

The captures come from the port's vectorised generator (the JAX one
projects all K points for each point), which the first test ties to the
JAX generator.
"""
import numpy as np
import pytest
import torch

from pycamset_tpu.calibration.camera_calibrator import (
    run_stereo_calibration as jax_rsc)
from pycamset_tpu.models.detections import TargetDetection as JDetection
from pycamset_tpu.optim import handlers as jh
from pycamset_tpu.optim.driver import run_bundle_adjustment as jax_rba
from pycamset_tpu.utils.saving import load_CameraSet as jax_load
from pycamset_tpu_torch import problems
from pycamset_tpu_torch.calibration.camera_calibrator import (
    run_stereo_calibration)
from pycamset_tpu_torch.from_jax import (camset_from_numpy,
                                         detection_from_numpy,
                                         rs_primitive_from_numpy)
from pycamset_tpu_torch.optim import handlers as ph
from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
from pycamset_tpu_torch.optim.structured_driver import (
    build_structured_problem)
from pycamset_tpu_torch.utils.saving import load_CameraSet
from pycamset_tpu_torch.utils.synthetic import rs_capture
from test_rolling_shutter import (TRUE_READOUTS, _grid_template, _ring_rig,
                                  _rs_capture)

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)

OPTS = {"outliers": "n", "verbosity": 0}


def _port_cams(cams):
    return camset_from_numpy(cams.get_names(), [c.extrinsic for c in cams],
                             [c.intrinsic for c in cams],
                             [c.distortion_coefs for c in cams],
                             [c.res for c in cams])


def _capture(n_ims, noise, seed):
    cams = _ring_rig()
    tpl = _grid_template()
    dd, poses, vels = rs_capture(_port_cams(cams), tpl, n_ims,
                                 TRUE_READOUTS, noise=noise, seed=seed)
    return cams, tpl, dd, poses, vels


def _pair(cams, tpl, dd, ref_readout=TRUE_READOUTS[0], options=None):
    """The JAX package's RS handler of a capture (PnP-seeded) and the
    port's of the same data, seeded at the JAX start."""
    opts = {**OPTS, "rolling_shutter": ref_readout, **(options or {})}
    names = list(cams.get_names())
    jhandler = jh.RSTemplateBundleHandler(
        cams, jh.FreePointTarget(tpl.reshape(1, -1, 3)),
        JDetection(cam_names=names, data=dd), options=dict(opts))
    x0 = np.array(jhandler.get_initial_params())
    port = ph.RSTemplateBundleHandler(
        _port_cams(cams), ph.FreePointTarget(tpl.reshape(1, -1, 3)),
        detection_from_numpy(names, dd, jhandler.detection.max_ims),
        options=dict(opts), missing_poses=jhandler.missing_poses)
    jp = jhandler.bundlePrimitive
    rs_primitive_from_numpy(port, jp.intr, jp.extr, jp.poses, jp.readout,
                            jp.pose_colmask)
    port.set_initial_params(x0)
    return jhandler, port


@pytest.fixture(scope="module")
def solved():
    """One capture solved by both packages through the user entry point."""
    cams, tpl, dd, poses, vels = _capture(10, 0.1, 5)
    jhandler, port = _pair(cams, tpl, dd)
    jres, jcams = jax_rba(jhandler)
    pres, pcams = run_bundle_adjustment(port, device="cpu")
    return dict(jh=jhandler, ph=port, jr=jres, pr=pres, jc=jcams, pc=pcams,
                vels=vels, cams=cams, tpl=tpl, dd=dd)


def test_rs_capture_matches_the_jax_generator():
    cams, tpl = _ring_rig(), _grid_template()
    ref = _rs_capture(cams, tpl, 4, TRUE_READOUTS, noise=0.1, seed=2)
    got = rs_capture(_port_cams(cams), tpl, 4, TRUE_READOUTS, noise=0.1,
                     seed=2)
    assert got[0].shape == ref[0].shape
    assert np.array_equal(got[0][:, :3], ref[0][:, :3])
    assert np.abs(got[0] - ref[0]).max() <= 1e-9
    for g, r in zip(got[1:], ref[1:]):
        assert np.array_equal(g, r)


def test_rs_chain_residual_at_truth():
    """The chain reproduces the generator: residuals at the generating
    parameters sit at the row fixed point's tolerance on a noise-free
    capture (JAX ``test_rs_chain_residual_at_truth``)."""
    cams, tpl, dd, poses, vels = _capture(8, 0.0, 3)
    _, port = _pair(cams, tpl, dd)
    prim = port.bundlePrimitive
    for c, cam in enumerate(port.camset):
        prim.extr[c] = np.concatenate(ph.gu.ext_4x4_to_rod(cam.extrinsic))
    prim.poses[:, :6] = poses
    prim.poses[:, 6:] = vels
    prim.readout[:, 0] = TRUE_READOUTS
    x_true = prim.base_full()[prim.unfixed_full()]
    _solve, residual_fn, _x0 = build_structured_problem(port, device="cpu")
    assert np.sqrt(np.mean(residual_fn(x_true) ** 2)) < 1e-4


def test_rs_layout_matches_jax():
    """Gauge columns, the full vector's order, the aux channel and the
    out-of-order chain's local assembler, against the JAX handler's."""
    cams, tpl, dd, _p, _v = _capture(6, 0.0, 2)
    jhandler, port = _pair(cams, tpl, dd)
    jp, pp = jhandler.bundlePrimitive, port.bundlePrimitive
    assert not pp.pose_colmask[0, :6].any() and pp.pose_colmask[0, 6:].all()
    assert not pp.readout_unfixed[0] and pp.readout_unfixed[1:].all()
    assert np.array_equal(pp.unfixed_full(), jp.unfixed_full())
    assert np.array_equal(pp.base_full(), jp.base_full())
    flat = port.get_detection_data(flatten=True)
    assert np.array_equal(port.aux_table(flat), jhandler.aux_table(flat))
    local = np.arange(28.0)
    cam, im = local[:16], local[16:]
    got = port.op_fun.make_local_assembler()(
        torch.tensor(cam), torch.tensor(im), torch.zeros(0,
                                                         dtype=torch.float64))
    ref = jhandler.op_fun.make_local_assembler()(cam, im, np.zeros(0))
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_rs_solve_matches_jax(solved):
    """``run_bundle_adjustment`` ("auto": the structured backend) on the
    same handler in both packages."""
    jres, pres = solved["jr"], solved["pr"]
    assert (pres["nit"], pres["nfev"], pres["status"]) == (
        jres["nit"], jres["nfev"], jres["status"])
    assert abs(pres["cost"] - jres["cost"]) <= 1e-9 * jres["cost"]
    x_j, x_p = np.asarray(jres["x"]), np.asarray(pres["x"])
    assert np.abs(x_p - x_j).max() <= 1e-7 * np.abs(x_j).max()
    got = solved["ph"].get_readouts(x_p)
    ref = solved["jh"].get_readouts(x_j)
    assert got.keys() == ref.keys()
    for name in ref:
        assert abs(got[name] - ref[name]) <= 1e-7
    assert got["cam0"] == pytest.approx(TRUE_READOUTS[0])
    for c in (1, 2):
        assert abs(got[f"cam{c}"] - TRUE_READOUTS[c]) < 0.05, got
    v_got = solved["ph"].get_velocities(x_p)
    assert np.abs(v_got - solved["jh"].get_velocities(x_j)).max() <= 1e-7
    assert np.abs(v_got - solved["vels"]).max() < 0.02
    assert np.sqrt(np.mean(np.asarray(pres["fun"]) ** 2)) < 0.2


def test_rolling_shutter_option_builds_the_rs_handler(solved):
    """``run_stereo_calibration(problem_options={"rolling_shutter": r})``
    solves the RS chain through "auto" on the structured backend, as the
    JAX package's does; the global-shutter handler on the same data keeps
    the smear (JAX ``test_global_shutter_handler_degrades_on_rs_data``)."""
    cams, tpl, dd = solved["cams"], solved["tpl"], solved["dd"]
    names = list(cams.get_names())
    det = detection_from_numpy(names, dd, int(dd[:, 1].max()) + 1)
    target = ph.FreePointTarget(tpl.reshape(1, -1, 3))
    opts = {**OPTS, "rolling_shutter": TRUE_READOUTS[0]}
    port = ph.RSTemplateBundleHandler(_port_cams(cams), target, det,
                                      options=dict(opts))
    port.set_initial_params(np.array(solved["jh"].get_initial_params()))
    got = run_stereo_calibration(None, None, None, param_handler=port,
                                 save=False, device="cpu")
    ref = solved["pr"]["x"]
    assert np.array_equal(got.calibration_params, ref)
    # the option alone picks the handler (its PnP seed is the JAX one,
    # bit for bit: the same solve)
    by_option = run_stereo_calibration(_port_cams(cams), det, target,
                                       save=False, problem_options=opts,
                                       device="cpu")
    assert type(by_option.calibration_handler) is ph.RSTemplateBundleHandler
    assert np.array_equal(by_option.calibration_params, ref)
    jcams = jax_rsc(cams, JDetection(cam_names=names, data=dd),
                    jh.FreePointTarget(tpl.reshape(1, -1, 3)), save=False,
                    problem_options=dict(opts))
    assert np.abs(by_option.calibration_params
                  - jcams.calibration_params).max() <= 1e-7 * np.abs(
                      jcams.calibration_params).max()
    gs = ph.TemplateBundleHandler(_port_cams(cams), target, det,
                                  options=dict(OPTS))
    gs.set_initial_params(
        np.array(solved["jh"].get_initial_params())[_global_columns(
            solved["jh"])])
    res, _ = run_bundle_adjustment(gs, device="cpu")
    assert np.sqrt(np.mean(res["fun"] ** 2)) > 10 * 0.1


def _global_columns(jhandler):
    """The free entries of an RS start that a global-shutter handler of
    the same rig has: intrinsics, extrinsics and the pose half of each
    image's row."""
    prim = jhandler.bundlePrimitive
    n_i, n_c = prim.poses.shape[0], prim.intr.shape[0]
    keep = np.ones(prim.base_full().size, dtype=bool)
    ee = (prim.intr_width + 6) * n_c
    keep[ee:ee + 12 * n_i] = np.tile(np.arange(12) < 6, n_i)
    keep[ee + 12 * n_i:] = False
    return keep[prim.unfixed_full()]


@pytest.mark.parametrize("path", ["generic", "scipy", "fleet",
                                  "uncertainty"])
def test_rs_refusals_match_jax(path, solved):
    """The paths with no aux channel refuse the chain with the JAX
    package's error type and message. (The fleet's aux refusal is an
    ``UnsupportedChain`` that its mixed-chain fallback catches, in both
    packages: the error raised is the mixed layout's.)"""
    cams, tpl, dd = solved["cams"], solved["tpl"], solved["dd"]
    jhandler, port = _pair(cams, tpl, dd)
    if path in ("generic", "scipy"):
        def jax_call():
            jax_rba(jhandler, backend=path)

        def port_call():
            run_bundle_adjustment(port, backend=path, device="cpu")
    elif path == "fleet":
        from pycamset_tpu.optim.fleet import build_fleet_problem as jfleet
        from pycamset_tpu_torch.optim.fleet import build_fleet_problem

        def jax_call():
            jfleet([jhandler, jhandler])

        def port_call():
            build_fleet_problem([port, port], device="cpu")
    else:
        def jax_call():
            solved["jc"].calibration_uncertainty()

        def port_call():
            solved["pc"].calibration_uncertainty(device="cpu")
    with pytest.raises(Exception) as ref:
        jax_call()
    with pytest.raises(Exception) as got:
        port_call()
    assert type(got.value).__name__ == type(ref.value).__name__
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_rs_camset_both_ways(writer, solved, tmp_path):
    """An RS calibration's file, written by either package, loads in both:
    the handler class, its options and the detections survive."""
    path = tmp_path / "rs.camset"
    solved["jc" if writer == "jax" else "pc"].save(path)
    jback, pback = jax_load(path), load_CameraSet(path)
    assert type(pback.calibration_handler) is ph.RSTemplateBundleHandler
    assert type(jback.calibration_handler) is jh.RSTemplateBundleHandler
    for a, b in ((jback, pback),):
        ha, hb = a.calibration_handler, b.calibration_handler
        assert ha.problem_opts == hb.problem_opts
        assert np.array_equal(ha.detection.get_data(),
                              hb.detection.get_data())
        assert np.array_equal(a.calibration_params, b.calibration_params)
        for ca, cb in zip(a, b):
            assert np.array_equal(ca.intrinsic, cb.intrinsic)
            assert np.array_equal(ca.extrinsic, cb.extrinsic)
    x = np.asarray(pback.calibration_params)
    assert (pback.calibration_handler.get_readouts(x)
            == jback.calibration_handler.get_readouts(x))


def test_rs_handler_maker():
    """``problems.rs_handler``: the bench rig's cameras, readouts drawn in
    [0.5, 0.9], camera 0's pinned at its truth, seeded without PnP; its
    structured problem runs the forward-mode route (no kernel)."""
    handler, truth = problems.rs_handler(3, 6, grid=7)
    assert ((truth["readouts"] >= 0.5) & (truth["readouts"] <= 0.9)).all()
    assert handler.ref_readout == truth["readouts"][0]
    assert handler.initial_params is not None
    solve, residual_fn, x0 = build_structured_problem(handler, device="cpu")
    prob = solve.problem
    assert prob.uv.shape[-1] == 3 and prob.widths.a == 16
    assert prob.widths.b == 12
    x, res = solve(x0)
    assert int(res.status) in (1, 2)
    assert prob.rms_px(res.cost) < 0.36
