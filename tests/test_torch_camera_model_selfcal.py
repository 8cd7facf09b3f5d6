"""Port parity: the self-calibration and free-point user paths at the other
camera models.

For the rational (a = 18), thin-prism (22), tilted (24) and fisheye (14)
models, held against the JAX package on the CPU in float64:

- ``make_structured_neq`` of the self-calibration chain (Projection* +
  Extrinsic3D + RigidTform3d + FreePoint) and of the pose-free free-point
  chain (Projection* + Extrinsic3D + FreePoint) at the same pieces and
  masks, within 1e-9 of each field's max-abs; each chain takes the fused
  family (8 images, over Kernel C) at two models and the per-block one (5
  images, over Kernel D) at the other two;
- ``SelfBundleHandler(options={"camera_model": m})`` warm-started from the
  port's template calibration of a 3 x 4 rig (its ``.camset`` file loaded
  by both packages: the file carries the model's distortion width) and
  solved by ``run_stereo_calibration`` in both packages: the same ``nit``,
  ``nfev`` and ``status``, the cost within 1e-9 relative, the recovered
  target; the self-calibrated files loading in both packages;
- the JAX package's own rational self-calibration scenario
  (``tests/test_rational_model.py::test_rational_self_calibration_end_to_end``)
  through both packages, with its checks;
- ``FreePointBundleHandler`` at each model on the wand set-up of
  ``tests/test_torch_freepoint.py`` (its ``_jax_wand_handler`` on the
  model's rig, lenses fixed at the truth): the same solve, and its file in
  both packages.

The Brown models' self-cal solves crawl through a flat valley where float64
rounding grows between the two packages (ROADMAP Queue C 6, settled as
rounding by ``tools/brown_trajectory_neq.py``: on the rational scenario's
rig the two packages' normal equations agree at every iterate of the JAX
trajectory to the rounding of one ulp of x, and the JAX package parts
from itself by 1.9e-3 of the cost at 100 evaluations from starts one ulp
apart, the port from it by 1.4e-3). The packages' costs part by 1.5e-13
of the cost at 10 evaluations there, 4.4e-10 at 15 and 2.8e-8 at 20. So
those self-cal solves take a budget of 10 evaluations (``BUDGET``) where
they are compared; the fisheye's and the free-point solves, which
converge, run their full budget, and the JAX test's own checks of the
rational scenario run on the port's solve at the full budget.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycamset_tpu.calibration.camera_calibrator import (
    run_stereo_calibration as jax_rsc)
from pycamset_tpu.models.camera_set import CameraSet as JCameraSet
from pycamset_tpu.models.camera_set import make_cam_dict
from pycamset_tpu.models.detections import TargetDetection as JDetection
from pycamset_tpu.optim import handlers as jh
from pycamset_tpu.optim import structured as js
from pycamset_tpu.optim.driver import run_bundle_adjustment as jax_rba
from pycamset_tpu.utils.general_utils import make_4x4h_tform
from pycamset_tpu.utils.saving import load_CameraSet as jax_load
from pycamset_tpu.utils.synthetic import make_synthetic_rig
from pycamset_tpu_torch.calibration.camera_calibrator import (
    run_stereo_calibration)
from pycamset_tpu_torch.from_jax import pieces_from_numpy, tensor_from_numpy
from pycamset_tpu_torch.optim import handlers as ph
from pycamset_tpu_torch.optim import structured as ts
from pycamset_tpu_torch.optim.chain import OptimFunction
from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
from pycamset_tpu_torch.utils.saving import load_CameraSet
from test_torch_camera_model_selfcal_grams import _block_inputs
from test_torch_freepoint import _jax_wand_handler, _port_of
from test_torch_selfcal_handlers import _carry

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)

MODELS = ["rational", "thin_prism", "tilted", "fisheye"]
INTR_W = {"rational": 12, "thin_prism": 16, "tilted": 18, "fisheye": 8}
# the Brown models' self-cal budget where the packages are compared (see
# the module docstring)
BUDGET = 10
NAMES = ["a", "b", "c"]


def _assert_close(got, ref, tol, name):
    got, ref = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    if ref.size:
        err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)
        assert err <= tol, (name, err)


def _t(a):
    return tensor_from_numpy(a, "cpu", torch.float64)


@pytest.mark.parametrize("model,chain,n_ims", [
    ("rational", "selfcal", 8), ("thin_prism", "selfcal", 5),
    ("tilted", "selfcal", 5), ("fisheye", "selfcal", 8),
    ("rational", "freepoint", 5), ("thin_prism", "freepoint", 8),
    ("tilted", "freepoint", 8), ("fisheye", "freepoint", 5)])
def test_make_structured_neq_matches_jax(model, chain, n_ims):
    """Both packages' structured normal equations at the same pieces (a
    lens column fixed on camera 1, pose 0 fixed, the key gauge)."""
    d = _block_inputs(model, free_point=chain == "freepoint", n_ims=n_ims)
    n_cams, a = d["n_cams"], d["a"]
    b = 6 if chain == "selfcal" else 0
    cam = d["cam_b"][::n_ims]
    im = d["im_b"][:n_ims]
    cm_cam = np.ones((n_cams, a))
    cm_cam[1, 4] = 0.0
    cm_im = np.ones((n_ims, b))
    cm_im[:1] = 0.0
    kw = dict(loss="huber", f_scale=2.0, loss_semantics="observation")
    jneq = js.make_structured_neq(d["op_fun"], d["widths"], n_cams, n_ims,
                                  **kw)(
        js.ParamPieces(jnp.asarray(cam), jnp.asarray(im),
                       jnp.asarray(d["keyp"])),
        jnp.asarray(d["uv"]), jnp.asarray(d["mask"]),
        jnp.zeros((d["k_pad"], 3)),
        js.ParamPieces(cm_cam, cm_im, d["kmask"]))
    widths = ts.GroupWidths(a, b, 3)
    top = OptimFunction([ph._projection_block(model), *_port_tail(chain)])
    assert ts.chain_widths(top) == widths
    fused = ts.resolve_fused_grams(top, widths, n_cams, n_ims) is not None
    assert fused == (n_ims == 8)
    f64 = torch.float64
    tneq = ts.make_structured_neq(top, widths, n_cams, n_ims, **kw)(
        pieces_from_numpy(cam, im, d["keyp"], "cpu", f64), _t(d["uv"]),
        _t(d["mask"]), torch.zeros(d["k_pad"], 3, dtype=f64),
        pieces_from_numpy(cm_cam, cm_im, d["kmask"], "cpu", f64))
    for name, g, r in zip(js.NormalEq._fields, tneq, jneq):
        _assert_close(g.numpy(), r, 1e-9, name)


def _port_tail(chain):
    from pycamset_tpu_torch.optim import blocks as tb
    if chain == "selfcal":
        return [tb.Extrinsic3D(), tb.RigidTform3d(), tb.FreePoint()]
    return [tb.Extrinsic3D(), tb.FreePoint()]


def _jax_cams(rig):
    k = [np.array([[i[0], 0, i[1]], [0, i[2], i[3]], [0, 0, 1]])
         for i in rig["intr"]]
    ext = [make_4x4h_tform(e[:3], e[3:]) for e in rig["extr"]]
    return JCameraSet(camera_dict=make_cam_dict(
        NAMES, ext, k, [i[4:] for i in rig["intr"]], [[1600, 1200]] * 3))


@contextlib.contextmanager
def _recorded(module, results: list):
    """A context in which ``module.run_bundle_adjustment`` (what its
    ``run_stereo_calibration`` calls) appends each solve's result to
    ``results``."""
    orig = module.run_bundle_adjustment

    def spy(*args, **kw):
        out = orig(*args, **kw)
        results.append(out[0])
        return out

    module.run_bundle_adjustment = spy
    try:
        yield
    finally:
        module.run_bundle_adjustment = orig


@pytest.fixture(scope="module", params=MODELS)
def two_stage(request, tmp_path_factory):
    """The port's template stage of a 3 x 4 rig at the model (PnP-seeded,
    ``run_stereo_calibration``), its ``.camset`` file loaded by both
    packages; then each package's self-cal stage warm-started from its
    loaded set, through run_stereo_calibration, each solve's result
    recorded."""
    import pycamset_tpu.calibration.camera_calibrator as jcc
    import pycamset_tpu_torch.calibration.camera_calibrator as pcc
    model = request.param
    rig = make_synthetic_rig(n_cams=3, n_ims=4, grid=5, visibility=0.95,
                             noise_px=0.2, seed=7, camera_model=model)
    opts = {"outliers": "n", "verbosity": 0, "camera_model": model}
    if model != "fisheye":
        opts["max_nfev"] = BUDGET
    jtarget = jh.FreePointTarget(rig["template"].reshape(1, -1, 3))
    jdet = JDetection(cam_names=NAMES, data=rig["dd"])
    pcams, ptarget, pdet = _carry(_jax_cams(rig), jtarget, jdet)
    tpl = run_stereo_calibration(pcams, pdet, ptarget, save=False,
                                 problem_options=dict(opts), device="cpu")
    path = tmp_path_factory.mktemp(model) / "template.camset"
    tpl.save(path)
    ptemplate, jtemplate = load_CameraSet(path), jax_load(path)
    assert type(jtemplate.calibration_handler) is jh.TemplateBundleHandler
    pth, jth = ptemplate.calibration_handler, jtemplate.calibration_handler
    jself = jh.SelfBundleHandler(jtemplate, jth.target, jth.detection,
                                 options=dict(opts))
    jself.set_from_templated_camset(jtemplate)
    pself = ph.SelfBundleHandler(ptemplate, pth.target, pth.detection,
                                 options=dict(opts))
    pself.set_from_templated_camset(ptemplate)
    x0 = (np.array(jself.initial_params), np.array(pself.initial_params))
    results = []
    with _recorded(jcc, results):
        jfinal = jax_rsc(jtemplate, jth.detection, jth.target,
                         param_handler=jself, save=False)
    with _recorded(pcc, results):
        pfinal = run_stereo_calibration(ptemplate, pth.detection,
                                        pth.target, param_handler=pself,
                                        save=False, device="cpu")
    return dict(model=model, rig=rig, jself=jself, pself=pself, x0=x0,
                jfinal=jfinal, pfinal=pfinal, ptemplate=ptemplate,
                jres=results[0], pres=results[1])


def test_selfcal_two_stage_matches_jax(two_stage):
    """The same warm start bit for bit; the solved parameters, cameras and
    recovered target within 1e-6 of their scale (the flat valley moves x
    more than the cost: the cost is held to 1e-9 below)."""
    model = two_stage["model"]
    x0_jax, x0_port = two_stage["x0"]
    assert np.array_equal(x0_port, x0_jax)
    jself, pself = two_stage["jself"], two_stage["pself"]
    assert pself.intr_width == jself.intr_width == INTR_W[model]
    assert type(pself.op_fun.blocks[0]).__name__ == type(
        jself.op_fun.blocks[0]).__name__
    jf, pf = two_stage["jfinal"], two_stage["pfinal"]
    _assert_close(pf.calibration_params, jf.calibration_params, 1e-6, "x")
    for cj, cp in zip(jf, pf):
        assert np.ravel(cp.distortion_coefs).size == INTR_W[model] - 4
        for attr in ("intrinsic", "distortion_coefs", "extrinsic"):
            _assert_close(getattr(cp, attr), getattr(cj, attr), 1e-6, attr)
    _assert_close(pself.get_updated_target(pf.calibration_params),
                  jself.get_updated_target(np.asarray(
                      jf.calibration_params)), 1e-6, "target")
    # the self-calibration fits at least as well as the template stage
    rms = [np.sqrt(np.mean(np.asarray(c.calibration_result) ** 2))
           for c in (two_stage["ptemplate"], pf)]
    assert rms[1] <= rms[0] + 1e-12


def test_selfcal_solve_counts_match_jax(two_stage):
    """nit, nfev, status and the cost of the self-cal solve that
    run_stereo_calibration ran in each package."""
    jres, pres = two_stage["jres"], two_stage["pres"]
    assert (pres.nit, pres.nfev, pres.status) == (jres.nit, jres.nfev,
                                                  jres.status)
    assert pres.status in ((1, 2) if two_stage["model"] == "fisheye"
                           else (1, 2, 4))
    assert abs(pres.cost - jres.cost) <= 1e-9 * jres.cost
    assert np.array_equal(pres.x, two_stage["pfinal"].calibration_params)


def test_selfcal_files_load_in_both_packages(two_stage, tmp_path):
    n_dist = INTR_W[two_stage["model"]] - 4
    for name, cams in (("port", two_stage["pfinal"]),
                       ("jax", two_stage["jfinal"])):
        path = tmp_path / f"{name}.camset"
        cams.save(path)
        back, jback = load_CameraSet(path), jax_load(path)
        assert type(back.calibration_handler) is ph.SelfBundleHandler
        assert type(jback.calibration_handler) is jh.SelfBundleHandler
        assert back.calibration_handler.intr_width == n_dist + 4
        for ca, cb in zip(back, jback):
            assert np.ravel(ca.distortion_coefs).size == n_dist
            for attr in ("intrinsic", "distortion_coefs", "extrinsic"):
                assert np.array_equal(np.asarray(getattr(ca, attr)),
                                      np.asarray(getattr(cb, attr)))
        assert np.array_equal(back.calibration_params,
                              np.asarray(cams.calibration_params))


def test_jax_rational_self_calibration_scenario_in_both_packages():
    """``tests/test_rational_model.py``'s rational self-calibration (3 x 8,
    grid 5, noise 0.1 px, seed 5; PnP seeds in both packages, the same
    start): its checks on the port's solve, and the two packages' solves
    alike at ``BUDGET`` evaluations."""
    rig = make_synthetic_rig(n_cams=3, n_ims=8, grid=5, visibility=0.95,
                             noise_px=0.1, seed=5, camera_model="rational")
    opts = {"outliers": "n", "camera_model": "rational"}
    jtarget = jh.FreePointTarget(rig["template"].reshape(1, -1, 3))
    jdet = JDetection(cam_names=NAMES, data=rig["dd"])
    jcams = _jax_cams(rig)
    jself = jh.SelfBundleHandler(jcams, jtarget, jdet, options=dict(opts))
    pself = ph.SelfBundleHandler(*_carry(jcams, jtarget, jdet),
                                 options=dict(opts))
    assert np.array_equal(pself.get_initial_params(),
                          np.asarray(jself.get_initial_params()))
    # the JAX test's checks, on the port's solve at the default budget
    pres, pcams = run_bundle_adjustment(pself, device="cpu")
    assert np.sqrt(np.mean(np.asarray(pres.fun) ** 2)) < 0.15
    pts = pself.get_updated_target(pres.x)
    assert np.abs(pts - rig["template"]).max() < 5e-4  # metres
    assert np.reshape(pcams["a"].distortion_coefs, -1).size == 8
    # the two packages alike at BUDGET evaluations (the module docstring)
    for h in (jself, pself):
        h.problem_opts["max_nfev"] = BUDGET
    jres, _ = jax_rba(jself)
    pres, _ = run_bundle_adjustment(pself, device="cpu")
    assert (pres.nit, pres.nfev, pres.status) == (jres.nit, jres.nfev,
                                                  jres.status)
    assert abs(pres.cost - jres.cost) <= 1e-9 * jres.cost


@pytest.mark.parametrize("model", MODELS)
def test_freepoint_handler_matches_jax(model, tmp_path):
    """``tests/test_torch_freepoint.py``'s wand set-up on the model's rig
    (every lens fixed at the truth, camera 0 the identity, the largest
    start coordinate pinned): the same solve, and its file in both
    packages."""
    options = {"camera_model": model}
    jhandler, pin = _jax_wand_handler(options)
    port = _port_of(jhandler, pin, options)
    x_jax = np.array(jhandler.get_initial_params())
    assert np.abs(np.array(port.get_initial_params()) - x_jax).max() <= (
        1e-12 * np.abs(x_jax).max())
    port.set_initial_params(x_jax.copy())
    assert port.op_fun.blocks[0].params.n == INTR_W[model]
    jres, jcams = jax_rba(jhandler, backend="structured")
    pres, pcams = run_bundle_adjustment(port, backend="structured",
                                        device="cpu")
    assert (pres.nit, pres.nfev, pres.status) == (jres.nit, jres.nfev,
                                                  jres.status)
    assert pres.status in (1, 2)
    assert abs(pres.cost - jres.cost) <= 1e-9 * jres.cost
    _assert_close(port.get_updated_points(pres.x),
                  jhandler.get_updated_points(np.asarray(jres.x)), 1e-9,
                  "points")
    assert np.array_equal(pcams[0].extrinsic, np.eye(4))
    for name, cams in (("port", pcams), ("jax", jcams)):
        path = tmp_path / f"{name}.camset"
        cams.save(path)
        back, jback = load_CameraSet(path), jax_load(path)
        assert isinstance(back.calibration_handler,
                          ph.FreePointBundleHandler)
        assert isinstance(jback.calibration_handler,
                          jh.FreePointBundleHandler)
        for ca, cb in zip(back, jback):
            assert np.ravel(ca.distortion_coefs).size == INTR_W[model] - 4
            for attr in ("intrinsic", "distortion_coefs", "extrinsic"):
                assert np.array_equal(np.asarray(getattr(ca, attr)),
                                      np.asarray(getattr(cb, attr)))
