"""Port parity: the other camera models on the template user path.

For the rational (intrinsic width 12), thin-prism (16), tilted (18) and
fisheye (8) models, held against the JAX package on the CPU in float64:

- ``ops.distortion``: distortion and undistortion of normalized and pixel
  coordinates, with the coefficients broadcast per point, within 1e-12;
  ``ops.projection``: ``project_cam_points`` and ``intr9_from_k_dist``;
- ``analytic.projection_partials`` (the tilted model's dMt in closed form
  where the JAX package takes ``jax.jacfwd``) within 1e-9 of each output's
  scale, with a point on the optical axis for the fisheye;
- ``cuda_grams.pack_block_params`` (the JAX layout at each width, the
  tilted row with Mt, dMt/dtaux and dMt/dtauy) within 1e-12;
- a ``TemplateBundleHandler(options={"camera_model": m})`` on a 3-camera x
  4-image rig carried over from the JAX package's (its CameraSet and
  TargetDetection as numpy): the same layout and projection block, the
  same PnP start bit for bit, and the JAX handler's parameters and masks
  carried over (``from_jax.handler_pieces_from_numpy``) the port problem's; ``run_bundle_adjustment`` in both packages
  with the same ``nit``/``nfev``/``status`` and the cost within 1e-9
  relative; the returned cameras with the model's distortion width;
  ``.camset`` files of either package loaded by the other, the width kept;
  triangulation and projection through the solved cameras.

The Brown models' extra coefficients are loosely determined by four images,
so the solve crawls on to its default budget of 100 evaluations, where the
two packages' float64 roundings have grown apart to a few 1e-6 of the cost
(the trajectories diverge in a flat valley); with a budget of 25 (``BUDGET``)
both stop at the same step within 1e-10. The fisheye converges (status 1)
well inside it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pycamset_tpu.ops.distortion as jd
from pycamset_tpu.models.camera_set import CameraSet as JCameraSet
from pycamset_tpu.models.camera_set import make_cam_dict as j_make_cam_dict
from pycamset_tpu.models.detections import TargetDetection as JDetection
from pycamset_tpu.ops.projection import intr9_from_k_dist as j_intr9
from pycamset_tpu.ops.projection import project_cam_points as j_project
from pycamset_tpu.optim import analytic as ja
from pycamset_tpu.optim import handlers as jh_mod
from pycamset_tpu.optim.driver import run_bundle_adjustment as jax_rba
from pycamset_tpu.optim.pallas_grams import pack_block_params as j_pack
from pycamset_tpu.utils.general_utils import make_4x4h_tform
from pycamset_tpu.utils.saving import load_CameraSet as jax_load
from pycamset_tpu.utils.synthetic import make_synthetic_rig
from pycamset_tpu_torch.from_jax import (camset_from_numpy,
                                         detection_from_numpy,
                                         handler_pieces_from_numpy)
from pycamset_tpu_torch.ops import distortion as td
from pycamset_tpu_torch.ops.projection import intr9_from_k_dist as t_intr9
from pycamset_tpu_torch.ops.projection import project_cam_points as t_project
from pycamset_tpu_torch.optim import analytic as ta
from pycamset_tpu_torch.optim import cuda_grams as cg
from pycamset_tpu_torch.optim import handlers as ph
from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
from pycamset_tpu_torch.optim.structured_driver import (
    build_structured_problem)
from pycamset_tpu_torch.utils.saving import load_CameraSet

MODELS = ["rational", "thin_prism", "tilted", "fisheye"]
INTR_W = {"rational": 12, "thin_prism": 16, "tilted": 18, "fisheye": 8}
BUDGET = 25
NAMES = ["a", "b", "c"]


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _rig(model, n_ims=4, seed=7):
    return make_synthetic_rig(n_cams=3, n_ims=n_ims, grid=7, visibility=0.95,
                              noise_px=0.2, seed=seed, camera_model=model)


def _close(got, ref, tol, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-300)
    assert err <= tol, (what, err)


@pytest.mark.parametrize("model", ["standard"] + MODELS)
def test_distortion_matches_jax(model):
    rng = np.random.default_rng(3)
    dists = _rig(model)["intr"][:, 4:]          # three cameras' coefficients
    xy = rng.uniform(-0.45, 0.45, size=(3, 40, 2))
    xy[0, 0] = 0.0                              # the optical axis
    kmat = np.array([[1450.0, 0, 790], [0, 1460.0, 610], [0, 0, 1]])
    uv = xy * [1450.0, 1460.0] + [790, 610]
    for c, d in enumerate(dists):
        ref = np.asarray(jd.distort_normalized(jnp.asarray(xy[c]),
                                               jnp.asarray(d)))
        _close(td.distort_normalized(_t(xy[c]), _t(d)), ref, 1e-12, "xy_d")
        for iters in (8, 20):
            _close(td.undistort_normalized(_t(ref), _t(d), iters=iters),
                   jd.undistort_normalized(jnp.asarray(ref), jnp.asarray(d),
                                           iters=iters), 1e-12, "xy")
        _close(td.distort_pixels(_t(uv[c]), _t(kmat), _t(d)),
               jd.distort_pixels(jnp.asarray(uv[c]), jnp.asarray(kmat),
                                 jnp.asarray(d)), 1e-12, "uv_d")
        _close(td.undistort_pixels(_t(uv[c]), _t(kmat), _t(d)),
               jd.undistort_pixels(jnp.asarray(uv[c]), jnp.asarray(kmat),
                                   jnp.asarray(d)), 1e-12, "uv")
    # the coefficients broadcast per point (a rig's cameras at once)
    per_pt = np.repeat(dists[:, None], xy.shape[1], axis=1)
    got = td.distort_normalized(_t(xy), _t(per_pt)).numpy()
    for c, d in enumerate(dists):
        _close(got[c], jd.distort_normalized(jnp.asarray(xy[c]),
                                             jnp.asarray(d)), 1e-12, c)


def test_tilt_matrix_and_its_derivatives_match_jax():
    from jax import jacfwd
    for taux, tauy in ((0.01, -0.02), (0.3, 0.15), (0.0, 0.0)):
        ref = np.asarray(jd._tilt_matrix(taux, tauy))
        _close(td.tilt_matrix(_t(taux), _t(tauy)), ref, 1e-15)
        dref = np.asarray(jacfwd(lambda t: jd._tilt_matrix(t[0], t[1]))(
            jnp.asarray([taux, tauy])))
        for k, d in enumerate(td.tilt_matrix_jacobian(_t(taux), _t(tauy))):
            assert np.abs(d.numpy() - dref[..., k]).max() <= 1e-15
        xy = np.array([[0.1, -0.2], [0.3, 0.25]])
        _close(td.apply_tilt(_t(xy), _t(ref)),
               jd._apply_tilt(jnp.asarray(xy), jnp.asarray(ref)), 1e-15)


@pytest.mark.parametrize("model", MODELS)
def test_projection_matches_jax(model):
    rig = _rig(model)
    rng = np.random.default_rng(5)
    xc = rng.normal(size=(30, 3)) * 0.3 + [0, 0, 1.5]
    xc[0, :2] = 0.0                             # on the optical axis
    for intr in rig["intr"]:
        got = ta.projection_partials(_t(intr), _t(xc))
        ref = ja.projection_partials(jnp.asarray(intr), jnp.asarray(xc))
        for name, g, r in zip(("pred", "d_intr", "d_xc"), got, ref):
            _close(g.numpy(), r, 1e-9, name)
        _close(t_project(_t(intr), _t(xc)),
               j_project(jnp.asarray(intr), jnp.asarray(xc)), 1e-12)
    k = np.array([[1450.0, 0, 790], [0, 1460.0, 610], [0, 0, 1]])
    for n in (4, 5, 8, 12, 14):
        d = np.arange(1, 15) * 1e-3
        assert np.array_equal(t_intr9(_t(k), _t(d), n_dist=n).numpy(),
                              np.asarray(j_intr9(k, d, n_dist=n)))


@pytest.mark.parametrize("model", MODELS)
def test_pack_block_params_matches_jax(model):
    rig = _rig(model)
    iw = INTR_W[model]
    rng = np.random.default_rng(2)
    cam_b = np.concatenate([rig["intr"], rig["extr"]], axis=1)[
        rng.integers(0, 3, size=8)]
    cam_b[:, -6:-3] += rng.normal(size=(8, 3)) * 0.3
    im_b = rig["poses"][rng.integers(0, 4, size=8)]
    im_b[0] = 0.0                               # a zero rotation
    got = cg.pack_block_params(_t(cam_b), _t(im_b)).numpy()
    ref = np.asarray(j_pack(jnp.asarray(cam_b), jnp.asarray(im_b),
                            intr_w=iw))
    assert got.shape == ref.shape == (8, cg.packed_width(iw))
    assert np.abs(got - ref).max() <= 1e-12


def _jax_handler(model, rig):
    k = [np.array([[i[0], 0, i[1]], [0, i[2], i[3]], [0, 0, 1]])
         for i in rig["intr"]]
    ext = [make_4x4h_tform(e[:3], e[3:]) for e in rig["extr"]]
    cams = JCameraSet(camera_dict=j_make_cam_dict(
        NAMES, ext, k, [i[4:] for i in rig["intr"]], [[1600, 1200]] * 3))
    return jh_mod.TemplateBundleHandler(
        cams, jh_mod.FreePointTarget(rig["template"].reshape(1, -1, 3)),
        JDetection(cam_names=NAMES, data=rig["dd"]),
        options={"outliers": "n", "camera_model": model,
                 "max_nfev": BUDGET})


def _port_handler(jh):
    cams = jh.camset
    return ph.TemplateBundleHandler(
        camset_from_numpy(cams.get_names(), [c.extrinsic for c in cams],
                          [c.intrinsic for c in cams],
                          [c.distortion_coefs for c in cams],
                          [c.res for c in cams]),
        ph.FreePointTarget(jh.target.point_data),
        detection_from_numpy(jh.detection.cam_names, jh.detection.get_data(),
                             jh.detection.max_ims),
        options=dict(jh.problem_opts))


@pytest.fixture(scope="module", params=MODELS)
def solved(request):
    """Both packages' handlers of one rig and their solves."""
    model = request.param
    rig = _rig(model)
    jh = _jax_handler(model, rig)
    port = _port_handler(jh)
    x_jax, x_port = jh.get_initial_params(), port.get_initial_params()
    jax_res, jax_cams = jax_rba(jh, backend="structured")
    port_res, port_cams = run_bundle_adjustment(port, backend="structured",
                                                device="cpu")
    return dict(model=model, rig=rig, jh=jh, port=port, x_jax=x_jax,
                x_port=x_port, jax_res=jax_res, jax_cams=jax_cams,
                port_res=port_res, port_cams=port_cams)


def test_the_same_layout_and_start(solved):
    jh, port = solved["jh"], solved["port"]
    iw = INTR_W[solved["model"]]
    assert port.intr_width == jh.intr_width == iw
    assert port.bundlePrimitive.intr.shape == (3, iw)
    assert type(port.op_fun.blocks[0]).__name__ == type(
        jh.op_fun.blocks[0]).__name__
    assert port.op_fun.blocks[0].params.n == iw
    assert np.array_equal(solved["x_jax"], solved["x_port"])


def test_the_same_solve(solved):
    j, p = solved["jax_res"], solved["port_res"]
    assert (p.nit, p.nfev, p.status) == (j.nit, j.nfev, j.status)
    assert abs(p.cost - j.cost) <= 1e-9 * j.cost
    rms = np.sqrt(np.mean(np.asarray(p.fun) ** 2))
    assert rms < 2.0 * solved["rig"]["noise_px"]
    for name in ("x", "fun"):
        ref = np.asarray(j[name])
        assert np.abs(np.asarray(p[name]) - ref).max() <= (
            1e-6 * np.abs(ref).max())


def test_the_cameras_keep_the_model_width(solved):
    n_dist = INTR_W[solved["model"]] - 4
    for cj, cp in zip(solved["jax_cams"], solved["port_cams"]):
        assert np.ravel(cp.distortion_coefs).size == n_dist
        assert np.ravel(cj.distortion_coefs).size == n_dist
        for attr in ("intrinsic", "distortion_coefs", "extrinsic"):
            ref = np.asarray(getattr(cj, attr))
            assert np.abs(np.asarray(getattr(cp, attr)) - ref).max() <= (
                1e-6 * np.abs(ref).max())


def test_solved_cameras_project_and_triangulate_as_jax(solved):
    """The JAX package's solved cameras, carried over, project and
    triangulate (undistorting at the model's width) as they do there."""
    jc = solved["jax_cams"]
    port = camset_from_numpy(
        jc.get_names(), [c.extrinsic for c in jc], [c.intrinsic for c in jc],
        [c.distortion_coefs for c in jc], [c.res for c in jc])
    pts = solved["rig"]["template"][:10] + [0.0, 0.0, 0.05]
    got = port.project_points_to_all_cams(pts, device="cpu")
    ref = jc.project_points_to_all_cams(pts)
    for g, r in zip(got, ref):
        for name in g:
            _close(g[name], r[name], 1e-12, name)
    data = solved["jh"].get_detection_data(flatten=True)
    _close(port.multi_cam_triangulate(data, device="cpu"),
           jc.multi_cam_triangulate(data), 1e-9)


def _same_file(a, b, n_dist):
    assert a.get_names() == b.get_names()
    for ca, cb in zip(a, b):
        assert np.ravel(ca.distortion_coefs).size == n_dist
        for attr in ("intrinsic", "distortion_coefs", "extrinsic", "res"):
            assert np.array_equal(np.asarray(getattr(ca, attr)),
                                  np.asarray(getattr(cb, attr))), attr
    ha, hb = a.calibration_handler, b.calibration_handler
    assert ha.problem_opts == hb.problem_opts
    assert ha.intr_width == hb.intr_width
    assert np.array_equal(a.calibration_params, b.calibration_params)


def test_port_file_loads_in_jax_package(solved, tmp_path):
    path = tmp_path / "port.camset"
    solved["port_cams"].save(path)
    back = jax_load(path)
    assert type(back.calibration_handler).__module__ == (
        "pycamset_tpu.optim.handlers")
    n_dist = INTR_W[solved["model"]] - 4
    _same_file(back, load_CameraSet(path), n_dist)
    _same_file(back, solved["port_cams"], n_dist)


def test_jax_file_loads_in_port(solved, tmp_path):
    path = tmp_path / "jax.camset"
    solved["jax_cams"].save(path)
    back = load_CameraSet(path)
    assert isinstance(back.calibration_handler, ph.TemplateBundleHandler)
    n_dist = INTR_W[solved["model"]] - 4
    _same_file(back, jax_load(path), n_dist)
    _same_file(back, solved["jax_cams"], n_dist)


def test_jax_handler_pieces_carry_over(solved):
    """The JAX handler's start and masks at the model's intrinsic width,
    carried as numpy by ``from_jax.handler_pieces_from_numpy``, are the
    port's problem's."""
    port, jh = solved["port"], solved["jh"]
    prob = build_structured_problem(port, device="cpu")[0].problem
    prim = jh.bundlePrimitive
    full = prim.base_full()
    full[prim.unfixed_full()] = np.asarray(solved["x_jax"])
    start, colmask = handler_pieces_from_numpy(
        port.op_fun, full, prim.unfixed_full(), 3, prim.poses.shape[0],
        port.n_keys(), prob.blocks.n_ims, prob.mask.shape[1], "cpu",
        torch.float64)
    assert start.cam.shape == (3, INTR_W[solved["model"]] + 6)
    for a, b in zip(start, prob.x0):
        assert torch.equal(a, b)
    for a, b in zip(colmask, prob.colmask):
        assert torch.equal(a, b)
