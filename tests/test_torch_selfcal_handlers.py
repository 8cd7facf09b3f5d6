"""Port parity: the self-calibration handler and its user path.

The JAX package's flow for a target it does not trust
(``pycamset_tpu/__main__.py:1167-1181``): calibrate on the template, then
``SelfBundleHandler(camset, target, detection)``,
``set_from_templated_camset(cams)`` and ``run_stereo_calibration(...,
param_handler=handler)``. Both packages run it in float64 on the CPU from
the JAX package's own rig helper (``tests/test_fleet.py::_template_handler``:
3 cameras x 6 images, grid 5, seed 5; each template stage seeded by its own
PnP, the same OpenCV calls), the port's inputs carried over as numpy:

- the gauge: ``find_not_colinear_pts`` and the seventh coordinate picked
  from the normal, the unseen-feature freezing, custom pins with and
  without ``always_correct_gauge``: the same indices and masks, bit for
  bit, and the same warm start;
- the self-cal solve: the same ``nit``, ``nfev`` and ``status``, the cost
  within 1e-9 relative, the parameters, residuals, cameras and the
  recovered target (``get_updated_target``) within 1e-9 of their scale;
- ``apply_gauge_transform`` (host numpy and scipy) within 1e-9, with and
  without ``scale_bars`` and with a target's ``valid_map`` of pairs;
- a ``.camset`` file written by either package loads in the other with its
  handler class, and a JAX template file warm-starts the port's handler.
"""
import numpy as np
import pytest
import torch

from pycamset_tpu.calibration.camera_calibrator import (
    run_stereo_calibration as jax_rsc)
from pycamset_tpu.optim import handlers as jh
from pycamset_tpu.utils.saving import load_CameraSet as jax_load
from pycamset_tpu_torch.calibration.camera_calibrator import (
    run_stereo_calibration)
from pycamset_tpu_torch.from_jax import (camset_from_numpy,
                                         detection_from_numpy)
from pycamset_tpu_torch.optim import handlers as ph
from pycamset_tpu_torch.utils.saving import load_CameraSet
from test_fleet import _template_handler

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)

OPTS = {"outliers": "n", "verbosity": 0}


def _carry(jcams, jtarget, jdet):
    """A JAX CameraSet, target and detection as the port's."""
    return (camset_from_numpy(jcams.get_names(),
                              [c.extrinsic for c in jcams],
                              [c.intrinsic for c in jcams],
                              [c.distortion_coefs for c in jcams],
                              [c.res for c in jcams]),
            ph.FreePointTarget(jtarget.point_data),
            detection_from_numpy(jdet.cam_names, jdet.get_data(),
                                 jdet.max_ims))


def _assert_close(got, ref, tol, name):
    got, ref = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    assert np.abs(got - ref).max() <= tol * (np.abs(ref).max() + 1e-30), name


def _inputs(depth=0.0, drop_key=None):
    """The JAX rig helper's CameraSet, target and detection (a non-planar
    target with ``depth``; every detection of ``drop_key`` removed)."""
    jhandler, _ = _template_handler(n_cams=3, n_ims=6, grid=5, seed=5)
    target = jhandler.target
    if depth:
        pts = target.point_data.copy()
        pts[..., 2] = np.random.default_rng(8).uniform(
            -depth, depth, size=pts.shape[:-1])
        target = jh.FreePointTarget(pts)
    det = jhandler.detection
    if drop_key is not None:
        data = det.get_data()
        det = type(det)(det.cam_names, data[data[:, 2] != drop_key],
                        det.max_ims)
    return jhandler.camset, target, det


def _pins(n_pts):
    unfixed = np.ones(3 * n_pts, dtype=bool)
    unfixed[:9] = False
    return unfixed


@pytest.mark.parametrize("case", ["planar", "non_planar", "unseen",
                                  "custom_pins", "custom_pins_aligned"])
def test_gauge_indices_and_masks_match_jax(case):
    jcams, jtarget, jdet = _inputs(
        depth=0.01 if case == "non_planar" else 0.0,
        drop_key=7 if case == "unseen" else None)
    kw = {}
    if case.startswith("custom_pins"):
        kw = dict(bundle_points_unfixed=_pins(25),
                  always_correct_gauge=case.endswith("aligned"))
    jself = jh.SelfBundleHandler(jcams, jtarget, jdet, options=OPTS, **kw)
    pself = ph.SelfBundleHandler(*_carry(jcams, jtarget, jdet),
                                 options=OPTS, **kw)
    assert pself.fixed_inds == jself.fixed_inds
    assert pself.correct_gauge == jself.correct_gauge
    assert np.array_equal(pself.feat_unfixed, jself.feat_unfixed)
    assert np.array_equal(pself.visible_feature_mask,
                          jself.visible_feature_mask)
    for name in ("unfixed_full", "base_full"):
        assert np.array_equal(getattr(pself.bundlePrimitive, name)(),
                              getattr(jself.bundlePrimitive, name)()), name
    assert pself.template_table() is None
    if case == "unseen":
        assert not pself.feat_unfixed[21:24].any()
    if case == "planar":
        # planar z = 0 grid: the seventh pinned coordinate is p2's z
        i2 = pself.fixed_inds[2]
        assert not pself.feat_unfixed[3 * i2 + 2]
        assert pself.feat_unfixed[3 * i2:3 * i2 + 2].all()


def test_find_not_colinear_pts_matches_jax():
    rng = np.random.default_rng(4)
    line = np.outer(np.arange(6.0), [1.0, 2.0, 0.5])
    for pts in (line[:, :] + 0.0, np.vstack([line, rng.normal(size=(3, 3))]),
                rng.normal(size=(8, 3))):
        try:
            ref = jh.find_not_colinear_pts(pts)
        except ValueError:
            with pytest.raises(ValueError, match="colinear"):
                ph.find_not_colinear_pts(pts)
            continue
        assert ph.find_not_colinear_pts(pts) == ref


@pytest.fixture(scope="module")
def two_stage():
    """Both packages' template stage, then the self-cal stage warm-started
    from it, through run_stereo_calibration."""
    jcams, jtarget, jdet = _inputs()
    jtemplate = jax_rsc(jcams, jdet, jtarget, save=False,
                        problem_options=dict(OPTS))
    pcams, ptarget, pdet = _carry(jcams, jtarget, jdet)
    ptemplate = run_stereo_calibration(pcams, pdet, ptarget, save=False,
                                       problem_options=dict(OPTS),
                                       device="cpu")
    jself = jh.SelfBundleHandler(jtemplate, jtarget, jdet, options=OPTS)
    jself.set_from_templated_camset(jtemplate)
    pself = ph.SelfBundleHandler(ptemplate, ptarget, pdet, options=OPTS)
    pself.set_from_templated_camset(ptemplate)
    x0 = (np.array(jself.initial_params), np.array(pself.initial_params))
    jfinal = jax_rsc(jtemplate, jdet, jtarget, param_handler=jself,
                     save=False)
    pfinal = run_stereo_calibration(ptemplate, pdet, ptarget,
                                    param_handler=pself, save=False,
                                    device="cpu")
    return dict(jtemplate=jtemplate, ptemplate=ptemplate, jself=jself,
                pself=pself, x0=x0, jfinal=jfinal, pfinal=pfinal)


def test_two_stage_flow_matches_jax(two_stage):
    jt, pt = two_stage["jtemplate"], two_stage["ptemplate"]
    assert np.array_equal(jt.calibration_params, pt.calibration_params) or (
        np.abs(pt.calibration_params - jt.calibration_params).max()
        <= 1e-9 * np.abs(jt.calibration_params).max())
    x0_jax, x0_port = two_stage["x0"]
    _assert_close(x0_port, x0_jax, 1e-9, "warm start")
    jf, pf = two_stage["jfinal"], two_stage["pfinal"]
    jres = jf.calibration_handler, pf.calibration_handler
    assert jres[0] is two_stage["jself"] and jres[1] is two_stage["pself"]
    _assert_close(pf.calibration_params, jf.calibration_params, 1e-9, "x")
    _assert_close(pf.calibration_result, jf.calibration_result, 1e-9, "fun")
    for cj, cp in zip(jf, pf):
        for attr in ("intrinsic", "distortion_coefs", "extrinsic"):
            _assert_close(getattr(cp, attr), getattr(cj, attr), 1e-9, attr)
    _assert_close(
        two_stage["pself"].get_updated_target(pf.calibration_params),
        two_stage["jself"].get_updated_target(
            np.asarray(jf.calibration_params)), 1e-9, "target")
    # the self-calibration fits at least as well as the template stage
    rms = [np.sqrt(np.mean(np.asarray(c.calibration_result) ** 2))
           for c in (pt, pf)]
    assert rms[1] <= rms[0] + 1e-12


def test_selfcal_solve_counts_match_jax(two_stage):
    """nit, nfev, status and the cost, read back from the history each
    package attaches."""
    from pycamset_tpu.optim.driver import run_bundle_adjustment as jax_rba
    from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
    jself, pself = two_stage["jself"], two_stage["pself"]
    jres, _ = jax_rba(jself)
    pres, _ = run_bundle_adjustment(pself, device="cpu")
    assert (pres.nit, pres.nfev, pres.status) == (jres.nit, jres.nfev,
                                                  jres.status)
    assert pres.status in (1, 2)
    assert abs(pres.cost - jres.cost) <= 1e-9 * jres.cost


@pytest.mark.parametrize("anchor", ["pitch", "scale_bars", "valid_pairs"])
def test_apply_gauge_transform_matches_jax(two_stage, anchor):
    jself, pself = two_stage["jself"], two_stage["pself"]
    x = np.asarray(two_stage["jfinal"].calibration_params)
    saved = (dict(jself.problem_opts), dict(pself.problem_opts),
             jself.target.valid_map, pself.target.valid_map)
    try:
        if anchor == "scale_bars":
            bars = [(0, 4, 0.0801), (0, 20, 0.0801), (6, 24, 0.0850)]
            jself.problem_opts["scale_bars"] = bars
            pself.problem_opts["scale_bars"] = bars
        if anchor == "valid_pairs":
            pairs = np.array([[0, 1], [1, 2], [5, 10], [12, 18]])
            jself.target.valid_map = pairs
            pself.target.valid_map = pairs
        jmodel = [np.array(m) for m in
                  jself.bundlePrimitive.return_bundle_primitives(x)]
        pmodel = [np.array(m) for m in
                  pself.bundlePrimitive.return_bundle_primitives(x)]
        # apply_gauge_transform writes into the primitive's pose and
        # extrinsic arrays (in both packages), so the fixed entries carry
        # the rounding of the earlier alignments
        for a, b in zip(pmodel, jmodel):
            _assert_close(a, b, 1e-12, "model")
        got = pself.apply_gauge_transform(*pmodel)
        ref = jself.apply_gauge_transform(*jmodel)
        for name, g, r in zip(("proj", "extr", "poses", "points"), got, ref):
            _assert_close(g, r, 1e-9, name)
        _assert_close(pself.get_updated_target(x),
                      jself.get_updated_target(x), 1e-9, "target")
        if anchor == "scale_bars":
            pts = pself.get_updated_target(x)
            assert abs(np.linalg.norm(pts[0] - pts[4]) - 0.0801) < 1e-3
    finally:
        (jself.problem_opts, pself.problem_opts, jself.target.valid_map,
         pself.target.valid_map) = saved


def test_selfcal_files_load_in_both_packages(two_stage, tmp_path):
    for name, cams in (("port", two_stage["pfinal"]),
                       ("jax", two_stage["jfinal"])):
        path = tmp_path / f"{name}.camset"
        cams.save(path)
        back, jback = load_CameraSet(path), jax_load(path)
        assert type(back.calibration_handler) is ph.SelfBundleHandler
        assert type(jback.calibration_handler) is jh.SelfBundleHandler
        for ca, cb in zip(back, jback):
            for attr in ("intrinsic", "distortion_coefs", "extrinsic"):
                assert np.array_equal(np.asarray(getattr(ca, attr)),
                                      np.asarray(getattr(cb, attr)))
        assert np.array_equal(back.calibration_params,
                              np.asarray(cams.calibration_params))
        assert np.array_equal(back.calibration_handler.feat_unfixed,
                              jback.calibration_handler.feat_unfixed)


def test_jax_template_file_warm_starts_the_port(two_stage, tmp_path):
    """A template calibration saved by the JAX package loads in the port
    as a TemplateBundleHandler's, which set_from_templated_camset takes;
    a self-calibrated set it refuses only if it is no template one."""
    path = tmp_path / "template.camset"
    two_stage["jtemplate"].save(path)
    back = load_CameraSet(path)
    assert type(back.calibration_handler) is ph.TemplateBundleHandler
    pself = ph.SelfBundleHandler(back, back.calibration_handler.target,
                                 back.calibration_handler.detection,
                                 options=OPTS)
    pself.set_from_templated_camset(back)
    _assert_close(pself.initial_params, two_stage["x0"][0], 0.0, "x0")
    bare = camset_from_numpy(["a"], [np.eye(4)], [np.eye(3)],
                             [np.zeros(5)], [[10, 10]])
    bare.calibration_handler = None
    with pytest.raises(ValueError, match="not a templated"):
        pself.set_from_templated_camset(bare)
