"""Port parity: rig health and partial recalibration (float64, CPU).

``pycamset_tpu_torch.calibration.monitor`` against the JAX package's
``calibration/monitor.py`` on the rig of its own tests
(``tests/test_monitor.py::_rig``: 4 cameras, 10 images, grid 6, 0.2 px):

- ``rig_health`` of a rig with one camera bumped (``_bump``): the same
  ``drifted`` list, per-camera, per-image,
  leave-one-out and overall rms to 1e-9 relative, the poses to 1e-9;
- ``recalibrate_extrinsics`` of the bumped camera and
  ``recalibrate_intrinsics`` of a refocused one (the JAX package's PnP
  seed, ``start="pnp"``): the same nit / nfev / status (the JAX solve's
  result read through its ``run_bundle_adjustment``), the cameras to 1e-9
  of their scale, rms and deltas to 1e-9 relative;
- ``start="rig"`` (no OpenCV): the same minimum as the PnP-seeded solve;
- the refusals of both packages: an unknown camera, no anchor camera.
"""
import copy

import numpy as np
import pytest
import torch

import pycamset_tpu.optim.driver as jdriver
from pycamset_tpu.calibration import monitor as jmon
from pycamset_tpu_torch.calibration import monitor as pmon
from pycamset_tpu_torch.from_jax import camset_from_jax, detection_from_jax
from pycamset_tpu_torch.models.abstract_target import FreePointTarget
from tests.test_monitor import _bump, _rig

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rig():
    cams, det, target, truth = _rig()
    stale = _bump(cams, "cam2")
    lens = copy.deepcopy(cams)
    k = lens["cam1"].intrinsic.copy()
    k[0, 0] *= 1.01
    k[1, 1] *= 1.01
    lens["cam1"].intrinsic = k
    lens["cam1"]._update_state()
    return {"cams": cams, "det": det, "target": target, "stale": stale,
            "lens": lens, "pdet": detection_from_jax(det),
            "ptarget": FreePointTarget(np.asarray(target.point_data))}


def _close(got, ref, tol=1e-9):
    got, ref = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
    assert np.abs(got - ref).max() <= tol * max(np.abs(ref).max(), 1e-300)


def _same_dict(got, ref, tol=1e-9):
    assert list(got) == list(ref)
    for k in ref:
        if np.isnan(ref[k]):
            assert np.isnan(got[k])
        else:
            assert abs(got[k] - ref[k]) <= tol * abs(ref[k])


def test_rig_health_matches_jax(rig):
    ref = jmon.rig_health(rig["stale"], rig["det"], rig["target"])
    got = pmon.rig_health(camset_from_jax(rig["stale"]), rig["pdet"],
                          rig["ptarget"], device="cpu")
    assert got["drifted"] == ref["drifted"]
    assert got["drifted"] == ["cam2"]
    for key in ("per_camera_rms_px", "per_image_rms_px",
                "leave_one_out_rms_px"):
        _same_dict(got[key], ref[key])
    assert abs(got["overall_rms_px"] - ref["overall_rms_px"]) <= (
        1e-9 * ref["overall_rms_px"])
    np.testing.assert_allclose(got["poses"], ref["poses"], rtol=0,
                               atol=1e-9)


def _jax_recal(monkeypatch, fn, *args, **kw):
    """The JAX package's recalibration and its LM result (recorded at its
    ``run_bundle_adjustment``)."""
    seen = {}
    run = jdriver.run_bundle_adjustment

    def spy(handler, *a, **k):
        seen["res"], cams = run(handler, *a, **k)
        return seen["res"], cams
    monkeypatch.setattr(jdriver, "run_bundle_adjustment", spy)
    cams, rep = fn(*args, **kw)
    monkeypatch.undo()
    return cams, rep, seen["res"]


def _same_cams(got, ref, names):
    for n in names:
        _close(got[n].extrinsic, ref[n].extrinsic)
        _close(got[n].intrinsic, ref[n].intrinsic)
        _close(np.ravel(got[n].distortion_coefs),
               np.ravel(ref[n].distortion_coefs))


@pytest.mark.parametrize("mode", ["extrinsics", "intrinsics"])
def test_recalibrate_matches_jax(rig, monkeypatch, mode):
    src, cam, jfn, pfn = (
        ("stale", "cam2", jmon.recalibrate_extrinsics,
         pmon.recalibrate_extrinsics) if mode == "extrinsics" else
        ("lens", "cam1", jmon.recalibrate_intrinsics,
         pmon.recalibrate_intrinsics))
    ref_cams, ref_rep, ref_res = _jax_recal(
        monkeypatch, jfn, rig[src], rig["det"], rig["target"],
        refresh=[cam])
    got_cams, got_rep = pfn(camset_from_jax(rig[src]), rig["pdet"],
                            rig["ptarget"], refresh=[cam], device="cpu")
    res = got_rep["result"]
    assert (res.nit, res.nfev, res.status) == (
        int(ref_res.nit), int(ref_res.nfev), int(ref_res.status))
    assert abs(res.cost - ref_res.cost) <= 1e-9 * ref_res.cost
    names = rig["cams"].get_names()
    _same_cams(got_cams, ref_cams, names)
    assert abs(got_rep["rms_px"] - ref_rep["rms_px"]) <= (
        1e-9 * ref_rep["rms_px"])
    assert got_rep["refreshed"] == ref_rep["refreshed"]
    for key, d in ref_rep["deltas"][cam].items():
        assert abs(got_rep["deltas"][cam][key] - d) <= 1e-9 * abs(d) + 1e-12
    if mode == "extrinsics":
        assert got_rep["anchors"] == ref_rep["anchors"]
        true_ext = rig["cams"][cam].extrinsic
        assert np.abs(got_cams[cam].extrinsic - true_ext).max() < 1e-3
    else:
        assert abs(got_cams[cam].intrinsic[0, 0]
                   - rig["cams"][cam].intrinsic[0, 0]) < 1.0


def test_rig_start_reaches_the_pnp_minimum(rig):
    stale = camset_from_jax(rig["stale"])
    pnp, rep_p = pmon.recalibrate_extrinsics(
        stale, rig["pdet"], rig["ptarget"], refresh=["cam2"], device="cpu")
    own, rep_r = pmon.recalibrate_extrinsics(
        stale, rig["pdet"], rig["ptarget"], refresh=["cam2"], start="rig",
        device="cpu")
    assert rep_r["result"].status in (1, 2, 3)
    assert abs(rep_r["rms_px"] - rep_p["rms_px"]) <= 1e-6 * rep_p["rms_px"]
    _close(own["cam2"].extrinsic, pnp["cam2"].extrinsic, tol=1e-5)
    for n in ("cam0", "cam1", "cam3"):
        # pinned: the stored extrinsic through one Rodrigues round trip
        np.testing.assert_allclose(own[n].extrinsic, stale[n].extrinsic,
                                   rtol=0, atol=1e-12)


def test_refusals_match_jax(rig):
    stale = camset_from_jax(rig["stale"])
    for mod, cams, det, tgt, kw in (
            (jmon, rig["stale"], rig["det"], rig["target"], {}),
            (pmon, stale, rig["pdet"], rig["ptarget"], {"device": "cpu"})):
        with pytest.raises(ValueError, match="unknown cameras"):
            mod.recalibrate_extrinsics(cams, det, tgt, refresh=["nope"],
                                       **kw)
        with pytest.raises(ValueError, match="anchor"):
            mod.recalibrate_extrinsics(cams, det, tgt,
                                       refresh=list(cams.get_names()), **kw)
    with pytest.raises(ValueError, match="unknown start"):
        pmon.recalibrate_intrinsics(stale, rig["pdet"], rig["ptarget"],
                                    start="cv2", device="cpu")
