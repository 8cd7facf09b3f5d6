"""Port parity: the calibration planner (float64, CPU).

``pycamset_tpu_torch.calibration.plan`` against the JAX package's
``calibration/plan.py`` on the rigs of its own tests (``tests/
test_plan.py::_ring_rig``, ``_grid_target``): ``workspace_center``, the
synthetic detections and true poses (1e-9), the triangulation ellipsoid of
a narrow and a wide pair (1e-9 relative), ``plan_calibration`` with the
JAX package's PnP start (the same nit / nfev / status, every sigma and rms
to 1e-9 relative, the same report string), the OpenCV-free
``start="truth"`` at the same minimum, and the impossible-rig refusal.
"""
import numpy as np
import pytest
import torch

import pycamset_tpu.optim.driver as jdriver
from pycamset_tpu.calibration import plan as jplan
from pycamset_tpu.models.camera_set import CameraSet, make_cam_dict
from pycamset_tpu.utils.synthetic import look_at_extrinsic
from pycamset_tpu_torch.calibration import plan as pplan
from pycamset_tpu_torch.from_jax import camset_from_jax
from tests.test_plan import _grid_target, _ring_rig

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rig():
    cams = _ring_rig()
    return {"cams": cams, "pcams": camset_from_jax(cams),
            "tpl": _grid_target()}


def _rel(got, ref, tol=1e-9):
    assert abs(got - ref) <= tol * abs(ref) + 1e-300


def test_workspace_center_and_detections_match_jax(rig):
    np.testing.assert_allclose(pplan.workspace_center(rig["pcams"]),
                               jplan.workspace_center(rig["cams"]),
                               rtol=0, atol=1e-12)
    det, poses = jplan.synthesize_detections(rig["cams"], rig["tpl"], 6,
                                             noise_px=0.3, seed=3)
    pdet, pposes = pplan.synthesize_detections(
        rig["pcams"], rig["tpl"], 6, noise_px=0.3, seed=3, device="cpu")
    np.testing.assert_allclose(pposes, poses, rtol=0, atol=1e-12)
    assert pdet.get_data().shape == det.get_data().shape
    np.testing.assert_allclose(pdet.get_data(), det.get_data(), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("half_deg", [4, 40])
def test_triangulation_sigma_matches_jax(half_deg):
    k = np.array([[1500.0, 0, 800], [0, 1500.0, 600], [0, 0, 1]])
    half = np.deg2rad(half_deg)
    exts = [look_at_extrinsic(np.array([np.sin(half) * s, 0.0,
                                        -np.cos(half)]), np.zeros(3))
            for s in (-1, 1)]
    cams = CameraSet(camera_dict=make_cam_dict(
        ["l", "r"], exts, [k, k], [np.zeros(5)] * 2, [[1600, 1200]] * 2))
    ref = jplan._triangulation_sigma(cams, np.zeros(3), 0.3)
    got = pplan._triangulation_sigma(camset_from_jax(cams), np.zeros(3),
                                     0.3, device="cpu")
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def _same_report(got, ref, tol=1e-9):
    for key in ("n_ims", "noise_px", "n_detections"):
        assert got[key] == ref[key]
    for key in ("expected_rms_px", "pose_sigma_rot_rad", "pose_sigma_trans"):
        _rel(got[key], ref[key], tol)
    np.testing.assert_allclose(got["workspace_center"],
                               ref["workspace_center"], rtol=0, atol=1e-12)
    assert list(got["cameras"]) == list(ref["cameras"])
    for n, c in ref["cameras"].items():
        for key, v in c.items():
            _rel(got["cameras"][n][key], v, tol)
    for key, v in ref["triangulation_sigma"].items():
        _rel(got["triangulation_sigma"][key], v, 1e-6)


def test_plan_calibration_matches_jax(rig, monkeypatch):
    seen = {}
    run = jdriver.run_bundle_adjustment

    def spy(handler, *a, **k):
        seen["res"], cams = run(handler, *a, **k)
        return seen["res"], cams
    monkeypatch.setattr(jdriver, "run_bundle_adjustment", spy)
    ref = jplan.plan_calibration(rig["cams"], rig["tpl"], n_ims=16,
                                 noise_px=0.3, seed=0)
    monkeypatch.undo()
    got = pplan.plan_calibration(rig["pcams"], rig["tpl"], n_ims=16,
                                 noise_px=0.3, seed=0, device="cpu")
    res, jres = got["result"], seen["res"]
    assert (res.nit, res.nfev, res.status) == (int(jres.nit),
                                               int(jres.nfev),
                                               int(jres.status))
    _same_report(got, ref)
    # the triangulation line rounds to 4 decimals of a mm
    assert pplan.format_plan_report(got) == jplan.format_plan_report(ref)

    own = pplan.plan_calibration(rig["pcams"], rig["tpl"], n_ims=16,
                                 noise_px=0.3, seed=0, start="truth",
                                 device="cpu")
    assert own["result"].status in (1, 2, 3)
    _same_report(own, ref, tol=1e-4)


def test_impossible_rig_raises_in_both():
    e1 = look_at_extrinsic(np.array([0, 0, -1.0]), np.array([0, 0, -5.0]))
    e2 = look_at_extrinsic(np.array([0, 0, 1.0]), np.array([0, 0, 5.0]))
    k = np.array([[1500.0, 0, 800], [0, 1500.0, 600], [0, 0, 1]])
    cams = CameraSet(camera_dict=make_cam_dict(
        ["a", "b"], [e1, e2], [k, k], [np.zeros(5)] * 2,
        [[1600, 1200]] * 2))
    with pytest.raises(ValueError, match="shared view volume"):
        jplan.synthesize_detections(cams, _grid_target(), n_ims=5)
    with pytest.raises(ValueError, match="shared view volume"):
        pplan.synthesize_detections(camset_from_jax(cams), _grid_target(),
                                    n_ims=5, device="cpu")
    with pytest.raises(ValueError, match="unknown start"):
        pplan.plan_calibration(camset_from_jax(_ring_rig()), _grid_target(),
                               start="cv2", device="cpu")
