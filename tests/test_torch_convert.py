"""Port parity: camera model conversion (float64, CPU).

``pycamset_tpu_torch.calibration.convert`` against the JAX package's
``calibration/convert.py`` on the cameras of its own tests
(``tests/test_convert.py::_cam``): standard -> rational, rational ->
standard, standard -> fisheye, a wide fisheye -> standard (the warning in
both packages) and fisheye -> fisheye, and a two-camera rig; the same nit
and status, the fitted intrinsics to 1e-9 of their scale, rms / max to
1e-9 relative (1e-9 px absolute where the fit is exact), the same point
counts; the unknown-model refusal.
"""
import logging

import numpy as np
import pytest
import torch

from pycamset_tpu.calibration import convert as jconv
from pycamset_tpu.models.camera_set import CameraSet as JCameraSet
from pycamset_tpu_torch.calibration import convert as pconv
from pycamset_tpu_torch.from_jax import camset_from_jax
from tests.test_convert import _cam

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)


def _port_cam(cam):
    return camset_from_jax(JCameraSet(camera_dict={cam.name: cam}))[cam.name]


def _same_report(got, ref):
    assert (got["from"], got["to"]) == (ref["from"], ref["to"])
    assert (got["nit"], got["status"]) == (ref["nit"], ref["status"])
    assert (got["n_points"], got["n_dropped"]) == (ref["n_points"],
                                                   ref["n_dropped"])
    scale = np.abs(ref["intr"]).max()
    assert np.abs(got["intr"] - ref["intr"]).max() <= 1e-9 * scale
    for key in ("rms_px", "max_px"):
        assert abs(got[key] - ref[key]) <= 1e-9 * ref[key] + 1e-9


@pytest.mark.parametrize("src,to", [("standard", "rational"),
                                    ("rational", "standard"),
                                    ("standard", "fisheye"),
                                    ("fisheye", "standard"),
                                    ("fisheye", "fisheye")])
def test_convert_camera_model_matches_jax(src, to, caplog):
    cam = _cam(src)
    with caplog.at_level(logging.WARNING):
        ref_cam, ref = jconv.convert_camera_model(cam, to=to)
    jax_warned = "cannot fully express" in caplog.text
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        got_cam, got = pconv.convert_camera_model(_port_cam(cam), to=to,
                                                  device="cpu")
    assert ("cannot fully express" in caplog.text) == jax_warned
    assert jax_warned == (src == "fisheye" and to == "standard")
    _same_report(got, ref)
    np.testing.assert_allclose(got_cam.intrinsic, ref_cam.intrinsic,
                               rtol=1e-9)
    np.testing.assert_array_equal(got_cam.extrinsic, ref_cam.extrinsic)
    assert got_cam.distortion_coefs.size == ref_cam.distortion_coefs.size


def test_convert_camera_set_matches_jax():
    a, b = _cam("standard", seed=1), _cam("standard", seed=2)
    a.name, b.name = "a", "b"
    cams = JCameraSet(camera_dict={"a": a, "b": b})
    ref_set, ref = jconv.convert_camera_set(cams, to="rational")
    got_set, got = pconv.convert_camera_set(camset_from_jax(cams),
                                            to="rational", device="cpu")
    assert got_set.get_names() == ref_set.get_names()
    for n in ("a", "b"):
        _same_report(got[n], ref[n])
        np.testing.assert_array_equal(got_set[n].extrinsic,
                                      cams[n].extrinsic)


def test_unknown_target_raises_in_both():
    for mod, cam in ((jconv, _cam()), (pconv, _port_cam(_cam()))):
        with pytest.raises(ValueError, match="unknown target model"):
            mod.convert_camera_model(cam, to="nope")
