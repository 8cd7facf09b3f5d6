"""Port parity: target poses on a fixed rig (float64, CPU).

``pycamset_tpu_torch.optim.find_target`` against the JAX package's
``optim/find_target.py`` on the rig of ``tests/test_periphery.py``'s
fixed-camera test (3 cameras, 6 images, grid 5, seed 9):

- ``estimate_poses_with_fixed_cameras`` from the PnP start: the poses to
  1e-9, the same nit / nfev / status, the residuals to 1e-9;
- the distortion width -> camera model inference of
  ``FixedCameraPoseHandler`` at the standard, rational, thin-prism and
  tilted widths (and the fisheye's 4), one parametrised test;
- ``start="rig"`` (no OpenCV: the port's tracker seeds the poses) and a
  caller's seed poses: the PnP start's poses to 1e-8 (0.2 px of noise).
"""
import numpy as np
import pytest
import torch

from pycamset_tpu.models.camera_set import CameraSet, make_cam_dict
from pycamset_tpu.models.detections import TargetDetection
from pycamset_tpu.optim import find_target as jft
from pycamset_tpu.optim.handlers import FreePointTarget as JTarget
from pycamset_tpu.utils.general_utils import make_4x4h_tform
from pycamset_tpu.utils.synthetic import make_synthetic_rig
from pycamset_tpu_torch.from_jax import camset_from_jax, detection_from_jax
from pycamset_tpu_torch.models.abstract_target import FreePointTarget
from pycamset_tpu_torch.optim import find_target as pft

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)

NAMES = ["a", "b", "c"]


def _jax_rig(noise_px=0.0, dist_width=5):
    """tests/test_periphery.py::TestFixedCameraPoses's rig (its noise and
    each camera's distortion cut or zero-padded to ``dist_width``)."""
    rig = make_synthetic_rig(n_cams=3, n_ims=6, grid=5, visibility=1.0,
                             noise_px=noise_px, seed=9)
    k_mats, exts, dists = [], [], []
    for c in range(3):
        i9 = rig["intr"][c]
        k_mats.append(np.array([[i9[0], 0, i9[1]], [0, i9[2], i9[3]],
                                [0, 0, 1]]))
        d = np.zeros(dist_width)
        d[:min(5, dist_width)] = i9[4:4 + min(5, dist_width)]
        dists.append(d)
        exts.append(make_4x4h_tform(rig["extr"][c][:3], rig["extr"][c][3:]))
    cams = CameraSet(camera_dict=make_cam_dict(
        NAMES, exts, k_mats, dists, [[1600, 1200]] * 3))
    target = JTarget(rig["template"].reshape(1, -1, 3))
    det = TargetDetection(cam_names=NAMES, data=rig["dd"])
    return cams, target, det, rig


def _port(cams, target, det):
    return (camset_from_jax(cams),
            FreePointTarget(np.asarray(target.point_data)),
            detection_from_jax(det))


def test_pnp_start_matches_jax():
    cams, target, det, rig = _jax_rig()
    ref_poses, ref = jft.estimate_poses_with_fixed_cameras(cams, target, det)
    poses, res = pft.estimate_poses_with_fixed_cameras(
        *_port(cams, target, det), device="cpu")
    assert (res.nit, res.nfev, res.status) == (
        int(ref.nit), int(ref.nfev), int(ref.status))
    np.testing.assert_allclose(poses, ref_poses, rtol=0, atol=1e-9)
    np.testing.assert_allclose(res.fun, np.asarray(ref["fun"]), rtol=0,
                               atol=1e-9)
    for i in range(6):
        truth = make_4x4h_tform(rig["poses"][i][:3], rig["poses"][i][3:])
        np.testing.assert_allclose(poses[i], truth, atol=1e-6)


@pytest.mark.parametrize("width", [5, 8, 12, 14, 4])
def test_width_inference_matches_jax(width):
    cams, target, det, _ = _jax_rig(dist_width=width)
    ref = jft.FixedCameraPoseHandler(cams, target, det,
                                     options={"outliers": "n"})
    got = pft.FixedCameraPoseHandler(*_port(cams, target, det),
                                     options={"outliers": "n"})
    assert got.camera_models == ref.camera_models
    assert got.camera_model == ref.camera_model
    assert got.problem_opts.get("camera_model") == ref.problem_opts.get(
        "camera_model")
    assert got.intr_width == ref.intr_width
    assert not got.bundlePrimitive.intr_unfixed.any()
    assert not got.bundlePrimitive.extr_unfixed.any()
    np.testing.assert_allclose(got.bundlePrimitive.intr,
                               ref.bundlePrimitive.intr, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.bundlePrimitive.extr,
                               ref.bundlePrimitive.extr, rtol=0, atol=1e-12)


def test_rig_start_reaches_the_pnp_minimum():
    cams, target, det, _ = _jax_rig(noise_px=0.2)
    pcams, ptarget, pdet = _port(cams, target, det)
    pnp, res_p = pft.estimate_poses_with_fixed_cameras(
        pcams, ptarget, pdet, device="cpu")
    own, res_r = pft.estimate_poses_with_fixed_cameras(
        pcams, ptarget, pdet, start="rig", device="cpu")
    assert res_r.status in (1, 2, 3)
    np.testing.assert_allclose(own, pnp, rtol=0, atol=1e-8)
    # the caller's own seeds: the rig start with the tracking done
    seeded, _ = pft.estimate_poses_with_fixed_cameras(
        pcams, ptarget, pdet, start=pnp + 1e-3, device="cpu")
    np.testing.assert_allclose(seeded, pnp, rtol=0, atol=1e-8)
    with pytest.raises(ValueError, match="unknown start"):
        pft.estimate_poses_with_fixed_cameras(pcams, ptarget, pdet,
                                              start="cv2", device="cpu")
