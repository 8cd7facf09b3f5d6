"""Port parity: the CameraSet / Camera surface and the top-level names.

The methods the port's ``models/camera.py`` and ``models/camera_set.py``
gained against the JAX package's (float64, CPU): the field of view and
projection matrix, ``set_minimal``, ``can_image``, the intrinsic edits,
the transforms, ``set_reference_cam``, merging, ``get_similar_angles``,
``get_calibration_points`` (1e-9) and the MVSNet export (``to_MVSnet_txt``
and ``write_to_txt`` with ``reconstruction/acmmp_utils.py``: the txt files
byte-identical, the undistorted images too); and the names of
``pycamset_tpu_torch/__init__.py`` (each resolves to the port's object).
"""
import importlib

import numpy as np
import pytest
import torch

import pycamset_tpu_torch
from pycamset_tpu.models.camera import Camera as JCamera
from pycamset_tpu.models.detections import TargetDetection as JDetection
from pycamset_tpu.optim.handlers import FreePointTarget as JTarget
from pycamset_tpu.optim.handlers import TemplateBundleHandler as JHandler
from pycamset_tpu.reconstruction import acmmp_utils as jacmmp
from pycamset_tpu.utils.synthetic import make_synthetic_rig
from pycamset_tpu_torch.from_jax import camset_from_jax, detection_from_jax
from pycamset_tpu_torch.models.abstract_target import FreePointTarget
from pycamset_tpu_torch.models.camera import Camera
from pycamset_tpu_torch.optim.handlers import TemplateBundleHandler
from pycamset_tpu_torch.reconstruction import acmmp_utils as pacmmp
from tests.test_interop import _rig

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)


def _cam_pair():
    k = np.array([[900.0, 0, 640.0], [0, 905.0, 360.0], [0, 0, 1]])
    ext = np.eye(4)
    ext[:3, 3] = [0.1, -0.2, 2.0]
    kw = dict(extrinsic=ext, intrinsic=k, res=[1280, 720],
              distortion_coefs=[0.1, -0.05, 1e-3, -2e-3, 0.01], name="c")
    return JCamera(**kw), Camera(**kw, device="cpu")


def _same_cam(got, ref):
    for attr in ("extrinsic", "intrinsic", "proj", "position", "view",
                 "cam_to_world"):
        np.testing.assert_allclose(getattr(got, attr), getattr(ref, attr),
                                   rtol=0, atol=1e-12)
    assert got.fov == pytest.approx(ref.fov, abs=1e-12)
    assert list(got.res) == list(ref.res)


def test_camera_methods_match_jax(tmp_path):
    ref, got = _cam_pair()
    assert got._cam_fov() == ref._cam_fov()
    np.testing.assert_array_equal(got._calc_projection_matrix(),
                                  ref._calc_projection_matrix())
    for pt in ([0.0, 0.0, 0.0], [5.0, 0.0, 0.0], [0.0, 0.0, -3.0]):
        assert got.can_image(pt, device="cpu") == ref.can_image(pt)
    for uv in ([10.0, 10.0], [1280.0, 5.0], [-1.0, 3.0]):
        assert got._is_in_image(uv) == ref._is_in_image(uv)
    tf = np.eye(4)
    tf[:3, 3] = [0.3, 0.1, -0.2]
    for edit in (lambda c: c.scale_self_2n(1), lambda c: c.scale_self_2n(2),
                 lambda c: c.crop_to_roi([5, 10, 150, 80]),
                 lambda c: c.reset_to_original_params(),
                 lambda c: c.transform(tf)):
        edit(ref)
        edit(got)
        _same_cam(got, ref)
    for mod in (ref, got):
        with pytest.raises(ValueError, match="crop bounds"):
            mod.crop_to_roi([0, 0, 5000, 10])
    ref.set_minimal(False)
    got.set_minimal(False)
    # the JAX map undistorts through OpenCV, the port's through its own
    # fixed-point iteration: 3.6e-8 apart at this lens's k1 = 0.1
    # (test_torch_handlers.py holds a milder lens to 1e-8)
    assert got.world_sensor_map.shape == ref.world_sensor_map.shape
    np.testing.assert_allclose(got.world_sensor_map[::97, ::61],
                               ref.world_sensor_map[::97, ::61], rtol=0,
                               atol=1e-7)
    ref.set_minimal(True)
    got.set_minimal(True)
    assert got.sensor_map is None and ref.sensor_map is None
    crop = np.array([[5, 300], [7, 400]])
    ref.to_MVSnet_txt(tmp_path / "j.txt", (0.1, 0.8), 192, crop)
    got.to_MVSnet_txt(tmp_path / "p.txt", (0.1, 0.8), 192, crop)
    assert (tmp_path / "p.txt").read_bytes() == (
        tmp_path / "j.txt").read_bytes()


def test_camera_set_transforms_match_jax():
    ref = _rig(n=4)
    got = camset_from_jax(ref)
    tf = np.eye(4)
    tf[:3, 3] = [0.3, 0.1, -0.2]
    moved_ref = ref.transform(tf, in_place=False)
    moved = got.transform(tf, in_place=False)
    for n in ref.get_names():
        _same_cam(moved[n], moved_ref[n])
        _same_cam(got[n], ref[n])       # the original is untouched
    for step in (lambda s: s.set_reference_cam("cam2"),
                 lambda s: s.scale_set_2n(1)):
        step(ref)
        step(got)
        for n in ref.get_names():
            _same_cam(got[n], ref[n])
    for i in range(4):
        np.testing.assert_array_equal(got.get_similar_angles(i, 2),
                                      ref.get_similar_angles(i, 2))
    a, b = got.make_subset([0, 1]), got.make_subset([2, 3])
    merged = a + b
    assert merged is a and merged.get_names() == got.get_names()
    with pytest.raises(ValueError, match="share camera names"):
        merged + got.make_subset([0])
    with pytest.raises(ValueError, match="camera sets"):
        merged + 3


def test_write_to_txt_matches_jax(tmp_path):
    ref = _rig(n=5, dists=[[0.1, -0.05, 1e-3, -2e-3, 0.01]] * 5)
    got = camset_from_jax(ref)
    r = jacmmp.ReconParams(maxangle=90, max_n_view=2)
    pr = pacmmp.ReconParams(maxangle=90, max_n_view=2)
    assert pr == pacmmp.ReconParams(**vars(r))
    rng = np.random.default_rng(0)
    ims = [rng.integers(0, 255, (720, 1280, 3), dtype=np.uint8)
           for _ in range(5)]
    crop = {"cam1": np.array([[10, 600], [20, 900]])}
    for tag, cams, params in (("jax", ref, r), ("port", got, pr)):
        (tmp_path / tag / "cams").mkdir(parents=True)
        cams.write_to_txt(tmp_path / tag / "cams", params, ims=ims,
                          crop=crop)
    for sub in ("cams", "images", "."):
        j, p = tmp_path / "jax" / sub, tmp_path / "port" / sub
        names = sorted(f.name for f in j.iterdir() if f.is_file())
        assert names == sorted(f.name for f in p.iterdir() if f.is_file())
        for name in names:
            assert (p / name).read_bytes() == (j / name).read_bytes(), name
    assert "pair.txt" in [f.name for f in (tmp_path / "port").iterdir()]
    gaze = np.array([c.view for c in got])
    for closest in (True, False):
        pick = {"pick_closest": closest}
        got_pairs = pacmmp.calc_pairs(gaze, pr, rng=np.random.default_rng(1),
                                      **pick)
        ref_pairs = jacmmp.calc_pairs(gaze, r, rng=np.random.default_rng(1),
                                      **pick)
        for g, e in zip(got_pairs, ref_pairs):
            np.testing.assert_array_equal(g, e)
    with pytest.raises(NotImplementedError):
        got.write_to_txt(tmp_path / "x", pr, mode="ACMMP")


def test_get_calibration_points_matches_jax():
    rig = make_synthetic_rig(n_cams=3, n_ims=5, grid=5, visibility=1.0,
                             noise_px=0.1, seed=4)
    names = ["a", "b", "c"]
    from pycamset_tpu_torch.from_jax import camset_from_numpy
    from pycamset_tpu_torch.utils.general_utils import make_4x4h_tform
    kmats = [np.array([[i[0], 0, i[1]], [0, i[2], i[3]], [0, 0, 1]])
             for i in rig["intr"]]
    exts = [make_4x4h_tform(e[:3], e[3:]) for e in rig["extr"]]
    got_cams = camset_from_numpy(names, exts, kmats,
                                 [i[4:] for i in rig["intr"]],
                                 [[1600, 1200]] * 3)
    opts = {"outliers": "n", "fixed_pose": None}
    tpl = rig["template"].reshape(1, -1, 3)
    jdet = JDetection(cam_names=names, data=rig["dd"])
    from pycamset_tpu.models.camera_set import CameraSet as JSet
    from pycamset_tpu.models.camera_set import make_cam_dict as jdict
    ref_cams = JSet(camera_dict=jdict(names, exts, kmats,
                                      [i[4:] for i in rig["intr"]],
                                      [[1600, 1200]] * 3))
    full = np.concatenate([rig["intr"].ravel(), rig["extr"].ravel(),
                           rig["poses"].ravel()])
    out = []
    for handler in (JHandler(ref_cams, JTarget(tpl), jdet, options=opts),
                    TemplateBundleHandler(got_cams, FreePointTarget(tpl),
                                          detection_from_jax(jdet),
                                          options=opts)):
        x = full[handler.bundlePrimitive.unfixed_full()]
        cams = handler.get_camset(x)
        cams.set_calibration_history({"x": x, "fun": np.zeros(2)}, handler)
        out.append(cams)
    ref = out[0].get_calibration_points()
    got = out[1].get_calibration_points(device="cpu")
    assert got.shape == ref.shape and got.shape[0] > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)
    with pytest.raises(ValueError, match="calibration history"):
        got_cams.get_calibration_points(device="cpu")


NAMES = {
    "Camera": "pycamset_tpu_torch.models.camera",
    "CameraSet": "pycamset_tpu_torch.models.camera_set",
    "load_CameraSet": "pycamset_tpu_torch.utils.saving",
    "calibrate_hand_eye": "pycamset_tpu_torch.calibration.handeye",
    "rig_health": "pycamset_tpu_torch.calibration.monitor",
    "recalibrate_extrinsics": "pycamset_tpu_torch.calibration.monitor",
    "recalibrate_intrinsics": "pycamset_tpu_torch.calibration.monitor",
    "convert_camera_model": "pycamset_tpu_torch.calibration.convert",
    "convert_camera_set": "pycamset_tpu_torch.calibration.convert",
    "calibrate_time_offsets": "pycamset_tpu_torch.calibration.sync",
    "calibrate_extrinsics_from_wand": "pycamset_tpu_torch.calibration.wand",
}


@pytest.mark.parametrize("name", sorted(NAMES))
def test_top_level_names_resolve(name):
    import pycamset_tpu
    assert name in pycamset_tpu.__all__ and name in pycamset_tpu_torch.__all__
    assert getattr(pycamset_tpu_torch, name) is getattr(
        importlib.import_module(NAMES[name]), name)
