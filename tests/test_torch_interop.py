"""Port parity: rig interchange (host numpy).

``pycamset_tpu_torch.utils.interop`` against the JAX package's
``utils/interop.py`` on the rigs of ``tests/test_interop.py::_rig``:

- the COLMAP text files and the NeRF JSON byte-identical to the JAX
  package's for the same rig (standard, k3 = 0, rational, fisheye; the
  COLMAP model with points and tracks too);
- the import round trips (COLMAP both ways, and each package reading the
  other's files), the quaternions to 1e-12;
- the thin-prism refusal and the mixed-rig refusal, as the JAX package
  raises them;
- the OpenCV YAML pair (cv2 is installed here): the same bytes, and the
  round trip.
"""
import numpy as np
import pytest
import torch

from pycamset_tpu.utils import interop as ji
from pycamset_tpu_torch.from_jax import camset_from_jax
from pycamset_tpu_torch.utils import interop as pi
from tests.test_interop import _rig

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)

D5 = [0.1, -0.05, 1e-3, -2e-3, 0.01]
DISTS = {"standard": [D5] * 3,
         "k3_zero": [[0.1, -0.05, 1e-3, -2e-3, 0.0]] * 3,
         "rational": [[0.3, -0.1, 1e-3, 2e-3, 0.05, 0.28, -0.09, 0.04]] * 3,
         "fisheye": [[0.02, -0.004, 0.001, -0.0002]] * 3}


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize("kind", sorted(DISTS))
def test_colmap_and_nerf_bytes_match_jax(tmp_path, kind):
    cams = _rig(dists=DISTS[kind])
    pcams = camset_from_jax(cams)
    names = {"cam1": "images/left.png"}
    ref = ji.export_colmap(cams, tmp_path / "jax", image_names=names)
    got = pi.export_colmap(pcams, tmp_path / "port", image_names=names)
    assert _files(got) == _files(ref)
    ref_n = ji.export_nerf(cams, tmp_path / "jax.json", image_names=names)
    got_n = pi.export_nerf(pcams, tmp_path / "port.json", image_names=names)
    assert got_n.read_bytes() == ref_n.read_bytes()
    # each package reads the other's files to the same rig
    back = pi.import_colmap(ref)
    ref_back = ji.import_colmap(got)
    # an imported camera is named by its image's file stem
    assert back.get_names() == ref_back.get_names() == ["cam0", "left",
                                                        "cam2"]
    for n, own in zip(back.get_names(), pcams.get_names()):
        np.testing.assert_array_equal(back[n].extrinsic,
                                      ref_back[n].extrinsic)
        np.testing.assert_array_equal(back[n].intrinsic,
                                      ref_back[n].intrinsic)
        np.testing.assert_array_equal(
            np.ravel(back[n].distortion_coefs),
            np.ravel(ref_back[n].distortion_coefs))
        np.testing.assert_allclose(back[n].extrinsic, pcams[own].extrinsic,
                                   rtol=0, atol=1e-12)
        assert back[n].res == [1280, 720]


def test_points_and_tracks_bytes_match_jax(tmp_path):
    cams = _rig()
    pts = np.array([[0, 0, 0.5], [0.1, 0.2, 0.6]])
    tracks = [[("cam0", (10.0, 20.0)), ("cam1", (30.0, 40.0))],
              [("cam0", (50.0, 60.0))]]
    kw = dict(points3d=pts, tracks=tracks, errors=[0.25, 0.5])
    ref = ji.export_colmap(cams, tmp_path / "jax", **kw)
    got = pi.export_colmap(camset_from_jax(cams), tmp_path / "port", **kw)
    assert _files(got) == _files(ref)


def test_quaternions_match_jax():
    rng = np.random.default_rng(3)
    from pycamset_tpu_torch.utils.general_utils import make_4x4h_tform
    for axis_scale in (2.5, np.pi - 1e-9):
        for _ in range(20):
            v = rng.normal(size=3)
            r = make_4x4h_tform(v / np.linalg.norm(v) * axis_scale,
                                np.zeros(3))[:3, :3]
            q = pi.quat_from_matrix(r)
            np.testing.assert_array_equal(q, ji.quat_from_matrix(r))
            np.testing.assert_array_equal(pi.matrix_from_quat(q),
                                          ji.matrix_from_quat(q))
            np.testing.assert_allclose(pi.matrix_from_quat(q), r, rtol=0,
                                       atol=1e-9)


def test_import_simple_models_match_jax(tmp_path):
    (tmp_path / "cameras.txt").write_text(
        "1 SIMPLE_RADIAL 640 480 500 320 240 0.1\n"
        "2 PINHOLE 640 480 500 510 320 240\n"
        "3 RADIAL 640 480 500 320 240 0.1 0.01\n"
        "4 SIMPLE_PINHOLE 640 480 450 320 240\n")
    (tmp_path / "images.txt").write_text(
        "1 1 0 0 0 0 0 1 1 a.png\n\n"
        "2 1 0 0 0 0 0 2 2 b.jpg\n\n"
        "3 0.5 0.5 0.5 0.5 0.1 0 2 3 c.png\n\n"
        "4 1 0 0 0 0 0 2 4 d.png\n\n")
    ref, got = ji.import_colmap(tmp_path), pi.import_colmap(tmp_path)
    assert got.get_names() == ref.get_names() == ["a", "b", "c", "d"]
    for n in ref.get_names():
        for attr in ("extrinsic", "intrinsic", "distortion_coefs"):
            np.testing.assert_array_equal(getattr(got[n], attr),
                                          getattr(ref[n], attr))


def test_refusals_match_jax(tmp_path):
    thin = _rig(dists=[np.r_[0.1, -0.05, 0, 0, 0.01,
                             0.09, -0.04, 0.008, 1e-4, 0, 0, 0]] * 3)
    mixed = _rig(dists=[np.zeros(5), np.zeros(4), np.zeros(5)])
    skewed = _rig()
    k = skewed["cam0"].intrinsic.copy()
    k[0, 1] = 2.0
    skewed["cam0"].intrinsic = k
    (tmp_path / "bin").mkdir()
    (tmp_path / "bin" / "cameras.bin").write_bytes(b"\x00")
    for cams, call, match in (
            (thin, "export_colmap", "convert_camera_model"),
            (thin, "export_nerf", "convert_camera_model"),
            (mixed, "export_nerf", "mixed"),
            (skewed, "export_colmap", "skew")):
        for mod, c in ((ji, cams), (pi, camset_from_jax(cams))):
            with pytest.raises(ValueError, match=match):
                getattr(mod, call)(c, tmp_path / f"{call}.out")
    for mod in (ji, pi):
        with pytest.raises(ValueError, match="model_converter"):
            mod.import_colmap(tmp_path / "bin")
        with pytest.raises(FileNotFoundError):
            mod.import_colmap(tmp_path / "nothing")
        with pytest.raises(ValueError, match="unsupported COLMAP"):
            mod._from_colmap_params("FOV", [1.0])


def test_opencv_yaml_matches_jax(tmp_path):
    cams = _rig(dists=[D5, np.zeros(5), DISTS["rational"][0]])
    pcams = camset_from_jax(cams)
    ref = ji.export_opencv_yaml(cams, tmp_path / "jax.yaml")
    got = pi.export_opencv_yaml(pcams, tmp_path / "port.yaml")
    assert got.read_bytes() == ref.read_bytes()
    back = pi.import_opencv_yaml(ref)
    assert back.get_names() == pcams.get_names()
    for n in pcams.get_names():
        np.testing.assert_array_equal(back[n].intrinsic, pcams[n].intrinsic)
        np.testing.assert_array_equal(np.ravel(back[n].distortion_coefs),
                                      np.ravel(pcams[n].distortion_coefs))
        np.testing.assert_allclose(back[n].extrinsic, pcams[n].extrinsic,
                                   rtol=0, atol=1e-15)
        assert back[n].res == [1280, 720]
