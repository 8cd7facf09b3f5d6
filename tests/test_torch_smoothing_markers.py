"""Port parity: the RTS smoother and the marker triangulator (float64,
CPU), and the serving scenes' generators.

- ``smoothing.smooth_pose_trajectory`` against the JAX package's on the
  noisy constant-velocity trajectories of its own tests
  (``tests/test_smoothing.py``): (I, 6) rows with lost frames, 4 x 4
  input, per-frame sigmas, velocities (1e-9; sigmas 1e-6 relative);
  ``unwrap_rvecs`` across pi; the refusals;
- ``markers.MarkerTriangulator`` against the JAX package's on the marker
  tests' rig and capture (``tests/test_markers.py``): points 1e-9 (NaN
  where fewer than 2 cameras see a marker), sigmas 1e-6 relative, rms,
  views, at 0 and 3 polish steps; the refusals;
- ``utils.synthetic.moving_capture`` and ``marker_capture`` against the
  JAX tests' generators (``tests/test_sync.py::_moving_capture``,
  ``tests/test_markers.py::_capture``).
"""
import numpy as np
import pytest
import torch

from pycamset_tpu.markers import MarkerTriangulator as JMarkers
from pycamset_tpu.smoothing import smooth_pose_trajectory as jax_smooth
from pycamset_tpu.smoothing import unwrap_rvecs as jax_unwrap
from pycamset_tpu_torch.from_jax import camset_from_jax
from pycamset_tpu_torch.markers import MarkerTriangulator
from pycamset_tpu_torch.smoothing import (smooth_pose_trajectory,
                                          unwrap_rvecs)
from pycamset_tpu_torch.utils.general_utils import make_4x4h_tform
from pycamset_tpu_torch.utils.synthetic import (grid_target, marker_capture,
                                                moving_capture, ring_rig)
from tests import test_markers as jm
from tests.test_smoothing import _noisy_cv_trajectory

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)


def _same(got, want, sig_rtol=1e-6):
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got[-1], want[-1], rtol=sig_rtol, atol=1e-15)


@pytest.mark.parametrize("case", ["lost_frames", "4x4", "sigma", "first_lost"])
def test_smoother_vs_jax(case):
    true6, meas6, cov = _noisy_cv_trajectory(n=40, seed=1)
    kw = {"q_rot": 1e-4, "q_trans": 1e-4, "return_velocity": True}
    poses = meas6.copy()
    if case in ("lost_frames", "first_lost"):
        cov = cov.copy()
        lost = slice(0, 3) if case == "first_lost" else slice(12, 18)
        cov[lost] = np.inf
        poses[lost] = 123.0
        kw["pose_cov"] = cov
    elif case == "4x4":
        poses = np.stack([make_4x4h_tform(m[:3], m[3:]) for m in meas6])
        kw["pose_cov"] = cov
    else:
        kw["pose_sigma"] = np.sqrt(np.einsum("fii->fi", cov))
        kw["dt"] = 1.0 / 30.0
    want = jax_smooth(poses, **kw)
    got = smooth_pose_trajectory(poses, device="cpu", **kw)
    _same(got, want)


def test_unwrap_and_refusals():
    th = np.linspace(3.0, 3.6, 13)
    rv = np.array([[0, 0, t if t <= np.pi else t - 2 * np.pi] for t in th])
    valid = np.ones(13, bool)
    valid[4] = False
    np.testing.assert_array_equal(unwrap_rvecs(rv, valid),
                                  jax_unwrap(rv, valid))
    np.testing.assert_allclose(unwrap_rvecs(rv)[:, 2], th, atol=1e-12)
    with pytest.raises(ValueError, match="at least 2"):
        smooth_pose_trajectory(np.zeros((1, 6)), device="cpu")
    with pytest.raises(ValueError, match="poses must be"):
        smooth_pose_trajectory(np.zeros((5, 7)), device="cpu")
    with pytest.raises(ValueError, match="every frame is marked lost"):
        smooth_pose_trajectory(np.zeros((3, 6)),
                               pose_cov=np.full((3, 6, 6), np.inf),
                               device="cpu")


@pytest.fixture(scope="module")
def markers():
    cams = jm._rig()
    occl = {(3, 1), (7, 4)}
    rows, truth = jm._capture(cams, n_frames=12, noise=0.2, seed=1,
                              occlude=occl)
    return cams, rows, truth, occl


@pytest.mark.parametrize("refine_iters", [0, 3])
def test_markers_vs_jax(markers, refine_iters):
    cams, rows, truth, occl = markers
    pj, ij = JMarkers(cams, jm.N_MARKERS,
                      refine_iters=refine_iters).reconstruct(rows)
    pp, ip = MarkerTriangulator(camset_from_jax(cams), jm.N_MARKERS,
                                refine_iters=refine_iters,
                                device="cpu").reconstruct(rows)
    np.testing.assert_array_equal(np.isnan(pp), np.isnan(pj))
    np.testing.assert_allclose(pp, pj, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(ip["n_views"], ij["n_views"])
    np.testing.assert_allclose(ip["rms"], ij["rms"], rtol=1e-6, atol=1e-12)
    np.testing.assert_array_equal(np.isinf(ip["sigma"]),
                                  np.isinf(ij["sigma"]))
    seen = ip["n_views"] >= 2
    np.testing.assert_allclose(ip["sigma"][seen], ij["sigma"][seen],
                               rtol=1e-6)
    for (j, m) in occl:
        assert np.isnan(pp[j, m]).all() and np.isinf(ip["sigma"][j, m]).all()
    if refine_iters:
        err = np.linalg.norm(pp - truth, axis=-1)
        assert np.nanmedian(err[seen]) < 3e-4


def test_marker_refusals(markers):
    tri = MarkerTriangulator(camset_from_jax(markers[0]), 2, device="cpu")
    with pytest.raises(ValueError, match="n_markers"):
        tri.reconstruct(np.array([[0, 0, 5, 800.0, 600.0]]))
    with pytest.raises(ValueError, match="non-empty rows"):
        tri.reconstruct(np.zeros((0, 5)))


def test_generators_vs_jax_tests():
    from tests.test_sync import _grid_target, _moving_capture, _ring_rig

    jcams = _ring_rig()
    jtpl, _ = _grid_target()
    np.testing.assert_array_equal(grid_target(), jtpl)
    cams = ring_rig()
    for offsets, readouts in ((np.zeros(3), np.full(3, 0.7)),
                              (np.array([0.0, 0.3, -0.35]), None)):
        det, knots = _moving_capture(jcams, jtpl, 6, offsets,
                                     readouts=readouts, noise=0.1, seed=9,
                                     linear=True)
        rows, kn = moving_capture(cams, grid_target(), 6, offsets,
                                  readouts=readouts, noise=0.1, seed=9,
                                  linear=True)
        np.testing.assert_array_equal(kn, knots)
        assert rows.shape == det.get_data().shape
        np.testing.assert_allclose(rows, det.get_data(), rtol=0, atol=1e-9)
    occl = {(3, 1), (7, 4)}
    rows, truth = jm._capture(jm._rig(), n_frames=10, noise=0.2, seed=1,
                              occlude=occl)
    mc = ring_rig(4, radius=1.5, z=0.6, f=1400.0,
                  dist=(-0.15, 0.04, 1e-4, -1e-4, 0.0))
    prow, ptruth = marker_capture(mc, 10, jm.N_MARKERS, noise=0.2, seed=1,
                                  occlude=occl)
    np.testing.assert_array_equal(ptruth, truth)
    assert prow.shape == rows.shape
    np.testing.assert_allclose(prow, rows, rtol=0, atol=1e-9)
