"""Port parity: hand-eye calibration (float64, CPU).

``pycamset_tpu_torch.calibration.handeye`` against the JAX package's
``calibration/handeye.py`` on the data of its own tests
(``tests/test_handeye.py``: ``_rand_rigid`` motions, ``_handeye_rig``'s 3
cameras, 12 images, grid 6, 0.2 px):

- ``solve_ax_xb`` (Park and Tsai, with pose noise) and ``solve_hand_eye``
  (both mountings) to 1e-9 of scale;
- ``calibrate_hand_eye`` eye-in-hand, eye-to-hand with a robust loss and
  with ``refine=False``: the same nit and status, X, Z and their sigmas to
  1e-9 of scale, rms to 1e-9 relative;
- the refusals of both packages: a single-axis motion set, bad shapes,
  too few pairs; the port's on a pose-count mismatch.
"""
import numpy as np
import pytest
import torch

from pycamset_tpu.calibration import handeye as jhe
from pycamset_tpu_torch.calibration import handeye as phe
from pycamset_tpu_torch.from_jax import camset_from_jax, detection_from_jax
from pycamset_tpu_torch.models.abstract_target import FreePointTarget
from tests.test_handeye import _handeye_rig, _inv, _rand_rigid

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)


def _close(got, ref, tol=1e-9):
    got, ref = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
    assert np.abs(got - ref).max() <= tol * max(np.abs(ref).max(), 1e-300)


def _noisy_motions(seed=4, n=40):
    import cv2
    rng = np.random.default_rng(seed)
    x = _rand_rigid(rng)
    bs, as_ = [], []
    for _ in range(n):
        b = _rand_rigid(rng)
        a = x @ b @ _inv(x)
        for t in (a, b):
            t[:3, :3] = t[:3, :3] @ cv2.Rodrigues(
                rng.normal(size=3) * 1e-3)[0]
            t[:3, 3] += rng.normal(size=3) * 1e-4
        as_.append(a)
        bs.append(b)
    return np.stack(as_), np.stack(bs)


@pytest.mark.parametrize("method", ["park", "tsai"])
def test_solve_ax_xb_matches_jax(method):
    a, b = _noisy_motions()
    _close(phe.solve_ax_xb(a, b, method=method),
           jhe.solve_ax_xb(a, b, method=method))


@pytest.mark.parametrize("mode", ["eye_in_hand", "eye_to_hand"])
def test_solve_hand_eye_matches_jax(mode):
    rng = np.random.default_rng(6)
    x, z = _rand_rigid(rng), _rand_rigid(rng)
    p = np.stack([_rand_rigid(rng, rot_scale=0.4, t_scale=0.15)
                  for _ in range(12)])
    if mode == "eye_in_hand":
        g = np.stack([z @ _inv(pi) @ _inv(x) for pi in p])
    else:
        g = np.stack([x @ pi @ _inv(z) for pi in p])
    for got, ref in zip(phe.solve_hand_eye(g, p, mode=mode),
                        jhe.solve_hand_eye(g, p, mode=mode)):
        _close(got, ref)


@pytest.mark.parametrize("mode,kw", [("eye_in_hand", {}),
                                     ("eye_to_hand", {"loss": "cauchy"}),
                                     ("eye_to_hand", {"refine": False})])
def test_calibrate_hand_eye_matches_jax(mode, kw):
    cams, det, target, g, x, z, rig = _handeye_rig(mode)
    ref = jhe.calibrate_hand_eye(cams, det, g, target, mode=mode, **kw)
    got = phe.calibrate_hand_eye(
        camset_from_jax(cams), detection_from_jax(det), g,
        FreePointTarget(np.asarray(target.point_data)), mode=mode,
        device="cpu", **kw)
    _close(got.info["x_seed"], ref.info["x_seed"])
    _close(got.info["z_seed"], ref.info["z_seed"])
    np.testing.assert_array_equal(got.info["usable"], ref.info["usable"])
    if not kw.get("refine", True):
        assert np.isnan(got.rms) and np.isnan(ref.rms)
        return
    assert (got.info["nit"], got.info["status"]) == (ref.info["nit"],
                                                     ref.info["status"])
    assert got.info["status"] > 0
    _close(got.x, ref.x)
    _close(got.z, ref.z)
    _close(got.info["xz_sigma"], ref.info["xz_sigma"])
    assert abs(got.rms - ref.rms) <= 1e-9 * ref.rms
    assert abs(got.info["cost"] - ref.info["cost"]) <= (
        1e-9 * ref.info["cost"])
    assert np.abs(got.x[:3, 3] - x[:3, 3]).max() < 1e-3


def test_refusals_match_jax():
    import cv2
    rng = np.random.default_rng(5)
    x = _rand_rigid(rng)
    bs = []
    for _ in range(8):
        b = np.eye(4)
        b[:3, :3] = cv2.Rodrigues(
            np.array([0.0, 0.0, rng.uniform(0.2, 1.0)]))[0]
        b[:3, 3] = rng.normal(size=3)
        bs.append(b)
    bs = np.stack(bs)
    as_ = np.stack([x @ b @ _inv(x) for b in bs])
    two = np.stack([np.eye(4)] * 2)
    for mod in (jhe, phe):
        with pytest.raises(ValueError, match="degenerate"):
            mod.solve_ax_xb(as_, bs)
        with pytest.raises(ValueError, match="N, 4, 4"):
            mod.solve_hand_eye(np.eye(4), np.eye(4))
        with pytest.raises(ValueError, match="at least 3"):
            mod.solve_hand_eye(two, two)
    # the JAX package's own refusal is held by test_handeye.py
    cams, det, target, g, x, z, rig = _handeye_rig("eye_in_hand",
                                                   rng_seed=17, n_ims=6)
    with pytest.raises(ValueError, match="synchronized"):
        phe.calibrate_hand_eye(
            camset_from_jax(cams), detection_from_jax(det), g[:-1],
            FreePointTarget(np.asarray(target.point_data)), device="cpu")
