"""Port parity: Rodrigues rotations and the numpy Rodrigues helpers.

The closed-form ``rodrigues_jacobian`` of pycamset_tpu_torch is held against
``jax.jacfwd`` of the JAX package's ``rodrigues_to_matrix``, on both sides of
its small-angle threshold (theta^2 = 1e-16), at r = 0 exactly and near pi;
the numpy ``ext_4x4_to_rod`` / ``make_4x4h_tform`` against the JAX package's
cv2 versions. Tolerances are relative to each output's max-abs scale.
"""
import jax
import numpy as np
import pytest
import torch

from pycamset_tpu.ops.rotations import rodrigues_to_matrix as jax_rod
from pycamset_tpu.utils import general_utils as jgu
from pycamset_tpu_torch.ops.rotations import (rodrigues_jacobian,
                                              rodrigues_to_matrix)
from pycamset_tpu_torch.utils import general_utils as tgu

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)

_AXIS = np.array([0.48, -0.6, 0.64])  # unit axis
RVECS = {
    "zero": np.zeros(3),
    "above_threshold": _AXIS * 1e-8 * 1.001,   # theta^2 just above 1e-16
    "below_threshold": _AXIS * 1e-8 * 0.999,   # small-angle branch
    "tiny": _AXIS * 1e-5,
    "generic": np.array([0.3, -0.2, 0.5]),
    "near_pi": _AXIS * (np.pi - 1e-6),
    "pi": _AXIS * np.pi,
    "random": np.random.default_rng(3).normal(size=3),
}


def _rel(got, ref):
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)


@pytest.mark.parametrize("name", sorted(RVECS))
def test_rodrigues_matrix_and_jacobian_match_jacfwd(name):
    r = RVECS[name]
    ref_r = np.asarray(jax_rod(r))
    ref_j = np.moveaxis(np.asarray(jax.jacfwd(jax_rod)(r)), -1, 0)
    got_r = rodrigues_to_matrix(torch.tensor(r)).numpy()
    got_j = rodrigues_jacobian(torch.tensor(r)).numpy()
    assert _rel(got_r, ref_r) <= 1e-12
    assert _rel(got_j, ref_j) <= 1e-12


def test_rodrigues_batched_matches_single():
    rv = np.stack([RVECS[k] for k in sorted(RVECS)])
    got = rodrigues_jacobian(torch.tensor(rv)).numpy()
    for i, k in enumerate(sorted(RVECS)):
        ref = np.moveaxis(np.asarray(jax.jacfwd(jax_rod)(RVECS[k])), -1, 0)
        assert _rel(got[i], ref) <= 1e-12, k


@pytest.mark.parametrize("name", sorted(RVECS))
def test_ext_4x4_to_rod_matches_cv2(name):
    h4 = np.eye(4)
    h4[:3, :3] = np.asarray(jax_rod(RVECS[name]))
    h4[:3, 3] = [0.1, -0.2, 1.5]
    r_ref, t_ref = jgu.ext_4x4_to_rod(h4)
    r_got, t_got = tgu.ext_4x4_to_rod(h4)
    # 1e-12, except at theta = pi - 1e-6: there both take the angle from
    # acos(c) with c ~ -1, which amplifies the 1e-16 rounding of the
    # orthonormalised matrix (each library's own SVD) by 1/sin(theta) = 1e6
    tol = 1e-8 if name == "near_pi" else 1e-12
    assert np.abs(r_got - r_ref).max() <= tol * max(1.0, np.abs(r_ref).max())
    assert np.array_equal(t_got, t_ref)


@pytest.mark.parametrize("name", sorted(RVECS))
def test_make_4x4h_tform_matches_cv2(name):
    for mode in ("opencv", "mvg"):
        ref = jgu.make_4x4h_tform(RVECS[name], [0.1, -0.2, 1.5], mode=mode)
        got = tgu.make_4x4h_tform(RVECS[name], [0.1, -0.2, 1.5], mode=mode)
        assert np.abs(got - ref).max() <= 1e-12
