"""Port parity: the synthetic rig generator.

The same seed must give the same rig in both packages: identical
[cam, im, key] detection rows and arrays that agree to 1e-9 (the only
difference is numpy Rodrigues in the port where the JAX package calls cv2).
"""
import numpy as np
import pytest
import torch

from pycamset_tpu.utils.synthetic import make_synthetic_rig as jax_rig
from pycamset_tpu_torch.utils.synthetic import make_synthetic_rig as port_rig

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)


@pytest.mark.parametrize("kw", [
    dict(n_cams=3, n_ims=5, grid=4, visibility=0.8, noise_px=0.5, seed=2),
    dict(n_cams=4, n_ims=16, grid=6, visibility=0.85, noise_px=0.3, seed=0),
    dict(n_cams=16, n_ims=10, grid=19, visibility=0.85, noise_px=0.3, seed=0),
    dict(n_cams=3, n_ims=4, grid=5, seed=7, camera_model="rational"),
])
def test_synthetic_rig_matches_jax_package(kw):
    ref = jax_rig(**kw)
    got = port_rig(**kw)
    assert np.array_equal(got["dd"][:, :3], ref["dd"][:, :3])
    for key in ("dd", "intr", "extr", "poses", "template"):
        assert got[key].shape == ref[key].shape, key
        scale = max(1.0, np.abs(ref[key]).max())
        assert np.abs(got[key] - ref[key]).max() <= 1e-9 * scale, key
    for key in ("n_cams", "n_ims", "n_keys", "noise_px", "camera_model"):
        assert got[key] == ref[key], key
