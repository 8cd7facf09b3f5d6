"""Port parity: per-camera model selection (float64, CPU).

``select_camera_model(per_camera=True)`` of the port against the JAX
package's on ``tests/test_model_select.py::_rig_cams_det``'s rig (3
cameras, 10 images, standard data at 0.05 px), ("standard", "rational")
at ``max_nfev`` 10, from the PnP start: the same pick, every score within
1e-9 relative, a NaN train score where the JAX package's is NaN (its
per-camera train solve pins both the camera and image 0's pose at the
identity: ROADMAP Queue C 9). Its own file: the JAX package compiles each
one-camera shape, about 20 s on the CPU.
"""
import torch

from tests.test_torch_model_select import rig, select_matches_jax  # noqa: F401

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)


def test_select_per_camera_matches_jax(rig):  # noqa: F811
    select_matches_jax(rig, per_camera=True)
