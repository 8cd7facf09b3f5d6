"""SE(3) pose application and the rigid fit (counterparts of
``pose_apply`` and ``rigid_fit`` in ``pycamset_tpu/ops/transforms.py``)."""
from __future__ import annotations

import numpy as np
import torch

from pycamset_tpu_torch.ops.rotations import rodrigues_to_matrix


def pose_apply(pose6: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply 6-dof poses [rvec, t] (..., 6) to points (..., 3)."""
    rmat = rodrigues_to_matrix(pose6[..., :3])
    return (torch.einsum("...ab,...b->...a", rmat, pts) + pose6[..., 3:])


def rigid_fit(src, dst, weights=None):
    """Least-squares rigid transform (R, t) with R @ src + t ~= dst, on the
    host (numpy, float64): Kabsch/Umeyama with a determinant correction, the
    third singular vectors rebuilt as the cross products of the first two
    (a valid completion for planar, rank-2 point sets). Counterpart of
    ``rigid_fit`` in ``pycamset_tpu/ops/transforms.py``.

    :param src: (N, 3). :param dst: (N, 3). :param weights: optional (N,)
        non-negative.
    :return: (R (3, 3), t (3,)).
    """
    src = np.asarray(src, dtype=float)
    dst = np.asarray(dst, dtype=float)
    w = (np.ones(src.shape[0]) if weights is None
         else np.asarray(weights, dtype=float))
    wsum = np.sum(w)
    mu_s = np.sum(src * w[:, None], axis=0) / wsum
    mu_d = np.sum(dst * w[:, None], axis=0) / wsum
    cov = ((dst - mu_d) * w[:, None]).T @ (src - mu_s)
    u, _, vt = np.linalg.svd(cov)
    u = np.stack([u[:, 0], u[:, 1], np.cross(u[:, 0], u[:, 1])], axis=1)
    vt = np.stack([vt[0], vt[1], np.cross(vt[0], vt[1])], axis=0)
    d = np.array([1.0, 1.0, np.sign(np.linalg.det(u @ vt))])
    rmat = (u * d) @ vt
    return rmat, mu_d - rmat @ mu_s
