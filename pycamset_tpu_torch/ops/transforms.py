"""SE(3) pose application and the rigid fit (counterparts of
``pose_apply`` and ``rigid_fit`` in ``pycamset_tpu/ops/transforms.py``):
``rigid_fit`` on the host, ``rigid_fit_batch`` on the tensors' device with
any leading dims (the JAX function under ``jax.vmap``)."""
from __future__ import annotations

import numpy as np
import torch

from pycamset_tpu_torch.ops.rotations import rodrigues_to_matrix


def pose_apply(pose6: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply 6-dof poses [rvec, t] (..., 6) to points (..., 3); the leading
    dims broadcast. R p is summed as R's three columns times p's entries:
    an einsum of (3, 3) by (3,) runs as one tiny GEMV a batch entry on a
    card, and an elementwise (..., 3, 3) product holds nine values a point
    (under a vmapped jvp, nine a point and direction)."""
    rmat = rodrigues_to_matrix(pose6[..., :3])
    return (rmat[..., 0] * pts[..., 0:1] + rmat[..., 1] * pts[..., 1:2]
            + rmat[..., 2] * pts[..., 2:3] + pose6[..., 3:])


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


def rigid_fit_batch(src: torch.Tensor, dst: torch.Tensor,
                    weights: torch.Tensor):
    """``rigid_fit`` on tensors with leading batch dims: Kabsch/Umeyama by
    one batched 3x3 SVD, the third singular vectors rebuilt as the cross
    products of the first two (planar, rank-2 point sets), the determinant
    corrected to a proper rotation.

    :param src: (..., N, 3). :param dst: (..., N, 3).
    :param weights: (..., N) non-negative, with a positive sum.
    :return: (R (..., 3, 3), t (..., 3)).
    """
    w = weights[..., None]
    wsum = torch.sum(weights, dim=-1)[..., None]
    mu_s = torch.sum(src * w, dim=-2) / wsum
    mu_d = torch.sum(dst * w, dim=-2) / wsum
    s0 = src - mu_s[..., None, :]
    d0 = dst - mu_d[..., None, :]
    cov = (d0 * w).transpose(-1, -2) @ s0
    u, _, vt = torch.linalg.svd(cov)
    u0, u1 = u[..., :, 0], u[..., :, 1]
    u = torch.stack([u0, u1, torch.linalg.cross(u0, u1)], dim=-1)
    v0, v1 = vt[..., 0, :], vt[..., 1, :]
    vt = torch.stack([v0, v1, torch.linalg.cross(v0, v1)], dim=-2)
    det = torch.sign(torch.linalg.det(u @ vt))
    ones = torch.ones_like(det)
    d = torch.stack([ones, ones, det], dim=-1)
    rmat = (u * d[..., None, :]) @ vt
    return rmat, mu_d - (rmat @ mu_s[..., None])[..., 0]
