"""SE(3) transforms and point-set fitting (counterpart of
``pycamset_tpu/ops/transforms.py``): poses as 6-vectors [rvec, t], (3, 4)
rigid transforms, (4, 4) homogeneous ones. Each tensor function takes
leading batch dims where the JAX one takes a single transform (the JAX
function under ``jax.vmap``); ``rigid_fit`` runs on the host,
``rigid_fit_batch`` on the tensors' device."""
from __future__ import annotations

import numpy as np
import torch

from pycamset_tpu_torch.ops.rotations import (matrix_to_rodrigues,
                                              rodrigues_to_matrix)


def pose_apply(pose6: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply 6-dof poses [rvec, t] (..., 6) to points (..., 3); the leading
    dims broadcast. R p is summed as R's three columns times p's entries:
    an einsum of (3, 3) by (3,) runs as one tiny GEMV a batch entry on a
    card, and an elementwise (..., 3, 3) product holds nine values a point
    (under a vmapped jvp, nine a point and direction)."""
    rmat = rodrigues_to_matrix(pose6[..., :3])
    return (rmat[..., 0] * pts[..., 0:1] + rmat[..., 1] * pts[..., 1:2]
            + rmat[..., 2] * pts[..., 2:3] + pose6[..., 3:])


def pose_to_se3(pose6: torch.Tensor) -> torch.Tensor:
    """6-dof poses [rvec, t] (..., 6) -> (..., 3, 4) rigid transforms."""
    return torch.cat([rodrigues_to_matrix(pose6[..., :3]),
                      pose6[..., 3:, None]], dim=-1)


def se3_to_pose(se3: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) or (..., 4, 4) rigid transforms -> poses (..., 6)."""
    return torch.cat([matrix_to_rodrigues(se3[..., :3, :3]),
                      se3[..., :3, 3]], dim=-1)


def pose_to_h4(pose6: torch.Tensor) -> torch.Tensor:
    """6-dof poses (..., 6) -> (..., 4, 4) homogeneous transforms."""
    se3 = pose_to_se3(pose6)
    bottom = torch.zeros(se3.shape[:-2] + (1, 4), dtype=se3.dtype,
                         device=se3.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([se3, bottom], dim=-2)


def se3_apply(se3: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a (3, 4) rigid transform to points (..., 3)."""
    return pts @ se3[:, :3].T + se3[:, 3]


def se3_inv(se3: torch.Tensor) -> torch.Tensor:
    """Invert (..., 3, 4) rigid transforms."""
    rt = se3[..., :, :3].transpose(-1, -2)
    return torch.cat([rt, -(rt @ se3[..., :, 3:])], dim=-1)


def pose_inv(pose6: torch.Tensor) -> torch.Tensor:
    """Invert 6-dof poses (..., 6)."""
    return se3_to_pose(se3_inv(pose_to_se3(pose6)))


def se3_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose (..., 3, 4) transforms: the result applies b first, then
    a."""
    ra = a[..., :, :3]
    return torch.cat([ra @ b[..., :, :3], ra @ b[..., :, 3:] + a[..., :, 3:]],
                     dim=-1)


def h_tform(pts: torch.Tensor, h4: torch.Tensor,
            fill: float = 1.0) -> torch.Tensor:
    """Homogeneous transform of points (..., 3) by a (4, 4) or (3, 4)
    matrix. ``fill=1`` transforms points (with the perspective divide of a
    full projective 4x4); ``fill=0`` transforms direction vectors."""
    res = pts @ h4[:3, :3].T + fill * h4[:3, 3]
    if h4.shape[0] == 4:
        w = pts @ h4[3, :3] + fill * h4[3, 3]
        if fill == 1.0:
            res = res / w[..., None]
    return res


def project_h(pts: torch.Tensor, p34: torch.Tensor) -> torch.Tensor:
    """Project points (..., 3) with a (3, 4) projective matrix, with the
    divide."""
    xyw = pts @ p34[:, :3].T + p34[:, 3]
    return xyw[..., :2] / xyw[..., 2:3]


def geometric_median(pts: torch.Tensor, iters: int = 50,
                     eps: float = 1e-12) -> torch.Tensor:
    """Weiszfeld geometric median of (N, 3) points, a fixed iteration
    count (no host read)."""
    med = torch.mean(pts, dim=0)
    for _ in range(iters):
        d = torch.linalg.norm(pts - med, dim=1)
        w = 1.0 / torch.clamp(d, min=eps)
        med = torch.sum(pts * w[:, None], dim=0) / torch.sum(w)
    return med


def make_cartesian(polar: torch.Tensor) -> torch.Tensor:
    """Spherical (lat, lng) (..., 2) -> cartesian unit vectors (..., 3);
    lat = 0 is the equator (z = 0), lat = +pi/2 the -z pole."""
    lat = polar[..., 0] + np.pi / 2
    lng = polar[..., 1]
    st = torch.sin(lat)
    return torch.stack([st * torch.cos(lng), st * torch.sin(lng),
                        torch.cos(lat)], dim=-1)


def make_polar(xyz: torch.Tensor) -> torch.Tensor:
    """Cartesian vectors (..., 3) -> spherical (lat, lng) (..., 2), the
    inverse of :func:`make_cartesian`."""
    n = xyz / torch.linalg.norm(xyz, dim=-1, keepdim=True)
    lat = torch.arccos(torch.clamp(n[..., 2], -1.0, 1.0)) - np.pi / 2
    lng = torch.arctan2(n[..., 1], n[..., 0])
    return torch.stack([lat, lng], dim=-1)


def pairwise_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise Euclidean distances (N, M) between (N, 3) and (M, 3)."""
    d2 = torch.sum((a[:, None, :] - b[None, :, :]) ** 2, dim=-1)
    return torch.sqrt(torch.clamp(d2, min=0.0))


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
