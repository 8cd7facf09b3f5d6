"""Batched n-view DLT triangulation.

Counterpart of ``triangulate_nviews``,
``triangulate_nviews_inhomogeneous`` and ``triangulate_observations``
(``method="homogeneous" | "inhomogeneous"``; ``het`` for a rig mixing
fisheye and Brown cameras) in ``pycamset_tpu/ops/triangulation.py``, in
plain torch: views padded to a common count with a validity mask (zero rows
add nothing to the normal matrix, so padding is exact), each observation
undistorted by fixed point. The homogeneous point is the smallest
eigenvector of the 4x4 normal matrix, one batched ``eigh`` over every point
(accuracy grade; ``eigh`` reads its status on the host); the inhomogeneous
one fixes w = 1 and solves the 3x3 normal system by its adjugate, plain
arithmetic with no host read (the tracker's seeding grade).
"""
from __future__ import annotations

import torch

from pycamset_tpu_torch.ops.distortion import (undistort_pixels,
                                               undistort_pixels_het)


def triangulate_nviews(proj: torch.Tensor, uv: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Triangulate points from up to V views each by DLT.

    :param proj: (N, V, 3, 4) projection matrices (K @ E[:3, :4]).
    :param uv: (N, V, 2) ideal (undistorted) pixel observations.
    :param mask: (N, V) 1 for valid views, 0 for padding.
    :return: (N, 3) points.
    """
    r1 = uv[..., 0:1] * proj[..., 2, :] - proj[..., 0, :]   # (N, V, 4)
    r2 = uv[..., 1:2] * proj[..., 2, :] - proj[..., 1, :]
    m = torch.cat([r1, r2], dim=-2)                           # (N, 2V, 4)
    mvalid = torch.cat([mask, mask], dim=-1)[..., None]
    # row normalisation improves f32 conditioning; padded rows stay zero
    norms = torch.linalg.norm(m, dim=-1, keepdim=True)
    m = m / torch.clamp(norms, min=1e-12) * mvalid
    mtm = m.transpose(-1, -2) @ m
    _, vecs = torch.linalg.eigh(mtm)
    x_h = vecs[..., :, 0]                     # smallest eigenvalue's vector
    return x_h[..., :3] / x_h[..., 3:]


def triangulate_nviews_inhomogeneous(proj: torch.Tensor, uv: torch.Tensor,
                                     mask: torch.Tensor) -> torch.Tensor:
    """Inhomogeneous DLT: w fixed at 1 and the 3x3 normal system solved in
    closed form (adjugate), no ``eigh``. Loses only points at infinity,
    which no physical target pose produces. Shapes as
    :func:`triangulate_nviews`; padding points (no views) stay finite."""
    r1 = uv[..., 0:1] * proj[..., 2, :] - proj[..., 0, :]   # (N, V, 4)
    r2 = uv[..., 1:2] * proj[..., 2, :] - proj[..., 1, :]
    m = torch.cat([r1, r2], dim=-2)                           # (N, 2V, 4)
    mvalid = torch.cat([mask, mask], dim=-1)[..., None]
    norms = torch.linalg.norm(m, dim=-1, keepdim=True)
    m = m / torch.clamp(norms, min=1e-12) * mvalid
    bmat, rhs = m[..., :3], -m[..., 3]
    nmat = bmat.transpose(-1, -2) @ bmat         # (N, 3, 3), SPD at >= 2 views
    g = (bmat.transpose(-1, -2) @ rhs[..., None])[..., 0]
    a, b, c = nmat[..., 0, 0], nmat[..., 0, 1], nmat[..., 0, 2]
    d, e, f = nmat[..., 1, 1], nmat[..., 1, 2], nmat[..., 2, 2]
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    det = a * co00 + b * co01 + c * co02
    adj = torch.stack([torch.stack([co00, co01, co02], dim=-1),
                       torch.stack([co01, co11, co12], dim=-1),
                       torch.stack([co02, co12, co22], dim=-1)], dim=-2)
    # eps keeps padding finite
    det = torch.where(torch.abs(det) > 1e-30, det,
                      torch.full_like(det, 1e-30))
    return (adj @ g[..., None])[..., 0] / det[..., None]


def triangulate_observations(proj_all: torch.Tensor, kmats: torch.Tensor,
                             dists: torch.Tensor, cam_idx: torch.Tensor,
                             uv: torch.Tensor, mask: torch.Tensor,
                             method: str = "homogeneous",
                             het: bool = False) -> torch.Tensor:
    """Triangulate a batch of points from padded observation tables.

    :param proj_all: (C, 3, 4) per-camera projection matrices.
    :param kmats: (C, 3, 3) intrinsics; :param dists: (C, n)
        distortion, n one of 4, 5, 8, 12, 14 (``ops/distortion.py``), or
        with ``het=True`` (C, 1 + n) rows [sel | coefs] of a rig mixing
        fisheye and Brown cameras (``undistort_pixels_het``).
    :param cam_idx: (N, V) camera of each observation slot.
    :param uv: (N, V, 2) raw (distorted) pixels; :param mask: (N, V).
    :param method: ``"homogeneous"`` (4x4 eigh, the default) or
        ``"inhomogeneous"`` (3x3 closed form).
    :return: (N, 3) points.
    """
    if method not in ("homogeneous", "inhomogeneous"):
        raise ValueError(f"unknown method {method!r}; expected "
                         "'homogeneous' or 'inhomogeneous'")
    tri = (triangulate_nviews if method == "homogeneous"
           else triangulate_nviews_inhomogeneous)
    und = (undistort_pixels_het if het else undistort_pixels)(
        uv, kmats[cam_idx], dists[cam_idx])
    return tri(proj_all[cam_idx], und, mask)
