"""Batched n-view DLT triangulation.

Counterpart of ``triangulate_nviews`` and ``triangulate_observations``
(``method="homogeneous"``; ``het`` for a rig mixing fisheye and Brown
cameras) in
``pycamset_tpu/ops/triangulation.py``, in plain torch: views padded to a
common count with a validity mask (zero rows add nothing to the normal
matrix, so padding is exact), each observation undistorted by fixed point,
and the point the smallest eigenvector of the 4x4 normal matrix, one
batched ``eigh`` over every point.
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


def triangulate_observations(proj_all: torch.Tensor, kmats: torch.Tensor,
                             dists: torch.Tensor, cam_idx: torch.Tensor,
                             uv: torch.Tensor, mask: torch.Tensor,
                             het: bool = False) -> torch.Tensor:
    """Triangulate a batch of points from padded observation tables.

    :param proj_all: (C, 3, 4) per-camera projection matrices.
    :param kmats: (C, 3, 3) intrinsics; :param dists: (C, n)
        distortion, n one of 4, 5, 8, 12, 14 (``ops/distortion.py``), or
        with ``het=True`` (C, 1 + n) rows [sel | coefs] of a rig mixing
        fisheye and Brown cameras (``undistort_pixels_het``).
    :param cam_idx: (N, V) camera of each observation slot.
    :param uv: (N, V, 2) raw (distorted) pixels; :param mask: (N, V).
    :return: (N, 3) points.
    """
    und = (undistort_pixels_het if het else undistort_pixels)(
        uv, kmats[cam_idx], dists[cam_idx])
    return triangulate_nviews(proj_all[cam_idx], und, mask)
