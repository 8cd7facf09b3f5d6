"""The camera projection (counterpart of ``project_cam_points``,
``project_cam_points_het``, ``pack_rig_intrinsics``, ``intr9_from_k_dist``,
``k_dist_from_intr9``, ``project_world_points`` and
``project_target_points`` in ``pycamset_tpu/ops/projection.py``): the
packed intrinsic vector is [fx, px, fy, py | dist], 9 entries for the
standard model, 12 rational, 16 thin-prism, 18 tilted and 8 fisheye
(``ops/distortion.py``); a heterogeneous rig (fisheye beside Brown
cameras) packs [sel | fx px fy py | dist slots], the family selector
first."""
from __future__ import annotations

import numpy as np
import torch

from pycamset_tpu_torch.ops.distortion import (distort_normalized,
                                               fisheye_distort_normalized)
from pycamset_tpu_torch.ops.transforms import pose_apply


def intr9_from_k_dist(kmat, dist, n_dist: int = 5) -> torch.Tensor:
    """(3, 3) intrinsic + distortion -> packed [fx, px, fy, py, dist...],
    the distortion padded with zeros or cut to ``n_dist`` coefficients
    (5 standard, 8 rational, 12 thin-prism, 14 tilted, 4 fisheye)."""
    kmat = torch.as_tensor(kmat)
    dist = torch.as_tensor(dist, dtype=kmat.dtype).reshape(-1)
    dist = torch.cat([dist, dist.new_zeros(max(0, n_dist - dist.shape[0]))]
                     )[:n_dist]
    return torch.cat([torch.stack([kmat[0, 0], kmat[0, 2], kmat[1, 1],
                                   kmat[1, 2]]), dist])


def k_dist_from_intr9(intr9: torch.Tensor):
    """Packed intrinsic vector -> ((3, 3) intrinsic, distortion)."""
    fx, px, fy, py = intr9[0], intr9[1], intr9[2], intr9[3]
    one, zero = torch.ones_like(fx), torch.zeros_like(fx)
    kmat = torch.stack([fx, zero, px, zero, fy, py, zero, zero,
                        one]).reshape(3, 3)
    return kmat, intr9[4:]


def project_cam_points(intr9: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """Project camera-frame points (..., 3) to distorted pixels (..., 2);
    the packed intrinsics (..., 4 + n_dist) broadcast against the points'
    leading dims."""
    fx, px, fy, py = (intr9[..., i] for i in range(4))
    inv_z = 1.0 / xc[..., 2]
    xy = xc[..., :2] * inv_z[..., None]
    xy_d = distort_normalized(xy, intr9[..., 4:])
    u = xy_d[..., 0] * fx + px
    v = xy_d[..., 1] * fy + py
    return torch.stack([u, v], dim=-1)


def project_cam_points_het(intr_het: torch.Tensor, xc: torch.Tensor,
                           brown_n_dist: int = 5) -> torch.Tensor:
    """Project through a heterogeneous row [sel, fx, px, fy, py, dist...]
    (..., 5 + w): sel = 0 the Brown model of ``brown_n_dist``
    coefficients, sel = 1 the fisheye with k1..k4 in the first four
    distortion slots. Both branches are evaluated and selected per point
    (each is finite on the other family's coefficients)."""
    fx, px, fy, py = (intr_het[..., i] for i in range(1, 5))
    dist = intr_het[..., 5:]
    inv_z = 1.0 / xc[..., 2]
    xy = xc[..., :2] * inv_z[..., None]
    xy_brown = distort_normalized(xy, dist[..., :brown_n_dist])
    xy_fish = fisheye_distort_normalized(xy, dist[..., :4])
    xy_d = torch.where(intr_het[..., 0, None] > 0.5, xy_fish, xy_brown)
    u = xy_d[..., 0] * fx + px
    v = xy_d[..., 1] * fy + py
    return torch.stack([u, v], dim=-1)


def pack_rig_intrinsics(kmats, dist_list):
    """Packed per-camera intrinsic rows and the projection that reads them.

    A rig of one family keeps [fx, px, fy, py | dist] (the narrower Brown
    vectors zero-padded to the widest) and ``project_cam_points``; a rig
    mixing 4-wide fisheye vectors with Brown ones packs the selector
    layout [sel | fx px fy py | dist] and projects through
    ``project_cam_points_het``.

    :param kmats: per-camera (3, 3) intrinsics.
    :param dist_list: per-camera distortion vectors (native widths).
    :return: (rows (C, w) float64 numpy, project_fn(intr_row, xc)).
    """
    dl = [np.reshape(np.asarray(d, dtype=float), -1) for d in dist_list]
    sizes = {d.size for d in dl}
    if not (4 in sizes and sizes != {4}):
        n_dist = 4 if sizes == {4} else max(5, max(sizes, default=5))
        rows = np.stack([
            intr9_from_k_dist(torch.as_tensor(np.asarray(k, dtype=float)),
                              torch.as_tensor(d), n_dist=n_dist).numpy()
            for k, d in zip(kmats, dl)])
        return rows, project_cam_points
    n_brown = max(5, max(s for s in sizes if s != 4))
    w = 5 + max(n_brown, 4)
    rows = np.zeros((len(dl), w))
    for i, (k, d) in enumerate(zip(kmats, dl)):
        k = np.asarray(k, dtype=float)
        rows[i, 0] = 1.0 if d.size == 4 else 0.0
        rows[i, 1:5] = [k[0, 0], k[0, 2], k[1, 1], k[1, 2]]
        n = 4 if d.size == 4 else w - 5
        rows[i, 5:5 + min(d.size, n)] = d[:n]

    def project_het(intr_row, xc):
        return project_cam_points_het(intr_row, xc, brown_n_dist=n_brown)

    return rows, project_het


def project_world_points(intr9: torch.Tensor, extr6: torch.Tensor,
                         pts_w: torch.Tensor) -> torch.Tensor:
    """World points (..., 3) -> pixels: the extrinsic, then the
    projection."""
    return project_cam_points(intr9, pose_apply(extr6, pts_w))


def project_target_points(intr9: torch.Tensor, extr6: torch.Tensor,
                          pose6: torch.Tensor,
                          pts_t: torch.Tensor) -> torch.Tensor:
    """Target-frame points -> pixels: the template chain (target pose,
    extrinsic, projection), right to left."""
    return project_cam_points(intr9, pose_apply(extr6,
                                                pose_apply(pose6, pts_t)))
