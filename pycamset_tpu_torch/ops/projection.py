"""The camera projection (counterpart of ``project_cam_points``,
``intr9_from_k_dist`` and ``k_dist_from_intr9`` in
``pycamset_tpu/ops/projection.py``): the packed intrinsic vector is
[fx, px, fy, py | dist], 9 entries for the standard model, 12 rational, 16
thin-prism, 18 tilted and 8 fisheye (``ops/distortion.py``)."""
from __future__ import annotations

import torch

from pycamset_tpu_torch.ops.distortion import distort_normalized


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
