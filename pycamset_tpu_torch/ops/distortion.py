"""Brown–Conrady lens distortion, standard 5-coefficient model.

Counterpart of ``distort_normalized``, ``distort_pixels``,
``undistort_normalized`` and ``undistort_pixels`` in
``pycamset_tpu/ops/distortion.py`` for dist = [k1, k2, p1, p2, k3] (OpenCV
order); the coefficients broadcast against the points (``dist`` (..., 5),
``kmat`` (..., 3, 3)). The rational, thin-prism, tilted and fisheye widths
are not ported yet (ROADMAP Queue A item 7).
"""
from __future__ import annotations

import torch


def _standard_only(dist: torch.Tensor):
    if dist.shape[-1] != 5:
        raise NotImplementedError(
            f"{dist.shape[-1]}-coefficient distortion is not ported yet "
            f"(ROADMAP Queue A item 7); only the standard 5-coefficient "
            f"model is")


def distort_normalized(xy: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Forward-distort normalized coords (..., 2); dist (..., 5)."""
    _standard_only(dist)
    x = xy[..., 0]
    y = xy[..., 1]
    k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def _focal_centre(kmat: torch.Tensor):
    f = torch.stack([kmat[..., 0, 0], kmat[..., 1, 1]], dim=-1)
    c = torch.stack([kmat[..., 0, 2], kmat[..., 1, 2]], dim=-1)
    return f, c


def distort_pixels(uv: torch.Tensor, kmat: torch.Tensor,
                   dist: torch.Tensor) -> torch.Tensor:
    """Forward-distort pixel coords (..., 2) given (3, 3) intrinsics."""
    f, c = _focal_centre(kmat)
    return distort_normalized((uv - c) / f, dist) * f + c


def undistort_normalized(xy_d: torch.Tensor, dist: torch.Tensor,
                         iters: int = 8) -> torch.Tensor:
    """Invert the distortion on normalized coords by fixed-point iteration
    (``iters`` rounds from the distorted point, as the JAX package's
    ``lax.fori_loop``)."""
    _standard_only(dist)
    k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))
    xd, yd = xy_d[..., 0], xy_d[..., 1]
    xy = xy_d
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xy = torch.stack([(xd - dx) / radial, (yd - dy) / radial], dim=-1)
    return xy


def undistort_pixels(uv: torch.Tensor, kmat: torch.Tensor, dist: torch.Tensor,
                     iters: int = 8) -> torch.Tensor:
    """Invert distortion for pixel coords (..., 2): ideal pixel coords."""
    f, c = _focal_centre(kmat)
    return undistort_normalized((uv - c) / f, dist, iters=iters) * f + c
