"""Lens distortion of the five camera models.

Counterpart of ``distort_normalized``, ``distort_pixels``,
``undistort_normalized``, ``undistort_pixels``, ``fisheye_theta_d``,
``fisheye_distort_normalized``, ``fisheye_undistort_normalized``,
``_tilt_matrix``, ``_apply_tilt`` and the heterogeneous-row functions
(``distort_normalized_het``, ``undistort_normalized_het``,
``undistort_pixels_het``) in ``pycamset_tpu/ops/distortion.py``.
The width of ``dist`` names the model (OpenCV order): 5 standard
[k1, k2, p1, p2, k3], 8 rational (+ k4, k5, k6: radial = num / den), 12
thin-prism (+ s1..s4), 14 tilted (+ taux, tauy: the sensor-tilt
homography) and 4 the fisheye [k1..k4] (Kannala-Brandt, cv2.fisheye). The
coefficients broadcast against the points (``dist`` (..., n), ``kmat``
(..., 3, 3)). A heterogeneous row ``[sel | coefs]`` (fisheye and Brown
cameras in one rig) selects the family per camera: sel = 1 the fisheye
with k1..k4 in the first four slots, sel = 0 the Brown model of the slot
width; both branches are evaluated and selected, so no host read decides.
"""
from __future__ import annotations

import torch

# distortion widths of the camera models
DIST_WIDTHS = (4, 5, 8, 12, 14)


def _check_width(dist: torch.Tensor):
    if dist.shape[-1] not in DIST_WIDTHS:
        raise NotImplementedError(
            f"{dist.shape[-1]}-coefficient distortion: the models take "
            f"{DIST_WIDTHS} coefficients (a heterogeneous [sel | coefs] row "
            f"goes through the *_het functions)")


def _radial_factor(r2: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Polynomial (5-coefficient) or rational (8 and more) radial factor."""
    k1, k2, k3 = dist[..., 0], dist[..., 1], dist[..., 4]
    num = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    if dist.shape[-1] >= 8:
        k4, k5, k6 = dist[..., 5], dist[..., 6], dist[..., 7]
        return num / (1.0 + r2 * (k4 + r2 * (k5 + r2 * k6)))
    return num


def tilt_matrix(taux: torch.Tensor, tauy: torch.Tensor) -> torch.Tensor:
    """OpenCV's sensor-tilt (Scheimpflug) matrix, (..., 3, 3):
    projZ(R) @ R with R = Ry(tauy) @ Rx(taux), cv2's
    computeTiltProjectionMatrix."""
    cx, sx = torch.cos(taux), torch.sin(taux)
    cy, sy = torch.cos(tauy), torch.sin(tauy)
    one, zero = torch.ones_like(cx), torch.zeros_like(cx)
    rx = torch.stack([one, zero, zero, zero, cx, sx, zero, -sx, cx],
                     dim=-1).reshape(*cx.shape, 3, 3)
    ry = torch.stack([cy, zero, -sy, zero, one, zero, sy, zero, cy],
                     dim=-1).reshape(*cx.shape, 3, 3)
    r = ry @ rx
    projz = torch.stack([r[..., 2, 2], zero, -r[..., 0, 2],
                         zero, r[..., 2, 2], -r[..., 1, 2],
                         zero, zero, one], dim=-1).reshape(*cx.shape, 3, 3)
    return projz @ r


def tilt_matrix_jacobian(taux: torch.Tensor, tauy: torch.Tensor):
    """(dMt/dtaux, dMt/dtauy), each (..., 3, 3), in closed form (the JAX
    package takes them by ``jax.jacfwd``): Mt = P(R) R with R = Ry Rx and
    P(R) = [[r22, 0, -r02], [0, r22, -r12], [0, 0, 1]], so
    dMt = P(dR) R + P(R) dR with P's linear part at dR."""
    cx, sx = torch.cos(taux), torch.sin(taux)
    cy, sy = torch.cos(tauy), torch.sin(tauy)
    one, zero = torch.ones_like(cx), torch.zeros_like(cx)

    def mat(*e):
        return torch.stack(e, dim=-1).reshape(*cx.shape, 3, 3)

    rx = mat(one, zero, zero, zero, cx, sx, zero, -sx, cx)
    ry = mat(cy, zero, -sy, zero, one, zero, sy, zero, cy)
    drx = mat(zero, zero, zero, zero, -sx, cx, zero, -cx, -sx)
    dry = mat(-sy, zero, -cy, zero, zero, zero, cy, zero, -sy)
    r = ry @ rx

    def proj(m, corner):
        return mat(m[..., 2, 2], zero, -m[..., 0, 2],
                   zero, m[..., 2, 2], -m[..., 1, 2], zero, zero, corner)

    out = []
    for dr in (ry @ drx, dry @ rx):
        out.append(proj(dr, zero) @ r + proj(r, one) @ dr)
    return tuple(out)


def apply_tilt(xy: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """A 3 x 3 homography (..., 3, 3) applied to normalized coords (..., 2)."""
    x, y = xy[..., 0], xy[..., 1]
    w = mat[..., 2, 0] * x + mat[..., 2, 1] * y + mat[..., 2, 2]
    u = mat[..., 0, 0] * x + mat[..., 0, 1] * y + mat[..., 0, 2]
    v = mat[..., 1, 0] * x + mat[..., 1, 1] * y + mat[..., 1, 2]
    return torch.stack([u / w, v / w], dim=-1)


def fisheye_theta_d(theta: torch.Tensor, dist4: torch.Tensor) -> torch.Tensor:
    """Kannala-Brandt distorted angle theta (1 + k1 th^2 + ... + k4 th^8)."""
    t2 = theta * theta
    poly = 1.0 + t2 * (dist4[..., 0] + t2 * (
        dist4[..., 1] + t2 * (dist4[..., 2] + t2 * dist4[..., 3])))
    return theta * poly


def fisheye_distort_normalized(xy: torch.Tensor,
                               dist4: torch.Tensor) -> torch.Tensor:
    """The fisheye mapping of normalized coords: r = |xy|,
    theta = atan(r), xy_d = xy theta_d(theta) / r, with the radius smoothed
    (sqrt(r^2 + 1e-18)) so the on-axis point stays differentiable."""
    r2 = xy[..., 0] ** 2 + xy[..., 1] ** 2
    r = torch.sqrt(r2 + 1e-18)
    theta = torch.atan(r)
    return xy * (fisheye_theta_d(theta, dist4) / r)[..., None]


def fisheye_undistort_normalized(xy_d: torch.Tensor, dist4: torch.Tensor,
                                 iters: int = 8) -> torch.Tensor:
    """Invert the fisheye mapping: theta <- rd / poly(theta), ``iters``
    rounds from theta = rd, then xy = xy_d tan(theta) / rd."""
    rd2 = xy_d[..., 0] ** 2 + xy_d[..., 1] ** 2
    rd = torch.sqrt(rd2 + 1e-18)
    theta = rd
    for _ in range(iters):
        t2 = theta * theta
        poly = 1.0 + t2 * (dist4[..., 0] + t2 * (
            dist4[..., 1] + t2 * (dist4[..., 2] + t2 * dist4[..., 3])))
        theta = rd / poly
    return xy_d * (torch.tan(theta) / rd)[..., None]


def distort_normalized(xy: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Forward-distort normalized coords (..., 2); dist (..., n), n one of
    4, 5, 8, 12, 14."""
    _check_width(dist)
    n = dist.shape[-1]
    if n == 4:
        return fisheye_distort_normalized(xy, dist)
    x = xy[..., 0]
    y = xy[..., 1]
    p1, p2 = dist[..., 2], dist[..., 3]
    r2 = x * x + y * y
    radial = _radial_factor(r2, dist)
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    if n >= 12:
        xd = xd + r2 * (dist[..., 8] + r2 * dist[..., 9])
        yd = yd + r2 * (dist[..., 10] + r2 * dist[..., 11])
    out = torch.stack([xd, yd], dim=-1)
    if n >= 14:
        out = apply_tilt(out, tilt_matrix(dist[..., 12], dist[..., 13]))
    return out


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
    ``lax.fori_loop``); the tilt is undone first, the prism terms join the
    iterated additive part, the fisheye iterates on its angle."""
    _check_width(dist)
    n = dist.shape[-1]
    if n == 4:
        return fisheye_undistort_normalized(xy_d, dist, iters=iters)
    p1, p2 = dist[..., 2], dist[..., 3]
    if n >= 14:
        inv_tilt = torch.linalg.inv(tilt_matrix(dist[..., 12], dist[..., 13]))
        xy_d = apply_tilt(xy_d, inv_tilt)
    xd, yd = xy_d[..., 0], xy_d[..., 1]
    xy = xy_d
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = _radial_factor(r2, dist)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        if n >= 12:
            dx = dx + r2 * (dist[..., 8] + r2 * dist[..., 9])
            dy = dy + r2 * (dist[..., 10] + r2 * dist[..., 11])
        xy = torch.stack([(xd - dx) / radial, (yd - dy) / radial], dim=-1)
    return xy


def undistort_pixels(uv: torch.Tensor, kmat: torch.Tensor, dist: torch.Tensor,
                     iters: int = 8) -> torch.Tensor:
    """Invert distortion for pixel coords (..., 2): ideal pixel coords."""
    f, c = _focal_centre(kmat)
    return undistort_normalized((uv - c) / f, dist, iters=iters) * f + c


def distort_normalized_het(xy: torch.Tensor,
                           hdist: torch.Tensor) -> torch.Tensor:
    """Forward-distort through a heterogeneous row ``[sel | coefs]``
    (..., 1 + n): sel = 1 the fisheye (k1..k4 in the first four slots),
    sel = 0 the Brown model of width n. Each branch stays finite on the
    other family's coefficients, so the per-camera select is NaN-safe."""
    brown = distort_normalized(xy, hdist[..., 1:])
    fish = fisheye_distort_normalized(xy, hdist[..., 1:5])
    return torch.where(hdist[..., 0, None] > 0.5, fish, brown)


def undistort_normalized_het(xy_d: torch.Tensor, hdist: torch.Tensor,
                             iters: int = 8) -> torch.Tensor:
    """Invert a heterogeneous row's distortion
    (``distort_normalized_het``)."""
    brown = undistort_normalized(xy_d, hdist[..., 1:], iters=iters)
    fish = fisheye_undistort_normalized(xy_d, hdist[..., 1:5], iters=iters)
    return torch.where(hdist[..., 0, None] > 0.5, fish, brown)


def undistort_pixels_het(uv: torch.Tensor, kmat: torch.Tensor,
                         hdist: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """``undistort_pixels`` through a heterogeneous ``[sel | coefs]`` row."""
    f, c = _focal_centre(kmat)
    return undistort_normalized_het((uv - c) / f, hdist, iters=iters) * f + c
