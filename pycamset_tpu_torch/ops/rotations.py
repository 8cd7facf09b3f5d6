"""Rotation kernels (axis-angle / Rodrigues) as batched PyTorch functions.

Counterpart of ``pycamset_tpu/ops/rotations.py``. The JAX package takes the
derivative of :func:`rodrigues_to_matrix` with ``jax.jacfwd``
(``pallas_grams.pack_block_params``, ``analytic._rot_and_jac``); here it is
the closed form :func:`rodrigues_jacobian`, which reproduces both branches
of the JAX function, the small-angle one included. :func:`matrix_to_rodrigues`
is the inverse map (the tracker's device seeding).
"""
from __future__ import annotations

import torch

_SMALL_ANGLE_SQ = 1e-16


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


def _angle_axis(rvec: torch.Tensor):
    """(big, theta, k): the guarded angle and unit axis of the JAX form
    (theta = 1 and k = 0 where theta^2 <= the small-angle threshold)."""
    theta2 = torch.sum(rvec * rvec, dim=-1)
    big = theta2 > _SMALL_ANGLE_SQ
    theta = torch.sqrt(torch.where(big, theta2, torch.ones_like(theta2)))
    k = torch.where(big[..., None], rvec / theta[..., None],
                    torch.zeros_like(rvec))
    return big, theta, k


def rodrigues_to_matrix(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3).

    Above the small-angle threshold (theta^2 > 1e-16) the full Rodrigues
    formula, below it the first-order expansion ``I + skew(r)``, as in the
    JAX function.
    """
    big, theta, k = _angle_axis(rvec)
    c = torch.cos(theta)[..., None, None]
    s = torch.sin(theta)[..., None, None]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    kk = k[..., :, None] * k[..., None, :]
    r_full = c * eye + s * skew(k) + (1.0 - c) * kk
    r_small = eye + skew(rvec)
    return torch.where(big[..., None, None], r_full, r_small)


def rodrigues_jacobian(rvec: torch.Tensor) -> torch.Tensor:
    """dR/dr in closed form: (..., 3) -> (..., 3, 3, 3) with index
    [..., j, a, b] = dR[a, b] / dr[j].

    This is the JAX layout after ``moveaxis(jacfwd(...), -1, 0)``. Above
    the threshold, with k = r / theta and dk_j = (e_j - k k_j) / theta:

        dR/dr_j = -s k_j I + c k_j [k]x + s [dk_j]x
                  + s k_j k k^T + (1 - c) (dk_j k^T + k dk_j^T)

    Below it (pose 0 is exactly zero in every bench problem) the
    derivative of ``I + skew(r)``: dR/dr_j = skew(e_j), never 0/0.
    """
    big, theta, k = _angle_axis(rvec)
    c = torch.cos(theta)[..., None, None, None]
    s = torch.sin(theta)[..., None, None, None]
    eye3 = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    kj = k[..., :, None, None]                                 # (...,j,1,1)
    # dk[..., j, :] = (e_j - k k_j) / theta
    dk = (eye3 - k[..., :, None] * k[..., None, :]) / theta[..., None, None]
    kk = (k[..., :, None] * k[..., None, :])[..., None, :, :]  # (...,1,3,3)
    skew_k = skew(k)[..., None, :, :]
    outer_dk = dk[..., :, :, None] * k[..., None, None, :]    # dk_j k^T
    d_full = (-s * kj * eye3 + c * kj * skew_k + s * skew(dk)
              + s * kj * kk
              + (1.0 - c) * (outer_dk + outer_dk.transpose(-1, -2)))
    d_small = skew(eye3).expand(d_full.shape)
    return torch.where(big[..., None, None, None], d_full, d_small)


def matrix_to_rodrigues(rmat: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle (..., 3); the inverse
    of :func:`rodrigues_to_matrix`.

    The theta ~ 0 and theta ~ pi branches are taken by select, with no
    data-dependent control flow, as in the JAX function, so it runs under
    ``torch.func.vmap`` and inside an exported program.
    """
    trace = rmat[..., 0, 0] + rmat[..., 1, 1] + rmat[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)

    # generic branch: the axis from the antisymmetric part
    w = torch.stack([rmat[..., 2, 1] - rmat[..., 1, 2],
                     rmat[..., 0, 2] - rmat[..., 2, 0],
                     rmat[..., 1, 0] - rmat[..., 0, 1]], dim=-1)
    sin_t = torch.sin(theta)
    generic_ok = torch.abs(sin_t) > 1e-6
    safe_sin = torch.where(generic_ok, sin_t, torch.ones_like(sin_t))
    r_generic = w * (theta / (2.0 * safe_sin))[..., None]
    r_small = 0.5 * w

    # theta ~ pi: the axis from the diagonal of (R + I) / 2 = k k^T, the
    # signs from the off-diagonals with the largest component as anchor
    kk = (torch.diagonal(rmat, dim1=-2, dim2=-1) + 1.0) * 0.5
    k = torch.sqrt(torch.clamp(kk, min=0.0))
    imax = torch.argmax(k, dim=-1)
    one = torch.ones_like(theta)
    s01, s02, s12 = (torch.sign(rmat[..., 0, 1]), torch.sign(rmat[..., 0, 2]),
                     torch.sign(rmat[..., 1, 2]))
    signs_by_anchor = torch.stack([
        torch.stack([one, s01, s02], dim=-1),
        torch.stack([s01, one, s12], dim=-1),
        torch.stack([s02, s12, one], dim=-1)], dim=-2)
    sign = torch.gather(
        signs_by_anchor, -2,
        imax[..., None, None].expand(imax.shape + (1, 3)))[..., 0, :]
    sign = torch.where(sign == 0.0, torch.ones_like(sign), sign)
    r_pi = k * sign * theta[..., None]

    near_pi = (cos_t < -0.999999)[..., None]
    return torch.where(near_pi, r_pi,
                       torch.where(generic_ok[..., None], r_generic, r_small))


# the JAX package's vmapped names; these functions take any leading dims
rodrigues_to_matrix_batch = rodrigues_to_matrix
matrix_to_rodrigues_batch = matrix_to_rodrigues
