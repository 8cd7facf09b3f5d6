"""Trajectory smoothing for tracked target poses.

Counterpart of ``pycamset_tpu/smoothing.py``: a fixed-interval RTS
(Rauch-Tung-Striebel) smoother with a constant-velocity prior over the
12-dim state [rvec(3), t(3), rvec_dot(3), t_dot(3)].

- The forward Kalman filter and the backward RTS pass run on ``device``
  (the card unless the caller names another) as two loops of 12 x 12
  products over the frames, JAX's two ``lax.scan``s; the innovation and
  gain solves are Cholesky solves (``cholesky_ex``: no host read).
- Each frame's measurement noise is the tracker's own 6 x 6 pose
  covariance (``info["pose_cov"]``); frames the tracker lost (non-finite)
  coast on the motion prior.
- Rotation vectors are unwrapped on the host first (``unwrap_rvecs``: one
  continuous branch of the Rodrigues chart).
"""
from __future__ import annotations

import numpy as np
import torch

from pycamset_tpu_torch.config import default_device_dtype, resolve_device
from pycamset_tpu_torch.utils.general_utils import (ext_4x4_to_rod,
                                                    make_4x4h_tform)

# measurement variance of a channel with no information (inf/NaN sigma,
# lost frames): large against pixel-scale pose covariances, far from
# overflowing float32 when inverted
_HUGE_VAR = 1e12


def unwrap_rvecs(rvecs: np.ndarray,
                 valid: np.ndarray | None = None) -> np.ndarray:
    """One continuous branch of the Rodrigues chart along a trajectory:
    per frame the representative ``r * (1 - 2 pi k / |r|)``, k in
    {-1, 0, 1}, closest to the previous VALID frame. Invalid frames pass
    through untouched and never anchor the choice."""
    out = np.array(rvecs, dtype=float, copy=True)
    prev = None
    for i in range(len(out)):
        if valid is not None and not valid[i]:
            continue
        if prev is not None:
            r = out[i]
            th = np.linalg.norm(r)
            cands = [r]
            if th > 1e-12:
                cands += [r * (1.0 - 2.0 * np.pi / th),
                          r * (1.0 + 2.0 * np.pi / th)]
            d = [np.linalg.norm(c - prev) for c in cands]
            out[i] = cands[int(np.argmin(d))]
        prev = out[i]
    return out


def _build_cv_model(dt: float, q_rot: float, q_trans: float, dtype):
    """Constant-velocity transition F (12 x 12) and process noise Q of a
    white-noise-acceleration prior with spectral densities q_rot / q_trans
    ((rad|m)^2 / s^3), numpy arrays of ``dtype``."""
    f = np.eye(12)
    f[:6, 6:] = dt * np.eye(6)
    q3, q2, q1 = dt ** 3 / 3.0, dt ** 2 / 2.0, dt
    q = np.zeros((12, 12))
    dens = np.array([q_rot] * 3 + [q_trans] * 3)
    for i in range(6):
        q[i, i] = q3 * dens[i]
        q[i, i + 6] = q[i + 6, i] = q2 * dens[i]
        q[i + 6, i + 6] = q1 * dens[i]
    return np.asarray(f, dtype), np.asarray(q, dtype)


def _pos_solve_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a^-1 b)^T for SPD ``a``: JAX's ``solve(a, b, assume_a="pos").T``."""
    chol = torch.linalg.cholesky_ex(a)[0]
    return torch.cholesky_solve(b, chol).T


def rts_device(z, r_cov, f, q, p0):
    """Forward Kalman + backward RTS over (I, 6) measurements on their
    device: measurement model z = x[:6] + noise(r_cov per frame).

    :return: (xs (I, 12) smoothed states, ps (I, 12, 12) covariances).
    """
    n = z.shape[0]
    eye12 = torch.eye(12, dtype=z.dtype, device=z.device)
    h = eye12[:6]
    x = torch.cat([z[0], torch.zeros(6, dtype=z.dtype, device=z.device)])
    p = p0
    xf, pf, xp, pp = [], [], [], []
    for k in range(n):
        rk = r_cov[k]
        s = h @ p @ h.T + rk                       # innovation (6, 6)
        gain = _pos_solve_t(s, h @ p)              # (12, 6)
        x = x + gain @ (z[k] - h @ x)
        kh = eye12 - gain @ h
        p = kh @ p @ kh.T + gain @ rk @ gain.T     # Joseph form (stable)
        xf.append(x)
        pf.append(p)
        x, p = f @ x, f @ p @ f.T + q
        xp.append(x)
        pp.append(p)
    xs, ps = [None] * n, [None] * n
    xs[-1], ps[-1] = xf[-1], pf[-1]
    for k in range(n - 2, -1, -1):
        # x_s[k] = x_f[k] + G (x_s[k+1] - x_p[k]), G = P_f F^T P_p^-1
        g = _pos_solve_t(pp[k], f @ pf[k])
        xs[k] = xf[k] + g @ (xs[k + 1] - xp[k])
        ps[k] = pf[k] + g @ (ps[k + 1] - pp[k]) @ g.T
    return torch.stack(xs), torch.stack(ps)


def smooth_pose_trajectory(poses: np.ndarray,
                           pose_cov: np.ndarray | None = None,
                           pose_sigma: np.ndarray | None = None,
                           dt: float = 1.0,
                           q_rot: float = 1e-3,
                           q_trans: float = 1e-3,
                           return_velocity: bool = False,
                           device="cuda", dtype=None):
    """RTS-smooth a tracked pose trajectory with a constant-velocity prior.

    :param poses: (I, 4, 4) target->world transforms, or (I, 6) rows.
    :param pose_cov: optional (I, 6, 6) per-frame covariances (the
        tracker's ``info["pose_cov"]``); non-finite marks a lost frame.
    :param pose_sigma: optional (I, 6) standard errors, used diagonally
        when ``pose_cov`` is not given.
    :param dt: the frame step (s). :param q_rot, q_trans: the white-noise
        acceleration densities (smaller: stiffer).
    :param return_velocity: also return (I, 6) [rvec_dot | t_dot].
    :param device: where the recursion runs (the card unless the caller
        names another); :param dtype: default float64 on the CPU, float32
        on a card.
    :return: (poses (I, 4, 4), sigmas (I, 6)), or (poses, velocities,
        sigmas) with ``return_velocity``.
    """
    poses = np.asarray(poses, dtype=float)
    if poses.ndim == 3 and poses.shape[1:] == (4, 4):
        z6 = np.stack([np.concatenate(ext_4x4_to_rod(t)) for t in poses])
    elif poses.ndim == 2 and poses.shape[1] == 6:
        z6 = poses.copy()
    else:
        raise ValueError("poses must be (I, 4, 4) or (I, 6); got "
                         f"{poses.shape}")
    n = len(z6)
    if n < 2:
        raise ValueError("need at least 2 frames to smooth")

    if pose_cov is not None:
        r = np.array(pose_cov, dtype=float, copy=True).reshape(n, 6, 6)
    elif pose_sigma is not None:
        sg = np.asarray(pose_sigma, dtype=float).reshape(n, 6)
        r = np.stack([np.diag(s ** 2) for s in sg])
    else:
        r = np.tile(np.eye(6) * 1e-6, (n, 1, 1))
    # lost frames: no information, a huge diagonal (not inf: the
    # innovation solve stays finite) makes their gain ~0
    bad = ~np.all(np.isfinite(r), axis=(1, 2))
    r[bad] = np.eye(6) * _HUGE_VAR
    # unwrap after marking the lost frames: their rows may hold garbage
    z6[:, :3] = unwrap_rvecs(z6[:, :3], valid=~bad)
    if bad.all():
        raise ValueError("every frame is marked lost (non-finite "
                         "pose_cov); nothing to smooth")
    if bad[0]:
        # the filter seeds its state from frame 0: take the first tracked
        z6[0] = z6[np.flatnonzero(~bad)[0]]
    # rank-deficient covariances clipped away from singular
    for i in range(n):
        d = np.diag(r[i])
        np.fill_diagonal(r[i], np.where(np.isfinite(d) & (d > 0),
                                        d, _HUGE_VAR))

    device = resolve_device(device)
    dtype = dtype or default_device_dtype(device)
    f, q = _build_cv_model(dt, q_rot, q_trans, np.float64)
    p0 = np.eye(12)
    p0[:6, :6] = r[0]
    p0[6:, 6:] *= 1e2 * max(q_rot, q_trans) / max(dt, 1e-9)

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)
    xs, ps = rts_device(dev(z6), dev(r), dev(f), dev(q), dev(p0))
    xs = xs.double().cpu().numpy()
    ps = ps.double().cpu().numpy()
    out_poses = np.stack([make_4x4h_tform(x[:3], x[3:6]) for x in xs])
    out_sigma = np.sqrt(np.clip(
        np.einsum("fii->fi", ps[:, :6, :6]), 0.0, None))
    if return_velocity:
        return out_poses, xs[:, 6:], out_sigma
    return out_poses, out_sigma
