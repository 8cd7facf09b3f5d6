"""Hand-eye / robot-world calibration of a multi-camera rig.

Counterpart of ``pycamset_tpu/calibration/handeye.py``. With ``G_i =
base_T_gripper[i]`` (the robot's forward kinematics) and ``P_i =
rig_T_target[i]`` (the target pose in the rig's frame, from the port's
``TargetTracker``):

- ``eye_in_hand``: the rig rides the gripper, the target is fixed in the
  base. ``X = gripper_T_rig`` and ``Z = base_T_target`` satisfy
  ``G_i X P_i = Z``.
- ``eye_to_hand``: the rig is fixed, the target rides the gripper.
  ``X = base_T_rig`` and ``Z = gripper_T_target`` satisfy
  ``X P_i = G_i Z``.

Both reduce to ``A X = X B`` over relative motions, seeded on the host by
the Park-Martin rotation-log least squares (or Tsai-Lenz), with the port's
numpy Rodrigues. Then a 12-parameter Levenberg-Marquardt over [x (6) |
z (6)] refines the pixel reprojection error of every detection through
every camera of the rig on the tensors' device (``optim/lm.
lm_solve_device``: masked steps, no host read in the loop). Its Jacobian
is closed form: the residual's partials in the camera frame
(``tracking.rig_projection_partials``) through the extrinsic, the inverse
of X (R_x^T (p - t_x)) and Z (Rodrigues' derivative); the JAX package
takes ``jax.jacfwd`` there.
"""
from __future__ import annotations

import logging
import time
from typing import NamedTuple

import numpy as np
import torch

from pycamset_tpu_torch.ops.rotations import (rodrigues_jacobian,
                                              rodrigues_to_matrix)
from pycamset_tpu_torch.ops.transforms import pose_apply, pose_inv
from pycamset_tpu_torch.tracking import rig_projection_partials
from pycamset_tpu_torch.utils.general_utils import (ext_4x4_to_rod,
                                                    make_4x4h_tform,
                                                    rodrigues_mat_to_vec)

logger = logging.getLogger(__name__)

# minimum angular spread (radians) between relative-motion rotation axes
# before the AX=XB rotation system is considered solvable
_MIN_AXIS_SPREAD = 1e-3


def _inv_h(t: np.ndarray) -> np.ndarray:
    """Invert a rigid 4x4 (host)."""
    out = np.eye(4)
    rt = t[:3, :3].T
    out[:3, :3] = rt
    out[:3, 3] = -rt @ t[:3, 3]
    return out


def _skew(v: np.ndarray) -> np.ndarray:
    return np.array([[0.0, -v[2], v[1]],
                     [v[2], 0.0, -v[0]],
                     [-v[1], v[0], 0.0]])


def _mean_rigid(ts: np.ndarray) -> np.ndarray:
    """Chordal-mean rotation (SVD projection) + mean translation."""
    m = np.mean(ts[:, :3, :3], axis=0)
    u, _, vt = np.linalg.svd(m)
    r = u @ vt
    if np.linalg.det(r) < 0:
        r = u @ np.diag([1.0, 1.0, -1.0]) @ vt
    out = np.eye(4)
    out[:3, :3] = r
    out[:3, 3] = np.mean(ts[:, :3, 3], axis=0)
    return out


def _pairs(n: int, max_pairs: int = 6000):
    """All index pairs (i, j), i < j, thinned evenly past max_pairs."""
    ii, jj = np.triu_indices(n, k=1)
    if ii.size > max_pairs:
        sel = np.linspace(0, ii.size - 1, max_pairs).round().astype(int)
        ii, jj = ii[sel], jj[sel]
    return ii, jj


def solve_ax_xb(a_tforms: np.ndarray, b_tforms: np.ndarray,
                method: str = "park") -> np.ndarray:
    """Solve ``A_i X = X B_i`` for rigid X over a set of motion pairs.

    :param a_tforms: (N, 4, 4) rigid transforms.
    :param b_tforms: (N, 4, 4) rigid transforms.
    :param method: "park" (rotation-log least squares, Park & Martin 1994)
        or "tsai" (modified-Rodrigues linear system, Tsai & Lenz 1989).
    :return: (4, 4) rigid X.
    :raises ValueError: when the motions carry too little rotation to
        determine X (all rotation axes parallel, or no rotation).
    """
    a_tforms = np.asarray(a_tforms, dtype=float)
    b_tforms = np.asarray(b_tforms, dtype=float)
    if a_tforms.shape != b_tforms.shape or a_tforms.shape[1:] != (4, 4):
        raise ValueError("a_tforms and b_tforms must both be (N, 4, 4)")
    alphas = np.stack([rodrigues_mat_to_vec(a[:3, :3]) for a in a_tforms])
    betas = np.stack([rodrigues_mat_to_vec(b[:3, :3]) for b in b_tforms])

    # solvability: rotation axes must span >= 2 directions
    norms = np.linalg.norm(alphas, axis=1)
    keep = norms > 1e-8
    if keep.sum() >= 2:
        axes = alphas[keep] / norms[keep][:, None]
        spread = np.linalg.svd(axes, compute_uv=False)
    else:
        spread = np.zeros(2)
    if spread[1] < _MIN_AXIS_SPREAD:
        raise ValueError(
            "hand-eye motions are rotationally degenerate (all relative "
            "rotations share one axis, or there is no rotation at all): "
            "X is unobservable — add robot poses that rotate about a "
            "second axis")

    if method == "park":
        m = np.einsum("ni,nj->ij", betas, alphas)
        # Rx = (M^T M)^(-1/2) M^T via SVD (also the chordal projection)
        u, s, vt = np.linalg.svd(m.T)
        rx = u @ vt
        if np.linalg.det(rx) < 0:
            rx = u @ np.diag([1.0, 1.0, -1.0]) @ vt
    elif method == "tsai":
        # modified Rodrigues p = 2 sin(theta/2) * axis
        def _p(v):
            th = np.linalg.norm(v)
            if th < 1e-12:
                return np.zeros(3)
            return 2.0 * np.sin(th / 2.0) * (v / th)
        lhs = np.concatenate([_skew(_p(al) + _p(be))
                              for al, be in zip(alphas, betas)])
        rhs = np.concatenate([_p(be) - _p(al)
                              for al, be in zip(alphas, betas)])
        pxp, *_ = np.linalg.lstsq(lhs, rhs, rcond=None)
        px = 2.0 * pxp / np.sqrt(1.0 + pxp @ pxp)
        n2 = px @ px
        rx = ((1.0 - n2 / 2.0) * np.eye(3)
              + 0.5 * (np.outer(px, px)
                       + np.sqrt(max(4.0 - n2, 0.0)) * _skew(px)))
    else:
        raise ValueError(f"unknown AX=XB method {method!r}")

    # (R_A - I) t_x = R_x t_B - t_A, stacked least squares
    lhs = np.concatenate([a[:3, :3] - np.eye(3) for a in a_tforms])
    rhs = np.concatenate([rx @ b[:3, 3] - a[:3, 3]
                          for a, b in zip(a_tforms, b_tforms)])
    tx, *_ = np.linalg.lstsq(lhs, rhs, rcond=None)
    x = np.eye(4)
    x[:3, :3] = rx
    x[:3, 3] = tx
    return x


def solve_hand_eye(base_T_gripper: np.ndarray, rig_T_target: np.ndarray,
                   mode: str = "eye_in_hand",
                   method: str = "park") -> tuple[np.ndarray, np.ndarray]:
    """Closed-form (X, Z) from synchronized robot and target poses.

    :param base_T_gripper: (N, 4, 4) forward kinematics per image.
    :param rig_T_target: (N, 4, 4) target pose in the rig frame per image.
    :param mode: "eye_in_hand" or "eye_to_hand" (module docstring).
    :return: (X, Z) rigid 4x4s.
    """
    g = np.asarray(base_T_gripper, dtype=float)
    p = np.asarray(rig_T_target, dtype=float)
    if g.shape != p.shape or g.ndim != 3 or g.shape[1:] != (4, 4):
        raise ValueError("pose arrays must both be (N, 4, 4)")
    if g.shape[0] < 3:
        raise ValueError("need at least 3 pose pairs")
    ginv = np.stack([_inv_h(t) for t in g])
    pinv = np.stack([_inv_h(t) for t in p])
    ii, jj = _pairs(g.shape[0])
    if mode == "eye_in_hand":
        # G_i X P_i = Z  =>  (G_j^-1 G_i) X = X (P_j P_i^-1)
        a = np.einsum("nij,njk->nik", ginv[jj], g[ii])
        b = np.einsum("nij,njk->nik", p[jj], pinv[ii])
        x = solve_ax_xb(a, b, method=method)
        z = _mean_rigid(np.einsum("nij,njk,nkl->nil", g, x[None].repeat(
            g.shape[0], 0), p))
    elif mode == "eye_to_hand":
        # X P_i = G_i Z  =>  (G_j G_i^-1) X = X (P_j P_i^-1)
        a = np.einsum("nij,njk->nik", g[jj], ginv[ii])
        b = np.einsum("nij,njk->nik", p[jj], pinv[ii])
        x = solve_ax_xb(a, b, method=method)
        z = _mean_rigid(np.einsum("nij,njk,nkl->nil", ginv, x[None].repeat(
            g.shape[0], 0), p))
    else:
        raise ValueError(f"unknown hand-eye mode {mode!r}")
    return x, z


class HandEyeResult(NamedTuple):
    """Hand-eye calibration output.

    x / z: the two rigid 4x4s (frames per the module docstring).
    rms: refined reprojection rms in px (NaN when refine=False).
    info: dict with the closed-form seeds, LM diagnostics, per-parameter
        sigmas (unit pixel noise scaled by the residual variance) and the
        per-image usage mask.
    """
    x: np.ndarray
    z: np.ndarray
    rms: float
    info: dict


def _pose6_of(t: np.ndarray) -> np.ndarray:
    r, tv = ext_4x4_to_rod(t)
    return np.concatenate([r, tv])


class HandEyeModel:
    """The refinement's device programs over a rig's constants: packed
    intrinsics, extrinsic rotations and translations (from the Rodrigues
    6-vectors), the template and M_i (I, 3, 4) (inv(G_i) eye-in-hand, G_i
    eye-to-hand); detections as (cam_i, im_i, key_i) int64 and uv."""

    def __init__(self, intr, extr6, tpl, m34, cam_i, im_i, key_i, uv, *,
                 het: bool, n_brown: int, loss: str, f_scale: float,
                 device, dtype):
        from pycamset_tpu_torch.optim.losses import make_loss

        def dev(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)
        intr, extr6 = dev(intr), dev(extr6)
        cam_i, im_i, key_i = (dev(a, torch.int64)
                              for a in (cam_i, im_i, key_i))
        self.intr = intr[cam_i]                               # (N, w)
        self.re = rodrigues_to_matrix(extr6[:, :3])[cam_i]    # (N, 3, 3)
        self.te = extr6[cam_i, 3:]
        self.pts = dev(tpl)[key_i]                            # (N, 3)
        m = dev(m34)[im_i]                                    # (N, 3, 4)
        self.mr, self.mt = m[:, :, :3], m[:, :, 3]
        self.uv = dev(uv)
        self.het, self.n_brown = het, n_brown
        self.rho_fn, self.weight_fn = make_loss(loss, f_scale)
        self.robust = loss != "linear"

    def residual_jac(self, xz):
        """Residuals (N, 2) and their Jacobian (N, 2, 12) at [x | z]."""
        x6, z6 = xz[:6], xz[6:]
        rz, drz = rodrigues_to_matrix(z6[:3]), rodrigues_jacobian(z6[:3])
        rx, drx = rodrigues_to_matrix(x6[:3]), rodrigues_jacobian(x6[:3])
        pt_m = self.pts @ rz.T + z6[3:]                       # Z
        pt_g = torch.sum(self.mr * pt_m[:, None, :], dim=-1) + self.mt
        pt_w = pose_apply(pose_inv(x6), pt_g)                 # inv(X)
        xc = torch.sum(self.re * pt_w[:, None, :], dim=-1) + self.te
        pred, d_xc = rig_projection_partials(self.intr, xc, self.het,
                                             self.n_brown)
        r = pred - self.uv
        d_w = torch.sum(d_xc[:, :, :, None] * self.re[:, None], dim=-2)
        # inv(X) p = R_x^T (p - t_x): d / d t_x = -R_x^T, d / d rx_j =
        # dR_x[j]^T (p - t_x)
        d_g = d_w @ rx.T                                      # (N, 2, 3)
        q = pt_g - x6[3:]
        u_x = torch.einsum("jab,na->njb", drx, q)             # (N, j, 3)
        d_rx = torch.einsum("ntb,njb->ntj", d_w, u_x)
        # Z p = R_z p + t_z, then M_i: d / d t_z = d_g M_R; / d rz_j =
        # d_g M_R dR_z[j] p
        d_m = torch.sum(d_g[:, :, :, None] * self.mr[:, None], dim=-2)
        u_z = torch.einsum("jab,nb->nja", drz, self.pts)      # (N, j, 3)
        d_rz = torch.einsum("nta,nja->ntj", d_m, u_z)
        jac = torch.cat([d_rx, -d_g, d_rz, d_m], dim=-1)      # (N, 2, 12)
        return r, jac

    def neq(self, xz):
        """(JtJ (12, 12), grad (12,), cost) at [x | z]."""
        r, j = self.residual_jac(xz)
        if self.robust:
            s = torch.sum(r * r, dim=-1)
            cost = torch.sum(self.rho_fn(s))
            sw = torch.sqrt(self.weight_fn(s))[:, None]
            r = r * sw
            j = j * sw[..., None]
        else:
            cost = torch.sum(r * r)
        jf = j.reshape(-1, 12)
        return jf.T @ jf, jf.T @ r.reshape(-1), cost

    def solve(self, xz0, max_nfev: int):
        """The LM solve and the unit-noise covariance inv(JtJ + ridge) at
        its end: (x, cost, nit, nfev, status, diag cov) as device
        tensors."""
        from pycamset_tpu_torch.optim.lm import lm_solve_device
        res = lm_solve_device(self.neq, xz0, max_nfev=max_nfev)
        jtj = self.neq(res.x)[0]
        ridge = 1e-12 * torch.clamp(torch.max(torch.diagonal(jtj)), min=1.0)
        eye = torch.eye(12, dtype=jtj.dtype, device=jtj.device)
        cov = torch.linalg.inv_ex(jtj + ridge * eye)[0]
        return (res.x, res.cost, res.nit, res.nfev, res.status,
                torch.diagonal(cov))


def calibrate_hand_eye(camset, detection, base_T_gripper: np.ndarray,
                       target, mode: str = "eye_in_hand",
                       method: str = "park", refine: bool = True,
                       loss: str = "linear", f_scale: float = 1.0,
                       min_detections: int = 8,
                       max_nfev: int = 60, device="cuda",
                       dtype=None) -> HandEyeResult:
    """Hand-eye calibration against a calibrated rig.

    1. Per-image target poses from the rig (``TargetTracker.track_batch``,
       one batched device program).
    2. Closed-form (X, Z) seed over the usable images (``solve_hand_eye``).
    3. The joint 12-parameter refinement of [X | Z] on the pixel
       residuals of every detection in every camera, on the device.

    :param camset: calibrated CameraSet (parameters held fixed).
    :param detection: TargetDetection whose image index indexes
        ``base_T_gripper``'s rows.
    :param base_T_gripper: (I, 4, 4) robot forward kinematics per image.
    :param target: the calibration target (template from point_data).
    :param mode: "eye_in_hand" or "eye_to_hand" (module docstring).
    :param refine: skip step 3 when False (closed form only).
    :param loss: robust loss of the refinement (``optim/losses.py``).
    :param min_detections: images with fewer detections stay out of the
        closed-form seed (they still enter the refinement).
    :param device: where the tracker and the refinement run (the card
        unless the caller names another); :param dtype: their dtype.
    """
    from pycamset_tpu_torch.config import default_device_dtype, resolve_device
    from pycamset_tpu_torch.ops.projection import pack_rig_intrinsics
    from pycamset_tpu_torch.tracking import TargetTracker, rig_family

    g = np.asarray(base_T_gripper, dtype=float)
    if g.ndim != 3 or g.shape[1:] != (4, 4):
        raise ValueError("base_T_gripper must be (I, 4, 4)")
    device = resolve_device(device)
    dtype = dtype or default_device_dtype(device)

    # -- step 1: target poses in the rig frame
    tracker = TargetTracker(camset, target, loss=loss, f_scale=f_scale,
                            device=device, dtype=dtype)
    rig_T_target, tinfo = tracker.track_batch(detection)
    n_ims = rig_T_target.shape[0]
    if n_ims != g.shape[0]:
        raise ValueError(
            f"detection covers {n_ims} images but base_T_gripper has "
            f"{g.shape[0]} poses — they must be synchronized 1:1")
    usable = (np.asarray(tinfo["n_used"]) >= min_detections) \
        & np.isfinite(rig_T_target.reshape(n_ims, -1)).all(axis=1)
    if usable.sum() < 3:
        raise ValueError(
            f"only {int(usable.sum())} of {n_ims} images have >= "
            f"{min_detections} detections and a finite pose — not enough "
            "to calibrate")

    # -- step 2: closed form on the usable subset
    x0, z0 = solve_hand_eye(g[usable], rig_T_target[usable], mode=mode,
                            method=method)
    info = {"x_seed": x0, "z_seed": z0, "usable": usable,
            "tracker_rms": tinfo["rms"], "mode": mode, "method": method}
    if not refine:
        return HandEyeResult(x0, z0, float("nan"), info)

    # -- step 3: the refinement on pixel residuals
    names = camset.get_names()
    dists = [np.reshape(camset[n].distortion_coefs, -1) for n in names]
    intr_rows, _ = pack_rig_intrinsics(
        [camset[n].intrinsic for n in names], dists)
    het, n_brown = rig_family(dists)
    extr6 = np.stack([np.concatenate(ext_4x4_to_rod(camset[n].extrinsic))
                      for n in names])
    tpl = np.asarray(target.point_data.reshape(-1, 3), dtype=float)
    # M_i as (I, 3, 4): eye_in_hand folds inv(G_i), eye_to_hand G_i
    m34 = np.stack([(_inv_h(t) if mode == "eye_in_hand" else t)[:3]
                    for t in g])
    dd = detection.get_data()
    model = HandEyeModel(
        intr_rows, extr6, tpl, m34, dd[:, 0].astype(np.int64),
        dd[:, 1].astype(np.int64), dd[:, 2].astype(np.int64), dd[:, 3:5],
        het=het, n_brown=n_brown, loss=loss, f_scale=f_scale, device=device,
        dtype=dtype)
    xz0 = np.concatenate([_pose6_of(x0), _pose6_of(z0)])
    t_lm = time.perf_counter()
    pieces = model.solve(torch.as_tensor(xz0, dtype=dtype, device=device),
                         max_nfev)
    # the one read-back of the solve
    xz, cost, nit, nfev, status, diag_cov = (t.double().cpu().numpy()
                                             for t in pieces)
    lm_s = time.perf_counter() - t_lm
    cost, nit, nfev, status = float(cost), int(nit), int(nfev), int(status)
    n_res = 2 * dd.shape[0]
    dof = max(n_res - 12, 1)
    rms = float(np.sqrt(cost / max(n_res, 1)))
    sigma2 = cost / dof
    x = make_4x4h_tform(xz[:3], xz[3:6])
    z = make_4x4h_tform(xz[6:9], xz[9:12])
    info.update({
        "nit": nit, "nfev": nfev, "status": status, "cost": cost,
        "lm_seconds": lm_s,
        "xz_sigma": np.sqrt(np.maximum(diag_cov, 0.0) * sigma2),
        "n_detections": int(dd.shape[0]),
    })
    return HandEyeResult(x, z, rms, info)
