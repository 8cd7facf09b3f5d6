"""Calibration planning: predict a proposed rig's achievable accuracy.

Counterpart of ``pycamset_tpu/calibration/plan.py``. Given a proposed
CameraSet, a calibration target and a capture plan (presentations, corner
noise), the planner

1. synthesizes detections: target poses sampled around the rig's mutual
   working volume, projected through each camera's full model, clipped to
   the sensors;
2. runs the real bundle adjustment on them (a ``TemplateBundleHandler`` on
   a ``FreePointTarget`` through the port's ``driver.
   run_bundle_adjustment``: the structured backend, Kernel A or B on a
   card);
3. propagates first-order uncertainty at the optimum (``optim/
   uncertainty.py``) into per-camera focal / principal-point / extrinsic
   sigmas, the triangulation error ellipsoid at the workspace centre and
   the target-pose sigmas.

The solve's start (``start``): ``"pnp"`` is the JAX package's, the
handler's PnP seed (OpenCV, on the host); ``"truth"`` needs no OpenCV (the
card's machine has none): the proposed rig and the sampled poses, in the
handler's gauge (its fixed pose at the identity).

The report is a best case: a perfect detector noise model, no outliers.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from pycamset_tpu_torch.utils.general_utils import (ext_4x4_to_rod,
                                                    make_4x4h_tform)


def workspace_center(cams) -> np.ndarray:
    """The point minimising squared distance to every camera's optical
    axis: where the rig's views intersect."""
    a = np.zeros((3, 3))
    b = np.zeros(3)
    for name in cams.get_names():
        cam = cams[name]
        d = cam.view / np.linalg.norm(cam.view)
        p = cam.position
        m = np.eye(3) - np.outer(d, d)   # projector off the axis
        a += m
        b += m @ p
    # lstsq: collinear axes make the normal matrix singular along the
    # shared line — take the min-norm point
    return np.linalg.lstsq(a, b, rcond=None)[0]


def synthesize_detections(cams, target_points: np.ndarray, n_ims: int,
                          noise_px: float = 0.3, seed: int = 0,
                          rot_spread: float = 0.45,
                          trans_spread: float | None = None,
                          min_cams: int = 2, device="cuda", dtype=None):
    """Synthetic TargetDetection table for a given rig.

    Target poses are sampled around :func:`workspace_center`, facing back
    along the mean view direction, with rotation / translation jitter;
    points project through each camera's full model
    (``Camera.project_points`` on ``device``) and are kept in front of and
    inside the sensor.

    :param target_points: (K, 3) target-local corner coordinates.
    :param trans_spread: translation jitter (m); default 15% of the mean
        camera-to-workspace distance.
    :returns: (TargetDetection, true_poses (I, 6) Rodrigues + t rows).
    """
    from pycamset_tpu_torch.models.detections import TargetDetection

    rng = np.random.default_rng(seed)
    names = cams.get_names()
    tpl = np.asarray(target_points, dtype=float).reshape(-1, 3)
    center = workspace_center(cams)
    mean_dist = float(np.mean(
        [np.linalg.norm(cams[n].position - center) for n in names]))
    if trans_spread is None:
        trans_spread = 0.15 * mean_dist
    vbar = np.mean([cams[n].view for n in names], axis=0)
    nv = np.linalg.norm(vbar)
    # a ring rig's view directions cancel: an arbitrary facing then (the
    # rotation jitter covers orientations anyway)
    vbar = vbar / nv if nv > 0.2 else np.array([0.0, 0.0, 1.0])
    # target +z along the mean view: the cameras sit on the board's -z
    # side, the side from which a printed pattern reads correctly
    zt = vbar
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(up, zt)) > 0.95:
        up = np.array([0.0, 1.0, 0.0])
    xt = np.cross(up, zt)
    xt /= np.linalg.norm(xt)
    yt = np.cross(zt, xt)
    r_base = np.stack([xt, yt, zt], axis=1)   # target->world columns

    rows = []
    poses = np.zeros((n_ims, 6))
    i = 0
    attempts = 0
    while i < n_ims and attempts < 20 * n_ims:
        attempts += 1
        rv = rng.normal(size=3)
        rv = rv / np.linalg.norm(rv) * rng.uniform(0, rot_spread)
        t = center + rng.normal(size=3) * trans_spread
        rot = make_4x4h_tform(rv, np.zeros(3))[:3, :3] @ r_base
        tf = np.eye(4)
        tf[:3, :3] = rot
        tf[:3, 3] = t - rot @ tpl.mean(axis=0)  # centre the target at t
        world = tpl @ rot.T + tf[:3, 3]
        frame_rows = []
        cams_seen = 0
        for ci, n in enumerate(names):
            cam = cams[n]
            z = (world @ cam.extrinsic[:3, :3].T
                 + cam.extrinsic[:3, 3])[:, 2]
            uv = np.asarray(cam.project_points(world, device=device,
                                               dtype=dtype))
            ok = ((z > 0.05 * mean_dist)
                  & (uv[:, 0] > 0) & (uv[:, 0] < cam.res[0])
                  & (uv[:, 1] > 0) & (uv[:, 1] < cam.res[1]))
            kk = np.flatnonzero(ok)
            if kk.size >= 4:
                cams_seen += 1
            if kk.size:
                uvn = uv[kk] + rng.normal(size=(kk.size, 2)) * noise_px
                frame_rows.append(np.column_stack([
                    np.full(kk.size, ci), np.full(kk.size, i), kk,
                    uvn]))
        if cams_seen >= min_cams:
            rows.extend(frame_rows)
            poses[i, :3], poses[i, 3:] = ext_4x4_to_rod(tf)
            i += 1
    if i < n_ims:
        raise ValueError(
            f"could only place {i}/{n_ims} target poses visible to >= "
            f"{min_cams} cameras — the rig has too little shared view "
            "volume (check camera aims), or min_cams is too high")
    dd = np.concatenate(rows, axis=0)
    return TargetDetection(cam_names=names, data=dd), poses


def _triangulation_sigma(cams, point: np.ndarray, sigma_px: float,
                         device="cuda"):
    """First-order 3D error ellipsoid of triangulating ``point`` from all
    cameras that see it: sqrt eigvals of sigma_px^2 (J^T J)^-1 with J the
    stacked pixel Jacobians, by finite differences through the full camera
    model. The differences step 1e-6: they are taken in float64 on any
    device (float32 would round the step away)."""
    js = []
    eps = 1e-6
    for n in cams.get_names():
        cam = cams[n]
        z = (point @ cam.extrinsic[:3, :3].T + cam.extrinsic[:3, 3])[2]
        pts = np.repeat(point[None], 4, axis=0)
        pts[1:] += eps * np.eye(3)
        uv = np.asarray(cam.project_points(pts, device=device,
                                           dtype=torch.float64))
        uv0 = uv[0]
        if not (z > 0 and 0 <= uv0[0] < cam.res[0]
                and 0 <= uv0[1] < cam.res[1]):
            continue
        js.append(((uv[1:] - uv0) / eps).T)
    if len(js) < 2:
        return None
    jtj = sum(j.T @ j for j in js)
    w = np.linalg.eigvalsh(np.linalg.inv(jtj)) * sigma_px ** 2
    return np.sqrt(np.clip(w, 0.0, None))  # ascending: best..worst axis


def _truth_start(handler, cams, true_poses: np.ndarray):
    """Seed ``handler`` at the proposed rig and the sampled poses, moved
    into its gauge: with a fixed pose k, the world becomes target k's
    frame (extrinsics E_c T_k, poses T_k^-1 T_i), as the PnP seed's."""
    k = handler.problem_opts.get("fixed_pose")
    tk = (np.eye(4) if k is None
          else make_4x4h_tform(true_poses[k, :3], true_poses[k, 3:]))
    tk_inv = np.linalg.inv(tk)
    prim = handler.bundlePrimitive
    for idc, name in enumerate(handler.cam_names):
        if prim.intr_unfixed[idc]:
            prim.intr[idc] = handler._intr_seed_row(idc, cams[name])
        if prim.extr_unfixed[idc]:
            prim.extr[idc] = np.concatenate(
                ext_4x4_to_rod(cams[name].extrinsic @ tk))
    for i in range(prim.poses.shape[0]):
        if prim.poses_unfixed[i]:
            t_i = make_4x4h_tform(true_poses[i, :3], true_poses[i, 3:])
            prim.poses[i, :6] = np.concatenate(ext_4x4_to_rod(tk_inv @ t_i))
    handler.missing_poses = np.zeros(prim.poses.shape[0], dtype=bool)
    handler.set_initial_params(handler.add_extra_params(
        prim.base_full()[prim.unfixed_full()]))


def plan_calibration(cams, target_points: np.ndarray, n_ims: int = 30,
                     noise_px: float = 0.3, seed: int = 0,
                     options: dict | None = None,
                     min_cams: int = 2, start: str = "pnp",
                     device="cuda", dtype=None) -> dict:
    """Predict the accuracy a proposed rig achieves after calibration.

    :param cams: the PROPOSED CameraSet (treated as ground truth).
    :param target_points: (K, 3) target-local corners.
    :param n_ims: planned number of target presentations.
    :param noise_px: expected detector corner noise (px, 1-sigma).
    :param start: the solve's start, ``"pnp"`` (OpenCV) or ``"truth"``
        (no OpenCV; module docstring).
    :param device: where the detections, the solve and the uncertainty run
        (the card unless the caller names another); :param dtype: their
        dtype.
    :returns: dict report, distances in the rig's units (conventionally
        metres), angles in radians; ``"result"`` is the solve's LM result.
    """
    from pycamset_tpu_torch.models.abstract_target import FreePointTarget
    from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
    from pycamset_tpu_torch.optim.handlers import TemplateBundleHandler
    from pycamset_tpu_torch.optim.uncertainty import calibration_uncertainty

    if start not in ("pnp", "truth"):
        raise ValueError(f"unknown start {start!r}; expected 'pnp' or "
                         "'truth'")
    if start == "pnp":
        from pycamset_tpu_torch.utils.general_utils import require_cv2
        require_cv2("The planner's PnP start", "pass start='truth'")
    tpl = np.asarray(target_points, dtype=float).reshape(-1, 3)
    det, true_poses = synthesize_detections(
        cams, tpl, n_ims, noise_px=noise_px, seed=seed, min_cams=min_cams,
        device=device, dtype=dtype)
    opts = {"outliers": "n", "verbosity": 0}
    if options:
        opts.update(options)
    handler = TemplateBundleHandler(
        cams, FreePointTarget(tpl.reshape(1, -1, 3)), det, options=opts)
    if start == "truth":
        _truth_start(handler, cams, true_poses)
    res, solved = run_bundle_adjustment(handler, dtype=dtype, device=device)
    rms = float(np.sqrt(np.mean(res["fun"] ** 2)))
    if rms > 3 * noise_px:
        logging.warning(
            "planner solve finished at %.2f px rms against %.2f px noise "
            "— the synthetic problem did not reach its floor; treat the "
            "sigma report as pessimistic", rms, noise_px)

    unc = calibration_uncertainty(solved, device=device, dtype=dtype)
    center = workspace_center(cams)
    tri = _triangulation_sigma(cams, center, noise_px, device=device)

    per_cam = {}
    dd = det.get_data()
    for ci, n in enumerate(cams.get_names()):
        sel = dd[dd[:, 0] == ci]
        # sensor coverage: occupancy of an 8x8 grid over the image
        cam = cams[n]
        gx = np.clip((sel[:, 3] / cam.res[0] * 8).astype(int), 0, 7)
        gy = np.clip((sel[:, 4] / cam.res[1] * 8).astype(int), 0, 7)
        cov_frac = len(set(zip(gx, gy))) / 64.0
        u = unc["cameras"][n]
        per_cam[n] = {
            "n_detections": int(len(sel)),
            "coverage": cov_frac,
            "focal_sigma_px": float(np.max(u["int_sigma"][[0, 2]])),
            "principal_sigma_px": float(np.max(u["int_sigma"][[1, 3]])),
            "rot_sigma_rad": float(np.max(u["ext_sigma"][:3])),
            "trans_sigma": float(np.max(u["ext_sigma"][3:])),
        }

    report = {
        "n_ims": n_ims,
        "noise_px": noise_px,
        "n_detections": int(len(dd)),
        "expected_rms_px": rms,
        "workspace_center": center.tolist(),
        "cameras": per_cam,
        "pose_sigma_rot_rad": float(np.median(
            np.max(unc["pose_sigma"][:, :3], axis=1))),
        "pose_sigma_trans": float(np.median(
            np.max(unc["pose_sigma"][:, 3:], axis=1))),
        "result": res,
    }
    if tri is not None:
        report["triangulation_sigma"] = {
            "best_axis": float(tri[0]), "worst_axis": float(tri[-1]),
            "rss": float(np.sqrt(np.sum(tri ** 2))),
        }
    return report


def format_plan_report(report: dict) -> str:
    """Human-readable rendering of :func:`plan_calibration`'s output."""
    lines = [
        f"calibration plan: {report['n_ims']} presentations, "
        f"{report['n_detections']} detections at "
        f"{report['noise_px']:.2f} px corner noise",
        f"expected reprojection rms: {report['expected_rms_px']:.3f} px",
    ]
    if "triangulation_sigma" in report:
        t = report["triangulation_sigma"]
        lines.append(
            "triangulation sigma at workspace centre: "
            f"{t['best_axis'] * 1e3:.4f}–{t['worst_axis'] * 1e3:.4f} mm "
            f"per axis ({t['rss'] * 1e3:.4f} mm rss)")
    lines.append(
        f"target pose tracking: rot {report['pose_sigma_rot_rad'] * 1e3:.3f}"
        f" mrad, trans {report['pose_sigma_trans'] * 1e3:.4f} mm (median)")
    lines.append(" cam           dets  cover  f_sig(px)  c_sig(px)  "
                 "rot(mrad)  trans(mm)")
    for n, c in report["cameras"].items():
        lines.append(
            f" {n:<12} {c['n_detections']:>6} {c['coverage']:>5.0%}  "
            f"{c['focal_sigma_px']:>9.3f}  {c['principal_sigma_px']:>9.3f}"
            f"  {c['rot_sigma_rad'] * 1e3:>9.3f}"
            f"  {c['trans_sigma'] * 1e3:>9.4f}")
    return "\n".join(lines)
