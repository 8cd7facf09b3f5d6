"""Wand (targetless) extrinsic calibration — the MoCap workflow.

Counterpart of the solve in ``pycamset_tpu/calibration/wand.py`` (its image
detectors, ``detect_wand_markers`` and ``detect_wand_in_imfolder``, wait
with the OpenCV image pipeline, ROADMAP Queue A item 3). Large volumes are
calibrated by waving a small marker wand: each frame gives a handful of
unconstrained 3D points seen by whichever cameras caught them, and the
solve is pose-free structure from motion with KNOWN lenses and free
extrinsics. :func:`calibrate_extrinsics_from_wand`:

1. undistort + normalise every detection through the known lens models
   (``Camera.undistort_points``, on ``device``);
2. the start (``start``): ``"pnp"`` is the JAX package's incremental
   registration (OpenCV on the host: the best-connected pair by essential
   matrix + recoverPose, every further camera by PnP, RANSAC; the
   structure re-triangulated as cameras join); ``"rig"`` needs no OpenCV
   (the card's machine has none): the camset's stored extrinsics,
   re-expressed in camera 0's frame, and every point triangulated by the
   same rule (multi-view DLT over the cameras that see it, dropped where
   it lands behind one);
3. one bundle adjustment over [extrinsics | wand points] with every lens
   pinned (``FreePointBundleHandler``, the free-point wrappers over
   Kernels C and D on a card): camera 0 the world frame, one point
   coordinate (the start's largest) pinned against the scale mode;
4. the metric scale from ``wand_template``'s marker spacing (a pure gauge)
   and the spread of the reconstructed wand lengths as a quality metric.

The pinned coordinate is the start's, so the two starts' raw solutions
differ by a similarity; after the metric scaling they agree. Without a
template the result keeps the start's scale: the seed pair's unit
baseline (``"pnp"``) or the stored rig's (``"rig"``);
``report["scale_from"]`` names it.

The handler's table puts every detection in image 0: a pose-free chain's
image index only picks the block a detection lands in, and a camera sees
a (frame, marker) point once, so one image per camera gives the same
residuals and normal equations on a (cameras x 1, points) grid instead of
the JAX package's (cameras x frames, points) one (12 cameras, 3,000
frames, 9,000 points: 327 M slots there). The grid is not bucketed
(``im_bucket: None`` unless the caller's options say otherwise): the
default bucket of 8 would pad the one image to 8, seven blocks a camera
of padding only.
"""
from __future__ import annotations

import copy
import logging

import numpy as np


def _normalized_obs(camset, dd, device="cuda", dtype=None):
    """Per-row undistorted normalized coordinates (K^-1, distortion
    inverted through each camera's own model, on ``device``)."""
    names = camset.get_names()
    out = np.zeros((len(dd), 2))
    cam_col = dd[:, 0].astype(int)
    for ci, name in enumerate(names):
        sel = np.flatnonzero(cam_col == ci)
        if not sel.size:
            continue
        cam = camset[name]
        und = np.asarray(cam.undistort_points(dd[sel, -2:], device=device,
                                              dtype=dtype))
        k = np.asarray(cam.intrinsic, dtype=float)
        out[sel, 0] = (und[:, 0] - k[0, 2]) / k[0, 0]
        out[sel, 1] = (und[:, 1] - k[1, 2]) / k[1, 1]
    return out


def _triangulate_multiview(exts, xns):
    """DLT of one point from >= 2 normalized views [(ext4x4, (2,)), ...]."""
    rows = []
    for ext, xn in zip(exts, xns):
        p = ext[:3]
        rows.append(xn[0] * p[2] - p[0])
        rows.append(xn[1] * p[2] - p[1])
    a = np.stack(rows)
    _, _, vt = np.linalg.svd(a, full_matrices=False)
    h = vt[-1]
    if abs(h[3]) < 1e-12:
        return None
    return h[:3] / h[3]


def _cheirality_ok(ext, x):
    return (ext[:3, :3] @ x + ext[:3, 3])[2] > 1e-6


def _retriangulate(obs, exts):
    """Every point seen by >= 2 of the cameras in ``exts`` (in its order),
    by multi-view DLT; a point behind any of its views is dropped."""
    counts = {}
    for c in exts:
        for k in obs[c]:
            counts[k] = counts.get(k, 0) + 1
    pts = {}
    for k, n in counts.items():
        if n < 2:
            continue
        views = [(exts[c], obs[c][k]) for c in exts if k in obs[c]]
        x = _triangulate_multiview([v[0] for v in views],
                                   [v[1] for v in views])
        if x is None or not all(_cheirality_ok(v[0], x) for v in views):
            continue
        pts[k] = x
    return pts


def register_cameras_incremental(obs, n_cams, min_pair: int = 20,
                                 ransac_norm: float = 2e-3,
                                 seed_pair=None):
    """Incremental pose-graph registration from normalized observations
    (OpenCV on the host).

    :param obs: {cam: {gkey: (2,) normalized xy}}.
    :returns: (exts {cam: 4x4 world->cam}, pts {gkey: (3,)}, order).
    """
    from pycamset_tpu_torch.utils.general_utils import cv2_pose, require_cv2
    cv2 = require_cv2("The wand's incremental registration "
                      "(register_cameras_incremental)",
                      "pass start='rig' to calibrate_extrinsics_from_wand "
                      "(the stored extrinsics seed the solve)")

    def shared(a, b):
        return sorted(set(obs[a]) & set(obs[b]))

    if seed_pair is None:
        best, best_n = None, -1
        for a in range(n_cams):
            for b in range(a + 1, n_cams):
                n = len(shared(a, b))
                if n > best_n:
                    best, best_n = (a, b), n
        seed_pair = best
        if best_n < max(min_pair, 8):
            raise ValueError(
                f"best camera pair {best} shares only {best_n} wand "
                "observations — capture more frames with the wand "
                "visible to overlapping cameras")
    a, b = seed_pair
    keys = shared(a, b)
    pa = np.stack([obs[a][k] for k in keys])
    pb = np.stack([obs[b][k] for k in keys])
    e_mat, inl = cv2.findEssentialMat(
        pa, pb, np.eye(3), method=cv2.RANSAC, prob=0.999,
        threshold=ransac_norm)
    if e_mat is None or e_mat.shape != (3, 3):
        raise ValueError(f"essential-matrix estimation failed for the "
                         f"seed pair {seed_pair}")
    _, r, t, _pose_inl = cv2.recoverPose(
        e_mat, pa, pb, np.eye(3), mask=inl.copy())
    ext_b = np.eye(4)
    ext_b[:3, :3] = r
    ext_b[:3, 3] = np.ravel(t)
    exts = {a: np.eye(4), b: ext_b}
    order = [a, b]

    pts = _retriangulate(obs, exts)
    if len(pts) < 8:
        raise ValueError(
            f"seed pair {seed_pair} triangulated only {len(pts)} points "
            "— degenerate relative geometry (pure rotation?) or too few "
            "inliers")
    remaining = set(range(n_cams)) - set(exts)
    while remaining:
        scores = {c: len(set(obs[c]) & set(pts)) for c in remaining}
        c = max(scores, key=scores.get)
        if scores[c] < 6:
            raise ValueError(
                f"cameras {sorted(remaining)} share too few wand points "
                f"with the registered set (best: camera {c} sees "
                f"{scores[c]}) — the capture does not connect the rig; "
                "wave the wand through the shared view volumes")
        keys_c = sorted(set(obs[c]) & set(pts))
        obj = np.stack([pts[k] for k in keys_c])
        img = np.stack([obs[c][k] for k in keys_c])
        okf, rvec, tvec, _inl = cv2.solvePnPRansac(
            obj.astype(np.float64), img.astype(np.float64), np.eye(3),
            None, reprojectionError=4 * ransac_norm)
        if not okf:
            raise ValueError(f"PnP registration failed for camera {c}")
        exts[c] = cv2_pose(cv2, np.ravel(rvec), np.ravel(tvec))
        order.append(c)
        remaining.discard(c)
        pts = _retriangulate(obs, exts)
    return exts, pts, order


def _stored_registration(obs, camset, n_cams):
    """The ``"rig"`` start: the stored extrinsics in camera 0's frame (camera
    0 the identity) and every point triangulated by ``_retriangulate``."""
    names = camset.get_names()
    e0_inv = np.linalg.inv(np.asarray(camset[names[0]].extrinsic,
                                      dtype=float))
    exts = {0: np.eye(4)}
    for c in range(1, n_cams):
        exts[c] = np.asarray(camset[names[c]].extrinsic, dtype=float) @ e0_inv
    pts = _retriangulate(obs, exts)
    if len(pts) < 8:
        raise ValueError(
            f"the stored rig triangulated only {len(pts)} wand points — "
            "its extrinsics do not see the capture; pass start='pnp'")
    return exts, pts, list(range(n_cams))


def calibrate_extrinsics_from_wand(camset, detections,
                                   wand_template=None, *,
                                   options: dict | None = None,
                                   min_pair: int = 20,
                                   ransac_px: float = 2.0,
                                   seed_pair=None, start: str = "pnp",
                                   device="cuda", dtype=None):
    """Calibrate a rig's extrinsics from a waved-wand capture.

    :param camset: rig with TRUSTED intrinsics (per-camera K + distortion
        from a prior lens calibration); with ``start="pnp"`` its
        extrinsics may be arbitrary, with ``start="rig"`` they seed the
        solve.
    :param detections: TargetDetection whose rows are
        ``[cam, frame, marker, u, v]`` (marker identity consistent within
        a frame), or a raw (N, 5) table of the same.
    :param wand_template: (M, 3) marker coordinates in the wand's own
        frame — anchors the METRIC scale via the inter-marker distances.
        None keeps the start's scale (a warning).
    :param options: extra ``problem_options`` for the bundle adjustment
        (loss, max_nfev, ...).
    :param ransac_px: registration RANSAC threshold in pixels (converted
        to normalized units with each rig's mean focal length).
    :param start: ``"pnp"`` or ``"rig"`` (module docstring).
    :param device: where the undistortion, the solve and the report's
        projections run (the card unless the caller names another);
        :param dtype: their dtype.
    :returns: (calibrated CameraSet in CAMERA 0's frame, report dict —
        rms_px, wand length spread, per-camera stats, registration
        order, the scale's source).
    """
    from pycamset_tpu_torch.models.detections import TargetDetection
    from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
    from pycamset_tpu_torch.optim.handlers import (FreePointBundleHandler,
                                                   FreePointTarget)

    if start not in ("pnp", "rig"):
        raise ValueError(f"unknown start {start!r}; expected 'pnp' or "
                         "'rig'")
    names = camset.get_names()
    n_cams = len(names)
    if n_cams < 2:
        raise ValueError("wand calibration needs >= 2 cameras")
    if isinstance(detections, TargetDetection):
        dd = detections.get_data()
    else:
        dd = np.asarray(detections, dtype=float)
    if dd is None or dd.ndim != 2 or dd.shape[1] != 5:
        raise ValueError("detections must be rows [cam, frame, marker, "
                         f"u, v]; got shape {None if dd is None else dd.shape}")
    n_markers = int(dd[:, 2].max()) + 1
    if wand_template is not None:
        wand_template = np.asarray(wand_template, dtype=float).reshape(-1, 3)
        if len(wand_template) < n_markers:
            raise ValueError(
                f"wand_template has {len(wand_template)} markers but the "
                f"detections reference marker id {n_markers - 1}")

    # global point id: one free 3D point per (frame, marker)
    gkey = (dd[:, 1].astype(int) * n_markers + dd[:, 2].astype(int))
    norm = _normalized_obs(camset, dd, device=device, dtype=dtype)
    cam_col = dd[:, 0].astype(int)
    obs = {c: {} for c in range(n_cams)}
    for i in range(len(dd)):
        obs[cam_col[i]][int(gkey[i])] = norm[i]

    if start == "pnp":
        f_mean = float(np.mean([np.asarray(camset[n].intrinsic)[0, 0]
                                for n in names]))
        exts, pts, order = register_cameras_incremental(
            obs, n_cams, min_pair=min_pair, ransac_norm=ransac_px / f_mean,
            seed_pair=seed_pair)
    else:
        exts, pts, order = _stored_registration(obs, camset, n_cams)

    # world frame = camera 0
    t0 = exts[0].copy()
    t0_inv = np.linalg.inv(t0)
    exts = {c: e @ t0_inv for c, e in exts.items()}
    pts = {k: (t0[:3, :3] @ x + t0[:3, 3]) for k, x in pts.items()}

    # keep only detections whose point survived registration, relabel
    keep_keys = sorted(pts)
    key_of = {k: i for i, k in enumerate(keep_keys)}
    keep = np.array([int(g) in pts for g in gkey])
    dd_ba = dd[keep].copy()
    dd_ba[:, 2] = [key_of[int(g)] for g in gkey[keep]]
    pts_init = np.stack([pts[k] for k in keep_keys])
    n_dropped = int((~keep).sum())
    if n_dropped:
        logging.info("wand: %d detections dropped (points seen by < 2 "
                     "registered cameras or behind a camera)", n_dropped)

    # rig clone carrying the registered extrinsics (intrinsics untouched)
    cams_init = copy.deepcopy(camset)
    for c, name in enumerate(names):
        cams_init[name].extrinsic = exts[c]
        cams_init[name]._update_state()

    opts = {"outliers": "n", "verbosity": 0, "im_bucket": None}
    if options:
        opts.update(options)
    fixed = {}
    for c, name in enumerate(names):
        fixed[name] = {"int": np.asarray(camset[name].intrinsic,
                                         dtype=float),
                       "dst": np.ravel(camset[name].distortion_coefs)}
    fixed[names[0]]["ext"] = np.eye(4)     # camera 0 = the world frame

    # every detection in image 0 (module docstring): one block a camera
    dd_grid = dd_ba.copy()
    dd_grid[:, 1] = 0.0
    handler = FreePointBundleHandler(
        cams_init, FreePointTarget(pts_init.reshape(1, -1, 3)),
        TargetDetection(cam_names=names, data=dd_grid),
        fixed_params=fixed, options=opts)
    # 7th gauge coordinate: with camera 0 at the origin, scaling every
    # point and translation together is reprojection-invariant — pin the
    # single largest point coordinate to remove the exact null mode
    pin = int(np.argmax(np.abs(pts_init.reshape(-1))))
    handler.feat_unfixed[pin] = False
    handler.bundlePrimitive.calc_free_poses()  # refresh free counts
    result, solved = run_bundle_adjustment(handler, dtype=dtype,
                                           device=device)
    rms = float(np.sqrt(np.mean(np.asarray(result["fun"]) ** 2)))
    pts_ba = handler.get_updated_points(result["x"]).reshape(-1, 3)

    # metric anchor: wand segment lengths are known — pure gauge, exact
    scale = 1.0
    scale_from = "seed pair baseline" if start == "pnp" else "stored rig"
    length_stats = None
    if wand_template is not None and n_markers >= 2:
        ratios = []
        frames = (np.asarray(keep_keys) // n_markers)
        marks = (np.asarray(keep_keys) % n_markers)
        by_frame = {}
        for i, (fr, mk) in enumerate(zip(frames, marks)):
            by_frame.setdefault(int(fr), {})[int(mk)] = pts_ba[i]
        for fr, mkpts in by_frame.items():
            ids = sorted(mkpts)
            for ai in range(len(ids)):
                for bi in range(ai + 1, len(ids)):
                    d_true = np.linalg.norm(wand_template[ids[ai]]
                                            - wand_template[ids[bi]])
                    d_est = np.linalg.norm(mkpts[ids[ai]] - mkpts[ids[bi]])
                    if d_true > 1e-12 and d_est > 1e-12:
                        ratios.append(d_true / d_est)
        if not ratios:
            logging.warning("wand_template given but no frame has two "
                            "reconstructed markers — scale left at the "
                            f"{scale_from}'s")
        else:
            scale = float(np.median(ratios))
            scale_from = "wand_template"
            pts_ba = pts_ba * scale
            lengths_err = (1.0 - np.asarray(ratios) * (1.0 / scale))
            length_stats = {
                "n_segments": len(ratios),
                "relative_spread_rms": float(
                    np.sqrt(np.mean(lengths_err ** 2))),
            }
    elif start == "pnp":
        logging.warning("no wand_template: the reconstruction's scale is "
                        "the seed pair's unit baseline, NOT metric")
    else:
        logging.warning("no wand_template: the reconstruction keeps the "
                        "stored rig's scale (start='rig'), NOT checked "
                        "against the wand")

    out = copy.deepcopy(solved)
    per_cam = {}
    dd_cam = dd_ba[:, 0].astype(int)
    for c, name in enumerate(names):
        e = np.asarray(solved[name].extrinsic, dtype=float).copy()
        e[:3, 3] *= scale
        out[name].extrinsic = e
        out[name]._update_state()
        # honest per-camera residuals: project the (scaled) solution
        sel = dd_ba[dd_cam == c]
        if len(sel):
            uv = np.asarray(out[name].project_points(
                pts_ba[sel[:, 2].astype(int)], device=device, dtype=dtype))
            per_cam[name] = {
                "n_detections": int(len(sel)),
                "rms_px": float(np.sqrt(np.mean(
                    np.sum((uv - sel[:, 3:5]) ** 2, axis=1)))),
            }
        else:
            per_cam[name] = {"n_detections": 0, "rms_px": None}

    report = {
        "rms_px": rms,
        "n_points": int(len(pts_ba)),
        "n_frames": int(len(set(int(k) // n_markers for k in keep_keys))),
        "n_detections_used": int(len(dd_ba)),
        "n_detections_dropped": n_dropped,
        "registration_order": [names[c] for c in order],
        "scale_applied": scale,
        "scale_from": scale_from,
        "metric": wand_template is not None,
        "cameras": per_cam,
        "wand_points": pts_ba,
    }
    if length_stats:
        report["wand_lengths"] = length_stats
    return out, report
