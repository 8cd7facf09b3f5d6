"""Rig health monitoring and partial recalibration.

Counterpart of ``pycamset_tpu/calibration/monitor.py``. Between full
calibrations a deployed rig asks two questions:

1. ``rig_health``: is the calibration still good, and if not, which camera
   moved? Per-frame target poses are fitted against the fixed rig (the
   port's ``TargetTracker.track_batch``: a plain solve, then a Cauchy-loss
   solve warm-started from it), then every camera gets a leave-one-out
   score: poses refitted without that camera's detections (warm-started
   from the main fit), and the camera's reprojection rms against them. A
   moved camera scores high while the others stay at the noise floor.
   Every batch shares the first fit's frame count and runs uncaptured, so
   the 2 + C batches of a report capture no CUDA graph.
2. ``recalibrate_extrinsics`` / ``recalibrate_intrinsics``: refresh the
   drifted mounts (lenses) with everything else pinned through
   ``fixed_params``, a template bundle adjustment (``fixed_pose: None``:
   the pinned cameras are the gauge) through the port's
   ``driver.run_bundle_adjustment`` on the structured backend (Kernel A or
   B on a card).

The solve's start (``start``): ``"pnp"`` is the JAX package's, the handler's
PnP relative-pose seed (OpenCV, on the host); ``"rig"`` needs no OpenCV
(the card's machine has none): the free blocks start at the stored rig's
values and the target poses at the port's tracker on the stored rig
(device seeding; ``optim/handlers.py::rig_start``).
"""
from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)


def _per_camera_rms(camset, dd: np.ndarray, poses: np.ndarray,
                    tpl: np.ndarray, names, device,
                    dtype) -> tuple[dict, np.ndarray]:
    """Reprojection rms per camera (and squared error per row).

    :param dd: (N, 5) [cam, im, key, u, v] detection table.
    :param poses: (I, 4, 4) target->world per image (non-finite skipped).
    :param tpl: (K, 3) template points.
    :return: ({name: rms}, (N,) squared errors, NaN where unscored); each
        camera's rows projected in one call on ``device``.
    """
    err2 = np.full(dd.shape[0], np.nan)
    cam_i = dd[:, 0].astype(int)
    im_i = dd[:, 1].astype(int)
    key_i = dd[:, 2].astype(int)
    finite = np.isfinite(poses.reshape(len(poses), -1)).all(axis=1)
    for c, name in enumerate(names):
        rows = np.flatnonzero(cam_i == c)
        rows = rows[(im_i[rows] < len(poses))]
        rows = rows[finite[im_i[rows]]]
        if not rows.size:
            continue
        pose = poses[im_i[rows]]
        world = (np.einsum("nab,nb->na", pose[:, :3, :3], tpl[key_i[rows]])
                 + pose[:, :3, 3])
        pred = camset[name].project_points(world, device=device, dtype=dtype)
        err2[rows] = np.sum((pred - dd[rows, 3:5]) ** 2, axis=1)
    per_cam = {}
    for c, name in enumerate(names):
        e = err2[cam_i == c]
        e = e[np.isfinite(e)]
        per_cam[name] = float(np.sqrt(e.mean())) if e.size else float("nan")
    return per_cam, err2


def rig_health(camset, detection, target, robust_fit: bool = True,
               f_scale: float = 1.0, drift_ratio: float = 2.0,
               drift_abs_px: float = 0.5, device="cuda",
               dtype=None) -> dict:
    """Health report for a calibrated rig against fresh detections.

    :param camset: the calibrated rig.
    :param detection: a fresh TargetDetection of the rig's target.
    :param target: the calibration target.
    :param robust_fit: fit the attribution poses with a Cauchy loss
        (warm-started from the plain solve): it keeps a drifted camera's
        biased detections from smearing the excess across the rig.
    :param drift_ratio / drift_abs_px: a camera is flagged as drifted when
        its leave-one-out rms exceeds BOTH ``drift_ratio`` x the median
        leave-one-out rms of the other cameras AND ``drift_abs_px``.
    :param device: where the tracker and the projections run (the card
        unless the caller names another); :param dtype: their dtype.
    :return: dict with overall / per-camera / per-image rms, leave-one-out
        scores, the fitted per-frame poses and the ``drifted`` list.
    """
    from pycamset_tpu_torch.models.detections import TargetDetection
    from pycamset_tpu_torch.tracking import TargetTracker

    names = camset.get_names()
    tpl = np.asarray(target.point_data.reshape(-1, 3), dtype=float)
    tracker = TargetTracker(camset, target, device=device, dtype=dtype)
    rob = TargetTracker(camset, target, loss="cauchy", f_scale=f_scale,
                        device=device, dtype=dtype) if robust_fit else None

    def fit(det):
        # the plain solve, then the robust loss warm-started from it (a
        # cold robust start from a seed poisoned by the outliers it should
        # reject can stall)
        p, i = tracker.track_batch(det)
        if rob is None:
            return p, i
        return rob.track_batch(det, inits=p)

    poses, info = fit(detection)
    dd = detection.get_data()

    per_cam, err2 = _per_camera_rms(camset, dd, poses, tpl, names, device,
                                    dtype)
    im_i = dd[:, 1].astype(int)
    per_image = {}
    for i in np.unique(im_i):
        e = err2[im_i == i]
        e = e[np.isfinite(e)]
        per_image[int(i)] = float(np.sqrt(e.mean())) if e.size else \
            float("nan")

    # leave-one-out: poses fitted without camera c, c scored against them
    loo = {}
    cam_i = dd[:, 0].astype(int)
    for c, name in enumerate(names):
        rest = dd[cam_i != c]
        held = dd[cam_i == c]
        if not held.size:
            loo[name] = float("nan")
            continue
        counts = np.bincount(rest[:, 1].astype(int),
                             minlength=poses.shape[0])
        if rest.size == 0 or (counts >= 3).sum() < 1:
            loo[name] = float("nan")
            continue
        det_rest = TargetDetection(cam_names=names, data=rest)
        # warm-started from the main fit's (consensus-robust) poses
        solver = rob if rob is not None else tracker
        poses_rest, _ = solver.track_batch(det_rest, inits=poses)
        _, e2 = _per_camera_rms(camset, held, poses_rest, tpl, names,
                                device, dtype)
        e2 = e2[np.isfinite(e2)]
        loo[name] = float(np.sqrt(e2.mean())) if e2.size else float("nan")

    drifted = []
    for name in names:
        v = loo[name]
        others = np.array([loo[n] for n in names
                           if n != name and np.isfinite(loo[n])])
        if not np.isfinite(v) or others.size == 0:
            continue
        if v > drift_ratio * np.median(others) and v > drift_abs_px:
            drifted.append(name)

    all_e = err2[np.isfinite(err2)]
    report = {
        "overall_rms_px": float(np.sqrt(all_e.mean())) if all_e.size
        else float("nan"),
        "per_camera_rms_px": per_cam,
        "per_image_rms_px": per_image,
        "leave_one_out_rms_px": loo,
        "drifted": drifted,
        "poses": poses,
        "tracker_info": info,
        "thresholds": {"drift_ratio": drift_ratio,
                       "drift_abs_px": drift_abs_px},
    }
    if drifted:
        logger.warning("rig drift detected: %s (leave-one-out rms %s px)",
                       drifted, {n: round(loo[n], 3) for n in drifted})
    return report


def _model_of(camset):
    """The problem's camera_model from the rig's distortion widths; a
    heterogeneous rig (4-wide fisheye beside Brown) gives a per-camera
    list."""
    from pycamset_tpu_torch.optim.handlers import infer_shared_n_dist
    of_width = {4: "fisheye", 5: "standard", 8: "rational",
                12: "thin_prism", 14: "tilted"}

    def brown_of(n):
        return ("tilted" if n > 12 else "thin_prism" if n > 8
                else "rational" if n > 5 else "standard")

    dl = [np.reshape(camset[n].distortion_coefs, -1)
          for n in camset.get_names()]
    sizes = {d.size for d in dl}
    if 4 in sizes and sizes != {4}:
        return ["fisheye" if d.size == 4 else brown_of(d.size)
                for d in dl]
    return of_width[infer_shared_n_dist(dl)]


def _recalibrate(camset, detection, target, refresh, free: str,
                 options: dict | None, start: str, device, dtype):
    """Shared core of the partial recalibrations: a template BA where
    everything is pinned through ``fixed_params`` except the ``free``
    block ("ext" or "int") of the ``refresh`` cameras."""
    from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
    from pycamset_tpu_torch.optim.handlers import (TemplateBundleHandler,
                                                   rig_start)

    names = camset.get_names()
    unknown = [n for n in refresh if n not in names]
    if unknown:
        raise ValueError(f"unknown cameras {unknown}; rig has {names}")
    if start not in ("pnp", "rig"):
        raise ValueError(f"unknown start {start!r}; expected 'pnp' or "
                         "'rig'")
    if start == "pnp":
        from pycamset_tpu_torch.utils.general_utils import require_cv2
        require_cv2("The PnP start of the recalibration",
                    "pass start='rig'")

    fixed = {}
    for name in names:
        cam = camset[name]
        f = {"int": np.asarray(cam.intrinsic, dtype=float),
             "dst": np.reshape(np.asarray(cam.distortion_coefs, float), -1),
             "ext": np.asarray(cam.extrinsic, dtype=float)}
        if name in refresh:
            del f[free]
            if free == "int":
                del f["dst"]  # the lens refresh frees distortion too
        fixed[name] = f

    opts = {"outliers": "n", "camera_model": _model_of(camset),
            # the pinned cameras ARE the gauge; a pinned target pose
            # would over-constrain (it belongs to the old recording)
            "fixed_pose": None}
    if options:
        opts.update(options)
    handler = TemplateBundleHandler(camset, target, detection,
                                    fixed_params=fixed, options=opts)
    if start == "rig":
        rig_start(handler, camset, detection, target, device, dtype)
    res, new_cams = run_bundle_adjustment(handler, dtype=dtype,
                                          device=device)
    rms = float(np.sqrt(np.mean(
        np.sum(np.reshape(new_cams.calibration_result, (-1, 2)) ** 2,
               axis=1))))
    return new_cams, rms, res


def recalibrate_extrinsics(camset, detection, target, refresh=None,
                           options: dict | None = None, start: str = "pnp",
                           device="cuda", dtype=None):
    """Refresh camera placements with every lens model pinned.

    :param camset: the calibrated rig (source of the pinned intrinsics
        and of the anchor extrinsics).
    :param detection: fresh detections to refit against.
    :param refresh: camera names whose extrinsics are re-solved; default
        every camera except the first. The others keep their extrinsics
        and define the gauge (the result stays in the original world
        frame); at least one camera must stay pinned.
    :param options: extra problem options (loss, max_nfev, backend, ...).
    :param start: the solve's start, ``"pnp"`` (OpenCV) or ``"rig"`` (no
        OpenCV; module docstring).
    :param device: where the solve runs (the card unless the caller names
        another); :param dtype: its dtype.
    :return: (new CameraSet, report dict with per-camera rotation (mrad)
        and translation (mm) deltas, the solve rms and its LM result).
    """
    names = camset.get_names()
    if refresh is None:
        refresh = list(names[1:])
    anchors = [n for n in names if n not in refresh]
    if not anchors:
        raise ValueError(
            "every camera is being refreshed: at least one camera must "
            "keep its extrinsic to anchor the world frame (pass refresh= "
            "excluding a trusted camera, e.g. the least-drifted one from "
            "rig_health)")
    new_cams, rms, res = _recalibrate(camset, detection, target, refresh,
                                      "ext", options, start, device, dtype)

    deltas = {}
    for name in refresh:
        old, new = camset[name].extrinsic, new_cams[name].extrinsic
        drot = new[:3, :3] @ old[:3, :3].T
        ang = np.arccos(np.clip((np.trace(drot) - 1) / 2, -1.0, 1.0))
        old_c = -old[:3, :3].T @ old[:3, 3]
        new_c = -new[:3, :3].T @ new[:3, 3]
        deltas[name] = {
            "rotation_mrad": float(ang * 1e3),
            "translation_mm": float(np.linalg.norm(new_c - old_c) * 1e3),
        }
    report = {"rms_px": rms, "deltas": deltas, "anchors": anchors,
              "refreshed": list(refresh), "result": res}
    logger.info("extrinsic refresh: rms %.3f px; deltas %s", rms,
                {n: (round(d['rotation_mrad'], 3),
                     round(d['translation_mm'], 3))
                 for n, d in deltas.items()})
    return new_cams, report


def recalibrate_intrinsics(camset, detection, target, refresh=None,
                           options: dict | None = None, start: str = "pnp",
                           device="cuda", dtype=None):
    """Refresh lens models with every camera placement pinned (a
    refocused or re-apertured lens on an unmoved mount): the ``refresh``
    cameras' intrinsics and distortion are re-solved while all extrinsics
    stay pinned (they fix the gauge).

    :param refresh: camera names whose lens models are re-solved; default
        all cameras. :param start, device, dtype: as
        :func:`recalibrate_extrinsics`.
    :return: (new CameraSet, report dict with per-camera focal /
        principal-point deltas in px, the solve rms and its LM result).
    """
    names = camset.get_names()
    if refresh is None:
        refresh = list(names)
    new_cams, rms, res = _recalibrate(camset, detection, target, refresh,
                                      "int", options, start, device, dtype)

    deltas = {}
    for name in refresh:
        old, new = camset[name].intrinsic, new_cams[name].intrinsic
        deltas[name] = {
            "focal_px": float(np.hypot(new[0, 0] - old[0, 0],
                                       new[1, 1] - old[1, 1])),
            "principal_px": float(np.hypot(new[0, 2] - old[0, 2],
                                           new[1, 2] - old[1, 2])),
            "dist_delta": float(np.abs(
                np.reshape(new_cams[name].distortion_coefs, -1)
                - np.reshape(camset[name].distortion_coefs, -1)).max()),
        }
    report = {"rms_px": rms, "deltas": deltas, "refreshed": list(refresh),
              "result": res}
    logger.info("intrinsic refresh: rms %.3f px; deltas %s", rms, deltas)
    return new_cams, report
