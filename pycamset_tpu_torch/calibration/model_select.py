"""Automatic camera-model selection by held-out reprojection error.

Counterpart of ``pycamset_tpu/calibration/model_select.py``. More
distortion coefficients always lower the training residual; the criterion
is generalisation:

1. split the detection table's images into a train and a holdout set (the
   JAX package's numpy split: the same images for the same seed);
2. for each candidate model, bundle-adjust on the train images only (the
   port's ``driver.run_bundle_adjustment``: Kernel A or B on a card);
3. freeze the trained cameras and solve only the target pose of each
   holdout image (``optim/find_target.py``), scoring its reprojection rms;
4. pick the model with the lowest holdout rms, preferring fewer parameters
   whenever a simpler model sits within ``parsimony_tol`` of the best.

The start (``start``) of every template solve and every holdout pose
solve: ``"pnp"`` is the JAX package's (OpenCV PnP on the host); ``"rig"``
needs no OpenCV (the card's machine has none): the seed rig's own values
and the port's tracker's poses on it (``optim/handlers.py::rig_start``),
in the handler's gauge. A per-camera solve has one camera, where the
tracker's device seeding cannot triangulate: its poses are the whole
seed rig's tracker poses, re-expressed in that camera's frame.

``initial_cams=None`` needs the OpenCV initial calibration
(``run_initial_calibration``), which is not ported (ROADMAP Queue A item
3): it raises ``NotImplementedError``.
"""
from __future__ import annotations

import logging
from typing import NamedTuple, Sequence

import numpy as np

from pycamset_tpu_torch.models.detections import TargetDetection
# intrinsic parameter count per camera, the parsimony ordering — the
# handlers' validation table is the single source of truth
from pycamset_tpu_torch.optim.handlers import _CAMERA_MODELS as _MODEL_WIDTHS

# fisheye is excluded by default: it is a different projection family
# (Kannala-Brandt theta-polynomial, for >100 deg lenses) whose seeding
# rejects narrow-lens data outright — ask for it explicitly when the rig
# is actually fisheye.
DEFAULT_CANDIDATES = ("standard", "rational", "thin_prism", "tilted")


class ModelScore(NamedTuple):
    """One candidate's scorecard."""
    model: str
    n_intr: int            # intrinsic params per camera
    train_rms: float       # px, on the train images at the BA solution
    holdout_rms: float     # px, on held-out images with pose-only solves
    n_train_dets: int
    n_holdout_dets: int


def subset_ims(detection: TargetDetection, im_ids: np.ndarray
               ) -> TargetDetection:
    """The detection rows of ``im_ids`` only, renumbered contiguously.

    The handlers iterate images 0..max_ims-1, so a subset must be
    renumbered (rank within the sorted kept ids), not just filtered.
    """
    rows = detection.get_data()
    if rows is None:
        raise ValueError("detection table has no data to subset")
    keep_ids = np.unique(np.asarray(im_ids, dtype=int))
    im_col = rows[:, 1].astype(int)
    sel = np.isin(im_col, keep_ids)
    out = rows[sel].copy()
    out[:, 1] = np.searchsorted(keep_ids, im_col[sel])
    return TargetDetection(cam_names=detection.cam_names, data=out,
                           max_ims=len(keep_ids))


def split_detection_images(detection: TargetDetection,
                           holdout_fraction: float = 0.25, seed: int = 0,
                           min_train: int = 4, min_holdout: int = 1
                           ) -> tuple[TargetDetection, TargetDetection]:
    """Random image-level train/holdout split (deterministic in ``seed``).

    Splitting by image — the unit the pose parameters attach to — keeps
    the holdout genuinely unseen: no holdout observation shares a pose
    with any training observation.
    """
    rows = detection.get_data()
    if rows is None:
        raise ValueError("detection table has no data to split")
    im_ids = np.unique(rows[:, 1].astype(int))
    if len(im_ids) < min_train + min_holdout:
        raise ValueError(
            f"model selection needs >= {min_train + min_holdout} images "
            f"with detections; this table has {len(im_ids)}")
    rng = np.random.default_rng(seed)
    shuffled = rng.permutation(im_ids)
    n_hold = int(round(holdout_fraction * len(im_ids)))
    n_hold = max(min_holdout, min(n_hold, len(im_ids) - min_train))
    hold_ids, train_ids = shuffled[:n_hold], shuffled[n_hold:]
    return subset_ims(detection, train_ids), subset_ims(detection, hold_ids)


def _rms_px(fun: np.ndarray) -> float:
    """Residual vector (flat u/v components) -> rms in px per component
    pair: sqrt(cost / (2 n)) == sqrt(mean(fun^2))."""
    return float(np.sqrt(np.mean(np.square(fun))))


def _family_seed(initial_cams, model):
    """A seed CameraSet whose distortion width matches ``model``'s family.

    The 4-wide distortion vector is the fisheye marker throughout the
    package (a Brown handler rejects it and vice versa), so scoring a
    fisheye candidate from a Brown seed — or the reverse — swaps in a
    zero-distortion vector of the right family width. Within a family
    the handler pads the tail itself. ``model`` may be a per-camera
    {name: model} map (per-camera auto selection picked a mixed rig).
    """
    from pycamset_tpu_torch.models.camera_set import CameraSet, make_cam_dict

    names = initial_cams.get_names()
    if isinstance(model, dict):
        fisheye_of = {str(k): v == "fisheye" for k, v in model.items()}
    else:
        fisheye_of = {str(n): model == "fisheye" for n in names}
    dists, changed = [], False
    for n in names:
        want_fisheye = fisheye_of[str(n)]
        d = np.reshape(np.asarray(initial_cams[n].distortion_coefs,
                                  dtype=float), -1)
        if (d.size == 4) != want_fisheye:
            d = np.zeros(4 if want_fisheye else 5)
            changed = True
        dists.append(d)
    if not changed:
        return initial_cams
    return CameraSet(camera_dict=make_cam_dict(
        names, [np.asarray(initial_cams[n].extrinsic) for n in names],
        [np.asarray(initial_cams[n].intrinsic) for n in names],
        dists, [initial_cams[n].res for n in names]))


def _tracked(cams, target, det, device, dtype) -> np.ndarray:
    """The port's tracker's poses (I, 4, 4) of ``det`` on ``cams``
    (device seeding), NaN where it cannot place a frame."""
    from pycamset_tpu_torch.tracking import TargetTracker
    poses, info = TargetTracker(cams, target, device=device,
                                dtype=dtype).track_batch(
        det, seed_mode="device")
    poses = np.array(poses, dtype=float)
    poses[np.asarray(info["n_used"]) < 3] = np.nan
    return poses


def score_camera_model(model: str, train_det: TargetDetection,
                       holdout_det: TargetDetection, target,
                       initial_cams, fixed_params: dict | None = None,
                       problem_options: dict | None = None,
                       start: str = "pnp", device="cuda",
                       dtype=None) -> ModelScore:
    """Train ``model`` on the train split; score it on the holdout split.

    ``initial_cams`` may carry any seed distortion width — the handler
    pads/truncates the seed to the model's width (zero-extended tails).
    :param start: ``"pnp"`` or ``"rig"`` (module docstring), for the train
        solve and the holdout pose solves. :param device, dtype: where
        and in what they run (the card unless the caller names another).
    """
    from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
    from pycamset_tpu_torch.optim.find_target import (
        check_start, estimate_poses_with_fixed_cameras)
    from pycamset_tpu_torch.optim.handlers import (TemplateBundleHandler,
                                                   rig_start)

    check_start(start)
    opts = dict(problem_options or {})
    opts.update({"camera_model": model, "outliers": "n", "verbosity": 0})
    seed_cams = _family_seed(initial_cams, model)
    handler = TemplateBundleHandler(
        camset=seed_cams, detection=train_det,
        target=target, fixed_params=fixed_params, options=opts)
    if start == "rig":
        rig_start(handler, seed_cams, train_det, target, device, dtype)
    result, trained = run_bundle_adjustment(
        handler, backend=opts.get("backend", "auto"), dtype=dtype,
        device=device)

    _poses, hold_res = estimate_poses_with_fixed_cameras(
        trained, target, holdout_det, start=start, device=device,
        dtype=dtype)
    return ModelScore(model=model, n_intr=_MODEL_WIDTHS[model],
                      train_rms=_rms_px(result["fun"]),
                      holdout_rms=_rms_px(hold_res["fun"]),
                      n_train_dets=result["fun"].size // 2,
                      n_holdout_dets=hold_res["fun"].size // 2)


def pick_model(scores: Sequence[ModelScore],
               parsimony_tol: float = 0.02) -> ModelScore:
    """Lowest holdout rms, preferring fewer parameters within tolerance.

    Among every candidate whose holdout rms is within
    ``(1 + parsimony_tol)`` of the best, the one with the fewest
    intrinsic parameters wins — extra coefficients must EARN their keep
    on data they were not fitted to.
    """
    # a candidate whose pose solves diverged scores NaN without raising;
    # treat it as failed rather than letting NaN poison min()
    finite = [s for s in scores if np.isfinite(s.holdout_rms)]
    if not finite:
        raise ValueError("no candidate model produced a finite score")
    best = min(s.holdout_rms for s in finite)
    viable = [s for s in finite if s.holdout_rms <= best * (1 + parsimony_tol)]
    return min(viable, key=lambda s: (s.n_intr, s.holdout_rms))


def _single_cam_detection(det: TargetDetection, c: int) -> TargetDetection:
    """One camera's rows as a standalone 1-camera detection table."""
    rows = det.get_data()
    sel = rows[:, 0].astype(int) == c
    out = rows[sel].copy()
    out[:, 0] = 0
    return TargetDetection(cam_names=[det.cam_names[c]], data=out,
                           max_ims=det.max_ims)


def score_models_per_camera(candidates, train_det, holdout_det, target,
                            initial_cams, fisheye_seed=None,
                            fixed_params: dict | None = None,
                            problem_options: dict | None = None,
                            start: str = "pnp", device="cuda", dtype=None):
    """Per-camera holdout scores from per-camera INDEPENDENT solves.

    Each camera trains alone (1-camera template BA with its extrinsic
    pinned to identity — the per-image poses absorb the gauge) and is
    scored by pose-only solves on its own holdout rows, so one camera's
    family mismatch cannot contaminate another's score through shared
    target poses. With ``start="rig"`` the poses of both splits are
    tracked once on the whole seed rig and re-expressed in each camera's
    frame.

    :return: ({model: {cam_name: holdout_rms}}, scorecards) — a failed
        (cam, model) cell scores NaN.
    """
    from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
    from pycamset_tpu_torch.optim.find_target import (
        check_start, estimate_poses_with_fixed_cameras)
    from pycamset_tpu_torch.optim.handlers import (TemplateBundleHandler,
                                                   rig_start)

    check_start(start)
    tracked = {}
    per_cam_scores: dict = {m: {} for m in candidates}
    scores: list[ModelScore] = []
    for model in candidates:
        seed_all = (fisheye_seed if model == "fisheye"
                    and fisheye_seed is not None else initial_cams)
        if start == "rig" and id(seed_all) not in tracked:
            tracked[id(seed_all)] = tuple(
                _tracked(seed_all, target, d, device, dtype)
                for d in (train_det, holdout_det))
        train_rms2, hold_rms2 = [], []
        n_train = n_hold = 0
        for c, name in enumerate(train_det.cam_names):
            name = str(name)
            try:
                cam_train = _single_cam_detection(train_det, c)
                cam_hold = _single_cam_detection(holdout_det, c)
                seed1 = _family_seed(seed_all.make_subset([c]), model)
                opts = dict(problem_options or {})
                opts.update({"camera_model": model, "outliers": "n",
                             "verbosity": 0})
                handler = TemplateBundleHandler(
                    camset=seed1, detection=cam_train, target=target,
                    fixed_params={name: {"ext": np.eye(4)}}, options=opts)
                hold_start = start
                if start == "rig":
                    poses_train, poses_hold = tracked[id(seed_all)]
                    rig_start(handler, seed1, cam_train, target, device,
                              dtype, poses=poses_train)
                    # the trained camera's frame is its own: the holdout
                    # seeds in it
                    hold_start = np.einsum(
                        "ab,ibc->iac", seed1[0].extrinsic, poses_hold)
                result, trained = run_bundle_adjustment(
                    handler, backend=opts.get("backend", "auto"),
                    dtype=dtype, device=device)
                _p, hres = estimate_poses_with_fixed_cameras(
                    trained, target, cam_hold, start=hold_start,
                    device=device, dtype=dtype)
                per_cam_scores[model][name] = _rms_px(hres["fun"])
                train_rms2.append(np.sum(np.square(result["fun"])))
                hold_rms2.append(np.sum(np.square(hres["fun"])))
                n_train += result["fun"].size // 2
                n_hold += hres["fun"].size // 2
            except Exception as e:
                logging.warning(f"camera model {model!r} failed for camera "
                                f"{name!r}: {e!r}")
                per_cam_scores[model][name] = np.nan
        if n_train and n_hold:
            scores.append(ModelScore(
                model=model, n_intr=_MODEL_WIDTHS[model],
                train_rms=float(np.sqrt(np.sum(train_rms2) / (2 * n_train))),
                holdout_rms=float(np.sqrt(np.sum(hold_rms2) / (2 * n_hold))),
                n_train_dets=n_train, n_holdout_dets=n_hold))
        for name, rms in per_cam_scores[model].items():
            logging.info(f"model {model:>10} / {name}: "
                         f"holdout {rms:.4f} px")
    return per_cam_scores, scores


def pick_model_per_camera(per_cam_scores: dict, cam_names,
                          parsimony_tol: float = 0.02):
    """Per-camera winners from {model: {cam: holdout_rms}} scorecards.

    Same parsimony rule as pick_model, applied per camera. Returns a
    single model name when every camera agrees, else the {cam: model}
    map a heterogeneous handler consumes.
    """
    winners = {}
    for name in (str(n) for n in cam_names):
        rows = [(m, rms[name]) for m, rms in per_cam_scores.items()
                if np.isfinite(rms.get(name, np.nan))]
        if not rows:
            raise ValueError(
                f"no candidate model produced a finite holdout score for "
                f"camera {name!r}")
        best = min(r for _, r in rows)
        viable = [(m, r) for m, r in rows
                  if r <= best * (1 + parsimony_tol)]
        winners[name] = min(
            viable, key=lambda mr: (_MODEL_WIDTHS[mr[0]], mr[1]))[0]
    picks = set(winners.values())
    return winners[str(cam_names[0])] if len(picks) == 1 else winners


def select_camera_model(detection: TargetDetection, target,
                        initial_cams=None, cam_res: list | None = None,
                        candidates: Sequence[str] = DEFAULT_CANDIDATES,
                        holdout_fraction: float = 0.25, seed: int = 0,
                        parsimony_tol: float = 0.02,
                        fixed_params: dict | None = None,
                        problem_options: dict | None = None,
                        per_camera: bool = False, start: str = "pnp",
                        device="cuda", dtype=None
                        ) -> tuple[str, list[ModelScore]]:
    """Cross-validated camera-model selection.

    :param detection: the full detection table.
    :param target: the calibration target (template geometry).
    :param initial_cams: seed CameraSet (None needs the OpenCV initial
        calibration, not ported: ``NotImplementedError``).
    :param candidates: model names to try (fisheye only by request — see
        DEFAULT_CANDIDATES).
    :param holdout_fraction: fraction of images held out for scoring.
    :param seed: train/holdout split seed.
    :param parsimony_tol: relative holdout-rms band within which a model
        with fewer parameters beats a lower-error one.
    :param per_camera: pick a model PER CAMERA from the per-camera
        holdout scores (parsimony applied camera-wise). Mixed picks
        return a {cam: model} map.
    :param start: ``"pnp"`` or ``"rig"`` (module docstring).
    :param device: where the solves run (the card unless the caller names
        another); :param dtype: their dtype.
    :return: (winning model name OR per-camera map, per-candidate
        scorecards). A candidate whose train or scoring solve raises is
        logged and skipped; at least one candidate must survive.
    """
    from pycamset_tpu_torch.optim.find_target import check_start
    bad = sorted(set(candidates) - set(_MODEL_WIDTHS))
    if bad:
        raise ValueError(f"unknown camera model(s) {bad}; expected a "
                         f"subset of {sorted(_MODEL_WIDTHS)}")
    check_start(start)
    train_det, holdout_det = split_detection_images(
        detection, holdout_fraction=holdout_fraction, seed=seed)

    if initial_cams is None:
        raise NotImplementedError(
            "select_camera_model(initial_cams=None) seeds from the OpenCV "
            "initial calibration (run_initial_calibration), which the port "
            "does not have yet (ROADMAP Queue A item 3); pass initial_cams")

    if per_camera:
        # per-camera selection must come from per-camera INDEPENDENT
        # solves: in a joint rig-wide candidate solve a wrong family on
        # one camera drags the shared target poses and contaminates every
        # other camera's holdout score
        per_cam_scores, scores = score_models_per_camera(
            candidates, train_det, holdout_det, target, initial_cams,
            fixed_params=fixed_params, problem_options=problem_options,
            start=start, device=device, dtype=dtype)
        picked = pick_model_per_camera(per_cam_scores, detection.cam_names,
                                       parsimony_tol=parsimony_tol)
        logging.info(f"selected per-camera model(s): {picked!r}")
        return picked, scores

    scores: list[ModelScore] = []
    errors: list[str] = []
    for model in candidates:
        try:
            s = score_camera_model(
                model, train_det, holdout_det, target, initial_cams,
                fixed_params=fixed_params,
                problem_options=problem_options, start=start,
                device=device, dtype=dtype)
        except Exception as e:  # a model that cannot fit is a result,
            logging.warning(     # not a crash of the selection
                f"camera model {model!r} failed during selection: {e!r}")
            errors.append(f"{model}: {e!r}")
            continue
        logging.info(f"model {model:>10}: train {s.train_rms:.4f} px, "
                     f"holdout {s.holdout_rms:.4f} px "
                     f"({s.n_intr} intrinsics/cam)")
        scores.append(s)
    if not scores:
        raise RuntimeError(
            "every candidate camera model failed during selection:\n  "
            + "\n  ".join(errors))

    winner = pick_model(scores, parsimony_tol=parsimony_tol)
    logging.info(f"selected camera model {winner.model!r} "
                 f"(holdout {winner.holdout_rms:.4f} px)")
    return winner.model, scores
