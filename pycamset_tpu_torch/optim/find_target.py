"""Target pose estimation with fixed, pre-calibrated cameras.

Counterpart of ``pycamset_tpu/optim/find_target.py``: the pose of a known
target in each image, every camera parameter held fixed, as the template
bundle adjustment with every camera column pinned (only the per-image pose
blocks are free): a batched, jointly optimal multi-camera PnP. The solve
is the port's ``driver.run_bundle_adjustment`` on the structured backend
(Kernel A or B on a card).

The start (``start``): ``"pnp"`` is the JAX package's, a per-image OpenCV
PnP against the fixed rig (on the host); ``"rig"`` needs no OpenCV (the
card's machine has none): the poses come from the port's tracker on the
rig (device seeding, ``handlers.rig_start``); an (I, 4, 4) array of
target -> world poses seeds the solve with the caller's own (a non-finite
pose leaves its image out).
"""
from __future__ import annotations

import numpy as np

import pycamset_tpu_torch.utils.general_utils as gu
from pycamset_tpu_torch.models.abstract_target import AbstractTarget
from pycamset_tpu_torch.models.camera_set import CameraSet
from pycamset_tpu_torch.models.detections import TargetDetection
from pycamset_tpu_torch.optim.handlers import (TemplateBundleHandler,
                                               infer_shared_n_dist,
                                               rig_start)

RIG_START = "pass start='rig' (the port's tracker seeds the poses)"


def make_fixed_camera_params(camset: CameraSet) -> dict:
    """fixed_params dict pinning every camera's int/ext/dst to its current
    values (the format threaded through calibrate_cameras)."""
    fixed = {}
    for name in camset.get_names():
        cam = camset[name]
        fixed[name] = {
            "int": np.asarray(cam.intrinsic, dtype=float),
            "dst": np.reshape(np.asarray(cam.distortion_coefs, dtype=float),
                              -1),
            "ext": np.asarray(cam.extrinsic, dtype=float),
        }
    return fixed


def _model_of_width(n: int) -> str:
    if n == 4:  # the fisheye marker width
        return "fisheye"
    if n > 12:
        return "tilted"
    if n > 8:
        return "thin_prism"
    if n > 5:
        return "rational"
    return "standard"


class FixedCameraPoseHandler(TemplateBundleHandler):
    """A TemplateBundleHandler with every camera parameter fixed."""

    def __init__(self, camset, target, detection, options=None,
                 missing_poses=None):
        options = dict(options or {})
        # a rig calibrated with the rational / thin-prism model carries
        # 8 / 12 distortion coefficients; follow it rather than truncating
        # to 5
        if "camera_model" not in options:
            dl = [np.reshape(np.asarray(camset[n].distortion_coefs), -1)
                  for n in camset.get_names()]
            sizes = {d.size for d in dl}
            if 4 in sizes and sizes != {4}:
                # heterogeneous rig: follow each camera's own family
                options["camera_model"] = [_model_of_width(d.size)
                                           for d in dl]
            else:
                model = _model_of_width(infer_shared_n_dist(dl))
                if model != "standard":
                    options["camera_model"] = model
        super().__init__(camset, target, detection,
                         fixed_params=make_fixed_camera_params(camset),
                         options=options, missing_poses=missing_poses)

    def calc_initial_params(self) -> np.ndarray:
        """Seed each image's pose by per-camera PnP against the fixed rig
        (OpenCV, on the host; its Rodrigues conversion too, so the seed is
        the JAX package's bit for bit)."""
        cv2 = gu.require_cv2("The PnP seed of the fixed-rig pose solve "
                             "(FixedCameraPoseHandler)", RIG_START)
        prim = self.bundlePrimitive
        last_good = np.eye(4)
        missing = []
        for idp, im_det in enumerate(self.detection.get_image_list()):
            pose_w = None
            for cam in self.camset:
                pose_c = self.target.target_pose_in_cam_image(
                    im_det, cam, mode="nan")
                if not np.any(np.isnan(pose_c)):
                    pose_w = cam.cam_to_world @ pose_c
                    break
            if pose_w is None:
                missing.append(True)
                pose_w = last_good
            else:
                missing.append(False)
                last_good = pose_w
            if prim.poses_unfixed[idp]:
                rvec, tvec = gu.cv2_rod(cv2, pose_w)
                prim.poses[idp] = np.concatenate([rvec, tvec])
        self.missing_poses = np.array(missing)
        return prim.base_full()[prim.unfixed_full()]


def check_start(start, allowed=("pnp", "rig"), what: str = "start"):
    """``start`` is one of ``allowed`` or an array of seed poses (a
    caller-made rig start); the ``"pnp"`` start needs OpenCV here."""
    if isinstance(start, str):
        if start not in allowed:
            raise ValueError(f"unknown {what} {start!r}; expected one of "
                             f"{list(allowed)} or an (I, 4, 4) array of "
                             "seed poses")
        if start == "pnp":
            gu.require_cv2("The PnP start", RIG_START)


def estimate_poses_with_fixed_cameras(
        camset: CameraSet, target: AbstractTarget, detection: TargetDetection,
        options: dict | None = None, return_detection: bool = False,
        start="pnp", device="cuda", dtype=None):
    """Jointly optimal target pose per image given a calibrated rig.

    :param return_detection: also return the flattened detection table the
        solve used — its rows align with ``result['fun']``, so callers can
        bucket residuals (e.g. per camera for per-camera model selection).
    :param start: ``"pnp"`` (OpenCV), ``"rig"`` (the port's tracker on
        ``camset``) or (I, 4, 4) target -> world seed poses (module
        docstring).
    :param device: where the solve runs (the card unless the caller names
        another); :param dtype: its dtype.
    :return: (poses (I,4,4) target->world transforms, OptimizeResult
        [, detection table (N,5)]).
    """
    from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
    check_start(start)
    opts = {"outliers": "n", "fixed_pose": None, "verbosity": 0}
    if options:
        opts.update(options)
    # no gauge fixing needed: the fixed cameras pin the frame
    opts.pop("fixed_pose", None)
    handler = FixedCameraPoseHandler(camset, target, detection, options=opts)
    handler.bundlePrimitive.poses_unfixed[:] = True
    handler.bundlePrimitive.calc_free_poses()
    if not isinstance(start, str):
        rig_start(handler, camset, detection, target, device, dtype,
                  poses=start)
    elif start == "rig":
        rig_start(handler, camset, detection, target, device, dtype)
    result, _ = run_bundle_adjustment(handler, dtype=dtype, device=device)
    _, _, pose6 = handler.bundlePrimitive.return_bundle_primitives(
        result["x"])
    poses = np.array([gu.make_4x4h_tform(p[:3], p[3:]) for p in pose6])
    if return_detection:
        return poses, result, handler.get_detection_data(flatten=True)
    return poses, result
