"""AbstractTarget: the calibration-target base class (host side).

Counterpart of the core of ``pycamset_tpu/models/abstract_target.py``:
``point_data`` of shape (u, ..., w, n, 3) (faces of n coplanar points),
the per-face locally flat coordinates (``make_local``), ``get_keys``,
``target_pose_in_cam_image`` (PnP, ``:419-475``) and ``pose_in_detections``
(``:477-525``); and ``FreePointTarget`` (``pycamset_tpu/optim/handlers.py:
1363``), a target given by its point cloud alone. The ChArUco and Ccube
targets, image detection and the ``cv2.calibrateCamera`` seed are the next
slice of ROADMAP Queue A item 3.

PnP is OpenCV's ``solvePnPGeneric`` on the host: ``target_pose_in_cam_image``
imports cv2 when it is called and raises ``ImportError`` without it. A
handler seeded through ``set_initial_params`` never calls it.
"""
from __future__ import annotations

import logging
from abc import ABC, abstractmethod
from copy import copy

import numpy as np

from pycamset_tpu_torch.models.detections import (ImageDetection,
                                                  TargetDetection)
from pycamset_tpu_torch.utils.general_utils import (cv2_pose,
                                                    mad_outlier_detection,
                                                    require_cv2)

SEED_INSTEAD = ("seed the handler with handler.set_initial_params(x0) "
                "instead")


def get_keys(data: np.ndarray) -> np.ndarray:
    """Key columns of a detection table; 1-d keys get a leading face 0."""
    keys = data[:, 2:-2]
    if keys.shape[1] > 1:
        return keys
    return np.hstack([np.zeros_like(keys), keys])


class AbstractTarget(ABC):
    """An abstract calibration target.

    Inheritors define ``find_in_image`` and ``point_data`` of shape
    (u, ..., w, n, 3); they call ``super().__init__(inputs=locals())`` with
    the constructor arguments (for persistence) and ``self._process_data()``
    after setting ``point_data``.
    """

    def __init__(self, inputs: dict):
        # the constructor arguments (arrays as lists), so that a saved
        # calibration can rebuild the target by name
        self.input_args = {
            k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in inputs.items() if k not in ("self", "__class__")
        }
        self.point_data: np.ndarray | None = None
        self.point_local: np.ndarray | None = None
        self.original_points: np.ndarray | None = None
        self.valid_map: bool | np.ndarray = True

    def _process_data(self):
        """Call at the end of any inheriting __init__."""
        self.point_local = self.make_local()
        self.original_points = self.point_data.copy()

    @abstractmethod
    def find_in_image(self, image, draw=False, camera=None,
                      wait_len=1) -> ImageDetection:
        """Detect the target in an image; return an ImageDetection."""
        raise NotImplementedError

    def make_local(self) -> np.ndarray:
        """Per-face locally flat (z = 0) coordinates via a change of basis
        (the seeding assumes each face is planar)."""
        if self.point_data is None:
            raise AttributeError(
                "The self.point_data variable should be set during "
                "initialisation")
        if self.point_data.ndim == 2:
            self.point_data = self.point_data[None]
        full_shape = self.point_data.shape
        faces = self.point_data.reshape(-1, full_shape[-2], 3)
        if len(faces) == 1:
            return copy(self.point_data)

        def unit(v):
            return v / np.linalg.norm(v, axis=-1, keepdims=True)

        # per-face frame: the first edge, the fitted plane normal (the
        # least principal axis of the face's scatter) and their cross product
        anchor = faces[:, 0]
        edge = faces[:, 1] - anchor
        spread = faces - faces.mean(axis=1, keepdims=True)
        normal = np.stack([np.linalg.svd(s.T @ s)[0][:, -1] for s in spread])
        frame = np.stack(
            [unit(np.cross(edge, normal)), unit(edge), unit(normal)], axis=1)
        flattened = (faces - anchor[:, None]) @ np.linalg.inv(frame)
        return flattened.reshape(full_shape)

    def target_pose_in_cam_image(self, detection: TargetDetection, cam,
                                 refine: bool = False,
                                 mode: str = "throw") -> np.ndarray:
        """PnP pose of the target (target -> camera 4x4) in one image, by
        OpenCV on the host. mode='nan' returns a nan matrix instead of
        raising on failure."""
        cv2 = require_cv2("PnP pose seeding (target_pose_in_cam_image)",
                          SEED_INSTEAD)

        def fail(msg):
            if mode == "nan":
                return np.full((4, 4), np.nan)
            raise ValueError(msg)

        if not detection.has_data():
            return fail(f"The detection had no data at all, including for "
                        f"camera {cam.name}")
        rows = detection.get(cam=cam.name).get_data()
        if rows is None:
            return fail(f"The detection had no data for camera {cam.name}")
        if len(np.unique(rows[:, 1])) > 1:
            return fail("passed detection contained info from multiple "
                        "cameras; pose estimation only works with 1 image")

        keys = get_keys(rows).astype(int)
        seen_model_pts = self.point_data[tuple(keys.T)]
        if len(seen_model_pts) < 6:
            return fail("Inadequate number of corners for pose estimation")
        dist = np.ravel(np.asarray(cam.distortion_coefs, dtype=float))
        obs_px = rows[:, -2:]
        err_scale = 1.0
        if dist.size == 4:
            # the fisheye marker width: solvePnP takes Brown-Conrady
            # distortion, so undistort to the normalized pinhole frame first
            # and solve with an identity intrinsic; the residuals are then in
            # normalized units and rescale by the focal for the check below
            err_scale = float(cam.intrinsic[0, 0])
            norm = cv2.fisheye.undistortPoints(
                obs_px.reshape(1, -1, 2).astype(np.float64),
                np.asarray(cam.intrinsic, dtype=float), dist)
            obs_px, kmat, dist = norm.reshape(-1, 2), np.eye(3), np.zeros(5)
        else:
            kmat = cam.intrinsic
        _n_sols, rvecs, tvecs, per_sol_err = cv2.solvePnPGeneric(
            seen_model_pts.astype("float32"),
            obs_px.astype("float32"), kmat, dist)
        best = int(np.argmin(per_sol_err))
        best_err = float(np.squeeze(per_sol_err[best])) * err_scale
        if best_err > 5:
            logging.warning(
                f"Initial error of {best_err: .2f} found for a pose "
                f"detection.")
        if refine:
            raise NotImplementedError
        return cv2_pose(cv2, rvecs[best], tvecs[best])

    def pose_in_detections(self, detections: TargetDetection, camset,
                           ref_cam=0, outliers: str = "ask"
                           ) -> tuple[list[np.ndarray], np.ndarray]:
        """World-frame target poses per image (PnP from the reference
        camera, else any other that saw the target), with MAD outlier
        filtering: 'ask' prompts, 'y' removes outliers, 'n' keeps them.

        :return: (the found 4x4 poses, (I,) bool: a pose found in each
            image).
        """
        cv2 = require_cv2("PnP pose seeding (pose_in_detections)",
                          SEED_INSTEAD)
        cam_order = [ref_cam] + sorted(
            set(range(camset.get_n_cams())) - {ref_cam})

        def world_pose_of(im_rows):
            for idx in cam_order:
                viewer = camset[idx]
                try:
                    local = self.target_pose_in_cam_image(im_rows, viewer)
                    return viewer.cam_to_world @ local
                except (ValueError, cv2.error):
                    continue
            return None

        maybe_poses = [world_pose_of(im_rows)
                       for im_rows in detections.get_image_list()]
        p_detected = np.array([p is not None for p in maybe_poses])
        poses = [p for p in maybe_poses if p is not None]
        centre = np.mean([p[:3, 3] for p in poses], axis=0)

        logging.info("Beginning outlier detection")
        for sweep in range(10):
            flagged = mad_outlier_detection(
                [np.linalg.norm(p[:3, 3] - centre) for p in poses],
                out_thresh=5)
            if flagged is None:
                logging.info(f"No outliers detected in iteration {sweep}.")
                break
            choice = outliers
            while choice not in ("y", "n"):
                print(f"Outliers detected in iteration {sweep}.")
                choice = input("Drop these outlier detections? [y/n]: ")
            if choice != "y":
                break
            original_rows = np.flatnonzero(p_detected)[flagged]
            p_detected[original_rows] = False
            poses = list(np.delete(np.array(poses), flagged, axis=0))
        return poses, p_detected


class FreePointTarget(AbstractTarget):
    """A bare container target defined only by its point cloud."""

    def __init__(self, point_data):
        super().__init__(inputs=locals())
        self.point_data = np.asarray(point_data, dtype=float)
        self._process_data()

    def find_in_image(self, image, draw=False, camera=None, wait_len=1):
        raise NotImplementedError
