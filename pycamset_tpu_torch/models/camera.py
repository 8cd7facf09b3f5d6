"""The Camera model: pinhole + lens distortion with derived state.

Counterpart of the state and device parts of ``pycamset_tpu/models/camera.py``
(``:74-237``): the state (extrinsic 4x4, intrinsic 3x3, distortion, res,
name), the state derived from it on update (cam_to_world, position, view
and up vectors, fov, the 3x4 projection, the optional sensor map),
``project_points``, ``undistort_points``, ``can_image``,
``im_to_world_ray``, the image ``undistort``, the intrinsic edits
(``scale_self_2n``, ``crop_to_roi``, ``reset_to_original_params``), the
rig transform (``transform``) and the MVSNet export (``to_MVSnet_txt``).
The distortion's width names the camera model (``ops/distortion.py``): 5
standard, 8 rational, 12 thin-prism, 14 tilted, 4 fisheye (the 4-wide
vector is the fisheye marker: even zeros mean the equidistant mapping).
Plots and meshes wait for ROADMAP Queue A item 10.

Projection and undistortion run through the port's torch ops on
``device`` (the card unless the caller names another; dtype as
``config.default_device_dtype``) and return numpy. The sensor map is the
port's fixed-point undistortion of every pixel, where the JAX package calls
``cv2.undistortImagePoints`` (``cv2.fisheye.undistortPoints`` for a fisheye).
The image ``undistort`` is an OpenCV remap (``cv2.fisheye.undistortImage``
for a fisheye) and imports cv2 when it is called.
"""
from __future__ import annotations

import logging
import math
from copy import deepcopy
from pathlib import Path

import numpy as np
import torch

from pycamset_tpu_torch.config import default_device_dtype, resolve_device
from pycamset_tpu_torch.ops.distortion import distort_pixels, undistort_pixels
from pycamset_tpu_torch.utils.general_utils import (h_tform, require_cv2,
                                                    vector_cam_points)

DEFAULT_RES = [1000, 1000]
DEFAULT_FOCAL_PX = 1000.0

# vector-mode rays are returned as short segments so downstream consumers
# get a point near the camera, not at unit range
VECTOR_RAY_SEGMENT = 0.1
# the focal point marker is drawn this many world units per 1000 focal px
FOCAL_MARKER_PER_KPX = 1.0 / 1000.0


def _default_intrinsic() -> np.ndarray:
    k = np.eye(3)
    k[0, 0] = k[1, 1] = DEFAULT_FOCAL_PX
    k[0, 2] = DEFAULT_RES[0] / 2
    k[1, 2] = DEFAULT_RES[1] / 2
    return k


def _on_device(fn, arrays, device, dtype) -> np.ndarray:
    """fn over the numpy ``arrays`` as tensors on ``device``, as numpy."""
    device = resolve_device(device)
    dtype = dtype or default_device_dtype(device)
    out = fn(*(torch.as_tensor(np.asarray(a, dtype=float), dtype=dtype,
                               device=device) for a in arrays))
    return out.double().cpu().numpy()


def sensor_map(map_type, intrinsics, res=(1600, 1200), dist_coefs=None,
               device="cuda", dtype=None) -> np.ndarray:
    """Per-pixel ray directions (res[0], res[1], 3) in camera space, the
    pixels undistorted first when ``dist_coefs`` is given (on ``device``,
    the card unless the caller names another)."""
    if map_type not in ("normalised", "linear"):
        raise ValueError("Invalid sensor map type")
    v, u = np.meshgrid(np.arange(res[1]), np.arange(res[0]))
    px = np.stack([u.ravel(), v.ravel()], axis=1).astype(float)
    if dist_coefs is not None:
        px = _on_device(undistort_pixels,
                        (px, intrinsics, np.ravel(dist_coefs)), device, dtype)
    homog = np.hstack([px, np.ones((len(px), 1))])
    rays = (homog @ np.linalg.inv(intrinsics).T).reshape(res[0], res[1], 3)
    if map_type == "normalised":
        rays = rays / np.linalg.norm(rays, axis=-1, keepdims=True)
    return rays


class Camera:
    """An object-oriented pinhole + distortion camera model."""

    def __init__(self, extrinsic=None, intrinsic=None, res=None,
                 distortion_coefs=None, name: str | None = None,
                 minimal: bool = True, device="cuda"):
        """
        :param extrinsic: 4x4 world->camera transform.
        :param intrinsic: 3x3 pinhole intrinsic matrix.
        :param res: camera resolution.
        :param distortion_coefs: the lens model's coefficients (5 standard
            Brown–Conrady [k1, k2, p1, p2, k3], 8 rational, 12 thin-prism,
            14 tilted, 4 fisheye), OpenCV order.
        :param name: camera name.
        :param minimal: skip the eager sensor map (lazy for hi-res cams).
        :param device: where a non-minimal camera builds its sensor map on
            each update (the card unless the caller names another).
        """
        self.res = DEFAULT_RES if res is None else res
        self.extrinsic = (np.eye(4) if extrinsic is None
                          else np.asarray(extrinsic, dtype=float))
        self.intrinsic = (_default_intrinsic() if intrinsic is None
                          else np.asarray(intrinsic, dtype=float))
        self.original_matrix = deepcopy(self.intrinsic)
        self.distortion_coefs = (np.zeros(5) if distortion_coefs is None
                                 else np.ravel(np.asarray(distortion_coefs,
                                                          dtype=float)))
        self.cam_to_world: np.ndarray | None = None
        self.down_scale_factor: int = 0
        self.name = name
        self.minimal = bool(minimal)
        self.device = device
        self._update_state()

    def __eq__(self, other):
        if not isinstance(other, Camera):
            return False
        return bool(np.allclose(self.intrinsic, other.intrinsic)
                    and np.allclose(self.extrinsic, other.extrinsic)
                    and np.allclose(np.ravel(self.distortion_coefs),
                                    np.ravel(other.distortion_coefs)))

    # ------------------------------------------------------- derived state

    def _update_state(self):
        """Recalculate all state derived from the camera parameters (the
        eager sensor map of a non-minimal camera on ``self.device``)."""
        c2w = np.linalg.inv(self.extrinsic)
        self.cam_to_world = c2w
        # columns of the rotation part are the camera axes in world space
        self.position = c2w[:3, 3]
        self.view = c2w[:3, 2]
        self.u_axis = -c2w[:3, 1]
        if self.minimal:
            self.sensor_map = self.world_sensor_map = None
        else:
            self._make_sensormap(device=self.device)
        focal_px = self.intrinsic[0, 0]
        self.focal_point = (self.position
                            + FOCAL_MARKER_PER_KPX * focal_px * self.view)
        self.fov = self._cam_fov()
        self.proj = self._calc_projection_matrix()

    def _cam_fov(self):
        half_height = self.res[1] / 2
        return math.degrees(2.0 * np.arctan2(half_height,
                                             self.intrinsic[0, 0]))

    def _calc_projection_matrix(self):
        return self.intrinsic @ self.extrinsic[:3]

    def set_extrinsic(self, new_extrinsic):
        self.extrinsic = np.asarray(new_extrinsic, dtype=float)
        self._update_state()

    def set_distortion_coefs(self, dist_coefs):
        self.distortion_coefs = np.ravel(np.asarray(dist_coefs, dtype=float))
        self._update_state()

    def set_minimal(self, minimal: bool):
        self.minimal = bool(minimal)
        self.sensor_map = self.world_sensor_map = None
        self._update_state()

    # ----------------------------------------------------------- projection

    def project_points(self, points, mode: str = "opencv",
                       distort: bool = True, device="cuda", dtype=None):
        """Project world points (n, 3) to pixel coordinates.

        :param mode: 'opencv' returns (u, v); 'image' returns (v, u).
        :param distort: apply the lens distortion model (on ``device``).
        """
        uv = np.atleast_2d(h_tform(np.asarray(points, dtype=float),
                                   self.proj))
        dist = np.ravel(self.distortion_coefs)
        # a 4-wide vector is the fisheye marker: even all-zero coefficients
        # mean the equidistant mapping (r -> atan r), never the pinhole
        if distort and (dist.size == 4 or np.any(dist)):
            uv = _on_device(distort_pixels, (uv, self.intrinsic, dist),
                            device, dtype)
        return uv[:, ::-1] if mode == "image" else uv

    def undistort_points(self, uv, iters: int = 8, device="cuda",
                         dtype=None):
        """Invert lens distortion on pixel coordinates (n, 2)."""
        return _on_device(
            lambda p, k, d: undistort_pixels(p, k, d, iters=iters),
            (uv, self.intrinsic, np.ravel(self.distortion_coefs)),
            device, dtype)

    def _is_in_image(self, cords) -> bool:
        uv = np.ravel(np.asarray(cords))
        wh = np.asarray(self.res, dtype=float)
        return bool(np.all((uv > 0) & (uv < wh)))

    def can_image(self, pt, device="cuda", dtype=None) -> bool:
        """True if a world point projects inside the image bounds (the
        projection on ``device``)."""
        return self._is_in_image(self.project_points(
            np.asarray(pt)[None], device=device, dtype=dtype))

    # ------------------------------------------------------------ ray casts

    def _make_sensormap(self, mode="linear", distort=True, device="cuda"):
        self.sensor_map = sensor_map(
            mode, self.intrinsic, tuple(self.res),
            dist_coefs=self.distortion_coefs if distort else None,
            device=device)
        # camera-space rays rotated into world axes (stored relative to the
        # camera centre)
        self.world_sensor_map = np.einsum(
            "ij,uvj->uvi", self.cam_to_world[:3, :3], self.sensor_map)

    def get_image_cord_sensor_map(self):
        """Sensor map in image (v, u) order rather than opencv (u, v)."""
        return self.world_sensor_map.transpose(1, 0, 2)

    def im_to_world_ray(self, cord, depth_im=None, distort=True,
                        use_vector=False, device="cuda"):
        """Pixel coordinate(s) (n, 2) -> world-space ray endpoints; with a
        depth image the ray length is the depth at the pixel."""
        px = np.atleast_2d(np.asarray(cord))
        if use_vector:
            src = self.undistort_points(px, device=device) if distort else px
            dirs = vector_cam_points("linear", src, self.intrinsic,
                                     self.cam_to_world)
            return self.position + VECTOR_RAY_SEGMENT * dirs
        self._make_sensormap(distort=distort, device=device)
        dirs = self.world_sensor_map[px[:, 0], px[:, 1]]
        if depth_im is not None:
            depth = depth_im[px[:, 1], px[:, 0]]
            if np.any(np.isnan(depth)):
                logging.warning("Nan length found in depth image used for ray")
            dirs = depth[:, None] * dirs
        return self.position + dirs

    def undistort(self, image: np.ndarray) -> np.ndarray:
        """Undistort an image with the camera parameters (an OpenCV remap,
        on the host; a 4-wide distortion vector, the fisheye, through
        cv2.fisheye)."""
        cv2 = require_cv2("Camera.undistort (an image remap)",
                          "undistort images where OpenCV is installed")
        dist = np.ravel(np.asarray(self.distortion_coefs, dtype=float))
        if dist.size == 4:
            return cv2.fisheye.undistortImage(
                image, self.intrinsic, dist, Knew=self.intrinsic)
        return cv2.undistort(image, self.intrinsic, dist)

    # ------------------------------------------------------ intrinsic edits

    def scale_self_2n(self, down_scale_factor: int = 1):
        """Downscale the intrinsics by a power of two."""
        self.down_scale_factor = down_scale_factor
        shrink = 0.5 ** down_scale_factor
        # averaging 1/shrink pixels moves the pixel-centre origin: the new
        # principal point picks up a (shrink/2 - 1/2) px offset
        centre_shift = (shrink - 1.0) / 2.0
        rescale = np.diag([shrink, shrink, 1.0])
        rescale[:2, 2] = centre_shift
        self.res = [int(n * shrink) for n in self.res]
        self.intrinsic = rescale @ self.intrinsic
        self._update_state()

    def crop_to_roi(self, roi):
        """Alter intrinsics to mimic a cropped sensor.
        roi=[ymin,xmin,xmax,ymax]."""
        ymin, xmin, xmax, ymax = roi
        if xmax > self.res[0] or ymax > self.res[1]:
            raise ValueError("crop bounds outside of camera viewpoint")
        self.intrinsic = self.intrinsic.copy()
        self.intrinsic[0, 2] -= xmin
        self.intrinsic[1, 2] -= ymin
        self._update_state()

    def reset_to_original_params(self):
        self.intrinsic = np.asarray(self.original_matrix)
        self._update_state()

    def transform(self, transformation_matrix):
        """Post-multiply the extrinsic by a 4x4 homogeneous transform."""
        self.set_extrinsic(self.extrinsic @ np.asarray(transformation_matrix))

    # -------------------------------------------------------------- exports

    def to_MVSnet_txt(self, f_loc: Path, depth_range: tuple[float, float],
                      depth_steps: int, crop=None) -> None:
        """Write the camera to the MVSNet cam.txt format."""
        k = self.intrinsic.copy()
        if crop is not None:
            k[0, 2] -= crop[1, 0]
            k[1, 2] -= crop[0, 0]
        near, far = depth_range
        step = (far - near) / depth_steps

        def block(mat):
            return "\n".join(" ".join(str(v) for v in row) for row in mat)

        text = (f"extrinsic\n{block(self.extrinsic)}\n\n"
                f"intrinsic\n{block(k)}\n\n"
                f"{near} {step} {depth_steps} {far}\n")
        Path(f_loc).write_text(text)
