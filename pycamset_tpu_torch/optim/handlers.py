"""Parameter handlers: the problem a bundle adjustment solves.

Counterpart of ``pycamset_tpu/optim/handlers.py``: ``DEFAULT_OPTIONS``,
``parse_camera_models``, the primitives (the flat parameter vector <->
[intr w/cam | extr 6/cam | pose 6/im | points 3/key] arrays, with the
fixed-parameter masks:
``TemplateBundlePrimitive``, ``StandardBundlePrimitive``,
``FreePointPrimitive``) and the handlers:

- ``TemplateBundleHandler``: the target-pose BA of a CameraSet, a target
  and its TargetDetection (layout, fixed parameters, the PnP seed, MAD
  outlier exclusion, the calibrated CameraSet), with
  ``estimate_camera_relative_poses`` and the helpers they call;
- ``SelfBundleHandler`` (JAX ``handlers.py:1084-1360``): target
  self-calibration, the template BA with the target points free, a
  7-coordinate gauge on three non-colinear points (or the caller's own
  pins), unseen points frozen, the warm start from a template solve
  (``set_from_templated_camset``) and the similarity alignment of the
  result onto the reference target (``apply_gauge_transform``, host numpy
  and scipy);
- ``FreePointBundleHandler`` (``:1375-1442``): the pose-free bundle
  adjustment of cameras and independently observed 3D points (a wand
  calibration's frames), seeded from the CameraSet's extrinsics.

The handlers are host state; ``optim/structured_driver.py`` builds the
device problem from them.

The ``camera_model`` option takes the JAX package's five models, for the
whole rig or per camera (a {cam_name: model} dict or a list): "standard"
(intr width 9), "rational" (12), "thin_prism" (16), "tilted" (18) and
"fisheye" (8; the 4-wide distortion vector is the fisheye marker). A rig of
Brown models of several widths runs the widest model's chain with the
narrower cameras' extra coefficients pinned to zero by a per-column
intrinsic mask (``intr_colmask``, exact sub-models); a rig mixing fisheye
with Brown cameras (het) runs the selector chain ``ProjectionHet``, rows
[sel | fx px fy py | dist slots], the selector and a fisheye camera's pad
slots never free. The calibrated cameras keep each camera's own
distortion width. The template, self-calibration and free-point handlers
run each of the five models and both kinds of map; the multi-target chains
take one model a rig. The PnP seed
(``calc_initial_params``) is OpenCV on the host, imported when it runs;
without cv2 it raises ``ImportError`` and ``set_initial_params(x0)`` seeds
the handler instead (the path a card's machine takes). Its Rodrigues
conversions go through cv2 too, so the seed is the JAX package's bit for
bit. ``rig_start`` seeds a handler with no OpenCV (the ``start="rig"``
of the recalibrations, the fixed-rig pose solve and model selection):
the stored rig's values and the port's tracker's poses, re-expressed in
the handler's gauge. The self-calibration handler seeds through PnP as the
template one does, or, on a card's machine, from a template solve
(``set_from_templated_camset``); the free-point handler needs no OpenCV.
``RSTemplateBundleHandler`` (JAX ``handlers.py:655-800``) calibrates a
rolling-shutter rig: per-image [pose | velocity] rows, a per-camera
readout, the normalised image row an aux channel of the detections
(``aux_table``). The multi-target handlers are the JAX package's examples
(``pycamset_tpu_torch/examples``); the target-shape plot
(``special_plots``) waits for the plotting layer (item 10).
"""
from __future__ import annotations

import logging
from copy import deepcopy
from itertools import combinations

import numpy as np

import pycamset_tpu_torch.utils.general_utils as gu
from pycamset_tpu_torch.models.abstract_target import (  # noqa: F401
    SEED_INSTEAD, AbstractTarget, FreePointTarget)
from pycamset_tpu_torch.models.camera_set import CameraSet
from pycamset_tpu_torch.models.detections import TargetDetection
from pycamset_tpu_torch.optim.blocks import (
    Extrinsic3D, FreePoint, Projection, ProjectionFisheye, ProjectionHet,
    ProjectionRational, ProjectionThinPrism, ProjectionTilted, RigidTform3d,
    TemplatePoints)
from pycamset_tpu_torch.optim.chain import OptimFunction
from pycamset_tpu_torch.optim.residuals import build_detection_arrays
from pycamset_tpu_torch.ops.transforms import rigid_fit

DEFAULT_OPTIONS = {
    "verbosity": 2,
    "fixed_pose": 0,
    "ref_cam": 0,
    "ref_pose": 0,
    "outliers": "ask",
    "max_nfev": 100,
    # "standard" = Brown-Conrady 5-coef (intr 9/cam); "rational" = OpenCV
    # CALIB_RATIONAL_MODEL 8-coef (intr 12/cam); "thin_prism" = rational +
    # CALIB_THIN_PRISM_MODEL 12-coef (intr 16/cam); "tilted" = +
    # CALIB_TILTED_MODEL taux/tauy 14-coef (intr 18/cam); "fisheye" =
    # cv2.fisheye Kannala-Brandt 4-coef (intr 8/cam)
    "camera_model": "standard",
}

_CAMERA_MODELS = {"standard": 9, "rational": 12, "thin_prism": 16,
                  "tilted": 18, "fisheye": 8}
# distortion widths of the Brown-family models (4 + n_dist = intr width)
_BROWN_DIST = {"standard": 5, "rational": 8, "thin_prism": 12, "tilted": 14}


def parse_camera_models(opt, cam_names):
    """Resolve the ``camera_model`` option (one name, a {cam_name: model}
    dict or a per-camera list) into per-camera models.

    :return: (models, het, base_model): the per-camera list; het, True
        where the rig mixes fisheye with Brown cameras (the
        ``ProjectionHet`` chain); base_model, the widest Brown model of a
        rig of several models (the chain's width), None for a rig of one.
    """
    if isinstance(opt, str):
        models = [opt] * len(cam_names)
    elif isinstance(opt, dict):
        by_name = {str(k): v for k, v in opt.items()}
        missing = [str(c) for c in cam_names if str(c) not in by_name]
        if missing:
            raise ValueError(
                f"camera_model map is missing cameras {missing}; give one "
                "model per camera (or a single model name for the rig)")
        models = [by_name[str(c)] for c in cam_names]
    else:
        models = [str(m) for m in opt]
        if len(models) != len(cam_names):
            raise ValueError(
                f"camera_model list has {len(models)} entries for "
                f"{len(cam_names)} cameras")
    for m in models:
        if m not in _CAMERA_MODELS:
            raise ValueError(
                f"Unknown camera_model {m!r}; expected one of "
                f"{sorted(_CAMERA_MODELS)} (per-camera 'auto' is resolved "
                "by calibrate_cameras before the handler is built)")
    brown = sorted({m for m in models if m != "fisheye"},
                   key=lambda m: _CAMERA_MODELS[m])
    if len(set(models)) == 1 or not brown:
        return models, False, None
    return models, "fisheye" in models, brown[-1]


def _het_intr_width(brown_model: str) -> int:
    """[sel | fx px fy py | dist slots] width of a heterogeneous rig."""
    return 5 + max(_BROWN_DIST[brown_model], 4)


def _het_intr_row(model: str, kvec4, dist, width: int) -> np.ndarray:
    """One camera's packed heterogeneous row (the selector in slot 0)."""
    row = np.zeros(width)
    row[0] = 1.0 if model == "fisheye" else 0.0
    row[1:5] = np.asarray(kvec4, dtype=float)
    n = 4 if model == "fisheye" else width - 5
    row[5:5 + n] = _pack_dist(dist, n)
    return row


def _het_intr_colmask(models, width: int) -> np.ndarray:
    """(C, width) bool mask of the free heterogeneous intrinsic columns:
    the selector is never free, a fisheye camera's slots past k1..k4 are
    padding, and a Brown camera narrower than the rig's widest model pins
    its extra coefficients to zero."""
    cm = np.ones((len(models), width), dtype=bool)
    cm[:, 0] = False
    for i, m in enumerate(models):
        if m == "fisheye":
            cm[i, 9:] = False
        else:
            cm[i, 5 + _BROWN_DIST[m]:] = False
    return cm


def _brown_mix_colmask(models, width: int) -> np.ndarray:
    """(C, width) bool mask of a Brown rig of several widths: each camera
    keeps its own model's coefficients free, the widest layout's extra
    columns pinned to zero (exact sub-models)."""
    cm = np.ones((len(models), width), dtype=bool)
    for i, m in enumerate(models):
        cm[i, 4 + _BROWN_DIST[m]:] = False
    return cm


def _projection_block(camera_model: str) -> Projection:
    """The projection block of a camera model."""
    blocks = {"standard": Projection, "rational": ProjectionRational,
              "thin_prism": ProjectionThinPrism, "tilted": ProjectionTilted,
              "fisheye": ProjectionFisheye}
    if camera_model not in blocks:
        raise ValueError(
            f"Unknown camera_model {camera_model!r}; expected one of "
            f"{sorted(_CAMERA_MODELS)}")
    return blocks[camera_model]()


def infer_shared_n_dist(dlists) -> int:
    """The common distortion width of a rig's cameras: 4 for an all-fisheye
    rig, else the widest Brown width (at least 5). The fisheye's 4-wide
    vectors cannot be padded into Brown slots, so a rig mixing the two
    raises ``ValueError`` (the PnP seed packs such a rig itself,
    ``estimate_camera_relative_poses``)."""
    sizes = {int(np.reshape(np.asarray(d), -1).size) for d in dlists}
    if 4 in sizes and sizes != {4}:
        raise ValueError(
            "rig mixes fisheye (4-coefficient) and Brown-family cameras; "
            f"distortion widths seen: {sorted(sizes)}. Mixed projection "
            "families are not supported on this path — calibrate the "
            "families separately or convert the models.")
    if sizes == {4}:
        return 4
    return max(5, max(sizes, default=5))


def _pack_dist(dist, n: int) -> np.ndarray:
    """Pad/truncate a distortion vector to n coefficients (OpenCV order)."""
    d = np.reshape(np.asarray(dist, dtype=float), (-1,))
    if d.size > n and np.any(d[n:] != 0):
        logging.warning(
            f"Truncating a {d.size}-coefficient distortion vector to {n} "
            "coefficients; pass options={'camera_model': 'rational' / "
            "'thin_prism' / 'tilted'} to keep the higher-order terms.")
    return np.pad(d, (0, max(0, n - d.size)))[:n]


# ----------------------------------------------------------------- primitive

class TemplateBundlePrimitive:
    """Base arrays (poses, extr, intr) + per-row unfixed masks for the
    template BA; maps the free parameter vector to and from the arrays.
    ``intr_colmask`` (C, intr_width) bool marks the intrinsic columns that
    can be free at all (a heterogeneous rig's selector and pad slots, a
    narrower Brown camera's extra coefficients are not); default all."""

    def __init__(self, poses, extr, intr, poses_unfixed=None,
                 extr_unfixed=None, intr_unfixed=None, intr_colmask=None):
        self.poses = poses
        self.extr = extr
        self.intr = intr
        self.intr_width = intr.shape[1]
        self.intr_colmask = (np.asarray(intr_colmask, dtype=bool)
                             if intr_colmask is not None
                             else np.ones(intr.shape, dtype=bool))
        self.poses_unfixed = (poses_unfixed if poses_unfixed is not None
                              else np.ones(poses.shape[0], dtype=bool))
        self.extr_unfixed = (extr_unfixed if extr_unfixed is not None
                             else np.ones(extr.shape[0], dtype=bool))
        self.intr_unfixed = (intr_unfixed if intr_unfixed is not None
                             else np.ones(intr.shape[0], dtype=bool))
        self.calc_free_poses()

    def calc_free_poses(self):
        self.free_poses = int(np.sum(self.poses_unfixed))
        self.free_extr = int(np.sum(self.extr_unfixed))
        self.free_intr = int(np.sum(self.intr_unfixed))
        self.intr_end = self.intr_width * self.free_intr
        self.extr_end = 6 * self.free_extr + self.intr_end
        self.pose_end = 6 * self.free_poses + self.extr_end

    def base_full(self) -> np.ndarray:
        """The full [intr | extr | poses] vector."""
        return np.concatenate(
            [self.intr.ravel(), self.extr.ravel(), self.poses.ravel()])

    def _intr_unfixed_flat(self) -> np.ndarray:
        return (np.repeat(self.intr_unfixed, self.intr_width)
                & self.intr_colmask.ravel())

    def unfixed_full(self) -> np.ndarray:
        """(full,) bool: the free entries of the full vector."""
        return np.concatenate([
            self._intr_unfixed_flat(),
            np.repeat(self.extr_unfixed, 6),
            np.repeat(self.poses_unfixed, 6)])

    def return_bundle_primitives(self, params):
        """Scatter a free parameter vector into the full arrays."""
        full = self.base_full()
        full[self.unfixed_full()] = params
        n_c = self.intr.shape[0]
        n_p = self.poses.shape[0]
        ie, ee = self.intr_width * n_c, (self.intr_width + 6) * n_c
        self.intr[:] = full[:ie].reshape(n_c, self.intr_width)
        self.extr[:] = full[ie:ee].reshape(n_c, 6)
        self.poses[:] = full[ee:].reshape(n_p, 6)
        return self.intr, self.extr, self.poses


class StandardBundlePrimitive(TemplateBundlePrimitive):
    """Template primitive + per-coordinate-fixable target feature points
    (JAX ``handlers.py:265-302``)."""

    def __init__(self, poses, bundle_points, extr, intr, poses_unfixed=None,
                 bundle_points_unfixed=None, extr_unfixed=None,
                 intr_unfixed=None, intr_colmask=None):
        self.bundle_pts = bundle_points  # flat (3 * n_points,)
        self.bdpt_unfixed = (bundle_points_unfixed
                             if bundle_points_unfixed is not None
                             else np.ones(bundle_points.shape[0], dtype=bool))
        super().__init__(poses, extr, intr, poses_unfixed, extr_unfixed,
                         intr_unfixed, intr_colmask=intr_colmask)

    def calc_free_poses(self):
        super().calc_free_poses()
        self.free_bdpt = int(np.sum(self.bdpt_unfixed))
        self.bdpt_end = self.free_bdpt + self.pose_end

    def base_full(self) -> np.ndarray:
        return np.concatenate([super().base_full(), self.bundle_pts.ravel()])

    def unfixed_full(self) -> np.ndarray:
        return np.concatenate([super().unfixed_full(), self.bdpt_unfixed])

    def return_bundle_primitives(self, params):
        full = self.base_full()
        full[self.unfixed_full()] = params
        n_c = self.intr.shape[0]
        n_p = self.poses.shape[0]
        ie, ee = self.intr_width * n_c, (self.intr_width + 6) * n_c
        self.intr[:] = full[:ie].reshape(n_c, self.intr_width)
        self.extr[:] = full[ie:ee].reshape(n_c, 6)
        self.poses[:] = full[ee:ee + 6 * n_p].reshape(n_p, 6)
        self.bundle_pts[:] = full[ee + 6 * n_p:]
        return (self.intr, self.extr, self.poses,
                self.bundle_pts.reshape(-1, 3))


class FreePointPrimitive(TemplateBundlePrimitive):
    """Intr + extr + free 3D points, no poses: the pose-free variant (JAX
    ``handlers.py:305-342``)."""

    def __init__(self, bundle_points, extr, intr, bundle_points_unfixed=None,
                 extr_unfixed=None, intr_unfixed=None, intr_colmask=None):
        self.bundle_pts = bundle_points
        self.bdpt_unfixed = (bundle_points_unfixed
                             if bundle_points_unfixed is not None
                             else np.ones(bundle_points.shape[0], dtype=bool))
        super().__init__(np.zeros((0, 6)), extr, intr,
                         poses_unfixed=np.zeros(0, dtype=bool),
                         extr_unfixed=extr_unfixed, intr_unfixed=intr_unfixed,
                         intr_colmask=intr_colmask)

    def calc_free_poses(self):
        super().calc_free_poses()
        self.free_bdpt = int(np.sum(self.bdpt_unfixed))
        self.bdpt_end = self.free_bdpt + self.pose_end

    def base_full(self) -> np.ndarray:
        return np.concatenate(
            [self.intr.ravel(), self.extr.ravel(), self.bundle_pts.ravel()])

    def unfixed_full(self) -> np.ndarray:
        return np.concatenate([
            self._intr_unfixed_flat(),
            np.repeat(self.extr_unfixed, 6), self.bdpt_unfixed])

    def return_bundle_primitives(self, params):
        full = self.base_full()
        full[self.unfixed_full()] = params
        n_c = self.intr.shape[0]
        ie, ee = self.intr_width * n_c, (self.intr_width + 6) * n_c
        self.intr[:] = full[:ie].reshape(n_c, self.intr_width)
        self.extr[:] = full[ie:ee].reshape(n_c, 6)
        self.bundle_pts[:] = full[ee:]
        return self.intr, self.extr, self.bundle_pts.reshape(-1, 3)


# -------------------------------------------------------------------- handler

class TemplateBundleHandler:
    """The standard target-pose bundle adjustment of a CameraSet, a target
    and its TargetDetection: parameter layout, fixed-parameter masks,
    initial estimates and the calibrated CameraSet.

    Extension hooks: ``add_extra_params`` appends extra initial parameters,
    ``parse_extra_params_and_setup`` consumes them.
    """

    def __init__(self, camset: CameraSet, target: AbstractTarget,
                 detection: TargetDetection, fixed_params: dict | None = None,
                 options: dict | None = None, missing_poses=None):
        self.problem_opts = dict(DEFAULT_OPTIONS)
        if options is not None:
            self.problem_opts.update(options)

        self.fixed_params = gu.list_dict_to_np_array(fixed_params) or {}
        self.camset = camset
        self.cam_names = camset.get_names()
        self.detection = deepcopy(detection)
        self.target = target
        self.point_data = deepcopy(target.point_data)
        self.target_point_shape = np.array(target.point_data.shape)
        self.initial_params = None

        n_poses = detection.max_ims
        n_cams = camset.get_n_cams()
        self.camera_models, self.is_het, base = parse_camera_models(
            self.problem_opts.get("camera_model", "standard"),
            self.cam_names)
        self.het_brown_model = base if self.is_het else None
        self.mixed_models = len(set(self.camera_models)) > 1
        if self.is_het:
            self.camera_model = "het"
            self.intr_width = _het_intr_width(base)
        else:
            # a Brown rig of several widths runs the widest model's chain;
            # the narrower cameras' extra columns are pinned by the colmask
            self.camera_model = base or self.camera_models[0]
            self.intr_width = _CAMERA_MODELS[self.camera_model]

        intr = np.zeros((n_cams, self.intr_width))
        if self.is_het:
            # the family selectors live in (fixed) intrinsic slot 0
            intr[:, 0] = [1.0 if m == "fisheye" else 0.0
                          for m in self.camera_models]
        extr = np.zeros((n_cams, 6))
        poses = np.zeros((n_poses, 6))
        extr_unfixed = np.array(
            ["ext" not in self.fixed_params.get(c, {}) for c in self.cam_names])
        intr_unfixed = np.array(
            ["int" not in self.fixed_params.get(c, {}) for c in self.cam_names])
        pose_unfixed = np.ones(n_poses, dtype=bool)
        # fixed_pose=None means "no gauge pose" (a None index would add an
        # axis and fix every pose)
        if self.problem_opts.get("fixed_pose") is not None:
            fixed_pose = self.problem_opts["fixed_pose"]
            pose_unfixed[fixed_pose] = False
            poses[fixed_pose, :] = 0.0
        intr_colmask = None
        if self.is_het:
            intr_colmask = _het_intr_colmask(self.camera_models,
                                             self.intr_width)
        elif self.mixed_models:
            intr_colmask = _brown_mix_colmask(self.camera_models,
                                              self.intr_width)
        self.bundlePrimitive = TemplateBundlePrimitive(
            poses, extr, intr, extr_unfixed=extr_unfixed,
            intr_unfixed=intr_unfixed, poses_unfixed=pose_unfixed,
            intr_colmask=intr_colmask)
        self.populate_self_from_fixed_params()

        self.missing_poses = missing_poses
        self.op_fun = OptimFunction(
            [self._proj_block(), Extrinsic3D(), TemplatePoints()])

    def _proj_block(self) -> Projection:
        """The rig's projection block (the family selector for a het
        rig)."""
        if self.is_het:
            return ProjectionHet(self.het_brown_model)
        return _projection_block(self.camera_model)

    def populate_self_from_fixed_params(self):
        """Copy any fixed extrinsic/intrinsic values into the base arrays."""
        for idx, cam_name in enumerate(self.cam_names):
            fixed = self.fixed_params.get(cam_name, {})
            if "ext" in fixed:
                ext = np.asarray(fixed["ext"], dtype=float)
                if ext.shape == (4, 4):
                    rvec, tvec = gu.ext_4x4_to_rod(ext)
                    ext = np.concatenate([rvec, tvec])
                self.bundlePrimitive.extr[idx] = ext
            if "int" in fixed:
                intr = np.asarray(fixed["int"], dtype=float)
                if self.is_het:
                    if intr.shape != (3, 3):
                        raise ValueError(
                            "heterogeneous rigs take fixed intrinsics as a "
                            "(3,3) matrix (+ optional 'dst'), not a packed "
                            "vector — the packed layout is family-specific")
                    self.bundlePrimitive.intr[idx] = _het_intr_row(
                        self.camera_models[idx],
                        intr[[0, 0, 1, 1], [0, 2, 1, 2]],
                        fixed.get("dst", np.zeros(4)), self.intr_width)
                    continue
                n_dist = self.bundlePrimitive.intr_width - 4
                if intr.shape == (3, 3):
                    # stored as the packed vector; distortion stays zero
                    # unless 'dst' is also fixed
                    dst = _pack_dist(fixed.get("dst", np.zeros(n_dist)),
                                     n_dist)
                    intr = np.concatenate(
                        [intr[[0, 0, 1, 1], [0, 2, 1, 2]], dst])
                self.bundlePrimitive.intr[idx] = _pack_dist(intr, n_dist + 4)

    def n_keys(self) -> int:
        return int(np.prod(self.target_point_shape[:-1]))

    def template_table(self):
        """The constant target-geometry lookup table."""
        return self.point_data.reshape(-1, 3)

    def n_groups(self) -> int:
        """Count of PER_GROUP parameter blocks (multi-target extensions,
        ``examples/extend_param_handler.py``)."""
        return 0

    def group_of_key(self):
        """key -> PER_GROUP index mapping, or None when the chain has
        none."""
        return None

    def can_make_jac(self) -> bool:
        return self.op_fun.can_make_jac()

    def build_problem(self, pad_multiple: int = 512):
        """(ParamStruct, DetectionArrays) of the generic backend
        (``optim/residuals.py``)."""
        struct = self.op_fun.param_struct(
            len(self.cam_names), self.bundlePrimitive.poses.shape[0],
            self.n_keys(), n_groups=self.n_groups())
        dd = self.get_detection_data(flatten=True)
        det = build_detection_arrays(self.op_fun, struct, dd,
                                     self.template_table(),
                                     pad_multiple=pad_multiple,
                                     group_of_key=self.group_of_key())
        return struct, det

    # ------------------------------------------------- initial parametrisation

    def add_extra_params(self, param_array: np.ndarray) -> np.ndarray:
        """Extension hook: append extra initial parameter estimates."""
        return param_array

    def parse_extra_params_and_setup(self, param_array: np.ndarray
                                     ) -> np.ndarray:
        """Extension hook: consume extra parameters, mutate handler state."""
        return param_array

    def set_initial_params(self, x: np.ndarray):
        """Seed the solve with the free parameter vector x (no PnP, no
        cv2)."""
        self.initial_params = x

    def get_initial_params(self) -> np.ndarray:
        if self.initial_params is not None:
            return self.initial_params
        # cached: the PnP sweep and its outlier prompt run once
        self.initial_params = self.calc_initial_params()
        return self.initial_params

    def calc_initial_params(self) -> np.ndarray:
        """Seed the solve: intrinsics from the CameraSet, extrinsics and
        target poses from PnP-based relative pose estimation (OpenCV, on
        the host)."""
        cv2 = gu.require_cv2("The PnP seed (calc_initial_params)",
                             SEED_INSTEAD)
        cams = self.camset
        (cam_poses, target_poses, per_im_error,
         pose_found) = estimate_camera_relative_poses(
            detection=self.detection, cams=self.camset,
            calibration_target=self.target,
            ref_cam=self.problem_opts.get("ref_cam", 0),
            ref_pose=self.problem_opts.get("ref_pose", 0))

        # an image where no camera found a target pose has no seed: its
        # detections leave the optimisation
        self.missing_poses = ~pose_found
        self.find_and_exclude_transform_outliers(per_im_error)

        prim = self.bundlePrimitive
        for idc in range(len(self.cam_names)):
            if prim.intr_unfixed[idc]:
                prim.intr[idc] = self._intr_seed_row(idc, cams[idc])
            if prim.extr_unfixed[idc]:
                rvec, tvec = gu.cv2_rod(cv2, cam_poses[idc])
                prim.extr[idc] = np.concatenate([rvec, tvec])
        for idp in range(prim.poses.shape[0]):
            if prim.poses_unfixed[idp]:
                pose = target_poses[idp]
                if np.any(np.isnan(pose)):
                    pose = np.eye(4)
                rvec, tvec = gu.cv2_rod(cv2, pose)
                prim.poses[idp, :6] = np.concatenate([rvec, tvec])

        params = prim.base_full()[prim.unfixed_full()]
        return self.add_extra_params(params)

    def _intr_seed_row(self, idc: int, cam) -> np.ndarray:
        """A camera's packed intrinsic seed row [fx px fy py | dist], or
        its heterogeneous row [sel | fx px fy py | dist slots]."""
        kvec = cam.intrinsic[[0, 0, 1, 1], [0, 2, 1, 2]]
        if self.is_het:
            return _het_intr_row(self.camera_models[idc], kvec,
                                 cam.distortion_coefs, self.intr_width)
        return np.concatenate([
            kvec, _pack_dist(cam.distortion_coefs, self.intr_width - 4)])

    def find_and_exclude_transform_outliers(self, per_im_error):
        """MAD-outlier poses are marked missing ('ask' prompts, 'y' drops
        them, 'n' keeps them)."""
        if self.missing_poses is None:
            raise ValueError(
                "missing poses should be initialised before calling this "
                "function")
        self.missing_poses = np.asarray(self.missing_poses, dtype=bool)
        logging.info("Beginning outlier detection")
        choice = self.problem_opts["outliers"]
        for sweep in range(10):
            live = np.flatnonzero(~self.missing_poses)
            flagged = gu.mad_outlier_detection(per_im_error[live],
                                               out_thresh=20)
            if flagged is None:
                logging.info(f"No outliers detected in iteration {sweep}.")
                break
            while choice not in ("y", "n"):
                print(f"Outliers detected in iteration {sweep}.")
                choice = input(
                    "Drop these outlier poses from the problem? [y/n]: ")
            if choice != "y":
                break
            self.missing_poses[live[flagged]] = True

    # ------------------------------------------------------------ extraction

    def get_bundle_adjustment_inputs(self, x, make_points: bool = False):
        """Free params -> (intr, extr, poses) arrays, or the per-image
        world-space target points when make_points=True."""
        proj, extr, poses = self.bundlePrimitive.return_bundle_primitives(x)
        if make_points:
            im_points = np.empty((len(poses), *self.point_data.shape))
            for idx, pose in enumerate(poses):
                t = gu.make_4x4h_tform(pose[:3], pose[3:])
                im_points[idx] = gu.h_tform(
                    self.point_data.reshape(-1, 3), t).reshape(
                        self.point_data.shape)
            return np.reshape(im_points, (len(poses), -1, 3))
        return proj, extr, poses

    def get_camset(self, x, return_pose: bool = False):
        """Free parameter vector -> calibrated CameraSet (+ target poses)."""
        new_cams = _clone_camset(self.camset)
        proj, extr, poses = self.bundlePrimitive.return_bundle_primitives(x)
        _write_cams(new_cams, self.cam_names, proj, extr,
                    camera_models=self.camera_models, het=self.is_het)
        if not return_pose:
            return new_cams
        # flat-12 (R | t) per pose
        ps = np.array([gu.make_4x4h_tform(p[:3], p[3:])[:3, :4].reshape(-1)
                       for p in poses])
        return new_cams, ps

    def get_detection(self) -> TargetDetection:
        return TargetDetection(cam_names=self.cam_names,
                               data=self.get_detection_data())

    def get_detection_data(self, flatten: bool = False) -> np.ndarray:
        """The detection table of the optimisation (missing-pose rows
        removed; optionally with flattened keys)."""
        dims = self.target_point_shape[:-1]
        detection = self.detection
        if self.missing_poses is not None and np.any(self.missing_poses):
            logging.info("Missing poses required removing detected data "
                         "from the optimisation")
            missing = np.where(np.asarray(self.missing_poses))[0]
            detection = self.detection.delete_row(im_num=missing)
        if flatten:
            return detection.return_flattened_keys(dims).get_data()
        return detection.get_data()


# ------------------------------------------------------------ rolling shutter

class RSBundlePrimitive(TemplateBundlePrimitive):
    """Template primitive of a ROLLING-SHUTTER rig: 12-wide per-image rows
    [pose6 | velocity6] and a per-camera readout parameter. The full
    vector follows the RS chain's group order (Projection, Extrinsic3D,
    RSPoseVel, RSTemplateTime): [intr | extr | posevel 12/im | readout
    1/cam]. ``pose_colmask`` (I, 12) marks the pose columns that can be
    free (the gauge image pins its 6 pose columns, not its velocity)."""

    def __init__(self, poses, extr, intr, readout, poses_unfixed=None,
                 extr_unfixed=None, intr_unfixed=None,
                 readout_unfixed=None, intr_colmask=None,
                 pose_colmask=None):
        self.readout = readout                      # (C, 1)
        self.readout_unfixed = (
            readout_unfixed if readout_unfixed is not None
            else np.ones(readout.shape[0], dtype=bool))
        self.pose_colmask = (np.asarray(pose_colmask, dtype=bool)
                             if pose_colmask is not None
                             else np.ones(poses.shape, dtype=bool))
        super().__init__(poses, extr, intr, poses_unfixed, extr_unfixed,
                         intr_unfixed, intr_colmask=intr_colmask)

    def base_full(self) -> np.ndarray:
        return np.concatenate(
            [self.intr.ravel(), self.extr.ravel(), self.poses.ravel(),
             self.readout.ravel()])

    def unfixed_full(self) -> np.ndarray:
        return np.concatenate([
            self._intr_unfixed_flat(),
            np.repeat(self.extr_unfixed, 6),
            np.repeat(self.poses_unfixed, 12) & self.pose_colmask.ravel(),
            self.readout_unfixed])

    def return_bundle_primitives(self, params):
        full = self.base_full()
        full[self.unfixed_full()] = params
        n_c = self.intr.shape[0]
        n_p = self.poses.shape[0]
        ie, ee = self.intr_width * n_c, (self.intr_width + 6) * n_c
        pe = ee + 12 * n_p
        self.intr[:] = full[:ie].reshape(n_c, self.intr_width)
        self.extr[:] = full[ie:ee].reshape(n_c, 6)
        self.poses[:] = full[ee:pe].reshape(n_p, 12)
        self.readout[:] = full[pe:].reshape(n_c, 1)
        return self.intr, self.extr, self.poses, self.readout


class RSTemplateBundleHandler(TemplateBundleHandler):
    """Rolling-shutter template calibration (JAX ``handlers.py:702-800``):
    the target-pose BA with a constant-velocity within-frame motion model.
    Each image has 12 parameters [pose | velocity], each camera a readout
    duration, and a detection on row v reprojects through the pose sampled
    at ``tau = readout * (v/H - 1/2)``.

    Within one capture only the products ``readout_c * velocity_i`` are
    observable, so the reference camera's (``ref_cam``) readout is pinned
    to ``options["rolling_shutter"]`` (True pins 1.0: the other readouts
    then come out relative to it). The gauge image (``fixed_pose``) pins
    its 6 pose columns; its velocity stays free. A static capture leaves
    the velocity and readout block unobservable (damping holds it at the
    seed).

    It runs on the structured backend's forward-mode route
    (``structured.make_block_grams``): the generic and scipy backends, the
    fleet and the uncertainty refuse the chain, as the JAX package's do."""

    def __init__(self, camset, target, detection, fixed_params=None,
                 options=None, missing_poses=None):
        from pycamset_tpu_torch.optim.blocks import RSPoseVel, RSTemplateTime
        super().__init__(camset, target, detection, fixed_params, options,
                         missing_poses)
        rs_opt = self.problem_opts.get("rolling_shutter", True)
        self.ref_readout = 1.0 if rs_opt is True else float(rs_opt)
        sup = self.bundlePrimitive
        n_cams = sup.intr.shape[0]
        n_poses = sup.poses.shape[0]
        poses12 = np.zeros((n_poses, 12))
        poses12[:, :6] = sup.poses
        readout = np.full((n_cams, 1), self.ref_readout)
        readout_unfixed = np.ones(n_cams, dtype=bool)
        readout_unfixed[int(self.problem_opts.get("ref_cam", 0))] = False
        # the gauge image pins only its POSE columns; its velocity is free
        poses_unfixed = sup.poses_unfixed.copy()
        pose_colmask = np.ones((n_poses, 12), dtype=bool)
        if self.problem_opts.get("fixed_pose") is not None:
            fp = int(self.problem_opts["fixed_pose"])
            poses_unfixed[fp] = True
            pose_colmask[fp, :6] = False
        self.bundlePrimitive = RSBundlePrimitive(
            poses12, sup.extr, sup.intr, readout,
            poses_unfixed=poses_unfixed, extr_unfixed=sup.extr_unfixed,
            intr_unfixed=sup.intr_unfixed,
            readout_unfixed=readout_unfixed,
            intr_colmask=sup.intr_colmask, pose_colmask=pose_colmask)
        # per-camera image heights for the normalised-row aux channel
        self._heights = np.array(
            [float(np.asarray(camset[n].res).reshape(-1)[1])
             for n in self.cam_names])
        self.op_fun = OptimFunction(
            [self._proj_block(), Extrinsic3D(), RSPoseVel(),
             RSTemplateTime()])

    def aux_table(self, dd: np.ndarray) -> np.ndarray:
        """(N, 1) normalised-row channel v/H - 1/2 of the RS chain."""
        cam = dd[:, 0].astype(int)
        v = dd[:, -1]
        return (v / self._heights[cam] - 0.5)[:, None]

    def get_bundle_adjustment_inputs(self, x, make_points: bool = False):
        proj, extr, poses12, _readout = (
            self.bundlePrimitive.return_bundle_primitives(x))
        if make_points:
            im_points = np.empty((len(poses12), *self.point_data.shape))
            for idx, pose in enumerate(poses12):
                t = gu.make_4x4h_tform(pose[:3], pose[3:6])
                im_points[idx] = gu.h_tform(
                    self.point_data.reshape(-1, 3),
                    t).reshape(self.point_data.shape)
            return np.reshape(im_points, (len(poses12), -1, 3))
        return proj, extr, poses12

    def get_camset(self, x, return_pose: bool = False):
        new_cams = _clone_camset(self.camset)
        proj, extr, poses12, _ro = (
            self.bundlePrimitive.return_bundle_primitives(x))
        _write_cams(new_cams, self.cam_names, proj, extr,
                    camera_models=self.camera_models, het=self.is_het)
        if not return_pose:
            return new_cams
        ps = np.array([gu.make_4x4h_tform(p[:3], p[3:6])[:3, :4].reshape(-1)
                       for p in poses12])
        return new_cams, ps

    def get_readouts(self, x) -> dict:
        """Per-camera readout estimates (frame units relative to the pinned
        reference readout)."""
        _p, _e, _ps, readout = (
            self.bundlePrimitive.return_bundle_primitives(x))
        return {str(n): float(r) for n, r in
                zip(self.cam_names, readout.ravel())}

    def get_velocities(self, x) -> np.ndarray:
        """(I, 6) within-frame target velocities (per reference-readout
        frame units)."""
        _p, _e, poses12, _r = (
            self.bundlePrimitive.return_bundle_primitives(x))
        return poses12[:, 6:].copy()


# ------------------------------------------------------------------ self-cal

def find_not_colinear_pts(points: np.ndarray):
    """Indices of 3 non-colinear points (for gauge fixing): point 0 and the
    first pair (in ``combinations`` order) that spans a triangle."""
    ind0 = 0
    for ind1, ind2 in combinations(np.arange(1, points.shape[0]), 2):
        ab = points[ind0] - points[ind1]
        ac = points[ind0] - points[ind2]
        if np.linalg.norm(np.cross(ab, ac)) > 1e-8:
            return ind0, ind1, ind2
    raise ValueError(
        "No set of values that were not colinear were found in the provided "
        "data.")


class SelfBundleHandler(TemplateBundleHandler):
    """Target self-calibration: the template BA plus per-point target
    geometry parameters, with a 7-coordinate gauge fix and unseen-feature
    freezing; results are similarity-aligned back onto the reference model.

    ``bundle_points_unfixed`` lets the caller pin their own coordinates
    (e.g. a known sub-structure); the automatic 7-coordinate gauge fix is
    then skipped and, unless ``always_correct_gauge=True``, so is the
    post-hoc similarity alignment, since the user's pins define the frame.
    """

    def __init__(self, camset, target, detection, fixed_params=None,
                 options=None, missing_poses=None,
                 bundle_points_unfixed=None, always_correct_gauge=False):
        super().__init__(camset, target, detection, fixed_params, options,
                         missing_poses)
        self.flat_point_data = np.copy(self.point_data.reshape(-1))

        if bundle_points_unfixed is not None:
            self.feat_unfixed = np.array(bundle_points_unfixed, dtype=bool)
            if self.feat_unfixed.shape != self.flat_point_data.shape:
                raise ValueError(
                    "bundle_points_unfixed must be a flat per-coordinate "
                    f"mask of shape {self.flat_point_data.shape}")
            n_pinned = int(self.feat_unfixed.size - self.feat_unfixed.sum())
            if n_pinned == 0:
                raise ValueError(
                    "bundle_points_unfixed fixes nothing: the self "
                    "calibration needs >= 7 pinned coordinates to break "
                    "the gauge symmetry")
            if n_pinned < 7:
                logging.warning(
                    f"Only {n_pinned} coordinates pinned; the 7-dof "
                    "similarity gauge is under-constrained and the solve "
                    "may wander.")
            self.fixed_inds = None
            self.correct_gauge = bool(always_correct_gauge)
            logging.info(
                "Custom unfixed bundle points given; the optimisation will "
                + ("still" if self.correct_gauge else "not")
                + " similarity-align the result onto the reference model.")
        else:
            # gauge: 3 + 3 + 1 coordinates of 3 non-colinear points. The
            # seventh must constrain the rotation about the p0-p1 axis,
            # under which p2 moves along v = axis x (p2 - p0): pin p2's
            # coordinate where |v| is largest (for a planar z = 0 target,
            # its z)
            pts3 = self.flat_point_data.reshape(-1, 3)
            self.fixed_inds = find_not_colinear_pts(pts3)
            i0, i1, i2 = self.fixed_inds
            axis = pts3[i1] - pts3[i0]
            v = np.cross(axis / np.linalg.norm(axis), pts3[i2] - pts3[i0])
            j2 = int(np.argmax(np.abs(v)))
            self.feat_unfixed = np.ones(self.flat_point_data.shape[0],
                                        dtype=bool)
            self.feat_unfixed[3 * i0: 3 * i0 + 3] = False
            self.feat_unfixed[3 * i1: 3 * i1 + 3] = False
            self.feat_unfixed[3 * i2 + j2] = False
            self.correct_gauge = True

        # freeze features never observed
        n_points = self.n_keys()
        dd = self.detection.return_flattened_keys(
            self.target.point_data.shape[:-1]).get_data()[:, 2]
        self.visible_feature_mask = np.isin(np.arange(n_points), dd)
        for idf, vis in enumerate(self.visible_feature_mask):
            if not vis:
                self.feat_unfixed[3 * idf: 3 * idf + 3] = False

        sup = self.bundlePrimitive
        self.bundlePrimitive = StandardBundlePrimitive(
            sup.poses, self.flat_point_data, sup.extr, sup.intr,
            extr_unfixed=sup.extr_unfixed, intr_unfixed=sup.intr_unfixed,
            poses_unfixed=sup.poses_unfixed,
            bundle_points_unfixed=self.feat_unfixed,
            intr_colmask=sup.intr_colmask)

        self.missing_poses = missing_poses
        self.op_fun = OptimFunction(
            [self._proj_block(), Extrinsic3D(), RigidTform3d(), FreePoint()])

    def template_table(self):
        return None  # the geometry is optimised, not a constant table

    def get_initial_params(self) -> np.ndarray:
        if self.initial_params is not None:
            return self.initial_params
        # the self-cal primitive already carries the free bundle points
        # (seeded from the reference geometry at construction)
        self.initial_params = self.calc_initial_params()
        return self.initial_params

    def set_from_templated_camset(self, prev_cams: CameraSet):
        """Warm start from a completed template calibration: its parameters
        and the reference points' free coordinates."""
        if not isinstance(prev_cams.calibration_handler,
                          TemplateBundleHandler):
            raise ValueError(
                "Previous camera set was not a templated adjustment")
        self.missing_poses = prev_cams.calibration_handler.missing_poses
        self.initial_params = np.concatenate([
            np.asarray(prev_cams.calibration_params, dtype=float).copy(),
            prev_cams.calibration_handler.target.point_data
            .copy().flatten()[self.feat_unfixed]])

    def get_bundle_adjustment_inputs(self, x, make_points: bool = False):
        proj, extr, poses, bundle_points = (
            self.bundlePrimitive.return_bundle_primitives(x))
        if make_points:
            im_points = np.empty((len(poses), *self.point_data.shape))
            for idx, pose in enumerate(poses):
                t = gu.make_4x4h_tform(pose[:3], pose[3:])
                im_points[idx] = gu.h_tform(
                    bundle_points, t).reshape(self.point_data.shape)
            return np.reshape(im_points, (len(poses), -1, 3))
        return proj, extr, poses, bundle_points

    def get_updated_target(self, x):
        """The recovered (gauge-aligned) target geometry."""
        model = self.bundlePrimitive.return_bundle_primitives(x)
        if not self.correct_gauge:
            return model[3]
        _, _, _, ps = self.apply_gauge_transform(*model)
        return ps

    def get_camset(self, x, return_pose: bool = False):
        new_cams = _clone_camset(self.camset)
        model = self.bundlePrimitive.return_bundle_primitives(x)
        if self.correct_gauge:
            proj, extr, poses, _ = self.apply_gauge_transform(*model)
        else:
            proj, extr, poses, _ = model
        _write_cams(new_cams, self.cam_names, proj, extr,
                    camera_models=self.camera_models, het=self.is_het)
        if not return_pose:
            return new_cams
        flat = np.array([gu.make_4x4h_tform(p[:3], p[3:])[:3, :4].reshape(-1)
                         for p in poses])
        return new_cams, flat

    def apply_gauge_transform(self, proj, extr, poses, point_estimate):
        """Similarity-align the recovered model onto the reference target.

        Rescales by the mean valid nearest-neighbour distance ratio, or,
        when the ``scale_bars`` option gives measured point-pair distances
        ``[(i, j, metres), ...]``, by the least-squares metric scale those
        define; then rigid-fits the recovered points onto the reference
        model and carries scale and transform into the poses and
        extrinsics (the projections are unchanged). Host numpy and scipy.
        """
        from scipy.spatial.distance import cdist
        ref_points = self.target.point_data.reshape((-1, 3))
        valid_map = self.target.valid_map
        vm = self.visible_feature_mask

        bars = self.problem_opts.get("scale_bars")
        if bars:
            # measured distances between target points: scale is a pure
            # gauge freedom, so the least-squares rescale after the solve
            # equals constraining the distances inside it
            bi = np.array([b[0] for b in bars], dtype=int)
            bj = np.array([b[1] for b in bars], dtype=int)
            bd = np.array([b[2] for b in bars], dtype=float)
            if np.any(bd <= 0):
                raise ValueError("scale_bars distances must be positive")
            if np.any(bi == bj):
                raise ValueError("scale_bars endpoints must be distinct "
                                 "point indices")
            unseen = ~(vm[bi] & vm[bj])
            if np.any(unseen):
                logging.warning(
                    f"{int(unseen.sum())} scale bar(s) touch target points "
                    "that were never observed (frozen at the reference "
                    "geometry): their estimated lengths carry the OLD "
                    "scale and will bias the metric anchor.")
            est = np.linalg.norm(point_estimate[bi] - point_estimate[bj],
                                 axis=1)
            s = float(np.dot(bd, est) / np.dot(est, est))
            new_map = ref_map = None
        elif isinstance(valid_map, (bool, np.bool_)):
            if not valid_map:
                raise ValueError(
                    "Target has given a valid map of False, which indicates "
                    "no distance comparisons are valid.")
            inds = np.triu_indices(int(np.sum(vm)), k=1)
            new_map = cdist(point_estimate[vm], point_estimate[vm])[inds]
            ref_map = cdist(ref_points[vm], ref_points[vm])[inds]
            # anchor on the grid pitch: the pairs within 1e-3 of the least
            # positive reference distance
            pos = ref_map[ref_map > 0]
            if pos.size:
                sel = (ref_map > 0) & (ref_map <= pos.min() * (1.0 + 1e-3))
                new_map, ref_map = new_map[sel], ref_map[sel]
        elif isinstance(valid_map, np.ndarray):
            pairs = valid_map[:, :2].astype(int)
            new_map = np.linalg.norm(
                point_estimate[pairs[:, 0]] - point_estimate[pairs[:, 1]],
                axis=1)
            ref_map = np.linalg.norm(
                ref_points[pairs[:, 0]] - ref_points[pairs[:, 1]], axis=1)
        else:
            raise ValueError(
                "target.valid_map must be True (every point pair is "
                "comparable) or an (n, 2) array of comparable index pairs.")

        if not bars:
            with np.errstate(invalid="ignore", divide="ignore"):
                s = np.mean(ref_map / new_map) if new_map.size else np.nan
        if not np.isfinite(s) or s <= 0:
            logging.critical(
                "Could not anchor the model scale (no finite positive "
                "comparable distances); leaving the recovered scale "
                "unchanged")
            s = 1.0
        new_points = s * point_estimate

        try:
            rmat, tvec = rigid_fit(new_points[vm], ref_points[vm])
            update_tform = np.eye(4)
            update_tform[:3, :3] = rmat
            update_tform[:3, 3] = tvec
        except Exception as e:
            logging.critical(
                "Gauge alignment onto the reference model failed; keeping "
                "the identity transform")
            logging.critical(f"Gave error: {e}")
            update_tform = np.eye(4)

        undo = np.linalg.inv(update_tform)
        new_points = gu.h_tform(new_points, update_tform)

        def as_rod6(mat4):
            return np.concatenate(gu.ext_4x4_to_rod(mat4))

        # conjugating each pose keeps projections invariant while the world
        # frame (points + scale) moves onto the reference model; extrinsics
        # only absorb the inverse on the right
        for i, rod6 in enumerate(poses):
            scaled = gu.make_4x4h_tform(rod6[:3], s * rod6[3:])
            poses[i] = as_rod6(update_tform @ scaled @ undo)
        for i, rod6 in enumerate(extr):
            scaled = gu.make_4x4h_tform(rod6[:3], s * rod6[3:])
            extr[i] = as_rod6(scaled @ undo)
        return proj, extr, poses, new_points


# ---------------------------------------------------------------- free-point

class FreePointBundleHandler(TemplateBundleHandler):
    """Pose-free bundle adjustment: the camera parameters and the 3D
    positions of independently observed points (structure from motion; a
    wand calibration's frames). The start is the CameraSet's intrinsics and
    extrinsics and the target's points (no PnP, no OpenCV)."""

    def __init__(self, camset, target, detection, fixed_params=None,
                 options=None, missing_poses=None):
        super().__init__(camset, target, detection, fixed_params, options,
                         missing_poses)
        self.flat_point_data = np.copy(self.point_data.reshape(-1))
        self.feat_unfixed = np.ones(self.flat_point_data.shape[0], dtype=bool)
        self.super_primitive = self.bundlePrimitive
        self.bundlePrimitive = FreePointPrimitive(
            self.flat_point_data, self.super_primitive.extr,
            self.super_primitive.intr,
            extr_unfixed=self.super_primitive.extr_unfixed,
            intr_unfixed=self.super_primitive.intr_unfixed,
            bundle_points_unfixed=self.feat_unfixed,
            intr_colmask=self.super_primitive.intr_colmask)
        self.missing_poses = missing_poses
        self.op_fun = OptimFunction(
            [self._proj_block(), Extrinsic3D(), FreePoint()])

    def template_table(self):
        return None

    def build_problem(self, pad_multiple: int = 512):
        struct = self.op_fun.param_struct(
            len(self.cam_names), 0, self.n_keys())
        dd = self.get_detection_data(flatten=True)
        det = build_detection_arrays(self.op_fun, struct, dd, None,
                                     pad_multiple=pad_multiple)
        return struct, det

    def get_initial_params(self) -> np.ndarray:
        if self.initial_params is not None:
            return self.initial_params
        prim = self.bundlePrimitive
        for idc in range(len(self.cam_names)):
            if prim.intr_unfixed[idc]:
                prim.intr[idc] = self._intr_seed_row(idc, self.camset[idc])
            if prim.extr_unfixed[idc]:
                rvec, tvec = gu.ext_4x4_to_rod(self.camset[idc].extrinsic)
                prim.extr[idc] = np.concatenate([rvec, tvec])
        prim.bundle_pts[:] = self.point_data.reshape(-1)
        self.initial_params = prim.base_full()[prim.unfixed_full()]
        return self.initial_params

    def set_from_camset(self, prev_cams: CameraSet, init_points: np.ndarray):
        """Warm start the cameras from a previous solve + initial points."""
        self.initial_params = np.concatenate([
            np.asarray(prev_cams.calibration_params, dtype=float).copy(),
            np.asarray(init_points, dtype=float).flatten()])

    def get_bundle_adjustment_inputs(self, x, make_points: bool = False):
        return self.bundlePrimitive.return_bundle_primitives(x)

    def get_camset(self, x, return_pose: bool = False):
        new_cams = _clone_camset(self.camset)
        proj, extr, ps = self.bundlePrimitive.return_bundle_primitives(x)
        _write_cams(new_cams, self.cam_names, proj, extr,
                    camera_models=self.camera_models, het=self.is_het)
        if return_pose:
            return new_cams, ps
        return new_cams

    def get_updated_points(self, x):
        _, _, ps = self.bundlePrimitive.return_bundle_primitives(x)
        return ps


def _clone_camset(camset: CameraSet) -> CameraSet:
    """A fresh CameraSet of deep-copied Cameras (no calibration history)."""
    return CameraSet(camera_dict={
        name: deepcopy(camset[name]) for name in camset.get_names()})


def _write_cams(new_cams, cam_names, proj, extr, camera_models=None,
                het: bool = False):
    """Write packed intrinsic rows and extrinsics back into the Camera
    objects. ``het`` marks the selector layout [sel | fx px fy py | dist
    slots]; ``camera_models`` cuts each camera's distortion to its own
    model's width (4 fisheye, 5 / 8 / 12 / 14 Brown), so a camera of a
    mixed rig keeps its own model."""
    for idc, cam_name in enumerate(cam_names):
        row = np.asarray(proj[idc], dtype=float)
        off = 1 if het else 0
        kvec = row[off:off + 4]
        dist = row[off + 4:]
        if camera_models is not None:
            m = camera_models[idc]
            dist = dist[:4] if m == "fisheye" else dist[:_BROWN_DIST[m]]
        intr = np.eye(3)
        intr[0, 0], intr[0, 2], intr[1, 1], intr[1, 2] = kvec
        cam = new_cams[cam_name]
        cam.extrinsic = gu.make_4x4h_tform(extr[idc][:3], extr[idc][3:])
        cam.intrinsic = intr
        cam.distortion_coefs = np.array(dist)
        cam._update_state()


# -------------------------------------------------------- initial estimation

def check_for_target_misalignment(tforms: np.ndarray, ref_cam: int = 0):
    """Warn when relative cam-to-reference transforms vary across images (a
    sign of misordered or desynchronised captures); nan poses (failed PnP)
    drop out of the nan-aware statistics."""
    nan4 = np.full((4, 4), np.nan)
    inv_ref = [np.linalg.inv(p) if np.all(np.isfinite(p)) else nan4
               for p in tforms[ref_cam]]
    rel = np.array([[t_c @ r_t for r_t, t_c in zip(inv_ref, cam_t)]
                    for cam_t in tforms])
    for ic, rel_c in enumerate(rel):
        if ic == ref_cam:
            continue
        angs = np.array([np.arccos(np.clip((np.trace(t[:3, :3]) - 1) / 2,
                                           -1, 1)) for t in rel_c])
        mags = [np.linalg.norm(t[:3, -1]) for t in rel_c]
        std_ang, std_mag = np.nanstd(angs), np.nanstd(mags)
        if std_mag > 0.050:
            logging.critical(
                f"Found inconsistent relative translation positions "
                f"(stdev = {std_mag:.2f} m) for camera index {ic}")
            logging.warning(
                "This may indicate misordered images, temporal misalignment, "
                "or very bad detections, and is likely to cause calibration "
                "difficulties.")
        if std_ang > 5 / 180 * np.pi:
            logging.critical(
                f"Found inconsistent relative angle magnitudes "
                f"(stdev = {std_ang / np.pi * 180:.2f} degrees) for camera "
                f"index {ic}")


def check_feasiblity_and_update_refpose(mat_ac: np.ndarray,
                                        ref_pose: int) -> int:
    """Pick a reference image in which every camera found a pose."""
    visible_pose = ~np.any(np.isnan(mat_ac[:, :, 0, 0]), axis=0)
    if not visible_pose[ref_pose]:
        f_index = int(np.argmax(visible_pose))
        if not visible_pose[f_index]:
            raise ValueError("Couldn't find an initial pose for all cameras.")
        ref_pose = f_index
    return ref_pose


def reprojection_costs(dd: np.ndarray, imlocs: np.ndarray, proj: np.ndarray,
                       ints: np.ndarray, dists: np.ndarray,
                       fisheye_mask=None) -> np.ndarray:
    """Per-detection reprojection residuals (host numpy): P·X, divide,
    distort, subtract the measured uv.

    :param dd: flattened detection table [cam, im, key, u, v].
    :param imlocs: (n_ims, n_keys, 3) world-space target points per image.
    :param proj: (C, 3, 4); :param ints: (C, 3, 3); :param dists: (C, n),
        n = 4 (fisheye: the whole rig Kannala-Brandt) or 5 / 8 / 12 / 14
        (the Brown family: rational radial, prism terms, sensor tilt).
    :param fisheye_mask: optional (C,) bool, a heterogeneous rig: the
        marked cameras project through Kannala-Brandt (k1..k4 in the first
        four slots), the others through the Brown model of the width.
    :return: (N, 2) residuals.
    """
    cam = dd[:, 0].astype(int)
    im = dd[:, 1].astype(int)
    key = dd[:, 2].astype(int)
    pts = imlocs[im, key]
    p = proj[cam]
    xyw = np.einsum("nij,nj->ni", p[:, :, :3], pts) + p[:, :, 3]
    uv = xyw[:, :2] / xyw[:, 2:3]
    f = np.stack([ints[cam, 0, 0], ints[cam, 1, 1]], axis=1)
    c = np.stack([ints[cam, 0, 2], ints[cam, 1, 2]], axis=1)
    xy = (uv - c) / f
    x, y = xy[:, 0], xy[:, 1]
    pred_fish = None
    if dists.shape[1] == 4 or fisheye_mask is not None:
        r = np.sqrt(x * x + y * y + 1e-18)
        theta = np.arctan(r)
        t2 = theta * theta
        kf = [dists[cam, i] for i in range(4)]
        theta_d = theta * (1 + t2 * (kf[0] + t2 * (kf[1]
                                                   + t2 * (kf[2]
                                                           + t2 * kf[3]))))
        pred_fish = xy * (theta_d / r)[:, None] * f + c
        if dists.shape[1] == 4:
            return pred_fish - dd[:, 3:5]
    k1, k2, p1, p2, k3 = (dists[cam, i] for i in range(5))
    r2 = x * x + y * y
    radial = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
    if dists.shape[1] >= 8:
        k4, k5, k6 = (dists[cam, i] for i in range(5, 8))
        radial = radial / (1 + r2 * (k4 + r2 * (k5 + r2 * k6)))
    prism_x = prism_y = 0.0
    if dists.shape[1] >= 12:
        s1, s2, s3, s4 = (dists[cam, i] for i in range(8, 12))
        prism_x = r2 * (s1 + r2 * s2)
        prism_y = r2 * (s3 + r2 * s4)
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x) + prism_x
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y + prism_y
    if dists.shape[1] >= 14:  # the sensor tilt, one matrix per camera
        cx_, sx_ = np.cos(dists[:, 12]), np.sin(dists[:, 12])
        cy_, sy_ = np.cos(dists[:, 13]), np.sin(dists[:, 13])
        zz, oo = np.zeros_like(cx_), np.ones_like(cx_)
        rx_ = np.stack([oo, zz, zz, zz, cx_, sx_, zz, -sx_, cx_],
                       axis=1).reshape(-1, 3, 3)
        ry_ = np.stack([cy_, zz, -sy_, zz, oo, zz, sy_, zz, cy_],
                       axis=1).reshape(-1, 3, 3)
        rr = ry_ @ rx_
        pz = np.zeros_like(rr)
        pz[:, 0, 0] = pz[:, 1, 1] = rr[:, 2, 2]
        pz[:, 0, 2] = -rr[:, 0, 2]
        pz[:, 1, 2] = -rr[:, 1, 2]
        pz[:, 2, 2] = 1.0
        m = (pz @ rr)[cam]
        w = m[:, 2, 0] * xd + m[:, 2, 1] * yd + m[:, 2, 2]
        xd, yd = ((m[:, 0, 0] * xd + m[:, 0, 1] * yd + m[:, 0, 2]) / w,
                  (m[:, 1, 0] * xd + m[:, 1, 1] * yd + m[:, 1, 2]) / w)
    pred = np.stack([xd, yd], axis=1) * f + c
    if fisheye_mask is not None:
        pred = np.where(fisheye_mask[cam][:, None], pred_fish, pred)
    return pred - dd[:, 3:5]


def estimate_camera_relative_poses(
        calibration_target: AbstractTarget, detection: TargetDetection,
        cams: CameraSet, ref_cam: int = 0, ref_pose: int = 0):
    """Single-reference-camera pose initialisation (PnP, OpenCV on the host).

    Per-camera PnP target poses per image; the reference image (seen by
    every camera) anchors the world frame; each image's pose is the
    per-camera candidate of least total reprojection cost.

    :return: (cam_poses (C, 4, 4) world->cam, target_poses (I, 4, 4)
        target->world, per_im_error (I,), pose_found (I,) bool).
    """
    img_detections = detection.get_image_list()
    cam_list = list(cams)
    # a thread-pooled C x I PnP sweep (solvePnPGeneric releases the GIL)
    flat = gu.thread_map(
        lambda ci: calibration_target.target_pose_in_cam_image(
            img_detections[ci % len(img_detections)],
            cam_list[ci // len(img_detections)], mode="nan"),
        range(len(cam_list) * len(img_detections)))
    mat_ac = np.array(flat).reshape(
        len(cam_list), len(img_detections), 4, 4)               # (C,I,4,4)
    # before any gap-filling: which images got a pose from ANY camera
    pose_found = ~np.all(np.isnan(mat_ac[:, :, 0, 0]), axis=0)

    check_for_target_misalignment(mat_ac, ref_cam)
    ref_pose = check_feasiblity_and_update_refpose(mat_ac, ref_pose)

    mrt_ac = mat_ac[:, ref_pose]                                # (C,4,4)
    mac_rt = np.array([np.linalg.inv(m) for m in mrt_ac])
    mat_rt_ac = mac_rt[:, None] @ mat_ac                        # (C,I,4,4)

    dlists = [np.reshape(c.distortion_coefs, -1) for c in cams]
    sizes = {int(d.size) for d in dlists}
    fisheye_mask = None
    if 4 in sizes and sizes != {4}:
        # a heterogeneous rig: the fisheye k1..k4 in the first Brown slots,
        # selected per camera in reprojection_costs
        n_dist = max(5, max(s for s in sizes if s != 4))
        fisheye_mask = np.array([d.size == 4 for d in dlists])
    else:
        n_dist = infer_shared_n_dist(dlists)
    dists = np.array([_pack_dist(d, n_dist) for d in dlists])
    ints = np.array([c.intrinsic for c in cams])
    proj = ints @ mrt_ac[:, :3, :]

    ps = calibration_target.point_data.reshape((-1, 3))
    target_shape = calibration_target.point_data.shape
    dd = detection.return_flattened_keys(target_shape[:-1]).get_data()
    im_col = dd[:, 1].astype(int)
    n_ims = int(detection.max_ims)

    # score every camera's candidate pose set
    errors = np.full((len(mat_rt_ac), n_ims), np.nan)
    for idc, mat_rt_c in enumerate(mat_rt_ac):
        nanform = np.isnan(mat_rt_c[:, 0, 0])
        if np.all(nanform):
            errors[idc] = np.inf  # this camera localised nothing
            mat_rt_c[:] = np.eye(4)
            continue
        # gap-fill missing candidates from the nearest valid image
        first_valid = int(np.argmin(nanform))
        for idn, wasnan in enumerate(nanform):
            if wasnan:
                mat_rt_c[idn] = (mat_rt_c[idn - 1] if idn > first_valid
                                 else mat_rt_c[first_valid])
        imlocs = np.array([gu.h_tform(ps, m) for m in mat_rt_c])
        costs = np.linalg.norm(
            reprojection_costs(dd, imlocs, proj, ints, dists, fisheye_mask),
            axis=1)
        errors[idc] = np.bincount(im_col, weights=costs, minlength=n_ims)

    estimate_locs = np.argmin(errors, axis=0)                  # best cam per im
    mat_rt = np.array([mat_rt_ac[e, i] for i, e in enumerate(estimate_locs)])

    imlocs = np.array([gu.h_tform(ps, m) for m in mat_rt])
    costs = np.linalg.norm(
        reprojection_costs(dd, imlocs, proj, ints, dists, fisheye_mask),
        axis=1)
    per_im_error = np.bincount(im_col, weights=costs, minlength=n_ims)

    mat_rt[ref_pose] = np.eye(4)
    return mrt_ac, mat_rt, per_im_error, pose_found


# ------------------------------------------------------ the OpenCV-free start

def _rig_gauge(handler, camset, poses, found):
    """The 4x4 W taking the handler's world frame to the stored rig's (a
    point X of the handler's frame is W X in the stored one), or None where
    the two are one frame. A camera whose extrinsic the handler fixes
    decides (the first such camera: W = stored^-1 fixed, None where the
    fixed extrinsic is the stored one); else the handler's fixed target
    pose (``fixed_pose``: W = the tracker's pose of that image); else
    None."""
    for name in handler.cam_names:
        fixed = handler.fixed_params.get(name, {}).get("ext")
        if fixed is None:
            continue
        fixed = np.asarray(fixed, dtype=float)
        if fixed.shape != (4, 4):
            fixed = gu.make_4x4h_tform(fixed[:3], fixed[3:])
        stored = np.asarray(camset[name].extrinsic, dtype=float)
        return (None if np.array_equal(fixed, stored)
                else np.linalg.inv(stored) @ fixed)
    fp = handler.problem_opts.get("fixed_pose")
    if fp is None:
        return None
    if not found[fp]:
        raise ValueError(
            f"start='rig': the tracker could not place image {fp}, the "
            "handler's fixed (gauge) pose; pass options={'fixed_pose': i} "
            "naming an image the rig sees")
    return poses[fp]


def rig_start(handler, camset, detection, target, device, dtype,
              poses=None):
    """Seed ``handler`` with no OpenCV (``start="rig"``): the free
    intrinsic and extrinsic blocks at the stored rig's values, the target
    poses from the port's tracker on the stored rig (device seeding), or
    ``poses`` (I, 4, 4) target -> world in the stored rig's frame where the
    caller has them (a frame with a non-finite pose is not placed). A frame
    the tracker cannot place (under 3 detections, or a non-finite pose)
    leaves the problem. The rig and the poses are re-expressed in the
    handler's gauge (``_rig_gauge``): its fixed extrinsics, or its fixed
    target pose."""
    n_poses = handler.bundlePrimitive.poses.shape[0]
    if poses is None:
        from pycamset_tpu_torch.tracking import TargetTracker
        poses, info = TargetTracker(camset, target, device=device,
                                    dtype=dtype).track_batch(
            detection, seed_mode="device")
        used = np.asarray(info["n_used"])
    else:
        poses = np.asarray(poses, dtype=float)
        used = np.full(len(poses), 3)
    found = np.zeros(n_poses, dtype=bool)
    n = min(n_poses, len(poses))
    found[:n] = (np.isfinite(poses[:n].reshape(n, -1)).all(axis=1)
                 & (used[:n] >= 3))
    world = _rig_gauge(handler, camset, poses, found)
    prim = handler.bundlePrimitive
    for idc, name in enumerate(handler.cam_names):
        if prim.intr_unfixed[idc]:
            prim.intr[idc] = handler._intr_seed_row(idc, camset[name])
        if prim.extr_unfixed[idc]:
            ext = np.asarray(camset[name].extrinsic, dtype=float)
            if world is not None:
                ext = ext @ world
            prim.extr[idc] = np.concatenate(gu.ext_4x4_to_rod(ext))
    to_handler = None if world is None else np.linalg.inv(world)
    for i in range(n_poses):
        if prim.poses_unfixed[i]:
            pose = np.eye(4)
            if found[i]:
                pose = poses[i] if to_handler is None else (
                    to_handler @ poses[i])
            prim.poses[i, :6] = np.concatenate(gu.ext_4x4_to_rod(pose))
    handler.missing_poses = ~found
    handler.set_initial_params(handler.add_extra_params(
        prim.base_full()[prim.unfixed_full()]))
