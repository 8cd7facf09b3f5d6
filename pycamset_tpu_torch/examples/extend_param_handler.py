"""Extending the parameter handler: calibrate with TWO rigidly-coupled
targets.

Counterpart of ``TwoTargetPrimitive``, ``TwoTargetCalibrator``,
``TwoTargetSelfPrimitive`` and ``TwoTargetSelfCalibrator`` in the JAX
package's ``examples/extend_param_handler.py`` (its demos are not carried
over). The unknown relative transform between the targets is a chain block
bound PER_GROUP (the target a feature belongs to):

    pixel = projection( extrinsic( pose_im( rel_group( point[key] ))))

Group 0 (the base target) has its relative transform fixed to the
identity; group 1's six parameters are free. ``TwoTargetCalibrator`` takes
the points from the targets (the grouped chain, ``GroupTemplatePoints``:
Kernels E and F at key width 6); ``TwoTargetSelfCalibrator`` frees them
too (the mixed chain, ``GroupRigidTform3d + FreePoint``: E and F at key
width 9). Both run through ``optim.driver.run_bundle_adjustment`` and
``optim.fleet.run_fleet_bundle_adjustment``.

The PnP seed of the relative pose (``add_extra_params``) needs OpenCV, as
the handlers' own seed does; without it, seed with
``set_initial_params``. The rig takes one camera model: a per-camera map
(fisheye beside Brown cameras, or Brown models of several widths) raises
``NotImplementedError`` (the JAX examples build the standard projection
whatever the map).
"""
from __future__ import annotations

import numpy as np

import pycamset_tpu_torch.utils.general_utils as gu
from pycamset_tpu_torch.models.camera_set import CameraSet
from pycamset_tpu_torch.models.detections import TargetDetection
from pycamset_tpu_torch.optim.blocks import (
    Extrinsic3D, FreePoint, GroupRigidTform3d, GroupTemplatePoints,
    RigidTform3d)
from pycamset_tpu_torch.optim.chain import OptimFunction
from pycamset_tpu_torch.optim.handlers import (
    SEED_INSTEAD, TemplateBundleHandler, TemplateBundlePrimitive,
    _clone_camset, _projection_block, _write_cams, find_not_colinear_pts)


class TwoTargetPrimitive(TemplateBundlePrimitive):
    """Template primitive + per-group relative transforms."""

    def __init__(self, poses, extr, intr, rel_poses, poses_unfixed=None,
                 extr_unfixed=None, intr_unfixed=None, rel_unfixed=None):
        self.rel_poses = rel_poses                     # (n_groups, 6)
        self.rel_unfixed = (rel_unfixed if rel_unfixed is not None
                            else np.ones(rel_poses.shape[0], dtype=bool))
        super().__init__(poses, extr, intr, poses_unfixed, extr_unfixed,
                         intr_unfixed)

    def base_full(self):
        return np.concatenate([super().base_full(), self.rel_poses.ravel()])

    def unfixed_full(self):
        return np.concatenate([super().unfixed_full(),
                               np.repeat(self.rel_unfixed, 6)])

    def _split(self, params):
        """The full vector with ``params`` at the free entries, and the
        offsets of the poses' and the rel poses' ends."""
        full = self.base_full()
        full[self.unfixed_full()] = params
        n_c, n_p = self.intr.shape[0], self.poses.shape[0]
        ie, ee = self.intr_width * n_c, (self.intr_width + 6) * n_c
        self.intr[:] = full[:ie].reshape(n_c, self.intr_width)
        self.extr[:] = full[ie:ee].reshape(n_c, 6)
        self.poses[:] = full[ee:ee + 6 * n_p].reshape(n_p, 6)
        pe = ee + 6 * n_p
        re = pe + self.rel_poses.size
        self.rel_poses[:] = full[pe:re].reshape(-1, 6)
        return full, re

    def return_bundle_primitives(self, params):
        self._split(params)
        return self.intr, self.extr, self.poses, self.rel_poses


class TwoTargetCalibrator(TemplateBundleHandler):
    """Calibrate with two targets that are rigidly fixed together.

    The second target's detections use keys offset by the first target's
    feature count; its pose relative to the first is recovered jointly with
    the calibration.
    """

    def __init__(self, camset: CameraSet, target0, target1,
                 detection0: TargetDetection, detection1: TargetDetection,
                 fixed_params=None, options=None, missing_poses=None):
        super().__init__(camset, target0, detection0, fixed_params, options,
                         missing_poses)
        if self.mixed_models:
            kinds = sorted(set(self.camera_models))
            raise NotImplementedError(
                f"a per-camera camera_model map {kinds} on the two-target "
                f"example handlers: the JAX package's twins replace the "
                f"chain's projection with the standard model's, so there is "
                f"no behaviour to match; give the rig one model (the "
                f"heterogeneous two-target chains themselves run through "
                f"problems.grouped_problem / mixed_problem)")
        self.extra_target = target1
        self.extra_detection = detection1
        self.len0 = target0.point_data.reshape(-1, 3).shape[0]
        self.len1 = target1.point_data.reshape(-1, 3).shape[0]
        self.point_data = np.concatenate(
            [target0.point_data.reshape(-1, 3),
             target1.point_data.reshape(-1, 3)], axis=0)
        self.target_point_shape = np.array(self.point_data.shape)

        prim = self.bundlePrimitive
        rel = np.zeros((2, 6))
        rel_unfixed = np.array([False, True])  # group 0 = identity (fixed)
        self.bundlePrimitive = TwoTargetPrimitive(
            prim.poses, prim.extr, prim.intr, rel,
            poses_unfixed=prim.poses_unfixed, extr_unfixed=prim.extr_unfixed,
            intr_unfixed=prim.intr_unfixed, rel_unfixed=rel_unfixed)

        self.op_fun = OptimFunction(
            [_projection_block(self.camera_model), Extrinsic3D(),
             RigidTform3d(), GroupTemplatePoints()])

    # ---- PER_GROUP wiring -------------------------------------------------

    def n_groups(self) -> int:
        return 2

    def group_of_key(self) -> np.ndarray:
        return (np.arange(self.len0 + self.len1) >= self.len0).astype(int)

    def template_table(self):
        return self.point_data

    # ---- initial estimates ------------------------------------------------

    def add_extra_params(self, param_array: np.ndarray) -> np.ndarray:
        """Append the initial estimate of target 1's relative pose, from
        per-image PnP of both targets (OpenCV)."""
        cv2 = gu.require_cv2("The relative pose seed (add_extra_params)",
                             SEED_INSTEAD)
        base_poses, base_ok = self.target.pose_in_detections(
            self.detection, self.camset,
            outliers=self.problem_opts.get("outliers", "ask"))
        extra_poses, extra_ok = self.extra_target.pose_in_detections(
            self.extra_detection, self.camset,
            outliers=self.problem_opts.get("outliers", "ask"))
        pairs = [np.linalg.inv(b) @ e
                 for b, e, okb, oke in zip(base_poses, extra_poses,
                                           base_ok, extra_ok) if okb and oke]
        rvec, tvec = gu.cv2_rod(cv2, gu.average_tforms(pairs))
        self.bundlePrimitive.rel_poses[1] = np.concatenate([rvec, tvec])
        # the free vector already covers the rel block (it is part of the
        # primitive); re-extract it so the seeded value lands in place
        prim = self.bundlePrimitive
        return prim.base_full()[prim.unfixed_full()]

    def get_detection_data(self, flatten: bool = False) -> np.ndarray:
        """The merged detection table: target 1's keys offset by len0."""
        if not flatten:
            raise ValueError("data must be flattened for multiple targets")
        data0 = super().get_detection_data(flatten=True)
        dims = self.extra_target.point_data.shape[:-1]
        data1 = (self.extra_detection.return_flattened_keys(dims).get_data()
                 + [0, 0, self.len0, 0, 0])
        return np.concatenate([data0, data1], axis=0)

    def get_relative_pose(self, x) -> np.ndarray:
        """The recovered target1->target0 4x4 transform."""
        rel = self.bundlePrimitive.return_bundle_primitives(x)[3]
        return gu.make_4x4h_tform(rel[1][:3], rel[1][3:])

    def get_camset(self, x, return_pose: bool = False):
        # the relative pose tail doesn't disturb the camera unpacking
        new_cams = _clone_camset(self.camset)
        proj, extr, poses = self.bundlePrimitive.return_bundle_primitives(
            x)[:3]
        _write_cams(new_cams, self.cam_names, proj, extr)
        if not return_pose:
            return new_cams
        flat = np.array([gu.make_4x4h_tform(p[:3], p[3:])[:3, :4].reshape(-1)
                         for p in poses])
        return new_cams, flat


class TwoTargetSelfPrimitive(TwoTargetPrimitive):
    """Two-target primitive + free per-point geometry.

    Parameter layout matches the chain group order:
    [intr | extr | poses | rel poses (PER_GROUP) | points (PER_KEY)].
    """

    def __init__(self, poses, extr, intr, rel_poses, bundle_points,
                 poses_unfixed=None, extr_unfixed=None, intr_unfixed=None,
                 rel_unfixed=None, bundle_points_unfixed=None):
        self.bundle_pts = bundle_points          # flat (3*n_points,)
        self.bdpt_unfixed = (bundle_points_unfixed
                             if bundle_points_unfixed is not None
                             else np.ones(bundle_points.shape[0], dtype=bool))
        super().__init__(poses, extr, intr, rel_poses, poses_unfixed,
                         extr_unfixed, intr_unfixed, rel_unfixed)

    def base_full(self):
        return np.concatenate([super().base_full(),
                               self.bundle_pts.ravel()])

    def unfixed_full(self):
        return np.concatenate([super().unfixed_full(), self.bdpt_unfixed])

    def return_bundle_primitives(self, params):
        full, re = self._split(params)
        self.bundle_pts[:] = full[re:]
        return (self.intr, self.extr, self.poses, self.rel_poses,
                self.bundle_pts.reshape(-1, 3))


class TwoTargetSelfCalibrator(TwoTargetCalibrator):
    """Two rigidly-coupled targets, SELF-calibrating BOTH geometries and
    the relative pose jointly.

    The chain mixes PER_KEY (free 3D points) and PER_GROUP (relative pose)
    parameters, which runs on the arrow-structured mixed backend
    (``optim/structured_mixed.py``). Gauge: each target's local frame is
    anchored to its nominal model: 7 fixed coordinates on target 0
    (similarity: the global frame and scale) and 6 on target 1 (rigid: its
    frame is otherwise absorbed by the free relative pose), group 0's
    relative pose fixed to the identity and unseen features frozen.
    """

    def __init__(self, camset: CameraSet, target0, target1,
                 detection0: TargetDetection, detection1: TargetDetection,
                 fixed_params=None, options=None, missing_poses=None):
        super().__init__(camset, target0, target1, detection0, detection1,
                         fixed_params, options, missing_poses)
        flat_pts = np.copy(self.point_data.reshape(-1)).astype(float)
        pts3 = flat_pts.reshape(-1, 3)
        gok = self.group_of_key()
        feat_unfixed = np.ones(pts3.shape[0] * 3, dtype=bool)
        for g in range(self.n_groups()):
            idx = np.where(gok == g)[0]
            j0, j1, j2 = find_not_colinear_pts(pts3[idx])
            i0, i1, i2 = idx[j0], idx[j1], idx[j2]
            feat_unfixed[3 * i0:3 * i0 + 3] = False
            if g == 0:   # + scale anchor: 3 + 3 + 1 = 7 (similarity)
                feat_unfixed[3 * i1:3 * i1 + 3] = False
                feat_unfixed[3 * i2] = False
            else:        # 3 + 2 + 1 = 6 (rigid; rel pose carries the rest)
                feat_unfixed[3 * i1:3 * i1 + 2] = False
                feat_unfixed[3 * i2] = False
        # freeze features never observed
        seen = np.unique(self.get_detection_data(flatten=True)[:, 2]
                         .astype(int))
        for idf in np.setdiff1d(np.arange(pts3.shape[0]), seen):
            feat_unfixed[3 * idf:3 * idf + 3] = False

        prim = self.bundlePrimitive
        self.bundlePrimitive = TwoTargetSelfPrimitive(
            prim.poses, prim.extr, prim.intr, prim.rel_poses, flat_pts,
            poses_unfixed=prim.poses_unfixed, extr_unfixed=prim.extr_unfixed,
            intr_unfixed=prim.intr_unfixed, rel_unfixed=prim.rel_unfixed,
            bundle_points_unfixed=feat_unfixed)
        self.op_fun = OptimFunction(
            [_projection_block(self.camera_model), Extrinsic3D(),
             RigidTform3d(), GroupRigidTform3d(), FreePoint()])

    def template_table(self):
        return None  # geometry is optimised, not a constant table

    def get_relative_pose(self, x) -> np.ndarray:
        rel = self.bundlePrimitive.return_bundle_primitives(x)[3]
        return gu.make_4x4h_tform(rel[1][:3], rel[1][3:])

    def get_updated_targets(self, x):
        """(points of target 0, points of target 1) in their local frames."""
        pts = self.bundlePrimitive.return_bundle_primitives(x)[4]
        return pts[:self.len0], pts[self.len0:]
