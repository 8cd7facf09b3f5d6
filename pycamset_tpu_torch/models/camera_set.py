"""CameraSet: an ordered collection of Cameras with calibration utilities.

Counterpart of ``pycamset_tpu/models/camera_set.py``: ``make_cam_dict``,
dict / list / slice / name indexing, subsets, iteration, equality, merging
(``+``), ``project_points_to_all_cams``, ``multi_cam_triangulate``,
``save``, ``set_resolutions_from_file``, the rig transforms
(``scale_set_2n``, ``transform``, ``set_reference_cam``), the calibration
history with its ``calibration_uncertainty`` and
``get_calibration_points``, ``essential_matrix``, ``fundamental_matrix``,
``get_similar_angles`` and the MVSNet export (``write_to_txt``).
Triangulation runs through the port's batched DLT
(``ops/triangulation.py``) on ``device``, the card unless the caller names
another, with each camera's distortion at its model's width (4, 5, 8, 12 or
14; narrower Brown vectors zero-padded to the widest, ``stack_cam_dists``);
a rig mixing fisheye and Brown cameras undistorts through heterogeneous
``[sel | coefs]`` rows, as the JAX package does. Plots, scene meshes and
the calibration diagnostics' plots wait for ROADMAP Queue A item 10.
"""
from __future__ import annotations

import numbers
from copy import deepcopy
from pathlib import Path

import numpy as np
import torch

from pycamset_tpu_torch.config import default_device_dtype, resolve_device
from pycamset_tpu_torch.models.camera import Camera
from pycamset_tpu_torch.ops.triangulation import triangulate_observations
from pycamset_tpu_torch.utils.general_utils import require_cv2
from pycamset_tpu_torch.utils.saving import save_camset


def stack_cam_dists(dist_list):
    """Stack per-camera distortion vectors into one (C, w) array.

    A rig of one family stacks plainly, the narrower Brown vectors
    zero-padded (exact sub-models). A rig mixing the fisheye's 4-wide
    vectors with Brown ones returns heterogeneous rows ``[sel | coefs]``
    (``ops/distortion.py``'s ``*_het`` functions) and het=True.

    :return: (dists, het).
    """
    dl = [np.ravel(np.asarray(d, dtype=float)) for d in dist_list]
    sizes = {d.size for d in dl}
    if 4 not in sizes or sizes == {4}:
        w = max(sizes) if sizes else 5
        return np.array([np.pad(d, (0, w - d.size)) for d in dl]), False
    w = max(5, max(s for s in sizes if s != 4))
    out = np.zeros((len(dl), 1 + w))
    for i, d in enumerate(dl):
        out[i, 0] = 1.0 if d.size == 4 else 0.0
        out[i, 1:1 + min(d.size, w)] = d[:w]
    return out, True


def make_cam_dict(camera_names, extrinsic_matrices, intrinsic_matrices,
                  dist_coefs=None, res=None) -> dict:
    """Build a name->Camera dict from parameter lists, filling defaults."""
    if res is None:
        res = [[768, 1024]] * len(camera_names)
    if dist_coefs is None:
        dist_coefs = [np.zeros(5)] * len(camera_names)
    return {
        name: Camera(extrinsic=ext, intrinsic=intr, res=r,
                     distortion_coefs=dist, name=name)
        for name, ext, intr, dist, r in zip(
            camera_names, extrinsic_matrices, intrinsic_matrices, dist_coefs,
            res)
    }


class CameraSet:
    """A set of fixed cameras (a multi-camera rig)."""

    def __init__(self, camera_names=None, extrinsic_matrices=None,
                 intrinsic_matrices=None, distortion_coefs=None, res=None,
                 camera_dict: dict | None = None):
        self.calibration_result = self.calibration_handler = None
        self.calibration_jac = self.calibration_params = None
        self._cam_list: list | None = None
        self._cam_dict: dict | None = None
        self.n_cams: int | None = None

        per_cam_args = (camera_names, extrinsic_matrices, res,
                        intrinsic_matrices, distortion_coefs)
        if camera_dict is None:
            if all(a is None for a in per_cam_args):
                return  # an empty set, to be filled by make_subset
            if any(a is None for a in per_cam_args):
                raise ValueError(
                    "Initialising a CameraSet requires names, extrinsic, "
                    "intrinsic, distortion coefficients and resolutions")
            camera_dict = make_cam_dict(
                camera_names, extrinsic_matrices, intrinsic_matrices,
                dist_coefs=distortion_coefs, res=res)
        self._cam_dict = camera_dict
        self._update()

    def _update(self):
        self._cam_list = list(self._cam_dict.values())
        self.n_cams = len(self._cam_list)

    # ----------------------------------------------------------- collections

    def get_n_cams(self) -> int:
        return len(self._cam_list)

    def __len__(self):
        return self.get_n_cams()

    def get_names(self) -> list:
        return list(self._cam_dict.keys())

    def get_cam_dict(self) -> dict:
        return self._cam_dict

    def get_cam_list(self) -> list:
        return self._cam_list

    def make_subset(self, inp) -> "CameraSet":
        """A new CameraSet of some of this one's cameras: a slice, or a
        list (or integer array) of indices or names."""
        pool = self.get_names()
        if isinstance(inp, np.ndarray):
            if not np.issubdtype(inp.dtype, np.integer):
                raise ValueError(
                    "Camera subsets accept only integer index arrays")
            inp = inp.tolist()
        if isinstance(inp, slice):
            picked = pool[inp]
        elif isinstance(inp, list):
            picked = []
            for idx in inp:
                if isinstance(idx, str):
                    if idx not in pool:
                        raise ValueError(f"{idx!r} is not a camera name")
                    picked.append(idx)
                else:
                    picked.append(pool[idx])
        else:
            raise ValueError(f"{inp} is not a valid subset identifier")
        subset = CameraSet()
        subset._cam_dict = {k: self._cam_dict[k] for k in picked}
        subset._update()
        return subset

    def __getitem__(self, inp):
        if isinstance(inp, (list, slice, np.ndarray)):
            return self.make_subset(inp)
        if isinstance(inp, numbers.Number):
            if inp in self._cam_dict:  # a numeric key that exists wins
                return self._cam_dict[inp]
            return self._cam_list[inp]
        return self._cam_dict[inp]

    def __setitem__(self, key, value: Camera):
        self._cam_dict[key] = value
        self._update()

    def __iter__(self):
        return iter(self._cam_list)

    def __eq__(self, other):
        if not isinstance(other, CameraSet):
            return False
        if set(self.get_names()) != set(other.get_names()):
            return False
        return all(self[c] == other[c] for c in self.get_names())

    def __add__(self, other: "CameraSet") -> "CameraSet":
        if not isinstance(other, CameraSet):
            raise ValueError("Can only add together camera sets")
        if self._cam_dict.keys() & other._cam_dict.keys():
            raise ValueError(
                "Camera sets share camera names so cannot be added")
        self._cam_dict.update(other._cam_dict)
        self._update()
        return self

    # ------------------------------------------------------------ projection

    def project_points_to_all_cams(self, points, distort=True,
                                   device="cuda"):
        """Project world points (n, 3) to every camera: a list (one per
        point) of {cam_name: uv} dicts, or one dict for a single point."""
        points = np.asarray(points, dtype=float)
        one_point = points.ndim == 1
        points = np.atleast_2d(points)
        by_cam = {name: cam.project_points(points, distort=distort,
                                           device=device)
                  for name, cam in self._cam_dict.items()}
        per_point = [{name: uvs[i] for name, uvs in by_cam.items()}
                     for i in range(points.shape[0])]
        return per_point[0] if one_point else per_point

    def multi_cam_triangulate(self, to_reconstruct, return_used=False,
                              distort=True, device="cuda", dtype=None):
        """Least-squares triangulation of shared-visibility observations.

        :param to_reconstruct: {cam_name: uv} dict, list of dicts, or a raw
            detection table [cam, im, key..., u, v].
        :return: (n, 3) world points (plus bookkeeping if return_used).
        """
        names = self.get_names()
        if isinstance(to_reconstruct, dict):
            to_reconstruct = [to_reconstruct]
        if isinstance(to_reconstruct, list):
            data: list = []
            for idx, group in enumerate(to_reconstruct):
                for cam_name, datum in group.items():
                    data.append([names.index(cam_name), 0, idx,
                                 datum[0], datum[1]])
            data = (np.array(data, dtype=float) if data
                    else np.zeros((0, 5)))
        else:
            data = np.asarray(to_reconstruct, dtype=float)

        def empty_result():
            out = np.zeros((0, 3))
            if return_used:
                return out, np.zeros((0, data.shape[1] if data.size else 5)), \
                    [], np.zeros((0, 1))
            return out

        if data.shape[0] == 0:
            return empty_result()

        # keep only groups (unique im+key) observed by >= 2 cameras
        _, inv, count = np.unique(data[:, 1:-2], axis=0,
                                  return_inverse=True, return_counts=True)
        viable_mask = count > 1
        recon = data[viable_mask[inv.squeeze()]]
        if recon.shape[0] == 0:
            return empty_result()

        # groups ordered by FIRST APPEARANCE in the input table
        uniq, grp_first, grp_inv, grp_counts = np.unique(
            recon[:, 1:-2], axis=0, return_index=True, return_inverse=True,
            return_counts=True)
        grp_inv = grp_inv.squeeze()
        appearance = np.argsort(grp_first)
        rank = np.empty_like(appearance)
        rank[appearance] = np.arange(appearance.size)
        gid = rank[grp_inv]
        uniq = uniq[appearance]
        grp_counts = grp_counts[appearance]
        n_groups = uniq.shape[0]
        vmax = int(grp_counts.max())

        # padded (n_groups, vmax) observation tables
        order = np.argsort(gid, kind="stable")
        slot = np.zeros(recon.shape[0], dtype=int)
        slot[order] = np.arange(recon.shape[0]) - np.concatenate(
            [[0], np.cumsum(grp_counts)[:-1]])[gid[order]]
        cam_idx = np.zeros((n_groups, vmax), dtype=np.int64)
        uv = np.zeros((n_groups, vmax, 2))
        mask = np.zeros((n_groups, vmax))
        cam_idx[gid, slot] = recon[:, 0].astype(np.int64)
        uv[gid, slot] = recon[:, -2:]
        mask[gid, slot] = 1.0

        proj = np.stack([cam.proj for cam in self])
        intr = np.stack([cam.intrinsic for cam in self])
        # without distortion, a true identity: 5-wide Brown zeros (a zero
        # 4-wide vector would still be the equidistant fisheye mapping)
        dists, het = (stack_cam_dists([cam.distortion_coefs for cam in self])
                      if distort else (np.zeros((len(self), 5)), False))

        device = resolve_device(device)
        dtype = dtype or default_device_dtype(device)

        def dev(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        reconstructed = triangulate_observations(
            dev(proj), dev(intr), dev(dists),
            torch.as_tensor(cam_idx, device=device), dev(uv),
            dev(mask), het=het).double().cpu().numpy()

        if return_used:
            where_mask = np.where(viable_mask[inv.squeeze()])[0]
            working_array = np.split(where_mask[order],
                                     np.cumsum(grp_counts)[:-1])
            return reconstructed, recon, working_array, uniq
        return reconstructed

    # ----------------------------------------------------------------- state

    def save(self, floc: Path | str = "saved_cameras.camset"):
        """Save to the .camset JSON checkpoint format."""
        save_camset(self, Path(floc))

    def set_resolutions_from_file(self, floc: Path):
        """Read per-camera resolutions from the first image in each
        camera's subfolder (an OpenCV read, on the host)."""
        cv2 = require_cv2("CameraSet.set_resolutions_from_file (image reads)",
                          "set each camera's res directly instead")
        folders = sorted(p.name for p in Path(floc).iterdir() if p.is_dir())
        if set(folders) != set(self.get_names()):
            raise ValueError(f"Subfolders of the file {floc} do not match the "
                             "current camera names")
        suffixes = {".png", ".bmp", ".tiff", ".jpg", ".jpeg"}
        for name in self.get_names():
            first = sorted(p for p in (Path(floc) / name).iterdir()
                           if p.suffix.lower() in suffixes)[0]
            h, w = cv2.imread(str(first)).shape[:2]
            self[name].res = np.array((w, h))

    def scale_set_2n(self, d_factor):
        for cam in self:
            cam.scale_self_2n(d_factor)

    def transform(self, transformation_matrix, in_place=True):
        """Transform all cameras by a 4x4 homogeneous matrix."""
        if not in_place:
            moved = deepcopy(self)
            moved.transform(transformation_matrix)
            return moved
        for cam in self:
            cam.transform(transformation_matrix)
        return None

    def set_reference_cam(self, cam_id):
        """Re-centre world coordinates on a reference camera."""
        self.transform(np.linalg.inv(self[cam_id].extrinsic))

    def set_calibration_history(self, optimisation_results, param_handler):
        """Attach the optimisation outputs so the set can be re-derived."""
        self.calibration_params = optimisation_results["x"]
        self.calibration_result = optimisation_results["fun"]
        self.calibration_jac = optimisation_results.get("jac")
        self.calibration_handler = param_handler

    def calibration_uncertainty(self, device="cuda") -> dict:
        """Per-parameter standard errors of this calibration (first-order
        error propagation at the solution, ``optim/uncertainty.py``); the
        residuals and Jacobian are evaluated on ``device``, the card unless
        the caller names another."""
        from pycamset_tpu_torch.optim.uncertainty import (
            calibration_uncertainty)
        return calibration_uncertainty(self, device=device)

    def get_calibration_points(self, device="cuda"):
        """Triangulate the calibration features (on ``device``, the card
        unless the caller names another), masking target-space
        outliers."""
        if self.calibration_handler is None:
            raise ValueError("No calibration history was found")
        detection = self.calibration_handler.get_detection()
        to_reconstruct = detection.sort(["key", "im_num"]).get_data()
        _, poses = self.calibration_handler.get_camset(
            self.calibration_params, return_pose=True)

        reconstructed, recon_subset, _, _ = self.multi_cam_triangulate(
            to_reconstruct, return_used=True, device=device)

        group_starts = np.sort(np.unique(
            recon_subset[:, 1:-2], axis=0, return_index=True)[1])
        group_im = recon_subset[group_starts, 1].astype(int)

        # pull each point into its image's target frame; anything further
        # than 3x the model's own mean radius is a triangulation outlier
        model_radius = np.mean(np.linalg.norm(
            self.calibration_handler.target.point_data, axis=-1))
        pose_rt = np.asarray(poses)[group_im].reshape(-1, 3, 4)
        in_target = np.einsum("nij,nj->ni",
                              pose_rt[:, :, :3].transpose(0, 2, 1),
                              reconstructed - pose_rt[:, :, 3])
        keep = np.linalg.norm(in_target, axis=-1) < 3 * model_radius
        return reconstructed[keep]

    # ------------------------------------------------------- two-view geometry

    def essential_matrix(self, cam_a, cam_b) -> np.ndarray:
        """Essential matrix on normalized image coordinates:
        ``xn_b^T E xn_a = 0``, E = [t]_x R of the cam_a -> cam_b frame."""
        rel = self[cam_b].extrinsic @ np.linalg.inv(self[cam_a].extrinsic)
        r, t = rel[:3, :3], rel[:3, 3]
        tx = np.array([[0.0, -t[2], t[1]],
                       [t[2], 0.0, -t[0]],
                       [-t[1], t[0], 0.0]])
        return tx @ r

    def fundamental_matrix(self, cam_a, cam_b) -> np.ndarray:
        """Fundamental matrix on UNDISTORTED pixel coordinates:
        ``u_b^T F u_a = 0``, F = Kb^-T E Ka^-1, largest entry 1."""
        e = self.essential_matrix(cam_a, cam_b)
        ka = np.asarray(self[cam_a].intrinsic, dtype=float)
        kb = np.asarray(self[cam_b].intrinsic, dtype=float)
        f = np.linalg.inv(kb).T @ e @ np.linalg.inv(ka)
        scale = np.abs(f).max()
        return f / scale if scale > 0 else f

    def get_similar_angles(self, test_cam_num, n):
        """Indices of the n cameras with the closest view direction."""
        gaze = np.array([cam.extrinsic[:3, 2] for cam in self])
        gaze /= np.linalg.norm(gaze, axis=1, keepdims=True)
        separation = np.arccos(np.clip(gaze @ gaze[test_cam_num], -1, 1))
        separation[test_cam_num] = np.inf  # never "similar" to itself
        return np.argsort(separation)[:n]

    # ----------------------------------------------------------------- export

    def write_to_txt(self, loc: Path, r, ims=None, mode="MVSnet", crop=None,
                     use_closest_cams=True):
        """Write the rig in MVSNet format: per-cam txts, images (undistorted
        and written by OpenCV, on the host) and pair.txt."""
        from pycamset_tpu_torch.reconstruction.acmmp_utils import (
            calc_pairs, write_pair_file)
        if mode != "MVSnet":
            raise NotImplementedError
        crop = crop or {}
        for cam_n, cam in enumerate(self):
            cam.to_MVSnet_txt(loc / f"{cam_n:08}_cam.txt",
                              (r.mindist, r.maxdist), r.steps,
                              crop.get(cam.name, None))

        if ims is not None:
            cv2 = require_cv2("CameraSet.write_to_txt's images",
                              "pass ims=None to write the cameras alone")
            im_dir = loc.parent / "images"
            im_dir.mkdir(exist_ok=True)
            for idx, raw in enumerate(ims):
                cam = self[idx]
                frame = cam.undistort(raw)
                window = crop.get(cam.name, None)
                if window is not None:
                    (r0, r1), (c0, c1) = window
                    frame = frame[r0:r1, c0:c1]
                cv2.imwrite(str(im_dir / f"{idx:08}.jpg"), frame,
                            [cv2.IMWRITE_JPEG_QUALITY, 100])

        view_dirs = np.array([cam.view for cam in self])
        pairs = calc_pairs(view_dirs, r, pick_closest=use_closest_cams)
        with open(loc.parent / "pair.txt", "w") as f:
            write_pair_file(f, pairs)
