"""Streaming 3D marker reconstruction against a calibrated rig.

Counterpart of ``pycamset_tpu/markers.py``: for NON-rigid marker sets
(wands, actors, tools) ``MarkerTriangulator`` gives each frame's marker
positions with their sigmas, the whole capture in one program over a
static (frames, markers, cameras) observation grid, on ``device`` (the
card unless the caller names another):

1. the observations undistorted on the device (the cameras' own models;
   a rig mixing fisheye and Brown cameras through the ``[sel | coefs]``
   rows) and the homogeneous DLT seed of every (frame, marker), the
   batched 4 x 4 eigh in chunks of ``_SEED_CHUNK`` points;
2. ``refine_iters`` fixed Gauss-Newton steps on the distorted pixel
   residual, the Jacobian by forward mode (``torch.func.jacfwd``), under
   ``torch.func.vmap`` over (frame, marker), as the JAX package's
   ``jax.vmap`` of ``jax.vmap``;
3. the first-order covariance sigma^2 (J^T J)^-1, dof-scaled; markers
   seen by fewer than 2 cameras give NaN positions and inf sigmas.
"""
from __future__ import annotations

import numpy as np
import torch

from pycamset_tpu_torch.config import default_device_dtype, resolve_device
from pycamset_tpu_torch.models.camera_set import stack_cam_dists
from pycamset_tpu_torch.models.detections import TargetDetection
from pycamset_tpu_torch.ops.distortion import (undistort_pixels,
                                               undistort_pixels_het)
from pycamset_tpu_torch.ops.projection import pack_rig_intrinsics
from pycamset_tpu_torch.ops.triangulation import triangulate_nviews


# points a batched eigh of the DLT seed takes at once: cuSOLVER refused
# one call of 1,024 frames x 64 markers (CUSOLVER_STATUS_INVALID_VALUE in
# its batched syev's workspace query) on an H100
_SEED_CHUNK = 16384


class MarkerTriangulator:
    """Per-frame marker-cloud reconstruction.

    :param camset: the calibrated rig.
    :param n_markers: marker count per frame (ids in the tables < it).
    :param refine_iters: Gauss-Newton steps on the pixel reprojection
        (0 = the raw DLT).
    :param device: where it runs (the card unless the caller names
        another); :param dtype: default float64 on the CPU, float32 on a
        card.
    """

    def __init__(self, camset, n_markers: int, refine_iters: int = 3,
                 device="cuda", dtype=None):
        self.camset = camset
        self.n_markers = int(n_markers)
        self.refine_iters = int(refine_iters)
        names = camset.get_names()
        self.n_cams = len(names)
        self.device = resolve_device(device)
        self._tdtype = dtype or default_device_dtype(self.device)
        dists = [np.reshape(camset[n].distortion_coefs, -1) for n in names]
        kmats = np.stack([np.asarray(camset[n].intrinsic, dtype=float)
                          for n in names])
        intr_rows, self._project_fn = pack_rig_intrinsics(kmats, dists)
        exts4 = np.stack([np.asarray(camset[n].extrinsic, dtype=float)
                          for n in names])
        dists_h, self._het = stack_cam_dists(dists)

        def dev(a):
            return torch.as_tensor(np.asarray(a, dtype=float),
                                   dtype=self._tdtype, device=self.device)
        # each camera's rotation and translation straight from its 4x4 (a
        # Rodrigues round trip costs 1e-8 near a half turn)
        self._intr = dev(intr_rows)
        self._rot, self._trans = dev(exts4[:, :3, :3]), dev(exts4[:, :3, 3])
        self._kmats, self._dists = dev(kmats), dev(dists_h)
        self._proj = dev(np.einsum("cij,cjk->cik", kmats, exts4[:, :3, :]))

    def _residuals(self, x, uv, mask):
        """(C, 2) masked pixel residuals of one point x (3,)."""
        xc = self._rot @ x + self._trans                    # (C, 3)
        z = xc[..., 2]
        z_safe = torch.where(torch.abs(z) > 1e-6, z, torch.full_like(z, 1e-6))
        xc = torch.cat([xc[..., :2], z_safe[..., None]], dim=-1)
        pred = self._project_fn(self._intr, xc)
        return (pred - uv) * mask[:, None]

    def _jtj(self, x, uv, mask):
        j = torch.func.jacfwd(self._residuals)(x, uv, mask)  # (C, 2, 3)
        jf = j.reshape(-1, 3)
        return jf.T @ jf, jf

    def _solve_one(self, x, uv, mask):
        """One (frame, marker): the DLT seed x (3,), (C, 2) raw
        observations and (C,) mask -> packed [x y z | cost | n_views |
        var_x var_y var_z]."""
        n_views = torch.sum(mask)
        eye = torch.eye(3, dtype=x.dtype, device=x.device)
        for _ in range(self.refine_iters):
            r = self._residuals(x, uv, mask)
            jtj, jf = self._jtj(x, uv, mask)
            g = jf.T @ r.reshape(-1)
            ridge = 1e-9 * torch.clamp(torch.max(torch.diagonal(jtj)),
                                       min=1.0)
            dx = torch.linalg.solve_ex(jtj + ridge * eye, g)[0]
            # a polish step must not explode an ill-seeded point
            ok = torch.isfinite(dx).all() & (n_views >= 2.0)
            x = torch.where(ok, x - dx, x)
        r = self._residuals(x, uv, mask)
        cost = torch.sum(r * r)
        jtj, _ = self._jtj(x, uv, mask)
        ridge = 1e-12 * torch.clamp(torch.max(torch.diagonal(jtj)), min=1.0)
        cov = torch.linalg.inv_ex(jtj + ridge * eye)[0]
        return torch.cat([x, cost[None], n_views[None], torch.diagonal(cov)])

    def _seeds(self, und, mask):
        """The homogeneous DLT seed of every (frame, marker): (I, M, 3), the
        batched 4 x 4 eigh taken in chunks of _SEED_CHUNK points."""
        n_c = self.n_cams
        proj = self._proj.expand((_SEED_CHUNK,) + self._proj.shape)
        flat_und, flat_mask = und.reshape(-1, n_c, 2), mask.reshape(-1, n_c)
        out = [triangulate_nviews(proj[:len(u)], u.contiguous(),
                                  m.contiguous())
               for u, m in zip(flat_und.split(_SEED_CHUNK),
                               flat_mask.split(_SEED_CHUNK))]
        x0 = torch.cat(out).reshape(mask.shape[:-1] + (3,))
        return torch.nan_to_num(x0, nan=0.0, posinf=0.0, neginf=0.0)

    def _solve_grid(self, und, uv, mask):
        return torch.func.vmap(torch.func.vmap(self._solve_one))(
            self._seeds(und, mask), uv, mask)

    # ----------------------------------------------------------------- API

    def _grids(self, dd, n_frames):
        """(I, M, C, 2) raw and undistorted observation grids and the
        (I, M, C) mask, on the device."""
        m, c = self.n_markers, self.n_cams
        uv = np.zeros((n_frames, m, c, 2))
        mask = np.zeros((n_frames, m, c))
        ci = dd[:, 0].astype(int)
        ji = dd[:, 1].astype(int)
        ki = dd[:, 2].astype(int)
        uv[ji, ki, ci] = dd[:, 3:5]
        mask[ji, ki, ci] = 1.0
        uv_t = torch.as_tensor(uv, dtype=self._tdtype, device=self.device)
        cams = torch.arange(c, device=self.device)
        mask_t = torch.as_tensor(mask, dtype=self._tdtype, device=self.device)
        und = (undistort_pixels_het if self._het else undistort_pixels)(
            uv_t, self._kmats[cams], self._dists[cams])
        # empty slots hold zeros (the DLT masks them out; no NaN may reach it)
        und = torch.where(mask_t[..., None] > 0, und, torch.zeros_like(und))
        return und, uv_t, mask_t

    def reconstruct(self, detections):
        """Per-frame marker positions for a whole capture, one program.

        :param detections: TargetDetection or raw rows
            ``[cam, frame, marker, u, v]``.
        :return: (points (I, M, 3), NaN where < 2 cameras saw the marker;
            info dict: ``rms`` (I, M), ``n_views`` (I, M), ``sigma``
            (I, M, 3) 1-sigma per axis).
        """
        if isinstance(detections, TargetDetection):
            dd = detections.get_data()
        else:
            dd = np.asarray(detections, dtype=float)
        if dd is None or dd.ndim != 2 or dd.shape[1] != 5 or not len(dd):
            raise ValueError("detections must be non-empty rows "
                             "[cam, frame, marker, u, v]")
        if dd[:, 2].max() >= self.n_markers:
            raise ValueError(
                f"marker id {int(dd[:, 2].max())} >= n_markers "
                f"{self.n_markers}")
        n_frames = int(dd[:, 1].max()) + 1
        out = self._solve_grid(*self._grids(dd, n_frames)).double().cpu(
            ).numpy()                                       # ONE transfer
        pts = out[..., :3].copy()
        cost = out[..., 3]
        n_views = out[..., 4].astype(int)
        dof = np.maximum(2 * n_views - 3, 0)
        sigma2 = np.where(dof >= 1, cost / np.maximum(dof, 1), np.inf)
        sigma = np.sqrt(np.clip(out[..., 5:8], 0.0, None)
                        * sigma2[..., None])
        sigma[~np.isfinite(sigma)] = np.inf
        unseen = n_views < 2
        pts[unseen] = np.nan
        sigma[unseen] = np.inf
        rms = np.sqrt(cost / np.maximum(2 * n_views, 1))
        rms[unseen] = np.nan
        return pts, {"rms": rms, "n_views": n_views, "sigma": sigma}
