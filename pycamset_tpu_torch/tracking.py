"""Streaming target-pose tracking against a fixed, calibrated rig.

Counterpart of ``pycamset_tpu/tracking.py``: the serving path. A rig is
calibrated once; then each frame of detections needs the target's 6-dof
pose (or, with ``rolling_shutter=`` / ``time_offsets=``, the 12-dof
[pose | velocity] state). The device programs live in ``TrackerCore``, a
``torch.nn.Module`` whose buffers are the rig's constants:

- the residual and its Jacobian in closed form (pose, then extrinsic, then
  projection: ``optim/analytic.projection_partials``), where the JAX
  package takes ``jax.jacfwd``; every function takes leading frame dims;
- the LM solve is ``optim/lm.lm_run_device``: ``max_nfev - 1`` masked
  steps with no host read, which gives each frame the x, cost, nit and
  status of JAX's vmapped ``lax.while_loop``;
- device seeding: inhomogeneous triangulation of every key seen by >= 2
  cameras, a weighted rigid fit of the template onto it, and the last
  good seed carried into frames that cannot be seeded (a cumulative-max
  index gather, JAX's forward-fill ``lax.scan``);
- ``track_batch`` solves all frames in one batched program; ``track_stream``
  warm-starts each frame from the last. On a card the stream is one CUDA
  graph replay a frame (the frame index and the carried state live in
  device buffers: no host read between frames), and ``track`` one replay;
  on the CPU the same functions run uncaptured.

The closed-form Jacobian (not ``torch.func.jvp``) is what lets
``serving.export_tracker`` export these programs with a symbolic frame
axis: ``torch.export`` cannot trace ``jvp`` with a dynamic dimension.
Host PnP (the first frame of ``track``/``track_stream`` without ``init=``,
``seed_mode="pnp"`` and the ``"auto"`` rescue of a frame whose rms marks a
failed solve) imports OpenCV through ``require_cv2`` when a frame needs it.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from pycamset_tpu_torch.config import default_device_dtype, resolve_device
from pycamset_tpu_torch.models.camera_set import stack_cam_dists
from pycamset_tpu_torch.models.detections import TargetDetection
from pycamset_tpu_torch.ops.projection import pack_rig_intrinsics
from pycamset_tpu_torch.ops.rotations import (matrix_to_rodrigues,
                                              rodrigues_jacobian,
                                              rodrigues_to_matrix)
from pycamset_tpu_torch.ops.transforms import rigid_fit_batch
from pycamset_tpu_torch.ops.triangulation import triangulate_observations
from pycamset_tpu_torch.optim.analytic import projection_partials
from pycamset_tpu_torch.optim.lm import lm_run_device
from pycamset_tpu_torch.optim.losses import make_loss
from pycamset_tpu_torch.utils.general_utils import (cv2_pose, cv2_rod,
                                                    ext_4x4_to_rod,
                                                    make_4x4h_tform,
                                                    require_cv2)

_NO_CV2 = ("pass init= (track, track_stream) or inits= (track_batch), or "
           "use track_batch(seed_mode='device')")


def rig_projection_partials(intr, xc, het: bool, n_brown: int):
    """pred (..., 2) and d pred / d xc (..., 2, 3) of camera-frame points
    xc (..., 3), each through its packed row intr (..., w) of
    ``pack_rig_intrinsics`` (a het row: both families, selected by slot
    0)."""
    xc1 = xc[..., None, :]
    if not het:
        pred, _, d_xc = projection_partials(intr, xc1, with_intr=False)
        return pred[..., 0, :], d_xc[..., 0, :, :]
    kvec, dist = intr[..., 1:5], intr[..., 5:]
    pb, _, db = projection_partials(
        torch.cat([kvec, dist[..., :n_brown]], -1), xc1, with_intr=False)
    pf, _, df = projection_partials(
        torch.cat([kvec, dist[..., :4]], -1), xc1, with_intr=False)
    fish = intr[..., 0] > 0.5
    return (torch.where(fish[..., None], pf[..., 0, :], pb[..., 0, :]),
            torch.where(fish[..., None, None], df[..., 0, :, :],
                        db[..., 0, :, :]))


def rig_family(dists):
    """(het, n_brown) of a rig's distortion vectors: het when 4-wide
    fisheye vectors sit beside Brown ones (``pack_rig_intrinsics``'
    selector layout), n_brown the Brown width of that layout."""
    sizes = {np.reshape(d, -1).size for d in dists}
    return (4 in sizes and sizes != {4},
            max([5] + [s for s in sizes if s != 4]))


def _mat_vec(m, v):
    """(..., 3, 3) @ (..., 3) as a product and a sum over the last axis
    (the leading dims broadcast)."""
    return torch.sum(m * v[..., None, :], dim=-1)


class TrackerCore(torch.nn.Module):
    """The tracker's device programs over a rig's constants (buffers).

    Shapes, with any leading frame dims ``...``: state (..., S), cam_i and
    key_i (..., N) int64, uv (..., N, 2), mask (..., N); S = 6, or 12 for
    the timed state.
    """

    def __init__(self, intr, re, te, tpl, rs, toff, heights, kmats, dists,
                 proj, *, het: bool, n_brown: int, timed: bool, loss: str,
                 f_scale: float, max_nfev: int):
        super().__init__()
        for name, val in (("intr", intr), ("re", re), ("te", te),
                          ("tpl", tpl), ("rs", rs), ("toff", toff),
                          ("heights", heights), ("kmats", kmats),
                          ("dists", dists), ("proj", proj)):
            self.register_buffer(name, val)
        self.het, self.n_brown, self.timed = het, n_brown, timed
        self.n_state = 12 if timed else 6
        self.pack_w = self.n_state + 3 + self.n_state ** 2
        self.max_nfev = int(max_nfev)
        # the LM's steps through torch's scan operator (set while exporting)
        self.lm_as_scan = False
        self.robust = loss != "linear"
        self.rho, self.weight = make_loss(loss, f_scale)

    # ------------------------------------------------------------ residual

    def _partials(self, cam_i, xc):
        """pred (..., N, 2) and d pred / d xc (..., N, 2, 3) through each
        detection's camera (a het rig: both families, selected)."""
        return rig_projection_partials(self.intr[cam_i], xc, self.het,
                                       self.n_brown)

    def residual_jac(self, state, cam_i, key_i, uv, mask):
        """Masked residuals (..., N, 2) and their Jacobian (..., N, 2, S).

        The timed state samples each detection at dt = readout * (v/H -
        1/2) + offset of its camera, from the OBSERVED row: pose6 + dt *
        velocity, so d r / d velocity = dt * d r / d pose6. The 3 x 3
        products are a broadcast product and a sum: a batched matmul of
        one 3 x 3 a detection runs as a GEMV a batch entry on a card."""
        pts = self.tpl[key_i]                                 # (..., N, 3)
        if self.timed:
            dt = (self.rs[cam_i] * (uv[..., 1] / self.heights[cam_i] - 0.5)
                  + self.toff[cam_i])                         # (..., N)
            p6 = state[..., None, :6] + dt[..., None] * state[..., None, 6:]
        else:
            p6 = state[..., None, :6]                         # (..., 1, 6)
        rp = rodrigues_to_matrix(p6[..., :3])
        drp = rodrigues_jacobian(p6[..., :3])                 # (.., j, a, b)
        re = self.re[cam_i]                                   # (..., N, 3, 3)
        xw = _mat_vec(rp, pts) + p6[..., 3:]
        xc = _mat_vec(re, xw) + self.te[cam_i]
        pred, d_xc = self._partials(cam_i, xc)
        m = mask[..., None]
        r = (pred - uv) * m
        # d pred / d t = d_xc Re; d pred / d rv_j = d_xc Re dRp[j] X
        d_t = torch.sum(d_xc[..., :, :, None] * re[..., None, :, :],
                        dim=-2)                               # (..., N, 2, 3)
        u = torch.sum(drp * pts[..., None, None, :], dim=-1)  # (..., N, j, 3)
        d_rv = torch.sum(d_t[..., :, None, :] * u[..., None, :, :],
                         dim=-1)                              # (..., N, 2, 3)
        j6 = torch.cat([d_rv, d_t], dim=-1)                   # (..., N, 2, 6)
        if self.timed:
            j6 = torch.cat([j6, dt[..., None, None] * j6], dim=-1)
        return r, j6 * m[..., None]

    def neq(self, state, cam_i, key_i, uv, mask):
        """(JtJ (..., S, S), grad (..., S), cost (...)) at state."""
        r, j = self.residual_jac(state, cam_i, key_i, uv, mask)
        if self.robust:
            s = torch.sum(r * r, dim=-1)
            cost = torch.sum(self.rho(s) * mask, dim=-1)
            sw = torch.sqrt(self.weight(s))[..., None]
            r = r * sw
            j = j * sw[..., None]
        else:
            cost = torch.sum(r * r, dim=(-2, -1))
        n_s = self.n_state
        jf = j.reshape(j.shape[:-3] + (-1, n_s))
        rf = r.reshape(r.shape[:-2] + (-1,))
        jtj = jf.transpose(-1, -2) @ jf
        grad = torch.sum(jf * rf[..., None], dim=-2)
        if self.timed:
            # the weak zero-velocity prior (1e-8 of the pose information):
            # a static or one-row frame leaves the velocity unobservable
            diag6 = torch.diagonal(jtj, dim1=-2, dim2=-1)[..., :6]
            lam = 1e-8 * torch.clamp(torch.amax(diag6, dim=-1), min=1.0)
            vel_eye = torch.cat([torch.zeros(6, dtype=jtj.dtype,
                                             device=jtj.device),
                                 torch.ones(6, dtype=jtj.dtype,
                                            device=jtj.device)])
            jtj = jtj + lam[..., None, None] * torch.diag(vel_eye)
            grad = grad + lam[..., None] * vel_eye * state
            cost = cost + lam * torch.sum(state[..., 6:] ** 2, dim=-1)
        return jtj, grad, cost

    # --------------------------------------------------------------- solve

    def solve_packed(self, pose0, cam_i, key_i, uv, mask):
        """The LM solve and the unit-noise covariance inv(JtJ + ridge) at
        its end, packed [x | cost | nit | status | cov (S*S)] (..., W)."""
        s = lm_run_device(lambda p: self.neq(p, cam_i, key_i, uv, mask),
                          pose0, max_nfev=self.max_nfev,
                          as_scan=self.lm_as_scan)
        return self.pack(s.x, s.cost, s.it, s.status, self.cov(s.jtj))

    def cov(self, jtj):
        """inv(JtJ + ridge I), the ridge 1e-12 of the largest diagonal
        entry (at least 1e-12): a degenerate frame stays finite or inf."""
        diag = torch.diagonal(jtj, dim1=-2, dim2=-1)
        ridge = 1e-12 * torch.clamp(torch.amax(diag, dim=-1), min=1.0)
        eye = torch.eye(self.n_state, dtype=jtj.dtype, device=jtj.device)
        return torch.linalg.inv_ex(jtj + ridge[..., None, None] * eye)[0]

    def pack(self, x, cost, nit, status, cov):
        return torch.cat([x, cost[..., None],
                          nit.to(x.dtype)[..., None],
                          status.to(x.dtype)[..., None],
                          cov.reshape(cov.shape[:-2] + (-1,))], dim=-1)

    # ------------------------------------------------------------- seeding

    def seed_batch(self, uv_grid, mask_grid):
        """(I, K, C, 2) uv + (I, K, C) mask grids -> (I, S) seeds."""
        n_c = self.kmats.shape[0]
        n_k = self.tpl.shape[0]
        flat_mask = mask_grid.reshape(-1, n_c)
        cam_rows = torch.arange(n_c, device=uv_grid.device).expand(
            flat_mask.shape)
        pts = triangulate_observations(
            self.proj, self.kmats, self.dists, cam_rows,
            uv_grid.reshape(-1, n_c, 2), flat_mask, method="inhomogeneous",
            het=self.het).reshape(-1, n_k, 3)
        seen = torch.sum(mask_grid, dim=-1) >= 2.0            # (I, K)
        # unseen keys triangulate to garbage (inf from a zero det): zero
        # them before the weighted fit
        pts = torch.where(seen[..., None], torch.nan_to_num(
            pts, nan=0.0, posinf=0.0, neginf=0.0), torch.zeros_like(pts))
        w = seen.to(uv_grid.dtype)
        frame_ok = torch.sum(w, dim=-1) >= 3.0                # (I,)
        w_safe = torch.where(frame_ok[:, None], w, torch.ones_like(w))
        rmat, t = rigid_fit_batch(self.tpl.expand(pts.shape), pts, w_safe)
        seeds = torch.nan_to_num(torch.cat(
            [matrix_to_rodrigues(rmat), t], dim=-1))
        if self.timed:          # velocity seeds at 0; the LM recovers it
            seeds = torch.cat([seeds, torch.zeros_like(seeds)], dim=-1)
        # the last seedable frame at or before each frame; frames before
        # the first seedable one take it; none at all: zeros
        idx = torch.arange(seeds.shape[0], device=seeds.device)
        last = torch.cummax(torch.where(frame_ok, idx, -1), dim=0).values
        first = torch.argmax(frame_ok.to(torch.int32))
        filled = seeds[torch.where(last >= 0, last, first)]
        return torch.where(torch.any(frame_ok), filled,
                           torch.zeros_like(filled))

    def solve_batch_seeded(self, uv_grid, mask_grid, cam_i, key_i, uv,
                           mask):
        """Device seeds, then the batched solve: (packed (I, W), seeds)."""
        seeds = self.seed_batch(uv_grid, mask_grid)
        return self.solve_packed(seeds, cam_i, key_i, uv, mask), seeds

    # -------------------------------------------------------------- stream

    def stream_step(self, carry, cam_i, key_i, uv, mask):
        """One frame warm-started from ``carry``: (next carry, packed row).
        A frame with fewer than S/2 detections (3 points for 6 dof, 6 for
        the timed state) carries the state forward and reports inf cost."""
        s = lm_run_device(lambda p: self.neq(p, cam_i, key_i, uv, mask),
                          carry, max_nfev=self.max_nfev,
                          as_scan=self.lm_as_scan)
        tracked = torch.sum(mask, dim=-1) >= self.n_state / 2.0
        nxt = torch.where(tracked, s.x, carry)
        cost = torch.where(tracked, s.cost,
                           torch.full_like(s.cost, float("inf")))
        return nxt, self.pack(nxt, cost, s.it, s.status, self.cov(s.jtj))

    def solve_stream(self, pose0, cam_i, key_i, uv, mask):
        """Frames in order, each from the last one's state: (I, W)."""
        carry, rows = pose0, []
        for i in range(cam_i.shape[0]):
            carry, row = self.stream_step(carry, cam_i[i], key_i[i], uv[i],
                                          mask[i])
            rows.append(row)
        return torch.stack(rows)


class _FrameGraphs:
    """CUDA graphs of the one-frame programs, a capture per shape: the
    single-frame solve (``track``) and the stream (``track_stream``: the
    frame index and the carried state live in device buffers, one replay a
    frame, no host read between frames)."""

    def __init__(self, core: TrackerCore):
        self.core = core
        self.stream = None
        self.single = None
        self.streams = {}
        self.capture_ms = {}

    def _capture(self, body, key):
        from pycamset_tpu_torch.optim.structured_lm import capture
        if self.stream is None:
            self.stream = torch.cuda.Stream()
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            body()                    # warm-up, uncaptured, on the side stream
        torch.cuda.current_stream().wait_stream(self.stream)
        graph, ms = capture(body, self.stream)
        self.capture_ms[key] = ms
        return graph

    def solve_one(self, args):
        if self.single is None:
            inp = [a.clone() for a in args]
            out = [None]

            def body():
                out[0] = self.core.solve_packed(*inp)
            graph = self._capture(body, "single")
            self.single = (graph, inp, out)
        graph, inp, out = self.single
        for buf, a in zip(inp, args):
            buf.copy_(a)
        graph.replay()
        return out[0].clone()

    def solve_stream(self, pose0, cam_i, key_i, uv, mask):
        n = cam_i.shape[0]
        if n not in self.streams:
            data = [a.clone() for a in (cam_i, key_i, uv, mask)]
            carry = pose0.clone()
            idx = torch.zeros(1, dtype=torch.int64, device=pose0.device)
            rows = torch.zeros((n, self.core.pack_w), dtype=pose0.dtype,
                               device=pose0.device)

            def body():
                frame = [torch.index_select(a, 0, idx)[0] for a in data]
                nxt, row = self.core.stream_step(carry, *frame)
                rows.index_copy_(0, idx, row[None])
                carry.copy_(nxt)
                idx.add_(1)
            graph = self._capture(body, f"stream {n}")
            self.streams[n] = (graph, data, carry, idx, rows)
        graph, data, carry, idx, rows = self.streams[n]
        for buf, a in zip(data, (cam_i, key_i, uv, mask)):
            buf.copy_(a)
        carry.copy_(pose0)
        idx.zero_()
        for _ in range(n):
            graph.replay()
        return rows.clone()


def _np_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


class TargetTracker:
    """6-dof (or 12-dof timed) target pose solver for a fixed rig.

    :param camset: the calibrated rig (camera parameters held fixed).
    :param target: the target (template geometry from target.point_data).
    :param max_detections: per-frame detection capacity (default: every
        camera sees every feature); more are truncated with a warning.
    :param loss: robust loss (``optim/losses.py``); :param f_scale: its
        scale. :param max_nfev: LM evaluations a frame.
    :param rolling_shutter: per-camera readout in frame units ((C,) or a
        scalar): each frame solves [pose | velocity], a detection on row v
        seen at pose + velocity * readout * (v/H - 1/2).
    :param time_offsets: per-camera clock offsets in frames ((C,)): the
        detections of camera c are modelled ``offset_c`` later along the
        same velocity (implies the 12-dof state).
    :param device: where the programs run (the card unless the caller
        names another); :param dtype: default float64 on the CPU, float32
        on a card.
    """

    def __init__(self, camset, target, max_detections: int | None = None,
                 loss: str = "linear", f_scale: float = 1.0,
                 max_nfev: int = 25, rolling_shutter=None, time_offsets=None,
                 device="cuda", dtype=None):
        self.camset = camset
        self.target = target
        self.device = resolve_device(device)
        self._tdtype = dtype or default_device_dtype(self.device)
        self._dtype = _np_dtype(self._tdtype)
        names = camset.get_names()
        dists = [np.reshape(camset[n].distortion_coefs, -1) for n in names]
        kmats = [np.asarray(camset[n].intrinsic, dtype=float) for n in names]
        intr_rows, _ = pack_rig_intrinsics(kmats, dists)
        self._intr = intr_rows.astype(self._dtype)
        self._tpl = np.asarray(target.point_data.reshape(-1, 3),
                               dtype=self._dtype)
        self.n_keys = int(self._tpl.shape[0])
        self.n_cams = len(names)
        self.max_detections = int(max_detections
                                  or self.n_cams * self.n_keys)
        self._max_nfev = int(max_nfev)
        self._timed = rolling_shutter is not None or time_offsets is not None
        self._n_state = 12 if self._timed else 6
        self._last_pose: np.ndarray | None = None

        def per_cam(v):
            return np.broadcast_to(np.asarray(0.0 if v is None else v,
                                              dtype=float),
                                   (self.n_cams,)).copy()
        self._rs, self._toff = per_cam(rolling_shutter), per_cam(time_offsets)
        heights = np.array([float(np.ravel(camset[n].res)[1])
                            for n in names])
        dists_h, het = stack_cam_dists(dists)
        n_brown = rig_family(dists)[1]
        exts = np.stack([np.asarray(camset[n].extrinsic, dtype=float)
                         for n in names])
        proj = np.einsum("cij,cjk->cik", np.stack(kmats), exts[:, :3, :])

        def dev(a):
            return torch.as_tensor(np.asarray(a, dtype=float),
                                   dtype=self._tdtype, device=self.device)
        # each camera's rotation and translation straight from its 4x4 (a
        # Rodrigues round trip costs 1e-8 near a half turn)
        self.core = TrackerCore(
            dev(self._intr), dev(exts[:, :3, :3]), dev(exts[:, :3, 3]),
            dev(self._tpl), dev(self._rs), dev(self._toff), dev(heights),
            dev(np.stack(kmats)), dev(dists_h), dev(proj), het=het,
            n_brown=n_brown, timed=self._timed, loss=loss, f_scale=f_scale,
            max_nfev=max_nfev)
        self._graphs = (_FrameGraphs(self.core)
                        if self.device.type == "cuda" else None)

    # --------------------------------------------------------- programs

    def _solve_p(self, init, cam_i, key_i, uv, mask):
        args = (init, cam_i, key_i, uv, mask)
        if self._graphs is not None:
            return self._graphs.solve_one(args)
        return self.core.solve_packed(*args)

    def _solve_stream(self, pose0, *dev_args):
        if self._graphs is not None:
            return self._graphs.solve_stream(pose0, *dev_args)
        return self.core.solve_stream(pose0, *dev_args)

    def _tensor(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype or self._tdtype,
                               device=self.device)

    # ------------------------------------------------------------ frames

    def _obs_grids(self, dd_all: np.ndarray, n_frames: int):
        """(I, K, C, 2) uv grid + (I, K, C) mask from flattened rows, the
        device seeder's layout (shared with ``ServingTracker``)."""
        im_c = dd_all[:, 1].astype(int)
        key_c = dd_all[:, -3].astype(int)
        cam_c = dd_all[:, 0].astype(int)
        uv_grid = np.zeros((n_frames, self.n_keys, self.n_cams, 2),
                           dtype=self._dtype)
        mask_grid = np.zeros((n_frames, self.n_keys, self.n_cams),
                             dtype=self._dtype)
        uv_grid[im_c, key_c, cam_c] = dd_all[:, -2:]
        mask_grid[im_c, key_c, cam_c] = 1.0
        return uv_grid, mask_grid

    def _pack_frame(self, dd: np.ndarray):
        """One frame's rows [cam, (im,) key..., u, v] -> padded
        (cam_i, key_i, uv, mask) of the detection capacity."""
        n_max = self.max_detections
        if dd is None or not len(dd):
            return (np.zeros(n_max, np.int64), np.zeros(n_max, np.int64),
                    np.zeros((n_max, 2)), np.zeros(n_max))
        cam_i = dd[:, 0].astype(np.int64)
        key_i = dd[:, -3].astype(np.int64)
        uv = dd[:, -2:].astype(np.float64)
        if len(dd) > n_max:
            logging.warning(
                f"frame has {len(dd)} detections > capacity {n_max}; "
                "truncating (raise max_detections)")
            cam_i, key_i, uv = cam_i[:n_max], key_i[:n_max], uv[:n_max]
        pad = n_max - len(cam_i)
        return (np.concatenate([cam_i, np.zeros(pad, np.int64)]),
                np.concatenate([key_i, np.zeros(pad, np.int64)]),
                np.concatenate([uv, np.zeros((pad, 2))]),
                np.concatenate([np.ones(len(cam_i)), np.zeros(pad)]))

    def _pnp_seed(self, det: TargetDetection) -> np.ndarray | None:
        dd = det.return_flattened_keys(
            self.target.point_data.shape[:-1]).get_data()
        return self._pnp_seed_rows(dd)

    def _pnp_seed_rows(self, rows: np.ndarray | None) -> np.ndarray | None:
        """Host PnP seed (target->world pose6) from one frame's rows
        [cam, im, key, u, v]: the first camera with >= 6 detections that
        OpenCV localises; None when none does."""
        if rows is None or not len(rows):
            return None
        cv2 = require_cv2("the tracker's PnP seed", _NO_CV2)
        tpl = np.asarray(self._tpl, dtype=np.float64)
        cams_col = rows[:, 0].astype(int)
        for ci, name in enumerate(self.camset.get_names()):
            sel = rows[cams_col == ci]
            if len(sel) < 6:
                continue
            cam = self.camset[name]
            obj = tpl[sel[:, -3].astype(int)]
            obs = sel[:, -2:].astype(np.float64)
            dist = np.ravel(np.asarray(cam.distortion_coefs, dtype=float))
            if dist.size == 4:  # the fisheye marker width
                obs = cv2.fisheye.undistortPoints(
                    obs.reshape(1, -1, 2),
                    np.asarray(cam.intrinsic, dtype=float),
                    dist).reshape(-1, 2)
                kmat, dist = np.eye(3), np.zeros(5)
            else:
                kmat = np.asarray(cam.intrinsic, dtype=float)
            n_sols, rvecs, tvecs, errs = cv2.solvePnPGeneric(
                obj.astype(np.float32), obs.astype(np.float32), kmat, dist)
            if not n_sols:
                continue
            best = int(np.argmin(errs))
            pose_c = cv2_pose(cv2, rvecs[best], tvecs[best])
            if np.any(np.isnan(pose_c)):
                continue
            rvec, tvec = cv2_rod(cv2, cam.cam_to_world @ pose_c)
            return np.concatenate([rvec, tvec])
        return None

    def _widen_state(self, init) -> np.ndarray:
        """A 4x4, a 6-vector or a full state -> the (S,) state (velocity
        0 under the timed model)."""
        init = np.asarray(init, dtype=float)
        if init.shape == (4, 4):
            init = np.concatenate(ext_4x4_to_rod(init))
        init = np.ravel(init)
        if init.size == 6 and self._n_state == 12:
            init = np.concatenate([init, np.zeros(6)])
        if init.size != self._n_state:
            raise ValueError(f"seed must be a 4x4, a 6-vector or a "
                             f"{self._n_state}-state; got {init.shape}")
        return init

    def _pnp_rescue(self, out, seeds_d, dd_all, bounds, mask, dev_args):
        """Re-seed by host PnP the frames whose rms marks a failed solve
        (above max(10 x the median, 2 px) with >= 4 detections), solve
        them again and keep the cheaper solve a frame. ``out`` is the
        packed host (I, W) matrix; nothing runs without such a frame."""
        s = self._n_state
        n_used = np.asarray(mask).sum(axis=1)
        rms = np.sqrt(out[:, s] / np.maximum(2 * n_used, 1))
        med = (float(np.median(rms[n_used >= 4])) if np.any(n_used >= 4)
               else 0.0)
        bad = (rms > max(10.0 * med, 2.0)) & (n_used >= 4)
        if not np.any(bad):
            return out
        seeds = np.array(torch.as_tensor(seeds_d).double().cpu().numpy())
        n_fixed = 0
        for i in np.nonzero(bad)[0]:
            sv = self._pnp_seed_rows(dd_all[bounds[i]:bounds[i + 1]])
            if sv is not None:
                seeds[i] = self._widen_state(sv)
                n_fixed += 1
        if not n_fixed:
            return out
        out2 = self._fetch(self.core.solve_packed(self._tensor(seeds),
                                                  *dev_args))
        pick = bad & (out2[:, s] < out[:, s])
        return np.where(pick[:, None], out2, out)

    @staticmethod
    def _fetch(t: torch.Tensor) -> np.ndarray:
        """ONE device-to-host copy of a packed result, as float64."""
        return t.double().cpu().numpy()

    # --------------------------------------------------------------- API

    def track(self, detection: TargetDetection, init=None):
        """Pose of the target in ONE frame's detections.

        :param init: 6-vector or 4x4 seed; default the previous frame's
            result (warm start), then host PnP.
        :return: (pose 4x4 target->world, info dict: rms, nit, n_used,
            status, pose_sigma; velocity under the timed model).
        """
        if not detection.has_data():
            raise ValueError("frame has no detections")
        dd = detection.return_flattened_keys(
            self.target.point_data.shape[:-1]).get_data()
        if dd is None or not len(dd):
            raise ValueError("frame has no detections")
        if init is None:
            init = self._last_pose
        if init is None:
            init = self._pnp_seed(detection)
        if init is None:
            raise ValueError(
                "no PnP seed found and no init given for the first frame")
        init = self._widen_state(np.asarray(init, dtype=float))

        s = self._n_state
        cam_i, key_i, uv, mask = self._pack_frame(dd)
        out = self._fetch(self._solve_p(
            self._tensor(init), self._tensor(cam_i, torch.int64),
            self._tensor(key_i, torch.int64), self._tensor(uv),
            self._tensor(mask)))
        pose6, cost = out[:6], float(out[s])
        cov_unit = out[s + 3:s + 3 + s * s].reshape(s, s)
        self._last_pose = out[:s]
        n_used = int(mask.sum())
        dof = 2 * n_used - s
        if dof >= 1:
            pose_sigma = np.sqrt(np.clip(np.diag(cov_unit)[:6] * cost / dof,
                                         0.0, None))
            pose_sigma[~np.isfinite(pose_sigma)] = np.inf
        else:
            # the pose interpolates <= S/2 points: no error estimate
            pose_sigma = np.full(6, np.inf)
        info = {"rms": float(np.sqrt(cost / (2 * n_used))),
                "nit": int(out[s + 1]), "n_used": n_used,
                "status": int(out[s + 2]), "pose_sigma": pose_sigma}
        if self._timed:
            info["velocity"] = out[6:12]  # [rvec_dot | t_dot] per frame
        return make_4x4h_tform(pose6[:3], pose6[3:]), info

    def track_batch(self, detection: TargetDetection, inits=None,
                    seed_mode: str = "auto"):
        """Poses for EVERY image in the detection table, in one batched
        program.

        :param inits: (I, 6) / (I, 4, 4) seeds; default device seeding.
        :param seed_mode: with no ``inits``: ``"auto"`` seeds on the device
            (triangulation + rigid fit) and host-PnP-rescues a frame whose
            rms marks a failed solve (OpenCV only then); ``"device"`` skips
            the rescue; ``"pnp"`` seeds every frame by host PnP.
        :return: (poses (I, 4, 4), info dict of per-frame arrays: rms, nit,
            status, n_used, pose_sigma, pose_cov; velocity, velocity_sigma
            under the timed model).
        """
        if not detection.has_data():
            raise ValueError("detection table has no images")
        if seed_mode not in ("auto", "device", "pnp"):
            raise ValueError(f"unknown seed_mode {seed_mode!r}; expected "
                             "'auto', 'device' or 'pnp'")
        dd_all, bounds, n_frames, mask, dev_args = self._pack_table(detection)

        if inits is None and seed_mode in ("auto", "device"):
            uv_grid, mask_grid = self._obs_grids(dd_all, n_frames)
            out_d, seeds_d = self.core.solve_batch_seeded(
                self._tensor(uv_grid), self._tensor(mask_grid), *dev_args)
            out = self._fetch(out_d)
            if seed_mode == "auto":
                out = self._pnp_rescue(out, seeds_d, dd_all, bounds, mask,
                                       dev_args)
        else:
            if inits is not None:
                inits = np.asarray(inits, dtype=float)
                if inits.ndim == 3:  # (I, 4, 4)
                    inits = np.stack([np.concatenate(ext_4x4_to_rod(t))
                                      for t in inits])
                seeds = [self._widen_state(t) for t in inits]
            else:  # seed_mode == "pnp"
                seeds, last = [], None
                for i in range(n_frames):
                    seed = self._pnp_seed_rows(
                        dd_all[bounds[i]:bounds[i + 1]])
                    if seed is None:
                        seed = last if last is not None else np.zeros(6)
                    last = seed
                    seeds.append(self._widen_state(seed))
            out = self._fetch(self.core.solve_packed(
                self._tensor(np.stack(seeds)), *dev_args))
        return self._finalize_batch(out, mask)

    def track_stream(self, detection: TargetDetection, init=None):
        """Sequential warm-start tracking over a video: each frame's solve
        starts from the previous frame's state. Frames with fewer than S/2
        detections carry the state forward (inf rms and pose_sigma).

        :param init: 6-vector or 4x4 seed for the FIRST frame; default
            host PnP on the first frame any camera localises.
        :return: (poses (I, 4, 4), info dict as ``track_batch``'s).
        """
        if not detection.has_data():
            raise ValueError("detection table has no images")
        dd_all, bounds, n_frames, mask, dev_args = self._pack_table(detection)
        if init is None:
            for i in range(n_frames):
                init = self._pnp_seed_rows(dd_all[bounds[i]:bounds[i + 1]])
                if init is not None:
                    break
        if init is None:
            raise ValueError("no PnP seed found in any frame and no init "
                             "given for track_stream")
        out = self._fetch(self._solve_stream(
            self._tensor(self._widen_state(init)), *dev_args))
        # frames the warm start lost: PnP-reseed, keep the better solve
        out = self._pnp_rescue(out, out[:, :self._n_state], dd_all, bounds,
                               mask, dev_args)
        return self._finalize_batch(out, mask)

    def _pack_table(self, detection: TargetDetection):
        """Whole-table packing shared by the batch paths: flatten, sort by
        image where needed, one vectorised scatter into (I, N) arrays."""
        flat = detection.return_flattened_keys(
            self.target.point_data.shape[:-1])
        dd_all = flat.get_data()
        n_frames = int(detection.max_ims)
        n_max = self.max_detections
        if dd_all is None or not len(dd_all):
            dd_all = np.zeros((0, 5))
        elif np.any(np.diff(dd_all[:, 1]) < 0):
            dd_all = dd_all[np.argsort(dd_all[:, 1], kind="stable")]
        bounds = np.searchsorted(dd_all[:, 1], np.arange(n_frames + 1))
        im_col = dd_all[:, 1].astype(np.int64)
        pos = np.arange(len(dd_all)) - bounds[im_col]  # slot within frame
        keep = pos < n_max
        if not np.all(keep):
            logging.warning(
                f"{int((~keep).sum())} detections beyond the per-frame "
                f"capacity {n_max} truncated (raise max_detections)")
        cam_i = np.zeros((n_frames, n_max), np.int64)
        key_i = np.zeros((n_frames, n_max), np.int64)
        uv = np.zeros((n_frames, n_max, 2))
        mask = np.zeros((n_frames, n_max))
        r, c = im_col[keep], pos[keep]
        cam_i[r, c] = dd_all[keep, 0].astype(np.int64)
        key_i[r, c] = dd_all[keep, -3].astype(np.int64)
        uv[r, c] = dd_all[keep, -2:]
        mask[r, c] = 1.0
        dev_args = (self._tensor(cam_i, torch.int64),
                    self._tensor(key_i, torch.int64),
                    self._tensor(uv), self._tensor(mask))
        return dd_all, bounds, n_frames, mask, dev_args

    def _finalize_batch(self, out, mask):
        """Packed (I, W) rows [x | cost | nit | status | cov] -> the API
        (``ServingTracker`` calls it unbound with its own ``_n_state``)."""
        s = getattr(self, "_n_state", 6)
        pose6, cost = out[:, :6], out[:, s]
        cov_unit = out[:, s + 3:s + 3 + s * s].reshape(-1, s, s)
        self._last_pose = out[-1, :s]
        n_used = mask.sum(axis=1)
        rms = np.sqrt(cost / np.maximum(2 * n_used, 1))
        dof = 2 * n_used - s
        sigma2 = cost / np.maximum(dof, 1)
        sigma_all = np.sqrt(np.clip(
            np.einsum("fii->fi", cov_unit) * sigma2[:, None], 0.0, None))
        pose_sigma = sigma_all[:, :6]
        # underdetermined frames are unconstrained, not certain; degenerate
        # geometry keeps the inf sentinel instead of NaN
        pose_sigma[dof < 1] = np.inf
        pose_sigma[~np.isfinite(pose_sigma)] = np.inf
        # the 6x6 covariances feed smoothing.smooth_pose_trajectory; lost
        # frames are non-finite so the smoother coasts them
        pose_cov = cov_unit[:, :6, :6] * sigma2[:, None, None]
        pose_cov[dof < 1] = np.inf
        poses = np.stack([make_4x4h_tform(p[:3], p[3:]) for p in pose6])
        info = {"rms": rms, "nit": out[:, s + 1].astype(int),
                "status": out[:, s + 2].astype(int), "n_used": n_used,
                "pose_sigma": pose_sigma, "pose_cov": pose_cov}
        if s == 12:
            info["velocity"] = out[:, 6:12]      # [rvec_dot | t_dot]/frame
            vel_sigma = sigma_all[:, 6:12]
            vel_sigma[dof < 1] = np.inf
            info["velocity_sigma"] = vel_sigma
        return poses, info
