"""Temporal synchronisation of a calibrated multi-camera rig.

Counterpart of ``pycamset_tpu/calibration/sync.py``. A rig without
genlock samples the scene at per-camera times

    t_cj = j + d_c + s_c * (j - j_mid)        [frame units]

with an unknown sub-frame offset ``d_c`` and, for free-running clocks, a
frame-rate skew ``s_c``. A moving target makes both observable: a clock
error shows as a reprojection error proportional to the image-plane
velocity. :func:`calibrate_time_offsets` estimates the clocks jointly with
the target's trajectory from one moving-target capture:

1. integer frame shifts (``max_shift > 0``) by normalised cross-correlation
   of per-camera image-plane speed signals (host numpy);
2. the trajectory's start from the port's ``TargetTracker.track_batch`` on
   the integer-aligned table, Rodrigues-unwrapped and gap-filled (host);
3. one Levenberg-Marquardt solve over ``[pose knots (I, 6) | offsets |
   skews | readouts]`` on the tensors' device (``optim/lm.lm_solve_device``:
   masked steps, no host read in the loop). The pose at time t linearly
   interpolates its two bracketing knots, so each (camera, frame) cell
   touches two knot blocks and its camera's clock. Each cell's 14 x 14
   gram over q = [X_f | X_f1 | tau | readout] comes from the closed-form
   Jacobian of the residual in the interpolated pose (the tracker's
   ``rig_projection_partials``, Rodrigues' derivative), scaled by the
   interpolation's chain rule; the JAX package takes ``jax.jacfwd`` there.
   One-hot contractions onto the knot axis assemble the block-tridiagonal
   pose system, the (6I, E) clock coupling and the E x E clock block (no
   scatter-add: a float32 atomic sum would make the result depend on the
   order of the adds), then the dense (6I + E) system.

Gauge: camera 0 is the time base (d_0 = s_0 = 0). A weak first-difference
prior on the knots (relative weight ``prior_lambda``) resolves time bins no
camera observes. The clock covariance comes from a Schur elimination of the
knots with the reference's ridges.
"""
from __future__ import annotations

import logging
import time
from typing import NamedTuple

import numpy as np
import torch

from pycamset_tpu_torch.config import default_device_dtype, resolve_device
from pycamset_tpu_torch.ops.rotations import (rodrigues_jacobian,
                                              rodrigues_to_matrix)
from pycamset_tpu_torch.tracking import rig_projection_partials
from pycamset_tpu_torch.utils.general_utils import (ext_4x4_to_rod,
                                                    make_4x4h_tform)


class SyncResult(NamedTuple):
    """Result of :func:`calibrate_time_offsets`.

    offsets / skew / readout are in FRAME units (camera 0's offset and
    skew pinned to 0; readout has no gauge freedom and is estimated for
    every camera); ``info`` carries seconds when ``fps`` was given, plus
    diagnostics.
    """
    offsets: np.ndarray          # (C,) frames; offsets[0] == 0 (gauge)
    offset_sigma: np.ndarray     # (C,) 1-sigma, frames
    skew: np.ndarray | None      # (C,) frames/frame, or None
    skew_sigma: np.ndarray | None
    readout: np.ndarray | None   # (C,) rolling-shutter readout, frames
    readout_sigma: np.ndarray | None
    rms: float                   # reprojection rms (px) at the solution
    info: dict


def _obs_grids(detection, target, n_cams: int, n_ims: int, dtype):
    """Detection table -> dense (C, I, K, 2) uv + (C, I, K) mask grids."""
    flat = detection.return_flattened_keys(target.point_data.shape[:-1])
    dd = flat.get_data()
    k = int(np.prod(target.point_data.shape[:-1]))
    uv = np.zeros((n_cams, n_ims, k, 2), dtype=dtype)
    mask = np.zeros((n_cams, n_ims, k), dtype=dtype)
    if dd is not None and len(dd):
        ci = dd[:, 0].astype(int)
        ji = dd[:, 1].astype(int)
        ki = dd[:, -3].astype(int)
        uv[ci, ji, ki] = dd[:, -2:]
        mask[ci, ji, ki] = 1.0
    return uv, mask, dd


def estimate_integer_shifts(uv: np.ndarray, mask: np.ndarray,
                            max_shift: int, min_overlap: int = 8,
                            ratios: np.ndarray | None = None
                            ) -> np.ndarray:
    """Integer frame shifts from image-plane speed cross-correlation.

    The per-frame centroid of a camera's detections moves with the target;
    its speed profile is (up to projection) the same time signal in every
    camera. The lag maximising the normalised cross-correlation against
    camera 0's profile is the integer part of that camera's offset.

    :param ratios: per-camera frame-duration ratios (``fps_ref / fps_c``)
        for mixed-rate rigs: each camera's speed profile (per unit time)
        is resampled onto the reference frame grid before correlating.
    :returns: (C,) integer shifts m (reference frames) with
        signal_c(t) ~ signal_0(t + m).
    """
    n_cams, n_ims = mask.shape[:2]
    cnt = mask.sum(axis=-1)                                   # (C, J)
    cen = (uv * mask[..., None]).sum(axis=2) \
        / np.maximum(cnt, 1.0)[..., None]                     # (C, J, 2)
    has = cnt >= 3
    vel = np.linalg.norm(np.diff(cen, axis=1), axis=-1)       # (C, J-1)
    ok = has[:, 1:] & has[:, :-1]
    if ratios is not None and not np.allclose(ratios, 1.0):
        # per-time speed samples (at t = (j + 1/2) ratio) onto the
        # reference half-frame grid
        t_ref = np.arange(n_ims - 1) + 0.5
        vel_r = np.zeros((n_cams, n_ims - 1))
        ok_r = np.zeros((n_cams, n_ims - 1), dtype=bool)
        for c in range(n_cams):
            tv = (np.arange(n_ims - 1) + 0.5) * ratios[c]
            good = ok[c]
            if good.sum() < 2:
                continue
            vel_r[c] = np.interp(t_ref, tv[good],
                                 vel[c][good] / max(ratios[c], 1e-12))
            ok_r[c] = (t_ref >= tv[good][0]) & (t_ref <= tv[good][-1])
        vel, ok = vel_r, ok_r

    def znorm(sig, valid):
        v = sig[valid]
        if v.size < 2 or np.std(v) < 1e-12:
            return None
        out = np.zeros_like(sig)
        out[valid] = (v - v.mean()) / v.std()
        return out

    ref = znorm(vel[0], ok[0])
    if ref is None:
        raise ValueError(
            "camera 0 has no usable motion signal (too few frames with "
            ">= 3 detections, or a static target) — cannot estimate "
            "integer shifts; capture a moving target")
    shifts = np.zeros(n_cams, dtype=int)
    for c in range(1, n_cams):
        sig = znorm(vel[c], ok[c])
        if sig is None:
            logging.warning("camera %d has no motion signal; integer "
                            "shift left at 0", c)
            continue
        best, best_score = 0, -np.inf
        for m in range(-max_shift, max_shift + 1):
            # overlap of cam c's frame j with cam 0's frame j + m
            lo, hi = max(0, -m), min(len(sig), len(ref) - m)
            if hi - lo < min_overlap:
                continue
            both = ok[c][lo:hi] & ok[0][lo + m:hi + m]
            if both.sum() < min_overlap:
                continue
            a = sig[lo:hi][both]
            b = ref[lo + m:hi + m][both]
            sa, sb = np.std(a), np.std(b)
            if sa < 1e-12 or sb < 1e-12:
                continue
            score = float(np.mean((a - a.mean()) * (b - b.mean()))
                          / (sa * sb))
            if score > best_score:
                best, best_score = m, score
        shifts[c] = best
    return shifts


class SyncModel:
    """The joint trajectory-and-clock problem's device programs.

    Constants live on ``device`` in ``dtype``: per-camera packed
    intrinsics, extrinsic rotations and translations (from the Rodrigues
    6-vectors, as the reference evaluates them), the template, and the
    per-camera frame-time grid. Parameters p = [X (I * 6) | d (C - 1) |
    s (C - 1, with skew) | readout (C, with rolling shutter)].
    """

    def __init__(self, intr, extr6, tpl, ratios, n_knots: int, n_ims: int,
                 *, het: bool, n_brown: int, estimate_skew: bool,
                 estimate_rolling_shutter: bool, loss: str, f_scale: float,
                 prior_lambda: float, device, dtype):
        from pycamset_tpu_torch.optim.losses import make_loss

        def dev(a):
            return torch.as_tensor(np.asarray(a, dtype=float), dtype=dtype,
                                   device=device)
        self.intr = dev(intr)
        extr6 = dev(extr6)
        self.re = rodrigues_to_matrix(extr6[:, :3])          # (C, 3, 3)
        self.te = extr6[:, 3:]
        self.tpl = dev(tpl)
        self.n_cams = int(self.intr.shape[0])
        self.n_knots, self.n_ims = int(n_knots), int(n_ims)
        self.het, self.n_brown = het, n_brown
        self.skew, self.rs = estimate_skew, estimate_rolling_shutter
        self.rho_fn, self.weight_fn = make_loss(loss, f_scale)
        self.robust = loss != "linear"
        self.prior_lambda = float(prior_lambda)
        self.n_off = self.n_cams - 1
        self.n_pose = 6 * self.n_knots
        self.n_e = (self.n_off * (2 if estimate_skew else 1)
                    + (self.n_cams if estimate_rolling_shutter else 0))
        jmid = (self.n_knots - 1) / 2.0
        # camera c's frame counter on the reference (camera 0) timeline
        j_idx = torch.arange(self.n_ims, dtype=dtype, device=device)
        self.t_nom = dev(ratios)[:, None] * j_idx[None, :]     # (C, J)
        self.trel = self.t_nom - jmid        # skew lever, mid-capture 0

    def split(self, p):
        """p -> (knots (I, 6), offsets (C,), skews (C,), readouts (C,))."""
        zero = p.new_zeros(1)
        x = p[:self.n_pose].reshape(self.n_knots, 6)
        pos = self.n_pose
        d = torch.cat([zero, p[pos:pos + self.n_off]])
        pos += self.n_off
        if self.skew:
            s = torch.cat([zero, p[pos:pos + self.n_off]])
            pos += self.n_off
        else:
            s = p.new_zeros(self.n_cams)
        rs = (p[pos:pos + self.n_cams] if self.rs
              else p.new_zeros(self.n_cams))
        return x, d, s, rs

    def cells(self, p, uv, mask, rho):
        """The per (camera, frame) cell pieces over q = [X_f | X_f1 | tau
        | readout]: (knots (I, 6), gram (C, J, 14, 14), gradient
        (C, J, 14), cost (C, J), knot index f (C, J))."""
        x, d, s, rs = self.split(p)
        t = self.t_nom + d[:, None] + s[:, None] * self.trel
        in_range = ((t >= 0.0) & (t <= self.n_knots - 1.0)).to(p.dtype)
        f = torch.clamp(torch.floor(t), 0, self.n_knots - 2).to(torch.int64)
        w = torch.clamp(t - f.to(p.dtype), 0.0, 1.0)          # (C, J)
        xf, xf1 = x[f], x[f + 1]                              # (C, J, 6)
        mask = mask * in_range[..., None]
        dx = xf1 - xf
        # each key's sampling time within the frame (the row phase rho)
        wk = w[..., None] + rs[:, None, None] * rho           # (C, J, K)
        p6 = xf[:, :, None, :] + wk[..., None] * dx[:, :, None, :]
        rp = rodrigues_to_matrix(p6[..., :3])
        drp = rodrigues_jacobian(p6[..., :3])                 # (.., j, a, b)
        pts = self.tpl
        world = torch.sum(rp * pts[:, None, :], dim=-1) + p6[..., 3:]
        re = self.re[:, None, None]                           # (C,1,1,3,3)
        xc = torch.sum(re * world[..., None, :], dim=-1) \
            + self.te[:, None, None]
        z = xc[..., 2]
        # masked keys can sit behind the camera: keep 1/z finite so a
        # masked residual never makes a NaN
        z_ok = torch.abs(z) > 1e-6
        xc = torch.cat([xc[..., :2], torch.where(
            z_ok, z, torch.full_like(z, 1e-6))[..., None]], dim=-1)
        intr = self.intr[:, None, None].expand(xc.shape[:-1]
                                               + self.intr.shape[-1:])
        pred, d_xc = rig_projection_partials(intr, xc, self.het,
                                             self.n_brown)
        d_xc = torch.cat([d_xc[..., :2], d_xc[..., 2:]
                          * z_ok[..., None, None].to(p.dtype)], dim=-1)
        r = pred - uv                                         # (C,J,K,2)
        # d r / d p6: d pred / d t = d_xc Re; / d rv_j = d_xc Re dRp[j] X
        d_t = torch.sum(d_xc[..., :, :, None] * re[..., None, :, :], dim=-2)
        u = torch.sum(drp * pts[:, None, None, :], dim=-1)    # (.., j, 3)
        d_rv = torch.sum(d_t[..., :, None, :] * u[..., None, :, :], dim=-1)
        jp6 = torch.cat([d_rv, d_t], dim=-1)                  # (C,J,K,2,6)
        jtau = torch.sum(jp6 * dx[:, :, None, None, :], dim=-1)
        wk2 = wk[..., None, None]
        jq = torch.cat([(1.0 - wk2) * jp6, wk2 * jp6, jtau[..., None],
                        (rho[..., None] * jtau)[..., None]], dim=-1)
        if self.robust:
            ssq = torch.sum(r * r, dim=-1)
            cost = torch.sum(self.rho_fn(ssq) * mask, dim=-1)
            mw = mask * torch.sqrt(self.weight_fn(ssq))
        else:
            cost = torch.sum(r * r * mask[..., None], dim=(-2, -1))
            mw = mask
        jm = (jq * mw[..., None, None]).reshape(jq.shape[:2] + (-1, 14))
        rm = (r * mw[..., None]).reshape(r.shape[:2] + (-1,))
        a = jm.transpose(-1, -2) @ jm                         # (C,J,14,14)
        g = torch.sum(jm * rm[..., None], dim=-2)             # (C,J,14)
        return x, a, g, cost, f

    def data_cost(self, p, uv, mask, rho):
        """The reprojection cost at p (the prior is left out: it must not
        enter the reported pixel rms)."""
        return torch.sum(self.cells(p, uv, mask, rho)[3])

    def neq(self, p, uv, mask, rho):
        """(JtJ, grad, cost) of the full problem at p, dense."""
        x, a, g, costs, f = self.cells(p, uv, mask, rho)
        n_i, dt = self.n_knots, p.dtype
        # knot memberships: one-hot contractions, no scatter-add
        of = torch.nn.functional.one_hot(f, n_i).to(dt)       # (C, J, I)
        of1 = torch.nn.functional.one_hot(f + 1, n_i).to(dt)
        # pose blocks: the interpolation weights already live inside the
        # cell grams, so the assembly is membership only
        dblk = (torch.einsum("cji,cjab->iab", of, a[..., :6, :6])
                + torch.einsum("cji,cjab->iab", of1, a[..., 6:12, 6:12]))
        oblk = torch.einsum("cji,cjab->iab", of, a[..., :6, 6:12])
        gx = (torch.einsum("cji,cja->ia", of, g[..., :6])
              + torch.einsum("cji,cja->ia", of1, g[..., 6:12]))

        # weak first-difference smoothness prior: resolves unobserved bins
        lam = self.prior_lambda * torch.clamp(torch.max(torch.abs(dblk)),
                                              min=1.0)
        eye6 = torch.eye(6, dtype=dt, device=p.device)
        ends = torch.full((n_i,), 2.0, dtype=dt, device=p.device)
        ends[0] = ends[-1] = 1.0
        dblk = dblk + lam * ends[:, None, None] * eye6
        not_last = torch.ones(n_i, dtype=dt, device=p.device)
        not_last[-1] = 0.0
        oblk = oblk - lam * not_last[:, None, None] * eye6
        diff = x[1:] - x[:-1]
        zrow = diff.new_zeros(1, 6)
        gp = lam * (torch.cat([zrow, diff]) - torch.cat([diff, zrow]))
        cost_prior = lam * torch.sum(diff * diff)

        # clock couplings from the tau / readout gram columns
        ctau = a[..., :12, 12]                                # (C, J, 12)
        htt = a[..., 12, 12]                                  # (C, J)
        gtau = g[..., 12]
        trel = self.trel

        def pose_clock(col):                                  # -> (I, C, 6)
            return (torch.einsum("cji,cja->ica", of, col[..., :6])
                    + torch.einsum("cji,cja->ica", of1, col[..., 6:12]))

        wd = pose_clock(ctau)
        w_cols = [wd[:, 1:, :]]
        ge_parts = [torch.sum(gtau, dim=1)[1:]]
        hee_rows = [[torch.diag(torch.sum(htt, dim=1)[1:])]]
        if self.skew:
            ws = pose_clock(ctau * trel[:, :, None])
            w_cols.append(ws[:, 1:, :])
            hds = torch.diag(torch.sum(htt * trel, dim=1)[1:])
            hss = torch.diag(torch.sum(htt * trel ** 2, dim=1)[1:])
            hee_rows[0].append(hds)
            hee_rows.append([hds, hss])
            ge_parts.append(torch.sum(gtau * trel, dim=1)[1:])
        if self.rs:
            wr = pose_clock(a[..., :12, 13])
            w_cols.append(wr)                                 # all C cams
            htr = torch.diag(torch.sum(a[..., 12, 13], dim=1))  # (C, C)
            hrr = torch.diag(torch.sum(a[..., 13, 13], dim=1))
            hee_rows[0].append(htr[1:, :])
            if self.skew:
                hsr = torch.diag(torch.sum(a[..., 12, 13] * trel, dim=1))
                hee_rows[1].append(hsr[1:, :])
                hee_rows.append([htr[:, 1:], hsr[:, 1:], hrr])
            else:
                hee_rows.append([htr[:, 1:], hrr])
            ge_parts.append(torch.sum(g[..., 13], dim=1))
        hee = torch.cat([torch.cat(row, dim=1) for row in hee_rows], dim=0)

        # dense assembly: block-tridiagonal pose system + clock arrow
        n_pose = self.n_pose
        mp = p.new_zeros(n_i, 6, n_i, 6)
        idx = torch.arange(n_i, device=p.device)
        mp[idx, :, idx, :] = dblk
        mp[idx[:-1], :, idx[1:], :] = oblk[:-1]
        mp[idx[1:], :, idx[:-1], :] = oblk[:-1].transpose(-1, -2)
        mp = mp.reshape(n_pose, n_pose)
        w_all = torch.cat([wc.transpose(1, 2).reshape(n_pose, -1)
                           for wc in w_cols], dim=1)          # (6I, E)
        jtj = torch.cat([torch.cat([mp, w_all], dim=1),
                         torch.cat([w_all.T, hee], dim=1)], dim=0)
        grad = torch.cat([(gx + gp).reshape(-1), torch.cat(ge_parts)])
        return jtj, grad, torch.sum(costs) + cost_prior

    def solve(self, p0, uv, mask, rho, max_nfev: int):
        """The LM solve and the clock covariance by Schur elimination of
        the knots (the reference's ridges): (x, diag cov_e, data cost,
        nit, nfev, status) as device tensors, none read back."""
        from pycamset_tpu_torch.optim.lm import lm_solve_device

        def neq(q):
            return self.neq(q, uv, mask, rho)
        res = lm_solve_device(neq, p0, max_nfev=max_nfev)
        jtj = neq(res.x)[0]
        n_pose, n_e = self.n_pose, self.n_e
        mp = jtj[:n_pose, :n_pose]
        wp = jtj[:n_pose, n_pose:]
        hee = jtj[n_pose:, n_pose:]
        eye_p = torch.eye(n_pose, dtype=p0.dtype, device=p0.device)
        ridge_m = 1e-12 * torch.clamp(torch.max(torch.diagonal(mp)), min=1.0)
        sol = torch.linalg.solve_ex(mp + ridge_m * eye_p, wp)[0]
        s_e = hee - wp.T @ sol
        ridge_e = 1e-12 * torch.clamp(
            torch.max(torch.abs(torch.diagonal(s_e))), min=1.0)
        eye_e = torch.eye(n_e, dtype=p0.dtype, device=p0.device)
        cov_e = torch.linalg.inv_ex(s_e + ridge_e * eye_e)[0]
        return (res.x, torch.diagonal(cov_e),
                self.data_cost(res.x, uv, mask, rho), res.nit, res.nfev,
                res.status)


def calibrate_time_offsets(camset, detection, target, *,
                           estimate_skew: bool = False,
                           estimate_rolling_shutter: bool = False,
                           max_shift: int = 0,
                           fps: float | None = None,
                           frame_rates=None,
                           loss: str = "linear", f_scale: float = 1.0,
                           max_nfev: int = 100,
                           prior_lambda: float = 1e-6,
                           min_track_detections: int = 6,
                           device="cuda", dtype=None) -> SyncResult:
    """Estimate per-camera time offsets (and optionally rate skew and
    rolling-shutter readout) from a moving-target capture against a
    calibrated rig.

    :param camset: calibrated CameraSet (all camera parameters fixed).
    :param detection: TargetDetection over the capture; frame index ``im``
        is each camera's own frame counter.
    :param target: the calibration target (template from point_data).
    :param estimate_skew: also estimate a per-camera frame-rate skew
        (frames per frame, centred at mid-capture).
    :param estimate_rolling_shutter: also estimate a per-camera readout
        duration (frames): a detection on row v is sampled at
        ``t + readout * (v / height - 1/2)``; estimated for every camera.
    :param max_shift: maximum |integer| frame shift searched by signal
        cross-correlation before the joint solve (0: sub-frame offsets).
    :param fps: camera 0's frame rate; ``info`` then also reports seconds.
    :param frame_rates: per-camera frame rates (C,) for mixed-rate rigs;
        every camera's counter maps onto camera 0's timeline.
    :param prior_lambda: relative weight of the knot smoothness prior.
    :param device: where the tracker and the joint solve run (the card
        unless the caller names another); :param dtype: default float64
        on the CPU, float32 on a card.
    :returns: :class:`SyncResult`, offsets in frames, camera 0 == 0.
    """
    from pycamset_tpu_torch.models.detections import TargetDetection
    from pycamset_tpu_torch.ops.projection import pack_rig_intrinsics
    from pycamset_tpu_torch.smoothing import unwrap_rvecs
    from pycamset_tpu_torch.tracking import TargetTracker, rig_family

    device = resolve_device(device)
    tdtype = dtype or default_device_dtype(device)
    dtype = np.float64 if tdtype == torch.float64 else np.float32
    names = camset.get_names()
    n_cams = len(names)
    if n_cams < 2:
        raise ValueError("temporal calibration needs >= 2 cameras (one "
                         "camera defines the time base)")
    n_ims = int(detection.max_ims)
    if n_ims < 4:
        raise ValueError("temporal calibration needs a capture of >= 4 "
                         f"frames; got {n_ims}")
    uv_g, mask_g, dd = _obs_grids(detection, target, n_cams, n_ims, dtype)
    if dd is None or not len(dd):
        raise ValueError("detection table is empty")

    # mixed-rate rigs: camera c's frame j sits at j * ratio_c on camera
    # 0's timeline; the knots cover the longest span
    if frame_rates is not None:
        rates = np.broadcast_to(
            np.asarray(frame_rates, dtype=float), (n_cams,))
        if np.any(rates <= 0):
            raise ValueError(f"frame_rates must be positive; got {rates}")
        ratios = rates[0] / rates
    else:
        ratios = np.ones(n_cams)
    cam_col = dd[:, 0].astype(int)
    spans = np.zeros(n_cams)
    for c in range(n_cams):
        sel = dd[cam_col == c]
        if len(sel):
            spans[c] = sel[:, 1].max() * ratios[c]
    n_knots = max(int(np.ceil(spans.max())) + 1, 2)

    # -- step 1: integer shifts
    shifts = np.zeros(n_cams, dtype=int)
    if max_shift > 0:
        shifts = estimate_integer_shifts(uv_g, mask_g, max_shift,
                                         ratios=ratios)

    # -- step 2: trajectory start from the tracker on the aligned table
    # (frames bin to the nearest reference-timeline knot)
    im_new = (np.rint(dd[:, 1] * ratios[cam_col]).astype(int)
              + shifts[cam_col])
    keep = (im_new >= 0) & (im_new < n_knots)
    dd2 = dd[keep].copy()
    dd2[:, 1] = im_new[keep]
    tracker = TargetTracker(camset, target, loss=loss, f_scale=f_scale,
                            device=device, dtype=tdtype)
    poses, tinfo = tracker.track_batch(
        TargetDetection(cam_names=names, data=dd2))
    n_tracked = poses.shape[0]
    x0 = np.zeros((n_knots, 6))
    valid = np.zeros(n_knots, dtype=bool)
    lim = min(n_knots, n_tracked)
    finite = np.isfinite(poses[:lim].reshape(lim, -1)).all(axis=1)
    valid[:lim] = (np.asarray(tinfo["n_used"][:lim])
                   >= min_track_detections) & finite
    for i in np.flatnonzero(valid):
        x0[i] = np.concatenate(ext_4x4_to_rod(poses[i]))
    if valid.sum() < 2:
        raise ValueError(
            f"target tracked in only {int(valid.sum())} frames — not "
            "enough to anchor a trajectory (check the rig calibration "
            "and detection coverage)")
    x0[:, :3] = unwrap_rvecs(x0[:, :3], valid=valid)
    anchors = np.flatnonzero(valid)
    holes = np.flatnonzero(~valid)
    for a in range(6):  # linear gap fill keeps untracked bins plausible
        x0[holes, a] = np.interp(holes, anchors, x0[anchors, a])

    # -- step 3: the joint solve on the device
    dists = [np.reshape(camset[n].distortion_coefs, -1) for n in names]
    intr_rows, _ = pack_rig_intrinsics(
        [camset[n].intrinsic for n in names], dists)
    het, n_brown = rig_family(dists)
    extr6 = np.stack([np.concatenate(ext_4x4_to_rod(camset[n].extrinsic))
                      for n in names])
    tpl = np.asarray(target.point_data.reshape(-1, 3), dtype=float)
    # per-detection row phase: a detection on row v is sampled
    # readout * rho later than mid-scan (rho from the OBSERVED row: data,
    # not a parameter)
    heights = np.array([float(np.ravel(camset[n].res)[1]) for n in names])
    rho_g = (uv_g[..., 1] / heights[:, None, None] - 0.5).astype(dtype)
    model = SyncModel(intr_rows.astype(dtype), extr6.astype(dtype),
                      tpl.astype(dtype), ratios.astype(dtype), n_knots,
                      n_ims, het=het, n_brown=n_brown,
                      estimate_skew=estimate_skew,
                      estimate_rolling_shutter=estimate_rolling_shutter,
                      loss=loss, f_scale=f_scale, prior_lambda=prior_lambda,
                      device=device, dtype=tdtype)
    n_off, n_pose, n_e = model.n_off, model.n_pose, model.n_e
    jmid = (n_knots - 1) / 2.0

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=tdtype, device=device)
    p0 = np.concatenate([
        x0.reshape(-1), shifts[1:].astype(float),
        np.zeros(n_off if estimate_skew else 0),
        np.zeros(n_cams if estimate_rolling_shutter else 0)]).astype(dtype)
    t_lm = time.perf_counter()
    pieces = model.solve(dev(p0), dev(uv_g), dev(mask_g), dev(rho_g),
                         max_nfev)
    # the one read-back of the solve
    x_all, diag_cov, cost, nit, nfev, status = (
        t.double().cpu().numpy() for t in pieces)
    lm_s = time.perf_counter() - t_lm
    x = x_all[:n_pose].reshape(n_knots, 6)
    e = x_all[n_pose:n_pose + n_e]
    cost, nit, nfev, status = float(cost), int(nit), int(nfev), int(status)

    offsets = np.zeros(n_cams)
    offsets[1:] = e[:n_off]
    skew = None
    pos = n_off
    if estimate_skew:
        skew = np.zeros(n_cams)
        skew[1:] = e[pos:pos + n_off]
        pos += n_off
    readout = None
    if estimate_rolling_shutter:
        readout = np.asarray(e[pos:pos + n_cams])
    # effective detections: within the valid time window at the solution
    j_idx = np.arange(n_ims, dtype=float)
    t_nom = ratios[:, None] * j_idx[None, :]
    t = t_nom + offsets[:, None]
    if skew is not None:
        t = t + skew[:, None] * (t_nom - jmid)
    in_range = (t >= 0.0) & (t <= n_knots - 1.0)
    n_det_eff = int((mask_g * in_range[..., None]).sum())
    dof = max(2 * n_det_eff - (n_pose + n_e), 1)
    sigma2 = cost / dof
    e_sigma = np.sqrt(np.clip(diag_cov, 0.0, None) * sigma2)
    offset_sigma = np.zeros(n_cams)
    offset_sigma[1:] = e_sigma[:n_off]
    skew_sigma = None
    pos = n_off
    if estimate_skew:
        skew_sigma = np.zeros(n_cams)
        skew_sigma[1:] = e_sigma[pos:pos + n_off]
        pos += n_off
    readout_sigma = None
    if estimate_rolling_shutter:
        readout_sigma = np.asarray(e_sigma[pos:pos + n_cams])
    rms = float(np.sqrt(cost / max(2 * n_det_eff, 1)))

    # observability diagnostic: median knot-to-knot motion
    dx = np.diff(x, axis=0)
    motion = {"rot_rad_per_frame": float(np.median(
        np.linalg.norm(dx[:, :3], axis=1))),
        "trans_per_frame": float(np.median(
            np.linalg.norm(dx[:, 3:], axis=1)))}
    if np.any(offset_sigma[1:] > 0.05):
        logging.warning(
            "temporal calibration is weakly observable (offset sigma up "
            "to %.2f frames) — the capture's motion is too slow or too "
            "short", float(np.max(offset_sigma[1:])))

    info = {
        "nit": nit, "nfev": nfev, "status": status, "cost": cost,
        "lm_seconds": lm_s, "n_detections": n_det_eff,
        "integer_shifts": shifts,
        "trajectory": np.stack([make_4x4h_tform(r[:3], r[3:]) for r in x]),
        "tracker_rms": tinfo["rms"], "motion": motion,
        "camera_names": list(names), "frame_rate_ratios": ratios,
        "n_knots": n_knots,
    }
    if fps is not None and fps > 0:
        info["offsets_s"] = offsets / fps
        info["offset_sigma_s"] = offset_sigma / fps
        if skew is not None:
            info["clock_rate_ppm"] = skew * 1e6  # frames/frame = s/s
        if readout is not None:
            info["readout_s"] = readout / fps
    return SyncResult(offsets, offset_sigma, skew, skew_sigma,
                      readout, readout_sigma, rms, info)


def format_sync_report(result: SyncResult, fps: float | None = None) -> str:
    """Human-readable rendering of a :class:`SyncResult`."""
    lines = [
        f"temporal calibration over {result.info['n_detections']} "
        f"detections: rms {result.rms:.3f} px, {result.info['nit']} "
        "iterations",
        " camera        offset(frames)     sigma"
        + ("      skew(ppm)" if result.skew is not None else "")
        + ("  readout(frames)" if result.readout is not None else ""),
    ]
    for i, n in enumerate(result.info["camera_names"]):
        row = (f" {n:<12} {result.offsets[i]:>+14.4f} "
               f"{result.offset_sigma[i]:>9.4f}")
        if result.skew is not None:
            row += f" {result.skew[i] * 1e6:>+14.2f}"
        if result.readout is not None:
            row += f" {result.readout[i]:>16.4f}"
        if i == 0:
            row += "   (time base)"
        lines.append(row)
    if fps is not None and fps > 0:
        ms = result.offsets / fps * 1e3
        lines.append(" offsets at {:.6g} fps: ".format(fps) + ", ".join(
            f"{n}={v:+.3f} ms" for n, v in
            zip(result.info["camera_names"], ms)))
    m = result.info["motion"]
    lines.append(
        f" capture motion: {m['rot_rad_per_frame'] * 1e3:.2f} mrad + "
        f"{m['trans_per_frame'] * 1e3:.3f} mm per frame (median)")
    return "\n".join(lines)
