"""Closed-form residual + Jacobian for the template, self-calibration,
free-point and multi-target chains, for the five camera models, and for
heterogeneous rigs (fisheye beside Brown cameras) on the template,
self-calibration and free-point chains.

Counterpart of ``projection_partials``, ``block_rj_template``,
``block_rj_selfcal``, ``block_rj_freepoint``,
``block_rj_grouped_template``, ``block_rj_mixed_selfcal``, ``_het_split``,
``_het_merge`` and ``make_block_rj_het`` in
``pycamset_tpu/optim/analytic.py``. The JAX
functions work on one block and are vmapped over blocks; these take the
block axis (any leading dims) directly. Rotation derivatives come from the
closed-form ``ops.rotations.rodrigues_jacobian``, the tilted model's dMt
from ``ops.distortion.tilt_matrix_jacobian``, instead of ``jax.jacfwd``.

Derivative layout per slot: Jc (2, a) = [d/intr | d/extr6],
Ji (2, 6) = d/pose6, and Jk: (2, 0) for the template chain, (2, 3) =
d/point for the self-calibration chain, (2, 6) = d/group pose for the
grouped chain and (2, 9) = [d/group pose | d/point] for the mixed chain.
The intrinsic width selects the camera model: 9 standard, 12 rational, 16
thin-prism, 18 tilted, 8 fisheye. A heterogeneous camera vector [sel |
fx px fy py | dist slots | extr6] (``blocks.ProjectionHet``) has no kernel
in either package: ``block_rj_het`` evaluates the closed form at both
families' re-packings of every block and selects per camera, as the JAX
package runs it in XLA; no host read decides, so a captured LM step holds
it. Mixed Brown widths need nothing here: their chain is the widest
model's, with the narrower cameras' extra columns pinned by the column
mask.
"""
from __future__ import annotations

import torch

from pycamset_tpu_torch.ops.distortion import (tilt_matrix,
                                               tilt_matrix_jacobian)
from pycamset_tpu_torch.ops.rotations import (rodrigues_jacobian,
                                              rodrigues_to_matrix)

# intrinsic widths of the camera models
INTR_WIDTHS = (8, 9, 12, 16, 18)


def _check_intr_w(intr_w: int):
    if intr_w not in INTR_WIDTHS:
        raise NotImplementedError(
            f"intrinsic width {intr_w}: the camera models are {INTR_WIDTHS} "
            f"(fisheye 8, standard 9, rational 12, thin-prism 16, tilted "
            f"18); a heterogeneous rig's rows go through block_rj_het")


def projection_partials(intr: torch.Tensor, xc: torch.Tensor,
                        with_intr: bool = True):
    """Per-slot projection partials of any of the five camera models.

    :param intr: (..., intr_w) [fx, px, fy, py | dist coefs].
    :param xc: (..., K, 3) camera-frame points.
    :param with_intr: False skips d_intr (returned as None): a caller that
        holds the camera fixed (the tracker) needs d_xc alone.
    :return: (pred (..., K, 2), d_intr (..., K, 2, intr_w),
        d_xc (..., K, 2, 3))
    """
    intr_w = intr.shape[-1]
    _check_intr_w(intr_w)

    def c(i):
        return intr[..., i, None]

    fx, px, fy, py = c(0), c(1), c(2), c(3)
    inv_z = 1.0 / xc[..., 2]
    x = xc[..., 0] * inv_z
    y = xc[..., 1] * inv_z
    r2 = x * x + y * y
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)

    if intr_w == 8:
        xd, yd, jxd, jyd, dxd_dx, dxd_dy, dyd_dx, dyd_dy = _fisheye_tail(
            intr, x, y, r2)
    else:
        k1, k2, p1, p2, k3 = c(4), c(5), c(6), c(7), c(8)
        num = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dnum = k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2)
        if intr_w >= 12:  # rational model: radial is a polynomial ratio
            k4, k5, k6 = c(9), c(10), c(11)
            den = 1.0 + r2 * (k4 + r2 * (k5 + r2 * k6))
            dden = k4 + r2 * (2.0 * k5 + 3.0 * k6 * r2)
            inv_den = 1.0 / den
            radial = num * inv_den
            dradial = (dnum - radial * dden) * inv_den
        else:
            inv_den = 1.0
            radial = num
            dradial = dnum

        xy = x * y
        xd = x * radial + 2.0 * p1 * xy + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * xy
        if intr_w >= 16:  # thin-prism terms
            s1, s2, s3, s4 = c(12), c(13), c(14), c(15)
            xd = xd + r2 * (s1 + r2 * s2)
            yd = yd + r2 * (s3 + r2 * s4)

        # d(xd, yd)/d(dist coefs); the affine intrinsics fold in after the
        # tilt chain
        jxd, jyd = [], []
        if with_intr:
            jxd = [x * r2 * inv_den, x * r2 * r2 * inv_den, 2.0 * xy,
                   r2 + 2.0 * x * x, x * r2 ** 3 * inv_den]
            jyd = [y * r2 * inv_den, y * r2 * r2 * inv_den,
                   r2 + 2.0 * y * y, 2.0 * xy, y * r2 ** 3 * inv_den]
            if intr_w >= 12:
                for i in (1, 2, 3):
                    jxd.append(-x * radial * r2 ** i * inv_den)
                    jyd.append(-y * radial * r2 ** i * inv_den)
            if intr_w >= 16:
                jxd.extend([r2, r2 * r2, zero, zero])
                jyd.extend([zero, zero, r2, r2 * r2])

        # distorted-normalized wrt normalized
        dxd_dx = radial + 2.0 * x * x * dradial + 2.0 * p1 * y + 6.0 * p2 * x
        dxd_dy = 2.0 * xy * dradial + 2.0 * p1 * x + 2.0 * p2 * y
        dyd_dx = dxd_dy
        dyd_dy = radial + 2.0 * y * y * dradial + 6.0 * p1 * y + 2.0 * p2 * x
        if intr_w >= 16:  # the prism breaks the dyd_dx == dxd_dy symmetry
            dpx = s1 + 2.0 * s2 * r2
            dpy = s3 + 2.0 * s4 * r2
            dxd_dx = dxd_dx + 2.0 * x * dpx
            dxd_dy = dxd_dy + 2.0 * y * dpx
            dyd_dx = dyd_dx + 2.0 * x * dpy
            dyd_dy = dyd_dy + 2.0 * y * dpy

        if intr_w >= 18:  # tilted: everything through the homography
            mt = tilt_matrix(intr[..., 16], intr[..., 17])[..., None, :, :]
            dms = (tilt_matrix_jacobian(intr[..., 16], intr[..., 17])
                   if with_intr else ())

            def m(mat, i, j):
                return mat[..., i, j]

            iw = 1.0 / (m(mt, 2, 0) * xd + m(mt, 2, 1) * yd + m(mt, 2, 2))
            xtl = (m(mt, 0, 0) * xd + m(mt, 0, 1) * yd + m(mt, 0, 2)) * iw
            ytl = (m(mt, 1, 0) * xd + m(mt, 1, 1) * yd + m(mt, 1, 2)) * iw
            a00 = (m(mt, 0, 0) - xtl * m(mt, 2, 0)) * iw
            a01 = (m(mt, 0, 1) - xtl * m(mt, 2, 1)) * iw
            a10 = (m(mt, 1, 0) - ytl * m(mt, 2, 0)) * iw
            a11 = (m(mt, 1, 1) - ytl * m(mt, 2, 1)) * iw
            jxd, jyd = ([a00 * jx + a01 * jy for jx, jy in zip(jxd, jyd)],
                        [a10 * jx + a11 * jy for jx, jy in zip(jxd, jyd)])
            for dm in dms:
                dm = dm[..., None, :, :]
                dw = m(dm, 2, 0) * xd + m(dm, 2, 1) * yd + m(dm, 2, 2)
                jxd.append((m(dm, 0, 0) * xd + m(dm, 0, 1) * yd
                            + m(dm, 0, 2) - xtl * dw) * iw)
                jyd.append((m(dm, 1, 0) * xd + m(dm, 1, 1) * yd
                            + m(dm, 1, 2) - ytl * dw) * iw)
            dxd_dx, dxd_dy, dyd_dx, dyd_dy = (
                a00 * dxd_dx + a01 * dyd_dx, a00 * dxd_dy + a01 * dyd_dy,
                a10 * dxd_dx + a11 * dyd_dx, a10 * dxd_dy + a11 * dyd_dy)
            xd, yd = xtl, ytl

    pred = torch.stack([fx * xd + px, fy * yd + py], dim=-1)
    d_intr = None if not with_intr else torch.stack([
        torch.stack([xd, one, zero, zero] + [fx * j for j in jxd], dim=-1),
        torch.stack([zero, zero, yd, one] + [fy * j for j in jyd], dim=-1),
    ], dim=-2)
    # normalized wrt camera-frame: dx/dXc = [1/z, 0, -x/z]; dy = [0,1/z,-y/z]
    du_dx = fx * dxd_dx
    du_dy = fx * dxd_dy
    dv_dx = fy * dyd_dx
    dv_dy = fy * dyd_dy
    d_xc = torch.stack([
        torch.stack([du_dx * inv_z, du_dy * inv_z,
                     -(du_dx * x + du_dy * y) * inv_z], dim=-1),
        torch.stack([dv_dx * inv_z, dv_dy * inv_z,
                     -(dv_dx * x + dv_dy * y) * inv_z], dim=-1),
    ], dim=-2)
    return pred, d_intr, d_xc


def _fisheye_tail(intr8: torch.Tensor, x, y, r2):
    """The fisheye (Kannala-Brandt) point and partials: xd = x
    theta_d(theta) / r with theta = atan(r), the radius smoothed as in the
    forward map; s depends on the radius alone, so d(xd, yd)/d(x, y) is
    s I + g [x, y][x, y]^T with g = (ds/dr) / r.

    :return: (xd, yd, the four coefficient columns of xd and of yd,
        dxd_dx, dxd_dy, dyd_dx, dyd_dy)."""
    k1, k2, k3, k4 = (intr8[..., i, None] for i in range(4, 8))
    r = torch.sqrt(r2 + 1e-18)
    inv_r = 1.0 / r
    theta = torch.atan(r)
    t2 = theta * theta
    poly = 1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))
    s = theta * poly * inv_r
    # d theta_d / d k_i = theta^(2i + 1)
    jxd, jyd = [], []
    tp = t2 * theta
    for _ in range(4):
        jxd.append(x * tp * inv_r)
        jyd.append(y * tp * inv_r)
        tp = tp * t2
    # dtheta/dr = 1/(1 + r^2); dtheta_d/dtheta = poly + theta poly'
    dtheta_d = poly + 2.0 * t2 * (k1 + t2 * (2.0 * k2
                                             + t2 * (3.0 * k3
                                                     + t2 * 4.0 * k4)))
    g = (dtheta_d / (1.0 + r2) - s) * inv_r * inv_r
    dxd_dy = x * y * g
    return (s * x, s * y, jxd, jyd, s + x * x * g, dxd_dy, dxd_dy,
            s + y * y * g)


def _rj_core(cam_a: torch.Tensor, pose6: torch.Tensor, pts: torch.Tensor,
             uv: torch.Tensor):
    """(r, Jc, Ji, d_xc, Re Rp) of Xc = Re (Rp X + tp) + te over blocks."""
    intr_w = cam_a.shape[-1] - 6
    _check_intr_w(intr_w)
    intr = cam_a[..., :intr_w]
    re = rodrigues_to_matrix(cam_a[..., intr_w:intr_w + 3])
    dre = rodrigues_jacobian(cam_a[..., intr_w:intr_w + 3])
    te = cam_a[..., intr_w + 3:]
    rp = rodrigues_to_matrix(pose6[..., :3])
    drp = rodrigues_jacobian(pose6[..., :3])
    tp = pose6[..., 3:]

    xw = torch.einsum("...ab,kb->...ka", rp, pts) + tp[..., None, :]
    xc = torch.einsum("...ab,...kb->...ka", re, xw) + te[..., None, :]
    pred, d_intr, d_xc = projection_partials(intr, xc)
    r = pred - uv

    # extrinsic: dXc/drve[j] = dRe[j] @ Xw ; dXc/dte = I
    dxc_drve = torch.einsum("...jab,...kb->...kaj", dre, xw)
    j_rve = torch.einsum("...kta,...kaj->...ktj", d_xc, dxc_drve)
    jc = torch.cat([d_intr, j_rve, d_xc], dim=-1)

    # pose: dXc/drvp[j] = Re @ dRp[j] @ X ; dXc/dtp = Re
    re_drp = torch.einsum("...ab,...jbc->...jac", re, drp)
    dxc_drvp = torch.einsum("...jab,kb->...kaj", re_drp, pts)
    j_rvp = torch.einsum("...kta,...kaj->...ktj", d_xc, dxc_drvp)
    j_tp = torch.einsum("...kta,...ab->...ktb", d_xc, re)
    ji = torch.cat([j_rvp, j_tp], dim=-1)
    return r, jc, ji, d_xc, re @ rp


def block_rj_template(cam_a: torch.Tensor, pose6: torch.Tensor,
                      tpl: torch.Tensor, uv: torch.Tensor):
    """Closed-form (r, Jc, Ji, Jk) for blocks of the template chain.

    :param cam_a: (..., a) [intr | extr6]. :param pose6: (..., 6).
    :param tpl: (K, 3) template points. :param uv: (..., K, 2).
    :return: r (..., K, 2), Jc (..., K, 2, a), Ji (..., K, 2, 6),
        Jk (..., K, 2, 0).
    """
    r, jc, ji, _, _ = _rj_core(cam_a, pose6, tpl, uv)
    return r, jc, ji, r.new_zeros(r.shape + (0,))


def block_rj_selfcal(cam_a: torch.Tensor, pose6: torch.Tensor,
                     points: torch.Tensor, uv: torch.Tensor):
    """Closed-form (r, Jc, Ji, Jk) for blocks of the self-calibration
    chain: the template chain with the free PER_KEY point in place of the
    template point, and Jk = d(u,v)/dXc @ (Re Rp).

    :param points: (K, 3) free target points. Other shapes as
        ``block_rj_template``; Jk is (..., K, 2, 3).
    """
    r, jc, ji, d_xc, rerp = _rj_core(cam_a, pose6, points, uv)
    jk = torch.einsum("...kta,...ab->...ktb", d_xc, rerp)
    return r, jc, ji, jk


def block_rj_freepoint(cam_a: torch.Tensor, pose6, points: torch.Tensor,
                       uv: torch.Tensor):
    """Closed-form (r, Jc, Ji, Jk) for blocks of the pose-free free-point
    chain: Xc = Re X + te, Ji zero-width, Jk = d(u,v)/dXc Re.

    :param pose6: not read (the chain has no image parameters).
        Other shapes as ``block_rj_selfcal``; Ji is (..., K, 2, 0).
    """
    intr_w = cam_a.shape[-1] - 6
    _check_intr_w(intr_w)
    re = rodrigues_to_matrix(cam_a[..., intr_w:intr_w + 3])
    dre = rodrigues_jacobian(cam_a[..., intr_w:intr_w + 3])
    xc = (torch.einsum("...ab,kb->...ka", re, points)
          + cam_a[..., None, intr_w + 3:])
    pred, d_intr, d_xc = projection_partials(cam_a[..., :intr_w], xc)
    r = pred - uv
    dxc_drve = torch.einsum("...jab,kb->...kaj", dre, points)
    j_rve = torch.einsum("...kta,...kaj->...ktj", d_xc, dxc_drve)
    jc = torch.cat([d_intr, j_rve, d_xc], dim=-1)
    jk = torch.einsum("...kta,...ab->...ktb", d_xc, re)
    return r, jc, r.new_zeros(r.shape + (0,)), jk


def _group_rj(cam_a, pose6, grp6, pts, uv):
    """(r, Jc, Ji, [J_rvg | J_tg], d_xc, Re Rp, Rg) of
    Xc = Re (Rp (Rg X + tg) + tp) + te, with the per-key group poses
    ``grp6`` (K, 6) and points ``pts`` (K, 3)."""
    rg = rodrigues_to_matrix(grp6[:, :3])                  # (K,3,3)
    drg = rodrigues_jacobian(grp6[:, :3])                  # (K,3,3,3)
    xg = torch.einsum("kab,kb->ka", rg, pts) + grp6[:, 3:]
    r, jc, ji, d_xc, rerp = _rj_core(cam_a, pose6, xg, uv)
    # group pose: dXc/drvg[j] = Re Rp dRg[j] X ; dXc/dtg = Re Rp
    drg_x = torch.einsum("kjbc,kc->kjb", drg, pts)         # (K,3,3)
    dxc_drvg = torch.einsum("...ab,kjb->...kaj", rerp, drg_x)
    j_rvg = torch.einsum("...kta,...kaj->...ktj", d_xc, dxc_drvg)
    j_tg = torch.einsum("...kta,...ab->...ktb", d_xc, rerp)
    return r, jc, ji, torch.cat([j_rvg, j_tg], dim=-1), d_xc, rerp, rg


def block_rj_grouped_template(cam_a: torch.Tensor, pose6: torch.Tensor,
                              keyp6: torch.Tensor, tpl: torch.Tensor,
                              uv: torch.Tensor):
    """Closed-form (r, Jc, Ji, Jk) for blocks of the multi-target (grouped)
    template chain: the template point pre-transformed by a per-GROUP
    SE(3), expanded to one 6-row per key by the group one-hot.

    :param keyp6: (K, 6) per-key group poses [rvec | t]. :param tpl: (K, 3).
        Other shapes as ``block_rj_template``; Jk is (..., K, 2, 6),
        [d/rvg | d/tg].
    """
    r, jc, ji, jk, _, _, _ = _group_rj(cam_a, pose6, keyp6, tpl, uv)
    return r, jc, ji, jk


def block_rj_mixed_selfcal(cam_a: torch.Tensor, pose6: torch.Tensor,
                           keyp: torch.Tensor, uv: torch.Tensor):
    """Closed-form (r, Jc, Ji, Jk) for blocks of the MIXED multi-target
    self-calibration chain: free PER_KEY points pre-transformed by a
    per-GROUP SE(3) (expanded per key), then the per-image pose.

    :param keyp: (K, 9) c-axis rows in chain order [group pose 6 | point 3].
    :return: Jk (..., K, 2, 9) in the same order; the point columns are
        d(u,v)/dXc (Re Rp Rg).
    """
    r, jc, ji, jg, d_xc, rerp, rg = _group_rj(cam_a, pose6, keyp[:, :6],
                                              keyp[:, 6:9], uv)
    m_k = torch.einsum("...ab,kbc->...kac", rerp, rg)
    j_pt = torch.einsum("...kta,...kab->...ktb", d_xc, m_k)
    return r, jc, ji, torch.cat([jg, j_pt], dim=-1)


def _het_split(cam_a: torch.Tensor, brown_n_dist: int):
    """Heterogeneous camera vectors [sel | fx px fy py | dist | extr6]
    (..., a) -> (fisheye selector (..., 1, 1, 1) bool, the Brown
    re-packing [intr | extr6], the fisheye one)."""
    kvec, dist, extr = cam_a[..., 1:5], cam_a[..., 5:-6], cam_a[..., -6:]
    cam_brown = torch.cat([kvec, dist[..., :brown_n_dist], extr], dim=-1)
    cam_fish = torch.cat([kvec, dist[..., :4], extr], dim=-1)
    return cam_a[..., 0, None, None, None] > 0.5, cam_brown, cam_fish


def _het_merge(fish, out_b, out_f, w_d: int):
    """Select each block's family outputs and embed Jc in the
    heterogeneous column layout [sel | shared 4 | dist w_d | extr6] (the
    selector column zero, a fisheye camera's pad slots zero)."""
    (r_b, jc_b, ji_b, jk_b), (r_f, jc_f, ji_f, jk_f) = out_b, out_f
    z1 = jc_b.new_zeros(jc_b.shape[:-1] + (1,))
    pad_f = jc_f.new_zeros(jc_f.shape[:-1] + (w_d - 4,))
    jc_bf = torch.cat([z1, jc_b], dim=-1)
    jc_ff = torch.cat([z1, jc_f[..., :8], pad_f, jc_f[..., 8:]], dim=-1)
    return (torch.where(fish[..., 0], r_f, r_b),
            torch.where(fish, jc_ff, jc_bf), torch.where(fish, ji_f, ji_b),
            torch.where(fish, jk_f, jk_b))


_HET_INNER = {"template": block_rj_template, "selfcal": block_rj_selfcal,
              "freepoint": block_rj_freepoint}


def block_rj_het(family: str, brown_n_dist: int):
    """The closed form of a heterogeneous rig's chain: fn(cam_a (..., a),
    pose6, keyp_or_tpl (K, 3), uv (..., K, 2)) -> (r, Jc, Ji, Jk), the
    chain's own closed form (``family``: "template", "selfcal" or
    "freepoint") evaluated on both family re-packings of every block and
    selected per block. Both branches stay finite on the other family's
    coefficients (polynomials, atan), so the select is NaN-safe."""
    inner = _HET_INNER[family]

    def rj(cam_a, pose6, pts, uv):
        w_d = cam_a.shape[-1] - 11
        fish, cam_b, cam_f = _het_split(cam_a, brown_n_dist)
        return _het_merge(fish, inner(cam_b, pose6, pts, uv),
                          inner(cam_f, pose6, pts, uv), w_d)

    return rj
