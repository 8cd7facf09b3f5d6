"""Synthetic rig generation for benchmarks and tests.

Counterpart of ``pycamset_tpu/utils/synthetic.py``, line for line: the same
seed gives the same rig (``dd``, ``intr``, ``extr``, ``poses``,
``template``). Only the Rodrigues helpers differ (numpy here, cv2 there).

Builds a ground-truth multi-camera rig observing a planar grid target across
many poses, with optional visibility dropout and pixel noise. The observation
table matches the TargetDetection layout [cam, im, key, u, v].
"""
from __future__ import annotations

import numpy as np

from pycamset_tpu_torch.utils.general_utils import make_4x4h_tform, ext_4x4_to_rod


def look_at_extrinsic(position: np.ndarray, to: np.ndarray) -> np.ndarray:
    """A world->camera 4x4 whose +z axis looks from position to target."""
    z = to - position
    z = z / np.linalg.norm(z)
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(up, z)) > 0.95:
        up = np.array([0.0, 1.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    rot = np.stack([x, y, z])  # world->cam rows
    ext = np.eye(4)
    ext[:3, :3] = rot
    ext[:3, 3] = -rot @ position
    return ext


def make_synthetic_rig(n_cams: int = 16, n_ims: int = 100, grid: int = 19,
                       visibility: float = 0.85, noise_px: float = 0.3,
                       seed: int = 0, res=(1600, 1200),
                       camera_model: str = "standard",
                       pose_scale: tuple = (0.4, 0.15),
                       tangential_px: float = 5e-4,
                       template_depth: float = 0.0,
                       shared_intrinsics: bool = False,
                       template_warp: float = 0.0):
    """Generate a rig + observations.

    Cameras sit on a ring of radius ~1 m looking at the origin; the target
    (grid x grid corners, 20 mm pitch) moves through random poses near the
    origin. Observations outside the image or dropped by the visibility
    fraction are removed.

    camera_model="rational" generates 12-wide intrinsics with nonzero
    k4..k6 and projects through the rational radial model; "thin_prism"
    adds nonzero s1..s4 (16-wide); "tilted" adds taux/tauy (18-wide).

    template_warp (the port's own option, 0 by default) bends the board the
    cameras see away from the nominal one: each true point moves along the
    board normal (z) by a normal draw of that RMS (metres) from its own
    generator, ``default_rng(seed + 202)``, so every other draw, and the
    rig of the JAX package's generator with the same seed, stays as it is.
    The observations come from the true (warped) board; ``template`` stays
    the nominal one, and ``template_true`` is the warped one.

    :return: dict with intr (C,9/12/16/18), extr (C,6), poses (I,6),
        template (K,3), template_true (K,3), dd (N,5) observation table, and
        metadata.
    """
    rng = np.random.default_rng(seed)
    widths = {"standard": 9, "rational": 12, "thin_prism": 16,
              "tilted": 18, "fisheye": 8}
    # per-camera model list = a HETEROGENEOUS rig (fisheye + Brown mix);
    # intr rows pad to the widest family's width
    models = ([camera_model] * n_cams if isinstance(camera_model, str)
              else [str(m) for m in camera_model])
    if len(models) != n_cams:
        raise ValueError(f"camera_model list needs {n_cams} entries")
    het = len(set(models)) > 1
    camera_model = models[0] if not het else "het"
    intr_w = max(widths[m] for m in models)
    k = grid * grid
    tpl = np.stack(np.meshgrid(np.arange(grid), np.arange(grid)), -1).reshape(-1, 2)
    tpl = np.concatenate([(tpl - grid / 2) * 0.02, np.zeros((k, 1))], 1)
    if template_depth:
        # non-planar target: planar SELF-calibration (free intrinsics +
        # free geometry) carries a near-null mode beyond the 7-coordinate
        # similarity gauge (equilibrated JtJ cond ~5e16), which makes any
        # covariance at the solution meaningless; a little depth removes
        # the degeneracy for tests that need a well-posed system
        tpl[:, 2] = np.random.default_rng(seed + 101).uniform(
            -template_depth, template_depth, size=k)

    tpl_true = tpl.copy()
    if template_warp:
        tpl_true[:, 2] += np.random.default_rng(seed + 202).normal(
            size=k) * template_warp

    intr = np.zeros((n_cams, intr_w))
    extr = np.zeros((n_cams, 6))
    for c in range(n_cams):
        f = rng.uniform(1400, 1600)
        if models[c] == "fisheye":
            # wide lens: shorter focal, Kannala-Brandt angle polynomial
            f = rng.uniform(550, 650)
            intr[c, :8] = [f, res[0] / 2 + rng.normal() * 5,
                           f * rng.uniform(0.99, 1.01),
                           res[1] / 2 + rng.normal() * 5,
                           rng.uniform(-0.08, -0.02),
                           rng.uniform(0.0, 0.03),
                           rng.normal() * 2e-3, rng.normal() * 5e-4]
            ang = 2 * np.pi * c / n_cams
            pos = np.array([np.cos(ang), np.sin(ang),
                            rng.uniform(0.3, 0.8)]) * rng.uniform(0.9, 1.1)
            rvec, tvec = ext_4x4_to_rod(look_at_extrinsic(pos, np.zeros(3)))
            extr[c] = np.concatenate([rvec, tvec])
            continue
        intr[c, :9] = [f, res[0] / 2 + rng.normal() * 5,
                       f * rng.uniform(0.99, 1.01), res[1] / 2 + rng.normal() * 5,
                       rng.uniform(-0.25, -0.05), rng.uniform(0.0, 0.08),
                       rng.normal() * tangential_px,
                       rng.normal() * tangential_px,
                       rng.uniform(-0.01, 0.01)]
        if models[c] in ("rational", "thin_prism", "tilted"):
            intr[c, 9:12] = [rng.uniform(-0.10, 0.10),
                             rng.uniform(-0.02, 0.02),
                             rng.uniform(-0.005, 0.005)]
        if models[c] in ("thin_prism", "tilted"):
            intr[c, 12:16] = rng.uniform(-2e-3, 2e-3, size=4)
        if models[c] == "tilted":
            intr[c, 16:18] = rng.uniform(-0.01, 0.01, size=2)
        ang = 2 * np.pi * c / n_cams
        pos = np.array([np.cos(ang), np.sin(ang),
                        rng.uniform(0.3, 0.8)]) * rng.uniform(0.9, 1.1)
        rvec, tvec = ext_4x4_to_rod(look_at_extrinsic(pos, np.zeros(3)))
        extr[c] = np.concatenate([rvec, tvec])

    if shared_intrinsics is not False and shared_intrinsics is not None:
        # identical lens batch(es): cameras of one group project through
        # the group's first camera's intrinsics (True = one group; a
        # per-camera group-id array gives a mixed-batch rig)
        gid = (np.zeros(n_cams, dtype=int) if shared_intrinsics is True
               else np.asarray(shared_intrinsics, dtype=int))
        for c in range(n_cams):
            intr[c] = intr[np.flatnonzero(gid == gid[c])[0]]

    # pose_scale = (rotation rad, translation m) spread; tiny values give
    # near-degenerate geometry (barely-moving target) for stress tests
    poses = np.zeros((n_ims, 6))
    poses[:, :3] = rng.normal(size=(n_ims, 3)) * pose_scale[0]
    poses[:, 3:] = rng.normal(size=(n_ims, 3)) * pose_scale[1]
    poses[0] = 0.0  # gauge reference

    # project everything (host numpy; mirrors the device projection model)
    def project(c, pts):
        fx, px, fy, py = intr[c, :4]
        if models[c] == "fisheye":
            t = make_4x4h_tform(extr[c, :3], extr[c, 3:])
            xc = pts @ t[:3, :3].T + t[:3, 3]
            xy = xc[:, :2] / xc[:, 2:3]
            r = np.sqrt(np.sum(xy * xy, axis=1) + 1e-18)
            theta = np.arctan(r)
            t2 = theta * theta
            k1f, k2f, k3f, k4f = intr[c, 4:8]
            theta_d = theta * (1 + t2 * (k1f + t2 * (k2f + t2 * (k3f
                                                                 + t2 * k4f))))
            xy_d = xy * (theta_d / r)[:, None]
            return (np.stack([xy_d[:, 0] * fx + px, xy_d[:, 1] * fy + py], 1),
                    xc[:, 2])
        k1, k2, p1, p2, k3 = intr[c, 4:9]
        t = make_4x4h_tform(extr[c, :3], extr[c, 3:])
        xc = pts @ t[:3, :3].T + t[:3, 3]
        x = xc[:, 0] / xc[:, 2]
        y = xc[:, 1] / xc[:, 2]
        r2 = x * x + y * y
        radial = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
        if models[c] in ("rational", "thin_prism", "tilted"):
            k4, k5, k6 = intr[c, 9:12]
            radial = radial / (1 + r2 * (k4 + r2 * (k5 + r2 * k6)))
        px_add = py_add = 0.0
        if models[c] in ("thin_prism", "tilted"):
            s1, s2, s3, s4 = intr[c, 12:16]
            px_add = r2 * (s1 + r2 * s2)
            py_add = r2 * (s3 + r2 * s4)
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x) + px_add
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y + py_add
        if models[c] == "tilted":
            taux, tauy = intr[c, 16:18]
            cx_, sx_ = np.cos(taux), np.sin(taux)
            cy_, sy_ = np.cos(tauy), np.sin(tauy)
            rr = (np.array([[cy_, 0, -sy_], [0, 1, 0], [sy_, 0, cy_]])
                  @ np.array([[1, 0, 0], [0, cx_, sx_], [0, -sx_, cx_]]))
            m = np.array([[rr[2, 2], 0, -rr[0, 2]],
                          [0, rr[2, 2], -rr[1, 2]], [0, 0, 1]]) @ rr
            w = m[2, 0] * xd + m[2, 1] * yd + m[2, 2]
            xd, yd = ((m[0, 0] * xd + m[0, 1] * yd + m[0, 2]) / w,
                      (m[1, 0] * xd + m[1, 1] * yd + m[1, 2]) / w)
        return np.stack([xd * fx + px, yd * fy + py], 1), xc[:, 2]

    rows = []
    for i in range(n_ims):
        t = make_4x4h_tform(poses[i, :3], poses[i, 3:])
        world = tpl_true @ t[:3, :3].T + t[:3, 3]
        for c in range(n_cams):
            uv, z = project(c, world)
            ok = ((z > 0.1) & (uv[:, 0] > 0) & (uv[:, 0] < res[0])
                  & (uv[:, 1] > 0) & (uv[:, 1] < res[1])
                  & (rng.uniform(size=k) < visibility))
            kk = np.where(ok)[0]
            obs = uv[kk] + rng.normal(size=(len(kk), 2)) * noise_px
            rows.append(np.column_stack([
                np.full(len(kk), c), np.full(len(kk), i), kk, obs]))
    dd = np.concatenate(rows, axis=0)
    return {
        "intr": intr, "extr": extr, "poses": poses, "template": tpl,
        "template_true": tpl_true,
        "dd": dd, "n_cams": n_cams, "n_ims": n_ims, "n_keys": k,
        "noise_px": noise_px, "camera_model": camera_model,
        "camera_models": models,
    }
