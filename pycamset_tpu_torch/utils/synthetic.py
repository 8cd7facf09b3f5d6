"""Synthetic rig generation for benchmarks and tests.

Counterpart of ``pycamset_tpu/utils/synthetic.py``, line for line: the same
seed gives the same rig (``dd``, ``intr``, ``extr``, ``poses``,
``template``). Only the Rodrigues helpers differ (numpy here, cv2 there).

Builds a ground-truth multi-camera rig observing a planar grid target across
many poses, with optional visibility dropout and pixel noise. The observation
table matches the TargetDetection layout [cam, im, key, u, v]. ``rs_capture``
makes a rolling-shutter capture of a rig (the JAX package's test
generator, vectorised). The serving path's scenes: ``ring_rig``,
``grid_target``, ``knot_path`` and ``moving_capture`` (a target moving
along a pose path, with per-camera clock offsets and rolling-shutter
readouts: the JAX package's ``tests/test_sync.py`` generator, vectorised)
and ``marker_capture`` (markers on smooth paths: ``tests/test_markers.py``'s
generator, vectorised); ``wand_capture`` (a waved marker wand on
``tests/test_wand.py``'s path, vectorised).
"""
from __future__ import annotations

import numpy as np
import torch

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


def _rodrigues_batch(rvecs: np.ndarray) -> np.ndarray:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3) (numpy)."""
    theta = np.linalg.norm(rvecs, axis=-1)[..., None, None]
    k = rvecs / np.where(theta[..., 0] > 0, theta[..., 0], 1.0)
    kx = np.zeros(rvecs.shape + (3,))
    kx[..., 0, 1], kx[..., 0, 2] = -k[..., 2], k[..., 1]
    kx[..., 1, 0], kx[..., 1, 2] = k[..., 2], -k[..., 0]
    kx[..., 2, 0], kx[..., 2, 1] = -k[..., 1], k[..., 0]
    return (np.cos(theta) * np.eye(3)
            + (1.0 - np.cos(theta)) * k[..., :, None] * k[..., None, :]
            + np.sin(theta) * kx)


def rs_capture(cams, tpl: np.ndarray, n_ims: int, readouts,
               vel_rot: float = 0.15, vel_tr: float = 0.08,
               noise: float = 0.0, seed: int = 0):
    """Rolling-shutter observations of a target moving with constant
    velocity WITHIN each frame: a detection on row v sees the pose
    ``pose + vel * tau`` at ``tau = readout * (v/H - 1/2)``, the row found
    by fixed-point iteration. The draws and the rules are those of the JAX
    package's test generator (``tests/test_rolling_shutter.py::
    _rs_capture``: poses 0.3 rad / 0.1 m, pose 0 the identity, velocities
    ``vel_rot`` / ``vel_tr``, a point kept where z > 0.1 at the frame's
    pose and its pixel inside the image, then the noise, camera-major),
    but each fixed-point step moves every point of a camera's images at
    once (one projection of I x K points), where the JAX generator
    projects all K points for each point.

    :param cams: a CameraSet (its cameras project on the host CPU).
    :param tpl: (K, 3) target points. :param readouts: (C,) per camera, in
        frame units.
    :return: (dd (N, 5) [cam, im, key, u, v], poses (I, 6), vels (I, 6)).
    """
    rng = np.random.default_rng(seed)
    n_keys = tpl.shape[0]
    poses = np.zeros((n_ims, 6))
    poses[:, :3] = rng.normal(size=(n_ims, 3)) * 0.3
    poses[:, 3:] = rng.normal(size=(n_ims, 3)) * 0.1
    poses[0] = 0.0  # gauge pose
    vels = np.zeros((n_ims, 6))
    vels[:, :3] = rng.normal(size=(n_ims, 3)) * vel_rot
    vels[:, 3:] = rng.normal(size=(n_ims, 3)) * vel_tr

    def project(cam, p6):
        """Each point through its own pose: p6 (I, K, 6) -> uv, z (I, K)."""
        world = (np.einsum("ikab,kb->ika", _rodrigues_batch(p6[..., :3]),
                           tpl) + p6[..., 3:])
        z = (world @ cam.extrinsic[:3, :3].T + cam.extrinsic[:3, 3])[..., 2]
        uv = cam.project_points(world.reshape(-1, 3), device="cpu",
                                dtype=torch.float64)
        return np.asarray(uv).reshape(n_ims, n_keys, 2), z

    rows = []
    for c, name in enumerate(cams.get_names()):
        cam = cams[name]
        w, h = (float(x) for x in np.asarray(cam.res).reshape(-1)[:2])
        uv, z = project(cam, np.repeat(poses[:, None], n_keys, axis=1))
        live = np.ones(n_ims, dtype=bool)     # images still iterating
        for _ in range(8):
            tau = readouts[c] * (uv[..., 1] / h - 0.5)
            moved = poses[:, None] + vels[:, None] * tau[..., None]
            new = project(cam, moved)[0]
            done = np.abs(new - uv).max(axis=(1, 2)) < 1e-11
            uv = np.where(live[:, None, None], new, uv)
            live &= ~done
            if not live.any():
                break
        for i in range(n_ims):
            ok = ((z[i] > 0.1) & (uv[i, :, 0] > 0) & (uv[i, :, 0] < w)
                  & (uv[i, :, 1] > 0) & (uv[i, :, 1] < h))
            kk = np.flatnonzero(ok)
            obs = uv[i, kk] + rng.normal(size=(kk.size, 2)) * noise
            rows.append(np.column_stack([
                np.full(kk.size, c), np.full(kk.size, i), kk, obs]))
    return np.concatenate(rows), poses, vels


def ring_rig(n: int = 3, radius: float = 1.0, z: float = 0.5,
             f: float = 1500.0, dist=(-0.1, 0.02, 1e-4, -1e-4, 0.0)):
    """A CameraSet of ``n`` cameras ``cam0``... on a ring of ``radius`` at
    height ``z``, each looking at the origin (1600 x 1200, focal ``f``,
    principal point (800, 600), distortion ``dist``). The defaults are the
    JAX sync tests' ``_ring_rig``; ``radius=1.5, z=0.6, f=1400, dist=(-0.15,
    0.04, 1e-4, -1e-4, 0)`` is the marker tests' ``_rig``."""
    from pycamset_tpu_torch.models.camera_set import CameraSet, make_cam_dict
    names, exts, kmats, dists = [], [], [], []
    for i in range(n):
        ang = 2 * np.pi * i / n
        pos = np.array([radius * np.cos(ang), radius * np.sin(ang), z])
        exts.append(look_at_extrinsic(pos, np.zeros(3)))
        kmats.append(np.array([[f, 0, 800.0], [0, f, 600.0], [0, 0, 1]]))
        dists.append(np.array(dist, dtype=float))
        names.append(f"cam{i}")
    return CameraSet(camera_dict=make_cam_dict(
        names, exts, kmats, dists, [[1600, 1200]] * n))


def grid_target(g: int = 6, pitch: float = 0.03) -> np.ndarray:
    """(g * g, 3) planar grid points centred near the origin."""
    xy = np.stack(np.meshgrid(np.arange(g), np.arange(g)), -1).reshape(-1, 2)
    return np.concatenate([(xy - g / 2) * pitch, np.zeros((g * g, 1))], 1)


def knot_path(n_frames: int, static: bool = False,
              linear: bool = False) -> np.ndarray:
    """(n_frames, 6) knot poses of a smooth path; ``linear`` puts them on
    one straight line in pose space (exact for a per-frame constant
    velocity), ``static`` holds one pose."""
    ph = 2 * np.pi * np.arange(n_frames) / n_frames
    y = np.zeros((n_frames, 6))
    if static:
        y[:, 3:] = [0.02, -0.01, 0.0]
        return y
    if linear:
        ramp = np.linspace(-0.5, 0.5, n_frames)
        return np.outer(ramp, [0.3, -0.25, 0.2, 0.08, -0.07, 0.06])
    y[:, 0] = 0.25 * np.sin(ph)
    y[:, 1] = 0.20 * np.sin(2 * ph + 0.7)
    y[:, 2] = 0.15 * np.cos(ph)
    y[:, 3] = 0.05 * np.sin(ph + 0.3)
    y[:, 4] = 0.05 * np.cos(2 * ph)
    y[:, 5] = 0.04 * np.sin(3 * ph)
    return y


def moving_capture(cams, tpl: np.ndarray, n_frames: int, offsets,
                   skews=None, readouts=None, ratios=None,
                   noise: float = 0.0, seed: int = 0, static: bool = False,
                   linear: bool = False, device="cpu"):
    """A target moving along ``knot_path`` (linearly interpolated between
    integer-time knots), seen by each camera c at frame times j ratio_c +
    offsets[c] + skews[c] (j ratio_c - j_mid) in reference frames (times
    outside [0, n_frames - 1] are skipped). ``ratios`` are the per-camera
    frame-duration ratios fps_ref / fps_c: a 0.5 camera runs at twice the
    reference rate, floor((n_frames - 1) / ratio_c) + 1 frames over the
    same span. With ``readouts`` a detection on row v is seen at t +
    readout_c (v/1200 - 1/2), the row found by fixed point (at most 6
    sweeps, a frame done once no pixel moves by 1e-10). Kept: z > 0.1 and
    inside 1600 x 1200; then the noise, camera-major, frame by frame.

    The JAX package's ``tests/test_sync.py::_moving_capture``, each sweep
    projecting every point of a camera's frames at once (in float64 on
    ``device``).

    :return: (dd (N, 5) [cam, im, key, u, v], knots (n_frames, 6)).
    """
    rng = np.random.default_rng(seed)
    y = knot_path(n_frames, static=static, linear=linear)
    n_keys = tpl.shape[0]

    def project_at(cam, t):
        """t (J, K) -> uv (J, K, 2), z (J, K): each point at its time."""
        f = np.clip(np.floor(t).astype(int), 0, n_frames - 2)
        w = (t - f)[..., None]
        p6 = (1.0 - w) * y[f] + w * y[f + 1]
        world = (np.einsum("jkab,kb->jka", _rodrigues_batch(p6[..., :3]),
                           tpl) + p6[..., 3:])
        z = (world @ cam.extrinsic[:3, :3].T + cam.extrinsic[:3, 3])[..., 2]
        uv = cam.project_points(world.reshape(-1, 3), device=device,
                                dtype=torch.float64)
        return np.asarray(uv).reshape(t.shape + (2,)), z

    rows = []
    jmid = (n_frames - 1) / 2.0
    for c, name in enumerate(cams.get_names()):
        cam = cams[name]
        ratio = 1.0 if ratios is None else float(ratios[c])
        j = np.arange(int(np.floor((n_frames - 1) / ratio)) + 1)
        t = j * ratio + offsets[c]
        if skews is not None:
            t = t + skews[c] * (j * ratio - jmid)
        inside = (t >= 0.0) & (t <= n_frames - 1.0)
        j, t = j[inside], t[inside]
        tk = np.repeat(t[:, None], n_keys, axis=1)
        uv, z = project_at(cam, tk)
        if readouts is not None and readouts[c]:
            live = np.ones(len(j), dtype=bool)
            for _ in range(6):
                new = project_at(
                    cam, t[:, None] + readouts[c] * (uv[..., 1] / 1200.0
                                                     - 0.5))[0]
                done = np.abs(new - uv).max(axis=(1, 2)) < 1e-10
                uv = np.where(live[:, None, None], new, uv)
                live &= ~done
                if not live.any():
                    break
        for i, jj in enumerate(j):
            ok = ((z[i] > 0.1) & (uv[i, :, 0] > 0) & (uv[i, :, 0] < 1600)
                  & (uv[i, :, 1] > 0) & (uv[i, :, 1] < 1200))
            kk = np.flatnonzero(ok)
            obs = uv[i, kk] + rng.normal(size=(kk.size, 2)) * noise
            rows.append(np.column_stack([
                np.full(kk.size, c), np.full(kk.size, jj), kk, obs]))
    return np.concatenate(rows), y


def marker_capture(cams, n_frames: int, n_markers: int, noise: float = 0.2,
                   seed: int = 0, occlude=None):
    """Markers on independent smooth paths: marker m at frame j sits at
    (0.35 sin(ph (1 + m % 3) + m), 0.35 cos(ph (2 + m % 2) + 0.7 m),
    0.25 sin(ph + 1.3 m)), ph = 2 pi j / n_frames; a camera keeps a marker
    with z > 0.1 inside 1600 x 1200, then the (u, v) noise, frame-major,
    camera, then marker. ``occlude``: (frame, marker) pairs left to camera 0
    alone. The JAX package's ``tests/test_markers.py::_capture``, each
    camera projecting every frame at once.

    :return: (rows (N, 5) [cam, frame, marker, u, v], truth (I, M, 3)).
    """
    rng = np.random.default_rng(seed)
    ph = 2 * np.pi * np.arange(n_frames) / n_frames
    m = np.arange(n_markers)
    truth = np.stack([
        0.35 * np.sin(ph[:, None] * (1 + m % 3) + m),
        0.35 * np.cos(ph[:, None] * (2 + m % 2) + 0.7 * m),
        0.25 * np.sin(ph[:, None] + 1.3 * m)], axis=-1)
    pts = truth.reshape(-1, 3)
    keep, uvs = [], []
    for name in cams.get_names():
        cam = cams[name]
        uv = np.asarray(cam.project_points(pts, device="cpu",
                                           dtype=torch.float64)).reshape(
            n_frames, n_markers, 2)
        z = (truth @ cam.extrinsic[:3, :3].T + cam.extrinsic[:3, 3])[..., 2]
        keep.append((z > 0.1) & (uv[..., 0] > 0) & (uv[..., 0] < 1600)
                    & (uv[..., 1] > 0) & (uv[..., 1] < 1200))
        uvs.append(uv)
    keep, uvs = np.stack(keep, 1), np.stack(uvs, 1)     # (I, C, M)
    if occlude:
        for (j, mk) in occlude:
            keep[j, 1:, mk] = False
    jj, cc, mm = np.nonzero(keep)                       # frame, cam, marker
    noisy = uvs[jj, cc, mm] + rng.normal(size=(len(jj), 2)) * noise
    return np.column_stack([cc, jj, mm, noisy]).astype(float), truth


def wand_capture(cams, wand: np.ndarray, n_frames: int, noise: float = 0.2,
                 seed: int = 0, drop: float = 0.3, res=(1600, 1200)):
    """A wand of markers ``wand`` (M, 3) waved through the volume on the
    path of the JAX package's ``tests/test_wand.py::_wand_capture``
    (frame j: translation (0.45 sin 2ph, 0.45 cos(3ph + 0.6),
    0.35 sin(ph + 1.1)), rotation (1.8 sin(2ph + 0.3), 1.5 cos ph,
    1.1 sin 3ph), ph = 2 pi j / n_frames). A camera misses a whole frame
    with probability ``drop`` and keeps a marker with z > 0.1 inside
    ``res``; then the (u, v) noise. Each camera projects every frame at
    once and the draws come in bulk, so the rows match that test's
    geometry, not its random stream.

    :return: (rows (N, 5) [cam, frame, marker, u, v] frame-major, truth
        (I, M, 3) world marker positions).
    """
    rng = np.random.default_rng(seed)
    ph = 2 * np.pi * np.arange(n_frames) / n_frames
    pos = np.stack([0.45 * np.sin(ph * 2), 0.45 * np.cos(ph * 3 + 0.6),
                    0.35 * np.sin(ph + 1.1)], 1)
    rvec = np.stack([1.8 * np.sin(ph * 2 + 0.3), 1.5 * np.cos(ph),
                     1.1 * np.sin(ph * 3)], 1)
    rot = np.stack([make_4x4h_tform(r, np.zeros(3))[:3, :3] for r in rvec])
    truth = np.einsum("iab,mb->ima", rot, wand) + pos[:, None]
    names = cams.get_names()
    n_m = len(wand)
    keep, uvs = [], []
    for name in names:
        cam = cams[name]
        uv = np.asarray(cam.project_points(
            truth.reshape(-1, 3), device="cpu",
            dtype=torch.float64)).reshape(n_frames, n_m, 2)
        z = (truth @ cam.extrinsic[:3, :3].T + cam.extrinsic[:3, 3])[..., 2]
        keep.append((z > 0.1) & (uv[..., 0] > 0) & (uv[..., 0] < res[0])
                    & (uv[..., 1] > 0) & (uv[..., 1] < res[1]))
        uvs.append(uv)
    keep, uvs = np.stack(keep, 1), np.stack(uvs, 1)     # (I, C, M)
    keep &= (rng.uniform(size=keep.shape[:2]) >= drop)[..., None]
    jj, cc, mm = np.nonzero(keep)                       # frame, cam, marker
    noisy = uvs[jj, cc, mm] + rng.normal(size=(len(jj), 2)) * noise
    return np.column_stack([cc, jj, mm, noisy]).astype(float), truth
