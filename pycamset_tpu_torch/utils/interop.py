"""Calibrated-rig interchange with external reconstruction pipelines.

Counterpart of ``pycamset_tpu/utils/interop.py`` (host numpy; the same
bytes for the same rig). Beside the MVSNet export
(``CameraSet.write_to_txt``), the three formats users most often need to
carry a calibrated rig into:

* **COLMAP** sparse-model text directories (``cameras.txt`` /
  ``images.txt`` / ``points3D.txt``) — both directions. Exports feed
  ``colmap point_triangulator`` / dense MVS directly; imports let a rig
  that was bundle-adjusted in COLMAP flow into this framework's tracking,
  reconstruction and monitoring tools.
* **NeRF** ``transforms.json`` (instant-ngp / nerfstudio conventions:
  OpenGL camera axes, per-frame intrinsics, OPENCV / OPENCV_FISHEYE
  distortion tags).
* **OpenCV YAML** (``cv2.FileStorage``) — readable from any OpenCV
  program, both directions; OpenCV is imported when these run.

Conventions. A :class:`~pycamset_tpu_torch.models.camera.Camera` stores a 4x4
world->camera extrinsic in OpenCV axes (+z forward, +y down) and an
OpenCV-ordered distortion vector whose width marks the family (5 standard,
8 rational, 12 thin-prism, 14 tilted, 4 fisheye). COLMAP shares the OpenCV
camera axes and the world->camera direction, so poses pass through exactly
(rotation re-encoded as a Hamilton wxyz quaternion); NeRF flips the camera
y/z axes and stores camera->world.
"""
from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np

from pycamset_tpu_torch.models.camera import Camera
from pycamset_tpu_torch.models.camera_set import CameraSet, make_cam_dict
from pycamset_tpu_torch.utils.general_utils import require_cv2

# ----------------------------------------------------------- quaternions


def quat_from_matrix(r: np.ndarray) -> np.ndarray:
    """Hamilton [w, x, y, z] unit quaternion from a 3x3 rotation.

    Shepperd's method: pick the largest of the four squared components
    from the trace pattern, so the division is always well-conditioned.
    """
    r = np.asarray(r, dtype=float)
    t = np.trace(r)
    cand = np.array([t, r[0, 0], r[1, 1], r[2, 2]])
    i = int(np.argmax(cand))
    if i == 0:
        w = np.sqrt(1.0 + t) / 2.0
        x = (r[2, 1] - r[1, 2]) / (4.0 * w)
        y = (r[0, 2] - r[2, 0]) / (4.0 * w)
        z = (r[1, 0] - r[0, 1]) / (4.0 * w)
    else:
        a = i - 1
        b, c = (a + 1) % 3, (a + 2) % 3
        s = np.sqrt(1.0 + r[a, a] - r[b, b] - r[c, c]) * 2.0
        axis = np.empty(3)
        axis[a] = s / 4.0
        axis[b] = (r[b, a] + r[a, b]) / s
        axis[c] = (r[c, a] + r[a, c]) / s
        w = (r[c, b] - r[b, c]) / s
        x, y, z = axis
    q = np.array([w, x, y, z])
    if q[0] < 0:  # canonical sign (COLMAP convention prints either; fix one)
        q = -q
    return q / np.linalg.norm(q)


def matrix_from_quat(q: np.ndarray) -> np.ndarray:
    """3x3 rotation from a Hamilton [w, x, y, z] quaternion."""
    w, x, y, z = np.asarray(q, dtype=float) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


# ------------------------------------------------------------- model maps

_MAX_SKEW = 1e-9


def _intr4(cam: Camera) -> tuple[float, float, float, float]:
    k = np.asarray(cam.intrinsic, dtype=float)
    if abs(k[0, 1]) > _MAX_SKEW * max(abs(k[0, 0]), 1.0):
        raise ValueError(
            f"camera {cam.name!r} has a skew term ({k[0, 1]:.3g}); neither "
            "COLMAP nor NeRF models skew — re-estimate without it")
    return float(k[0, 0]), float(k[1, 1]), float(k[0, 2]), float(k[1, 2])


def _colmap_model_of(cam: Camera) -> tuple[str, list[float]]:
    """(COLMAP model name, params) for one camera; raises for families
    COLMAP cannot express (thin-prism / tilted Brown variants — convert
    first via :func:`pycamset_tpu_torch.calibration.convert.
    convert_camera_model`).
    """
    fx, fy, cx, cy = _intr4(cam)
    d = np.ravel(np.asarray(cam.distortion_coefs, dtype=float))
    if d.size == 4:      # Kannala-Brandt
        return "OPENCV_FISHEYE", [fx, fy, cx, cy, *d.tolist()]
    if d.size == 5:
        if d[4] == 0.0:
            return "OPENCV", [fx, fy, cx, cy, *d[:4].tolist()]
        return "FULL_OPENCV", [fx, fy, cx, cy, *d.tolist(), 0.0, 0.0, 0.0]
    if d.size == 8:
        return "FULL_OPENCV", [fx, fy, cx, cy, *d.tolist()]
    raise ValueError(
        f"camera {cam.name!r}: COLMAP has no Brown model with "
        f"{d.size} distortion coefficients (thin-prism/tilted); refit with "
        "pycamset_tpu_torch.calibration.convert.convert_camera_model(cam, "
        "to='rational') first")


# COLMAP model name -> (param layout handler). Each returns
# (kmat 3x3, dist vector) in this package's conventions.
def _from_colmap_params(model: str, p: list[float]):
    def kmat(fx, fy, cx, cy):
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])

    if model == "SIMPLE_PINHOLE":
        f, cx, cy = p
        return kmat(f, f, cx, cy), np.zeros(5)
    if model == "PINHOLE":
        fx, fy, cx, cy = p
        return kmat(fx, fy, cx, cy), np.zeros(5)
    if model == "SIMPLE_RADIAL":
        f, cx, cy, k1 = p
        return kmat(f, f, cx, cy), np.array([k1, 0, 0, 0, 0.0])
    if model == "RADIAL":
        f, cx, cy, k1, k2 = p
        return kmat(f, f, cx, cy), np.array([k1, k2, 0, 0, 0.0])
    if model == "OPENCV":
        fx, fy, cx, cy, k1, k2, p1, p2 = p
        return kmat(fx, fy, cx, cy), np.array([k1, k2, p1, p2, 0.0])
    if model == "FULL_OPENCV":
        fx, fy, cx, cy, *d8 = p
        d8 = np.asarray(d8, dtype=float)
        if np.all(d8[5:] == 0.0):      # pure polynomial: collapse to 5-coef
            return kmat(fx, fy, cx, cy), d8[:5].copy()
        return kmat(fx, fy, cx, cy), d8
    if model == "OPENCV_FISHEYE":
        fx, fy, cx, cy, k1, k2, k3, k4 = p
        return kmat(fx, fy, cx, cy), np.array([k1, k2, k3, k4])
    raise ValueError(f"unsupported COLMAP camera model {model!r} "
                     "(supported: SIMPLE_PINHOLE, PINHOLE, SIMPLE_RADIAL, "
                     "RADIAL, OPENCV, FULL_OPENCV, OPENCV_FISHEYE)")


# ------------------------------------------------------------ COLMAP write


def export_colmap(cams: CameraSet, out_dir: Path | str,
                  image_names: dict[str, str] | None = None,
                  points3d: np.ndarray | None = None,
                  tracks: list[list[tuple[str, tuple[float, float]]]] | None
                  = None,
                  errors: np.ndarray | None = None) -> Path:
    """Write ``cams`` as a COLMAP sparse-model text directory.

    :param image_names: per-camera image file names (defaults to
        ``<cam_name>.png``) — these must match the image files handed to
        COLMAP for feature extraction / densification.
    :param points3d: optional (N, 3) world points for ``points3D.txt``.
    :param tracks: optional per-point observation lists
        ``[(cam_name, (x, y)), ...]``; observations also populate the
        images' 2D-point lines so the model is fully linked.
    :param errors: optional per-point reprojection errors (px).
    :returns: the directory written (contains the three .txt files).
    """
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    names = cams.get_names()
    cam_id = {n: i + 1 for i, n in enumerate(names)}
    image_names = image_names or {}

    with open(out / "cameras.txt", "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for n in names:
            cam = cams[n]
            model, params = _colmap_model_of(cam)
            w, h = int(cam.res[0]), int(cam.res[1])
            ps = " ".join(f"{v:.17g}" for v in params)
            f.write(f"{cam_id[n]} {model} {w} {h} {ps}\n")

    # per-image 2D point lines (built from tracks when given)
    pts2d: dict[str, list[str]] = {n: [] for n in names}
    track_entries: list[str] = []
    if points3d is not None:
        points3d = np.asarray(points3d, dtype=float).reshape(-1, 3)
        errs = (np.zeros(len(points3d)) if errors is None
                else np.asarray(errors, dtype=float).reshape(-1))
        for pid in range(len(points3d)):
            obs = (tracks[pid] if tracks is not None else [])
            parts = []
            for cam_name, (x, y) in obs:
                idx2d = len(pts2d[cam_name])
                pts2d[cam_name].append(f"{x:.17g} {y:.17g} {pid + 1}")
                parts.append(f"{cam_id[cam_name]} {idx2d}")
            x, y, z = points3d[pid]
            track_entries.append(
                f"{pid + 1} {x:.17g} {y:.17g} {z:.17g} 128 128 128 "
                f"{errs[pid]:.17g} " + " ".join(parts))

    with open(out / "images.txt", "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for n in names:
            cam = cams[n]
            q = quat_from_matrix(cam.extrinsic[:3, :3])
            t = cam.extrinsic[:3, 3]
            name = image_names.get(n, f"{n}.png")
            f.write(f"{cam_id[n]} "
                    + " ".join(f"{v:.17g}" for v in [*q, *t])
                    + f" {cam_id[n]} {name}\n")
            f.write(" ".join(pts2d[n]) + "\n")

    with open(out / "points3D.txt", "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        for line in track_entries:
            f.write(line + "\n")
    logging.info("wrote COLMAP model (%d cameras, %d points) to %s",
                 len(names), len(track_entries), out)
    return out


def import_colmap(model_dir: Path | str) -> CameraSet:
    """Read a COLMAP sparse-model text directory into a CameraSet.

    Each COLMAP image becomes one camera, named by the image's file stem
    (COLMAP rigs are usually one image per physical camera when used this
    way; for multi-image captures, subset afterwards). Binary models must
    first be converted with ``colmap model_converter --output_type TXT``.
    """
    d = Path(model_dir)
    if not (d / "cameras.txt").exists():
        if (d / "cameras.bin").exists():
            raise ValueError(
                f"{d} holds a BINARY colmap model; run colmap "
                "model_converter --output_type TXT first")
        raise FileNotFoundError(f"no cameras.txt under {d}")

    colmap_cams: dict[int, tuple[np.ndarray, np.ndarray, tuple[int, int]]] = {}
    for line in (d / "cameras.txt").read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        toks = line.split()
        cid, model = int(toks[0]), toks[1]
        w, h = int(toks[2]), int(toks[3])
        kmat, dist = _from_colmap_params(model, [float(v) for v in toks[4:]])
        colmap_cams[cid] = (kmat, dist, (w, h))

    names, exts, kmats, dists, res = [], [], [], [], []
    # two lines per image: pose, then POINTS2D (possibly EMPTY — keep blank
    # lines so the alternation stays aligned)
    lines = [ln.strip() for ln in (d / "images.txt").read_text().splitlines()
             if not ln.lstrip().startswith("#")]
    expecting_pose = True
    for line in lines:
        if not expecting_pose:           # a POINTS2D line (may be empty)
            expecting_pose = True
            continue
        if not line:
            continue
        expecting_pose = False
        toks = line.split()
        q = np.array([float(v) for v in toks[1:5]])
        t = np.array([float(v) for v in toks[5:8]])
        cid = int(toks[8])
        name = Path(toks[9]).stem
        ext = np.eye(4)
        ext[:3, :3] = matrix_from_quat(q)
        ext[:3, 3] = t
        kmat, dist, (w, h) = colmap_cams[cid]
        names.append(name)
        exts.append(ext)
        kmats.append(kmat)
        dists.append(dist)
        res.append([w, h])
    return CameraSet(camera_dict=make_cam_dict(names, exts, kmats, dists,
                                               res))


# --------------------------------------------------------------- NeRF JSON

# OpenCV camera axes (+y down, +z forward) -> OpenGL (+y up, -z forward)
_CV_TO_GL = np.diag([1.0, -1.0, -1.0, 1.0])


def export_nerf(cams: CameraSet, out_path: Path | str,
                image_names: dict[str, str] | None = None,
                aabb_scale: int = 16) -> Path:
    """Write ``transforms.json`` (instant-ngp / nerfstudio conventions).

    Frames carry camera->world matrices in OpenGL axes and per-frame
    intrinsics (nerfstudio reads those; instant-ngp uses the top-level
    copies from the first camera). Brown cameras emit k1/k2/p1/p2
    (+k3 when present); fisheye rigs are tagged OPENCV_FISHEYE with
    k1..k4. Thin-prism / tilted rigs raise — convert first.
    """
    names = cams.get_names()
    image_names = image_names or {}
    frames = []
    fisheye = None
    for n in names:
        cam = cams[n]
        fx, fy, cx, cy = _intr4(cam)
        d = np.ravel(np.asarray(cam.distortion_coefs, dtype=float))
        if d.size not in (4, 5, 8):
            raise ValueError(
                f"camera {n!r}: NeRF tooling has no {d.size}-coef Brown "
                "model; convert_camera_model(cam, to='standard') first")
        is_fish = d.size == 4
        if fisheye is None:
            fisheye = is_fish
        elif fisheye != is_fish:
            raise ValueError("mixed fisheye/Brown rigs cannot share one "
                             "transforms.json camera_model")
        c2w = np.linalg.inv(cam.extrinsic) @ _CV_TO_GL
        frame = {
            "file_path": image_names.get(n, f"{n}.png"),
            "transform_matrix": c2w.tolist(),
            "w": int(cam.res[0]), "h": int(cam.res[1]),
            "fl_x": fx, "fl_y": fy, "cx": cx, "cy": cy,
        }
        if is_fish:
            frame.update(k1=d[0], k2=d[1], k3=d[2], k4=d[3])
        else:
            frame.update(k1=float(d[0]), k2=float(d[1]),
                         p1=float(d[2]), p2=float(d[3]))
            if d.size >= 5 and d[4] != 0.0:
                frame["k3"] = float(d[4])
        frames.append(frame)

    first = frames[0]
    doc = {
        "camera_model": "OPENCV_FISHEYE" if fisheye else "OPENCV",
        "aabb_scale": aabb_scale,
        "camera_angle_x": 2.0 * float(np.arctan2(first["w"] / 2.0,
                                                 first["fl_x"])),
        **{k: first[k] for k in ("w", "h", "fl_x", "fl_y", "cx", "cy")},
        **{k: first[k] for k in ("k1", "k2", "p1", "p2", "k3", "k4")
           if k in first},
        "frames": frames,
    }
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=2))
    logging.info("wrote %s (%d frames)", out, len(frames))
    return out


# ------------------------------------------------------------- OpenCV YAML


def export_opencv_yaml(cams: CameraSet, out_path: Path | str) -> Path:
    """Write the rig as an OpenCV ``FileStorage`` YAML file.

    Layout: ``nb_camera``, then per camera ``camera_matrix_<i>``,
    ``distortion_<i>``, ``rotation_<i>`` / ``translation_<i>``
    (world->camera), ``image_size_<i>`` and ``camera_name_<i>`` — readable
    from any OpenCV program via ``cv2.FileStorage``.
    """
    cv2 = require_cv2("export_opencv_yaml (cv2.FileStorage)",
                      "export a COLMAP model or a NeRF file instead")
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    fs = cv2.FileStorage(str(out), cv2.FILE_STORAGE_WRITE)
    try:
        names = cams.get_names()
        fs.write("nb_camera", len(names))
        for i, n in enumerate(names):
            cam = cams[n]
            fs.write(f"camera_name_{i}", str(n))
            fs.write(f"camera_matrix_{i}", np.asarray(cam.intrinsic,
                                                      dtype=float))
            fs.write(f"distortion_{i}",
                     np.ravel(np.asarray(cam.distortion_coefs,
                                         dtype=float)).reshape(1, -1))
            fs.write(f"rotation_{i}", cam.extrinsic[:3, :3].astype(float))
            fs.write(f"translation_{i}",
                     cam.extrinsic[:3, 3].reshape(3, 1).astype(float))
            fs.write(f"image_size_{i}",
                     np.asarray([int(cam.res[0]), int(cam.res[1])],
                                dtype=np.int32).reshape(1, 2))
    finally:
        fs.release()
    return out


def import_opencv_yaml(path: Path | str) -> CameraSet:
    """Read a rig written by :func:`export_opencv_yaml` (or any file in the
    same layout) back into a CameraSet."""
    cv2 = require_cv2("import_opencv_yaml (cv2.FileStorage)",
                      "read a COLMAP model (import_colmap) instead")
    fs = cv2.FileStorage(str(path), cv2.FILE_STORAGE_READ)
    try:
        n = int(fs.getNode("nb_camera").real())
        names, exts, kmats, dists, res = [], [], [], [], []
        for i in range(n):
            node = fs.getNode(f"camera_name_{i}")
            names.append(node.string() if not node.empty() else f"cam{i}")
            kmats.append(np.asarray(fs.getNode(f"camera_matrix_{i}").mat()))
            dists.append(np.ravel(fs.getNode(f"distortion_{i}").mat()))
            ext = np.eye(4)
            ext[:3, :3] = np.asarray(fs.getNode(f"rotation_{i}").mat())
            ext[:3, 3] = np.ravel(fs.getNode(f"translation_{i}").mat())
            exts.append(ext)
            sz = np.ravel(fs.getNode(f"image_size_{i}").mat())
            res.append([int(sz[0]), int(sz[1])])
    finally:
        fs.release()
    return CameraSet(camera_dict=make_cam_dict(names, exts, kmats, dists,
                                               res))
