"""Host-side helpers (numpy only).

Counterparts of ``make_4x4h_tform``, ``ext_4x4_to_rod``, ``h_tform``,
``thread_map``, ``list_dict_to_np_array``, ``numpy_dict_to_list``,
``average_tforms``, ``mad_outlier_detection`` and ``vector_cam_points`` in
``pycamset_tpu/utils/general_utils.py``. The JAX package calls
``cv2.Rodrigues`` for both Rodrigues directions; the machine that runs the
port has no OpenCV, so both directions are written out here in numpy,
following OpenCV's algorithm (including its orthonormalisation and its θ≈0 /
θ≈π branches) so the same inputs give the same vectors to rounding. The
host steps that need OpenCV itself (PnP seeding, image I/O) import it
through ``require_cv2`` inside the one function that needs it.
"""
from __future__ import annotations

import logging

import numpy as np


def rodrigues_vec_to_mat(rvec) -> np.ndarray:
    """Axis-angle (3,) -> rotation matrix (3,3), as ``cv2.Rodrigues``."""
    r = np.asarray(rvec, dtype=float).reshape(3)
    theta = float(np.linalg.norm(r))
    if theta < np.finfo(float).eps:
        return np.eye(3)
    k = r / theta
    c, s = np.cos(theta), np.sin(theta)
    kx = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]],
                   [-k[1], k[0], 0.0]])
    return c * np.eye(3) + (1.0 - c) * np.outer(k, k) + s * kx


def rodrigues_mat_to_vec(rmat) -> np.ndarray:
    """Rotation matrix (3,3) -> axis-angle (3,), as ``cv2.Rodrigues``.

    The matrix is first projected onto the rotations (U V^T of its SVD).
    Near θ = 0 the vector is zero; near θ = π, where the antisymmetric part
    vanishes, the axis comes from the diagonal of (R + I)/2 with its signs
    fixed from the off-diagonal entries.
    """
    u, _, vt = np.linalg.svd(np.asarray(rmat, dtype=float)[:3, :3])
    rot = u @ vt
    w = np.array([rot[2, 1] - rot[1, 2], rot[0, 2] - rot[2, 0],
                  rot[1, 0] - rot[0, 1]])
    s = np.sqrt(np.sum(w * w) * 0.25)
    c = float(np.clip((np.trace(rot) - 1.0) * 0.5, -1.0, 1.0))
    theta = np.arccos(c)
    if s >= 1e-5:
        return w * (theta / (2.0 * s))
    if c > 0:
        return np.zeros(3)
    rx = np.sqrt(max((rot[0, 0] + 1.0) * 0.5, 0.0))
    ry = np.sqrt(max((rot[1, 1] + 1.0) * 0.5, 0.0)) * (
        -1.0 if rot[0, 1] < 0 else 1.0)
    rz = np.sqrt(max((rot[2, 2] + 1.0) * 0.5, 0.0)) * (
        -1.0 if rot[0, 2] < 0 else 1.0)
    if (abs(rx) < abs(ry) and abs(rx) < abs(rz)
            and (rot[1, 2] > 0) != (ry * rz > 0)):
        rz = -rz
    r = np.array([rx, ry, rz])
    return r * (theta / np.linalg.norm(r))


def make_4x4h_tform(rvec, trans, mode: str = "opencv") -> np.ndarray:
    """Rodrigues rotation (or 3x3 matrix) + translation -> 4x4 transform.

    mode='opencv' gives [R|t]; mode='mvg' gives [R|-R t].
    """
    rvec = np.asarray(rvec, dtype=float).squeeze()
    trans = np.asarray(trans, dtype=float).squeeze()
    rot = rodrigues_vec_to_mat(rvec) if rvec.ndim < 2 else rvec
    if mode == "mvg":
        t = -(rot @ trans)
    elif mode == "opencv":
        t = trans
    else:
        raise ValueError(f"{mode} is an invalid 4x4 type")
    out = np.eye(4)
    out[:3, :3] = rot
    out[:3, 3] = t
    return out


def ext_4x4_to_rod(h4: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """4x4 (or 3x4) transform -> (rvec, tvec)."""
    h4 = np.asarray(h4, dtype=float)
    return rodrigues_mat_to_vec(h4[:3, :3]), h4[:3, 3]


def require_cv2(step: str, instead: str):
    """OpenCV for a host step that cannot run without it (PnP seeding, image
    I/O), imported here and nowhere at import time. Raises ``ImportError``
    naming the step and ``instead``, the way around it."""
    try:
        import cv2
    except ImportError as err:
        raise ImportError(
            f"{step} needs OpenCV (cv2), which this Python cannot import; "
            f"{instead}") from err
    return cv2


def cv2_pose(cv2, rvec, tvec) -> np.ndarray:
    """``make_4x4h_tform`` through ``cv2.Rodrigues``, for the seeding steps
    that hold OpenCV already: the JAX package's pose bit for bit, where the
    numpy Rodrigues agrees to rounding."""
    rot, _ = cv2.Rodrigues(np.asarray(rvec, dtype=float).squeeze())
    out = np.eye(4)
    out[:3, :3] = rot
    out[:3, 3] = np.asarray(tvec, dtype=float).squeeze()
    return out


def cv2_rod(cv2, h4) -> tuple[np.ndarray, np.ndarray]:
    """``ext_4x4_to_rod`` through ``cv2.Rodrigues`` (see ``cv2_pose``)."""
    rot, _ = cv2.Rodrigues(np.asarray(h4, dtype=float)[:3, :3])
    return rot.squeeze(), np.asarray(h4)[:3, 3]


def default_thread_count() -> int:
    """Host thread-pool size for the OpenCV steps (PnP seeding):
    min(max(1, cpu_count - 2), 20). OpenCV releases the GIL inside its C++
    calls, so Python threads give real parallelism there."""
    import os
    return min(max(1, (os.cpu_count() or 2) - 2), 20)


def thread_map(fn, items, n_threads: int | None = None) -> list:
    """Order-preserving parallel map over a host thread pool; serial for
    one thread or one item."""
    items = list(items)
    if n_threads is None:
        n_threads = default_thread_count()
    n_threads = min(n_threads, len(items)) if items else 1
    if n_threads <= 1:
        return [fn(it) for it in items]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=n_threads) as ex:
        return list(ex.map(fn, items))


def _convert_nested(d, from_type, converter):
    """In-place recursive conversion of from_type values in a nested dict."""
    if isinstance(d, dict):
        for k, v in d.items():
            if isinstance(v, dict):
                _convert_nested(v, from_type, converter)
            elif isinstance(v, from_type):
                d[k] = converter(v)
    return d


def list_dict_to_np_array(d):
    """Recursively convert lists in a nested dict to numpy arrays (in place)."""
    return _convert_nested(d, list, np.array)


def numpy_dict_to_list(d):
    """Recursively convert numpy arrays in a nested dict to lists (in place)."""
    return _convert_nested(d, np.ndarray, lambda a: a.tolist())


def h_tform(points: np.ndarray, transform: np.ndarray,
            fill: float = 1) -> np.ndarray:
    """Homogeneous transform of an (n,3) point array.

    With fill=1 the result is dehomogenised by its last component, which
    is dropped: a (4,4) rigid transform returns (n,3) points, a (3,4)
    projection (n,2) pixels. fill=0 transforms directions (no translation,
    no divide).
    """
    points = np.asarray(points, dtype=float)
    squeeze = points.ndim == 1
    if squeeze:
        points = points[None, ...]
    res = points @ transform[:, :3].T + fill * transform[:, 3]
    if fill == 1:
        res = res[:, :-1] / res[:, -1:]
    else:
        res = res[:, :-1] if transform.shape[0] == 4 else res
    return res.squeeze() if squeeze else res


def approx_average_quaternion(quats) -> np.ndarray:
    """Eigenvector-based average of unit quaternions (Markley's method)."""
    q = np.array([qq for qq in quats if not np.any(np.isnan(qq))])
    w = np.ones(len(q)) / len(q)
    return np.linalg.eigh(np.einsum("ij,ik,i->jk", q, q, w))[1][:, -1]


def average_tforms(tforms: list[np.ndarray]) -> np.ndarray:
    """Average a list of 4x4 rigid transforms (quaternion mean + mean
    translation)."""
    from scipy.spatial.transform import Rotation as R
    finite = [t for t in tforms if np.all(np.isfinite(t))]
    if not finite:
        return np.full((4, 4), np.nan)
    if len(finite) == 1:
        return finite[0]
    mean_quat = approx_average_quaternion(
        [R.from_matrix(t[:3, :3]).as_quat(canonical=True) for t in finite])
    mean = np.eye(4)
    mean[:3, :3] = R.from_quat(mean_quat).as_matrix()
    mean[:3, 3] = np.mean([t[:3, -1] for t in finite], axis=0)
    return mean


def mad_outlier_detection(data, out_thresh: float = 3):
    """Median-absolute-deviation outlier detection: the outlier indices (as
    from np.nonzero), or None if there are none. The JAX package's
    ``draw=True`` plot waits for the plotting layer (ROADMAP Queue A item
    10)."""
    data = np.asarray(data, dtype=float)
    centre = np.median(data)
    mad = np.median(np.abs(data - centre))
    if mad == 0:
        return None
    deviation = np.abs(data - centre) / mad
    if not np.any(deviation > out_thresh):
        return None
    flagged = np.nonzero(deviation > out_thresh)
    logging.critical("found outliers in indicies:"
                     + "".join(f" {idx}" for idx in flagged))
    logging.critical("These may prevent calibration conversion")
    return flagged


def vector_cam_points(map_type, pts, intrinsics, cam_to_world):
    """Back-project pixel points to world-frame ray directions."""
    if map_type not in ("normalised", "linear"):
        raise ValueError("Invalid sensor map type")
    px = np.asarray(pts, dtype=float)
    homog = np.hstack([px, np.ones((len(px), 1))])
    rays = homog @ np.linalg.inv(intrinsics).T
    if map_type == "normalised":
        rays = rays / np.linalg.norm(rays, axis=-1, keepdims=True)
    return h_tform(rays, cam_to_world, fill=0)
