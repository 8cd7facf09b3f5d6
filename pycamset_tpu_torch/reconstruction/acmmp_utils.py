"""MVSNet / ACMMP export parameters and view-pair selection.

Counterpart of ``pycamset_tpu/reconstruction/acmmp_utils.py`` (numpy):
ReconParams (depth range / steps, angle limits, max views), calc_pairs
(view-pair selection by inter-camera view angle), write_pair_file (the
pair.txt format), for ``CameraSet.write_to_txt``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ReconParams:
    """Expected parameters for ACMMP / MVSNet exports."""
    mindist: float = 0.1
    maxdist: float = 0.8
    steps: int = 192
    minangle: float = 3
    maxangle: float = 45
    max_n_view: int = 9


def get_v_vec(ext: np.ndarray) -> np.ndarray:
    """View vector of a camera from its extrinsic matrix."""
    return ext[:3, :3] @ np.array([0, 0, 1])


def calc_pairs(c_vec: np.ndarray, r_param: ReconParams, rng=None,
               pick_closest: bool = False) -> list[np.ndarray]:
    """Acceptable reconstruction pairs per camera from view vectors.

    Pairs must subtend an inter-view angle within [minangle, maxangle]; when
    more than max_n_view qualify, picks the closest-angle subset (or a random
    one).
    """
    rng = np.random.default_rng() if rng is None else rng
    gaze = np.asarray(c_vec, dtype=float)
    gaze = gaze / np.linalg.norm(gaze, axis=1, keepdims=True)
    separation_deg = np.degrees(np.arccos(np.clip(gaze @ gaze.T, -1, 1)))
    usable = (separation_deg > r_param.minangle) & \
             (separation_deg < r_param.maxangle)

    def pick(ref_idx):
        candidates = np.flatnonzero(usable[ref_idx])
        if len(candidates) < r_param.max_n_view:
            return candidates
        if pick_closest:
            by_angle = np.argsort(separation_deg[ref_idx, candidates])
            return candidates[by_angle[:r_param.max_n_view]]
        return rng.choice(candidates, r_param.max_n_view, replace=False)

    return [pick(i) for i in range(len(gaze))]


def write_pair_file(f, pair_list) -> None:
    """Write a pair list in the MVSNet pair.txt format."""
    lines = [str(len(pair_list))]
    for ref_idx, partners in enumerate(pair_list):
        lines.append(str(ref_idx))
        lines.append(f"{len(partners)} "
                     + " ".join(f"{cam_id} 1" for cam_id in partners))
    f.write("\n".join(lines) + "\n")
