"""The port's math ops in plain torch, under the names of
``pycamset_tpu/ops/__init__.py``. The port's functions take leading batch
dims, so each ``*_batch`` name (``jax.vmap`` of the single form in the JAX
package) is the function itself."""
from pycamset_tpu_torch.ops.distortion import (distort_normalized,
                                               distort_pixels,
                                               undistort_normalized,
                                               undistort_pixels)
from pycamset_tpu_torch.ops.projection import (intr9_from_k_dist,
                                               k_dist_from_intr9,
                                               project_cam_points,
                                               project_target_points,
                                               project_world_points)
from pycamset_tpu_torch.ops.rotations import (matrix_to_rodrigues,
                                              rodrigues_to_matrix, skew)
from pycamset_tpu_torch.ops.transforms import (geometric_median, h_tform,
                                               make_cartesian, make_polar,
                                               pairwise_dist, pose_apply,
                                               pose_inv, pose_to_h4,
                                               pose_to_se3, project_h,
                                               rigid_fit, se3_apply,
                                               se3_compose, se3_inv,
                                               se3_to_pose)
from pycamset_tpu_torch.ops.triangulation import (triangulate_nviews,
                                                  triangulate_observations)

rodrigues_to_matrix_batch = rodrigues_to_matrix
matrix_to_rodrigues_batch = matrix_to_rodrigues
triangulate_nviews_batch = triangulate_nviews

__all__ = [
    "rodrigues_to_matrix", "matrix_to_rodrigues", "rodrigues_to_matrix_batch",
    "matrix_to_rodrigues_batch", "skew",
    "pose_to_se3", "se3_to_pose", "pose_to_h4", "se3_apply", "pose_apply",
    "se3_inv", "pose_inv", "se3_compose", "h_tform", "project_h",
    "rigid_fit", "geometric_median", "pairwise_dist", "make_cartesian",
    "make_polar",
    "distort_normalized", "distort_pixels", "undistort_normalized",
    "undistort_pixels",
    "intr9_from_k_dist", "k_dist_from_intr9", "project_cam_points",
    "project_world_points", "project_target_points",
    "triangulate_nviews", "triangulate_nviews_batch",
    "triangulate_observations",
]
