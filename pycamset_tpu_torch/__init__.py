"""pycamset_tpu_torch — the PyTorch/CUDA twin of pycamset_tpu.

The first slice covers the structured (Schur) Levenberg-Marquardt bundle
adjustment of the template chain Projection . Extrinsic3D . TemplatePoints
for the standard camera model: synthetic rig -> block grid -> structured
normal equations -> Schur step -> LM. The normal equations come from two
hand-written CUDA kernels on a card (``optim/cuda_grams.py``,
``csrc/template_grams.cu``) and from their plain PyTorch twins on the CPU.

Layout and function names mirror ``pycamset_tpu`` so each counterpart is
found by name. The package imports torch, numpy and scipy only — never jax,
cv2 or pycamset_tpu.
"""
from pycamset_tpu_torch import config  # noqa: F401  (sets the precision flags)

__version__ = "0.1.0"

__all__ = ["Camera", "CameraSet", "load_CameraSet", "TargetTracker",
           "export_tracker", "load_tracker_artifact",
           "run_fleet_bundle_adjustment", "FleetMismatch",
           "calibrate_hand_eye", "rig_health", "recalibrate_extrinsics",
           "recalibrate_intrinsics", "convert_camera_model",
           "convert_camera_set", "calibrate_time_offsets",
           "calibrate_extrinsics_from_wand", "MarkerTriangulator",
           "smooth_pose_trajectory"]

# exported as the JAX package exports them (pycamset_tpu/__init__.py),
# imported on first use; its calibrate_cameras, ChArUco, Ccube,
# calibrate_fleet and write_calibration_report are not ported yet
_LAZY = {"Camera": "pycamset_tpu_torch.models.camera",
         "CameraSet": "pycamset_tpu_torch.models.camera_set",
         "load_CameraSet": "pycamset_tpu_torch.utils.saving",
         "run_fleet_bundle_adjustment": "pycamset_tpu_torch.optim.fleet",
         "FleetMismatch": "pycamset_tpu_torch.optim.fleet",
         "TargetTracker": "pycamset_tpu_torch.tracking",
         "export_tracker": "pycamset_tpu_torch.serving",
         "load_tracker_artifact": "pycamset_tpu_torch.serving",
         "calibrate_hand_eye": "pycamset_tpu_torch.calibration.handeye",
         "rig_health": "pycamset_tpu_torch.calibration.monitor",
         "recalibrate_extrinsics": "pycamset_tpu_torch.calibration.monitor",
         "recalibrate_intrinsics": "pycamset_tpu_torch.calibration.monitor",
         "convert_camera_model": "pycamset_tpu_torch.calibration.convert",
         "convert_camera_set": "pycamset_tpu_torch.calibration.convert",
         "calibrate_time_offsets": "pycamset_tpu_torch.calibration.sync",
         "calibrate_extrinsics_from_wand":
             "pycamset_tpu_torch.calibration.wand",
         "MarkerTriangulator": "pycamset_tpu_torch.markers",
         "smooth_pose_trajectory": "pycamset_tpu_torch.smoothing"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
