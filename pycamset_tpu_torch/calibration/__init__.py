"""The calibration entry points: the user path
(``camera_calibrator.py``) and the calibration extras, each under the
module name of ``pycamset_tpu/calibration/``: temporal synchronisation
(``sync``), rig health and partial recalibration (``monitor``), hand-eye
calibration (``handeye``), lens-model conversion (``convert``), the rig
planner (``plan``), camera-model selection (``model_select``) and the
wand's extrinsic calibration (``wand``). Their functions are exported here by name, each
module imported on first use."""

_LAZY = {
    "sync": ("SyncResult", "calibrate_time_offsets",
             "estimate_integer_shifts", "format_sync_report"),
    "monitor": ("rig_health", "recalibrate_extrinsics",
                "recalibrate_intrinsics"),
    "handeye": ("HandEyeResult", "calibrate_hand_eye", "solve_ax_xb",
                "solve_hand_eye"),
    "convert": ("convert_camera_model", "convert_camera_set"),
    "plan": ("format_plan_report", "plan_calibration",
             "synthesize_detections", "workspace_center"),
    "model_select": ("DEFAULT_CANDIDATES", "ModelScore", "pick_model",
                     "pick_model_per_camera", "score_camera_model",
                     "select_camera_model", "split_detection_images",
                     "subset_ims"),
    "wand": ("calibrate_extrinsics_from_wand",
             "register_cameras_incremental"),
}
_MODULE_OF = {name: mod for mod, names in _LAZY.items() for name in names}

__all__ = sorted(_MODULE_OF)


def __getattr__(name):
    if name in _MODULE_OF:
        import importlib
        module = importlib.import_module(f"{__name__}.{_MODULE_OF[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
