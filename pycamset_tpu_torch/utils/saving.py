"""Persistence: the `.camset` JSON checkpoint format.

Counterpart of ``compress``, ``decompress``, ``instance_obj``,
``save_camset`` and ``load_CameraSet`` in ``pycamset_tpu/utils/saving.py``,
with the same file layout: the cameras as JSON lists, the calibration
history (parameters, residuals, the handler's options, the target's
constructor arguments, the detection table) beside them, arrays in
pyCamSet's chunked-blosc dicts (``utils/blosc_compat``).

Shared classes are named by their pyCamSet module (``_REFERENCE_MODULE_FOR``)
on save, as the JAX package names them, so a file the port writes loads in
the JAX package and in pyCamSet, and one they write loads here. On load,
``pyCamSet.*`` and ``pycamset_tpu*`` module names resolve to the port's
own classes by class name; no module of the JAX package is ever imported.
"""
from __future__ import annotations

import base64
import importlib
import json
import logging
import zlib
from copy import copy
from pathlib import Path

import numpy as np

from pycamset_tpu_torch.utils.blosc_compat import (compress_reference_dict,
                                                   decompress_reference_dict)
from pycamset_tpu_torch.utils.general_utils import numpy_dict_to_list

# class -> pyCamSet module, named on save for the classes both libraries
# have (the JAX package's table, ``pycamset_tpu/utils/saving.py:35-46``)
_REFERENCE_MODULE_FOR = {
    "Camera": "pyCamSet.cameras.camera",
    "CameraSet": "pyCamSet.cameras.camera_set",
    "TargetDetection": "pyCamSet.calibration_targets.target_detections",
    "ImageDetection": "pyCamSet.calibration_targets.target_detections",
    "ChArUco": "pyCamSet.calibration_targets.target_charuco",
    "Ccube": "pyCamSet.calibration_targets.target_Ccube",
    "TemplateBundleHandler": "pyCamSet.optimisation.template_handler",
    "SelfBundleHandler": "pyCamSet.optimisation.standard_bundle_handler",
    "FreePointBundleHandler": "pyCamSet.optimisation.free_point_handler",
    "FreePointTarget": "pyCamSet.optimisation.free_point_handler",
}
# namespaces whose classes load as the port's own, by class name
_OWN_NAMESPACES = ("pyCamSet.", "pycamset_tpu.", "pycamset_tpu_torch.")


def _port_classes() -> dict:
    """The port's classes that a `.camset` file can name."""
    from pycamset_tpu_torch.models.abstract_target import FreePointTarget
    from pycamset_tpu_torch.models.camera import Camera
    from pycamset_tpu_torch.models.camera_set import CameraSet
    from pycamset_tpu_torch.models.detections import (ImageDetection,
                                                      TargetDetection)
    from pycamset_tpu_torch.optim.handlers import (FreePointBundleHandler,
                                                   SelfBundleHandler,
                                                   TemplateBundleHandler)
    return {cls.__name__: cls for cls in (
        Camera, CameraSet, TargetDetection, ImageDetection, FreePointTarget,
        TemplateBundleHandler, SelfBundleHandler, FreePointBundleHandler)}


def instance_obj(class_module: str, class_name: str, **kwargs):
    """Instantiate class_module.class_name(**kwargs). pyCamSet and
    pycamset_tpu names resolve to the port's class of that name (raises
    ``NotImplementedError`` where the port has none yet); other modules are
    imported."""
    if class_module.startswith(_OWN_NAMESPACES):
        cls = _port_classes().get(class_name)
        if cls is None:
            raise NotImplementedError(
                f"{class_module}.{class_name} is not ported yet (ROADMAP "
                f"Queue A item 3: the ChArUco and Ccube targets; item 7: the "
                f"rolling-shutter handler)")
    else:
        cls = getattr(importlib.import_module(class_module), class_name)
    return cls(**kwargs)


def compress(arr: np.ndarray, clevel: int = 3) -> dict:
    """An ndarray as pyCamSet's chunked-blosc JSON dict
    (``blosc_compat.compress_reference_dict``)."""
    return compress_reference_dict(np.asarray(arr), clevel=clevel)


def decompress(save_dict: dict) -> np.ndarray:
    """Invert :func:`compress`; also reads the zlib layout of early files
    of the JAX package."""
    if "num_chunk" in save_dict:
        return decompress_reference_dict(save_dict)
    codec = save_dict.get("codec", "blosc")
    if codec != "zlib":
        raise ValueError(f"Unsupported array codec {codec!r} "
                         "(file written by a different implementation)")
    raw = zlib.decompress(base64.b64decode(save_dict["data"]))
    arr = np.frombuffer(raw, dtype=np.dtype(save_dict["dtype"])).copy()
    return arr.reshape(save_dict["shape"])


def save_camset(cams, f_name: Path = Path("cams.camset")) -> None:
    """Save a CameraSet (+ calibration history if present) to JSON."""
    def type_record(obj, prefix):
        cls = type(obj)
        module = _REFERENCE_MODULE_FOR.get(cls.__name__, cls.__module__)
        return {f"{prefix}_module": module, f"{prefix}_name": cls.__name__}

    doc: dict = {
        "cams": {
            cam.name: {
                "int": np.asarray(cam.intrinsic).tolist(),
                "ext": np.asarray(cam.extrinsic).tolist(),
                "dst": np.ravel(np.asarray(cam.distortion_coefs)).tolist(),
                "res": np.asarray(cam.res).tolist(),
            } for cam in cams
        },
        "cam_config": {**type_record(cams, "camset"),
                       "cam_name": type(cams[0]).__name__},
        "optim": {},
    }
    optim = doc["optim"]
    if getattr(cams, "calibration_params", None) is not None:
        optim["params"] = np.asarray(cams.calibration_params).tolist()

    handler = getattr(cams, "calibration_handler", None)
    optim["handler_config"] = {}
    if handler is not None:
        optim["handler_config"] = type_record(handler, "handler") | {
            "fixed_params": numpy_dict_to_list(copy(handler.fixed_params)),
            "options": handler.problem_opts,
        }
        if handler.missing_poses is not None:
            optim["handler_config"]["missing_poses"] = (
                np.asarray(handler.missing_poses).astype(int).tolist())

        target = handler.target
        optim["target_config"] = type_record(target, "target")
        if hasattr(target, "input_args"):
            optim["target_config"]["input"] = target.input_args

        table = handler.detection
        optim["dtct_config"] = type_record(table, "dtct") | {
            "cam_names": table.cam_names,
            "max_ims": int(table.max_ims),
            "compressed_data": compress(table.get_data()),
        }

    if getattr(cams, "calibration_result", None) is not None:
        optim["results"] = compress(np.asarray(cams.calibration_result))
    if getattr(cams, "calibration_jac", None) is not None:
        optim["jac"] = compress(np.asarray(cams.calibration_jac))

    Path(f_name).write_text(json.dumps(doc, indent=4))


def load_CameraSet(f_loc: Path | str):
    """Load a CameraSet from JSON, rebuilding the calibration history
    (detection, target, handler) by the names the file gives; the first
    stage that fails downgrades the load to a bare CameraSet, with a
    warning."""
    saved = json.loads(Path(f_loc).read_text())
    classes = _port_classes()

    cam_dict = {
        name: classes["Camera"](
            name=name, extrinsic=np.array(rec["ext"]),
            intrinsic=np.array(rec["int"]),
            distortion_coefs=np.array(rec["dst"]), res=np.array(rec["res"]))
        for name, rec in saved["cams"].items()
    }
    camset = classes["CameraSet"](camera_dict=cam_dict)

    def rebuild_detection():
        rec = saved["optim"]["dtct_config"]
        return instance_obj(rec["dtct_module"], rec["dtct_name"],
                            data=decompress(rec["compressed_data"]),
                            cam_names=rec["cam_names"],
                            max_ims=rec["max_ims"])

    def rebuild_target():
        rec = saved["optim"]["target_config"]
        return instance_obj(rec["target_module"], rec["target_name"],
                            **rec["input"])

    def rebuild_handler(detection, target):
        rec = saved["optim"]["handler_config"]
        kwargs = dict(camset=camset, target=target, detection=detection,
                      fixed_params=rec["fixed_params"],
                      options=rec["options"])
        if "missing_poses" in rec:
            kwargs["missing_poses"] = np.array(
                rec["missing_poses"]).astype(bool)
        return instance_obj(rec["handler_module"], rec["handler_name"],
                            **kwargs)

    def attach_results():
        camset.calibration_result = decompress(saved["optim"]["results"])
        camset.calibration_params = np.array(saved["optim"]["params"])

    try:
        stage = "detection table"
        detection = rebuild_detection()
        stage = "calibration target"
        target = rebuild_target()
        stage = "parameter handler"
        handler = rebuild_handler(detection, target)
        stage = "optimisation results"
        attach_results()
    except Exception as err:
        logging.warning(
            f"Could not rebuild the {stage} from {f_loc} ({err}); "
            "loading the bare CameraSet without calibration history")
        return camset

    camset.calibration_handler = handler
    return camset
