"""The calibration pipeline's last step: the joint bundle adjustment.

Counterpart of ``run_stereo_calibration`` in
``pycamset_tpu/calibration/camera_calibrator.py`` (``:337-363``): seed
cameras and a TargetDetection in, a calibrated CameraSet (with its
calibration history) out, saved to a ``.camset`` file if asked. The solve
runs on ``device``, the card unless the caller names another.

The image-folder front of ``calibrate_cameras`` (detection, the
``cv2.calibrateCamera`` seed, the ChArUco and Ccube targets) is the next
slice of ROADMAP Queue A item 3. ``problem_options={"rolling_shutter":
r}`` calibrates a rolling-shutter rig (``RSTemplateBundleHandler``: the
reference camera's readout pinned to r, True meaning 1.0), as in the JAX
package.
"""
from __future__ import annotations

import logging
from pathlib import Path

from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
from pycamset_tpu_torch.optim.handlers import (RSTemplateBundleHandler,
                                               TemplateBundleHandler)


def run_stereo_calibration(
        cams, detections, target, param_handler=None, save: bool = True,
        save_loc: Path | None = None, fixed_params: dict | None = None,
        floc: Path | None = None, threads: int = 1,
        problem_options: dict | None = None, device="cuda", dtype=None):
    """The full multiview calibration: a target-pose bundle adjustment.

    :param param_handler: a prepared handler: a ``TemplateBundleHandler``
        (e.g. seeded through ``set_initial_params``), a ``SelfBundleHandler``
        (e.g. warm-started by ``set_from_templated_camset`` from a template
        solve; the result is gauge-aligned onto the reference target) or a
        ``FreePointBundleHandler``; else a ``TemplateBundleHandler`` (an
        ``RSTemplateBundleHandler`` where ``problem_options`` sets
        ``"rolling_shutter"``) is built from ``cams``, ``detections``,
        ``target``, ``fixed_params`` and ``problem_options``.
    :param floc: an image folder to read each camera's resolution from
        before saving (an OpenCV read).
    """
    logging.info("Starting the joint multiview bundle adjustment")
    if param_handler is None:
        handler_cls = (RSTemplateBundleHandler
                       if (problem_options or {}).get("rolling_shutter")
                       else TemplateBundleHandler)
        param_handler = handler_cls(
            camset=cams, detection=detections, target=target,
            fixed_params=fixed_params, options=problem_options)

    _opt_result, solved_cams = run_bundle_adjustment(
        param_handler=param_handler, threads=threads, dtype=dtype,
        backend=param_handler.problem_opts.get("backend", "auto"),
        device=device)
    param_handler.camset = solved_cams

    if save:
        if floc is not None:
            solved_cams.set_resolutions_from_file(floc)
        solved_cams.save(save_loc if save_loc is not None
                         else Path("optimised_cameras.camset"))
    return solved_cams
