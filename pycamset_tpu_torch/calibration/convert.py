"""Camera model conversion: refit one distortion family onto another.

Counterpart of ``pycamset_tpu/calibration/convert.py``. Many downstream
tools speak one distortion family only; ``convert_camera_model`` refits the
target family to reproduce the SOURCE camera's projection over a dense
pixel grid:

1. sample a grid of source pixels, lift them to camera-frame rays by
   inverting the source model (``Camera.undistort_points``, fisheye-aware),
   keeping only rays the source model round-trips within ``lift_tol_px``;
2. fit the target family's packed intrinsic vector so that projecting those
   rays lands back on the pixels: ``optim/lm.lm_solve`` on the pixel
   residuals, on the tensors' device, with the closed-form intrinsic
   partials of ``optim/analytic.projection_partials`` (the JAX package
   takes ``jax.jacfwd`` there). The LM is the host-looped one (one status
   read a step): a fit of 8-18 parameters stops within a few steps, where
   the masked device loop would run all ``max_nfev - 1``.

The report carries the conversion rms / max in px: families are not
nested, so the residual is the answer to "can model B express lens A".
"""
from __future__ import annotations

import logging

import numpy as np
import torch

logger = logging.getLogger(__name__)

_WIDTHS = {"standard": 9, "rational": 12, "thin_prism": 16, "tilted": 18,
           "fisheye": 8}


def _model_of_cam(cam) -> str:
    n = int(np.reshape(np.asarray(cam.distortion_coefs), -1).size)
    if n == 4:
        return "fisheye"
    return {5: "standard", 8: "rational", 12: "thin_prism",
            14: "tilted"}.get(n, "standard")


def _fit_neq(intr_t, rays, uv):
    """(JtJ, grad, cost) of the pixel residuals of ``rays`` through the
    packed intrinsics ``intr_t``."""
    from pycamset_tpu_torch.optim.analytic import projection_partials
    pred, d_intr, _ = projection_partials(intr_t, rays)
    r = pred - uv
    j = d_intr.reshape(-1, intr_t.shape[-1])
    return j.T @ j, j.T @ r.reshape(-1), torch.sum(r * r)


def convert_camera_model(cam, to: str = "standard", grid: int = 40,
                         margin: float = 0.02, max_nfev: int = 200,
                         lift_tol_px: float = 0.05, device="cuda",
                         dtype=None):
    """Refit ``cam``'s projection with the ``to`` distortion family.

    :param cam: source Camera (any supported model).
    :param to: target family, "standard" | "rational" | "thin_prism" |
        "tilted" | "fisheye".
    :param grid: sample grid resolution per image axis.
    :param margin: border fraction excluded from sampling.
    :param lift_tol_px: rays whose source-model round trip misses the
        original pixel by more than this are dropped from the fit.
    :param device: where the lift and the fit run (the card unless the
        caller names another); :param dtype: their dtype.
    :return: (new Camera with the fitted model, same extrinsic, name and
        resolution; report dict with rms_px / max_px / n_points, the
        packed fitted intrinsics, nit, nfev and status).
    """
    from pycamset_tpu_torch.config import default_device_dtype, resolve_device
    from pycamset_tpu_torch.models.camera import Camera
    from pycamset_tpu_torch.ops.projection import (intr9_from_k_dist,
                                                   project_cam_points)
    from pycamset_tpu_torch.optim.lm import lm_solve

    if to not in _WIDTHS:
        raise ValueError(f"unknown target model {to!r}; expected one of "
                         f"{sorted(_WIDTHS)}")
    device = resolve_device(device)
    dtype = dtype or default_device_dtype(device)
    res = np.asarray(cam.res, dtype=float)

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=dtype,
                               device=device)

    # -- 1. sample source pixels, lift them to rays through the source model
    mx, my = margin * res[0], margin * res[1]
    u = np.linspace(mx, res[0] - mx, grid)
    v = np.linspace(my, res[1] - my, grid)
    uv = np.stack(np.meshgrid(u, v), axis=-1).reshape(-1, 2)
    ideal = cam.undistort_points(uv, iters=25, device=device, dtype=dtype)
    kinv = np.linalg.inv(np.asarray(cam.intrinsic, dtype=float))
    rays = np.concatenate([ideal, np.ones((len(ideal), 1))], axis=1) \
        @ kinv.T                                     # z = 1 camera frame

    src_dist = np.reshape(np.asarray(cam.distortion_coefs, float), -1)
    src_intr = intr9_from_k_dist(dev(cam.intrinsic), dev(src_dist),
                                 n_dist=max(4, src_dist.size))
    back = project_cam_points(src_intr, dev(rays)).double().cpu().numpy()
    ok = np.linalg.norm(back - uv, axis=1) < lift_tol_px
    if ok.sum() < 16:
        raise ValueError(
            f"only {int(ok.sum())} of {len(uv)} sampled pixels lift "
            "through the source model — increase margin or grid")
    rays_d, uv_d = dev(rays[ok]), dev(uv[ok])

    # -- 2. fit the target family's packed intrinsics on the device
    k = np.asarray(cam.intrinsic, dtype=float)
    x0 = np.zeros(_WIDTHS[to])
    x0[:4] = [k[0, 0], k[0, 2], k[1, 1], k[1, 2]]
    out = lm_solve(lambda p: _fit_neq(p, rays_d, uv_d), dev(x0),
                   max_nfev=max_nfev)
    err = project_cam_points(out.x, rays_d) - uv_d
    # the one read-back of the fit
    fit, err, nit, nfev, status = (
        t.double().cpu().numpy()
        for t in (out.x, err, out.nit, out.nfev, out.status))
    eucl = np.linalg.norm(err, axis=1)

    k_new = np.array([[fit[0], 0.0, fit[1]],
                      [0.0, fit[2], fit[3]],
                      [0.0, 0.0, 1.0]])
    new_cam = Camera(extrinsic=np.asarray(cam.extrinsic).copy(),
                     intrinsic=k_new, res=np.asarray(cam.res).copy(),
                     distortion_coefs=fit[4:], name=cam.name)
    report = {
        "from": _model_of_cam(cam), "to": to,
        "rms_px": float(np.sqrt(np.mean(eucl ** 2))),
        "max_px": float(eucl.max()),
        "n_points": int(ok.sum()), "n_dropped": int((~ok).sum()),
        "intr": fit, "nit": int(nit), "nfev": int(nfev),
        "status": int(status),
    }
    if report["rms_px"] > 0.5:
        logger.warning(
            "model conversion %s -> %s leaves %.2f px rms (max %.2f): the "
            "target family cannot fully express this lens",
            report["from"], to, report["rms_px"], report["max_px"])
    return new_cam, report


def convert_camera_set(cams, to: str = "standard", **kwargs):
    """Convert every camera of a rig (extrinsics, names and order kept).

    :return: (new CameraSet, {camera name: conversion report}).
    """
    from pycamset_tpu_torch.models.camera_set import CameraSet

    new = {}
    reports = {}
    for name in cams.get_names():
        new[name], reports[name] = convert_camera_model(cams[name], to=to,
                                                        **kwargs)
    return CameraSet(camera_dict=new), reports
