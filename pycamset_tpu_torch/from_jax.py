"""Carry the JAX package's problem data over to the port.

The inputs are numpy arrays (``np.asarray`` of a JAX array, or the JAX
package's host-numpy pieces); the outputs are the port's tensors on a given
device and dtype, or its CameraSet and TargetDetection. This module imports no JAX: a caller that holds JAX arrays
converts them with ``np.asarray`` first.
"""
from __future__ import annotations

import numpy as np
import torch

from pycamset_tpu_torch.config import resolve_device
from pycamset_tpu_torch.models.camera_set import CameraSet, make_cam_dict
from pycamset_tpu_torch.models.detections import TargetDetection
from pycamset_tpu_torch.optim.fleet import shared_template
from pycamset_tpu_torch.optim.shared_intr import TiedNormalEq, TiedPieces
from pycamset_tpu_torch.optim.structured import (
    ParamPieces, chain_widths, pad_pieces_to_grid, split_full_params)
from pycamset_tpu_torch.optim.structured_driver import build_colmask_pieces
from pycamset_tpu_torch.optim.structured_mixed import MixedPieces


def tensor_from_numpy(a, device, dtype) -> torch.Tensor:
    """A contiguous tensor copy of a numpy array on ``device``."""
    return torch.as_tensor(np.ascontiguousarray(np.asarray(a)), dtype=dtype,
                           device=resolve_device(device))


def pieces_from_numpy(cam, im, key, device, dtype) -> ParamPieces:
    """(cam, im, key) numpy pieces -> ParamPieces; also the column masks
    (a colmask is a ParamPieces of 0/1 entries)."""
    return ParamPieces(*(tensor_from_numpy(p, device, dtype)
                         for p in (cam, im, key)))


def handler_pieces_from_numpy(op_fun, full, unfixed, n_cams: int,
                              n_ims: int, n_keys: int, n_ims_grid: int,
                              k_pad: int, device, dtype):
    """A handler's full parameter vector and unfixed mask (numpy: a JAX
    handler's ``bundlePrimitive.base_full()`` with its start placed at
    ``unfixed_full()``, and that mask, which folds in a mixed-model rig's
    per-column ``intr_colmask``) -> (start ParamPieces, column-mask
    ParamPieces) of the port's chain ``op_fun`` on the padded grid, as
    ``build_structured_problem`` lays them out: pad key rows replicate key
    0 and pad images image 0, neither ever free; a pose-free chain's image
    piece is zero-width, (n_ims_grid, 0)."""
    widths = chain_widths(op_fun)
    struct = op_fun.param_struct(n_cams, n_ims, n_keys)
    full = np.asarray(full, dtype=np.float64)
    start = pad_pieces_to_grid(
        split_full_params(torch.as_tensor(full), op_fun, struct, n_cams,
                          n_ims, n_keys, widths),
        widths, False, n_keys, k_pad, n_ims, n_ims_grid)
    colmask = build_colmask_pieces(full, np.asarray(unfixed, dtype=bool),
                                   op_fun, struct, widths, n_cams, n_ims,
                                   n_keys, k_pad, n_ims_grid)
    return tuple(pieces_from_numpy(*(t.numpy() for t in p), device, dtype)
                 for p in (start, colmask))


def grid_from_numpy(uv, mask, tpl, device, dtype):
    """(uv (B,K,2 + A), mask (B,K), tpl (K,3)) numpy -> tensors; a chain
    with aux channels (the rolling-shutter row) carries them in uv's
    trailing columns, as ``build_block_arrays`` lays them out."""
    return tuple(tensor_from_numpy(a, device, dtype) for a in (uv, mask, tpl))


def mixed_pieces_from_numpy(cam, im, key, grp, device, dtype) -> MixedPieces:
    """(cam, im, key, grp) numpy pieces of a mixed chain, or its column
    masks -> MixedPieces."""
    return MixedPieces(*(tensor_from_numpy(p, device, dtype)
                         for p in (cam, im, key, grp)))


def tied_pieces_from_numpy(shared, cam, im, device, dtype) -> TiedPieces:
    """(shared, cam, im) numpy pieces of the tied system (a JAX
    ``TiedPieces``, each field through ``np.asarray``) -> TiedPieces."""
    return TiedPieces(*(tensor_from_numpy(p, device, dtype)
                        for p in (shared, cam, im)))


def tied_neq_from_numpy(fields, device, dtype) -> TiedNormalEq:
    """A tied system's normal equations as numpy, in ``TiedNormalEq``'s
    field order (a JAX ``TiedNormalEq``: ``[np.asarray(f) for f in neq]``)
    -> TiedNormalEq."""
    return TiedNormalEq(*(tensor_from_numpy(f, device, dtype)
                          for f in fields))


def fleet_from_numpy(pieces, uv, mask, tpl, device, dtype):
    """A fleet's stacked numpy data (``bench.py::fleet_problem``: the
    pieces, uv, mask and point tables, each with a leading rig axis) ->
    (ParamPieces, uv, mask, the one (K, 3) point table the port's fleet
    shares); raises ``ValueError`` unless every rig has the same table
    (``optim.fleet.shared_template``)."""
    return (pieces_from_numpy(*pieces, device, dtype),
            tensor_from_numpy(uv, device, dtype),
            tensor_from_numpy(mask, device, dtype),
            tensor_from_numpy(shared_template(np.asarray(tpl)), device,
                              dtype))


def camset_from_numpy(names, ext4x4, kmats, dists, res):
    """A CameraSet of the port from per-camera numpy arrays (a JAX
    package's CameraSet as ``[c.extrinsic for c in cams]`` etc.; each
    camera's distortion at its own width, so a mixed-model rig carries
    over: 4-wide fisheye beside 5- to 14-wide Brown cameras)."""
    return CameraSet(camera_dict=make_cam_dict(
        list(names), [np.asarray(e, dtype=float) for e in ext4x4],
        [np.asarray(k, dtype=float) for k in kmats],
        [np.asarray(d, dtype=float) for d in dists],
        [list(np.asarray(r).tolist()) for r in res]))


def detection_from_numpy(cam_names, table, max_ims):
    """A TargetDetection of the port from a detection table (numpy,
    [cam, im, key..., u, v] rows) and its image count."""
    return TargetDetection(cam_names=list(cam_names),
                           data=np.array(table, dtype=float),
                           max_ims=int(max_ims))


def rs_primitive_from_numpy(handler, intr, extr, poses12, readout,
                            pose_colmask):
    """A rolling-shutter handler's primitive state from numpy (a JAX
    ``RSBundlePrimitive``'s ``intr`` / ``extr`` rows, ``poses`` (I, 12)
    [pose | velocity], ``readout`` (C, 1) and ``pose_colmask`` (I, 12)),
    written into the port's ``RSTemplateBundleHandler`` ``handler`` in
    place; returns it. The aux channel is the handler's own ``aux_table``
    of the detections (the same v/H - 1/2 in both packages)."""
    prim = handler.bundlePrimitive
    prim.intr[:] = np.asarray(intr, dtype=np.float64)
    prim.extr[:] = np.asarray(extr, dtype=np.float64)
    prim.poses[:] = np.asarray(poses12, dtype=np.float64)
    prim.readout[:] = np.asarray(readout, dtype=np.float64).reshape(-1, 1)
    prim.pose_colmask = np.array(pose_colmask, dtype=bool)
    return handler


def camset_from_jax(cams):
    """The port's CameraSet of a JAX package's CameraSet, read through its
    ``get_names()`` and each camera's extrinsic, intrinsic, distortion and
    resolution (nothing of the JAX package is imported here)."""
    names = cams.get_names()
    return camset_from_numpy(
        names, [cams[n].extrinsic for n in names],
        [cams[n].intrinsic for n in names],
        [np.ravel(cams[n].distortion_coefs) for n in names],
        [cams[n].res for n in names])


def detection_from_jax(det):
    """The port's TargetDetection of a JAX package's one (its camera names,
    table and image count)."""
    return detection_from_numpy(det.cam_names, det.get_data(), det.max_ims)
