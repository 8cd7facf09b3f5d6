"""Composable function blocks (counterpart of ``pycamset_tpu/optim/blocks.py``).

A block is a plain function on tensors and a chain is their composition,
evaluated right to left (the LAST block feeds the one before it). The port
carries the blocks of the template chain
``Projection + Extrinsic3D + TemplatePoints``, of the self-calibration
chain ``Projection + Extrinsic3D + RigidTform3d + FreePoint`` and of the
two multi-target chains, ``... + RigidTform3d + GroupRigidTform3d +
FreePoint`` (mixed) and ``... + RigidTform3d + GroupTemplatePoints``
(grouped), and the projection blocks of the five camera models
(``Projection`` standard, ``ProjectionRational``, ``ProjectionThinPrism``,
``ProjectionTilted``, ``ProjectionFisheye``), with ``ProjectionHet``, the
per-camera family selector of a rig mixing fisheye and Brown cameras, and
the rolling-shutter chain's ``RSPoseVel + RSTemplateTime`` (a per-detection
aux channel, the normalised image row). The structured backend chooses a
closed form by the block class names, as the JAX package does, so the names
are kept; any other chain of blocks runs its forward-mode route.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import torch

from pycamset_tpu_torch.ops.projection import (project_cam_points,
                                               project_cam_points_het)
from pycamset_tpu_torch.ops.transforms import pose_apply


class key_type(enum.IntEnum):
    """Binds a parameter group to a detection table column."""
    PER_CAM = 0
    PER_IMG = 1
    PER_KEY = 2
    SINGLE = 3
    PER_GROUP = 4


@dataclass(frozen=True)
class ParamSpec:
    """A (link type, parameter count) descriptor; hashable so identical
    groups are deduplicated across blocks."""
    link: key_type
    n: int


class FunctionBlock:
    """A chunk of the cost model: consumes ``num_inp`` values from the block
    to its right, reads ``params.n`` parameters, produces ``num_out`` values.
    """
    num_inp: int = 0
    num_out: int = 0
    params: ParamSpec
    template: bool = False  # reads its input from the target template table
    # per-detection auxiliary channels consumed (the normalised image row of
    # a rolling-shutter chain); compute() then takes (params, inp, aux)
    aux_inputs: int = 0

    def compute(self, params: torch.Tensor,
                inp: torch.Tensor | None) -> torch.Tensor:
        """Evaluation of the block on (..., n) params and (..., num_inp)
        inputs."""
        raise NotImplementedError

    def __add__(self, other):
        from pycamset_tpu_torch.optim.chain import OptimFunction
        if isinstance(other, FunctionBlock):
            return OptimFunction([self, other])
        if isinstance(other, OptimFunction):
            return OptimFunction([self] + other.blocks)
        return NotImplemented

    def __radd__(self, other):
        from pycamset_tpu_torch.optim.chain import OptimFunction
        if isinstance(other, OptimFunction):
            return OptimFunction(other.blocks + [self])
        return NotImplemented


class Projection(FunctionBlock):
    """Pinhole + Brown–Conrady projection; 9 PER_CAM params
    [fx, px, fy, py, k1, k2, p1, p2, k3]."""
    num_inp = 3
    num_out = 2
    params = ParamSpec(key_type.PER_CAM, 9)

    def compute(self, params, inp):
        return project_cam_points(params, inp)


class ProjectionRational(Projection):
    """Pinhole + rational-model projection; 12 PER_CAM params
    [fx, px, fy, py, k1, k2, p1, p2, k3, k4, k5, k6], radial =
    (1 + k1 r2 + k2 r4 + k3 r6) / (1 + k4 r2 + k5 r4 + k6 r6) (OpenCV's
    CALIB_RATIONAL_MODEL)."""
    params = ParamSpec(key_type.PER_CAM, 12)


class ProjectionThinPrism(Projection):
    """Pinhole + rational + thin-prism projection; 16 PER_CAM params
    [..., k4, k5, k6, s1, s2, s3, s4] (CALIB_RATIONAL_MODEL |
    CALIB_THIN_PRISM_MODEL)."""
    params = ParamSpec(key_type.PER_CAM, 16)


class ProjectionTilted(Projection):
    """Pinhole + rational + thin-prism + sensor-tilt projection; 18 PER_CAM
    params [..., s1, s2, s3, s4, taux, tauy] (OpenCV's full 14-coefficient
    model, CALIB_TILTED_MODEL)."""
    params = ParamSpec(key_type.PER_CAM, 18)


class ProjectionFisheye(Projection):
    """Fisheye (Kannala-Brandt, cv2.fisheye) projection; 8 PER_CAM params
    [fx, px, fy, py, k1, k2, k3, k4], the pixel radius proportional to
    theta_d = theta (1 + k1 th^2 + ... + k4 th^8)."""
    params = ParamSpec(key_type.PER_CAM, 8)


class ProjectionHet(Projection):
    """Per-camera projection FAMILY selector: fisheye (Kannala-Brandt)
    cameras beside cameras of one Brown model in one bundle adjustment.
    PER_CAM params [sel, fx, px, fy, py, dist...]: ``sel`` (0 Brown, 1
    fisheye) is never free, and the distortion slots hold the Brown
    model's ``brown_n_dist`` coefficients or the fisheye's k1..k4 (+ zero
    padding, never free)."""

    def __init__(self, brown_model: str = "standard"):
        widths = {"standard": 5, "rational": 8, "thin_prism": 12,
                  "tilted": 14}
        if brown_model not in widths:
            raise ValueError(
                f"brown_model {brown_model!r} not a Brown-family model "
                f"(expected one of {sorted(widths)})")
        self.brown_model = brown_model
        self.brown_n_dist = widths[brown_model]
        self.params = ParamSpec(key_type.PER_CAM,
                                5 + max(self.brown_n_dist, 4))

    def compute(self, params, inp):
        return project_cam_points_het(params, inp,
                                      brown_n_dist=self.brown_n_dist)


class RigidTform3d(FunctionBlock):
    """SE(3) transform of a 3-input point; 6 PER_IMG params [rvec, t]."""
    num_inp = 3
    num_out = 3
    params = ParamSpec(key_type.PER_IMG, 6)

    def compute(self, params, inp):
        return pose_apply(params, inp)


class Extrinsic3D(RigidTform3d):
    """RigidTform3d bound per camera (the camera extrinsic)."""
    params = ParamSpec(key_type.PER_CAM, 6)


class TemplatePoints(RigidTform3d):
    """SE(3) pose of the target; the input point comes from the constant
    template lookup table rather than a previous block."""
    template = True
    num_inp = 0
    num_out = 3
    params = ParamSpec(key_type.PER_IMG, 6)


class FreePoint(FunctionBlock):
    """A 3D point parameterised by its coordinates; 3 PER_KEY params."""
    num_inp = 0
    num_out = 3
    params = ParamSpec(key_type.PER_KEY, 3)

    def compute(self, params, inp):
        return params


class RSTemplateTime(FunctionBlock):
    """Rolling-shutter template source: emits the template point and the
    detection's sample-time offset ``tau = readout * (v/H - 1/2)`` (output
    width 4 = [pt, tau]). 1 PER_CAM parameter, the readout duration in
    frame units relative to the reference camera's; the normalised-row aux
    channel ``v/H - 1/2`` is computed per detection on the host and rides
    an extra column of the observation grid."""
    num_inp = 0
    num_out = 4
    template = True
    aux_inputs = 1
    params = ParamSpec(key_type.PER_CAM, 1)

    def compute(self, params, inp, aux=None):
        tau = params[..., 0] * (aux[..., 0] if aux is not None
                                else params.new_zeros(()))
        lead = torch.broadcast_shapes(inp.shape[:-1], tau.shape)
        return torch.cat([inp.expand(*lead, 3), tau.expand(lead)[..., None]],
                         dim=-1)


class RSPoseVel(FunctionBlock):
    """Rolling-shutter target motion: 12 PER_IMG params [pose6 | vel6];
    consumes [pt (3), tau (1)] and applies the pose sampled at tau,
    ``pose + vel * tau`` (constant velocity within the frame)."""
    num_inp = 4
    num_out = 3
    params = ParamSpec(key_type.PER_IMG, 12)

    def compute(self, params, inp):
        pose = params[..., :6] + params[..., 6:] * inp[..., 3:4]
        return pose_apply(pose, inp[..., :3])


class GroupRigidTform3d(RigidTform3d):
    """SE(3) transform bound per feature group — e.g. the relative pose of
    each of several rigidly-coupled calibration targets."""
    params = ParamSpec(key_type.PER_GROUP, 6)


class GroupTemplatePoints(TemplatePoints):
    """Template lookup + SE(3) transform bound per feature GROUP: each
    group's points are one rigid target posed relative to the base
    target's frame."""
    params = ParamSpec(key_type.PER_GROUP, 6)
