"""Bundle-adjustment optimisation: blocks, chains, LM solver, handlers.

The exports of ``pycamset_tpu/optim/__init__.py``: the function blocks
and chain layout, the generic LM (``LMResult``, ``lm_solve``,
``lm_solve_masked``), the three handlers (template, self-calibration,
free-point) with the free-point target, ``make_optimisation_function``,
``run_bundle_adjustment``, ``calibration_uncertainty`` and
``parameter_covariance``; beside them the port's own camera-model
projection blocks and the fleet's ``run_fleet_bundle_adjustment`` with its
``FleetMismatch``.
"""
from pycamset_tpu_torch.optim.blocks import (
    Extrinsic3D, FreePoint, FunctionBlock, ParamSpec, Projection,
    ProjectionFisheye, ProjectionHet, ProjectionRational,
    ProjectionThinPrism, ProjectionTilted, RigidTform3d, TemplatePoints,
    key_type)
from pycamset_tpu_torch.optim.chain import OptimFunction, ParamStruct
from pycamset_tpu_torch.optim.lm import LMResult, lm_solve, lm_solve_masked
from pycamset_tpu_torch.optim.handlers import (
    DEFAULT_OPTIONS, FreePointBundleHandler, FreePointTarget,
    SelfBundleHandler, TemplateBundleHandler, estimate_camera_relative_poses)
from pycamset_tpu_torch.optim.driver import (
    make_optimisation_function, run_bundle_adjustment)
from pycamset_tpu_torch.optim.uncertainty import (
    calibration_uncertainty, parameter_covariance)

__all__ = [
    "FunctionBlock", "ParamSpec", "key_type", "Projection",
    "ProjectionRational", "ProjectionThinPrism", "ProjectionTilted",
    "ProjectionFisheye", "ProjectionHet", "RigidTform3d",
    "Extrinsic3D", "TemplatePoints", "FreePoint", "OptimFunction",
    "ParamStruct", "LMResult", "lm_solve", "lm_solve_masked",
    "DEFAULT_OPTIONS", "TemplateBundleHandler", "SelfBundleHandler",
    "FreePointBundleHandler", "FreePointTarget",
    "estimate_camera_relative_poses", "make_optimisation_function",
    "run_bundle_adjustment", "calibration_uncertainty",
    "parameter_covariance", "run_fleet_bundle_adjustment", "FleetMismatch",
]


def __getattr__(name):
    # the fleet loads on first use: the single-rig user path does not load
    # it (tests/test_torch_slice.py)
    if name in ("run_fleet_bundle_adjustment", "FleetMismatch"):
        from pycamset_tpu_torch.optim import fleet
        return getattr(fleet, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
