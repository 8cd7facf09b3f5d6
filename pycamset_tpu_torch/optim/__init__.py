"""Bundle-adjustment optimisation: blocks, chains, handlers and
``run_bundle_adjustment``.

The exports of ``pycamset_tpu/optim/__init__.py`` that the port has: the
function blocks and chain layout, the three handlers (template,
self-calibration, free-point) with the free-point target,
``run_bundle_adjustment``, and the fleet's ``run_fleet_bundle_adjustment``
with its ``FleetMismatch``. The generic LM (``lm_solve``), the uncertainty
module and ``make_optimisation_function`` are ROADMAP Queue A item 8.
"""
from pycamset_tpu_torch.optim.blocks import (
    Extrinsic3D, FreePoint, FunctionBlock, ParamSpec, Projection,
    ProjectionFisheye, ProjectionHet, ProjectionRational,
    ProjectionThinPrism, ProjectionTilted, RigidTform3d, TemplatePoints,
    key_type)
from pycamset_tpu_torch.optim.chain import OptimFunction, ParamStruct
from pycamset_tpu_torch.optim.handlers import (
    DEFAULT_OPTIONS, FreePointBundleHandler, FreePointTarget,
    SelfBundleHandler, TemplateBundleHandler, estimate_camera_relative_poses)
from pycamset_tpu_torch.optim.driver import run_bundle_adjustment

__all__ = [
    "FunctionBlock", "ParamSpec", "key_type", "Projection",
    "ProjectionRational", "ProjectionThinPrism", "ProjectionTilted",
    "ProjectionFisheye", "ProjectionHet", "RigidTform3d",
    "Extrinsic3D", "TemplatePoints", "FreePoint", "OptimFunction",
    "ParamStruct", "DEFAULT_OPTIONS", "TemplateBundleHandler",
    "SelfBundleHandler", "FreePointBundleHandler", "FreePointTarget",
    "estimate_camera_relative_poses", "run_bundle_adjustment",
    "run_fleet_bundle_adjustment", "FleetMismatch",
]


def __getattr__(name):
    # the fleet loads on first use: the single-rig user path does not load
    # it (tests/test_torch_slice.py)
    if name in ("run_fleet_bundle_adjustment", "FleetMismatch"):
        from pycamset_tpu_torch.optim import fleet
        return getattr(fleet, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
