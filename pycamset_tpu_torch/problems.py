"""The bench's bundle-adjustment problems, built with the port.

Counterparts of ``bench.py::standard_problem`` / ``template_colmask``,
``bench.py::selfcal_problem`` / ``selfcal_colmask`` and
``bench.py::mixed_problem`` / ``mixed_colmask_groups``, and a grouped
template problem on the mixed problem's rig. Each builds a synthetic rig
(visibility 0.85, 0.3 px noise; seed 0, or 5 for the multi-target ones) and
the (B, K) block grid, standard camera model; the self-calibration, free-point,
multi-target and template-handler makers take ``camera_model`` (the rig
``make_synthetic_rig`` makes for that model, through its projection block).

- Template: the chain Projection + Extrinsic3D + TemplatePoints, the true
  parameters perturbed by ``rng(1)`` with the bench's scale vector, and
  pose 0 zeroed and fixed as the gauge. The one difference: template pad
  rows replicate key 0 (``pad_template_table``) where the bench pads with
  zeros; pad slots are masked, so both give the same normal equations.
- Self-calibration: the chain Projection + Extrinsic3D + RigidTform3d +
  FreePoint, the target points free, started at the true parameters (pad
  key rows replicate key 0), pad keys frozen, a 7-coordinate gauge on the
  points and pose 0 fixed; the template table is zeros.
- Mixed multi-target self-calibration: the chain Projection + Extrinsic3D +
  RigidTform3d + GroupRigidTform3d + FreePoint, two targets (the two halves
  of the grid), started at the true parameters except group 1's relative
  pose, offset by ``GROUP_START[1]``; group 0 fixed, pose 0 fixed, the
  self-cal point gauge; ``max_nfev`` 60. Both halves are one board, so
  the true relative pose of group 1 is the identity (``GROUP_TRUE``).
- Grouped multi-target template: the chain Projection + Extrinsic3D +
  RigidTform3d + GroupTemplatePoints on the same rig, start and gauge (the
  points come from the template). Both multi-target makers take a
  per-camera model list: fisheye beside Brown cameras runs
  ``ProjectionHet`` (the forward-mode route).

- The user path (``template_handler``): the template problem's rig as a
  CameraSet, a TargetDetection and a ``TemplateBundleHandler`` seeded at
  the same start, for ``run_bundle_adjustment`` and
  ``run_stereo_calibration``; with ``template_warp`` the board the cameras
  see is bent away from the nominal target along its normal, so that a
  self-calibration (``SelfBundleHandler``, ``selfcal_stage_handler``)
  after the template one has geometry to recover; with a per-camera
  ``camera_model`` list, a mixed-model rig (fisheye beside Brown cameras,
  or Brown models of several widths).
- Pose-free free points (``freepoint_scene``, ``freepoint_problem``,
  ``freepoint_handler``): the template rig with each image's board points
  as free world points (key = image x 384 + point at grid 19: the points
  of an image padded to a multiple of 128 keys, as a wand calibration's
  frames are independent points), the scene moved by one rigid transform
  so that camera 0 sits at the origin, and the wand's gauge
  (``calibration/wand.py:361-388`` of the JAX package): every lens fixed,
  camera 0's extrinsic the identity and fixed, the largest coordinate of
  an observed point pinned. The start: the true points plus 1 mm of
  ``rng(seed + 1)`` noise, the other cameras' extrinsics moved by 1e-2 as
  the bench's start moves them; never-observed keys frozen.

- Fleet: ``bench.py::fleet_problem``, R template rigs of one structure
  and one target (seeds 100 + r, every start perturbed by one ``rng(7)``
  in rig order), solved as one batch (``optim/fleet.py``); and the same
  rigs as handlers (``fleet_handlers``) of the template, self-calibration,
  grouped and mixed chains, and wand rigs of the free-point chain, for
  ``run_fleet_bundle_adjustment``.
- Rolling shutter (``rs_handler``): the template rig's cameras and grid,
  a capture of a target moving within each frame
  (``utils.synthetic.rs_capture``), each camera's readout drawn in [0.5,
  0.9], as an ``RSTemplateBundleHandler`` seeded without PnP.
- Multi-target handlers (``multi_target_handler``): the mixed and grouped
  problems' rig as the port's ``TwoTargetSelfCalibrator`` /
  ``TwoTargetCalibrator`` (``examples/extend_param_handler.py``), the
  board's halves as the two targets, for ``run_bundle_adjustment``.

Each problem is an ``optim.problem.BAProblem`` (or, for the fleet, a
``FleetProblem``): on a card it owns the CUDA graphs of its LM step, one
per dense-solve route, dtype and budget: the first solve captures one, and
later solves of the same problem replay it. Each maker builds on the card
unless the caller names another device (the tests name the CPU).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from pycamset_tpu_torch.config import default_device_dtype, resolve_device
from pycamset_tpu_torch.from_jax import (camset_from_numpy,
                                         detection_from_numpy,
                                         mixed_pieces_from_numpy,
                                         pieces_from_numpy, tensor_from_numpy)
from pycamset_tpu_torch.ops.cuda_cholesky import psd_opted_in
from pycamset_tpu_torch.optim.blocks import (Extrinsic3D, FreePoint,
                                             GroupRigidTform3d,
                                             GroupTemplatePoints, Projection,
                                             RigidTform3d, TemplatePoints)
from pycamset_tpu_torch.optim.chain import OptimFunction, ParamStruct
from pycamset_tpu_torch.optim.fleet import fleet_solve, shared_template
from pycamset_tpu_torch.optim.handlers import (FreePointBundleHandler,
                                               FreePointTarget,
                                               SelfBundleHandler,
                                               TemplateBundleHandler,
                                               _projection_block)
from pycamset_tpu_torch.optim.problem import BAProblem, MixedProblem
from pycamset_tpu_torch.optim.structured import (
    GroupWidths, ParamPieces, build_block_arrays, chain_widths, group_onehot,
    make_structured_neq, pad_template_table, split_full_params)
from pycamset_tpu_torch.optim.structured_mixed import (MixedPieces,
                                                       mixed_chain_widths)
from pycamset_tpu_torch.optim.structured_driver import (
    build_structured_problem)
from pycamset_tpu_torch.optim.structured_lm import SLMResult
from pycamset_tpu_torch.utils.general_utils import (ext_4x4_to_rod,
                                                    make_4x4h_tform)
from pycamset_tpu_torch.utils.synthetic import make_synthetic_rig


# the multi-target problems' group poses at the start: group 0 is the
# base target (fixed), group 1 starts offset from its true identity pose
GROUP_START = np.array([[0.0] * 6, [0.04, -0.02, 0.06, 0.01, -0.02, 0.03]])
# the multi-target rig's truth: its two targets are the halves of one board
GROUP_TRUE = np.zeros((2, 6))
# each camera model's distortion width
DIST_WIDTH = {"fisheye": 4, "standard": 5, "rational": 8, "thin_prism": 12,
              "tilted": 14}
# rs_handler's capture: the cameras' readouts (frame units) are drawn in
# this range, the target moves within a frame at the JAX package's test
# velocities (rad and m a frame), and the detections carry this noise (px)
RS_READOUT_RANGE = (0.5, 0.9)
RS_VEL_ROT, RS_VEL_TR = 0.15, 0.08
RS_NOISE_PX = 0.3


def template_colmask(n_cams, n_ims, widths, k_pad, dtype=np.float64):
    """Unfixed masks (host numpy) of the bench template problem: pose 0 is
    the gauge."""
    cm_im = np.ones((n_ims, widths.b), dtype=dtype)
    cm_im[0] = 0.0
    return (np.ones((n_cams, widths.a), dtype=dtype), cm_im,
            np.ones((k_pad, 0), dtype=dtype))


def perturbed_start(rig, struct, seed=1, het: bool = False) -> np.ndarray:
    """The bench's perturbed full parameter vector (pose 0 zeroed).

    :param seed: an int, or a ``np.random.Generator`` to draw from (the
        fleet perturbs every rig from one generator).
    :param het: ``rig["intr"]`` holds heterogeneous rows [sel | fx px fy
        py | dist slots]: the selector is not moved."""
    n_cams, n_ims = rig["n_cams"], rig["n_ims"]
    x_full = np.concatenate([rig["intr"].ravel(), rig["extr"].ravel(),
                             rig["poses"].ravel()])
    rng = np.random.default_rng(seed)
    # the bench's intrinsic scales, 1e-4 for each coefficient past the
    # standard model's (the other camera models)
    intr_w = rig["intr"].shape[1]
    intr_scale = ([0.0] if het else []) + (
        [10.0, 5, 10, 5, 1e-2, 1e-3, 1e-4, 1e-4, 1e-4]
        + [1e-4] * 9)[:intr_w - int(het)]
    scale = np.concatenate([
        np.tile(intr_scale, n_cams),
        np.tile([1e-2] * 6, n_cams),
        np.tile([1e-2] * 6, n_ims),
    ])
    x_full = x_full + rng.normal(size=struct.total) * scale
    pose_sl = struct.group_slice(2)
    x_full[pose_sl.start:pose_sl.start + 6] = 0.0  # gauge: pose 0 fixed
    return x_full


def standard_problem(n_cams: int, n_ims: int, device="cuda",
                     dtype=None, grid: int = 19, seed: int = 0,
                     k_pad_multiple: int = 128, loss: str = "linear",
                     f_scale: float = 1.0,
                     loss_semantics: str = "component") -> BAProblem:
    """``bench.py::standard_problem(n_cams, n_ims, grid, seed)`` on
    ``device`` (dtype defaults to float64 on the CPU, float32 on CUDA)."""
    device = resolve_device(device)
    dtype = dtype or default_device_dtype(device)
    rig = make_synthetic_rig(n_cams=n_cams, n_ims=n_ims, grid=grid,
                             visibility=0.85, noise_px=0.3, seed=seed)
    n_keys = rig["n_keys"]
    op_fun = OptimFunction([Projection(), Extrinsic3D(), TemplatePoints()])
    widths = chain_widths(op_fun)
    struct = op_fun.param_struct(n_cams, n_ims, n_keys)
    blocks = build_block_arrays(rig["dd"], n_cams, n_ims, n_keys,
                                k_pad_multiple=k_pad_multiple)
    k_pad = blocks.uv.shape[1]
    tpl = pad_template_table(rig["template"], True, n_keys, k_pad)
    x_full = perturbed_start(rig, struct)
    p = split_full_params(torch.as_tensor(x_full), op_fun, struct, n_cams,
                          n_ims, n_keys, widths)
    x0 = pieces_from_numpy(p.cam.numpy(), p.im.numpy(), np.zeros((k_pad, 0)),
                           device, dtype)
    uv, mask = blocks.as_device(device, dtype)
    tpl_t = tensor_from_numpy(tpl, device, dtype)
    colmask = pieces_from_numpy(*template_colmask(n_cams, n_ims, widths,
                                                  k_pad), device, dtype)
    return BAProblem(op_fun, widths, struct, blocks, x0, uv, mask, tpl_t,
                     colmask, loss, f_scale, loss_semantics)


def _rig_cams(intr, exts, models=None):
    """A CameraSet ``cam0``, ``cam1``, ... (1600 x 1200) of packed
    intrinsic rows [fx, px, fy, py | dist] and 4x4 extrinsics, and its
    names; with ``models`` (one per camera: ``make_synthetic_rig``'s
    ``camera_models``) each camera's distortion cut to its own model's
    width (4 fisheye, 5 / 8 / 12 / 14 Brown)."""
    names = [f"cam{c}" for c in range(len(intr))]
    kmats = [np.array([[i9[0], 0, i9[1]], [0, i9[2], i9[3]], [0, 0, 1]])
             for i9 in intr]
    dists = ([i9[4:] for i9 in intr] if models is None else
             [i9[4:4 + DIST_WIDTH[m]] for i9, m in zip(intr, models)])
    return camset_from_numpy(names, exts, kmats, dists,
                             [[1600, 1200]] * len(intr)), names


def template_handler(n_cams: int, n_ims: int, grid: int = 19, seed: int = 0,
                     options: dict | None = None,
                     template_warp: float = 0.0,
                     camera_model: str = "standard",
                     shared_intrinsics=None, fixed_lenses: bool = False):
    """``standard_problem``'s rig as a user holds it: a CameraSet of the
    rig's cameras (1600 x 1200), the TargetDetection of its table, the grid
    as a ``FreePointTarget``, and a ``TemplateBundleHandler`` (options
    ``outliers: "n"``, ``verbosity: 0``, ``camera_model``, then
    ``options``) seeded through ``set_initial_params`` at the bench's
    perturbed start (pose 0 the gauge): no PnP, no OpenCV.

    :param template_warp: the RMS (metres) of the board's bend along its
        normal (``make_synthetic_rig``): the detections see the bent board
        (``rig["template_true"]``), the target stays the nominal grid.
    :param camera_model: the rig's lens model (``make_synthetic_rig``'s:
        "standard", "rational", "thin_prism", "tilted" or "fisheye"), or a
        list of one model a camera (fisheye beside Brown cameras, Brown
        models of several widths); the cameras carry their true
        distortion at their own model's width, and the handler solves the
        map (a heterogeneous rig's start: the true selector rows
        perturbed, ``perturbed_start(het=True)``).
    :param shared_intrinsics: None, True (every camera one lens) or
        per-camera group ids: the rig's cameras share their group's true
        lens, and the handler ties them (its ``shared_intrinsics``
        option).
    :param fixed_lenses: every camera's true lens fixed (``fixed_params``
        "int" and "dst"): only the extrinsics and the poses are free.
    :return: (handler, rig)."""
    rig = make_synthetic_rig(n_cams=n_cams, n_ims=n_ims, grid=grid,
                             visibility=0.85, noise_px=0.3, seed=seed,
                             template_warp=template_warp,
                             camera_model=camera_model,
                             shared_intrinsics=shared_intrinsics)
    options = {**_tied_option(shared_intrinsics), **(options or {})}
    cams, names = _rig_cams(rig["intr"], [make_4x4h_tform(e[:3], e[3:])
                                          for e in rig["extr"]],
                            rig["camera_models"])
    fixed = ({n: {"int": cams[n].intrinsic,
                  "dst": np.ravel(cams[n].distortion_coefs)} for n in names}
             if fixed_lenses else None)
    handler = TemplateBundleHandler(
        cams, FreePointTarget(rig["template"].reshape(1, -1, 3)),
        detection_from_numpy(names, rig["dd"], n_ims), fixed_params=fixed,
        options={"outliers": "n", "verbosity": 0,
                 "camera_model": camera_model, **(options or {})})
    prim = handler.bundlePrimitive
    struct = handler.op_fun.param_struct(n_cams, n_ims, rig["n_keys"])
    start = rig
    if handler.is_het:      # the true cameras in the selector layout
        start = {**rig, "intr": np.stack([
            handler._intr_seed_row(c, cams[c]) for c in range(n_cams)])}
    handler.set_initial_params(
        perturbed_start(start, struct, het=handler.is_het)[
            prim.unfixed_full()])
    return handler, rig


def selfcal_stage_handler(solved, template_handler: TemplateBundleHandler,
                          options: dict | None = None) -> SelfBundleHandler:
    """The self-calibration stage after a template calibration, on the
    same rig: a ``SelfBundleHandler`` of the template stage's calibrated
    CameraSet ``solved``, its target and detection (the template
    handler's options, then ``options``; a per-camera ``camera_model`` map
    carries over), warm-started from ``solved``
    (``set_from_templated_camset``)."""
    handler = SelfBundleHandler(
        solved, template_handler.target, template_handler.detection,
        options={**template_handler.problem_opts, **(options or {})})
    handler.set_from_templated_camset(solved)
    return handler


def rs_handler(n_cams: int, n_ims: int, grid: int = 19):
    """A rolling-shutter capture of ``standard_problem``'s rig: its
    cameras (1600 x 1200, standard model) and its grid (20 mm pitch, 384
    keys on the grid at 19), each camera's readout drawn in
    ``RS_READOUT_RANGE`` (frame units, ``default_rng(303)``), the target
    moving within each frame (``utils.synthetic.rs_capture``: velocities
    ``RS_VEL_ROT`` / ``RS_VEL_TR``, the JAX package's test scale,
    ``RS_NOISE_PX`` px). The handler is an ``RSTemplateBundleHandler``
    (camera 0 the reference, its readout pinned at the truth:
    ``rolling_shutter`` = ``readouts[0]``) seeded through
    ``set_initial_params``: the true intrinsics, extrinsics and poses moved
    as ``perturbed_start`` moves the bench's start, every velocity zero and
    every readout at the reference's, as the handler's own seed leaves
    them. No PnP, no OpenCV.

    :return: (handler, truth): truth holds ``readouts`` (C,), ``poses``
        and ``vels`` (I, 6), ``dd`` and the rig's ``intr`` / ``extr``."""
    from pycamset_tpu_torch.optim.handlers import RSTemplateBundleHandler
    from pycamset_tpu_torch.utils.synthetic import rs_capture
    rig = make_synthetic_rig(n_cams=n_cams, n_ims=1, grid=grid,
                             visibility=0.85, noise_px=0.3, seed=0)
    cams, names = _rig_cams(rig["intr"], [make_4x4h_tform(e[:3], e[3:])
                                          for e in rig["extr"]])
    readouts = np.random.default_rng(303).uniform(*RS_READOUT_RANGE,
                                                  size=n_cams)
    dd, poses, vels = rs_capture(cams, rig["template"], n_ims, readouts,
                                 vel_rot=RS_VEL_ROT, vel_tr=RS_VEL_TR,
                                 noise=RS_NOISE_PX, seed=0)
    handler = RSTemplateBundleHandler(
        cams, FreePointTarget(rig["template"].reshape(1, -1, 3)),
        detection_from_numpy(names, dd, n_ims),
        options={"outliers": "n", "verbosity": 0,
                 "rolling_shutter": float(readouts[0])})
    prim = handler.bundlePrimitive
    start = perturbed_start(
        {**rig, "n_ims": n_ims, "poses": poses},
        OptimFunction([Projection(), Extrinsic3D(), TemplatePoints()]
                      ).param_struct(n_cams, n_ims, rig["n_keys"]))
    ie, ee = 9 * n_cams, 15 * n_cams
    prim.intr[:] = start[:ie].reshape(n_cams, 9)
    prim.extr[:] = start[ie:ee].reshape(n_cams, 6)
    prim.poses[:, :6] = start[ee:].reshape(n_ims, 6)
    handler.set_initial_params(prim.base_full()[prim.unfixed_full()])
    return handler, {"readouts": readouts, "poses": poses, "vels": vels,
                     "dd": dd, "intr": rig["intr"], "extr": rig["extr"]}


def skew_block(blocks=None, xp=torch):
    """A block of the caller's own for the structured backend's
    forward-mode route: a per-camera pixel skew u' = u + s v (one PER_CAM
    parameter). No camera model has a skew term, so s is identifiable
    beside the intrinsics, and no closed form serves a chain that holds it.

    :param blocks: the blocks module whose ``FunctionBlock`` it subclasses
        (default the port's ``optim.blocks``); with the JAX package's
        module and ``xp=jax.numpy`` it is that package's twin.
    :param xp: the array namespace ``compute`` runs in."""
    if blocks is None:
        from pycamset_tpu_torch.optim import blocks

    class Skew(blocks.FunctionBlock):
        num_inp = 2
        num_out = 2
        params = blocks.ParamSpec(blocks.key_type.PER_CAM, 1)

        def compute(self, params, inp):
            return xp.stack((inp[..., 0] + params[..., 0] * inp[..., 1],
                             inp[..., 1]), -1)

    return Skew()


class SkewPrimitive:
    """A template primitive with a leading per-camera skew group: the full
    vector [skew 1/cam | intr | extr | poses], every skew free."""

    def __init__(self, inner):
        self.inner = inner
        self.skew = np.zeros(inner.intr.shape[0])

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def base_full(self):
        return np.concatenate([self.skew, self.inner.base_full()])

    def unfixed_full(self):
        return np.concatenate([np.ones(self.skew.size, dtype=bool),
                               self.inner.unfixed_full()])

    def return_bundle_primitives(self, params):
        n = self.skew.size
        self.skew[:] = params[:n]
        return self.inner.return_bundle_primitives(params[n:])


def with_skew(handler, x0, blocks=None, xp=torch):
    """``handler`` (a template handler of either package, its start
    ``x0``) with ``skew_block(blocks, xp)`` in front of its chain and a
    ``SkewPrimitive``, every skew started at 0; returns it."""
    handler.bundlePrimitive = SkewPrimitive(handler.bundlePrimitive)
    handler.op_fun = type(handler.op_fun)([skew_block(blocks, xp),
                                           *handler.op_fun.blocks])
    handler.set_initial_params(np.concatenate(
        [np.zeros(handler.bundlePrimitive.skew.size), x0]))
    return handler


def skew_handler(n_cams: int, n_ims: int):
    """``template_handler(n_cams, n_ims)`` with the skew block in front
    (``with_skew``)."""
    h, _ = template_handler(n_cams, n_ims)
    return with_skew(h, h.get_initial_params())


def _tied_option(shared_intrinsics) -> dict:
    """The handler option of a tied rig (group ids as labels), or none."""
    if shared_intrinsics is None or shared_intrinsics is False:
        return {}
    return {"shared_intrinsics": (True if shared_intrinsics is True else
                                  [int(g) for g in shared_intrinsics])}


def freepoint_scene(n_cams: int, n_ims: int, grid: int = 19, seed: int = 0,
                    k_pad_multiple: int = 128,
                    camera_model: str = "standard") -> dict:
    """The free-point problem's data, host numpy (see the module docstring),
    on the rig ``make_synthetic_rig`` makes for ``camera_model``.

    :return: dict with intr (C, intr_w), extr_true / extr_start (C, 6) with
        camera 0 at zero, pts_true / pts_start (n_keys, 3) (an image's pad
        slots replicate its point 0), dd (N, 5) [cam, im, key, u, v] with
        key = im * stride + point, n_keys = n_ims * stride, seen (n_keys,)
        bool, pin (the flat index of the pinned coordinate), pts_unfixed
        (3 n_keys,) bool (the observed points' coordinates but the pinned
        one) and rig."""
    rig = make_synthetic_rig(n_cams=n_cams, n_ims=n_ims, grid=grid,
                             visibility=0.85, noise_px=0.3, seed=seed,
                             camera_model=camera_model)
    n_pts = rig["n_keys"]
    stride = -(-n_pts // k_pad_multiple) * k_pad_multiple
    n_keys = n_ims * stride
    # one rigid motion of the scene puts camera 0 at the origin: points
    # X -> E0 X, extrinsics E -> E E0^-1; every projection is unchanged
    e0 = make_4x4h_tform(rig["extr"][0, :3], rig["extr"][0, 3:])
    e0_inv = np.linalg.inv(e0)
    extr_true = np.zeros((n_cams, 6))
    for c in range(1, n_cams):
        ext = make_4x4h_tform(rig["extr"][c, :3], rig["extr"][c, 3:]) @ e0_inv
        extr_true[c] = np.concatenate(ext_4x4_to_rod(ext))
    pts = np.zeros((n_ims, stride, 3))
    for i in range(n_ims):
        pose = make_4x4h_tform(rig["poses"][i, :3], rig["poses"][i, 3:])
        world = (rig["template"] @ pose[:3, :3].T + pose[:3, 3]) @ \
            e0[:3, :3].T + e0[:3, 3]
        pts[i, :n_pts] = world
        pts[i, n_pts:] = world[0]
    pts_true = pts.reshape(n_keys, 3)
    dd = rig["dd"].copy()
    dd[:, 2] = dd[:, 1] * stride + dd[:, 2]
    rng = np.random.default_rng(seed + 1)
    extr_start = extr_true + rng.normal(size=extr_true.shape) * 1e-2
    extr_start[0] = 0.0
    pts_start = pts_true + rng.normal(size=pts_true.shape) * 1e-3
    seen = np.isin(np.arange(n_keys), dd[:, 2].astype(int))
    # the wand's seventh gauge coordinate: the largest coordinate of an
    # observed point's start
    pin = int(np.argmax(np.abs(pts_start) * seen[:, None]))
    pts_unfixed = np.repeat(seen, 3)
    pts_unfixed[pin] = False
    return dict(intr=rig["intr"], extr_true=extr_true, extr_start=extr_start,
                pts_true=pts_true, pts_start=pts_start, dd=dd,
                n_keys=n_keys, seen=seen, pin=pin, pts_unfixed=pts_unfixed,
                rig=rig)


def freepoint_handler(n_cams: int, n_ims: int, grid: int = 19,
                      seed: int = 0, options: dict | None = None,
                      k_pad_multiple: int = 128,
                      camera_model: str = "standard"):
    """``freepoint_scene`` as a user holds it: a CameraSet at the start
    (true lenses of ``camera_model``, moved extrinsics, camera 0 the
    identity), the start points as a ``FreePointTarget``, the
    TargetDetection of the table, and a ``FreePointBundleHandler``
    (options ``outliers: "n"``, ``verbosity: 0``, ``camera_model``, then
    ``options``) with the wand's gauge: every lens fixed at the truth through
    ``fixed_params``, camera 0's extrinsic fixed at the identity, the
    pinned coordinate and the never-observed keys frozen in
    ``feat_unfixed``. Its start is the CameraSet's and the target's: no
    PnP, no OpenCV. ``k_pad_multiple``: the key stride's multiple (build
    the handler's problem with the same one).

    :return: (handler, scene)."""
    sc = freepoint_scene(n_cams, n_ims, grid, seed, k_pad_multiple,
                         camera_model)
    exts = [make_4x4h_tform(e[:3], e[3:]) for e in sc["extr_start"]]
    exts[0] = np.eye(4)
    cams, names = _rig_cams(sc["intr"], exts, sc["rig"]["camera_models"])
    fixed = {name: {"int": cams[name].intrinsic,
                    "dst": np.ravel(cams[name].distortion_coefs)}
             for name in names}
    fixed[names[0]]["ext"] = np.eye(4)
    handler = FreePointBundleHandler(
        cams, FreePointTarget(sc["pts_start"].reshape(1, -1, 3)),
        detection_from_numpy(names, sc["dd"], n_ims), fixed_params=fixed,
        options={"outliers": "n", "verbosity": 0,
                 "camera_model": camera_model, **(options or {})})
    handler.feat_unfixed[~sc["pts_unfixed"]] = False
    handler.bundlePrimitive.calc_free_poses()
    return handler, sc


def freepoint_problem(n_cams: int, n_ims: int, device="cuda", dtype=None,
                      grid: int = 19, seed: int = 0,
                      k_pad_multiple: int = 128, loss: str = "linear",
                      f_scale: float = 1.0,
                      loss_semantics: str = "component",
                      camera_model: str = "standard") -> BAProblem:
    """The pose-free free-point problem (chain Projection + Extrinsic3D +
    FreePoint, b = 0) of ``freepoint_scene`` on ``device`` (dtype defaults
    to float64 on the CPU, float32 on CUDA): the problem
    ``build_structured_problem`` builds of ``freepoint_handler``'s handler,
    on an image grid of ``n_ims`` (``im_bucket: None``), at
    ``camera_model``."""
    handler, _ = freepoint_handler(
        n_cams, n_ims, grid, seed, k_pad_multiple=k_pad_multiple,
        options={"im_bucket": None, "loss": loss, "f_scale": f_scale,
                 "loss_semantics": loss_semantics},
        camera_model=camera_model)
    solve_fn, _, _ = build_structured_problem(handler, dtype, device,
                                              k_pad_multiple)
    return solve_fn.problem


def selfcal_colmask(n_cams, n_ims, n_keys, k_pad, widths, dtype=np.float64):
    """Unfixed masks (host numpy) of the bench self-cal problem at the
    camera width ``widths.a``: pad keys frozen, a 7-coordinate gauge
    (points 0 and 1, and z of the second-row point round(sqrt(n_keys)):
    points 0, 1, 2 are collinear, so a third pin on that row would leave a
    null mode), pose 0 fixed."""
    kmask = np.ones((k_pad, 3), dtype=dtype)
    kmask[n_keys:] = 0.0
    kmask[0] = 0.0
    kmask[1] = 0.0
    kmask[int(round(n_keys ** 0.5)), 2] = 0.0
    cm_im = np.ones((n_ims, widths.b), dtype=dtype)
    cm_im[0] = 0.0
    return np.ones((n_cams, widths.a), dtype=dtype), cm_im, kmask


def selfcal_problem(n_cams: int, n_ims: int, device="cuda",
                    dtype=None, grid: int = 19, seed: int = 0,
                    k_pad_multiple: int = 128, loss: str = "linear",
                    f_scale: float = 1.0,
                    loss_semantics: str = "component",
                    camera_model: str = "standard") -> BAProblem:
    """``bench.py::selfcal_problem(n_cams, n_ims, grid, seed)`` on
    ``device`` (dtype defaults to float64 on the CPU, float32 on CUDA); with
    ``camera_model`` the rig ``make_synthetic_rig`` makes for that model,
    started at its truth, through the model's projection block."""
    device = resolve_device(device)
    dtype = dtype or default_device_dtype(device)
    rig = make_synthetic_rig(n_cams=n_cams, n_ims=n_ims, grid=grid,
                             visibility=0.85, noise_px=0.3, seed=seed,
                             camera_model=camera_model)
    n_keys = rig["n_keys"]
    op_fun = OptimFunction([_projection_block(camera_model), Extrinsic3D(),
                            RigidTform3d(), FreePoint()])
    widths = chain_widths(op_fun)
    struct = op_fun.param_struct(n_cams, n_ims, n_keys)
    blocks = build_block_arrays(rig["dd"], n_cams, n_ims, n_keys,
                                k_pad_multiple=k_pad_multiple)
    k_pad = blocks.uv.shape[1]
    full = np.concatenate([rig["intr"].ravel(), rig["extr"].ravel(),
                           rig["poses"].ravel(), rig["template"].ravel()])
    p = split_full_params(torch.as_tensor(full), op_fun, struct, n_cams,
                          n_ims, n_keys, widths)
    key = np.tile(p.key[:1].numpy(), (k_pad, 1))
    key[:n_keys] = p.key.numpy()
    x0 = pieces_from_numpy(p.cam.numpy(), p.im.numpy(), key, device, dtype)
    uv, mask = blocks.as_device(device, dtype)
    colmask = pieces_from_numpy(*selfcal_colmask(n_cams, n_ims, n_keys,
                                                 k_pad, widths),
                                device, dtype)
    tpl = tensor_from_numpy(np.zeros((k_pad, 3)), device, dtype)
    return BAProblem(op_fun, widths, struct, blocks, x0, uv, mask, tpl,
                     colmask, loss, f_scale, loss_semantics)


def mixed_colmask_groups(n_cams, n_ims, n_keys, k_pad, intr_mask,
                         dtype=np.float64):
    """(colmask, group_of_key) of the bench mixed 2-target problem, host
    numpy: the cameras' free intrinsic columns ``intr_mask`` (C, w) and
    every extrinsic column, the grid halves as the two targets, group 0's
    relative pose fixed, pad keys frozen, the self-cal point gauge, pose 0
    fixed."""
    a = intr_mask.shape[1] + 6
    gok = np.zeros(k_pad, np.int64)
    gok[:n_keys] = np.arange(n_keys) >= n_keys // 2
    _, cm_im, kmask = selfcal_colmask(n_cams, n_ims, n_keys, k_pad,
                                      GroupWidths(a, 6, 3), dtype)
    cm_grp = np.ones((2, 6), dtype=dtype)
    cm_grp[0] = 0.0
    cam = np.concatenate([intr_mask, np.ones((n_cams, 6))], axis=1)
    return MixedPieces(cam.astype(dtype), cm_im, kmask, cm_grp), gok


def _rig_lenses(rig, n_cams: int, camera_model):
    """(projection block, packed intrinsic rows, (C, w) 0/1 free-column
    mask) of a synthetic rig's cameras: one model's block and rows, a
    Brown rig of several widths at the widest model with the extra
    columns pinned, or a heterogeneous rig's ``ProjectionHet`` with its
    selector rows [sel | fx px fy py | dist slots] (as the handlers pack
    them, ``handlers.parse_camera_models``)."""
    from pycamset_tpu_torch.optim.handlers import (ProjectionHet,
                                                   _brown_mix_colmask,
                                                   _het_intr_colmask,
                                                   _het_intr_row,
                                                   _het_intr_width,
                                                   parse_camera_models)
    models, het, base = parse_camera_models(camera_model, range(n_cams))
    intr = rig["intr"]
    if het:
        w = _het_intr_width(base)
        rows = np.stack([_het_intr_row(m, i[:4], i[4:4 + DIST_WIDTH[m]], w)
                         for m, i in zip(models, intr)])
        return (ProjectionHet(base), rows,
                _het_intr_colmask(models, w).astype(float))
    cm = (_brown_mix_colmask(models, intr.shape[1]) if base
          else np.ones(intr.shape, dtype=bool))
    return _projection_block(base or models[0]), intr, cm.astype(float)


def _multi_target_rig(n_cams, n_ims, grid, seed, k_pad_multiple,
                      camera_model="standard"):
    rig = make_synthetic_rig(n_cams=n_cams, n_ims=n_ims, grid=grid,
                             visibility=0.85, noise_px=0.3, seed=seed,
                             camera_model=camera_model)
    blocks = build_block_arrays(rig["dd"], n_cams, n_ims, rig["n_keys"],
                                k_pad_multiple=k_pad_multiple)
    proj, intr, intr_cm = _rig_lenses(rig, n_cams, camera_model)
    colmask, gok = mixed_colmask_groups(n_cams, n_ims, rig["n_keys"],
                                        blocks.uv.shape[1], intr_cm)
    return {**rig, "intr": intr}, proj, blocks, colmask, gok


def mixed_problem(n_cams: int, n_ims: int, device="cuda",
                  dtype=None, grid: int = 19, seed: int = 5,
                  k_pad_multiple: int = 128,
                  loss: str = "linear", f_scale: float = 1.0,
                  loss_semantics: str = "component",
                  camera_model="standard") -> MixedProblem:
    """``bench.py::mixed_problem(n_cams, n_ims, grid, seed)`` on ``device``
    (dtype defaults to float64 on the CPU, float32 on CUDA); with
    ``camera_model`` the rig ``make_synthetic_rig`` makes for that model,
    through the model's projection block, at the same start (the true
    intrinsics, group 1 at ``GROUP_START[1]``) and gauge. A list of one
    model a camera makes a mixed-model rig (``_rig_lenses``): fisheye
    beside Brown cameras runs ``ProjectionHet``, the forward-mode route
    (no kernel serves it)."""
    device = resolve_device(device)
    dtype = dtype or default_device_dtype(device)
    rig, proj, blocks, colmask, gok = _multi_target_rig(
        n_cams, n_ims, grid, seed, k_pad_multiple, camera_model)
    n_keys, k_pad = rig["n_keys"], blocks.uv.shape[1]
    op_fun = OptimFunction([proj, Extrinsic3D(), RigidTform3d(),
                            GroupRigidTform3d(), FreePoint()])
    key_pad = np.concatenate(
        [rig["template"], np.repeat(rig["template"][:1], k_pad - n_keys, 0)])
    x0 = mixed_pieces_from_numpy(
        np.concatenate([rig["intr"], rig["extr"]], 1), rig["poses"], key_pad,
        GROUP_START, device, dtype)
    uv, mask = blocks.as_device(device, dtype)
    return MixedProblem(
        op_fun, mixed_chain_widths(op_fun),
        op_fun.param_struct(n_cams, n_ims, n_keys, n_groups=2), blocks, x0,
        uv, mask, tensor_from_numpy(np.zeros((k_pad, 3)), device, dtype),
        mixed_pieces_from_numpy(*colmask, device, dtype), loss, f_scale,
        loss_semantics, group_of_key=gok, n_groups=2, max_nfev=60)


def grouped_problem(n_cams: int, n_ims: int, device="cuda",
                    dtype=None, grid: int = 19, seed: int = 5,
                    k_pad_multiple: int = 128,
                    loss: str = "linear", f_scale: float = 1.0,
                    loss_semantics: str = "component",
                    camera_model="standard") -> BAProblem:
    """The grouped multi-target template problem: ``mixed_problem``'s rig,
    start and gauge with the points taken from the template (chain
    Projection + Extrinsic3D + RigidTform3d + GroupTemplatePoints), at
    ``camera_model`` as ``mixed_problem`` takes it (a list: a mixed-model
    rig)."""
    device = resolve_device(device)
    dtype = dtype or default_device_dtype(device)
    rig, proj, blocks, colmask, gok = _multi_target_rig(
        n_cams, n_ims, grid, seed, k_pad_multiple, camera_model)
    n_keys, k_pad = rig["n_keys"], blocks.uv.shape[1]
    op_fun = OptimFunction([proj, Extrinsic3D(), RigidTform3d(),
                            GroupTemplatePoints()])
    x0 = pieces_from_numpy(np.concatenate([rig["intr"], rig["extr"]], 1),
                           rig["poses"], GROUP_START, device, dtype)
    uv, mask = blocks.as_device(device, dtype)
    tpl = pad_template_table(rig["template"], True, n_keys, k_pad)
    return BAProblem(
        op_fun, chain_widths(op_fun),
        op_fun.param_struct(n_cams, n_ims, n_keys, n_groups=2), blocks, x0,
        uv, mask, tensor_from_numpy(tpl, device, dtype),
        pieces_from_numpy(colmask.cam, colmask.im, colmask.grp, device,
                          dtype), loss, f_scale, loss_semantics,
        group_of_key=gok, n_groups=2, max_nfev=60)


def _two_targets(rig, names, n_ims):
    """The rig's board as two targets, its halves (keys below and from
    n_keys // 2, as ``mixed_colmask_groups`` splits it), and each half's
    detections (the second half's keys from 0)."""
    half = rig["n_keys"] // 2
    dd = rig["dd"]
    second = dd[:, 2] >= half
    dd1 = dd[second].copy()
    dd1[:, 2] -= half
    return ((FreePointTarget(rig["template"][:half].reshape(1, -1, 3)),
             FreePointTarget(rig["template"][half:].reshape(1, -1, 3))),
            (detection_from_numpy(names, dd[~second], n_ims),
             detection_from_numpy(names, dd1, n_ims)))


def target_gauge(pts3: np.ndarray, similarity: bool) -> list[int]:
    """The flat coordinates that fix a target's gauge, of three
    non-colinear points p0, p1, p2 (``handlers.find_not_colinear_pts``):
    p0's three; p1's three (``similarity``: the scale too) or the two
    across the axis a = p1 - p0 (its largest component left free); and
    p2's coordinate along a x (p2 - p0), the direction in which p2 moves
    under a rotation about a (``SelfBundleHandler``'s rule: for a planar
    z = 0 target, its z)."""
    from pycamset_tpu_torch.optim.handlers import find_not_colinear_pts
    i0, i1, i2 = find_not_colinear_pts(pts3)
    axis = pts3[i1] - pts3[i0]
    v = np.cross(axis / np.linalg.norm(axis), pts3[i2] - pts3[i0])
    across = [j for j in range(3) if j != int(np.argmax(np.abs(axis)))]
    return ([3 * i0 + j for j in range(3)]
            + [3 * i1 + j for j in (range(3) if similarity else across)]
            + [3 * i2 + int(np.argmax(np.abs(v)))])


def multi_target_handler(n_cams: int, n_ims: int, mixed: bool = True,
                         grid: int = 19, seed: int = 5,
                         options: dict | None = None, start=None,
                         camera_model: str = "standard"):
    """``mixed_problem``'s (``mixed``) or ``grouped_problem``'s rig as a
    user holds it: a CameraSet of the rig's cameras, the board's two halves
    as two targets with their detections, and the port's copy of the JAX
    package's ``TwoTargetSelfCalibrator`` (``mixed``: free points, the
    handler's own gauge, 7 coordinates on target 0 and 6 on target 1) or
    ``TwoTargetCalibrator`` (options ``outliers: "n"``, ``verbosity: 0``,
    then ``options``), seeded through ``set_initial_params`` (no PnP, no
    OpenCV) at the problems' start: the true parameters, group 1's
    relative pose at ``GROUP_START[1]``, pose 0 the gauge.

    The mixed handler's point gauge is set to ``target_gauge``'s (target 0
    a similarity, 7 coordinates, ``mixed_problem``'s own; target 1 rigid,
    6), in place of the example's: that pins p1's x and y and p2's x on
    each target, which on the planar board leaves the rotations about the
    board's x axis (both targets) and y axis (target 1) free, and the LM
    crawls along them (4 rigs x 4 x 16 at grid 10 on the CPU: 24-99
    iterations, one rig at the 100-evaluation budget).

    :param start: a ``np.random.Generator``: the cameras and poses
        perturbed from it as the bench's template start is
        (``perturbed_start``), the others as above.
    :param camera_model: the rig's lens model (``make_synthetic_rig``'s),
        which the handler solves.
    :return: (handler, rig)."""
    from pycamset_tpu_torch.examples.extend_param_handler import (
        TwoTargetCalibrator, TwoTargetSelfCalibrator)
    rig = make_synthetic_rig(n_cams=n_cams, n_ims=n_ims, grid=grid,
                             visibility=0.85, noise_px=0.3, seed=seed,
                             camera_model=camera_model)
    cams, names = _rig_cams(rig["intr"], [make_4x4h_tform(e[:3], e[3:])
                                          for e in rig["extr"]])
    targets, dets = _two_targets(rig, names, n_ims)
    cls = TwoTargetSelfCalibrator if mixed else TwoTargetCalibrator
    handler = cls(cams, *targets, *dets,
                  options={"outliers": "n", "verbosity": 0,
                           "camera_model": camera_model, **(options or {})})
    prim = handler.bundlePrimitive
    if mixed:
        pts3 = rig["template"]
        half = rig["n_keys"] // 2
        # never-observed points stay frozen, as the example freezes them
        unfixed = np.repeat(np.isin(np.arange(rig["n_keys"]),
                                    rig["dd"][:, 2].astype(int)), 3)
        unfixed[target_gauge(pts3[:half], True)] = False
        unfixed[[half * 3 + j for j in target_gauge(pts3[half:],
                                                    False)]] = False
        prim.bdpt_unfixed = unfixed
    if start is None:
        full = np.concatenate([rig["intr"].ravel(), rig["extr"].ravel(),
                               rig["poses"].ravel()])
    else:
        struct = OptimFunction([_projection_block(camera_model),
                                Extrinsic3D(), TemplatePoints()]
                               ).param_struct(n_cams, n_ims, rig["n_keys"])
        full = perturbed_start(rig, struct, start)
    full = np.concatenate([full, GROUP_START.ravel()]
                          + ([rig["template"].ravel()] if mixed else []))
    handler.set_initial_params(full[prim.unfixed_full()])
    return handler, rig


def fleet_handlers(chain: str, n_rigs: int, n_cams: int, n_ims: int,
                   grid: int = 10, options: dict | None = None,
                   camera_model: str = "standard",
                   shared_intrinsics=None) -> list:
    """R handlers of one structure for ``optim.fleet.
    run_fleet_bundle_adjustment``, as ``fleet_problem`` makes its rigs:
    rig r from ``make_synthetic_rig(seed=100 + r)`` (visibility 0.85,
    0.3 px noise; one target for every rig), its cameras and poses
    perturbed by one ``default_rng(7)`` in rig order with the bench's
    scales, pose 0 the gauge, each seeded through ``set_initial_params``
    (the card's machine has no OpenCV).

    :param chain: "template" (``TemplateBundleHandler``: the rigs of
        ``fleet_problem``), "selfcal" (``SelfBundleHandler``: the board's
        points free from the nominal board, its 7-coordinate gauge),
        "grouped" or "mixed" (``multi_target_handler``: the board's two
        halves as two targets, group 1's relative pose from
        ``GROUP_START[1]``; mixed: the points free too), or "freepoint"
        (``freepoint_handler``'s wand rigs, seed 100 + r: the pose-free
        chain, each image's points free, the wand's gauge).
    :param options: the handlers' options (after ``outliers: "n"``,
        ``verbosity: 0``), e.g. ``{"im_bucket": None}``.
    :param camera_model: the rigs' lens model (``make_synthetic_rig``'s),
        which the handlers solve.
    :param shared_intrinsics: the template chain's tied lenses, as
        ``template_handler``'s (the tied fleet)."""
    from pycamset_tpu_torch.optim.handlers import SelfBundleHandler
    if shared_intrinsics is not None and chain != "template":
        raise ValueError("shared_intrinsics ties the template chain only")
    options = {**_tied_option(shared_intrinsics), **(options or {})}
    if chain == "freepoint":
        return [freepoint_handler(n_cams, n_ims, grid, 100 + r, options,
                                  camera_model=camera_model)[0]
                for r in range(n_rigs)]
    rng = np.random.default_rng(7)
    out = []
    for r in range(n_rigs):
        if chain in ("grouped", "mixed"):
            out.append(multi_target_handler(
                n_cams, n_ims, chain == "mixed", grid, 100 + r, options,
                start=rng, camera_model=camera_model)[0])
            continue
        rig = make_synthetic_rig(n_cams=n_cams, n_ims=n_ims, grid=grid,
                                 visibility=0.85, noise_px=0.3, seed=100 + r,
                                 camera_model=camera_model,
                                 shared_intrinsics=shared_intrinsics)
        cams, names = _rig_cams(rig["intr"], [make_4x4h_tform(e[:3], e[3:])
                                              for e in rig["extr"]])
        cls = {"template": TemplateBundleHandler,
               "selfcal": SelfBundleHandler}[chain]
        handler = cls(cams, FreePointTarget(rig["template"].reshape(1, -1,
                                                                    3)),
                      detection_from_numpy(names, rig["dd"], n_ims),
                      options={"outliers": "n", "verbosity": 0,
                               "camera_model": camera_model,
                               **(options or {})})
        struct = OptimFunction([_projection_block(camera_model),
                                Extrinsic3D(), TemplatePoints()]
                               ).param_struct(n_cams, n_ims, rig["n_keys"])
        full = perturbed_start(rig, struct, rng)
        prim = handler.bundlePrimitive
        if chain == "selfcal":
            full = np.concatenate([full, rig["template"].ravel()])
        handler.set_initial_params(full[prim.unfixed_full()])
        out.append(handler)
    return out


@dataclass
class FleetProblem:
    """R template rigs of one structure and one target on one device,
    solved as one batch (``optim/fleet.py::fleet_solve``). The per-rig
    tensors carry a leading rig axis; the point table and the column
    masks are shared by every rig."""
    op_fun: OptimFunction
    widths: GroupWidths
    struct: ParamStruct        # one rig's
    blocks: list               # BlockArrays per rig
    x0: ParamPieces            # starts: (R, C, a), (R, I, b), (R, K, 0)
    uv: torch.Tensor           # (R, B, K, 2)
    mask: torch.Tensor         # (R, B, K)
    tpl: torch.Tensor          # (K, 3), shared
    colmask: ParamPieces       # shared 0/1 unfixed masks
    loss: str
    f_scale: float
    loss_semantics: str
    max_nfev: int = 100
    graphs: dict = field(default_factory=dict, repr=False, compare=False)
    solos: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def n_rigs(self) -> int:
        return self.uv.shape[0]

    @property
    def n_real(self) -> np.ndarray:
        """(R,) real detections per rig."""
        return np.array([b.n_real for b in self.blocks])

    def neq_fn(self):
        """neq(pieces, uv, mask) -> NormalEq of ONE rig, on its data."""
        b0 = self.blocks[0]
        neq = make_structured_neq(self.op_fun, self.widths, b0.n_cams,
                                  b0.n_ims, loss=self.loss,
                                  f_scale=self.f_scale,
                                  loss_semantics=self.loss_semantics)
        return lambda p, uv, mask: neq(p, uv, mask, self.tpl, self.colmask)

    def graph(self, max_nfev: int | None = None) -> dict:
        """This fleet's step runners ({cohort size: FleetGraph}) for the
        dense-solve route in force, its dtype and ``max_nfev``: captured by
        the first solve, replayed by the later ones."""
        key = (psd_opted_in(), self.x0.cam.dtype, max_nfev or self.max_nfev)
        return self.graphs.setdefault(key, {})

    def solve(self, max_nfev: int | None = None,
              graph: bool = True) -> SLMResult:
        """The cascade solve of every rig from x0: the batched SLMResult
        (nfev and nit per rig, lists of ints). On a card each step of a
        cohort is one replay of this fleet's graph for that cohort size;
        ``graph=False`` runs the uncaptured batched step, the reference.
        On the CPU, the host loop."""
        graph = (self.graph(max_nfev)
                 if graph and self.x0.cam.device.type == "cuda" else False)
        return fleet_solve(self.neq_fn(), self.x0, (self.uv, self.mask),
                           max_nfev=max_nfev or self.max_nfev, graph=graph)

    def solo(self, r: int) -> BAProblem:
        """Rig r as a problem of its own (kept, with its graphs), to solve
        it alone for comparison."""
        if r not in self.solos:
            self.solos[r] = BAProblem(
                self.op_fun, self.widths, self.struct, self.blocks[r],
                ParamPieces(*(p[r] for p in self.x0)), self.uv[r],
                self.mask[r], self.tpl, self.colmask, self.loss,
                self.f_scale, self.loss_semantics, max_nfev=self.max_nfev)
        return self.solos[r]

    def rms_px(self, cost) -> np.ndarray:
        """(R,) sqrt(cost / (2 n_real)) per rig, as bench.py reports it."""
        cost = torch.as_tensor(cost).double().cpu().numpy()
        return np.sqrt(cost / (2 * self.n_real))


def fleet_problem(n_rigs: int, n_cams: int, n_ims: int, device="cuda",
                  dtype=None, grid: int = 10, k_pad_multiple: int = 128,
                  loss: str = "linear", f_scale: float = 1.0,
                  loss_semantics: str = "component") -> FleetProblem:
    """``bench.py::fleet_problem(n_rigs, n_cams, n_ims, grid)`` on
    ``device`` (dtype defaults to float64 on the CPU, float32 on CUDA):
    rig r from seed 100 + r, each start perturbed by one
    ``default_rng(7)`` in rig order with the bench's scales, pose 0
    zeroed and fixed as the gauge. The rigs must share one target
    (``fleet.shared_template`` checks, on the host; the synthetic target
    does not depend on the seed)."""
    device = resolve_device(device)
    dtype = dtype or default_device_dtype(device)
    op_fun = OptimFunction([Projection(), Extrinsic3D(), TemplatePoints()])
    widths = chain_widths(op_fun)
    rng = np.random.default_rng(7)
    blocks, tpls, cams, ims = [], [], [], []
    for r in range(n_rigs):
        rig = make_synthetic_rig(n_cams=n_cams, n_ims=n_ims, grid=grid,
                                 visibility=0.85, noise_px=0.3, seed=100 + r)
        n_keys = rig["n_keys"]
        struct = op_fun.param_struct(n_cams, n_ims, n_keys)
        blocks.append(build_block_arrays(rig["dd"], n_cams, n_ims, n_keys,
                                         k_pad_multiple=k_pad_multiple))
        k_pad = blocks[-1].uv.shape[1]
        tpls.append(pad_template_table(rig["template"], True, n_keys, k_pad))
        p = split_full_params(torch.as_tensor(perturbed_start(rig, struct,
                                                              rng)),
                              op_fun, struct, n_cams, n_ims, n_keys, widths)
        cams.append(p.cam.numpy())
        ims.append(p.im.numpy())
    tpl = shared_template(tpls)
    k_pad = tpl.shape[0]
    return FleetProblem(
        op_fun, widths, struct, blocks,
        pieces_from_numpy(np.stack(cams), np.stack(ims),
                          np.zeros((n_rigs, k_pad, 0)), device, dtype),
        tensor_from_numpy(np.stack([b.uv for b in blocks]), device, dtype),
        tensor_from_numpy(np.stack([b.mask for b in blocks]), device, dtype),
        tensor_from_numpy(tpl, device, dtype),
        pieces_from_numpy(*template_colmask(n_cams, n_ims, widths, k_pad),
                          device, dtype), loss, f_scale, loss_semantics)
