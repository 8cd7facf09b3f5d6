"""The bench's bundle-adjustment problems, built with the port.

Counterparts of ``bench.py::standard_problem`` / ``template_colmask`` and
``bench.py::selfcal_problem`` / ``selfcal_colmask``. Both build a synthetic
rig (seed 0, visibility 0.85, 0.3 px noise) and the (B, K) block grid,
standard camera model.

- Template: the chain Projection + Extrinsic3D + TemplatePoints, the true
  parameters perturbed by ``rng(1)`` with the bench's scale vector, and
  pose 0 zeroed and fixed as the gauge. The one difference: template pad
  rows replicate key 0 (``pad_template_table``) where the bench pads with
  zeros; pad slots are masked, so both give the same normal equations.
- Self-calibration: the chain Projection + Extrinsic3D + RigidTform3d +
  FreePoint, the target points free, started at the true parameters (pad
  key rows replicate key 0), pad keys frozen, a 7-coordinate gauge on the
  points and pose 0 fixed; the template table is zeros.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pycamset_tpu_torch.config import default_device_dtype, resolve_device
from pycamset_tpu_torch.from_jax import pieces_from_numpy, tensor_from_numpy
from pycamset_tpu_torch.optim.blocks import (Extrinsic3D, FreePoint,
                                             Projection, RigidTform3d,
                                             TemplatePoints)
from pycamset_tpu_torch.optim.chain import OptimFunction, ParamStruct
from pycamset_tpu_torch.optim.structured import (
    BlockArrays, GroupWidths, ParamPieces, build_block_arrays, chain_widths,
    make_structured_neq, pad_template_table, split_full_params)
from pycamset_tpu_torch.optim.structured_lm import structured_lm_solve
from pycamset_tpu_torch.utils.synthetic import make_synthetic_rig


@dataclass
class BAProblem:
    """A structured BA problem (template or self-cal chain) on one
    device."""
    op_fun: OptimFunction
    widths: GroupWidths
    struct: ParamStruct
    blocks: BlockArrays
    x0: ParamPieces        # start
    uv: torch.Tensor       # (B, K, 2)
    mask: torch.Tensor     # (B, K)
    tpl: torch.Tensor      # (K, 3) template table; zeros for self-cal
    colmask: ParamPieces   # 0/1 unfixed masks
    loss: str
    f_scale: float
    loss_semantics: str

    def neq_fn(self):
        """neq(pieces) -> NormalEq on this problem's data."""
        neq = make_structured_neq(
            self.op_fun, self.widths, self.blocks.n_cams, self.blocks.n_ims,
            loss=self.loss, f_scale=self.f_scale,
            loss_semantics=self.loss_semantics)
        return lambda p: neq(p, self.uv, self.mask, self.tpl, self.colmask)

    def solve(self, max_nfev: int = 100):
        return structured_lm_solve(self.neq_fn(), self.x0, max_nfev=max_nfev)

    def rms_px(self, cost) -> float:
        """sqrt(cost / (2 n_real)), as bench.py reports it."""
        return float(np.sqrt(float(cost) / (2 * self.blocks.n_real)))


def template_colmask(n_cams, n_ims, widths, k_pad, dtype=np.float64):
    """Unfixed masks (host numpy) of the bench template problem: pose 0 is
    the gauge."""
    cm_im = np.ones((n_ims, widths.b), dtype=dtype)
    cm_im[0] = 0.0
    return (np.ones((n_cams, widths.a), dtype=dtype), cm_im,
            np.ones((k_pad, 0), dtype=dtype))


def perturbed_start(rig, struct, seed: int = 1) -> np.ndarray:
    """The bench's perturbed full parameter vector (pose 0 zeroed)."""
    n_cams, n_ims = rig["n_cams"], rig["n_ims"]
    x_full = np.concatenate([rig["intr"].ravel(), rig["extr"].ravel(),
                             rig["poses"].ravel()])
    rng = np.random.default_rng(seed)
    scale = np.concatenate([
        np.tile([10.0, 5, 10, 5, 1e-2, 1e-3, 1e-4, 1e-4, 1e-4], n_cams),
        np.tile([1e-2] * 6, n_cams),
        np.tile([1e-2] * 6, n_ims),
    ])
    x_full = x_full + rng.normal(size=struct.total) * scale
    pose_sl = struct.group_slice(2)
    x_full[pose_sl.start:pose_sl.start + 6] = 0.0  # gauge: pose 0 fixed
    return x_full


def standard_problem(n_cams: int, n_ims: int, device, dtype=None,
                     grid: int = 19, seed: int = 0,
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


def selfcal_colmask(n_cams, n_ims, n_keys, k_pad, widths, dtype=np.float64):
    """Unfixed masks (host numpy) of the bench self-cal problem: pad keys
    frozen, a 7-coordinate gauge (points 0 and 1, and z of the second-row
    point round(sqrt(n_keys)): points 0, 1, 2 are collinear, so a third pin
    on that row would leave a null mode), pose 0 fixed."""
    kmask = np.ones((k_pad, 3), dtype=dtype)
    kmask[n_keys:] = 0.0
    kmask[0] = 0.0
    kmask[1] = 0.0
    kmask[int(round(n_keys ** 0.5)), 2] = 0.0
    cm_im = np.ones((n_ims, widths.b), dtype=dtype)
    cm_im[0] = 0.0
    return np.ones((n_cams, widths.a), dtype=dtype), cm_im, kmask


def selfcal_problem(n_cams: int, n_ims: int, device, dtype=None,
                    grid: int = 19, seed: int = 0,
                    k_pad_multiple: int = 128, loss: str = "linear",
                    f_scale: float = 1.0,
                    loss_semantics: str = "component") -> BAProblem:
    """``bench.py::selfcal_problem(n_cams, n_ims, grid, seed)`` on
    ``device`` (dtype defaults to float64 on the CPU, float32 on CUDA)."""
    device = resolve_device(device)
    dtype = dtype or default_device_dtype(device)
    rig = make_synthetic_rig(n_cams=n_cams, n_ims=n_ims, grid=grid,
                             visibility=0.85, noise_px=0.3, seed=seed)
    n_keys = rig["n_keys"]
    op_fun = OptimFunction([Projection(), Extrinsic3D(), RigidTform3d(),
                            FreePoint()])
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
