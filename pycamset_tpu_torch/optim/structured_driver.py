"""Builder gluing a handler to the structured Schur LM backend.

Counterpart of ``build_colmask_pieces`` and ``build_structured_problem`` in
``pycamset_tpu/optim/structured_driver.py`` for the template, self-
calibration and pose-free free-point chains: the handler's detection table
on the (camera x image bucket, key) block grid, its start and
fixed-parameter column masks as pieces (a keyed chain's pad key slots never
free, a pose-free chain's image piece zero-width), the device problem an
``optim.problem.BAProblem`` (so the handler's problem owns its CUDA graphs
as the bench problems do: the first solve captures the LM step, later solves
of the same problem replay it), and the same contract
``(solve_fn, residual_fn, x0_free)``.

The image axis pads to a multiple of ``problem_opts['im_bucket']`` (default
8; None disables), as in the JAX package: pad images carry image 0's pose,
zero masks and zero column masks, so they add nothing, and the gram kernel
family follows the padded count (100 images -> 104: Kernel A, the
per-block gram; 400 -> 400: Kernel B, the fused one). The JAX package
buckets so that rigs of similar size share compiled executables; the port
compiles nothing per shape, and keeps the bucket because the fused
kernel's padding rule (``fused_tile_pad_ok``) sees the bucketed count: with
it, a handler takes the JAX package's gram family for the same option. Of
the image counts 1-400, 70 would take the other family without it (90
images: the bucket gives 96 and Kernel B, no bucket Kernel A).

For the self-calibration and free-point handlers the bucket decides alone:
their family takes tile 8 or 16 (whichever pads less) up to 25% padding,
and tile 8 never pads a multiple of 8, so with the default bucket they
always take the fused family (Kernel C, or the free-point wrapper over
it); only ``im_bucket: None`` on an image count that both tiles pad past
25% (12 -> 16) reaches the per-block one (Kernel D). Both packages choose
the same way. A pose-free chain has no image parameters, but every
(camera, image) pair of its table still indexes a block: its grid counts
``detection.max_ims`` images.

Not in this slice, each raising ``NotImplementedError`` with its ROADMAP
Queue A item: the grouped and mixed multi-target chains (their handler
backend is the next slice of item 3), ``reduced_solver="cg"`` (item 6) and
a mesh (item 11).
"""
from __future__ import annotations

import numpy as np
import torch

from pycamset_tpu_torch.config import default_device_dtype, resolve_device
from pycamset_tpu_torch.optim.structured import (
    ParamPieces, auto_reduced_solver, build_block_arrays, chain_family,
    chain_widths, merge_pieces_to_full, pad_pieces_to_grid,
    pad_template_table, split_full_params)
from pycamset_tpu_torch.optim.problem import BAProblem


def build_colmask_pieces(base_full, unfixed, op_fun, struct, widths,
                         n_cams: int, n_ims: int, n_keys: int, k_pad: int,
                         n_ims_grid: int) -> ParamPieces:
    """0/1 unfixed column masks (CPU float64 pieces) on the padded grid;
    padded key and image slots are never free."""
    colmask = np.zeros_like(base_full)
    colmask[unfixed] = 1.0
    p = split_full_params(torch.as_tensor(colmask), op_fun, struct, n_cams,
                          n_ims, n_keys, widths)
    cm = pad_pieces_to_grid(p, widths, False, n_keys, k_pad, n_ims,
                            n_ims_grid)
    im, key = cm.im.clone(), cm.key.clone()
    im[n_ims:] = 0.0
    key[n_keys:] = 0.0
    return ParamPieces(cm.cam, im, key)


class StructuredSolve:
    """``solve_fn`` of ``build_structured_problem``: a free parameter
    vector -> (the solved free vector, float64 numpy; the SLMResult), an LM
    solve of ``problem`` from it. ``graph=False`` runs the uncaptured step,
    the reference the captured one is held to."""

    def __init__(self, problem: BAProblem, to_pieces, base_full, free_idx,
                 n_ims: int):
        self.problem = problem
        self._to_pieces = to_pieces
        self._base_full = base_full
        self._free_idx = free_idx
        self._n_ims = n_ims

    def pieces(self, x_free: np.ndarray) -> ParamPieces:
        """x_free on the problem's grid, device and dtype."""
        full = self._base_full.copy()
        full[self._free_idx] = np.asarray(x_free, dtype=np.float64)
        return self._to_pieces(full)

    def __call__(self, x_free: np.ndarray, graph: bool = True):
        prob = self.problem
        res = prob.solve(graph=graph, x0=self.pieces(x_free))
        # the device pieces merge to the full vector in float64 on the host
        # (one rounding of float32 pieces: the widening, which is exact)
        host = ParamPieces(res.x.cam.double().cpu(),
                           res.x.im[:self._n_ims].double().cpu(),
                           res.x.key[:prob.blocks.n_keys].double().cpu())
        full = merge_pieces_to_full(host, prob.op_fun, prob.struct,
                                    prob.blocks.n_cams, self._n_ims,
                                    prob.blocks.n_keys).numpy()
        return full[self._free_idx], res


def build_structured_problem(param_handler, dtype=None, device="cuda",
                             k_pad_multiple: int = 128, mesh=None):
    """A handler's problem on the structured backend, on ``device`` (the
    card unless the caller names another; dtype as
    ``config.default_device_dtype``).

    :return: (solve_fn(x0_free) -> (x_free, SLMResult),
              residual_fn(x_free) -> (n_real, 2) residuals in detection
              table row order, float64 numpy, computed on the device,
              x0_free) — the JAX package's contract; ``solve_fn`` is a
              ``StructuredSolve`` (its ``problem`` the BAProblem).
    Raises UnsupportedChain when the chain does not fit the structured
    layout.
    """
    if mesh is not None:
        raise NotImplementedError(
            "a sharded solve (mesh=) is not ported yet (ROADMAP Queue A "
            "item 11)")
    device = resolve_device(device)
    dtype = dtype or default_device_dtype(device)
    op_fun = param_handler.op_fun
    widths = chain_widths(op_fun)
    family = chain_family(op_fun, widths)
    if family == "grouped":
        raise NotImplementedError(
            "the grouped multi-target chain's handler path is not ported "
            "yet (the handler-level mixed and grouped backend is the next "
            "slice of ROADMAP Queue A item 3)")
    opts = param_handler.problem_opts
    reduced_solver = opts.get("reduced_solver", "auto")

    x0 = np.asarray(param_handler.get_initial_params(), dtype=np.float64)
    n_cams = len(param_handler.cam_names)
    n_ims = int(param_handler.bundlePrimitive.poses.shape[0])
    n_keys = param_handler.n_keys()
    # the pose-free chain has no image parameters, but every (cam, im) pair
    # of the table still indexes a block on the grid
    n_ims_true = n_ims if widths.b else int(param_handler.detection.max_ims)
    im_bucket = opts.get("im_bucket", 8)
    n_ims_grid = (-(-n_ims_true // im_bucket) * im_bucket if im_bucket
                  else n_ims_true)
    if reduced_solver == "auto":
        reduced_solver = auto_reduced_solver(widths, n_cams, n_ims_grid)
    if reduced_solver != "dense":
        raise NotImplementedError(
            f"reduced_solver={reduced_solver!r} is not ported yet (the "
            f"matrix-free CG solver is ROADMAP Queue A item 6)")

    dd = param_handler.get_detection_data(flatten=True)
    blocks = build_block_arrays(dd, n_cams, n_ims_grid, n_keys,
                                k_pad_multiple=k_pad_multiple)
    k_pad = blocks.uv.shape[1]
    struct = op_fun.param_struct(n_cams, n_ims, n_keys)
    base_full = param_handler.bundlePrimitive.base_full()
    unfixed = param_handler.bundlePrimitive.unfixed_full()
    base_full[unfixed] = x0
    free_idx = np.where(unfixed)[0]

    def to_pieces(full: np.ndarray) -> ParamPieces:
        p = split_full_params(torch.as_tensor(full), op_fun, struct, n_cams,
                              n_ims, n_keys, widths)
        p = pad_pieces_to_grid(p, widths, False, n_keys, k_pad, n_ims,
                               n_ims_grid)
        return ParamPieces(*(t.to(device=device, dtype=dtype) for t in p))

    colmask = build_colmask_pieces(base_full, unfixed, op_fun, struct,
                                   widths, n_cams, n_ims, n_keys, k_pad,
                                   n_ims_grid)
    uv, mask = blocks.as_device(device, dtype)
    tpl = torch.as_tensor(
        pad_template_table(param_handler.template_table(), op_fun.templated,
                           n_keys, k_pad), dtype=dtype, device=device)
    problem = BAProblem(
        op_fun, widths, struct, blocks, to_pieces(base_full), uv, mask, tpl,
        ParamPieces(*(t.to(device=device, dtype=dtype) for t in colmask)),
        opts.get("loss", "linear"), float(opts.get("f_scale", 1.0)),
        opts.get("loss_semantics", "component"),
        max_nfev=int(opts.get("max_nfev", 100)))
    solve_fn = StructuredSolve(problem, to_pieces, base_full, free_idx, n_ims)

    # the residual of each real detection, in table row order
    point_fn = op_fun.make_point_fn()
    assemble = op_fun.make_local_assembler()
    cols = torch.as_tensor(dd[:, :3].astype(np.int64), device=device)
    uv_rows = torch.as_tensor(dd[:, 3:5], dtype=dtype, device=device)

    def residual_fn(x_free: np.ndarray) -> np.ndarray:
        p = solve_fn.pieces(x_free)
        cam, im, key = cols.unbind(1)
        local = assemble(p.cam[cam], p.im[im], p.key[key])
        r = point_fn(local, tpl[key]) - uv_rows
        return r.double().cpu().numpy()

    return solve_fn, residual_fn, x0
