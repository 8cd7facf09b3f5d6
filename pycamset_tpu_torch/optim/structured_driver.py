"""Builder gluing a handler to the structured Schur LM backend.

Counterpart of ``build_colmask_pieces``, ``build_structured_problem`` and
``build_mixed_structured_problem`` in
``pycamset_tpu/optim/structured_driver.py`` for the template, self-
calibration, pose-free free-point, grouped and mixed multi-target chains
(with a rig's per-camera camera models: the column masks carry the
handler's ``intr_colmask``): the handler's detection table
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

The grouped multi-target chain (a PER_GROUP c-axis: one SE(3) per rigid
target, the points from the targets) takes the same function: the
handler's ``group_of_key`` padded to the key grid (pad keys take key 0's
group; their masks are zero), the key piece one row per group. The mixed
chain (PER_KEY free points AND PER_GROUP relative poses) has its own,
``build_mixed_structured_problem``, on ``optim/structured_mixed.py``: a
``problem.MixedProblem`` with the same contract. Both check the handler's
``group_of_key`` as the JAX package does: ``UnsupportedChain`` where the
handler has no groups, ``ValueError`` for an index out of range.

The reduced solver follows ``problem_opts["reduced_solver"]``: "auto" (the
default) takes the JAX package's rule (``structured.auto_reduced_solver``:
dense up to 4096 reduced dimensions, CG above: a dome of 274 or more Brown
cameras, a self-calibration of more than about 660 views at 16 cameras),
"dense" or "cg" as named. The mixed chain solves dense, as in the JAX
package.

Not ported yet: a mesh (``mesh=``), raising ``NotImplementedError`` with
its ROADMAP Queue A item (11).
"""
from __future__ import annotations

import numpy as np
import torch

from pycamset_tpu_torch.config import default_device_dtype, resolve_device
from pycamset_tpu_torch.optim.blocks import key_type
from pycamset_tpu_torch.optim.problem import BAProblem, MixedProblem
from pycamset_tpu_torch.optim.structured import (
    ParamPieces, UnsupportedChain, auto_reduced_solver, build_block_arrays,
    chain_family, chain_widths, merge_pieces_to_full, pad_pieces_to_grid,
    pad_template_table, split_full_params)
from pycamset_tpu_torch.optim.structured_mixed import (
    MixedPieces, merge_mixed_to_full, mixed_chain_widths, pad_mixed_pieces,
    split_full_mixed)


def build_colmask_pieces(base_full, unfixed, op_fun, struct, widths,
                         n_cams: int, n_ims: int, n_keys: int, k_pad: int,
                         n_ims_grid: int, grouped: bool = False
                         ) -> ParamPieces:
    """0/1 unfixed column masks (CPU float64 pieces) on the padded grid;
    padded key and image slots are never free (a grouped chain's key piece
    is one row per group: no pad rows)."""
    colmask = np.zeros_like(base_full)
    colmask[unfixed] = 1.0
    p = split_full_params(torch.as_tensor(colmask), op_fun, struct, n_cams,
                          n_ims, n_keys, widths)
    cm = pad_pieces_to_grid(p, widths, grouped, n_keys, k_pad, n_ims,
                            n_ims_grid)
    im, key = cm.im.clone(), cm.key.clone()
    im[n_ims:] = 0.0
    if not grouped:
        key[n_keys:] = 0.0
    return ParamPieces(cm.cam, im, key)


def image_grid(n_ims: int, im_bucket) -> int:
    """The image count padded to a multiple of ``im_bucket`` (None or 0:
    not padded)."""
    return -(-n_ims // im_bucket) * im_bucket if im_bucket else n_ims


def checked_groups(param_handler, n_keys: int, k_pad: int):
    """(group_of_key padded to the key grid, n_groups) of a handler, as the
    JAX package checks them: ``UnsupportedChain`` where the handler has no
    groups (no ``group_of_key``, or ``n_groups() <= 0``), ``ValueError``
    unless every key maps into [0, n_groups). Pad keys take key 0's group
    (their masks are zero)."""
    raw_gok = getattr(param_handler, "group_of_key", lambda: None)()
    n_groups = int(getattr(param_handler, "n_groups", lambda: 0)() or 0)
    if raw_gok is None or n_groups <= 0:
        raise UnsupportedChain(
            "a PER_GROUP chain needs the handler to implement "
            "group_of_key() -> (n_keys,) int array and n_groups() -> int "
            f"(got group_of_key()={raw_gok!r}, n_groups()={n_groups})")
    gok = np.asarray(raw_gok, dtype=np.int64)
    if gok.shape != (n_keys,):
        raise ValueError(
            f"group_of_key() must return one group index per key "
            f"({n_keys},); got shape {gok.shape}")
    if gok.min() < 0 or gok.max() >= n_groups:
        raise ValueError(
            f"group_of_key() indices out of range [0, {n_groups})")
    return (np.concatenate([gok, np.full(k_pad - n_keys, gok[0],
                                         dtype=np.int64)]), n_groups)


class StructuredSolve:
    """``solve_fn`` of ``build_structured_problem`` and
    ``build_mixed_structured_problem``: a free parameter vector -> (the
    solved free vector, float64 numpy; the SLMResult), an LM solve of
    ``problem`` from it. ``graph=False`` runs the uncaptured step, the
    reference the captured one is held to.

    :param to_pieces: full vector (numpy) -> device pieces on the grid.
    :param merge: the solved device pieces -> full vector (numpy float64;
        the float32 pieces widened, which is exact)."""

    def __init__(self, problem: BAProblem, to_pieces, merge, base_full,
                 free_idx):
        self.problem = problem
        self._to_pieces = to_pieces
        self._merge = merge
        self._base_full = base_full
        self._free_idx = free_idx

    def pieces(self, x_free: np.ndarray):
        """x_free on the problem's grid, device and dtype."""
        full = self._base_full.copy()
        full[self._free_idx] = np.asarray(x_free, dtype=np.float64)
        return self._to_pieces(full)

    def __call__(self, x_free: np.ndarray, graph: bool = True):
        res = self.problem.solve(graph=graph, x0=self.pieces(x_free))
        return self._merge(res.x)[self._free_idx], res


def merge_structured(op_fun, struct, n_cams: int, n_ims: int, n_keys: int,
                     n_keyrows: int):
    """pieces -> full vector (numpy float64) of a template, self-cal,
    free-point or grouped chain: the real image and key rows (``n_keyrows``:
    the keys, or a grouped chain's groups) merged on the host."""
    def merge(x: ParamPieces) -> np.ndarray:
        host = ParamPieces(x.cam.double().cpu(), x.im[:n_ims].double().cpu(),
                           x.key[:n_keyrows].double().cpu())
        return merge_pieces_to_full(host, op_fun, struct, n_cams, n_ims,
                                    n_keys).numpy()
    return merge


def detection_residuals(op_fun, dd: np.ndarray, tpl: torch.Tensor,
                        key_rows, device, dtype):
    """fn(pieces) -> (n_real, 2) residuals of the detection table ``dd``
    in row order, float64 numpy, computed on ``device``. ``key_rows(p,
    key)``: the c-axis rows of the detections' keys (the key piece's rows,
    or a grouped or mixed chain's expansion)."""
    point_fn = op_fun.make_point_fn()
    assemble = op_fun.make_local_assembler()
    cols = torch.as_tensor(dd[:, :3].astype(np.int64), device=device)
    uv_rows = torch.as_tensor(dd[:, 3:5], dtype=dtype, device=device)

    def residuals(p) -> np.ndarray:
        cam, im, key = cols.unbind(1)
        local = assemble(p.cam[cam], p.im[im], key_rows(p, key))
        r = point_fn(local, tpl[key]) - uv_rows
        return r.double().cpu().numpy()

    return residuals


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
    layout (the mixed chain: ``build_mixed_structured_problem``).
    """
    if mesh is not None:
        raise NotImplementedError(
            "a sharded solve (mesh=) is not ported yet (ROADMAP Queue A "
            "item 11)")
    device = resolve_device(device)
    dtype = dtype or default_device_dtype(device)
    op_fun = param_handler.op_fun
    widths = chain_widths(op_fun)
    chain_family(op_fun, widths)
    opts = param_handler.problem_opts
    reduced_solver = opts.get("reduced_solver", "auto")

    x0 = np.asarray(param_handler.get_initial_params(), dtype=np.float64)
    n_cams = len(param_handler.cam_names)
    n_ims = int(param_handler.bundlePrimitive.poses.shape[0])
    n_keys = param_handler.n_keys()
    # the pose-free chain has no image parameters, but every (cam, im) pair
    # of the table still indexes a block on the grid
    n_ims_true = n_ims if widths.b else int(param_handler.detection.max_ims)
    n_ims_grid = image_grid(n_ims_true, opts.get("im_bucket", 8))
    if reduced_solver == "auto":
        reduced_solver = auto_reduced_solver(widths, n_cams, n_ims_grid)

    dd = param_handler.get_detection_data(flatten=True)
    blocks = build_block_arrays(dd, n_cams, n_ims_grid, n_keys,
                                k_pad_multiple=k_pad_multiple)
    k_pad = blocks.uv.shape[1]
    # PER_GROUP-keyed chains (multi-target): the key axis carries one
    # parameter row per GROUP, expanded onto the key grid by group_of_key
    grouped = widths.key_link == key_type.PER_GROUP
    gok_pad, n_groups = (checked_groups(param_handler, n_keys, k_pad)
                         if grouped else (None, 0))
    struct = op_fun.param_struct(n_cams, n_ims, n_keys, n_groups=n_groups)
    base_full = param_handler.bundlePrimitive.base_full()
    # the free entries: the fixed rows and, per column, the intrinsic
    # columns that are never free (a het rig's selector and pad slots, a
    # narrower Brown camera's extra coefficients)
    unfixed = param_handler.bundlePrimitive.unfixed_full()
    if x0.shape != (int(unfixed.sum()),):
        raise ValueError(
            f"the start has {x0.size} entries; the handler's layout frees "
            f"{int(unfixed.sum())}")
    base_full[unfixed] = x0
    free_idx = np.where(unfixed)[0]

    def to_pieces(full: np.ndarray) -> ParamPieces:
        p = split_full_params(torch.as_tensor(full), op_fun, struct, n_cams,
                              n_ims, n_keys, widths)
        p = pad_pieces_to_grid(p, widths, grouped, n_keys, k_pad, n_ims,
                               n_ims_grid)
        return ParamPieces(*(t.to(device=device, dtype=dtype) for t in p))

    colmask = build_colmask_pieces(base_full, unfixed, op_fun, struct,
                                   widths, n_cams, n_ims, n_keys, k_pad,
                                   n_ims_grid, grouped)
    uv, mask = blocks.as_device(device, dtype)
    tpl = torch.as_tensor(
        pad_template_table(param_handler.template_table(), op_fun.templated,
                           n_keys, k_pad), dtype=dtype, device=device)
    problem = BAProblem(
        op_fun, widths, struct, blocks, to_pieces(base_full), uv, mask, tpl,
        ParamPieces(*(t.to(device=device, dtype=dtype) for t in colmask)),
        opts.get("loss", "linear"), float(opts.get("f_scale", 1.0)),
        opts.get("loss_semantics", "component"), group_of_key=gok_pad,
        n_groups=n_groups if grouped else None,
        max_nfev=int(opts.get("max_nfev", 100)),
        reduced_solver=reduced_solver)
    solve_fn = StructuredSolve(
        problem, to_pieces,
        merge_structured(op_fun, struct, n_cams, n_ims, n_keys,
                         n_groups if grouped else n_keys),
        base_full, free_idx)

    # the residual of each real detection, in table row order
    if grouped:
        gok_t = torch.as_tensor(gok_pad, device=device)
        residuals = detection_residuals(
            op_fun, dd, tpl, lambda p, key: p.key[gok_t[key]], device,
            dtype)
    else:
        residuals = detection_residuals(
            op_fun, dd, tpl, lambda p, key: p.key[key], device, dtype)

    def residual_fn(x_free: np.ndarray) -> np.ndarray:
        return residuals(solve_fn.pieces(x_free))

    return solve_fn, residual_fn, x0


def build_mixed_structured_problem(param_handler, dtype=None, device="cuda",
                                   k_pad_multiple: int = 128, mesh=None):
    """A MIXED PER_KEY + PER_GROUP chain's problem (multi-target
    self-calibration) on the arrow-structured backend
    (``optim/structured_mixed.py``), on ``device`` (the card unless the
    caller names another; dtype as ``config.default_device_dtype``). Same
    contract as ``build_structured_problem``; ``solve_fn.problem`` is a
    ``problem.MixedProblem``. Raises UnsupportedChain when the chain is not
    mixed or the handler has no groups. The reduced system is dense (the
    group counts are tiny), as in the JAX package.
    """
    if mesh is not None:
        raise NotImplementedError(
            "a sharded solve (mesh=) is not ported yet (ROADMAP Queue A "
            "item 11)")
    device = resolve_device(device)
    dtype = dtype or default_device_dtype(device)
    # the key -> group map first, so that the diagnostic names the gap
    if getattr(param_handler, "group_of_key", lambda: None)() is None:
        checked_groups(param_handler, 0, 0)
    op_fun = param_handler.op_fun
    widths = mixed_chain_widths(op_fun)
    opts = param_handler.problem_opts

    x0 = np.asarray(param_handler.get_initial_params(), dtype=np.float64)
    n_cams = len(param_handler.cam_names)
    n_ims = int(param_handler.bundlePrimitive.poses.shape[0])
    n_keys = param_handler.n_keys()
    n_ims_grid = image_grid(n_ims, opts.get("im_bucket", 8))

    dd = param_handler.get_detection_data(flatten=True)
    blocks = build_block_arrays(dd, n_cams, n_ims_grid, n_keys,
                                k_pad_multiple=k_pad_multiple)
    k_pad = blocks.uv.shape[1]
    gok_pad, n_groups = checked_groups(param_handler, n_keys, k_pad)
    struct = op_fun.param_struct(n_cams, n_ims, n_keys, n_groups=n_groups)
    base_full = param_handler.bundlePrimitive.base_full()
    unfixed = param_handler.bundlePrimitive.unfixed_full()
    base_full[unfixed] = x0
    free_idx = np.where(unfixed)[0]

    def to_pieces(full: np.ndarray) -> MixedPieces:
        p = split_full_mixed(torch.as_tensor(full), op_fun, struct, n_cams,
                             n_ims, n_keys, n_groups)
        p = pad_mixed_pieces(p, n_keys, k_pad, n_ims, n_ims_grid)
        return MixedPieces(*(t.to(device=device, dtype=dtype) for t in p))

    cm = np.zeros_like(base_full)
    cm[unfixed] = 1.0
    cm = to_pieces(cm)
    cm.key[n_keys:] = 0.0
    cm.im[n_ims:] = 0.0
    tpl = torch.as_tensor(
        pad_template_table(param_handler.template_table(), op_fun.templated,
                           n_keys, k_pad), dtype=dtype, device=device)
    uv, mask = blocks.as_device(device, dtype)
    problem = MixedProblem(
        op_fun, widths, struct, blocks, to_pieces(base_full), uv, mask, tpl,
        cm, opts.get("loss", "linear"), float(opts.get("f_scale", 1.0)),
        opts.get("loss_semantics", "component"), group_of_key=gok_pad,
        n_groups=n_groups, max_nfev=int(opts.get("max_nfev", 100)))
    solve_fn = StructuredSolve(
        problem, to_pieces,
        lambda x: merge_mixed_to_full(x, op_fun, struct, n_cams, n_ims,
                                      n_keys, n_groups),
        base_full, free_idx)

    # the c-axis [group pose | point] of each detection's key, chain order
    # (the one layout the mixed path serves: structured_mixed)
    gok_t = torch.as_tensor(gok_pad, device=device)
    residuals = detection_residuals(
        op_fun, dd, tpl,
        lambda p, key: torch.cat([p.grp[gok_t[key]], p.key[key]], dim=1),
        device, dtype)

    def residual_fn(x_free: np.ndarray) -> np.ndarray:
        return residuals(solve_fn.pieces(x_free))

    return solve_fn, residual_fn, x0
