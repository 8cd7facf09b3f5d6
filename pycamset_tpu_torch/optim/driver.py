"""The optimisation driver: handler -> device problem -> LM -> CameraSet.

Counterpart of ``pycamset_tpu/optim/driver.py``: ``OptimizeResult``,
``build_solver``, ``make_optimisation_function``,
``run_bundle_adjustment`` and ``_finish_bundle_adjustment``. Backends:

- ``"auto"`` and ``"structured"``: the handler's problem
  (``TemplateBundleHandler``, ``SelfBundleHandler``,
  ``FreePointBundleHandler``, or a multi-target handler such as
  ``examples/extend_param_handler.py``'s: the grouped chain on
  ``build_structured_problem``, the mixed one on
  ``build_mixed_structured_problem``, tried when the first raises
  ``UnsupportedChain``, as the JAX package dispatches) built by
  ``optim/structured_driver.py`` and solved by the structured LM (one CUDA
  graph replay per LM step on a card). The structured builders take
  every chain their layouts accept, as the JAX package's do (a chain of
  no kernel family, such as the rolling-shutter handler's, on the
  forward-mode route); where neither takes the chain, ``"auto"`` falls
  back to the generic backend, as the JAX package does; ``"structured"``
  raises the first builder's error. A chain with aux channels (the
  rolling-shutter one) runs on the structured backend only: the generic
  and scipy backends refuse it with the JAX package's ``ValueError``.
- any other name but ``"scipy"`` and ``"sharded"`` (``"generic"`` in the
  JAX package's tests): the generic backend, ``build_solver``: the
  detections grouped by identical gather rows where that pays
  (``residuals.build_grouped_detection_arrays``), else the flat scatter
  layout, and the host-looped dense LM of ``optim/lm.py``, on the device.
- ``"scipy"``: ``scipy.optimize.least_squares`` (TRF, ``x_scale="jac"``)
  on the host over ``make_optimisation_function``'s residual and sparse
  Jacobian, which the device evaluates.

``device`` is the card unless the caller names another; dtype as
``config.default_device_dtype``. No backend falls back to the CPU or to
another backend when the card or a step fails.

``shared_intrinsics`` (True, a label list or a dict) takes the tied
backend (``optim/shared_intr.py::build_shared_structured_problem``), as in
the JAX package: never an untied solve. A backend other than ``"auto"`` /
``"structured"`` with it raises ``ValueError``, as the JAX package does.
``backend="sharded"`` is not ported: it raises ``NotImplementedError``
naming ROADMAP Queue A item 11.
"""
from __future__ import annotations

import logging
import time
from typing import Callable

import numpy as np
import torch

from pycamset_tpu_torch.config import default_device_dtype, resolve_device
from pycamset_tpu_torch.optim.lm import lm_solve
from pycamset_tpu_torch.optim.residuals import (
    build_grouped_detection_arrays, make_grouped_neq_fn, make_local_jac_fn,
    make_neq_fn, make_residual_fn)
from pycamset_tpu_torch.optim.structured import UnsupportedChain
from pycamset_tpu_torch.optim.structured_driver import (
    build_mixed_structured_problem, build_structured_problem)


class OptimizeResult(dict):
    """A scipy-style result bag with attribute access."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    __setattr__ = dict.__setitem__


def _refuse_aux_chain(op_fun):
    if getattr(op_fun, "aux_width", 0):
        raise ValueError(
            "chains with per-detection aux inputs (rolling shutter) run on "
            "the structured backend; use backend='structured' or 'auto'")


class GenericSolve:
    """``solve_fn`` of ``build_solver``: a free parameter vector -> (the
    solved free vector, float64 numpy; the ``LMResult``).

    ``layout`` is "grouped" (``shape`` = (U, M)) or "scatter" (``shape`` =
    (N_padded,)); ``neq_free(x)`` is one evaluation of the free system on
    the device (x a tensor of the solve's device and dtype)."""

    def __init__(self, neq_free, layout: str, shape: tuple, max_nfev: int,
                 device, dtype):
        self.neq_free = neq_free
        self.layout = layout
        self.shape = shape
        self.max_nfev = max_nfev
        self.device = device
        self.dtype = dtype

    def __call__(self, x_free: np.ndarray):
        x0 = torch.as_tensor(np.array(x_free, dtype=np.float64),
                             dtype=self.dtype, device=self.device)
        res = lm_solve(self.neq_free, x0, max_nfev=self.max_nfev)
        return res.x.double().cpu().numpy(), res


def build_solver(param_handler, dtype=None, pad_multiple: int = 512,
                 device="cuda"):
    """The generic backend's problem for a handler, on ``device`` (the card
    unless the caller names another; dtype as
    ``config.default_device_dtype``).

    :return: (solve_fn(x0_free) -> (x_free, LMResult): a
              ``GenericSolve``,
              residual_fn(x_free) -> (n_real, 2) unpadded residuals,
              float64 numpy, computed on the device,
              x0_free initial parameters)
    """
    device = resolve_device(device)
    dtype = dtype or default_device_dtype(device)
    op_fun = param_handler.op_fun
    _refuse_aux_chain(op_fun)

    x0 = np.asarray(param_handler.get_initial_params(), dtype=np.float64)
    # build_problem must run after get_initial_params: missing poses are only
    # known once the pose seeding has run
    struct, det = param_handler.build_problem(pad_multiple=pad_multiple)
    cols, tpl, uv, mask = det.as_device(device, dtype)

    base_full = param_handler.bundlePrimitive.base_full()
    unfixed = param_handler.bundlePrimitive.unfixed_full()
    base_full[unfixed] = x0
    free_idx = torch.as_tensor(np.where(unfixed)[0], device=device)
    base_dev = torch.as_tensor(base_full, dtype=dtype, device=device)

    opts = param_handler.problem_opts
    loss = opts.get("loss", "linear")
    f_scale = float(opts.get("f_scale", 1.0))
    semantics = opts.get("loss_semantics", "component")
    # detections grouped by identical gather rows assemble as batched
    # matmuls and one small scatter; chains whose rows are unique per
    # detection keep the flat scatter (the JAX package's rule)
    grouped = None
    if opts.get("grouped_neq", True):
        grouped = build_grouped_detection_arrays(op_fun, struct, None, None,
                                                 precomputed=det)
    if grouped is not None:
        neq_args = grouped.as_device(device, dtype)
        neq = make_grouped_neq_fn(op_fun, loss=loss, f_scale=f_scale,
                                  loss_semantics=semantics)
        layout, shape = "grouped", tuple(grouped.mask.shape)
    else:
        neq = make_neq_fn(op_fun, loss=loss, f_scale=f_scale,
                          loss_semantics=semantics)
        neq_args = (cols, tpl, uv, mask)
        layout, shape = "scatter", tuple(det.mask.shape)
    residual = make_residual_fn(op_fun)

    def neq_free(x_free):
        full = base_dev.index_put((free_idx,), x_free)
        jtj, grad, cost = neq(full, *neq_args)
        return jtj[free_idx][:, free_idx], grad[free_idx], cost

    def residual_fn(x_free: np.ndarray) -> np.ndarray:
        full = base_dev.index_put((free_idx,), torch.as_tensor(
            np.array(x_free, dtype=np.float64), dtype=dtype, device=device))
        r = residual(full, cols, tpl, uv, mask)
        return r[: det.n_real].double().cpu().numpy()

    solve_fn = GenericSolve(neq_free, layout, shape,
                            int(opts.get("max_nfev", 100)), device, dtype)
    return solve_fn, residual_fn, x0


def make_optimisation_function(param_handler, threads: int = 1,
                               device="cuda", x0=None, dtype=None
                               ) -> tuple[Callable, Callable | None,
                                          np.ndarray]:
    """A (loss_fn, jac_fn, init_params) triple over the free parameters.

    The reference's API (pyCamSet ``optimisation_handling.py:24-49``), as
    the JAX package has it: ``loss_fn`` returns the flattened residual
    vector and ``jac_fn`` a ``scipy.sparse.csr_array`` of shape
    (2 n_det, n_free), rows interleaving (x_i, y_i) per detection, from
    the per-detection local Jacobians evaluated on ``device`` (the card
    unless the caller names another) and scattered into CSR on the host:
    directly consumable by ``scipy.optimize.least_squares``.

    :param x0: the start, returned as ``init_params``; by default the
        handler's ``get_initial_params()`` (a PnP seed where the handler
        holds none, which needs OpenCV).
    :param dtype: of the device evaluation (default as
        ``config.default_device_dtype``); the outputs are float64 numpy.
    """
    from scipy.sparse import csr_array

    _refuse_aux_chain(param_handler.op_fun)
    logging.info("getting initial params")
    device = resolve_device(device)
    dtype = dtype or default_device_dtype(device)
    op_fun = param_handler.op_fun
    x0 = np.asarray(param_handler.get_initial_params() if x0 is None
                    else x0, dtype=np.float64)
    struct, det = param_handler.build_problem()
    cols_np = det.cols[: det.n_real]
    darrs = det.as_device(device, dtype)

    base_full = param_handler.bundlePrimitive.base_full()
    unfixed = param_handler.bundlePrimitive.unfixed_full()
    base_full[unfixed] = x0
    free_idx = np.where(unfixed)[0]
    full_to_free = np.full(struct.total, -1, dtype=np.int64)
    full_to_free[free_idx] = np.arange(free_idx.size)

    residual = make_residual_fn(op_fun)
    local_jac = make_local_jac_fn(op_fun)
    free_idx_t = torch.as_tensor(free_idx, device=device)
    base_dev = torch.as_tensor(base_full, dtype=dtype, device=device)

    def full_of(x):
        # a copy: scipy hands over read-only arrays
        return base_dev.index_put((free_idx_t,), torch.as_tensor(
            np.array(x, dtype=np.float64), dtype=dtype, device=device))

    def loss_fn(x):
        r = residual(full_of(x), *darrs)[: det.n_real]
        return r.double().cpu().numpy().reshape(-1)

    jac_fn = None
    if param_handler.can_make_jac():
        # the CSR sparsity (free columns only), fixed by the table
        col_free = full_to_free[cols_np]                    # (N, L), -1 fixed
        keep = col_free >= 0
        counts = keep.sum(axis=1)                           # entries per row
        total = int(counts.sum())
        indptr = np.concatenate(
            [[0], np.cumsum(np.repeat(counts, 2))]).astype(np.int64)
        # positions of the x-row / y-row entries in the data array
        blk_start = np.concatenate([[0], np.cumsum(2 * counts)[:-1]])
        ent_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        within = np.arange(total) - np.repeat(ent_start, counts)
        x_pos = np.repeat(blk_start, counts) + within
        y_pos = x_pos + np.repeat(counts, counts)
        flat_cols = col_free[keep]
        indices = np.empty(2 * total, dtype=np.int64)
        indices[x_pos] = flat_cols
        indices[y_pos] = flat_cols

        def jac_fn(x):
            _, jac = local_jac(full_of(x), *darrs)
            jac = jac[: det.n_real].double().cpu().numpy()  # (N, 2, L)
            data = np.empty(2 * total)
            data[x_pos] = jac[:, 0][keep]
            data[y_pos] = jac[:, 1][keep]
            return csr_array((data, indices, indptr),
                             shape=(2 * det.n_real, free_idx.size))

    return loss_fn, jac_fn, x0


def _scipy_solver(param_handler, device):
    """The ``"scipy"`` backend: scipy's TRF with the sparse Jacobian, on
    the host, over the device-evaluated residual and Jacobian."""
    from scipy.optimize import least_squares

    loss_fn, jac_fn, init_params = make_optimisation_function(
        param_handler, device=device)
    opts = param_handler.problem_opts

    def solve_fn(x0):
        sol = least_squares(
            loss_fn, x0, jac=jac_fn, verbose=opts.get("verbosity", 0),
            max_nfev=opts.get("max_nfev", 100),
            loss=opts.get("loss", "linear"), f_scale=opts.get("f_scale", 1.0),
            x_scale="jac")
        res = OptimizeResult(
            cost=2.0 * sol.cost,        # scipy's cost = 0.5 * sum(r^2)
            nfev=sol.nfev, nit=sol.nfev, status=sol.status,
            history=np.array([2.0 * sol.cost]))
        return np.asarray(sol.x, dtype=np.float64), res

    def residual_fn(x):
        return loss_fn(x).reshape(-1, 2)

    return solve_fn, residual_fn, init_params


def run_bundle_adjustment(param_handler, threads: int = 1, dtype=None,
                          backend: str = "auto", device="cuda"
                          ) -> tuple[OptimizeResult, object]:
    """Solve the bundle adjustment a handler describes.

    :return: (OptimizeResult with x / fun / cost / nfev / nit / status /
              history, the argmin CameraSet)
    """
    logging.info("Making optimisation problem")
    tied = param_handler.problem_opts.get("shared_intrinsics")
    if tied and backend == "sharded":
        raise ValueError(
            "shared_intrinsics is not available on the sharded backend (the "
            "tied reduced system is tiny)")
    if tied and backend not in ("auto", "structured"):
        # no silent fallback: the other backends have no tying fold and
        # would solve every camera's lens independently
        raise ValueError(
            f"shared_intrinsics is not available on the {backend!r} "
            "backend (it would silently solve untied); use "
            "backend='auto' or 'structured'")
    if backend == "sharded":
        raise NotImplementedError(
            "backend='sharded' is not ported yet (ROADMAP Queue A item 11)")
    if backend == "scipy":
        # the reference-equivalent solver, kept for parity validation
        return _finish_bundle_adjustment(
            param_handler, *_scipy_solver(param_handler, device))
    if backend not in ("auto", "structured"):
        return _finish_bundle_adjustment(
            param_handler, *build_solver(param_handler, dtype=dtype,
                                         device=device))
    if tied:
        from pycamset_tpu_torch.optim.shared_intr import (
            build_shared_structured_problem)
        solve_fn, residual_fn, init_params = build_shared_structured_problem(
            param_handler, dtype=dtype, device=device)
        logging.info("Using the tied (shared-intrinsics) backend")
        return _finish_bundle_adjustment(param_handler, solve_fn,
                                         residual_fn, init_params)
    try:
        solve_fn, residual_fn, init_params = build_structured_problem(
            param_handler, dtype=dtype, device=device)
        logging.info("Using the structured (Schur) backend")
    except UnsupportedChain as e:
        try:
            # mixed PER_KEY + PER_GROUP chains (multi-target self-cal)
            # have their own arrow-structured backend
            solve_fn, residual_fn, init_params = (
                build_mixed_structured_problem(param_handler, dtype=dtype,
                                               device=device))
            logging.info("Using the mixed (key+group) structured backend")
        except UnsupportedChain:
            if backend == "structured":
                raise e
            logging.info(f"Structured backend unavailable ({e}); "
                         "falling back to the generic backend")
            solve_fn, residual_fn, init_params = build_solver(
                param_handler, dtype=dtype, device=device)
    return _finish_bundle_adjustment(param_handler, solve_fn, residual_fn,
                                     init_params)


def _finish_bundle_adjustment(param_handler, solve_fn, residual_fn,
                              init_params):
    """Run the built solver and package the result."""
    init_err = residual_fn(init_params)
    init_euclid = float(np.mean(np.linalg.norm(init_err, axis=1)))
    logging.info(f"found {len(init_params):.2e} parameters")
    logging.info(f"found {init_err.size:.2e} control points")
    logging.info(f"Initial Euclidean error: {init_euclid:.2f} px")
    if init_euclid > 150 or np.isnan(init_euclid):
        logging.critical(
            "Found worryingly high/NaN initial error: check that the initial "
            "parametisation is sensible")
        logging.info(
            "This can often indicate failure to place a camera or target "
            "correctly, giving nonsensical errors.")

    start = time.time()
    x_final, res = solve_fn(init_params)
    end = time.time()

    final_res = residual_fn(x_final)
    final_euclid = float(np.mean(np.linalg.norm(final_res, axis=1)))
    logging.info(f"Final Euclidean error: {final_euclid:.2f} px")
    logging.info(f"Optimisation took {end - start: .2f} seconds.")
    if final_euclid > 5:
        logging.critical(
            "Remaining error is very large: please check the output results")

    history = (res.history.double().cpu().numpy()
               if torch.is_tensor(res.history)
               else np.asarray(res.history, dtype=np.float64))
    optimisation = OptimizeResult(
        x=x_final, fun=final_res.reshape(-1), jac=None,
        cost=float(res.cost) * 0.5, nfev=int(res.nfev), nit=int(res.nit),
        status=int(res.status), history=history[history >= 0])

    camset = param_handler.get_camset(x_final)
    camset.set_calibration_history(optimisation, param_handler)
    return optimisation, camset
