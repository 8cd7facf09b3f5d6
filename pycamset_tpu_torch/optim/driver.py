"""The optimisation driver: handler -> device problem -> LM -> CameraSet.

Counterpart of ``OptimizeResult``, ``run_bundle_adjustment`` and
``_finish_bundle_adjustment`` in ``pycamset_tpu/optim/driver.py``, for the
backends ``"auto"`` and ``"structured"``: the handler's problem
(``TemplateBundleHandler``, ``SelfBundleHandler``,
``FreePointBundleHandler``, or a multi-target handler such as
``examples/extend_param_handler.py``'s: the grouped chain on
``build_structured_problem``, the mixed one on
``build_mixed_structured_problem``, tried when the first raises
``UnsupportedChain``, as the JAX package dispatches) built by
``optim/structured_driver.py``, solved
by the structured LM (one CUDA graph replay per LM step on a card), the
residuals and the calibrated CameraSet with its calibration history. ``device`` is the card unless the caller names
another; dtype as ``config.default_device_dtype``.

``shared_intrinsics`` (True, a label list or a dict) takes the tied
backend (``optim/shared_intr.py::build_shared_structured_problem``), as in
the JAX package: never an untied solve. A backend other than ``"auto"`` /
``"structured"`` with it raises ``ValueError``, as the JAX package does.

Not in this slice, each raising ``NotImplementedError`` with its ROADMAP
Queue A item, never another backend: ``backend="scipy"`` and the generic
fallback of ``"auto"`` (item 8) for a chain that neither
``build_structured_problem`` nor ``build_mixed_structured_problem`` takes,
and ``backend="sharded"`` (item 11).
"""
from __future__ import annotations

import logging
import time

import numpy as np

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
    if backend not in ("auto", "structured"):
        item = {"sharded": "11"}.get(backend, "8")
        raise NotImplementedError(
            f"backend={backend!r} is not ported yet (ROADMAP Queue A item "
            f"{item}); the port serves 'auto' and 'structured'")
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
        except UnsupportedChain as e_mixed:
            raise NotImplementedError(
                f"{e}; {e_mixed}: neither structured backend takes this "
                f"chain, and backend='auto''s generic fallback is ROADMAP "
                f"Queue A item 8") from e
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

    history = np.asarray(res.history.double().cpu())
    optimisation = OptimizeResult(
        x=x_final, fun=final_res.reshape(-1), jac=None,
        cost=float(res.cost) * 0.5, nfev=int(res.nfev), nit=int(res.nit),
        status=int(res.status), history=history[history >= 0])

    camset = param_handler.get_camset(x_final)
    camset.set_calibration_history(optimisation, param_handler)
    return optimisation, camset
