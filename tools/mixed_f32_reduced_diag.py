#!/usr/bin/env python3
"""The mixed multi-target LM in float32 on the CPU, in both packages, with
the reduced system's group-pose diagonal at every LM step.

    JAX_PLATFORMS=cpu python3 tools/mixed_f32_reduced_diag.py [n_cams n_ims]

Builds ``bench.py::mixed_problem`` (default 64 x 12) in float32 twice: in
the JAX package (its XLA gram builders, as the CPU backend picks them; the
bench's builder runs as it is, with ``config.default_device_dtype``
patched to float32 for the run) and in the port (its plain PyTorch twins),
and runs each package's structured LM. Each reduced system [cam | pose | group] that the dense solve receives
is recorded: the smallest of its 12 group-pose diagonal entries (group 0 is
fixed, so its 6 are zero), the smallest of the free group's 6, and whether
any is negative. Prints one line per LM step and package, then a summary.
The reduced diagonal is read where each package hands the system to its
dense solve (``structured_mixed._psd_solve``), which the script wraps for
the run; nothing in either package is changed.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def jax_run(n_cams, n_ims):
    """bench.py::mixed_problem's solve, built with the JAX package's
    device dtype patched to float32 for the run."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import bench
    from pycamset_tpu import config
    from pycamset_tpu.optim import structured_mixed as sm

    seen = []
    orig_solve, orig_dtype = sm._psd_solve, config.default_device_dtype

    def spy(amat, rhs):
        jax.debug.callback(lambda d: seen.append(np.asarray(d)),
                           jnp.diagonal(amat)[-12:], ordered=True)
        return orig_solve(amat, rhs)

    sm._psd_solve = spy
    config.default_device_dtype = lambda: jnp.float32
    try:
        solve, pieces, args, _ = bench.mixed_problem(n_cams, n_ims)
        res = solve(pieces, *args)
        jax.block_until_ready(res)
    finally:
        sm._psd_solve, config.default_device_dtype = orig_solve, orig_dtype
    assert res.x.cam.dtype == jnp.float32
    hist = np.asarray(res.history)[:int(res.nit) + 1]
    return seen, hist, int(res.nit), int(res.status)


def torch_run(n_cams, n_ims):
    """The port's mixed problem in float32 on the CPU (plain twins)."""
    import torch

    from pycamset_tpu_torch.optim import structured_mixed as sm
    from pycamset_tpu_torch.problems import mixed_problem
    prob = mixed_problem(n_cams, n_ims, "cpu", torch.float32)
    seen = []
    orig = sm._psd_solve

    def spy(amat, rhs):
        seen.append(torch.diagonal(amat)[-12:].double().numpy().copy())
        return orig(amat, rhs)

    sm._psd_solve = spy
    try:
        res = prob.solve()
    finally:
        sm._psd_solve = orig
    assert res.x.cam.dtype == torch.float32
    hist = res.history[:res.nit + 1].double().numpy()
    return seen, hist, res.nit, int(res.status)


def report(name, seen, hist, nit, status):
    negative = []
    for step, d in enumerate(seen):
        free = d[6:]
        accepted = step + 1 < len(hist) and hist[step + 1] < hist[step]
        if (d < 0).any():
            negative.append(step)
        print(f"[{name}] lm_step={step} min_group_diag={d.min():.6e} "
              f"min_free_group_diag={free.min():.6e} "
              f"negative={int((d < 0).sum())} accepted={accepted}",
              flush=True)
    print(f"[{name}] nit={nit} status={status} cost0={hist[0]:.6e} "
          f"cost={hist[-1]:.6e} steps_with_negative_diag={negative}",
          flush=True)
    return negative


def main() -> int:
    n_cams, n_ims = (int(a) for a in sys.argv[1:3]) if len(sys.argv) > 2 \
        else (64, 12)
    neg_jax = report("jax_f32", *jax_run(n_cams, n_ims))
    neg_torch = report("torch_f32", *torch_run(n_cams, n_ims))
    print(f"[summary] shape={n_cams}x{n_ims} jax_negative_steps={neg_jax} "
          f"torch_negative_steps={neg_torch}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
