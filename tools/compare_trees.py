#!/usr/bin/env python3
"""The same measurements on several checkouts of the port, on one card.

    python3 tools/compare_trees.py ROOT [ROOT ...] [--rounds 2]

Each ROOT is the root of a checkout (for example the parent commit
unpacked by ``git archive`` into ``build/``). For each round, each root in
turn (the order reversed in every other round: A B B A) is measured in a
process of its own, which imports that root's ``pycamset_tpu_torch``:

- the generic backend (``driver.build_solver``) on
  ``problems.template_handler(16, 100)`` (grouped layout) and on the self-
  calibration stage of the same rig with its board bent 0.5 mm (scatter
  layout): ms an LM step of warm solves (median of 3 over nit) and the
  peak MiB of one solve;
- ``calibration_uncertainty`` of the template rig's solved CameraSet:
  host seconds (median of 3) and peak MiB;
- the mixed (Kernel E at 16 x 100, F at 64 x 12) and grouped (E) bench
  problems: ms an evaluation of warm captured solves (median of 5 over
  nfev);
- the mixed handler fleets 64 x 4 x 16 (E folded) and 64 x 4 x 12 (F
  folded, ``im_bucket: None``): rigs/s of warm batch solves (median of 3);
- where the root has them, the forward-mode route's problems: the
  rolling-shutter rig ``problems.rs_handler(16, 100)`` and the
  heterogeneous grouped and mixed problems (fisheye and standard cameras
  in turn): ms an evaluation as above, and the peak MiB of one
  evaluation.

Prints the card's name and power limit first, then one line a case:
``[compare] root=... round=... case=... key=value ...``. Needs one CUDA
card and nvcc; imports neither jax nor pycamset_tpu.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

BOARD_WARP = 5e-4


def host_ms(fn, n: int) -> list[float]:
    import torch
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def peak_mib_of(fn) -> float:
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def say(tag: str, case: str, **fields):
    print(f"[compare] {tag} case={case} " + " ".join(
        f"{k}={v}" for k, v in fields.items()), flush=True)


def generic(tag, name, handler, dev):
    import numpy as np
    from pycamset_tpu_torch.optim.driver import build_solver
    solve_fn, _, x0 = build_solver(handler, device=dev)
    box = {}

    def solve():
        box["res"] = solve_fn(x0)[1]

    solve()
    peak = peak_mib_of(solve)
    ms = host_ms(solve, 3)
    nit = int(box["res"].nit)
    say(tag, f"generic_{name}", nit=nit,
        ms_per_step=f"{np.median(ms) / nit:.3f}",
        solve_ms_all=",".join(f"{m:.1f}" for m in ms),
        peak_mib=f"{peak:.0f}")


def per_evaluation(tag, name, prob, eval_peak: bool = False):
    import numpy as np
    res = prob.solve()
    ms = host_ms(prob.solve, 5)
    fields = {"nit": res.nit, "nfev": res.nfev,
              "ms_per_evaluation": f"{np.median(ms) / res.nfev:.3f}",
              "solve_ms_all": ",".join(f"{m:.2f}" for m in ms)}
    if eval_peak:
        neq = prob.neq_fn()
        neq(prob.x0)
        fields["eval_peak_mib"] = f"{peak_mib_of(lambda: neq(prob.x0)):.0f}"
    say(tag, name, **fields)


def measure(root: str, round_: int) -> int:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import pycamset_tpu_torch
    from pycamset_tpu_torch import problems
    from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
    from pycamset_tpu_torch.optim.fleet import build_fleet_problem
    from pycamset_tpu_torch.optim.uncertainty import calibration_uncertainty
    if not str(Path(pycamset_tpu_torch.__file__)).startswith(
            str(Path(root).resolve())):
        print(f"compare_trees: imported {pycamset_tpu_torch.__file__}, "
              f"not {root}'s package", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    tag = f"root={root} round={round_}"

    tpl, _ = problems.template_handler(16, 100)
    x_tpl = tpl.get_initial_params()
    generic(tag, "template_16x100", tpl, dev)
    bent, _ = problems.template_handler(16, 100, template_warp=BOARD_WARP)
    _, stage = run_bundle_adjustment(bent, device=dev)
    generic(tag, "selfcal_16x100",
            problems.selfcal_stage_handler(stage, bent), dev)

    tpl.set_initial_params(x_tpl)
    _, cams = run_bundle_adjustment(tpl, device=dev)
    calibration_uncertainty(cams, device=dev)
    peak = peak_mib_of(lambda: calibration_uncertainty(cams, device=dev))
    ms = host_ms(lambda: calibration_uncertainty(cams, device=dev), 3)
    say(tag, "uncertainty_template_16x100", host_ms=f"{np.median(ms):.1f}",
        peak_mib=f"{peak:.0f}")

    for name, make, shape in (("mixed_16x100_E", problems.mixed_problem,
                               (16, 100)),
                              ("mixed_64x12_F", problems.mixed_problem,
                               (64, 12)),
                              ("grouped_16x100_E", problems.grouped_problem,
                               (16, 100))):
        per_evaluation(tag, name, make(*shape, dev))

    for name, n_ims, options in (("mixed_fleet_64x4x16_E", 16, None),
                                 ("mixed_fleet_64x4x12_F", 12,
                                  {"im_bucket": None})):
        fleet = build_fleet_problem(
            problems.fleet_handlers("mixed", 64, 4, n_ims, options=options),
            device=dev)
        fleet.solve_batch()
        ms = host_ms(fleet.solve_batch, 3)
        say(tag, name, rigs_per_s=f"{fleet.n_rigs / np.median(ms) * 1e3:.1f}",
            solve_ms_all=",".join(f"{m:.2f}" for m in ms))
        del fleet
        torch.cuda.empty_cache()

    if hasattr(problems, "rs_handler"):
        from pycamset_tpu_torch.optim.structured_driver import (
            build_structured_problem)
        handler, _ = problems.rs_handler(16, 100)
        per_evaluation(tag, "rs_16x100", build_structured_problem(
            handler, device=dev)[0].problem, eval_peak=True)
        het = ["fisheye", "standard"] * 8
        for name, make in (("het_grouped_16x100", problems.grouped_problem),
                           ("het_mixed_16x100", problems.mixed_problem)):
            per_evaluation(tag, name, make(16, 100, dev, camera_model=het),
                           eval_peak=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--measure", type=int, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure is not None:
        return measure(args.roots[0], args.measure)
    import torch
    if not torch.cuda.is_available():
        print("compare_trees: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    rc = 0
    for r in range(args.rounds):
        for root in (args.roots if r % 2 == 0 else args.roots[::-1]):
            t0 = time.perf_counter()
            rc |= subprocess.run([sys.executable, __file__, root,
                                  "--measure", str(r)]).returncode
            print(f"[compare] root={root} round={r} seconds="
                  f"{time.perf_counter() - t0:.1f}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
