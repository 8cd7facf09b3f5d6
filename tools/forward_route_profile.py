#!/usr/bin/env python3
"""Where one evaluation of the structured backend's forward-mode route
spends the card's time.

    python3 tools/forward_route_profile.py [--top N]

On a card, for the rolling-shutter rig ``problems.rs_handler(16, 100)``
and the heterogeneous grouped and mixed problems
(``problems.{grouped,mixed}_problem(16, 100, camera_model=[fisheye,
standard, ...])``): one evaluation's device time by ``torch.profiler``
(the ``N`` aten operators and kernels with the most, and the profiler's
event count), its peak MiB, its ms uncaptured (host clock around a
synchronised call), and three warm captured solves' ms an evaluation,
beside the uniform standard-model problem's (Kernel E) for the two
multi-target ones. Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


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


def profile_one(name: str, prob, top: int, uniform=None):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    neq = prob.neq_fn()
    neq(prob.x0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2 ** 20
    neq(prob.x0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20 - base
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        neq(prob.x0)
        torch.cuda.synchronize()
    device = sum(ev.time_range.elapsed_us() for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA) / 1e3
    rows = sorted(prof.key_averages(),
                  key=lambda e: -e.self_device_time_total)[:top]
    res = prob.solve()
    warm = host_ms(prob.solve, 3)
    uncaptured = np.median(host_ms(lambda: neq(prob.x0), 3))
    fields = {"device_ms": f"{device:.3f}", "events": len(prof.events()),
              "peak_mib": f"{peak:.0f}",
              "uncaptured_eval_ms": f"{uncaptured:.3f}",
              "nit": res.nit, "nfev": res.nfev,
              "ms_per_evaluation": f"{np.median(warm) / res.nfev:.3f}"}
    if uniform is not None:
        ures = uniform.solve()
        fields["uniform_ms_per_evaluation"] = (
            f"{np.median(host_ms(uniform.solve, 3)) / ures.nfev:.3f}")
    print(f"[forward_route] case={name} " + " ".join(
        f"{k}={v}" for k, v in fields.items()), flush=True)
    for e in rows:
        print(f"[forward_route_op] case={name} "
              f"device_ms={e.self_device_time_total / 1e3:.3f} "
              f"count={e.count} name={e.key[:100].replace(' ', '_')}",
              flush=True)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("forward_route_profile: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    from pycamset_tpu_torch import problems
    from pycamset_tpu_torch.optim.structured_driver import (
        build_structured_problem)
    dev = torch.device("cuda", 0)
    handler, _ = problems.rs_handler(16, 100)
    profile_one("rs 16x100", build_structured_problem(
        handler, device=dev)[0].problem, args.top)
    het = ["fisheye", "standard"] * 8
    for name, maker in (("het_grouped 16x100", problems.grouped_problem),
                        ("het_mixed 16x100", problems.mixed_problem)):
        profile_one(name, maker(16, 100, dev, camera_model=het), args.top,
                    uniform=maker(16, 100, dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
