#!/usr/bin/env python3
"""Where the time of one warm BA solve goes, on one NVIDIA card.

    python3 chip_profile.py        # every shape below
    python3 chip_profile.py cg     # the CG dome alone

Solves the template problem (``bench.py::standard_problem``) at 16 x 100
and 64 x 400, the self-calibration problem (``bench.py::selfcal_problem``)
at 16 x 100 and 64 x 12, the mixed multi-target problem
(``bench.py::mixed_problem``) at 16 x 100 and 64 x 12 and the grouped
multi-target template problem (``problems.grouped_problem``) at 16 x 100
and the fleet (``bench.py::fleet_problem``: 64 rigs of 4 x 16, solved as
one batch, library route only) with the port: with the dense reduced
solve on the library route
(``cholesky_ex``, the default) and opted in to the one-launch SPD kernel
(``PYCAMSET_PALLAS_CHOL=1``), each in two modes: ``graph`` (the default,
each LM step one replay of the problem's CUDA graph) and ``host`` (the
uncaptured step, ``graph=False``; a fleet has one graph per cohort
size). Then the 288-camera dome (``problems.template_handler(288, 32)``'s
problem through ``build_structured_problem``: 4320 camera dimensions, which the
"auto" rule sends to the matrix-free CG reduced solver) on CG and, for
comparison, dense (library route), both modes. Each: one warm-up, five
solves timed with CUDA events, then one
more under ``torch.profiler``. Prints per shape, route and mode: LM
iterations (a fleet: its rigs' least and most), the median
solve time, the profiled solve's wall time, the device's busy time in it
(the sum of its device kernels, copies and fills) and the idle share that
leaves of the median solve, the number of device events, the graph's
replays and reads in the profiled solve (0 in ``host`` mode), and the top
operations by device and by host time.
Imports neither jax nor pycamset_tpu; needs one CUDA card and nvcc.
"""
from __future__ import annotations

import os
import sys
import time


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    if sys.argv[1:] != ["cg"]:
        profile_bench_shapes(dev)
    profile_cg_dome(dev)
    return 0


def profile_bench_shapes(dev):
    """The bench problems on both routes and the fleet, both modes."""
    from pycamset_tpu_torch.problems import (fleet_problem, grouped_problem,
                                             mixed_problem, selfcal_problem,
                                             standard_problem)
    for chain, make, n_cams, n_ims in (
            ("template", standard_problem, 16, 100),
            ("template", standard_problem, 64, 400),
            ("selfcal", selfcal_problem, 16, 100),
            ("selfcal", selfcal_problem, 64, 12),
            ("mixed", mixed_problem, 16, 100),
            ("mixed", mixed_problem, 64, 12),
            ("grouped", grouped_problem, 16, 100)):
        prob = make(n_cams, n_ims, dev)
        for route in ("library", "kernel"):
            os.environ.pop("PYCAMSET_PALLAS_CHOL", None)
            if route == "kernel":
                os.environ["PYCAMSET_PALLAS_CHOL"] = "1"
            for mode in ("graph", "host"):
                profile_solve(prob, chain, f"{n_cams}x{n_ims}", route, mode)
        os.environ.pop("PYCAMSET_PALLAS_CHOL", None)
    # the one-launch SPD kernel takes one system: the fleet's batch of
    # reduced systems takes the library route
    fleet = fleet_problem(64, 4, 16, dev)
    for mode in ("graph", "host"):
        profile_solve(fleet, "fleet", "64x4x16", "library", mode)


def profile_cg_dome(dev):
    """The dome's problem on the CG reduced solver, then dense, both
    modes (library route: n = 4320 is above the SPD kernel's MAX_N)."""
    import dataclasses

    from pycamset_tpu_torch.optim.structured_driver import (
        build_structured_problem)
    from pycamset_tpu_torch.problems import template_handler
    os.environ.pop("PYCAMSET_PALLAS_CHOL", None)
    handler, _ = template_handler(288, 32)
    prob = build_structured_problem(handler, device=dev)[0].problem
    for solver in ("cg", "dense"):
        if solver == "dense":
            prob = dataclasses.replace(prob, reduced_solver="dense",
                                       graphs={})
        for mode in ("graph", "host"):
            profile_solve(prob, f"template_{solver}", "288x32", "library",
                          mode)


def runner_counts(prob) -> tuple[int, int]:
    """(replays, reads) of a problem's step runners for the route in
    force: one SLMGraph, or a fleet's FleetGraph per cohort size."""
    runners = prob.graph()
    runners = runners.values() if isinstance(runners, dict) else [runners]
    return (sum(g.replays for g in runners), sum(g.reads for g in runners))


def profile_solve(prob, chain, shape, route, mode):
    """Time five warm solves, then profile one, and print the summary line
    and the top operations."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    graph = mode == "graph"
    prob.solve(graph=graph)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        prob.solve(graph=graph)
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    solve_ms = sorted(times)[len(times) // 2]
    before = runner_counts(prob)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = prob.solve(graph=graph)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    replays, reads = (a - b for a, b in zip(runner_counts(prob), before))
    nit = (res.nit if isinstance(res.nit, int)
           else f"{min(res.nit)}-{max(res.nit)}")
    # device activity (kernels, copies, fills), each counted once
    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    print(f"[profile] chain={chain} shape={shape} "
          f"dense_solve={route} mode={mode} nit={nit} "
          f"solve_ms_median={solve_ms:.3f} "
          f"profiled_wall_ms={wall_ms:.3f} device_busy_ms={busy_ms:.3f} "
          f"idle_share={1 - busy_ms / solve_ms:.3f} "
          f"device_events={len(dev_events)} replays={replays} "
          f"graph_reads={reads}", flush=True)
    ka = prof.key_averages()
    for key in ("self_device_time_total", "self_cpu_time_total"):
        print(ka.table(sort_by=key, row_limit=15,
                       max_name_column_width=60), flush=True)


if __name__ == "__main__":
    sys.exit(main())
