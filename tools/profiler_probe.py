#!/usr/bin/env python3
"""How often a ``torch.profiler`` session on the card records no device
event, and whether the card's timestamps drift from the host's window.

    python3 tools/profiler_probe.py [--seconds S] [--overflow-every N]
                                    [--launches L] [--busy B] [--out FILE]
    python3 tools/profiler_probe.py --fill

For S seconds (default 240) it repeats, on card 0: one profiling session
(CUDA activity only, as ``chip_smoke.py::device_ms`` takes it) around L
(default 20) small matrix products; every tenth round one session with
CPU activity too, which gives the skew between the first ``aten::mm`` on
the host and the first kernel on the card (µs, both on the profiler's
clock); one captured CUDA graph of the same products replayed under the
profiler; and between rounds some B seconds (default 0.5) of other work
on the card. Every N rounds (default 50), one session around 300,000 launches (more than the profiler's buffers
are sized for), after which the next sessions should still record.
Each round's record (process age, the host's wall clock minus its
monotonic clock, device events, the first kernel's start relative to the
trace start, the skew) goes to FILE as JSON lines; the summary (sessions,
empty sessions and when, skew and wall-clock drift ranges, the host
seconds a session takes to enter, to leave and to read its events) is
printed last, after the card's name and power limit. With ``--fill``
it only counts the device events of sessions taken while PyTorch's
allocator holds all but a few MiB of the card's memory, and again after
it gives the memory back.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np


SECONDS = {"enter": [], "exit": [], "events": []}


def session(fn, cpu: bool = False):
    """(device events, first kernel's start µs from the trace start, the
    skew µs between the first aten::mm and the first kernel or None); the
    host seconds of entering the session, leaving it and reading its
    events go to SECONDS."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    prof = profile(activities=acts)
    t0 = time.perf_counter()
    prof.__enter__()
    t1 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    prof.__exit__(None, None, None)
    t3 = time.perf_counter()
    evs = prof.events()
    t4 = time.perf_counter()
    SECONDS["enter"].append(t1 - t0)
    SECONDS["exit"].append(t3 - t2)
    SECONDS["events"].append(t4 - t3)
    dev = [e for e in evs if e.device_type == DeviceType.CUDA]
    first = min((e.time_range.start for e in dev), default=None)
    skew = None
    if cpu and dev:
        mm = [e.time_range.start for e in evs
              if e.device_type == DeviceType.CPU and e.name == "aten::mm"]
        if mm:
            skew = first - min(mm)
    return len(dev), first, skew


def fill_check(small, replay) -> dict:
    """Device events of three sessions of ``small`` and of ``replay`` with
    the card's memory held by PyTorch's allocator down to a few MiB free,
    and again once it is given back (``empty_cache``)."""
    import torch
    out, hold = {}, []
    free, _ = torch.cuda.mem_get_info()
    while free > 4 * 2 ** 20:
        n = min(free - 2 * 2 ** 20, 2 ** 30)
        try:
            hold.append(torch.empty(n, dtype=torch.uint8, device="cuda"))
        except torch.OutOfMemoryError:
            break
        free, _ = torch.cuda.mem_get_info()
    out["free_mib_held"] = free / 2 ** 20
    out["held"] = [session(small)[0] for _ in range(3)] + [
        session(replay)[0] for _ in range(3)]
    del hold
    torch.cuda.empty_cache()
    out["free_mib_given_back"] = torch.cuda.mem_get_info()[0] / 2 ** 20
    out["given_back"] = [session(small)[0] for _ in range(3)] + [
        session(replay)[0] for _ in range(3)]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=240.0)
    ap.add_argument("--overflow-every", type=int, default=50)
    ap.add_argument("--launches", type=int, default=20)
    ap.add_argument("--busy", type=float, default=0.5)
    ap.add_argument("--fill", action="store_true",
                    help="only the device-memory check (see fill_check)")
    ap.add_argument("--out", default="chiprun_out/profiler_probe.jsonl")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profiler_probe: no CUDA device", flush=True)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    a = torch.randn(256, 256, device=dev)
    big = torch.randn(4096, 4096, device=dev)

    def small():
        for _ in range(args.launches):
            a @ a

    def tiny_many():
        for _ in range(300_000):
            a.add_(0.0)

    g = torch.cuda.CUDAGraph()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        small()
    torch.cuda.current_stream().wait_stream(s)
    with torch.cuda.graph(g):
        small()

    if args.fill:
        print(json.dumps(fill_check(small, g.replay)), flush=True)
        return 0
    t0 = time.monotonic()
    wall0 = time.time_ns() - time.monotonic_ns()
    rounds, empty, skews, drift = 0, [], [], []
    with open(args.out, "w") as f:
        while time.monotonic() - t0 < args.seconds:
            rec = {"round": rounds, "age_s": round(time.monotonic() - t0, 3),
                   "wall_minus_mono_ms": (time.time_ns() - time.monotonic_ns()
                                          - wall0) / 1e6}
            drift.append(rec["wall_minus_mono_ms"])
            rec["events"], rec["first_us"], _ = session(small)
            rec["graph_events"], _, _ = session(g.replay)
            if rounds % 10 == 0:
                rec["cpu_events"], _, rec["skew_us"] = session(small, cpu=True)
                if rec["skew_us"] is not None:
                    skews.append(rec["skew_us"])
            if rounds % args.overflow_every == args.overflow_every // 2:
                rec["overflow_events"], _, _ = session(tiny_many)
            for key in ("events", "graph_events", "cpu_events"):
                if rec.get(key) == 0:
                    empty.append({"round": rounds, "age_s": rec["age_s"],
                                  "session": key})
            f.write(json.dumps(rec) + "\n")
            f.flush()
            tb = time.monotonic()
            while time.monotonic() - tb < args.busy:
                big @ big
                torch.cuda.synchronize()
            rounds += 1
    summary = {"rounds": rounds, "empty_sessions": len(empty),
               "empty": empty[:40],
               "skew_us_min": min(skews, default=None),
               "skew_us_max": max(skews, default=None),
               "wall_minus_mono_ms_min": min(drift),
               "wall_minus_mono_ms_max": max(drift),
               **{f"session_{k}_s_median": float(np.median(v))
                  for k, v in SECONDS.items()},
               **{f"session_{k}_s_max": max(v) for k, v in SECONDS.items()}}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
