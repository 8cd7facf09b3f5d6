#!/usr/bin/env python3
"""Where a Python script spends its wall time, by sampling its stack.

    python3 tools/sample_stacks.py [--interval S] [--out FILE] -- SCRIPT [ARGS]

Runs SCRIPT in this process as ``__main__`` while a thread reads the main
thread's stack every S seconds (default 0.25). At exit it writes FILE
(default ``chiprun_out/stack_samples.txt``): for each function
(``file:line name``) the seconds it was on the stack (inclusive) and at
its top (self), by the samples, largest first, and the run's wall
seconds. Sampling costs the script about one stack walk a sample. Exits
with SCRIPT's own code.
"""
from __future__ import annotations

import argparse
import os
import runpy
import sys
import threading
import time
from collections import Counter


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--interval", type=float, default=0.25)
    ap.add_argument("--out", default="chiprun_out/stack_samples.txt")
    ap.add_argument("script")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    main_id = threading.main_thread().ident
    inclusive, own = Counter(), Counter()
    done = threading.Event()

    def sample():
        while not done.wait(args.interval):
            frame = sys._current_frames().get(main_id)
            if frame is None:
                continue
            top, seen = True, set()
            while frame is not None:
                code = frame.f_code
                key = (f"{os.path.relpath(code.co_filename)}:"
                       f"{code.co_firstlineno} {code.co_name}")
                if top:
                    own[key] += 1
                    top = False
                if key not in seen:
                    seen.add(key)
                    inclusive[key] += 1
                frame = frame.f_back

    sampler = threading.Thread(target=sample, daemon=True)
    t0 = time.perf_counter()
    sampler.start()
    sys.argv = [args.script, *args.args]
    sys.path.insert(0, os.path.dirname(os.path.abspath(args.script)))
    code = 0
    try:
        runpy.run_path(args.script, run_name="__main__")
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else (0 if e.code is None
                                                        else 1)
        if not isinstance(e.code, int) and e.code is not None:
            print(e.code, file=sys.stderr)
    finally:
        done.set()
        sampler.join()
        wall = time.perf_counter() - t0
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        samples = inclusive.most_common(1)[0][1] if inclusive else 0
        with open(args.out, "w") as f:
            f.write(f"wall_s={wall:.1f} interval_s={args.interval} "
                    f"samples={samples}\n")
            f.write("inclusive_s self_s function\n")
            for key, n in inclusive.most_common(400):
                f.write(f"{n * args.interval:10.1f} "
                        f"{own[key] * args.interval:8.1f} {key}\n")
    return code


if __name__ == "__main__":
    sys.exit(main())
