"""Time the kernel library's nvcc under other splits of Kernels C-F's
translation units.

``csrc/mixed_grams.cu`` (C and D at every camera model, E and F at the
standard one), ``mixed_models_e.cu`` and ``mixed_models_f.cu`` (E and F at
the other models) share ``mixed_kernels.cuh``. A layout says which of them
compile as one translation unit: ``a+b`` is one unit made of their
``#include``s. Each layout is built as ``_build.py`` builds the library:
its units and the library's other sources (``template_grams.cu``,
``psd_solve.cu``, ``peak.cu``) each by its own nvcc with the package's
flags, all started together; the link is left out. Prints each unit's nvcc
seconds and the layout's wall seconds. Layouts run one after another, in
the order given (name a layout twice to see the spread).

    python3 tools/nvcc_layouts.py                  # the three layouts below
    python3 tools/nvcc_layouts.py split one split  # the named ones, in turn
                                                   # (split, ef, one)

Needs nvcc (the card's machine); writes only under ``build/`` at the root
of the checkout.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from pycamset_tpu_torch import _build as bld  # noqa: E402

OTHERS = ("template_grams.cu", "psd_solve.cu", "peak.cu")
LAYOUTS = {
    # the repo's: three units
    "split": ("mixed_grams.cu", "mixed_models_e.cu", "mixed_models_f.cu"),
    # E and F at the other models in one unit beside mixed_grams.cu
    "ef": ("mixed_grams.cu", "mixed_models_e.cu+mixed_models_f.cu"),
    # everything in one unit
    "one": ("mixed_grams.cu+mixed_models_e.cu+mixed_models_f.cu",),
}


def unit_source(unit: str, tmp: Path) -> Path:
    """The unit's source: the file itself, or one made of the joined
    files' includes."""
    parts = unit.split("+")
    if len(parts) == 1:
        return bld.CSRC / unit
    src = tmp / ("_".join(Path(p).stem for p in parts) + ".cu")
    src.write_text("".join(f'#include "{bld.CSRC / p}"\n' for p in parts))
    return src


def nvcc_seconds(nvcc: str, src: Path, tmp: Path) -> float:
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *bld.NVCC_FLAGS, "-I", str(bld.CSRC), "-c",
                           str(src), "-o", str(tmp / f"{src.stem}.o")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {src}:\n{proc.stdout}\n"
                         f"{proc.stderr}")
    return time.perf_counter() - t0


def run_layout(nvcc: str, name: str) -> dict:
    units = LAYOUTS[name] + OTHERS
    bld.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=bld.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        srcs = [unit_source(u, tmp) for u in units]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
            secs = list(pool.map(lambda s: nvcc_seconds(nvcc, s, tmp), srcs))
        wall = time.perf_counter() - t0
    return {"wall": wall, **dict(zip(units, secs))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("layouts", nargs="*", metavar="LAYOUT",
                    help=f"layouts to build in turn, of {list(LAYOUTS)} "
                         f"(default: all three)")
    args = ap.parse_args()
    unknown = set(args.layouts) - set(LAYOUTS)
    if unknown:
        ap.error(f"unknown layouts {sorted(unknown)}")
    nvcc = bld.find_nvcc()
    for name in args.layouts or list(LAYOUTS):
        rec = run_layout(nvcc, name)
        print(f"[nvcc_layout] layout={name} wall_s={rec.pop('wall'):.2f} "
              + " ".join(f"nvcc_s:{u}={s:.2f}" for u, s in rec.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
