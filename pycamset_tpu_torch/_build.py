"""Build and load the package's CUDA kernels at first use.

The sources are ``csrc/*.cu`` (and the headers ``csrc/*.cuh`` they share)
with a plain C interface. Each ``.cu`` is compiled by its own ``nvcc`` for
Hopper (``sm_90a``), all of them at once, and the objects are linked into
one shared library under ``build/pycamset_tpu_torch/`` at the root of the
checkout, named by a hash of the sources and flags (a changed source
rebuilds), and loaded with ``ctypes``. A library that includes no PyTorch
header builds in seconds.

Nothing here runs at import: ``load()`` is called by the kernel wrappers
(``optim/cuda_grams.py``, ``optim/cuda_selfcal_grams.py``,
``optim/cuda_mixed_grams.py``, ``ops/cuda_cholesky.py``, ``peak.py``) the
first time a CUDA tensor reaches them.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "pycamset_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argument types of the C entry points of csrc/template_grams.cu,
# csrc/mixed_grams.cu (Kernels C-F), csrc/mixed_models_{e,f}.cu (E and F at
# the other camera models), csrc/psd_solve.cu and csrc/peak.cu
_SIGNATURES = {
    "pct_template_gram": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "pct_template_gram_fused": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                                _P, _P, _P, _P, _P, _P, _P, _P],
    # Kernels A and B at another camera model: the intrinsic width first
    "pct_template_gram_model": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                                _P],
    "pct_template_gram_fused_model": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                      _F, _I, _P, _P, _P, _P, _P, _P, _P,
                                      _P],
    "pct_selfcal_gram": [_P] * 7 + [_I, _I, _I, _I, _F, _I] + [_P] * 8,
    "pct_selfcal_gram_fused": [_P] * 6 + [_I, _I, _I, _I, _I, _F, _I]
                              + [_P] * 15,
    # Kernels C and D at another camera model: the intrinsic width first
    "pct_selfcal_gram_model": [_I] + [_P] * 7 + [_I, _I, _I, _I, _F, _I]
                              + [_P] * 8,
    "pct_selfcal_gram_fused_model": [_I] + [_P] * 6
                                    + [_I, _I, _I, _I, _I, _F, _I]
                                    + [_P] * 15,
    "pct_mixed_gram": [_P] * 7 + [_I, _I, _I, _I, _I, _F, _I] + [_P] * 8,
    "pct_mixed_gram_fused": [_P] * 7 + [_I, _I, _I, _I, _I, _I, _F, _I]
                            + [_P] * 15,
    # Kernels E and F at another camera model: the intrinsic width first
    "pct_mixed_gram_model": [_I] + [_P] * 7 + [_I, _I, _I, _I, _I, _F, _I]
                            + [_P] * 8,
    "pct_mixed_gram_fused_model": [_I] + [_P] * 7
                                  + [_I, _I, _I, _I, _I, _I, _F, _I]
                                  + [_P] * 15,
    # Kernels C-F over n_rigs rigs at any width: the intrinsic width and
    # the rig count first
    "pct_selfcal_gram_rigs": [_I, _I] + [_P] * 7 + [_I, _I, _I, _I, _F, _I]
                             + [_P] * 8,
    "pct_selfcal_gram_fused_rigs": [_I, _I] + [_P] * 6
                                   + [_I, _I, _I, _I, _I, _F, _I]
                                   + [_P] * 15,
    "pct_mixed_gram_rigs": [_I, _I] + [_P] * 7
                           + [_I, _I, _I, _I, _I, _F, _I] + [_P] * 8,
    "pct_mixed_gram_fused_rigs": [_I, _I] + [_P] * 7
                                 + [_I, _I, _I, _I, _I, _I, _F, _I]
                                 + [_P] * 15,
    # what the device makes of C-F's first pass at (intr_w, cw, fused)
    "pct_mixed_occupancy": [_I, _I, _I, _P],
    "pct_psd_solve": [_P, _P, _I, _I] + [_P] * 9,
    "pct_psd_diag_tile": [_P, _I, _I, _P, _P],
    "pct_psd_solve_batched": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    "pct_psd_batched_smem_max_n": [],
    "pct_fma_chain": [_P, _P, _I, _I, _P],
}


@dataclass
class KernelLibrary:
    """The loaded kernels and how they were built."""
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an up-to-date library was found
    source_seconds: dict   # each source's nvcc seconds ({} when found)
    ptxas_info: str        # nvcc's -Xptxas -v report (registers, spills),
                           # kept beside the library as *.ptxas.txt


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc was not found (not on PATH, not under $CUDA_HOME/bin or "
        "/usr/local/cuda/bin): the CUDA toolkit is needed to build the "
        "kernels in pycamset_tpu_torch/csrc")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmd: list[str]) -> tuple[str, float]:
    """Run one nvcc command; raise with its output if it fails. Returns
    its stderr and its seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")
    return proc.stderr.strip(), time.perf_counter() - t0


def _compile_and_link(nvcc: str, out: Path) -> tuple[str, dict]:
    """One nvcc per source, all started together, then one link into
    ``out``; returns the compilers' -Xptxas -v reports and each source's
    seconds."""
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        with ThreadPoolExecutor(max_workers=len(objs)) as pool:
            runs = list(pool.map(
                lambda so: _run([nvcc, *NVCC_FLAGS, "-c", str(so[0]), "-o",
                                 str(so[1])]),
                zip(_sources(), objs)))
        _run([nvcc, "-shared", "-o", str(out), *map(str, objs)])
    return ("\n".join(report for report, _ in runs),
            {src.name: sec for src, (_, sec) in zip(_sources(), runs)})


@functools.cache
def load() -> KernelLibrary:
    """Build (if needed) and load the kernel library, once per process."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"libpct_kernels_{_source_hash()}.so"
    # the ptxas report is kept beside the library, so that a cached library
    # still reports its registers and spills
    report = path.with_suffix(".ptxas.txt")
    seconds, by_source = 0.0, {}
    if not (path.exists() and report.exists()):
        tmp = path.with_suffix(f".{os.getpid()}.tmp.so")
        t0 = time.perf_counter()
        try:
            ptxas, by_source = _compile_and_link(nvcc, tmp)
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise
        seconds = time.perf_counter() - t0
        tmp_report = report.with_suffix(f".{os.getpid()}.tmp")
        tmp_report.write_text(ptxas)
        os.replace(tmp_report, report)
        os.replace(tmp, path)
    ptxas = report.read_text()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return KernelLibrary(lib, path, seconds, by_source, ptxas)
