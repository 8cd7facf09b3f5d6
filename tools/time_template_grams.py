#!/usr/bin/env python3
"""Time builds of the template gram kernels (A and B) side by side on a card.

    python3 tools/time_template_grams.py [--time-only] [SOURCE.cu[:NVCC FLAGS]] ...

Each argument is a version of ``pycamset_tpu_torch/csrc/template_grams.cu``
(default: the checkout's own), optionally with extra nvcc flags after a
colon, for example ``old/template_grams.cu`` or
``csrc/template_grams.cu:-DSOME_SWITCH``. Every version is compiled by its
own nvcc, all at once, with the package's flags, into its own library; the
kernel wrappers are then pointed at each library in turn. For each version
and each of the two template shapes that ``chip_smoke.py`` drives (16 x 100
and 64 x 400), it holds A and B against their float64 plain twins (linear
and huber loss, the smoke's tolerance), checks that a repeat launch gives
the same bits, and times each kernel's launch alone by CUDA events
(``chip_smoke.cuda_ms``, 50 launches): A, and B at chunks of 1, 2, 4 and 8
images. Prints the card's name and power limit first, the ptxas registers
and spills of each build, and one ``[variant_time]`` line per version and
shape. ``--time-only`` reports a parity or bit failure and times the
version anyway: for diagnostic builds that skip a phase on purpose. Compare
versions only within one run.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def build(nvcc: str, out: Path, i: int, spec: str):
    """Compile one version into ``out/v<i>.so``; returns it and the ptxas
    report."""
    from pycamset_tpu_torch import _build as bld
    src, _, flags = spec.partition(":")
    so = out / f"v{i}.so"
    proc = subprocess.run([nvcc, *bld.NVCC_FLAGS, *flags.split(), "-shared",
                           "-o", str(so), src], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {spec}:\n{proc.stdout}\n"
                         f"{proc.stderr}")
    return so, proc.stderr


def check_version(cs, cg, f32, n_cams, n_ims, shape):
    """A and B against their float64 twins (linear and huber loss), and
    the same bits on a repeat launch; raises SystemExit on a failure."""
    for loss in ("linear", "huber"):
        kw = dict(loss=loss, f_scale=2.0)
        f64 = tuple(x.double() for x in f32)
        a_got = cg.template_gram(*f32, **kw)
        a_ref = cg.template_gram_plain(*f64, **kw)
        cs.parity(f"A {shape} {loss}", [a_got], [a_ref],
                  cg.scaled_errors(a_got, a_ref))
        b_got = cg.template_gram_fused(*f32, n_cams, n_ims, **kw)
        b_ref = cg.template_gram_fused_plain(*f64, n_cams, n_ims, **kw)
        cs.parity(f"B {shape} {loss}", b_got, b_ref,
                  cg.scaled_errors_fused(b_got, b_ref, a_ref, n_cams, n_ims))
    cs.same_bits("A", lambda: cg.template_gram(*f32))
    cs.same_bits("B", lambda: cg.template_gram_fused(*f32, n_cams, n_ims))


def main() -> int:
    import torch

    import chip_smoke as cs
    from pycamset_tpu_torch import _build as bld
    from pycamset_tpu_torch.optim import cuda_grams as cg
    from pycamset_tpu_torch.problems import standard_problem

    time_only = "--time-only" in sys.argv[1:]
    specs = [a for a in sys.argv[1:] if a != "--time-only"] or [
        str(bld.CSRC / "template_grams.cu")]
    cs.phase_device()
    nvcc = bld.find_nvcc()
    out = bld.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(specs)) as pool:
        built = list(pool.map(lambda a: build(nvcc, out, *a),
                              enumerate(specs)))

    dev = torch.device("cuda", 0)
    probs = {"16x100": standard_problem(16, 100, dev),
             "64x400": standard_problem(64, 400, dev)}
    chunk0 = cg.FUSED_CHUNK
    for spec, (so, ptxas) in zip(specs, built):
        print(f"=== {spec}", flush=True)
        for ln in ptxas.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  ptxas: {ln.strip()}", flush=True)
        lib = ctypes.CDLL(str(so))
        for name in ("pct_template_gram", "pct_template_gram_fused"):
            getattr(lib, name).argtypes = bld._SIGNATURES[name]
            getattr(lib, name).restype = ctypes.c_int
        # the wrappers reach the kernels through _build.load().lib
        bld.load = lambda lib=lib: types.SimpleNamespace(lib=lib)
        for shape, prob in probs.items():
            f32 = cs.template_inputs(prob)
            n_cams, n_ims = prob.blocks.n_cams, prob.blocks.n_ims
            try:
                check_version(cs, cg, f32, n_cams, n_ims, shape)
            except SystemExit as e:
                if not time_only:
                    raise
                print(f"  {shape}: {e} (timed all the same)", flush=True)
            packed = cg.pack_block_params(*f32[:2])
            line = {"A_ms": cs.cuda_ms(
                lambda: cg._launch_gram(packed, *f32[2:], 0, 1, 1.0), 50)}
            for chunk in (1, 2, 4, 8):
                cg.FUSED_CHUNK = chunk
                line[f"B_ms_chunk{chunk}"] = cs.cuda_ms(
                    lambda: cg._launch_gram_fused(packed, *f32[2:], n_cams,
                                                  n_ims, 0, 1, 1.0), 50)
            cg.FUSED_CHUNK = chunk0
            cs.say("variant_time", source=spec.replace(" ", "_"),
                   shape=shape, **{k: f"{v:.4f}" for k, v in line.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
