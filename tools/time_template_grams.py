#!/usr/bin/env python3
"""Time builds of a family of kernels side by side on a card.

    python3 tools/time_template_grams.py \\
        [--family template|mixed|selfcal|psd] [--model MODEL[,MODEL...]] \\
        [--time-only] [--same-bits] [SOURCE.cu[:NVCC FLAGS]] ...

``--family template`` (the default): versions of
``pycamset_tpu_torch/csrc/template_grams.cu`` (Kernels A and B);
``--family mixed``: versions of ``pycamset_tpu_torch/csrc/mixed_grams.cu``
(Kernels E and F; with ``--model``, together with ``mixed_models_e.cu``
and ``mixed_models_f.cu``); ``--family selfcal``: versions of whichever source
exports Kernels C and D (``pct_selfcal_gram{,_fused}``: the checkout's
``mixed_grams.cu``, an older ``selfcal_grams.cu``); ``--family psd``:
versions of ``pycamset_tpu_torch/csrc/psd_solve.cu`` (the SPD kernel and,
where a version exports it, its diagonal path alone,
``pct_psd_diag_tile``; a version without it is timed whole only). Each
argument is a
version (default: the checkout's own), optionally with extra nvcc flags
after a colon, for example
``old/mixed_grams.cu`` or ``csrc/mixed_grams.cu:-DSOME_SWITCH``; a version
of several sources joins them with ``+`` (``a.cu+b.cu``, one library). Every
version is compiled by its own nvcc, all at once, with the package's flags,
into its own library; the kernel wrappers are then pointed at each library
in turn. For each version and each shape of the family that ``chip_smoke.py``
drives, it holds the kernels against their float64 plain twins (linear and
huber loss, the smoke's tolerance), checks that a repeat launch gives the
same bits, and times each kernel's launch alone by its device time under
torch.profiler (``chip_smoke.kernel_ms``, 20 launches):

- template (16 x 100 and 64 x 400): A, and B at chunks of 1, 2, 4 and 8
  images;
- mixed (mixed 16 x 100, grouped 16 x 100, mixed 64 x 12): E at chunks of
  4, 8, 12 and 16 images, F at chunks of 2, 4, 8 and 16 blocks, each also
  split into its first pass and its reduction. ``--model`` takes the
  problems of that camera model's rig
  (``problems.{mixed,grouped}_problem(camera_model=...)``) and the kernels
  built at its width (``pct_mixed_gram{,_fused}_model``), or of each model
  of a comma-separated list, every shape named ``<shape> [<model>]``;
- selfcal (self-cal 16 x 100 and 64 x 12): C at chunks of 4 to 34 images,
  D at chunks of 2 to 12 blocks, each also split
  into its first pass and its reduction (the scratch sizes did not change
  with the redesign). ``--model`` (default ``standard``) takes the
  self-cal problems of that camera model's rig
  (``problems.selfcal_problem(camera_model=...)``) and the kernels built
  at its width (``pct_selfcal_gram{,_fused}_model``; a version without
  them cannot run another model);
- psd (no problem: synthetic systems): ``chip_smoke.psd_parity`` on
  ``PSD_SYNTHETIC`` and ``chip_smoke.diag_tile_parity`` instead of the gram
  checks; per width the kernel and the library call ``_cho_refine_solve``
  by device time, and the diagonal path alone at n = 1044.

With ``--same-bits`` (not for psd) each version's outputs on every
shape's inputs, under the linear and huber losses, are also held bit for
bit against the first version's (a change that must leave a kernel's
arithmetic as it was, such as a refactor of the shared headers): one
``[variant_bits]`` line per version and shape, and a failure exits
non-zero.

Prints the card's name and power limit first, the ptxas registers and
spills of each build, and one ``[variant_time]`` line per version and
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

# family -> (default source, its C entry points, the shapes it is timed at)
FAMILIES = {
    "template": ("template_grams.cu",
                 ("pct_template_gram", "pct_template_gram_fused"),
                 ("template 16x100", "template 64x400")),
    "mixed": ("mixed_grams.cu",
              ("pct_mixed_gram", "pct_mixed_gram_fused",
               "pct_mixed_gram_model", "pct_mixed_gram_fused_model"),
              ("mixed 16x100", "grouped 16x100", "mixed 64x12")),
    "selfcal": ("mixed_grams.cu",
                ("pct_selfcal_gram", "pct_selfcal_gram_fused",
                 "pct_selfcal_gram_model", "pct_selfcal_gram_fused_model"),
                ("selfcal 16x100", "selfcal 64x12")),
    "psd": ("psd_solve.cu", ("pct_psd_solve", "pct_psd_diag_tile"), ()),
}
# the psd family: the seven solves' widths (840 twice), the diagonal path's
# panel steps at n = 1044, and the condition of the timed systems
PSD_WIDTHS = (240, 840, 852, 960, 1032, 1044)
PSD_DIAG_K = (0, 14)
PSD_TIME_COND = 1e4


def build(nvcc: str, out: Path, i: int, spec: str):
    """Compile one version into ``out/v<i>.so``; returns it and the ptxas
    report."""
    from pycamset_tpu_torch import _build as bld
    src, _, flags = spec.partition(":")
    so = out / f"v{i}.so"
    proc = subprocess.run([nvcc, *bld.NVCC_FLAGS, *flags.split(), "-shared",
                           "-o", str(so), *src.split("+")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {spec}:\n{proc.stdout}\n"
                         f"{proc.stderr}")
    return so, proc.stderr


def build_all(specs: list[str]) -> list:
    """Compile every version at once, each by its own nvcc, into
    ``build/pycamset_tpu_torch/variants``; returns (library, ptxas report)
    per version."""
    from pycamset_tpu_torch import _build as bld
    nvcc = bld.find_nvcc()
    out = bld.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(specs)) as pool:
        return list(pool.map(lambda a: build(nvcc, out, *a),
                             enumerate(specs)))


def use_library(so: Path, entries) -> set:
    """Point the kernel wrappers at one version's library: they reach the
    kernels through ``_build.load().lib``. Returns the entries it has (an
    older version may lack one)."""
    from pycamset_tpu_torch import _build as bld
    lib = ctypes.CDLL(str(so))
    found = {name for name in entries if hasattr(lib, name)}
    for name in found:
        getattr(lib, name).argtypes = bld._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    bld.load = lambda: types.SimpleNamespace(lib=lib)
    return found


def problem(shape: str, dev, model: str = "standard"):
    from pycamset_tpu_torch import problems
    make = {"template": problems.standard_problem,
            "selfcal": problems.selfcal_problem,
            "mixed": problems.mixed_problem,
            "grouped": problems.grouped_problem}[shape.split()[0]]
    n_cams, n_ims = map(int, shape.split()[1].split("x"))
    if model != "standard":
        return make(n_cams, n_ims, dev, camera_model=model)
    return make(n_cams, n_ims, dev)


def checked(check, time_only: bool, shape: str):
    """Run a version's parity and bit checks; with ``time_only``, report a
    failure and go on to time the version all the same."""
    try:
        check()
    except SystemExit as e:
        if not time_only:
            raise
        print(f"  {shape}: {e} (timed all the same)", flush=True)


def pass_times(cs, line: dict, kernel: str, chunk: int, fn):
    """Into ``line``: the device time of each pass of one call of ``fn``
    (the first pass and the reduction) and their sum."""
    passes = cs.device_ms(fn)
    line[f"{kernel}_ms_chunk{chunk}"] = sum(passes.values())
    for name, ms in passes.items():
        pass_name = "reduce" if "reduce" in name else "first"
        line[f"{kernel}_{pass_name}_ms_chunk{chunk}"] = ms


def check(cs, parities, runs: dict, shape: str):
    """A family's kernels against their float64 twins (linear and huber
    loss; ``parities(**loss options)`` is one of ``chip_smoke``'s
    ``*_parities``), and the same bits on a repeat launch (``runs``, the
    matching ``*_runs``); raises SystemExit on a failure."""
    for loss in ("linear", "huber"):
        res = parities(loss=loss, f_scale=2.0)
        for name, (got, ref, scaled) in res.items():
            cs.parity(f"{name} {shape} {loss}", got, ref, scaled)
        del res
    for name, run in runs.items():
        cs.same_bits(name, run)


def time_template(cs, prob, shape, time_only):
    from pycamset_tpu_torch.optim import cuda_grams as cg
    f32 = cs.template_inputs(prob)
    n_cams, n_ims = prob.blocks.n_cams, prob.blocks.n_ims
    checked(lambda: check(
        cs, lambda **kw: cs.template_parities(cg, f32, n_cams, n_ims, **kw),
        cs.template_runs(cg, f32, n_cams, n_ims), shape), time_only, shape)
    packed = cg.pack_block_params(*f32[:2])
    line = {"A_ms": cs.kernel_ms(
        lambda: cg._launch_gram(packed, *f32[2:], 0, 1, 1.0))}
    chunk0 = cg.FUSED_CHUNK
    for chunk in (1, 2, 4, 8):
        cg.FUSED_CHUNK = chunk
        line[f"B_ms_chunk{chunk}"] = cs.kernel_ms(
            lambda: cg._launch_gram_fused(packed, *f32[2:], n_cams, n_ims, 0,
                                          1, 1.0))
    cg.FUSED_CHUNK = chunk0
    return line


def time_mixed(cs, prob, shape, time_only):
    import torch
    from pycamset_tpu_torch.optim import cuda_mixed_grams as mg
    f32 = cs.multi_target_inputs(prob)
    n_cams, n_ims = prob.blocks.n_cams, prob.blocks.n_ims
    wk = shape.startswith("mixed")
    iw = prob.widths.a - 6
    checked(lambda: check(
        cs, lambda **kw: cs.mixed_parities(mg, f32, n_cams, n_ims, wk, **kw),
        cs.mixed_runs(mg, f32, n_cams, n_ims, wk), shape), time_only, shape)
    packed = mg.pack_block_params(*f32[:2])
    kd = mg.pack_key_group_data(f32[2][:, :6],
                                f32[2][:, 6:9] if wk else f32[3])
    grid = f32[4:]
    line = {}
    chunks = mg.MIXED_CHUNK, mg.MIXED_CHUNK_F
    for kernel, chunk_list in (("E", (4, 8, 12, 16)), ("F", (2, 4, 8, 16))):
        for chunk in chunk_list:
            mg.MIXED_CHUNK = mg.MIXED_CHUNK_F = chunk
            fn = ((lambda: mg._launch_mixed_fused(packed, kd, *grid, n_cams,
                                                  n_ims, 0, 1, 1.0, iw))
                  if kernel == "E" else
                  (lambda: mg._launch_mixed(packed, kd, *grid, 0, 1, 1.0,
                                            iw)))
            pass_times(cs, line, kernel, chunk, fn)
    mg.MIXED_CHUNK, mg.MIXED_CHUNK_F = chunks
    torch.cuda.empty_cache()
    return line


def time_selfcal(cs, prob, shape, time_only):
    import torch
    from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
    f32 = cs.selfcal_inputs(prob)
    n_cams, n_ims = prob.blocks.n_cams, prob.blocks.n_ims
    checked(lambda: check(
        cs, lambda **kw: cs.selfcal_parities(sg, f32, n_cams, n_ims, **kw),
        cs.selfcal_runs(sg, f32, n_cams, n_ims), shape), time_only, shape)
    packed = sg.pack_block_params(*f32[:2])
    c_grid = (*f32[2:5], *f32[6:])
    iw = prob.widths.a - 6
    line = {}
    chunks = sg.SELFCAL_CHUNK, sg.SELFCAL_CHUNK_D
    for kernel, chunk_list in (("C", (4, 8, 10, 12, 14, 17, 20, 25, 34)),
                               ("D", (2, 3, 4, 5, 6, 7, 8, 12))):
        for chunk in chunk_list:
            sg.SELFCAL_CHUNK = sg.SELFCAL_CHUNK_D = chunk
            fn = ((lambda: sg._launch_selfcal_fused(packed, *c_grid, n_cams,
                                                    n_ims, 0, 1, 1.0, iw))
                  if kernel == "C" else
                  (lambda: sg._launch_selfcal(packed, *f32[2:], 0, 1, 1.0,
                                              iw)))
            pass_times(cs, line, kernel, chunk, fn)
    sg.SELFCAL_CHUNK, sg.SELFCAL_CHUNK_D = chunks
    torch.cuda.empty_cache()
    return line


def family_outputs(cs, family: str, prob, shape: str) -> dict:
    """The family's kernels on a shape's inputs (the smoke's), under the
    linear and huber losses: {kernel loss: its outputs on the host}."""
    from pycamset_tpu_torch.optim import cuda_grams as cg
    from pycamset_tpu_torch.optim import cuda_mixed_grams as mg
    from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
    n_cams, n_ims = prob.blocks.n_cams, prob.blocks.n_ims
    if family == "template":
        runs = cs.template_runs(cg, cs.template_inputs(prob), n_cams, n_ims)
    elif family == "selfcal":
        runs = cs.selfcal_runs(sg, cs.selfcal_inputs(prob), n_cams, n_ims)
    else:
        runs = cs.mixed_runs(mg, cs.multi_target_inputs(prob), n_cams, n_ims,
                             shape.startswith("mixed"))
    out = {}
    for loss in ("linear", "huber"):
        for name, run in runs.items():
            got = run(loss=loss, f_scale=2.0)
            got = got if isinstance(got, tuple) else (got,)
            out[f"{name} {loss}"] = tuple(t.cpu() for t in got)
    return out


def same_bits(cs, ref: dict, got: dict, spec: str, shape: str) -> bool:
    """Print whether every output of ``got`` equals ``ref``'s bit for
    bit."""
    import torch
    differ = [k for k in ref if not all(
        torch.equal(a, b) for a, b in zip(ref[k], got[k]))]
    cs.say("variant_bits", source=spec.replace(" ", "_"),
           shape=shape.replace(" ", "_"), same_bits=not differ,
           differ=",".join(d.replace(" ", "_") for d in differ) or "none")
    return not differ


def time_psd(cs, found: set, time_only: bool) -> dict:
    """One version of ``psd_solve.cu``: the smoke's parity and bit checks
    on ``PSD_SYNTHETIC`` (``psd_synthetic_parities``; the diagonal path's
    where the version has its entry); then, per width, the device time of
    ``psd_solve_raw`` and of the library call ``_cho_refine_solve`` on a
    synthetic system, and at n = 1044 that of ``psd_diag_tile`` for the
    panel steps ``PSD_DIAG_K``. (An entry that updates the buffer in place,
    as one built around an older kernel's own pieces may, is timed on the
    buffer it changes: the same instructions on other values.)
    {width: {name: ms}}."""
    import torch

    from pycamset_tpu_torch.ops import cuda_cholesky as cc
    from pycamset_tpu_torch.optim.structured import _cho_refine_solve
    dev = torch.device("cuda", 0)
    diag = "pct_psd_diag_tile" in found
    checked(lambda: list(cs.psd_synthetic_parities(dev, diag)), time_only,
            "psd")
    lines = {}
    for n in PSD_WIDTHS:
        a32, b32 = cs.psd_synthetic(n, PSD_TIME_COND, dev)
        line = {"kernel_ms": cs.kernel_ms(lambda: cc.psd_solve_raw(a32, b32)),
                "library_ms": cs.kernel_ms(
                    lambda: _cho_refine_solve(a32, b32))}
        if diag and n == max(PSD_WIDTHS):
            for k in PSD_DIAG_K:
                l = cc.psd_diag_tile_scratch(a32, k)
                line[f"diag_tile_k{k}_ms"] = cs.kernel_ms(
                    lambda: cc.psd_diag_tile(l, k))
        lines[f"n={n}"] = line
    return lines


def main() -> int:
    import torch

    import chip_smoke as cs
    from pycamset_tpu_torch import _build as bld

    args = sys.argv[1:]
    family = "template"
    if "--family" in args:
        i = args.index("--family")
        family = args[i + 1]
        del args[i:i + 2]
    if family not in FAMILIES:
        raise SystemExit(f"--family {family}: one of {tuple(FAMILIES)}")
    source, entries, shapes = FAMILIES[family]
    models = ["standard"]
    if "--model" in args:
        i = args.index("--model")
        models = args[i + 1].split(",")
        del args[i:i + 2]
        if family not in ("selfcal", "mixed"):
            raise SystemExit("--model: the selfcal and mixed families only")
    time_only = "--time-only" in args
    bits = "--same-bits" in args
    if bits and family == "psd":
        raise SystemExit("--same-bits: the gram families only")
    default = str(bld.CSRC / source)
    if family == "mixed" and models != ["standard"]:
        default = "+".join(str(bld.CSRC / f) for f in (
            source, "mixed_models_e.cu", "mixed_models_f.cu"))
    specs = [a for a in args if a not in ("--time-only", "--same-bits")] or [
        default]
    cs.phase_device()
    built = build_all(specs)

    dev = torch.device("cuda", 0)
    probs = {(shape if model == "standard" else f"{shape} [{model}]"):
             problem(shape, dev, model)
             for model in models for shape in shapes}
    timer = {"template": time_template, "mixed": time_mixed,
             "selfcal": time_selfcal}.get(family)
    first, all_same = {}, True
    for spec, (so, ptxas) in zip(specs, built):
        print(f"=== {spec}", flush=True)
        for ln in ptxas.splitlines():
            if any(w in ln for w in ("Compiling entry", "registers",
                                     "spill")):
                print(f"  ptxas: {ln.strip()}", flush=True)
        found = use_library(so, entries)
        if bits:
            for shape, prob in probs.items():
                outs = family_outputs(cs, family, prob, shape)
                if shape in first:
                    all_same &= same_bits(cs, first[shape], outs, spec,
                                          shape)
                else:
                    first[shape] = outs
                del outs
        lines = (time_psd(cs, found, time_only) if family == "psd" else
                 {shape: timer(cs, prob, shape, time_only)
                  for shape, prob in probs.items()})
        for shape, line in lines.items():
            cs.say("variant_time", source=spec.replace(" ", "_"),
                   shape=shape.replace(" ", "_"),
                   **{k: f"{v:.4f}" for k, v in line.items()})
    return 0 if all_same else 1


if __name__ == "__main__":
    sys.exit(main())
