#!/usr/bin/env python3
"""Kernels C and D beside their float32 plain twin, at the card tests'
noisy start, on a card.

    python3 tools/selfcal_f32_floor.py [--model MODEL] \
        [SOURCE.cu[:NVCC FLAGS]] ...

Each argument is a version of the source that exports Kernels C and D
(``pct_selfcal_gram{,_fused}``; default: the checkout's ``mixed_grams.cu``),
built as ``tools/time_template_grams.py`` builds one. For every case of
``tests/test_torch_cuda.py``'s ``SELFCAL_CASES`` at the noisy start (the
true start, 3 px of detection noise) and every loss, it prints one
``[f32_floor]`` line with the errors against the float64 plain twin of each
version's kernels and of the float32 plain twin on the CPU: gc's and gi's
error of their max-abs (C), the worst such error of C's other outputs and
of D's, and the worst error of C and of D in the solver's Jacobi scaling.
Then one ``[f32_floor_case]`` line per case with the worst of each over the
losses. A case whose kernels miss the tests' 1e-4 where the float32 twin
misses it too misses it by float32's rounding, not by the kernel. With
``--model`` (default ``standard``) every case is built on that camera
model's rig (``tests/test_torch_cuda.py::_selfcal_inputs``'s
``camera_model``) and the kernels run at its width.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

ENTRIES = ("pct_selfcal_gram", "pct_selfcal_gram_fused",
           "pct_selfcal_gram_model", "pct_selfcal_gram_fused_model")


def measures(cs, sg, d_got, c_got, refs, n_cams, n_ims) -> dict:
    """One side's errors: D's outputs ``d_got`` and C's ``c_got`` against
    the float64 twins' ``refs`` (D's outputs, C's, and the gram with every
    camera column unmasked that C's Jacobi scaling takes)."""
    d_ref, c_ref, gram = refs
    dev = gram.device
    d_got = tuple(t.to(dev) for t in d_got)
    c_got = tuple(t.to(dev) for t in c_got)
    c_rel = cs.max_abs_errors(c_got, c_ref)
    return {
        "C_gc": c_rel[1], "C_gi": c_rel[6],
        "C_other": max(c_rel[:1] + c_rel[2:6] + c_rel[7:]),
        "D": max(cs.max_abs_errors(d_got, d_ref)),
        "C_scaled": max(sg.scaled_errors_selfcal_fused(
            c_got, c_ref, gram, n_cams, n_ims).values()),
        "D_scaled": max(sg.scaled_errors_selfcal(d_got, d_ref).values())}


def main() -> int:
    import torch

    import chip_smoke as cs
    import test_torch_cuda as tc
    from pycamset_tpu_torch import _build as bld
    from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
    from time_template_grams import build_all, use_library

    args = sys.argv[1:]
    model = "standard"
    if "--model" in args:
        i = args.index("--model")
        model = args[i + 1]
        del args[i:i + 2]
    specs = args or [str(bld.CSRC / "mixed_grams.cu")]
    cs.phase_device()
    libs = [so for so, _ in build_all(specs)]
    for i, spec in enumerate(specs):
        cs.say("f32_floor_version", side=f"v{i}", source=spec)
    dev = torch.device("cuda", 0)
    for case in tc.SELFCAL_CASES:
        n_cams, n_ims, grid, n_keys, dark_cam, dark_key = case
        name = "-".join(map(str, case))
        f32 = tc._selfcal_inputs(dev, n_cams, n_ims, grid, "noisy",
                                 n_keys=n_keys, dark_cam=dark_cam,
                                 dark_key=dark_key, camera_model=model)
        f64 = tuple(t.double() for t in f32)
        cpu32 = tuple(t.cpu() for t in f32)
        worst, misses = {}, {}
        for loss, sem in tc.LOSS_CASES:
            kw = dict(loss=loss, f_scale=2.0, loss_semantics=sem)
            refs = (sg.selfcal_gram_plain(*f64, **kw),
                    sg.selfcal_gram_fused_plain(*f64[:5], *f64[6:], n_cams,
                                                n_ims, **kw),
                    sg.selfcal_gram_plain(*f64[:5], torch.ones_like(f64[5]),
                                          *f64[6:], **kw)[0])
            sides = {"f32_twin": (
                sg.selfcal_gram_plain(*cpu32, **kw),
                sg.selfcal_gram_fused_plain(*cpu32[:5], *cpu32[6:], n_cams,
                                            n_ims, **kw))}
            for i, so in enumerate(libs):
                use_library(so, ENTRIES)
                run = cs.selfcal_runs(sg, f32, n_cams, n_ims)
                sides[f"v{i}"] = (run["selfcal_gram"](**kw),
                                  run["selfcal_gram_fused"](**kw))
            for side, (d_got, c_got) in sides.items():
                m = measures(cs, sg, d_got, c_got, refs, n_cams, n_ims)
                cs.say("f32_floor", case=name, loss=loss, semantics=sem,
                       side=side, **{k: f"{v:.2e}" for k, v in m.items()})
                w = worst.setdefault(side, dict.fromkeys(m, 0.0))
                for k, v in m.items():
                    w[k] = max(w[k], v)
                misses[side] = misses.get(side, 0) + (max(m.values())
                                                      > cs.TOL)
        for side, w in worst.items():
            cs.say("f32_floor_case", case=name, side=side,
                   losses_over_tol=misses[side],
                   **{k: f"{v:.2e}" for k, v in w.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
