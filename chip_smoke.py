#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the kernels of ``pycamset_tpu_torch/csrc`` with nvcc and holds each
kernel against its plain PyTorch twin on the card, at both shapes of its
chain, for the four losses, and checks that a repeat launch gives the same
bits. Then it solves seven bundle adjustments, each through one kernel:

- template (``bench.py::standard_problem``) 16 cameras x 100 views through
  Kernel A (per-block gram) and 64 x 400 through Kernel B (fused);
- self-calibration (``bench.py::selfcal_problem``, free target points)
  16 x 100 through Kernel C (fused) and 64 x 12 through Kernel D
  (per-block);
- mixed multi-target self-calibration (``bench.py::mixed_problem``: free
  target points and a free relative pose for each of two targets) 16 x 100
  through Kernel E (fused, key width 9) and 64 x 12 through Kernel F
  (per-block, key width 9);
- grouped multi-target template (``problems.grouped_problem``, the mixed
  problem's rig with the points from the template) 16 x 100 through
  Kernel E at key width 6,

and checks each solve; the 16 x 100 solves also against the port's float64
solve on the CPU. Each LM step of a solve is one replay of a CUDA graph
(``optim/structured_lm.py::SLMGraph``, owned by the problem); the graph is
held bit for bit against the uncaptured step (``[graph]``), and
``[main_path]`` counts launches on the uncaptured step. The dense reduced
solve of every LM step goes through the
one-launch SPD kernel (``csrc/psd_solve.cu``) on the main path, opted in
with ``PYCAMSET_PALLAS_CHOL=1`` as in the JAX package; that kernel is held
against its float64 twin on the seven solves' own reduced systems and on
synthetic ones, and each solve runs with the opt-in off and on (an A/B
against the library route, ``cholesky_ex``); its diagonal path alone
(``psd_diag_tile``, one block) is held against float64 and timed at
n = 1044. The FP32 FMA probe
(``csrc/peak.cu``) measures the card's FP32 rate beside the published one.

Then the fleet (``bench.py::fleet_problem``: 64 rigs of 4 cameras x 16
images, one target, solved as one batch by ``optim/fleet.py``'s cascade):
``[fleet_kernel]`` holds Kernel B folded over the 64 rigs (one launch of
256 cameras, under ``torch.func.vmap``) against its float64 twin and each
rig's bits against a one-rig launch, times it beside 64 one-rig launches,
and checks Kernel A folded over a fleet of 12 images; ``[fleet]`` solves
the fleet uncaptured (launch counts), captured (one graph per cohort size,
bit-identical), against the port's float64 CPU fleet, and beside the same
rigs solved one by one.

Then the user path (``[user_path]``): at template 16 x 100 and 64 x 400, on
both dense-solve routes, a ``TemplateBundleHandler`` on the bench rig's
CameraSet and TargetDetection, seeded through ``set_initial_params`` at the
bench's start (the card's machine has no OpenCV for the PnP seed), its
problem (``build_structured_problem``: Kernel A at 16 x 100, whose 100
images pad to 104, Kernel B at 64 x 400) and ``run_stereo_calibration``;
its file written and loaded back on the library route of each shape and on
both routes at 16 x 100; each stage's host seconds.

Then the self-calibration after a template calibration
(``[selfcal_user_path]``): the bench rig with its board bent 0.5 mm RMS
along the normal, a template stage (Kernel A), then
``SelfBundleHandler.set_from_templated_camset`` and
``run_stereo_calibration``, at 16 x 100 (100 images bucket to 104: Kernel
C) on both dense-solve routes and 64 x 12 (``im_bucket: None``: Kernel D)
on the library one, each of the path's kernels first held against its
twin on the path's own tensors (``[parity_user_path]``); the recovered
points against the true bent board, the file loaded back. And the
pose-free free-point chain: ``[freepoint]``
holds the two free-point wrappers (Kernels D and C at identity poses,
``optim/cuda_selfcal_grams.py``) against their float64 twins at 16 x 24
(K = 9,216 free points) and 64 x 12 (K = 4,608) and times them beside the
free-point function's own bound, then solves
``problems.freepoint_handler`` (the wand's gauge) through
``run_bundle_adjustment`` on both routes: the fused wrapper over C at
16 x 24, the per-block one over D at 64 x 12 (``im_bucket: None``).

Then the other camera models on the template user path
(``[camera_models]``): for the rational (a = 18), thin-prism (22), tilted
(24) and fisheye (14) models, the rig ``utils/synthetic.py`` makes for
each, at 16 x 100 (Kernel A, the model's own instantiation) and 64 x 400
(Kernel B): the kernel against its float64 twin on the handler problem's
first evaluation, four losses, its device time beside its bound; the
handler's problem solved uncaptured, capturing and warm (captured =
uncaptured, the kernel once an evaluation by profiler names), status and
rms, the recovered lens against the truth over each camera's observed
field; ``run_stereo_calibration`` as the main path (its counts by camera
width), its file loaded back at 16 x 100; the float64 CPU solve beside
the fisheye 16 x 100 one and a tilted 4 x 100 one; and at tilted 64 x 400
(dense n = 1536) the opt-in SPD kernel route against the library route.

Then the self-calibration and free-point chains at the same four models
(``[selfcal_models]``): Kernels C and D and the two free-point wrappers
over them, each built at the model's width, against their float64 twins on
their problems' own tensors (C on the self-cal handler's 16 x 100 problem,
D on ``problems.selfcal_problem`` at 64 x 12, the fused wrapper on
``problems.freepoint_problem`` at 16 x 24, the per-block one on the
free-point handler's 64 x 12 problem), four losses, their device times
beside their bounds, registers, spills and peak MiB; the self-cal user
path at 16 x 100 (the board bent as in ``[selfcal_user_path]``: template
stage on A, then ``SelfBundleHandler`` with the model through
``run_stereo_calibration``, captured = uncaptured, C once an evaluation,
the file loaded back, the recovered points against the true board) and
the free-point user path at 64 x 12 (``run_bundle_adjustment`` over D's
wrapper), each with the model's kernel alone on its main path.

Then the multi-target chains at the same four models (``[mixed_models]``):
Kernels E and F, each built at the model's width and both key widths
(``csrc/mixed_models_e.cu``, ``mixed_models_f.cu``), against their float64
twins on their main paths' own tensors (E at mixed and grouped 16 x 100, F
at mixed and grouped 64 x 12; F at key width 6 also on grouped 16 x 100's),
four losses, with the per-group sums the solver builds from them, their
device times beside their bounds, registers, spills, the device's blocks an
SM and peak MiB; then
``problems.{mixed,grouped}_problem(..., camera_model=m)`` solved at mixed
16 x 100 (E), mixed 64 x 12 (F), grouped 16 x 100 (E, key width 6) and
grouped 64 x 12 (F, key width 6), each uncaptured as its main path (its
kernel alone, once an evaluation, at its widths) and captured (bit for
bit), status of the standard model's class, rms, group 1's recovered pose;
and at tilted mixed 64 x 12 (dense n = 1620) the SPD kernel route's
fallbacks beside the library route's residual misses.

Then the multi-target handlers (``[multi_target_handlers]``): the bench's
multi-target rig as two targets (the board's halves) through the port's
copies of the JAX package's ``TwoTargetSelfCalibrator`` (mixed 16 x 100:
Kernel E at key width 9; mixed 64 x 12 with ``im_bucket: None``: F) and
``TwoTargetCalibrator`` (grouped 16 x 100: E at key width 6), each through
``run_bundle_adjustment`` (its kernel alone, once an evaluation), its file
written and loaded back, its problem captured = uncaptured, status and
rms, its warm solve's ms an evaluation within 10% of the bench problem's
(``problems.{mixed,grouped}_problem``, timed beside it). Then the handler
fleets (``problems.fleet_handlers``: the bench fleet's 64 rigs of 4 x 16
at grid 10 as template, self-calibration, grouped and mixed handlers, and
the self-calibration and mixed ones at 12 images with ``im_bucket:
None``): ``[fleet_mixed_kernel]`` holds Kernels C, D, E and F (both key
widths) folded over the 64 rigs (one launch under ``torch.func.vmap``,
each rig reading its own per-key rows) against their float64 twins per
rig and each rig's bits against a one-rig launch, at the standard and the
tilted model, and times the folded launch beside 64 one-rig launches;
``[fleet_handlers]`` solves each fleet through
``run_fleet_bundle_adjustment`` (one launch of its kernel per evaluation
of the batch; captured = uncaptured; every rig at status 1-2 and rms <=
0.36 px; the first 4 rigs against the port's float64 CPU fleet; rigs/s;
rig 0's file loaded back). The same six fleets on the SPD kernel route
(``[fleet_handlers_psd]``: the kernel with a batch axis, one launch a batch
step, captured = uncaptured, fallbacks, rigs/s); the batched kernel on each
fleet's first reduced batch and the tied fleet's (``[parity_psd_batch]``:
against its float64 twin, within twice the float32 library route's error;
``[time_psd_batch]``: device ms beside the library batch, cuSOLVER's batched
``cholesky_ex`` and ``cholesky_solve``, and the bound).

Then the tied (shared-intrinsics) backend: ``[tied_fleet]`` solves
``fleet_problem``'s rigs with one lens a rig through
``run_fleet_bundle_adjustment`` on both routes (Kernel B folded once an
evaluation; the batched SPD kernel once a batch step), captured =
uncaptured, status, rms and identical lens rows at every rig, rigs/s;
``[tied_user_path]`` runs the bench rig with tied lenses at 16 x 100 (one
lens, saved through ``run_stereo_calibration``; two lens groups; the tilted
model) and 64 x 400 (``run_bundle_adjustment`` and ``get_camset``), on both
routes: its ``TiedProblem`` captured = uncaptured, Kernel A or B once an
evaluation, the SPD kernel once a step on the kernel route, status, rms,
identical group rows, at 16 x 100 the cost against the float64 CPU solve.

Then the mixed-model rigs, one camera model a camera: ``[brown_mix]``
(standard / rational / thin-prism in turn: the thin-prism chain at a = 22,
the narrower cameras' extra coefficients pinned by the column mask) saves
and reloads a 16 x 100 template calibration on Kernel A, self-calibrates
the same rig with its board bent on Kernel C, and solves 64 x 400 through
``run_bundle_adjustment`` on Kernel B, each kernel held to its float64
twin on its problem's tensors and timed, the pinned columns exact zeros;
``[het_rig]`` (fisheye / standard in turn, a = 16: the selector chain
``ProjectionHet``) does the 16 x 100 template and self-cal stages with no
gram kernel, on the plain closed form its chain takes. Both: captured =
uncaptured, status, rms, the warm ms an evaluation beside ``[user_path]``'s,
the float32 cost against the float64 CPU solve at 4 x 100.

Then the matrix-free CG reduced solver (``[cg_user_path]``): the rigs the
JAX rule ("auto": CG above 4096 reduced dimensions) sends to it, through
the user path with the default options: a 288-camera dome (4320 camera
dimensions, Kernel B) saved and loaded back, and a 16-camera, 720-view
sweep of a bent board (its template stage dense on Kernel B, its
self-calibration stage, 4560 dimensions, on Kernel C); per stage the CG
iterations of each LM step (a spy on the uncaptured solve), no dense
solve, captured = uncaptured, the device events a replay, the capture's
ms, the peak MiB, status, rms, and the same problem solved dense beside it
(ms an LM step, nit, rms). And the free-point (wand) fleet
(``[fleet_freepoint]``: ``problems.fleet_handlers("freepoint", 64, 4,
16)`` on Kernel C's wrapper folded over the 64 rigs, and 64 x 4 x 12 with
``im_bucket: None`` on Kernel D's): the folded wrapper against its float64
twin per rig and each rig's bits against its one-rig call, timed beside 64
one-rig launches; ``run_fleet_bundle_adjustment`` one launch a batch
evaluation, captured = uncaptured, status, rms, the float64 CPU fleet,
rigs/s beside the 64 rigs solved one by one.

Then the generic and scipy backends and calibration uncertainty, which
reach no kernel (the JAX package computes them in XLA and host scipy):
``[generic]`` first holds the card's float64 run of the path against the
CPU's at 3 x 8 (the generic solves, ``make_optimisation_function``'s CSR,
the sigmas), then solves the template user path 16 x 100 (the grouped
layout) and the bent board's self-calibration stage 16 x 100 (the scatter
layout) through ``run_bundle_adjustment(backend="generic")`` (no gram
kernel launched; layout, status, nit, ms an LM step by CUDA events, host
reads, peak MiB; the cost within 1e-4 of the structured solve's and of
the float64 generic solve's on the card), times
``make_optimisation_function``'s ``loss_fn`` and ``jac_fn`` at 16 x 100
(its CSR against the float64 one), and runs ``backend="scipy"`` on
``template_handler(16, 24, fixed_lenses=True)`` (status, rms, the cost
against the generic solve's); ``[uncertainty]`` gives
``calibration_uncertainty`` of the template, self-calibration and tied
(one lens) user paths at 16 x 100 and the free-point user path at 64 x 12
(the Schur route), and of the 16 x 100 CameraSet loaded back from its
``.camset`` (the in-memory sigmas bit for bit): route, free parameters,
sigma2, dof, the seconds of the card's evaluation and of the host's
covariance, peak MiB, and every sigma against the float64 run on the card
(1e-2 relative, or twice the float32 CPU twin's error where the twin
misses that, named).

Then the structured backend's forward-mode route, which reaches no kernel
(the JAX package's ``jacfwd`` route is XLA): ``[rs_user_path]`` calibrates
``problems.rs_handler(16, 100)``'s rolling-shutter capture through
``run_stereo_calibration(problem_options={"rolling_shutter": r})`` on both
dense-solve routes (the handler's problem captured = uncaptured, the SPD
kernel once an LM step on its route with its fallbacks, ms an LM step and
an evaluation, host reads, one evaluation's peak MiB; the entry as the main
path, saved and loaded back; status 1-2, rms <= 0.36 px, readouts within
0.05 and velocities within 0.02 of the truth; the float32 cost within 1e-4
of the card's float64 solve, which is tied to the CPU's at 3 x 8; the
global-shutter handler's rms on the same data); ``[het_multi_target]``
solves the grouped and mixed multi-target problems of a fisheye /
standard rig at 16 x 100 (``ProjectionHet``: no gram kernel; captured =
uncaptured, rms <= 0.36 px, ms an evaluation beside the uniform problem's
on Kernel E, float32 against float64); ``[auto_dispatch]`` reads the
backend ``run_bundle_adjustment(backend="auto")`` chooses for the
rolling-shutter chain, a chain with a block of the caller's own, and the
template, self-calibration, free-point, grouped and mixed chains.

Every phase prints one line; any failure raises, so the script exits
non-zero and prints no final line. The line before the last lists the
kernels as JSON; the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.

Imports neither jax nor pycamset_tpu. Needs one CUDA card and nvcc; exits
non-zero without one.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

# f32 sums of up to 2 x 1600 terms per entry, vs float64; held entry by entry
# in the solver's Jacobi scaling (scaled_errors*) and against each output's
# max-abs scale
TOL = 1e-4
# the four losses, both semantics
LOSS_CASES = (("linear", "component"), ("huber", "component"),
              ("cauchy", "observation"), ("soft_l1", "observation"))
PALLAS = "pycamset_tpu/optim/pallas_grams.py"
# kernel -> (source, the TPU kernel it replaces, its main-path problem)
KERNELS = {
    "template_gram": ("pycamset_tpu_torch/csrc/template_grams.cu",
                      f"{PALLAS}:425", "template 16x100"),
    "template_gram_fused": ("pycamset_tpu_torch/csrc/template_grams.cu",
                            f"{PALLAS}:583", "template 64x400"),
    "selfcal_gram_fused": ("pycamset_tpu_torch/csrc/mixed_grams.cu",
                           f"{PALLAS}:805", "selfcal 16x100"),
    "selfcal_gram": ("pycamset_tpu_torch/csrc/mixed_grams.cu",
                     f"{PALLAS}:1019", "selfcal 64x12"),
    "mixed_gram_fused": ("pycamset_tpu_torch/csrc/mixed_grams.cu",
                         f"{PALLAS}:1576", "mixed 16x100"),
    "mixed_gram": ("pycamset_tpu_torch/csrc/mixed_grams.cu",
                   f"{PALLAS}:1327", "mixed 64x12"),
}
# the free-point wrappers over C and D -> (the kernels' source, the TPU
# function it replaces, its main-path shape)
FREEPOINT_KERNELS = {
    "freepoint_gram_fused": ("pycamset_tpu_torch/csrc/mixed_grams.cu",
                             f"{PALLAS}:1147", "freepoint 16x24"),
    "freepoint_gram": ("pycamset_tpu_torch/csrc/mixed_grams.cu",
                       f"{PALLAS}:1113", "freepoint 64x12"),
}
# free-point shape -> (cameras, images, im_bucket); self-cal user path shape
# -> (cameras, images, problem options, routes); the board's bend (m RMS)
FREEPOINT = {"freepoint 16x24": (16, 24, 8), "freepoint 64x12": (64, 12, None)}
SELFCAL_USER = {"selfcal_user 16x100": (16, 100, {}, ("library", "kernel")),
                "selfcal_user 64x12": (64, 12, {"im_bucket": None},
                                       ("library",))}
# the free-point function's products per real detection at camera width
# a: the [Jc | r] gram's (a + 1)(a + 2) / 2 entries, wck 3a, hkk 6 and gk 3,
# over its two rows (760 at the standard model's a = 15)
def freepoint_flop_per_detection(a: int = 15) -> int:
    return ((a + 1) * (a + 2) // 2 + 3 * a + 6 + 3) * 4


BOARD_WARP = 5e-4
# [camera_models]: the template user path at the other camera models, each
# on the rig utils/synthetic.py makes for it -> its camera width a; the
# shapes (cameras, images) and the kernel each takes (the 16 x 100 grid's
# 104 images pad past 5%: A; 64 x 400: B)
MODEL_WIDTH = {"rational": 18, "thin_prism": 22, "tilted": 24, "fisheye": 14}
MODEL_SHAPES = {"16x100": (16, 100, "template_gram"),
                "64x400": (64, 400, "template_gram_fused")}
# the recovered lens against the truth over each camera's observed field:
# the distortion function (the rule of the JAX package's rational and
# fisheye tests), px, held for those two models (the thin-prism and tilted
# coefficients trade against the intrinsics on this rig: px apart where the
# rig's prediction is not); and, for every model, the whole
# recovered rig's prediction of each real detection (the true scene, no
# noise) against the true rig's, its RMS as a share of the noise: with
# 1.0 M to 15.6 M residuals and 0.8 k to 3.9 k free parameters the
# statistical floor is noise x sqrt(p / n), 0.016 to 0.032 of it
DIST_FIELD_PX = 0.5
DIST_FIELD_HELD = ("rational", "fisheye")
PREDICTION_RMS_OF_NOISE = 0.1
# main-path solve -> (the one kernel it must launch, its key width)
MAIN_PATH = {"template 16x100": ("template_gram", None),
             "template 64x400": ("template_gram_fused", None),
             "selfcal 16x100": ("selfcal_gram_fused", None),
             "selfcal 64x12": ("selfcal_gram", None),
             "mixed 16x100": ("mixed_gram_fused", 9),
             "mixed 64x12": ("mixed_gram", 9),
             "grouped 16x100": ("mixed_gram_fused", 6)}
PSD = ("psd_solve", "pycamset_tpu_torch/csrc/psd_solve.cu",
       "pycamset_tpu/ops/pallas_cholesky.py:143")
PSD_BATCH = ("psd_solve_batched", "pycamset_tpu_torch/csrc/psd_solve.cu",
             "pycamset_tpu/ops/pallas_cholesky.py:143 (under jax.vmap)")
# the batched kernel's bound on each fleet system's relative error to the
# float64 twin: its float64 refinement reads 3-4e-8 there; a float32 solve
# without it reads 5e-4 to 1e-3 (the library route's factor)
PSD_BATCH_TOL = 1e-6
PEAK = ("fma_peak", "pycamset_tpu_torch/csrc/peak.cu", "benchmarks/peak.py:37")
# bench.py::fleet_problem's shape (fleet64x4x16): rigs, cameras, images; and
# the same fleet at 12 images, where the fused rule declines Kernel B
FLEET = (64, 4, 16)
FLEET_A = (64, 4, 12)
B_OUTPUTS = ("hcc", "gc", "wci", "gii", "gi", "corner")
# synthetic normalised systems for the SPD kernel: (n, condition, the JAX
# kernel test's bound on the relative error at that condition)
PSD_SYNTHETIC = [(n, cond, tol) for n in (240, 852, 1044)
                 for cond, tol in ((1e2, 1e-4), (1e4, 1e-3), (1e6, 2e-2))]
# the diagonal path alone at n = 1044: the first update, a late full tile
# and the padded last tile (20 rows)
DIAG_TILE_K = (0, 14, 15)
# the hand-written kernels of the solve, by the base name of their device
# events (template arguments stripped)
SOLVE_KERNELS = ("gram_kernel", "cam_reduce_kernel", "mixed_kernel",
                 "mixed_reduce_kernel", "psd_solve_kernel",
                 "psd_batched_kernel")
# H100 SXM data sheet: HBM rate and FP32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# products per real detection: the W (W + 1) / 2 gram entries over its two
# rows (W = a + 7: 253 at the standard model's a = 15); self-cal adds wck
# (3a), wik (18), hkk (6) and gk (3), the multi-target kernels wcc (a cw),
# wic (6 cw), hkk (cw (cw + 1) / 2) and gk (cw). 2 FLOP per product pair
# term (multiply-add), row arithmetic not counted.
def gram_entries(a: int) -> int:
    return (a + 7) * (a + 8) // 2


def flop_per_detection(name: str, cw: int | None = None, a: int = 15) -> int:
    if name.startswith("mixed"):
        return (gram_entries(a) + (a + 6) * cw + cw * (cw + 1) // 2
                + cw) * 4
    if name.startswith("selfcal"):
        return (gram_entries(a) + 3 * a + 27) * 4
    return gram_entries(a) * 4


def say(tag: str, **fields):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def wrappers():
    """The eight kernel wrappers, whose ``launches`` count the kernels (the
    multi-target ones also per key width, ``launches_by_cw``; the two
    free-point wrappers count their launches of Kernels C and D, not in the
    self-cal wrappers' counts)."""
    from pycamset_tpu_torch.optim import cuda_grams as cg
    from pycamset_tpu_torch.optim import cuda_mixed_grams as mg
    from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
    return {"template_gram": cg.template_gram,
            "template_gram_fused": cg.template_gram_fused,
            "selfcal_gram_fused": sg.selfcal_gram_fused,
            "selfcal_gram": sg.selfcal_gram,
            "mixed_gram_fused": mg.mixed_gram_fused,
            "mixed_gram": mg.mixed_gram,
            "freepoint_gram_fused": sg.freepoint_gram_fused,
            "freepoint_gram": sg.freepoint_gram}


def zero_counts(counted):
    for fn in counted.values():
        fn.launches = 0
        for by in ("launches_by_cw", "launches_by_width"):
            for key in getattr(fn, by, {}):
                getattr(fn, by)[key] = 0


def cuda_ms(fn, n: int, warmup: int = 2) -> float:
    """Mean device time of fn over n calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def kernel_name(name: str) -> str:
    """A device event's name without its namespace, return type and
    parameter list (template arguments kept)."""
    name = name.replace("(anonymous namespace)::", "")
    return name.removeprefix("void ").split("(")[0].replace(" ", "")


# the pauses (s) before each torch.profiler session of one measurement: on
# the card a session now and then records no device event at all, the
# sessions taken right after it often none either, and once in a while
# every session of one measurement (tools/profiler_probe.py, PERF.md)
PROFILE_PAUSES_S = (0.0, 1.0, 3.0, 10.0, 30.0)
# every session taken, those that recorded no device event, and the
# device times taken by CUDA events because no session recorded one
PROFILER = {"sessions": 0, "empty": 0, "cuda_event_fallbacks": 0}
# device_ms's one entry when it timed fn by CUDA events
CUDA_EVENTS = "(every kernel, by CUDA events)"


def profiled(fn, n: int = 1, pauses=PROFILE_PAUSES_S):
    """(each device event of n calls of fn under torch.profiler as (name,
    µs), the last call's result). A session that records no device event
    at all is taken again, fn with it, after the next pause (so a caller
    that counts fn's side effects resets them inside fn); no events when
    every session is empty."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for tries, pause in enumerate(pauses, 1):
        time.sleep(pause)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                out = fn()
            torch.cuda.synchronize()
        PROFILER["sessions"] += 1
        events = [(kernel_name(ev.name), ev.time_range.elapsed_us())
                  for ev in prof.events() if ev.device_type == DeviceType.CUDA]
        if events:
            return events, out
        PROFILER["empty"] += 1
        say("profiler_empty", session=PROFILER["sessions"], tries=tries,
            fn=getattr(fn, "__qualname__", "?"))
    return [], out


def recorded(fn):
    """``profiled(fn)``, failing when no session recorded a device event."""
    events, out = profiled(fn)
    check(bool(events), f"torch.profiler recorded no device event in "
                        f"{len(PROFILE_PAUSES_S)} sessions")
    return events, out


def device_ms(fn, n: int = 20) -> dict:
    """Mean device time (ms) per call of each kernel that fn launches, over
    n calls under torch.profiler. Timing a launch by CUDA events measures
    the host instead once the host takes longer to issue a call (a wrapper's
    allocations and ctypes call) than the card takes to run it: so only
    when three sessions record nothing, as {CUDA_EVENTS: ms a call}."""
    import torch
    fn()
    torch.cuda.synchronize()
    events, _ = profiled(fn, n, (0.0, 0.5, 2.0))
    if not events:
        PROFILER["cuda_event_fallbacks"] += 1
        ms = cuda_ms(fn, n)
        say("profiler_fallback", timed_by="cuda_events", ms=f"{ms:.4f}")
        return {CUDA_EVENTS: ms}
    us, count = {}, {}
    for name, t in events:
        us[name] = us.get(name, 0.0) + t
        count[name] = count.get(name, 0) + 1
    # each kernel's mean over the events recorded, times its launches a
    # call: a trace that drops events does not shrink the time
    return {name: us[name] / count[name] / 1e3 * max(1, round(count[name] / n))
            for name in us}


def kernel_ms(fn) -> float:
    """Device time (ms) of one call of fn, all its kernels."""
    return sum(device_ms(fn).values())


def gram_io(name: str, prob, cw: int | None = None,
            rigs: int = 1) -> tuple[int, int]:
    """The floats one call of a gram kernel must read (each input once) and
    write (each output once) on a problem's inputs, as ``bound`` counts
    them."""
    from pycamset_tpu_torch.optim.cuda_grams import packed_width
    bb, k = prob.mask.shape
    kr = k * rigs               # every rig's per-key rows
    c = prob.blocks.n_cams
    a = prob.widths.a
    ppb, w = packed_width(a - 6), a + 7
    pose = 6 * a + 36 + 6 + 1               # wci, gii, gi, the cost corner
    ins = bb * ppb + k * 3 + bb * k * 3     # packed, points, uv, mask
    if name.startswith("mixed"):
        # packed, per-key group data (48 rows), uv, mask, cmask, imask,
        # kmask; the per-key outputs hkk and gk
        ins = bb * ppb + kr * 48 + bb * k * 3 + bb * (a + 6) + kr * cw
        outs = kr * cw * (cw + 1)
        if name == "mixed_gram":
            outs += bb * w * w + bb * k * (a + 6) * cw
        else:
            outs += (c * (a * a + a + a * cw * k) + bb * k * 6 * cw
                     + bb * pose)
    elif name == "template_gram":
        outs = bb * w * w
    elif name == "template_gram_fused":
        outs = c * (a * a + a) + bb * pose
    elif name == "selfcal_gram":
        ins += bb * (a + 6) + kr * 3 + (kr - k) * 3  # masks, rigs' points
        outs = bb * w * w + bb * k * (3 * a + 18) + kr * 12
    else:
        ins += bb * 6 + kr * 3 + (kr - k) * 3   # imask, kmask, rigs' points
        outs = (c * (a * a + a + 3 * a * k) + bb * k * 18 + bb * pose
                + kr * 12)
    return ins, outs


def bound(name: str, prob, cw: int | None = None,
          rigs: int = 1) -> tuple[float, str]:
    """The least time the card could take for one call of a kernel on a
    problem's inputs: the larger of its bytes (each input read once, each
    output written once, ``gram_io``) over the HBM rate and its products
    over the FP32 rate, counted for the problem's real detections. ``cw``:
    the key width of a multi-target kernel. The camera width a is the
    problem's (15 at the standard model; the packed row PPB and the gram
    width W = a + 7 follow it). ``rigs``: a launch folded over that many
    rigs, whose blocks and cameras ``prob`` counts (its mask (R*B, K)):
    every rig reads and writes its own per-key rows (C-F; A and B share
    one point table)."""
    t_bytes = 4 * sum(gram_io(name, prob, cw, rigs)) / HBM_BYTES_PER_S
    a = prob.widths.a
    t_ops = (prob.blocks.n_real * flop_per_detection(name, cw, a)
             / FP32_FLOP_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def template_inputs(prob):
    """The per-block tensors of a template problem's first evaluation."""
    import torch
    n_cams, n_ims = prob.blocks.n_cams, prob.blocks.n_ims
    cam_b = torch.repeat_interleave(prob.x0.cam, n_ims, dim=0)
    im_b = prob.x0.im.repeat(n_cams, 1)
    return cam_b, im_b, prob.tpl, prob.uv, prob.mask


def _mover(seed: int):
    """moved(x, scale, colmask): x plus rng(seed) normal steps of ``scale``
    on its free (colmask 1) entries, drawn in call order."""
    import torch
    rng = np.random.default_rng(seed)

    def moved(x, scale, colmask):
        step = rng.normal(size=tuple(x.shape)) * scale
        return x + torch.as_tensor(step, dtype=x.dtype,
                                   device=x.device) * colmask

    return moved


def cam_scale(a: int) -> np.ndarray:
    """The bench's perturbation scales of one camera row at camera width
    a (``problems.perturbed_start``'s: 1e-4 for each coefficient past the
    standard model's), the extrinsics' 1e-2 last."""
    return np.array(([10.0, 5, 10, 5, 1e-2, 1e-3, 1e-4, 1e-4, 1e-4]
                     + [1e-4] * 9)[:a - 6] + [1e-2] * 6)


def selfcal_inputs(prob, seed: int = 1):
    """The per-block tensors of a self-cal problem at a perturbed start:
    cameras and poses moved by the bench's template perturbation (its scale
    vector, ``rng(seed)``), the free points by 1 mm, the fixed coordinates
    left alone; one camera column fixed beside the problem's own masks.
    At the true start the residuals are only the 0.3 px noise, and the
    gradients are sums that cancel to float32's rounding floor.

    :return: (cam_b, im_b, keyp, uv, mask, cmask_b, imask_b, kmask) on the
        problem's device and dtype.
    """
    import torch
    n_cams, n_ims = prob.blocks.n_cams, prob.blocks.n_ims
    moved = _mover(seed)
    cam = moved(prob.x0.cam, cam_scale(prob.widths.a), prob.colmask.cam)
    im = moved(prob.x0.im, 1e-2, prob.colmask.im)
    key = moved(prob.x0.key, 1e-3, prob.colmask.key)
    cmask = prob.colmask.cam.clone()
    cmask[:, 3] = 0.0
    return (torch.repeat_interleave(cam, n_ims, dim=0),
            im.repeat(n_cams, 1), key, prob.uv, prob.mask,
            torch.repeat_interleave(cmask, n_ims, dim=0),
            prob.colmask.im.repeat(n_cams, 1), prob.colmask.key)


def multi_target_inputs(prob, seed: int = 1):
    """The per-block tensors of a mixed or grouped problem at a perturbed
    start: cameras and poses moved as ``selfcal_inputs`` moves them, the free
    group pose by 1e-2 and the free points by 1 mm, the fixed entries left
    alone; the group poses expanded per key; one camera column fixed beside
    the problem's own masks.

    :return: (cam_b, im_b, keyp, tpl, uv, mask, cmask_b, imask_b, kmask).
    """
    import torch
    n_cams, n_ims = prob.blocks.n_cams, prob.blocks.n_ims
    moved = _mover(seed)
    x, cm = prob.x0, prob.colmask
    cam = moved(x.cam, cam_scale(prob.widths.a), cm.cam)
    im = moved(x.im, 1e-2, cm.im)
    if hasattr(x, "grp"):       # mixed: free points and group poses
        x = x._replace(cam=cam, im=im, key=moved(x.key, 1e-3, cm.key),
                       grp=moved(x.grp, 1e-2, cm.grp))
    else:                       # grouped: the group poses are its key piece
        x = x._replace(cam=cam, im=im, key=moved(x.key, 1e-2, cm.key))
    keyp, kmask = prob.key_operands(x, cm)
    cmask = cm.cam.clone()
    cmask[:, 3] = 0.0
    return (torch.repeat_interleave(cam, n_ims, dim=0), im.repeat(n_cams, 1),
            keyp, prob.tpl, prob.uv, prob.mask,
            torch.repeat_interleave(cmask, n_ims, dim=0),
            cm.im.repeat(n_cams, 1), kmask)


def max_abs_errors(got, ref) -> list[float]:
    """Each output's worst error against its own max-abs scale."""
    return [float((g.double().to(r.device) - r.double()).abs().max())
            / (float(r.double().abs().max()) + 1e-30)
            for g, r in zip(got, ref)]


def parity(name, got, ref, scaled: dict) -> dict:
    """Check one kernel's outputs against its float64 twin's: finite, and
    every entry within TOL in the solver's Jacobi scaling (``scaled``, per
    output) and of its output's max-abs scale."""
    worst_abs = 0.0
    for g, r in zip(got, ref):
        check(bool(g.isfinite().all()), f"{name} output is not finite")
        worst_abs = max(worst_abs, float((g.double() - r.double()).abs()
                                         .max()))
    rel = max_abs_errors(got, ref)
    worst_scaled = max(scaled.values())
    check(worst_scaled <= TOL and max(rel) <= TOL,
          f"{name} vs its plain twin: scaled {scaled}, of max-abs "
          f"{[f'{e:.3e}' for e in rel]}")
    return {"abs": worst_abs, "rel": max(rel), "scaled": worst_scaled}


def same_bits(name, run):
    """Two launches on the same inputs give the same bits."""
    import torch
    first, again = run(), run()
    first = first if isinstance(first, tuple) else (first,)
    again = again if isinstance(again, tuple) else (again,)
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          f"{name}: a repeat launch changed the bits")


def template_runs(cg, f32, n_cams, n_ims) -> dict:
    """Kernels A and B on ``f32``: {name: launch(**loss options)}."""
    return {"template_gram": lambda **kw: cg.template_gram(*f32, **kw),
            "template_gram_fused": lambda **kw: cg.template_gram_fused(
                *f32, n_cams, n_ims, **kw)}


def template_parities(cg, f32, n_cams, n_ims, **kw) -> dict:
    """Kernels A and B on ``f32`` under one loss, beside their float64
    plain twins: {name: (outputs, the twin's, errors in the solver's Jacobi
    scaling)}."""
    run = template_runs(cg, f32, n_cams, n_ims)
    f64 = tuple(t.double() for t in f32)
    a_got = run["template_gram"](**kw)
    a_ref = cg.template_gram_plain(*f64, **kw)
    b_got = run["template_gram_fused"](**kw)
    b_ref = cg.template_gram_fused_plain(*f64, n_cams, n_ims, **kw)
    return {"template_gram": ([a_got], [a_ref],
                              cg.scaled_errors(a_got, a_ref)),
            "template_gram_fused": (b_got, b_ref, cg.scaled_errors_fused(
                b_got, b_ref, a_ref, n_cams, n_ims))}


def selfcal_runs(sg, f32, n_cams, n_ims) -> dict:
    """Kernels D and C on ``f32`` (C takes no cmask): {name: launch(**loss
    options)}."""
    c32 = (*f32[:5], *f32[6:])
    return {"selfcal_gram": lambda **kw: sg.selfcal_gram(*f32, **kw),
            "selfcal_gram_fused": lambda **kw: sg.selfcal_gram_fused(
                *c32, n_cams, n_ims, **kw)}


def selfcal_parities(sg, f32, n_cams, n_ims, **kw) -> dict:
    """Kernels D and C on ``f32`` under one loss, beside their float64
    plain twins: {name: (outputs, the twin's, errors in the solver's Jacobi
    scaling)}. C's scaling takes the twin's gram with every camera column
    unmasked, as C's outputs are."""
    import torch
    run = selfcal_runs(sg, f32, n_cams, n_ims)
    f64 = tuple(t.double() for t in f32)
    d_got = run["selfcal_gram"](**kw)
    d_ref = sg.selfcal_gram_plain(*f64, **kw)
    c_got = run["selfcal_gram_fused"](**kw)
    c_ref = sg.selfcal_gram_fused_plain(*f64[:5], *f64[6:], n_cams, n_ims,
                                        **kw)
    gram = sg.selfcal_gram_plain(*f64[:5], torch.ones_like(f64[5]),
                                 *f64[6:], **kw)[0]
    return {"selfcal_gram": (d_got, d_ref,
                             sg.scaled_errors_selfcal(d_got, d_ref)),
            "selfcal_gram_fused": (c_got, c_ref,
                                   sg.scaled_errors_selfcal_fused(
                                       c_got, c_ref, gram, n_cams, n_ims))}


def mixed_runs(mg, f32, n_cams, n_ims, wk: bool) -> dict:
    """Kernels F and E on ``f32`` (key width 9 with ``wk``, else 6):
    {name: launch(**loss options)}."""
    return {"mixed_gram": lambda **kw: mg.mixed_gram(
                *f32, with_key_cols=wk, **kw),
            "mixed_gram_fused": lambda **kw: mg.mixed_gram_fused(
                *f32, n_cams, n_ims, with_key_cols=wk, **kw)}


def mixed_parities(mg, f32, n_cams, n_ims, wk: bool, **kw) -> dict:
    """Kernels F and E on ``f32`` under one loss, beside their float64
    plain twins: {name: (outputs, the twin's, errors in the solver's Jacobi
    scaling)}."""
    run = mixed_runs(mg, f32, n_cams, n_ims, wk)
    f64 = tuple(t.double() for t in f32)
    f_got = run["mixed_gram"](**kw)
    f_ref = mg.mixed_gram_plain(*f64, with_key_cols=wk, **kw)
    e_got = run["mixed_gram_fused"](**kw)
    e_ref = mg.mixed_gram_fused_plain(*f64, n_cams, n_ims, with_key_cols=wk,
                                      **kw)
    return {"mixed_gram": (f_got, f_ref,
                           mg.scaled_errors_mixed(f_got, f_ref)),
            "mixed_gram_fused": (e_got, e_ref, mg.scaled_errors_mixed_fused(
                e_got, e_ref, f_ref[0], n_cams, n_ims))}


def record(out, name, shape, e):
    rec = out[name].setdefault(shape, dict.fromkeys(e, 0.0))
    for k, v in e.items():
        rec[k] = max(rec[k], v)


def bmm_ms(prob, width: int, n: int) -> float:
    """For reference: torch.bmm of a prebuilt (B, 2K, width) extended
    Jacobian with itself, the gram alone (no residual, no Jacobian)."""
    import torch
    bb, k = prob.mask.shape
    ext = torch.randn(bb, 2 * k, width, device=prob.mask.device)
    ext_t = ext.transpose(1, 2)
    return cuda_ms(lambda: torch.bmm(ext_t, ext), n)


def phase_device():
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from pycamset_tpu_torch._build import find_nvcc
    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    say("device", name=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=repr(nvcc[-1]))
    return smi


def ptxas_resources(ptxas_info: str) -> dict:
    """Registers and spill bytes (stores + loads) of each compiled entry,
    by mangled name, from nvcc's -Xptxas -v report."""
    out, entry = {}, None
    for ln in ptxas_info.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
            out[entry] = {"registers": None, "spill_bytes": 0}
        elif entry and "spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            out[entry]["spill_bytes"] = nums[1] + nums[2]
        elif entry and "registers" in ln:
            out[entry]["registers"] = int(ln.split("Used")[1].split()[0])
    return out


def phase_build():
    from pycamset_tpu_torch._build import load
    t0 = time.perf_counter()
    kl = load()
    say("build", seconds=f"{kl.build_seconds:.2f}",
        load_seconds=f"{time.perf_counter() - t0:.2f}", lib=kl.path.name,
        **{f"nvcc_s:{src}": f"{sec:.2f}"
           for src, sec in kl.source_seconds.items()})
    for ln in kl.ptxas_info.splitlines():
        if any(w in ln for w in ("Compiling entry", "registers", "spill")):
            print(f"  ptxas: {ln.strip()}", flush=True)
    # each gram kernel's first pass, at most 128 registers (four blocks of
    # 128 threads an SM) and no spills: Kernels A and B at the standard
    # model, template_grams.cu's gram_kernel<9, FUSED>; C-F,
    # mixed_grams.cu's mixed_kernel<9, CW, FUSED> (C/D at key width 3, E/F
    # at 9 and 6)
    res = ptxas_resources(kl.ptxas_info)
    firsts = [(name, None, f"gram_kernelILi9ELb{flag}E")
              for name, flag in (("A", 0), ("B", 1))]
    firsts += [(name, cw, f"mixed_kernelILi9ELi{cw}ELb{fused}E")
               for name, fused, widths in (("C", 1, (3,)), ("D", 0, (3,)),
                                           ("E", 1, (9, 6)),
                                           ("F", 0, (9, 6)))
               for cw in widths]
    from pycamset_tpu_torch.optim.cuda_mixed_grams import (
        first_pass_occupancy)
    for name, cw, entry in firsts:
        regs, spill = ptxas_entry(res, entry, cw is None)
        # C-F: the device's blocks an SM (E holds three of the four its
        # launch bounds ask: its 65 KB of shared memory)
        occ = ({} if cw is None else {
            k: v for k, v in first_pass_occupancy(
                15, cw, name in ("C", "E")).items()
            if k in ("blocks_per_sm", "launch_bound_blocks")})
        say("build", kernel=name, **({} if cw is None else {"cw": cw}),
            registers=regs, spill_bytes=spill, **occ)
        check(regs <= 128 and spill == 0,
              f"Kernel {name}: {regs} registers, {spill} spill bytes")
    # Kernels A and B at the other camera models: the fisheye's at four
    # blocks an SM (<= 128 registers), the wider models' at three (<= 168,
    # template_grams.cu's Occupancy); spills reported
    out = {}
    for model, a in MODEL_WIDTH.items():
        for name, flag in (("A", 0), ("B", 1)):
            regs, spill = ptxas_entry(
                res, f"gram_kernelILi{a - 6}ELb{flag}E", True)
            cap = 128 if a <= 15 else 168
            say("build", kernel=name, model=model, a=a, registers=regs,
                spill_bytes=spill, register_cap=cap)
            check(regs <= cap, f"Kernel {name} ({model}): {regs} registers "
                               f"above {cap}")
            out[("template_gram_fused" if flag else "template_gram",
                 model)] = {"registers": regs, "spill_bytes": spill}
    # Kernels C-F's first passes mixed_kernel<intr_w, cw, FUSED> at the
    # other camera models: C and D at key width 3, E and F at 9 and 6. The
    # device's own account of each (cuda_mixed_grams.first_pass_occupancy:
    # blocks an SM at its dynamic shared memory, registers, local bytes);
    # registers within the cap of the blocks an SM its launch bounds ask
    # for (mixed_kernels.cuh's Occupancy: the register target, four blocks
    # at a <= 15 and three above, no more than the shared memory admits),
    # the device holding at least those blocks (a register cap for blocks
    # that cannot be resident caps registers for nothing), ptxas's
    # registers the runtime's; spills reported
    for model, a in MODEL_WIDTH.items():
        for name, flag, cw in (("C", 1, 3), ("D", 0, 3), ("E", 1, 9),
                               ("E", 1, 6), ("F", 0, 9), ("F", 0, 6)):
            regs, spill = ptxas_entry(
                res, f"mixed_kernelILi{a - 6}ELi{cw}ELb{flag}E", False)
            occ = first_pass_occupancy(a, cw, bool(flag))
            asked = occ["launch_bound_blocks"]
            cap = min(255, 65536 // (128 * asked) // 8 * 8)
            say("build", kernel=name, model=model, a=a,
                **({} if cw == 3 else {"cw": cw}), registers=regs,
                spill_bytes=spill, register_cap=cap,
                launch_bound_blocks=asked,
                blocks_per_sm=occ["blocks_per_sm"],
                dynamic_smem_kib=f"{occ['dynamic_smem_bytes'] / 1024:.1f}",
                static_smem_bytes=occ["static_smem_bytes"],
                runtime_registers=occ["registers"],
                local_bytes=occ["local_bytes"])
            check(regs <= cap, f"Kernel {name} ({model}, cw {cw}): {regs} "
                               f"registers above {cap}")
            check(occ["blocks_per_sm"] >= asked
                  and occ["registers"] == regs,
                  f"Kernel {name} ({model}, cw {cw}): the device holds "
                  f"{occ['blocks_per_sm']} blocks an SM at "
                  f"{occ['registers']} registers, its launch bounds ask "
                  f"{asked} at ptxas's {regs}")
            wrapper = {"C": "selfcal_gram_fused", "D": "selfcal_gram",
                       "E": "mixed_gram_fused", "F": "mixed_gram"}[name]
            out[(wrapper, model) if cw == 3 else (wrapper, model, cw)] = {
                "registers": regs, "spill_bytes": spill,
                "blocks_per_sm": occ["blocks_per_sm"],
                "dynamic_smem_bytes": occ["dynamic_smem_bytes"]}
    return out


def ptxas_entry(res: dict, entry: str, template_file: bool):
    """(registers, spill bytes) of the one compiled entry whose mangled
    name holds ``entry`` (of template_grams.cu, or else of
    mixed_grams.cu)."""
    hit = [r for e, r in res.items()
           if entry in e and (("template_grams" in e) == template_file)]
    check(len(hit) == 1, f"ptxas reports {len(hit)} entries {entry}")
    return hit[0]["registers"], hit[0]["spill_bytes"]


def phase_template_kernels(probs, out, peak_tflops: float):
    """Kernels A and B vs their float64 plain twins at both template
    shapes, all four losses, and a repeat launch; times per shape, and
    each kernel's rate counted as its bound counts, beside the bound and
    the FMA probe's measured rate (``peak_tflops``)."""
    from pycamset_tpu_torch.optim import cuda_grams as cg
    for shape in ("template 16x100", "template 64x400"):
        prob = probs[shape]
        n_cams, n_ims = prob.blocks.n_cams, prob.blocks.n_ims
        f32 = template_inputs(prob)
        for loss, sem in LOSS_CASES:
            res = template_parities(cg, f32, n_cams, n_ims, loss=loss,
                                    f_scale=2.0, loss_semantics=sem)
            say("parity", shape=shape, loss=loss, semantics=sem, tol=TOL,
                **{f"{ab}_{k}": f"{v:.2e}"
                   for ab, (_, _, scaled) in zip("AB", res.values())
                   for k, v in scaled.items()})
            for name, (got, ref, scaled) in res.items():
                record(out, name, shape, parity(
                    f"{name} {shape} {loss}/{sem}", got, ref, scaled))
            del res
        for name, run in template_runs(cg, f32, n_cams, n_ims).items():
            same_bits(name, run)

        # times (linear loss; same inputs for both sides); *_kernel: the
        # device time of the launch alone on pre-packed parameters
        n_rep = 20 if shape.endswith("16x100") else 5
        packed = cg.pack_block_params(*f32[:2])
        t = {
            "template_gram_kernel": kernel_ms(
                lambda: cg._launch_gram(packed, *f32[2:], 0, 1, 1.0)),
            "template_gram_fused_kernel": kernel_ms(
                lambda: cg._launch_gram_fused(packed, *f32[2:], n_cams,
                                              n_ims, 0, 1, 1.0)),
            "template_gram": cuda_ms(lambda: cg.template_gram(*f32), n_rep),
            "template_gram_plain": cuda_ms(
                lambda: cg.template_gram_plain(*f32), n_rep),
            "template_gram_fused": cuda_ms(
                lambda: cg.template_gram_fused(*f32, n_cams, n_ims), n_rep),
            "template_gram_fused_plain": cuda_ms(
                lambda: cg.template_gram_fused_plain(*f32, n_cams, n_ims),
                n_rep),
            "pack_block_params": cuda_ms(
                lambda: cg.pack_block_params(*f32[:2]), n_rep),
            "bmm_22": bmm_ms(prob, 22, n_rep),
        }
        say("time", shape=shape, unit="ms",
            **{k: f"{v:.4f}" for k, v in t.items()})
        flop = prob.blocks.n_real * flop_per_detection("template")
        for name in ("template_gram", "template_gram_fused"):
            out[name][shape].update(
                ms=t[name], kernel_ms=t[name + "_kernel"],
                plain_ms=t[name + "_plain"], bmm_ms=t["bmm_22"])
            gflops = flop / (t[name + "_kernel"] * 1e6)
            say("time", shape=shape, kernel=name, gflop=f"{flop / 1e9:.4f}",
                gflops=f"{gflops:.1f}",
                of_bound=f"{bound(name, prob)[0] / t[name + '_kernel']:.4f}",
                of_fma_probe=f"{gflops / (peak_tflops * 1e3):.4f}")


def phase_selfcal_kernels(probs, out, peak_tflops: float):
    """Kernels C and D vs their float64 plain twins at both self-cal
    shapes, all four losses, and a repeat launch; times per shape, and
    each kernel's rate counted as its bound counts, beside the bound and
    the FMA probe's measured rate (``peak_tflops``)."""
    from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
    for shape in ("selfcal 16x100", "selfcal 64x12"):
        prob = probs[shape]
        n_cams, n_ims = prob.blocks.n_cams, prob.blocks.n_ims
        f32 = selfcal_inputs(prob)
        c32 = (*f32[:5], *f32[6:])          # Kernel C takes no cmask
        cpu32 = tuple(t.cpu() for t in f32)
        for loss, sem in LOSS_CASES:
            kw = dict(loss=loss, f_scale=2.0, loss_semantics=sem)
            res = selfcal_parities(sg, f32, n_cams, n_ims, **kw)
            d_got, d_ref, d_scaled = res["selfcal_gram"]
            c_got, c_ref, c_scaled = res["selfcal_gram_fused"]
            # the float32 twin on the CPU, same inputs: the f32 floor of the
            # per-(block, key) couplings, whose entries (one slot's product
            # each, which nothing averages) carry the f32 error of the
            # slot's IRLS weight under a robust loss
            floor = max_abs_errors(sg.selfcal_gram_plain(*cpu32, **kw)[1:3],
                                   [r.cpu() for r in d_ref[1:3]])
            d_rel = max_abs_errors(d_got, d_ref)
            c_rel = max_abs_errors(c_got, c_ref)
            say("parity", shape=shape, loss=loss, semantics=sem, tol=TOL,
                **{f"C_{k}": f"{v:.2e}" for k, v in c_scaled.items()},
                **{f"D_{k}": f"{v:.2e}" for k, v in d_scaled.items()})
            say("parity_max_abs", shape=shape, loss=loss, semantics=sem,
                tol=TOL, D_wck_b=f"{d_rel[1]:.2e}", D_wik_b=f"{d_rel[2]:.2e}",
                C_wik=f"{c_rel[3]:.2e}", cpu_f32_twin_wck_b=f"{floor[0]:.2e}",
                cpu_f32_twin_wik_b=f"{floor[1]:.2e}",
                D_worst_other=f"{max(d_rel[:1] + d_rel[3:]):.2e}",
                C_worst_other=f"{max(c_rel[:3] + c_rel[4:]):.2e}")
            for name, (got, ref, scaled) in res.items():
                record(out, name, shape, parity(
                    f"{name} {shape} {loss}/{sem}", got, ref, scaled))
            del res, d_got, d_ref, c_got, c_ref
        for name, run in selfcal_runs(sg, f32, n_cams, n_ims).items():
            same_bits(name, run)

        # each pass's device time (the first pass, the reduction)
        packed = sg.pack_block_params(*f32[:2])
        passes = {
            "selfcal_gram": device_ms(
                lambda: sg._launch_selfcal(packed, *f32[2:], 0, 1, 1.0)),
            "selfcal_gram_fused": device_ms(
                lambda: sg._launch_selfcal_fused(packed, *c32[2:], n_cams,
                                                 n_ims, 0, 1, 1.0))}
        say("time_passes", shape=shape, unit="ms",
            **{f"{name}:{kernel}": f"{ms:.4f}"
               for name, by_kernel in passes.items()
               for kernel, ms in by_kernel.items()})
        t = {
            "selfcal_gram_kernel": sum(passes["selfcal_gram"].values()),
            "selfcal_gram_fused_kernel": sum(
                passes["selfcal_gram_fused"].values()),
            "selfcal_gram": cuda_ms(lambda: sg.selfcal_gram(*f32), 20),
            "selfcal_gram_plain": cuda_ms(
                lambda: sg.selfcal_gram_plain(*f32), 10),
            "selfcal_gram_fused": cuda_ms(
                lambda: sg.selfcal_gram_fused(*c32, n_cams, n_ims), 20),
            "selfcal_gram_fused_plain": cuda_ms(
                lambda: sg.selfcal_gram_fused_plain(*c32, n_cams, n_ims),
                10),
            "bmm_25": bmm_ms(prob, 25, 20),
        }
        say("time", shape=shape, unit="ms",
            **{k: f"{v:.4f}" for k, v in t.items()})
        flop = prob.blocks.n_real * flop_per_detection("selfcal")
        for name in ("selfcal_gram", "selfcal_gram_fused"):
            out[name][shape].update(
                ms=t[name], kernel_ms=t[name + "_kernel"],
                plain_ms=t[name + "_plain"], bmm_ms=t["bmm_25"])
            k_ms = t[name + "_kernel"]
            gflops = flop / (k_ms * 1e6)
            say("time", shape=shape, kernel=name, gflop=f"{flop / 1e9:.4f}",
                gflops=f"{gflops:.1f}",
                of_bound=f"{bound(name, prob)[0] / k_ms:.4f}",
                of_fma_probe=f"{gflops / (peak_tflops * 1e3):.4f}")


def phase_mixed_kernels(probs, out, peak_tflops: float):
    """Kernels E and F vs their float64 plain twins at the three
    multi-target shapes (key width 9 for the mixed chain, 6 for the grouped
    one), all four losses, with the per-group pieces the solver sums from
    them, and a repeat launch; times per shape, and each kernel's rate
    counted as its bound counts, beside the bound and the FMA probe's
    measured rate (``peak_tflops``)."""
    import torch
    from pycamset_tpu_torch.optim import cuda_mixed_grams as mg
    for shape in ("mixed 16x100", "grouped 16x100", "mixed 64x12"):
        prob = probs[shape]
        n_cams, n_ims = prob.blocks.n_cams, prob.blocks.n_ims
        wk = shape.startswith("mixed")
        cw = mg.key_width(wk)
        oh = prob.onehot(prob.uv)
        f32 = multi_target_inputs(prob)
        for loss, sem in LOSS_CASES:
            res = mixed_parities(mg, f32, n_cams, n_ims, wk, loss=loss,
                                 f_scale=2.0, loss_semantics=sem)
            f_got, f_ref, f_scaled = res["mixed_gram"]
            e_got, e_ref, e_scaled = res["mixed_gram_fused"]
            f_grp = mg.scaled_errors_groups(f_got, f_ref, oh, n_cams, n_ims)
            e_grp = mg.scaled_errors_groups(e_got, e_ref, oh, n_cams, n_ims)
            f_rel = max_abs_errors(f_got, f_ref)
            e_rel = max_abs_errors(e_got, e_ref)
            say("parity", shape=shape, cw=cw, loss=loss, semantics=sem,
                tol=TOL, **{f"E_{k}": f"{v:.2e}" for k, v in e_scaled.items()},
                **{f"F_{k}": f"{v:.2e}" for k, v in f_scaled.items()})
            say("parity_groups", shape=shape, cw=cw, loss=loss,
                semantics=sem, tol=TOL,
                **{f"E_{k}": f"{v:.2e}" for k, v in e_grp.items()},
                **{f"F_{k}": f"{v:.2e}" for k, v in f_grp.items()})
            say("parity_max_abs", shape=shape, cw=cw, loss=loss,
                semantics=sem, tol=TOL,
                **{f"E_{k}": f"{v:.2e}" for k, v in zip(
                    ("hcc", "gc", "wcc", "wic", "wci", "gii", "gi", "corner",
                     "hkk", "gk"), e_rel)},
                **{f"F_{k}": f"{v:.2e}" for k, v in zip(
                    ("gram", "wcc_b", "wic_b", "hkk", "gk"), f_rel)})
            record(out, "mixed_gram", shape, parity(
                f"mixed_gram {shape} {loss}/{sem}", f_got, f_ref,
                {**f_scaled, **f_grp}))
            record(out, "mixed_gram_fused", shape, parity(
                f"mixed_gram_fused {shape} {loss}/{sem}", e_got, e_ref,
                {**e_scaled, **e_grp}))
            del res, f_got, f_ref, e_got, e_ref
        for name, run in mixed_runs(mg, f32, n_cams, n_ims, wk).items():
            same_bits(name, run)

        # times (linear loss); *_kernel: the device time of the launch
        # alone on pre-packed block parameters and per-key group data
        packed = mg.pack_block_params(*f32[:2])
        keyp, tpl = f32[2], f32[3]
        kd = mg.pack_key_group_data(keyp[:, :6],
                                    keyp[:, 6:9] if wk else tpl)
        grid = f32[4:]
        t = {
            "mixed_gram_kernel": kernel_ms(
                lambda: mg._launch_mixed(packed, kd, *grid, 0, 1, 1.0)),
            "mixed_gram_fused_kernel": kernel_ms(
                lambda: mg._launch_mixed_fused(packed, kd, *grid, n_cams,
                                               n_ims, 0, 1, 1.0)),
            "mixed_gram": cuda_ms(lambda: mg.mixed_gram(*f32, wk), 20),
            "mixed_gram_plain": cuda_ms(
                lambda: mg.mixed_gram_plain(*f32, wk), 10),
            "mixed_gram_fused": cuda_ms(
                lambda: mg.mixed_gram_fused(*f32, n_cams, n_ims, wk), 20),
            "mixed_gram_fused_plain": cuda_ms(
                lambda: mg.mixed_gram_fused_plain(*f32, n_cams, n_ims, wk),
                10),
            "pack_key_group_data": cuda_ms(
                lambda: mg.pack_key_group_data(keyp[:, :6], tpl), 20),
            f"bmm_{22 + cw}": bmm_ms(prob, 22 + cw, 20),
        }
        say("time", shape=shape, cw=cw, unit="ms",
            **{k: f"{v:.4f}" for k, v in t.items()})
        flop = prob.blocks.n_real * flop_per_detection("mixed", cw)
        for name in ("mixed_gram", "mixed_gram_fused"):
            out[name][shape].update(
                ms=t[name], kernel_ms=t[name + "_kernel"],
                plain_ms=t[name + "_plain"], bmm_ms=t[f"bmm_{22 + cw}"])
            k_ms = t[name + "_kernel"]
            gflops = flop / (k_ms * 1e6)
            say("time", shape=shape, cw=cw, kernel=name,
                gflop=f"{flop / 1e9:.4f}", gflops=f"{gflops:.1f}",
                of_bound=f"{bound(name, prob, cw)[0] / k_ms:.4f}",
                of_fma_probe=f"{gflops / (peak_tflops * 1e3):.4f}")
        torch.cuda.empty_cache()


@contextlib.contextmanager
def one_launch_psd(on: bool):
    """The JAX package's opt-in PYCAMSET_PALLAS_CHOL=1 set (on) or unset."""
    old = os.environ.pop("PYCAMSET_PALLAS_CHOL", None)
    if on:
        os.environ["PYCAMSET_PALLAS_CHOL"] = "1"
    try:
        yield
    finally:
        os.environ.pop("PYCAMSET_PALLAS_CHOL", None)
        if old is not None:
            os.environ["PYCAMSET_PALLAS_CHOL"] = old


def psd_bound(n: int, batch: int = 1) -> tuple[float, str]:
    """Least time of ``batch`` SPD solves of width n: each factor's n^3/3
    and the three solves' and residuals' 12 n^2 multiply-adds (2 FLOP each;
    the factor's n^3/3 = 2n^3/3 FLOP) over the FP32 rate, against each a
    read once and b, x, res2, b2 moved once over the HBM rate."""
    t_ops = batch * (2 * n ** 3 / 3 + 12 * n ** 2) / FP32_FLOP_PER_S
    t_bytes = 4 * batch * (n * n + 2 * n + 2) / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_peak(smi: str) -> dict:
    """The FP32 FMA probe at the JAX probe's size beside the published
    rate, and held against its float64 twin at a small size."""
    import torch
    from pycamset_tpu_torch import peak
    dev = torch.device("cuda", 0)
    small = torch.as_tensor(np.random.default_rng(0).uniform(
        0.5, 1.0, (64, 128)), dtype=torch.float32, device=dev)
    got = peak.fma_chain(small)
    ref = peak.fma_chain_plain(small.double())
    err = float((got.double() - ref).abs().max())
    rel = err / float(ref.abs().max())
    tol = peak.ITERS * 4 * 2.0 ** -24       # 4096 dependent f32 operations
    check(rel <= tol, f"fma_chain vs its float64 twin: {rel:.3e} > {tol:.3e}")
    same_bits("fma_chain", lambda: peak.fma_chain(small))
    m = peak.measure_fp32_peak(dev)
    big = torch.as_tensor(np.random.default_rng(0).uniform(
        0.5, 1.0, (peak.ROWS, peak.LANES)), dtype=torch.float32, device=dev)
    plain_ms = cuda_ms(lambda: peak.fma_chain_plain(big), 1, warmup=1)
    bound_ms = max(m["gflop"] * 1e9 / FP32_FLOP_PER_S,
                   8 * big.numel() / HBM_BYTES_PER_S) * 1e3
    say("peak", card=repr(smi), fp32_fma_tflops=f"{m['tflops']:.3f}",
        published_tflops=f"{FP32_FLOP_PER_S / 1e12:.0f}",
        ms=f"{m['ms']:.4f}", gflop=f"{m['gflop']:.1f}",
        plain_ms=f"{plain_ms:.2f}", rel_err=f"{rel:.2e}", tol=f"{tol:.2e}")
    return {"abs": err, "ms": m["ms"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "tflops": m["tflops"]}


@contextlib.contextmanager
def dense_solve_spy():
    """Record each call of the opt-in dense solve (``structured.psd_solve``,
    which ``_psd_solve`` looks up at call time), one per LM step: yields a
    list that fills with (a_n, rhs_n, the fallback's x or None), the
    system cloned on the device."""
    from pycamset_tpu_torch.optim import structured
    calls, orig = [], structured.psd_solve

    def spy(a_n, rhs_n, *, fallback, **kw):
        taken = []

        def recorded(a, b):
            taken.append(fallback(a, b))
            return taken[-1]

        x = orig(a_n, rhs_n, fallback=recorded, **kw)
        calls.append((a_n.clone(), rhs_n.clone(), taken[0] if taken else None))
        return x

    structured.psd_solve = spy
    try:
        yield calls
    finally:
        structured.psd_solve = orig


@contextlib.contextmanager
def library_solve_spy():
    """Hold each dense solve of the library route (``structured.
    _cho_refine_solve``, which ``_psd_solve`` looks up at call time) to the
    residual rule the kernel route falls back on: yields a list that fills
    with one device bool a call, true where the library's x meets
    ``residual_ok`` in float64 and is finite. The solve's x is returned
    untouched (same bits); the checks queue on the device and are read
    after the solve."""
    import torch
    from pycamset_tpu_torch.ops import cuda_cholesky as cc
    from pycamset_tpu_torch.optim import structured
    passed, orig = [], structured._cho_refine_solve

    def spy(a_n, rhs_n):
        x = orig(a_n, rhs_n)
        b64 = rhs_n.double()
        r = b64 - a_n.double() @ x.double()
        passed.append(cc.residual_ok(r @ r, b64 @ b64)
                      & torch.isfinite(x).all())
        return x

    structured._cho_refine_solve = spy
    try:
        yield passed
    finally:
        structured._cho_refine_solve = orig


def capture_reduced_systems(probs) -> dict:
    """The normalised (a_n, rhs_n) each solve hands the dense solve on its
    first LM step (opt-in on: psd_solve's arguments)."""
    systems = {}
    for shape, prob in probs.items():
        with dense_solve_spy() as calls, one_launch_psd(True):
            prob.solve(max_nfev=2, graph=False)
        check(bool(calls), f"the {shape} solve reached no psd_solve")
        systems[shape] = calls[0][:2]
    return systems


def fallback_evidence(a_n, rhs_n, x_lib) -> dict:
    """Why the dense solve fell back on (a_n, rhs_n): whether the library
    route's x meets the same residual rule (and is finite), the info of the
    float32 and of the float64 Cholesky factor of the same float32 matrix
    (0: it factors; k > 0: its leading minor of order k is not positive
    definite), and the matrix's smallest eigenvalue in float64."""
    import torch
    from pycamset_tpu_torch.ops import cuda_cholesky as cc
    a64, b64 = a_n.double(), rhs_n.double()
    r = b64 - a64 @ x_lib.double()
    return {"library_passes": bool(cc.residual_ok(r @ r, b64 @ b64)
                                   & torch.isfinite(x_lib).all()),
            "cholesky_info_f32": int(torch.linalg.cholesky_ex(a_n).info),
            "cholesky_info_f64": int(torch.linalg.cholesky_ex(a64).info),
            "eigenvalue_min_f64": float(torch.linalg.eigvalsh(a64)[0])}


def psd_synthetic(n: int, cond: float, dev):
    """A synthetic normalised system of width n and the given condition
    (rng(n)), as float32 (a_n, rhs_n) on dev."""
    import torch
    rng = np.random.default_rng(n)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    a = (q * np.logspace(0, -np.log10(cond), n)) @ q.T
    d = np.sqrt(np.diag(a))
    a_n = (a / d[:, None] / d[None, :]
           + 10 * np.finfo(np.float32).eps * np.eye(n))
    return (torch.as_tensor(a_n, dtype=torch.float32, device=dev),
            torch.as_tensor(rng.normal(size=n), dtype=torch.float32,
                            device=dev))


def diag_tile_parity(name, a32, k: int) -> float:
    """The SPD kernel's diagonal path alone (``psd_diag_tile``) on tile
    k + 1 of a32's factor buffer before that panel step, against its float64
    twin on the same float32 buffer: the inverse within TOL of its max-abs,
    exact zeros above the diagonal, the same bits on a repeat launch (each
    launch on its own copy of the buffer). Returns the error."""
    import torch
    from pycamset_tpu_torch.ops import cuda_cholesky as cc
    l = cc.psd_diag_tile_scratch(a32, k)
    ref = cc.psd_diag_tile_plain(l.double(), k)
    got = cc.psd_diag_tile(l.clone(), k)
    err = max_abs_errors([got], [ref])[0]
    check(bool(torch.isfinite(got).all()), f"psd_diag_tile {name}: not finite")
    check(err <= TOL, f"psd_diag_tile {name} k={k}: {err:.3e} > {TOL}")
    check(not bool(torch.triu(got, 1).any()),
          f"psd_diag_tile {name} k={k}: nonzero above the diagonal")
    same_bits(f"psd_diag_tile {name} k={k}",
              lambda: cc.psd_diag_tile(l.clone(), k))
    return err


def psd_parity(name, a32, b32, tol=1e-5) -> dict:
    """The kernel and the f32 library route on one system against the
    float64 twin: relative errors of x, res2/b2, and repeat-launch bits.
    The kernel's error may not exceed twice the library route's, or
    ``tol`` where that is larger."""
    import torch
    from pycamset_tpu_torch.ops import cuda_cholesky as cc
    from pycamset_tpu_torch.optim.structured import _cho_refine_solve
    x, res2, b2 = cc.psd_solve_raw(a32, b32)
    x64 = cc.psd_solve_raw_plain(a32.double(), b32.double())[0]
    lib = _cho_refine_solve(a32, b32)
    norm = float(torch.linalg.norm(x64))
    rel = float(torch.linalg.norm(x.double() - x64)) / norm
    rel_lib = float(torch.linalg.norm(lib.double() - x64)) / norm
    ratio = float(res2) / float(b2)
    same_bits(f"psd_solve {name}", lambda: cc.psd_solve_raw(a32, b32))
    check(bool(torch.isfinite(x).all()), f"psd_solve {name}: x not finite")
    limit = max(2 * rel_lib, tol)
    check(rel <= limit, f"psd_solve {name}: rel err {rel:.3e} > {limit:.3e}"
                        f" (library route {rel_lib:.3e})")
    return {"abs": float((x.double() - x64).abs().max()), "rel": rel,
            "rel_lib": rel_lib, "res2_over_b2": ratio}


def psd_synthetic_parities(dev, diag_tile: bool = True):
    """``psd_parity`` on each ``PSD_SYNTHETIC`` system and, with
    ``diag_tile``, ``diag_tile_parity`` at ``DIAG_TILE_K`` on the widest
    ones up to condition 1e4; yields (n, cond, tol, the solve's errors,
    {k: the inverse's error} or None)."""
    widest = max(n for n, _, _ in PSD_SYNTHETIC)
    for n, cond, tol in PSD_SYNTHETIC:
        a32, b32 = psd_synthetic(n, cond, dev)
        e = psd_parity(f"n={n} cond={cond:.0e}", a32, b32, tol)
        diag = ({k: diag_tile_parity(f"n={n} cond={cond:.0e}", a32, k)
                 for k in DIAG_TILE_K}
                if diag_tile and n == widest and cond <= 1e4 else None)
        yield n, cond, tol, e, diag


def phase_parity_psd(systems) -> dict:
    """The SPD kernel vs its float64 twin on the seven solves' first
    reduced systems (relative error <= 2x the f32 library route's, or
    1e-5; res2/b2 <= 1e-8) and on synthetic normalised systems."""
    import torch
    out = {}
    for shape, (a_n, rhs_n) in systems.items():
        e = psd_parity(shape, a_n, rhs_n)
        check(e["res2_over_b2"] <= 1e-8,
              f"psd_solve {shape}: res2/b2 {e['res2_over_b2']:.3e} > 1e-8")
        say("parity_psd", shape=shape.replace(" ", "_"), n=a_n.shape[0],
            rel_err=f"{e['rel']:.3e}", library_rel_err=f"{e['rel_lib']:.3e}",
            res2_over_b2=f"{e['res2_over_b2']:.3e}", same_bits=True)
        out[shape] = e
    for n, cond, tol, e, diag in psd_synthetic_parities(
            torch.device("cuda", 0)):
        say("parity_psd", synthetic=f"n={n}", cond=f"{cond:.0e}",
            rel_err=f"{e['rel']:.3e}", library_rel_err=f"{e['rel_lib']:.3e}",
            res2_over_b2=f"{e['res2_over_b2']:.3e}", tol=f"{tol:.0e}",
            same_bits=True)
        if diag:
            say("parity_psd", diag_tile=f"n={n}", cond=f"{cond:.0e}",
                tol=TOL, same_bits=True,
                **{f"minv_err_k{k}": f"{e:.3e}" for k, e in diag.items()})
    return out


def phase_time_psd(systems) -> dict:
    """The SPD kernel alone at each width, with the residual check and its
    host read (psd_solve with a fallback), its plain twin, and the library
    call (_cho_refine_solve: cholesky_ex + 3 cholesky_solve + 2 products),
    on the solves' own reduced systems."""
    from pycamset_tpu_torch.ops import cuda_cholesky as cc
    from pycamset_tpu_torch.optim.structured import _cho_refine_solve
    out = {}
    for shape, (a_n, rhs_n) in systems.items():
        n = a_n.shape[0]
        if n in out:
            continue
        t = {"ms": cuda_ms(lambda: cc.psd_solve_raw(a_n, rhs_n), 50),
             "kernel_ms": kernel_ms(lambda: cc.psd_solve_raw(a_n, rhs_n)),
             "checked_ms": cuda_ms(lambda: cc.psd_solve(
                 a_n, rhs_n, fallback=_cho_refine_solve), 50),
             "plain_ms": cuda_ms(lambda: cc.psd_solve_raw_plain(a_n, rhs_n),
                                 2, warmup=1),
             "library_ms": cuda_ms(lambda: _cho_refine_solve(a_n, rhs_n),
                                   50),
             "library_kernel_ms": kernel_ms(
                 lambda: _cho_refine_solve(a_n, rhs_n))}
        t["bound_ms"], t["bound_by"] = psd_bound(n)
        t["shape"] = shape
        say("time", kernel="psd_solve", n=n, shape=shape.replace(" ", "_"),
            unit="ms", **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                          for k, v in t.items() if k != "shape"})
        out[n] = t
    # the diagonal path alone (one block), on the widest system's factor
    # buffer before the panel step
    a_n = systems[max(systems, key=lambda s: systems[s][0].shape[0])][0]
    n = a_n.shape[0]
    diag = {}
    for k in DIAG_TILE_K[:2]:
        l = cc.psd_diag_tile_scratch(a_n, k)
        diag[k] = kernel_ms(lambda: cc.psd_diag_tile(l, k))
    say("time_passes", kernel="psd_diag_tile", n=n, unit="ms",
        **{f"k{k}": f"{ms:.4f}" for k, ms in diag.items()})
    out[n]["diag_tile_ms"] = diag
    return out


def phase_main_path(probs):
    """The main path, opted in to the one-launch SPD solve, uncaptured
    (``graph=False``: the wrappers count launches on the host, which a
    graph's replays do not pass through): each solve once,
    with every launch count set to 0 just before it; each must launch its
    own gram kernel, at its own key width, and no other, and the SPD kernel
    once per LM step. A fallback is allowed only on a system that the
    library route fails too (its own solution misses the same residual
    rule, or is not finite); each one prints its evidence
    (``fallback_evidence``) on a ``[main_path_fallback]`` line.

    :return: launches[kernel][shape] per solve."""
    import torch
    from pycamset_tpu_torch.ops import cuda_cholesky as cc
    counted = wrappers()
    launches = {name: {} for name in (*KERNELS, PSD[0])}
    for shape, prob in probs.items():
        zero_counts(counted)
        cc.psd_solve_raw.launches = 0
        cc.psd_solve.fallbacks = 0
        with dense_solve_spy() as calls, one_launch_psd(True):
            res = prob.solve(graph=False)
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in counted.items()}
        by_cw = {f"launches_{name}_cw{cw}": n
                 for name, fn in counted.items()
                 for cw, n in getattr(fn, "launches_by_cw", {}).items()}
        n_psd, nit = cc.psd_solve_raw.launches, res.nit
        n_fell = cc.psd_solve.fallbacks
        evidence = [dict(lm_step=step, **fallback_evidence(a, b, x))
                    for step, (a, b, x) in enumerate(calls) if x is not None]
        say("main_path", shape=shape.replace(" ", "_"),
            **{f"launches_{k}": v for k, v in counts.items()}, **by_cw,
            launches_psd_solve=n_psd, lm_steps=nit, psd_fallbacks=n_fell,
            fallbacks_library_passes=sum(e["library_passes"]
                                         for e in evidence))
        for e in evidence:
            say("main_path_fallback", shape=shape.replace(" ", "_"),
                **{k: (f"{v:.6e}" if isinstance(v, float) else v)
                   for k, v in e.items()})
        own, cw = MAIN_PATH[shape]
        for name, n in counts.items():
            if name == own:
                check(n > 0, f"the {shape} solve did not launch {name}")
                launches[name][shape] = n
            else:
                check(n == 0, f"the {shape} solve launched {name}")
        if cw is not None:
            check(counted[own].launches_by_cw[cw] == counts[own],
                  f"the {shape} solve launched {own} at another key width")
        check(n_psd == nit, f"the {shape} solve launched psd_solve {n_psd} "
                            f"times in {nit} LM steps")
        check(len(calls) == n_psd and len(evidence) == n_fell,
              f"the {shape} solve: {len(calls)} dense solves and "
              f"{len(evidence)} fallbacks seen, {n_psd} and {n_fell} counted")
        check(not any(e["library_passes"] for e in evidence),
              f"the {shape} solve fell back on a system that the library "
              f"route solves within the residual rule")
        launches[PSD[0]][shape] = n_psd
    return launches


def solve_kernel_counts(fn):
    """(launches of each hand-written kernel of the solve in one call of fn,
    by the names of its device events under torch.profiler; fn's result)."""
    events, out = recorded(fn)
    count = {}
    for name, _ in events:
        if name.split("<")[0] in SOLVE_KERNELS:
            count[name] = count.get(name, 0) + 1
    return count, out


def mib_allocated() -> float:
    """Device memory allocated now (MiB), with the peak counter reset."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 2 ** 20


def same_solve(a, b) -> bool:
    """Two SLMResults bit for bit: x, cost, history, nit, nfev, status."""
    import torch
    return ((a.nit, a.nfev, int(a.status)) == (b.nit, b.nfev, int(b.status))
            and torch.equal(a.cost, b.cost)
            and torch.equal(a.history, b.history)
            and all(torch.equal(p, q) for p, q in zip(a.x, b.x)))


def phase_graph(probs) -> dict:
    """The LM step as one CUDA graph (``optim.problem.BAProblem.graph``), at each
    shape on both dense-solve routes, against the uncaptured step
    (``graph=False``): the solve that captures it and a warm one (every
    step a replay) give the uncaptured solve's bits and fallbacks; under
    torch.profiler the warm solve launches each hand-written kernel as
    often as the uncaptured one, plus one evaluation's gram kernels for
    each step rerun after a fallback; it makes one replay and one read a
    step (and one read a rerun); and one step body, run uncaptured under
    ``torch.cuda.set_sync_debug_mode("error")``, makes no host sync.
    Prints capture ms and the peak device memory each mode's solve adds
    to what was allocated before it (``torch.cuda.max_memory_allocated``;
    for the graph, the capturing solve's).

    :return: {(shape, route): {"capture_ms", "replays", ...}}."""
    import torch
    from pycamset_tpu_torch.ops import cuda_cholesky as cc
    out = {}
    for shape, prob in probs.items():
        for route in ("library", "kernel"):
            with one_launch_psd(route == "kernel"):
                base = mib_allocated()
                ref_counts, ref = solve_kernel_counts(lambda: (
                    setattr(cc.psd_solve, "fallbacks", 0),
                    prob.solve(graph=False))[1])
                ref_mib = torch.cuda.max_memory_allocated() / 2 ** 20 - base
                fell = [cc.psd_solve.fallbacks]
                runner = prob.graph()
                check(runner.graph is None,
                      f"{shape} ({route}): a graph before the first solve")
                cc.psd_solve.fallbacks = 0
                base = mib_allocated()
                first = prob.solve()            # captures the step
                graph_mib = torch.cuda.max_memory_allocated() / 2 ** 20 - base
                fell.append(cc.psd_solve.fallbacks)
                check(runner.graph is not None,
                      f"{shape} ({route}): the solve captured no graph")
                before = []

                def warm_solve():
                    # counted from the last session profiled's solve alone
                    before[:] = (runner.steps, runner.replays,
                                 runner.reruns, runner.reads)
                    cc.psd_solve.fallbacks = 0
                    return prob.solve()
                counts, warm = solve_kernel_counts(warm_solve)
                fell.append(cc.psd_solve.fallbacks)
                steps, replays, reruns, reads = (
                    a - b for a, b in zip((runner.steps, runner.replays,
                                           runner.reruns, runner.reads),
                                          before))
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    runner.body()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
            tag = f"{shape} ({route})"
            check(same_solve(first, ref) and same_solve(warm, ref),
                  f"{tag}: the captured solve differs from the uncaptured")
            check(fell[0] == fell[1] == fell[2],
                  f"{tag}: fallbacks {fell} (uncaptured, first, warm)")
            check(steps == replays == ref.nit and reruns == fell[0]
                  and reads == ref.nit + reruns,
                  f"{tag}: {steps} steps, {replays} replays, {reruns} reruns, "
                  f"{reads} reads in {ref.nit} LM steps")
            # a rerun evaluates once more: its gram kernels, not the SPD one
            want = {name: n + (0 if name.startswith("psd") else
                               reruns * n // ref.nfev)
                    for name, n in ref_counts.items()}
            check(bool(ref_counts) and counts == want,
                  f"{tag}: kernels {counts} captured, {want} expected "
                  f"(uncaptured {ref_counts})")
            rec = dict(nit=ref.nit, nfev=ref.nfev, status=int(ref.status),
                       fallbacks=fell[0], reruns=reruns, replays=replays,
                       reads=reads,
                       capture_ms=f"{runner.capture_ms:.1f}",
                       peak_mib_graph=f"{graph_mib:.1f}",
                       peak_mib_uncaptured=f"{ref_mib:.1f}",
                       **{f"launches_{k}": f"{counts[k]}/{ref_counts[k]}"
                          for k in sorted(ref_counts)})
            say("graph", shape=shape.replace(" ", "_"), dense_solve=route,
                same_bits=True, sync_free_body=True, **rec)
            out[shape, route] = rec
    return out


def phase_solve(shape, prob, res, side: str, cpu_ref=None, max_nit=10):
    """Check one solve (status 1 or 2, rms <= 0.36 px, and nit <= max_nit
    unless it is None), time five warm solves with the opt-in of ``side``
    on the default (captured) path and five uncaptured (``graph=False``),
    and, given the port's float64 CPU solve of the problem, hold the final
    cost to it. Returns the two medians (ms). The iteration bound is the
    precision canary:
    reduced-precision products inflate the LM steps (5 -> ~95 in the JAX
    package). The line also counts the accepted steps (those that lowered
    the cost)."""
    import torch
    status = int(res.status)
    hist = res.history[:res.nit + 1].double().cpu()
    accepted = int((hist[1:] < hist[:-1]).sum())
    rms = prob.rms_px(res.cost)
    check(bool(torch.isfinite(res.cost)), f"{shape} cost is not finite")
    check(all(bool(torch.isfinite(p).all()) for p in res.x),
          f"{shape} parameters are not finite")
    check(all(g.shape == x.shape for g, x in zip(res.x, prob.x0)),
          f"{shape} result shape")
    times = {True: [], False: []}
    with one_launch_psd(side == "kernel"):
        for graph, got in times.items():
            for _ in range(6):  # one warm-up, then >= 5 timed
                torch.cuda.synchronize()
                t0, t1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                t0.record()
                prob.solve(graph=graph)
                t1.record()
                torch.cuda.synchronize()
                got.append(t0.elapsed_time(t1))
    median, median_host = (float(np.median(times[g][1:]))
                           for g in (True, False))
    fields = dict(nit=res.nit, accepted=accepted, nfev=res.nfev,
                  status=status,
                  rms_px=f"{rms:.5f}", n_real=prob.blocks.n_real,
                  solve_ms_median=f"{median:.3f}",
                  solve_ms_all=",".join(f"{x:.2f}" for x in times[True][1:]),
                  solve_ms_median_uncaptured=f"{median_host:.3f}",
                  solve_ms_all_uncaptured=",".join(
                      f"{x:.2f}" for x in times[False][1:]))
    check(status in (1, 2), f"{shape} ({side}) status {status}")
    check(rms <= 0.36, f"{shape} ({side}) rms {rms} above 1.2 x noise floor")
    check(max_nit is None or res.nit <= max_nit,
          f"{shape} ({side}) nit {res.nit} > {max_nit}")
    if cpu_ref is not None:
        ref, seconds = cpu_ref
        rel = abs(float(res.cost) - float(ref.cost)) / float(ref.cost)
        fields.update(cpu_f64_nit=ref.nit, cpu_f64_status=int(ref.status),
                      cpu_f64_cost=f"{float(ref.cost):.6f}",
                      rel_cost_diff=f"{rel:.3e}", cpu_f64_s=f"{seconds:.1f}")
        check(rel <= 1e-4, f"{shape} ({side}) cost differs from the f64 CPU "
                           f"solve by {rel:.3e}")
    say("solve", shape=shape.replace(" ", "_"), dense_solve=side,
        cost=f"{float(res.cost):.6f}", **fields)
    return median, median_host


def cpu_f64_solve(make, prob):
    """The port's float64 solve of a problem on the CPU, and its seconds."""
    import torch
    t0 = time.perf_counter()
    ref = make(prob.blocks.n_cams, prob.blocks.n_ims, "cpu",
               torch.float64).solve()
    return ref, time.perf_counter() - t0


def fleet_inputs(fleet):
    """The per-block tensors of every rig of a fleet at its start, the rig
    axis first: (cam_b (R,B,15), im_b (R,B,6), uv, mask)."""
    import torch
    n_cams, n_ims = fleet.blocks[0].n_cams, fleet.blocks[0].n_ims
    return (torch.repeat_interleave(fleet.x0.cam, n_ims, dim=1),
            fleet.x0.im.repeat(1, n_cams, 1), fleet.uv, fleet.mask)


def fold(x):
    """(R, N, ...) -> (R*N, ...), rig-major: the folded launch's layout."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def per_rig_max_abs(got, ref) -> list[float]:
    """Per output (each with its rig axis first): the worst rig's error
    against that rig's own max-abs scale of the output."""
    worst = []
    for g, r in zip(got, ref):
        g = g.double().reshape(g.shape[0], -1)
        r = r.double().to(g.device).reshape(r.shape[0], -1)
        err = (g - r).abs().amax(1) / (r.abs().amax(1) + 1e-30)
        worst.append(float(err.max()))
    return worst


def fleet_bound_problem(fleet):
    """What ``bound`` reads of a problem, for the fleet's folded launch:
    its (R*B, K) grid, R*C cameras and every rig's real detections."""
    from types import SimpleNamespace
    return SimpleNamespace(
        mask=fold(fleet.mask), widths=SimpleNamespace(a=15),
        blocks=SimpleNamespace(
            n_cams=fleet.n_rigs * fleet.blocks[0].n_cams,
            n_real=int(fleet.n_real.sum())))


def within_f32_floor(errs: dict, floor: dict) -> bool:
    """Every output's error within TOL or, where the float32 plain twin
    on the same inputs misses TOL itself (``floor``: its errors in the
    same measure), within twice the twin's error: a kernel is not held
    below float32's own floor. At the fleet's start a few blocks are
    already near the noise floor (rig 40: 0.8 px), and their pose
    gradients (gi) carry float32's systematic projection error (about
    1e-4 px) at 1e-4 of their scale."""
    return all(errs[k] <= max(TOL, 2 * floor[k]) for k in errs)


def phase_fleet_kernel(fleet, fleet_a) -> dict:
    """The folded Kernel B (every rig of ``fleet`` in ONE launch, under
    torch.func.vmap) in float32 against its float64 plain twin, four
    losses: every entry within TOL in the solver's Jacobi scaling (per
    camera and per block, so the worst over the fleet is its worst rig's;
    where the float32 twin on the same inputs misses TOL itself, within
    twice its error, ``f32_floor_limits``) and within TOL of its rig's
    max-abs of the output. Each rig's bits against a one-rig launch on
    its slice. The device time of the folded launch beside 64 one-rig
    launches, and its bound. Then the folded Kernel A on ``fleet_a`` (12
    images: the fused rule declines B), four losses, one launch a
    call."""
    import torch
    from pycamset_tpu_torch.optim import cuda_grams as cg
    r, c, i = fleet.n_rigs, fleet.blocks[0].n_cams, fleet.blocks[0].n_ims
    ops = fleet_inputs(fleet)
    tpl = fleet.tpl
    ops64 = tuple(fold(x).double() for x in ops)
    cpu32 = [fold(x).cpu() for x in ops]

    def folded(**kw):
        return torch.func.vmap(lambda cb, ib, u, m: cg.template_gram_fused(
            cb, ib, tpl, u, m, c, i, **kw))(*ops)

    rec = {"abs": 0.0, "rel": 0.0, "scaled": 0.0}
    for loss, sem in LOSS_CASES:
        kw = dict(loss=loss, f_scale=2.0, loss_semantics=sem)
        n0 = cg.template_gram_fused.launches
        got = folded(**kw)
        check(cg.template_gram_fused.launches == n0 + 1,
              "the folded Kernel B took more than one launch")
        ref = cg.template_gram_fused_plain(*ops64[:2], tpl.double(),
                                           *ops64[2:], r * c, i, **kw)
        gram = cg.template_gram_plain(*ops64[:2], tpl.double(), *ops64[2:],
                                      **kw)
        got_f = [fold(g) for g in got]
        scaled = cg.scaled_errors_fused(got_f, ref, gram, r * c, i)
        twin32 = cg.template_gram_fused_plain(*cpu32[:2], tpl.cpu(),
                                              *cpu32[2:], r * c, i, **kw)
        floor = cg.scaled_errors_fused(twin32, [x.cpu() for x in ref],
                                       gram.cpu(), r * c, i)
        unfolded = [x.reshape(g.shape) for x, g in zip(ref, got)]
        rel = dict(zip(B_OUTPUTS, per_rig_max_abs(got, unfolded)))
        rel_floor = dict(zip(B_OUTPUTS, per_rig_max_abs(
            [x.reshape(g.shape) for x, g in zip(twin32, got)], unfolded)))
        check(all(bool(g.isfinite().all()) for g in got),
              "the folded Kernel B's output is not finite")
        check(within_f32_floor(scaled, floor)
              and within_f32_floor(rel, rel_floor),
              f"folded Kernel B {loss}/{sem}: scaled {scaled}, the float32 "
              f"twin's {floor}; per-rig max-abs {rel}, the twin's "
              f"{rel_floor}")
        rec["abs"] = max(rec["abs"], max(
            float((g.double() - x).abs().max()) for g, x in zip(got_f, ref)))
        rec["rel"] = max(rec["rel"], max(rel.values()))
        rec["scaled"] = max(rec["scaled"], max(scaled.values()))
        rec["over_tol"] = rec.get("over_tol", 0) + sum(
            v > TOL for v in (*scaled.values(), *rel.values()))
        say("fleet_kernel", shape=f"{r}x{c}x{i}", kernel="B", loss=loss,
            semantics=sem, tol=TOL,
            **{f"B_{k}": f"{v:.2e}" for k, v in scaled.items()},
            **{f"cpu_f32_twin_{k}": f"{v:.2e}" for k, v in floor.items()})
        say("fleet_kernel_max_abs", shape=f"{r}x{c}x{i}", kernel="B",
            loss=loss, semantics=sem, tol=TOL,
            **{f"B_{k}": f"{v:.2e}" for k, v in rel.items()},
            **{f"cpu_f32_twin_{k}": f"{v:.2e}" for k, v in rel_floor.items()})
        del got, ref, gram, got_f
    # each rig's bits against a one-rig launch on its slice
    got = folded()
    same = sum(all(torch.equal(g[k], o) for g, o in zip(
        got, cg.template_gram_fused(*(x[k] for x in ops[:2]), tpl,
                                    *(x[k] for x in ops[2:]), c, i)))
               for k in range(r))
    check(same == r, f"folded Kernel B: {r - same} of {r} rigs' bits "
                     f"differ from their one-rig launches")
    # device time: the folded launch alone, 64 one-rig launches alone
    packed = cg.pack_block_params(fold(ops[0]), fold(ops[1]))
    packed_r = [cg.pack_block_params(ops[0][k], ops[1][k]) for k in range(r)]
    uv_f, mask_f = fold(ops[2]), fold(ops[3])
    t = {"kernel_ms": kernel_ms(lambda: cg._launch_gram_fused(
            packed, tpl, uv_f, mask_f, r * c, i, 0, 1, 1.0)),
         "one_rig_launches_kernel_ms": kernel_ms(lambda: [
             cg._launch_gram_fused(packed_r[k], tpl, ops[2][k], ops[3][k],
                                   c, i, 0, 1, 1.0) for k in range(r)]),
         "ms": cuda_ms(folded, 20),
         "one_rig_launches_ms": cuda_ms(lambda: [
             cg.template_gram_fused(*(x[k] for x in ops[:2]), tpl,
                                    *(x[k] for x in ops[2:]), c, i)
             for k in range(r)], 5),
         "plain_ms": cuda_ms(lambda: cg.template_gram_fused_plain(
             fold(ops[0]), fold(ops[1]), tpl, uv_f, mask_f, r * c, i), 5)}
    t["bound_ms"], t["bound_by"] = bound("template_gram_fused",
                                         fleet_bound_problem(fleet))
    say("fleet_kernel", shape=f"{r}x{c}x{i}", kernel="B", unit="ms",
        same_bits_rigs=f"{same}/{r}", blocks=r * c * -(-i // cg.FUSED_CHUNK),
        **{k: (f"{v:.4f}" if isinstance(v, float) else v)
           for k, v in t.items()})
    rec.update(t, shape=f"fleet {r}x{c}x{i}", same_bits_rigs=same)

    # the folded Kernel A
    ra, ca, ia = (fleet_a.n_rigs, fleet_a.blocks[0].n_cams,
                  fleet_a.blocks[0].n_ims)
    ops = fleet_inputs(fleet_a)
    ops64 = tuple(fold(x).double() for x in ops)
    cpu32 = [fold(x).cpu() for x in ops]
    worst_a = 0.0
    for loss, sem in LOSS_CASES:
        kw = dict(loss=loss, f_scale=2.0, loss_semantics=sem)
        n0 = cg.template_gram.launches
        got = torch.func.vmap(lambda cb, ib, u, m: cg.template_gram(
            cb, ib, fleet_a.tpl, u, m, **kw))(*ops)
        check(cg.template_gram.launches == n0 + 1,
              "the folded Kernel A took more than one launch")
        ref = cg.template_gram_plain(*ops64[:2], fleet_a.tpl.double(),
                                     *ops64[2:], **kw)
        twin32 = cg.template_gram_plain(*cpu32[:2], fleet_a.tpl.cpu(),
                                        *cpu32[2:], **kw)
        scaled = cg.scaled_errors(fold(got), ref)
        floor = cg.scaled_errors(twin32, ref.cpu())
        rel = {"gram": per_rig_max_abs([got], [ref.reshape(got.shape)])[0]}
        rel_floor = {"gram": per_rig_max_abs([twin32.reshape(got.shape)],
                                             [ref.reshape(got.shape)])[0]}
        check(bool(got.isfinite().all()) and within_f32_floor(scaled, floor)
              and within_f32_floor(rel, rel_floor),
              f"folded Kernel A {loss}/{sem}: scaled {scaled}, the float32 "
              f"twin's {floor}; per-rig max-abs {rel}, the twin's "
              f"{rel_floor}")
        worst_a = max(worst_a, max(scaled.values()), rel["gram"])
        say("fleet_kernel", shape=f"{ra}x{ca}x{ia}", kernel="A", loss=loss,
            semantics=sem, tol=TOL, launches=1,
            per_rig_max_abs=f"{rel['gram']:.2e}",
            cpu_f32_twin_per_rig_max_abs=f"{rel_floor['gram']:.2e}",
            **{f"A_{k}": f"{v:.2e}" for k, v in scaled.items()},
            **{f"cpu_f32_twin_{k}": f"{v:.2e}" for k, v in floor.items()})
    # device time: the folded launch alone, 64 one-rig launches alone
    tpl_a = fleet_a.tpl
    packed = cg.pack_block_params(fold(ops[0]), fold(ops[1]))
    packed_r = [cg.pack_block_params(ops[0][k], ops[1][k])
                for k in range(ra)]
    uv_f, mask_f = fold(ops[2]), fold(ops[3])
    ta = {"kernel_ms": kernel_ms(lambda: cg._launch_gram(
            packed, tpl_a, uv_f, mask_f, 0, 1, 1.0)),
          "one_rig_launches_kernel_ms": kernel_ms(lambda: [
              cg._launch_gram(packed_r[k], tpl_a, ops[2][k], ops[3][k], 0, 1,
                              1.0) for k in range(ra)]),
          "ms": cuda_ms(lambda: torch.func.vmap(
              lambda cb, ib, u, m: cg.template_gram(cb, ib, tpl_a, u, m))(
                  *ops), 20),
          "one_rig_launches_ms": cuda_ms(lambda: [
              cg.template_gram(*(x[k] for x in ops[:2]), tpl_a,
                               *(x[k] for x in ops[2:]))
              for k in range(ra)], 5),
          "plain_ms": cuda_ms(lambda: cg.template_gram_plain(
              fold(ops[0]), fold(ops[1]), tpl_a, uv_f, mask_f), 5)}
    ta["bound_ms"], ta["bound_by"] = bound("template_gram",
                                           fleet_bound_problem(fleet_a))
    say("fleet_kernel", shape=f"{ra}x{ca}x{ia}", kernel="A", unit="ms",
        blocks=ra * ca * ia,
        **{k: (f"{v:.4f}" if isinstance(v, float) else v)
           for k, v in ta.items()})
    rec["kernel_a"] = {"shape": f"fleet {ra}x{ca}x{ia}",
                       "launches_per_call": 1, "max_err": worst_a, **ta}
    return rec


def same_fleet(a, b) -> bool:
    """Two batched SLMResults bit for bit: x, cost, history, status, and
    each rig's nit and nfev."""
    import torch
    return ((a.nit, a.nfev) == (b.nit, b.nfev)
            and torch.equal(a.status, b.status)
            and torch.equal(a.cost, b.cost)
            and torch.equal(a.history, b.history)
            and all(torch.equal(p, q) for p, q in zip(a.x, b.x)))


def timed(fn, n: int, warmup: int = 1) -> list[float]:
    """CUDA-event ms of n calls of fn, one at a time, after the warm-ups."""
    import torch
    times = []
    for k in range(n + warmup):
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        if k >= warmup:
            times.append(t0.elapsed_time(t1))
    return times


def timed_pair(fa, fb, n: int) -> tuple[list[float], list[float]]:
    """CUDA-event ms of n calls each of fa and fb, taken in turn (fa, fb,
    fa, ...) after one warm-up each, so that a change in the host's load
    falls on both lists alike."""
    fa(), fb()
    pairs = [(timed(fa, 1, warmup=0)[0], timed(fb, 1, warmup=0)[0])
             for _ in range(n)]
    return [a for a, _ in pairs], [b for _, b in pairs]


def phase_fleet(fleet) -> dict:
    """The fleet's main path (``problems.fleet_problem(...).solve()``, the
    cascade): uncaptured once with every launch count at 0 (Kernel B
    only, one launch per evaluation of the batch or a cohort,
    ``slm_init``'s included); the solve that captures its graphs and a warm
    one bit-identical to it, Kernel B counted by torch.profiler names
    (1 + the replays); one replay and one read a step, one read a run
    entered; the full batch's step body free of host syncs. Every rig's
    status 1 or 2 and rms <= 0.36 px; every cost within 1e-4 relative of
    the port's float64 CPU fleet solve. The median of warm solves by CUDA
    events (and uncaptured), beside the same rigs solved one by one
    (``.solo(r).solve()``, each captured and warm)."""
    import torch
    from pycamset_tpu_torch.problems import fleet_problem
    r = fleet.n_rigs
    tag = f"{r}x{fleet.blocks[0].n_cams}x{fleet.blocks[0].n_ims}"
    counted = wrappers()
    zero_counts(counted)
    ref = fleet.solve(graph=False)
    torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in counted.items()}
    n_b = counts["template_gram_fused"]
    check(n_b > 0 and not any(n for name, n in counts.items()
                              if name != "template_gram_fused"),
          f"the fleet solve launched {counts}")
    runners = fleet.graph()
    check(not runners, "fleet graphs before the first solve")

    def graphs():
        return sum(g.graph is not None for g in runners.values())

    # a runner's first step is uncaptured: a cohort that steps once in the
    # first solve captures in the second; one that never steps, never
    first = fleet.solve()
    captures = [graphs()]
    second = fleet.solve()
    captures.append(graphs() - captures[0])
    before = {}

    def warm_solve():
        # counted from the last session profiled's solve alone
        before.update({n: (g.steps, g.replays, g.reads)
                       for n, g in runners.items()})
        return fleet.solve()
    prof, warm = solve_kernel_counts(warm_solve)
    cohort_steps = {n: g.steps - before[n][0] for n, g in runners.items()}
    steps, replays, reads = (sum(getattr(runners[n], k) - before[n][j]
                                 for n in runners)
                             for j, k in enumerate(("steps", "replays",
                                                    "reads")))
    check(all(same_fleet(x, ref) for x in (first, second, warm)),
          "the captured fleet solve differs from the uncaptured")
    check(sorted(runners) == [r // 8, r // 2, r]
          and all(g.graph is not None or g.steps <= 1
                  for g in runners.values()),
          f"runners {sorted(runners)}: steps "
          f"{[g.steps for g in runners.values()]}, {captures} captures")
    # warm: one replay a step; one read a step and one a run (4 runs)
    check(steps == replays and reads == steps + 4,
          f"{steps} steps, {replays} replays, {reads} reads")
    b_prof = prof.get("gram_kernel<9,true>", 0)
    check(n_b == 1 + steps and b_prof == 1 + replays,
          f"Kernel B launched {n_b} times uncaptured and {b_prof} captured "
          f"in {steps} batch steps (+1 slm_init)")
    check(n_b < sum(ref.nfev), "Kernel B launched once per rig")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        runners[r].body()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()

    status = ref.status.tolist()
    rms = fleet.rms_px(ref.cost)
    check(all(st in (1, 2) for st in status), f"fleet status {status}")
    check(float(rms.max()) <= 0.36, f"fleet rms {rms.max()} above 0.36 px")
    t0 = time.perf_counter()
    cpu = fleet_problem(*FLEET, "cpu", torch.float64).solve()
    cpu_s = time.perf_counter() - t0
    rel = ((ref.cost.double().cpu() - cpu.cost) / cpu.cost).abs()
    check(float(rel.max()) <= 1e-4,
          f"fleet cost differs from the f64 CPU fleet by {rel.max():.3e}")
    fleet_ms = timed(fleet.solve, 7)
    host_ms = timed(lambda: fleet.solve(graph=False), 3)
    solos = [fleet.solo(k) for k in range(r)]
    solo_res = [p.solve() for p in solos]          # each captures its graph
    solo_ms = timed(lambda: [p.solve() for p in solos], 3)
    median = float(np.median(fleet_ms))
    solo_median = float(np.median(solo_ms))
    nit_diff = [a - b.nit for a, b in zip(ref.nit, solo_res)]
    solo_rel = max(abs(float(ref.cost[k]) - float(b.cost)) / float(b.cost)
                   for k, b in enumerate(solo_res))
    rec = dict(
        rigs=r, n_real=int(fleet.n_real.sum()),
        nit_min=min(ref.nit), nit_max=max(ref.nit), nfev_sum=sum(ref.nfev),
        status_counts={s: status.count(s) for s in sorted(set(status))},
        rms_px_max=f"{rms.max():.5f}", rel_cost_diff_cpu_f64=f"{rel.max():.3e}",
        cpu_f64_nit_diff_rigs=sum(a != b for a, b in zip(ref.nit, cpu.nit)),
        cpu_f64_s=f"{cpu_s:.1f}", launches_template_gram_fused=n_b,
        launches_gram_kernel_captured=b_prof, batch_steps=steps,
        replays=replays, reads=reads,
        captures_first_second_solve=",".join(map(str, captures)),
        capture_ms=",".join(
            f"{n}:{runners[n].capture_ms:.1f}"
            for n in sorted(runners, reverse=True)
            if runners[n].capture_ms is not None),
        cohort_steps_warm=",".join(
            f"{n}:{cohort_steps[n]}" for n in sorted(runners, reverse=True)),
        solve_ms_median=f"{median:.3f}",
        solve_ms_all=",".join(f"{x:.2f}" for x in fleet_ms),
        solve_ms_median_uncaptured=f"{np.median(host_ms):.3f}",
        rigs_per_s=f"{r / median * 1e3:.1f}",
        one_by_one_ms_median=f"{solo_median:.3f}",
        one_by_one_ms_all=",".join(f"{x:.2f}" for x in solo_ms),
        one_by_one_rigs_per_s=f"{r / solo_median * 1e3:.1f}",
        solo_nit_diff_rigs=sum(d != 0 for d in nit_diff),
        solo_nit_diff_max=max(abs(d) for d in nit_diff),
        solo_rel_cost_diff_max=f"{solo_rel:.3e}")
    say("fleet", shape=tag, same_bits=True, sync_free_body=True, **rec)
    return {"launches": n_b, "launches_captured": b_prof,
            "solve_ms_median": median, "one_by_one_ms_median": solo_median}


@contextlib.contextmanager
def timed_method(cls, name: str, sec: dict, key: str):
    """Within the block, each call of ``cls.name`` writes its host seconds
    to ``sec[key]``."""
    orig = getattr(cls, name)

    def timed_call(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return orig(*args, **kwargs)
        finally:
            sec[key] = time.perf_counter() - t0
    setattr(cls, name, timed_call)
    try:
        yield
    finally:
        setattr(cls, name, orig)


def user_path_inputs(n_cams: int, n_ims: int):
    """The user path's inputs at a bench shape (``problems.template_handler``:
    ``standard_problem``'s rig as a CameraSet, a TargetDetection and a
    FreePointTarget) and its seed, the free entries of the bench's
    perturbed start; with the host seconds they took."""
    from pycamset_tpu_torch.problems import template_handler
    t0 = time.perf_counter()
    handler, _ = template_handler(n_cams, n_ims)
    return (handler.camset, handler.detection, handler.target,
            handler.get_initial_params(), time.perf_counter() - t0)


def phase_user_path(probs, cpu_x64: dict, ms_per_eval: dict) -> dict:
    """The user path at each bench template shape, on both dense-solve
    routes: a ``TemplateBundleHandler`` seeded through
    ``set_initial_params`` (no PnP, no OpenCV), its problem
    (``build_structured_problem``), ``run_stereo_calibration(...,
    save=True)`` into a temporary directory and the file loaded back.

    Checks: status 1 or 2, rms <= 0.36 px, nit <= 10; at 16x100 the
    float32 cost within 1e-4 relative of the port's float64 CPU solve of
    the same handler (``cpu_x64``, filled here once per shape); the
    handler's solve captured = uncaptured bit for bit (x merged on the host
    included), its graph captured once and replayed one step a replay, its
    gram kernel launched as often per evaluation as on the ``problems.py``
    path by profiler names (and the SPD kernel once an LM step on the
    kernel route); ``run_stereo_calibration`` launching its own gram kernel
    and no other (the wrappers' counts, zeroed just before it), its
    parameters those of the solve above bit for bit, ``calibration_result``
    equal to ``residual_fn(x)``, and the loaded CameraSet equal to the
    returned one. The file is written and loaded on the library route of
    each shape and on both routes at 16x100 (the writer does not depend on
    the route; at 64x400 the file is 236 MiB): elsewhere
    ``run_stereo_calibration`` runs with ``save=False``. Prints the host
    seconds of each stage: inputs, handler construction,
    ``build_structured_problem`` (host to device included), the first
    solve (capture), ``residual_fn``, ``get_camset``,
    ``run_stereo_calibration`` end to end, its save (``CameraSet.save``
    timed inside it), load; the warm solve median (CUDA events, 5) beside
    the ``problems.py`` problem's, and its ms an evaluation into
    ``ms_per_eval[(shape, route)]``.

    :return: {shape: {route: launches of its gram kernel (and psd_solve)
        in run_stereo_calibration}}."""
    import tempfile

    import torch
    from pycamset_tpu_torch.calibration.camera_calibrator import (
        run_stereo_calibration)
    from pycamset_tpu_torch.models.camera_set import CameraSet
    from pycamset_tpu_torch.optim.handlers import TemplateBundleHandler
    from pycamset_tpu_torch.optim.structured_driver import (
        build_structured_problem)
    from pycamset_tpu_torch.utils.saving import load_CameraSet
    counted = wrappers()
    out = {}
    for shape in ("template 16x100", "template 64x400"):
        prob = probs[shape]
        dev = prob.uv.device
        own = MAIN_PATH[shape][0]
        cams, det, target, x0, inputs_s = user_path_inputs(
            prob.blocks.n_cams, prob.blocks.n_ims)
        opts = {"outliers": "n", "verbosity": 0}
        if shape == "template 16x100":
            h64 = TemplateBundleHandler(cams, target, det, options=opts)
            h64.set_initial_params(x0)
            t0 = time.perf_counter()
            cpu_fn, _, _ = build_structured_problem(h64, device="cpu")
            cpu_x64[shape] = (cpu_fn(x0)[1], time.perf_counter() - t0)
        out[shape] = {}
        for route in ("library", "kernel"):
            tag = f"user_path {shape} ({route})"
            sec = {"inputs": inputs_s}
            with one_launch_psd(route == "kernel"):
                t0 = time.perf_counter()
                handler = TemplateBundleHandler(cams, target, det,
                                                options=opts)
                handler.set_initial_params(x0)
                sec["handler"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                solve_fn, residual_fn, x_init = build_structured_problem(
                    handler, device=dev)
                torch.cuda.synchronize()
                sec["build"] = time.perf_counter() - t0
                x_ref, ref, counts, warm, sec["first_solve"], runner = (
                    solved_through_graph(tag, solve_fn, x_init,
                                         route == "kernel"))
                bench_counts, bench = solve_kernel_counts(prob.solve)
                gram = [n for n in counts if n.startswith("gram_kernel")]
                check(len(gram) == 1 and gram == [
                    n for n in bench_counts if n.startswith("gram_kernel")]
                      and counts[gram[0]] * bench.nfev
                      == bench_counts[gram[0]] * warm.nfev,
                      f"{tag}: gram kernels {counts}, problems.py "
                      f"{bench_counts} (nfev {warm.nfev}, {bench.nfev})")
                handler_ms = timed(lambda: solve_fn(x_init), 5)
                ms_per_eval[(shape, route)] = (float(np.median(handler_ms))
                                               / warm.nfev)
                bench_ms = timed(prob.solve, 5)
                t0 = time.perf_counter()
                resid = residual_fn(x_ref)
                sec["residual_fn"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                handler.get_camset(x_ref)
                sec["get_camset"] = time.perf_counter() - t0

                e2e_handler = TemplateBundleHandler(cams, target, det,
                                                    options=opts)
                e2e_handler.set_initial_params(x0)
                save = route == "library" or shape == "template 16x100"
                with tempfile.TemporaryDirectory() as tmp, \
                        timed_method(CameraSet, "save", sec, "save"):
                    path = os.path.join(tmp, "cams.camset")
                    (solved, n_own, n_psd_e2e,
                     sec["run_stereo_calibration"]) = main_path_counts(
                        counted, own, tag, lambda: run_stereo_calibration(
                            None, None, None, param_handler=e2e_handler,
                            save=save, save_loc=path, device=dev))
                    if save:
                        t0 = time.perf_counter()
                        back = load_CameraSet(path)
                        sec["load"] = time.perf_counter() - t0
                        file_mib = os.path.getsize(path) / 2 ** 20
            check(np.array_equal(solved.calibration_params, x_ref),
                  f"{tag}: run_stereo_calibration's parameters differ from "
                  f"the solve's")
            check(not save or (
                back == solved and back.calibration_handler is not None
                and np.array_equal(back.calibration_params,
                                   solved.calibration_params)
                and np.array_equal(back.calibration_result,
                                   solved.calibration_result)),
                f"{tag}: the loaded CameraSet differs from the returned")
            check(np.array_equal(solved.calibration_result,
                                 resid.reshape(-1)),
                  f"{tag}: calibration_result is not residual_fn(x)")
            status = int(ref.status)
            rms = solve_fn.problem.rms_px(ref.cost)
            check(status in (1, 2), f"{tag}: status {status}")
            check(rms <= 0.36, f"{tag}: rms {rms} above 0.36 px")
            check(ref.nit <= 10, f"{tag}: nit {ref.nit} > 10")
            fields = {}
            if shape in cpu_x64:
                cpu, cpu_s = cpu_x64[shape]
                rel = abs(float(ref.cost) - float(cpu.cost)) / float(cpu.cost)
                check(rel <= 1e-4, f"{tag}: cost differs from the float64 "
                                   f"CPU handler solve by {rel:.3e}")
                fields = dict(cpu_f64_nit=cpu.nit, cpu_f64_s=f"{cpu_s:.1f}",
                              rel_cost_diff_cpu_f64=f"{rel:.3e}")
            say("user_path", shape=shape.replace(" ", "_"), dense_solve=route,
                same_bits=True, nit=ref.nit, nfev=ref.nfev, status=status,
                rms_px=f"{rms:.5f}", cost=f"{float(ref.cost):.6f}",
                n_real=prob.blocks.n_real, im_grid=solve_fn.problem.blocks.n_ims,
                **fields,
                **{f"launches_{k}": v for k, v in counts.items()},
                launches_per_eval_vs_problems=(
                    f"{counts[gram[0]]}/{warm.nfev}"
                    f"={bench_counts[gram[0]]}/{bench.nfev}"),
                e2e_launches=f"{own}:{n_own},psd:{n_psd_e2e}",
                capture_ms=f"{runner.capture_ms:.1f}",
                solve_ms_median=f"{np.median(handler_ms):.3f}",
                solve_ms_all=",".join(f"{t:.2f}" for t in handler_ms),
                problems_solve_ms_median=f"{np.median(bench_ms):.3f}",
                saved=save, **({"file_mib": f"{file_mib:.1f}"} if save else {}),
                **{f"{k}_s": f"{v:.3f}" for k, v in sec.items()})
            out[shape][route] = {own: n_own, PSD[0]: n_psd_e2e}
    return out


def freepoint_inputs(prob, seed: int = 1):
    """The per-block tensors of a free-point problem at a perturbed start:
    the free extrinsics moved by the bench's template perturbation
    (``rng(seed)``), the free points by 1 mm; every lens column free but
    one (the problem fixes them all: here the lens rows and columns are
    held too).

    :return: (cam_b, keyp, uv, mask, cmask_b, kmask)."""
    import torch
    n_ims = prob.blocks.n_ims
    moved = _mover(seed)
    a = prob.widths.a
    cam = moved(prob.x0.cam, cam_scale(a), prob.colmask.cam)
    key = moved(prob.x0.key, 1e-3, prob.colmask.key)
    cmask = prob.colmask.cam.clone()
    cmask[:, :a - 6] = 1.0
    cmask[:, 3] = 0.0
    return (torch.repeat_interleave(cam, n_ims, dim=0), key, prob.uv,
            prob.mask, torch.repeat_interleave(cmask, n_ims, dim=0),
            prob.colmask.key)


def freepoint_runs(sg, f32, n_cams, n_ims) -> dict:
    """The two free-point wrappers on ``f32`` (the fused one takes no
    cmask): {name: launch(**loss options)}."""
    cam_b, keyp, uv, mask, _, kmask = f32
    return {"freepoint_gram": lambda **kw: sg.freepoint_gram(*f32, **kw),
            "freepoint_gram_fused": lambda **kw: sg.freepoint_gram_fused(
                cam_b, keyp, uv, mask, kmask, n_cams, n_ims, **kw)}


def freepoint_parities(sg, f32, n_cams, n_ims, **kw) -> dict:
    """The two free-point wrappers on ``f32`` under one loss, beside their
    float64 plain twins: {name: (outputs, the twin's, errors in the
    solver's Jacobi scaling)}."""
    run = freepoint_runs(sg, f32, n_cams, n_ims)
    cam_b, keyp, uv, mask, cmask, kmask = (t.double() for t in f32)
    d_got = run["freepoint_gram"](**kw)
    d_ref = sg.freepoint_gram_plain(cam_b, keyp, uv, mask, cmask, kmask, **kw)
    c_got = run["freepoint_gram_fused"](**kw)
    c_ref = sg.freepoint_gram_fused_plain(cam_b, keyp, uv, mask, kmask,
                                          n_cams, n_ims, **kw)
    return {"freepoint_gram": (d_got, d_ref,
                               sg.scaled_errors_freepoint(d_got, d_ref)),
            "freepoint_gram_fused": (c_got, c_ref,
                                     sg.scaled_errors_freepoint_fused(
                                         c_got, c_ref, n_cams, n_ims))}


# the cases held to the float32 twin's floor, in the order met
F32_FLOOR_CASES = []


def parity_f32_floor(tag, got, ref, scaled, f32_twin, scaled_of) -> dict:
    """``parity``, save that where an output misses TOL the float32 plain
    twin on the same inputs (``f32_twin()``) is measured against the same
    float64 outputs (``scaled_of(outputs, ref)``: errors in the solver's
    Jacobi scaling; and of each output's max-abs), and the output is held
    to twice the twin's error where the twin misses TOL itself
    (``within_f32_floor``: a slot whose robust-loss weight cancels to
    float32's rounding), both printed."""
    rel = max_abs_errors(got, ref)
    if max(scaled.values()) <= TOL and max(rel) <= TOL:
        return parity(tag, got, ref, scaled)
    F32_FLOOR_CASES.append(tag)
    twin = f32_twin()
    floor = scaled_of(twin, ref)
    rel_floor = max_abs_errors(twin, ref)
    say("parity_f32_floor", case=tag.replace(" ", "_"),
        **{k: f"{v:.2e}" for k, v in scaled.items()},
        **{f"f32_twin_{k}": f"{v:.2e}" for k, v in floor.items()},
        max_abs=",".join(f"{e:.2e}" for e in rel),
        f32_twin_max_abs=",".join(f"{e:.2e}" for e in rel_floor))
    check(all(bool(g.isfinite().all()) for g in got)
          and within_f32_floor(scaled, floor)
          and within_f32_floor(dict(enumerate(rel)),
                               dict(enumerate(rel_floor))),
          f"{tag} vs its plain twin: scaled {scaled}, of max-abs {rel}; "
          f"the float32 twin {floor}, {rel_floor}")
    return {"abs": max(float((g.double() - r.double()).abs().max())
                       for g, r in zip(got, ref)),
            "rel": max(rel), "scaled": max(scaled.values())}


def freepoint_parity(sg, tag, f32, n_cams, n_ims, got, ref, scaled,
                     **kw) -> dict:
    """``parity_f32_floor`` for a free-point wrapper's outputs ``got``
    against its float64 twin's ``ref`` (the tag's first word names it)."""
    cam_b, keyp, uv, mask, _, kmask = f32
    if tag.split()[0] == "freepoint_gram":
        return parity_f32_floor(
            tag, got, ref, scaled,
            lambda: sg.freepoint_gram_plain(*f32, **kw),
            sg.scaled_errors_freepoint)
    return parity_f32_floor(
        tag, got, ref, scaled,
        lambda: sg.freepoint_gram_fused_plain(cam_b, keyp, uv, mask, kmask,
                                              n_cams, n_ims, **kw),
        lambda g, r: sg.scaled_errors_freepoint_fused(g, r, n_cams, n_ims))


def user_path_parity(out, shape, name, prob):
    """The gram kernel ``name`` of a handler path on the handler problem's
    own tensors (its image grid, bucket pads and gauge masks: A or B on a
    template stage at its start, C or D on a self-cal problem moved as
    ``selfcal_inputs`` moves it), against its float64 plain twin under the
    four losses (``parity_f32_floor``), recorded in ``out`` under
    ``shape``."""
    import torch
    from pycamset_tpu_torch.optim import cuda_grams as cg
    from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
    n_cams, n_ims = prob.blocks.n_cams, prob.blocks.n_ims
    gram = None                 # B's and C's scaling: the twin's gram
    if name == "template_gram_fused":
        f32 = template_inputs(prob)
        kernel, plain = cg.template_gram_fused, cg.template_gram_fused_plain

        def launch(fn, ins, **kw):
            return fn(*ins, n_cams, n_ims, **kw)

        def scaled_of(g, r):
            return cg.scaled_errors_fused(g, r, gram, n_cams, n_ims)
    elif name == "template_gram":
        f32 = template_inputs(prob)
        kernel, plain = cg.template_gram, cg.template_gram_plain

        def launch(fn, ins, **kw):
            return [fn(*ins, **kw)]

        def scaled_of(g, r):
            return cg.scaled_errors(g[0], r[0])
    elif name == "selfcal_gram":
        f32 = selfcal_inputs(prob)
        kernel, plain = sg.selfcal_gram, sg.selfcal_gram_plain
        scaled_of = sg.scaled_errors_selfcal

        def launch(fn, ins, **kw):
            return fn(*ins, **kw)
    else:
        f32 = selfcal_inputs(prob)
        kernel, plain = sg.selfcal_gram_fused, sg.selfcal_gram_fused_plain

        def launch(fn, ins, **kw):          # Kernel C takes no cmask
            return fn(*ins[:5], *ins[6:], n_cams, n_ims, **kw)

        def scaled_of(g, r):
            return sg.scaled_errors_selfcal_fused(g, r, gram, n_cams, n_ims)
    f64 = tuple(t.double() for t in f32)
    for loss, sem in LOSS_CASES:
        kw = dict(loss=loss, f_scale=2.0, loss_semantics=sem)
        if name == "selfcal_gram_fused":
            gram = sg.selfcal_gram_plain(*f64[:5], torch.ones_like(f64[5]),
                                         *f64[6:], **kw)[0]
        if name == "template_gram_fused":
            gram = cg.template_gram_plain(*f64, **kw)
        got, ref = launch(kernel, f32, **kw), launch(plain, f64, **kw)
        scaled = scaled_of(got, ref)
        say("parity_user_path", shape=shape.replace(" ", "_"), kernel=name,
            blocks=prob.mask.shape[0], keys=prob.mask.shape[1],
            im_grid=n_ims, loss=loss, semantics=sem, tol=TOL,
            **{k: f"{v:.2e}" for k, v in scaled.items()},
            max_abs=f"{max(max_abs_errors(got, ref)):.2e}")
        record(out, name, shape, parity_f32_floor(
            f"{name} {shape} {loss}/{sem}", got, ref, scaled,
            lambda: launch(plain, f32, **kw), scaled_of))
        del got, ref
    torch.cuda.empty_cache()


def freepoint_bound(name: str, prob, rigs: int = 1) -> tuple[float, str]:
    """The least time of one call of a free-point wrapper on a problem's
    inputs, for the free-point function's own work: its inputs (cam_b, the
    points, uv, mask, the column masks) read once and the outputs it keeps
    (hcc or the per-block gcc_b, gc, the cost, wck, hkk, gk) written once,
    against its products per real detection over the FP32 rate. The
    borrowed self-cal kernel's pose columns and C's per-block wik are not
    counted: the gap to this bound is what they cost. The camera width a
    is the problem's. ``rigs``: a launch folded over that many rigs, whose
    blocks and cameras ``prob`` counts (its mask (R*B, K)); each rig reads
    and writes its own per-key rows."""
    bb, k = prob.mask.shape
    c = prob.blocks.n_cams
    a = prob.widths.a
    kr = k * rigs
    ins = bb * a + kr * 3 + bb * k * 3 + kr * 3  # cam_b, points, uv+mask, kmask
    if name == "freepoint_gram":
        ins += bb * a                               # cmask
        outs = bb * (a * a + a + 1) + bb * k * 3 * a + kr * 12
    else:
        outs = c * (a * a + a) + bb + c * k * 3 * a + kr * 12
    t_bytes = 4 * (ins + outs) / HBM_BYTES_PER_S
    t_ops = (prob.blocks.n_real * freepoint_flop_per_detection(a)
             / FP32_FLOP_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_freepoint_kernels(fp_probs, out):
    """The two free-point wrappers (Kernels D and C at identity poses) vs
    their float64 plain twins at both free-point shapes, all four losses,
    and a repeat launch; times per shape: each launch's device time (the
    borrowed kernel's passes under torch.profiler), the wrapper and the
    float32 twin by CUDA events, the peak MiB a wrapper call adds, beside
    the free-point function's own bound."""
    import torch
    from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
    for shape, prob in fp_probs.items():
        n_cams, n_ims = prob.blocks.n_cams, prob.blocks.n_ims
        f32 = freepoint_inputs(prob)
        for loss, sem in LOSS_CASES:
            res = freepoint_parities(sg, f32, n_cams, n_ims, loss=loss,
                                     f_scale=2.0, loss_semantics=sem)
            say("parity_freepoint", shape=shape.replace(" ", "_"), loss=loss,
                semantics=sem, tol=TOL,
                **{f"{'D' if name == 'freepoint_gram' else 'C'}_{k}":
                   f"{v:.2e}" for name, (_, _, scaled) in res.items()
                   for k, v in scaled.items()},
                **{f"{'D' if name == 'freepoint_gram' else 'C'}_max_abs":
                   f"{max(max_abs_errors(got, ref)):.2e}"
                   for name, (got, ref, _) in res.items()})
            for name, (got, ref, scaled) in res.items():
                record(out, name, shape, freepoint_parity(
                    sg, f"{name} {shape} {loss}/{sem}", f32, n_cams, n_ims,
                    got, ref, scaled, loss=loss, f_scale=2.0,
                    loss_semantics=sem))
            del res
            torch.cuda.empty_cache()
        runs = freepoint_runs(sg, f32, n_cams, n_ims)
        for name, run in runs.items():
            same_bits(name, run)

        cam_b, keyp, uv, mask, cmask, kmask = f32
        im0, imask0 = sg._identity_poses(cam_b)
        packed = sg.pack_block_params(cam_b, im0)
        passes = {
            "freepoint_gram": device_ms(
                lambda: sg._launch_selfcal(packed, keyp, uv, mask, cmask,
                                           imask0, kmask, 0, 1, 1.0)),
            "freepoint_gram_fused": device_ms(
                lambda: sg._launch_selfcal_fused(packed, keyp, uv, mask,
                                                 imask0, kmask, n_cams,
                                                 n_ims, 0, 1, 1.0))}
        say("time_passes", shape=shape.replace(" ", "_"), unit="ms",
            **{f"{name}:{kernel}": f"{ms:.4f}"
               for name, by_kernel in passes.items()
               for kernel, ms in by_kernel.items()})
        for name, run in runs.items():
            base = mib_allocated()
            run()
            peak = torch.cuda.max_memory_allocated() / 2 ** 20 - base
            kernel = sum(passes[name].values())
            plain = (
                (lambda: sg.freepoint_gram_plain(*f32))
                if name == "freepoint_gram" else
                (lambda: sg.freepoint_gram_fused_plain(
                    cam_b, keyp, uv, mask, kmask, n_cams, n_ims)))
            rec = dict(ms=cuda_ms(run, 10), kernel_ms=kernel,
                       plain_ms=cuda_ms(plain, 3), peak_mib=peak)
            out[name][shape].update(rec)
            bound_ms, by = freepoint_bound(name, prob)
            say("time", shape=shape.replace(" ", "_"), kernel=name,
                unit="ms", **{k: f"{v:.4f}" for k, v in rec.items()},
                bound_ms=f"{bound_ms:.4f}", bound_by=by,
                of_bound=f"{bound_ms / max(kernel, 1e-9):.4f}")
        del f32, packed, runs
        torch.cuda.empty_cache()


def solved_through_graph(tag, solve_fn, x0, kernel_route: bool):
    """A handler problem's solves on the card: uncaptured (the reference),
    capturing, and warm under torch.profiler; checks one capture and one
    replay a step, captured = uncaptured bit for bit (the merged x too),
    and the SPD kernel once an LM step on the kernel route only.

    :return: (x_ref, ref, {kernel: launches in the warm solve}, the warm
        SLMResult, the capturing solve's host seconds, the runner)."""
    x_ref, ref = solve_fn(x0, graph=False)
    runner = solve_fn.problem.graph()
    t0 = time.perf_counter()
    x_first, first = solve_fn(x0)                   # captures
    first_s = time.perf_counter() - t0
    graph, replays = runner.graph, []
    counts, (x_warm, warm) = solve_kernel_counts(lambda: (
        replays.append(runner.replays), solve_fn(x0))[1])
    replays = replays[-1]
    check(runner.graph is graph and graph is not None
          and runner.replays - replays == warm.nit,
          f"{tag}: not one capture and one replay a step (graph "
          f"{graph is not None}, replays {runner.replays - replays}, nit "
          f"{warm.nit}, uncaptured nit {ref.nit})")
    check(same_solve(first, ref) and same_solve(warm, ref)
          and np.array_equal(x_first, x_ref)
          and np.array_equal(x_warm, x_ref),
          f"{tag}: the captured solve differs from the uncaptured")
    n_psd = sum(n for name, n in counts.items()
                if name.split("<")[0] == "psd_solve_kernel")
    check(n_psd == (warm.nit if kernel_route else 0),
          f"{tag}: {n_psd} SPD kernel launches in {warm.nit} LM steps")
    return x_ref, ref, counts, warm, first_s, runner


def check_selfcal_passes(tag, counts: dict, warm, flag: str, iw: int = 9):
    """By profiler names, the self-cal kernel's two passes at intrinsic
    width ``iw`` (``mixed_kernel<iw,3,{flag}>`` and its reduction) once an
    evaluation of the warm solve, and no other gram kernel."""
    grams = {n: k for n, k in counts.items()
             if n.split("<")[0] != "psd_solve_kernel"}
    want = {f"mixed_kernel<{iw},3,{flag}>": warm.nfev,
            f"mixed_reduce_kernel<{iw},3,{flag}>": warm.nfev}
    check(grams == want, f"{tag}: gram kernels {grams} in {warm.nfev} "
                         f"evaluations, {want} expected")


def main_path_counts(counted, own: str | None, tag: str, run):
    """The main path's run: every wrapper's count and the SPD kernel's set
    to 0 just before ``run()``, read just after; ``own`` must have launched
    and no other gram wrapper (``own`` None: no gram wrapper at all, the
    chain's plain route). Returns (run's result, own's launches, the SPD
    kernel's launches, the host seconds)."""
    from pycamset_tpu_torch.ops import cuda_cholesky as cc
    zero_counts(counted)
    cc.psd_solve_raw.launches = 0
    t0 = time.perf_counter()
    result = run()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    check((own is None or launches[own] > 0) and not any(
        n for name, n in launches.items() if name != own),
        f"{tag}: the main path launched {launches}")
    return (result, launches.get(own, 0), cc.psd_solve_raw.launches,
            seconds)


def phase_freepoint(fp_probs) -> dict:
    """The pose-free free-point bundle adjustment through the user's entry
    point, at each free-point shape on both dense-solve routes:
    ``problems.freepoint_handler`` (the wand's gauge; no PnP, no OpenCV)
    -> ``run_bundle_adjustment``, its counts zeroed just before it (the
    main path: the shape's own free-point wrapper and no other gram
    wrapper); the handler's problem (``build_structured_problem``, as
    ``problems.freepoint_problem`` builds it) solved uncaptured, capturing
    and warm (``solved_through_graph``: C at 16x24, D at 64x12, once an
    evaluation by profiler names). Checks: status 1 or 2, rms <= 0.36 px,
    the entry point's x the uncaptured solve's bit for bit and its
    residuals ``residual_fn``'s, camera 0 still the identity, the points
    finite; at 64x12 the float32 cost within 1e-4 relative of the port's
    float64 CPU solve of the same handler. Prints the warm solve median
    (CUDA events, 5) and each stage's host seconds.

    :return: {kernel: {"<shape> (<route>)": launches on the main path}}."""
    import torch
    from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
    from pycamset_tpu_torch.optim.structured_driver import (
        build_structured_problem)
    from pycamset_tpu_torch.problems import freepoint_handler
    counted = wrappers()
    launches = {name: {} for name in FREEPOINT_KERNELS}
    for shape, (n_cams, n_ims, bucket) in FREEPOINT.items():
        dev = fp_probs[shape].uv.device
        own = next(n for n, v in FREEPOINT_KERNELS.items() if v[2] == shape)
        flag = "true" if own.endswith("fused") else "false"
        t0 = time.perf_counter()
        handler, scene = freepoint_handler(n_cams, n_ims,
                                           options={"im_bucket": bucket})
        inputs_s = time.perf_counter() - t0
        cpu = None
        for route in ("library", "kernel"):
            tag = f"freepoint {shape} ({route})"
            sec = {"inputs": inputs_s}
            with one_launch_psd(route == "kernel"):
                t0 = time.perf_counter()
                solve_fn, residual_fn, x0 = build_structured_problem(
                    handler, device=dev)
                torch.cuda.synchronize()
                sec["build"] = time.perf_counter() - t0
                prob = solve_fn.problem
                x_ref, ref, counts, warm, sec["first_solve"], runner = (
                    solved_through_graph(tag, solve_fn, x0,
                                         route == "kernel"))
                check_selfcal_passes(tag, counts, warm, flag)
                handler_ms = timed(lambda: solve_fn(x0), 5)
                t0 = time.perf_counter()
                resid = residual_fn(x_ref)
                sec["residual_fn"] = time.perf_counter() - t0
                (result, cams), n_own, n_psd, sec["run_bundle_adjustment"] = (
                    main_path_counts(counted, own, tag, lambda: (
                        run_bundle_adjustment(handler, device=dev))))
            check(np.array_equal(result.x, x_ref)
                  and np.array_equal(result.fun, resid.reshape(-1)),
                  f"{tag}: run_bundle_adjustment's x or residuals differ "
                  f"from the solve's")
            pts = handler.get_updated_points(result.x)
            check(pts.shape == (handler.n_keys(), 3)
                  and bool(np.isfinite(pts).all())
                  and np.array_equal(cams[0].extrinsic, np.eye(4)),
                  f"{tag}: points or the camera-0 gauge")
            status, rms = int(ref.status), prob.rms_px(ref.cost)
            check(status in (1, 2), f"{tag}: status {status}")
            check(rms <= 0.36, f"{tag}: rms {rms} above 0.36 px")
            fields = {}
            if shape == "freepoint 64x12":
                if cpu is None:
                    t0 = time.perf_counter()
                    cpu_fn, _, cpu_x0 = build_structured_problem(
                        handler, device="cpu")
                    cpu = (cpu_fn(cpu_x0)[1], time.perf_counter() - t0)
                rel = abs(float(ref.cost) - float(cpu[0].cost)) / float(
                    cpu[0].cost)
                check(rel <= 1e-4, f"{tag}: cost differs from the float64 "
                                   f"CPU solve by {rel:.3e}")
                fields = dict(cpu_f64_nit=cpu[0].nit,
                              cpu_f64_status=int(cpu[0].status),
                              cpu_f64_s=f"{cpu[1]:.1f}",
                              rel_cost_diff_cpu_f64=f"{rel:.3e}")
            seen = scene["seen"]
            err_mm = 1e3 * np.sqrt(np.mean(np.sum(
                (pts[seen] - scene["pts_true"][seen]) ** 2, axis=1)))
            say("freepoint", shape=shape.replace(" ", "_"), dense_solve=route,
                same_bits=True, nit=ref.nit, nfev=ref.nfev, status=status,
                rms_px=f"{rms:.5f}", cost=f"{float(ref.cost):.6f}",
                n_real=prob.blocks.n_real, keys=prob.mask.shape[1],
                im_grid=prob.blocks.n_ims, **fields,
                **{f"launches_{k}": v for k, v in counts.items()},
                e2e_launches=f"{own}:{n_own},psd:{n_psd}",
                capture_ms=f"{runner.capture_ms:.1f}",
                solve_ms_median=f"{np.median(handler_ms):.3f}",
                solve_ms_all=",".join(f"{t:.2f}" for t in handler_ms),
                points_rms_mm_vs_true=f"{err_mm:.4f}",
                **{f"{k}_s": f"{v:.3f}" for k, v in sec.items()})
            launches[own][f"{shape} ({route})"] = n_own
        del handler, solve_fn, residual_fn, prob, runner
        torch.cuda.empty_cache()
    return launches


def phase_selfcal_user_path(probs, out) -> dict:
    """The self-calibration after a template calibration, the JAX package's
    flow for a target it does not trust, at each shape of ``SELFCAL_USER``:
    the bench rig with its board bent ``BOARD_WARP`` m RMS along the normal
    (``problems.template_handler(template_warp=...)``: the detections see
    the bent board, the target is the nominal grid); the template stage
    (``run_stereo_calibration`` of a ``TemplateBundleHandler`` seeded at
    the bench's start: Kernel A, its count zeroed just before it), then
    ``SelfBundleHandler(camset, target, detection)``,
    ``set_from_templated_camset`` and ``run_stereo_calibration(...,
    param_handler=..., save=True)``, the main path, its counts zeroed just
    before it (C at 16x100, whose 100 images bucket to 104; D at 64x12,
    ``im_bucket: None``), its file loaded back. The self-cal handler's
    problem is solved uncaptured, capturing and warm
    (``solved_through_graph``). Checks: status 1 or 2, rms <= 0.36 px and
    not above the template stage's, the entry point's parameters the
    uncaptured solve's bit for bit, ``calibration_result`` =
    ``residual_fn(x)``, the loaded set equal to the returned one with a
    ``SelfBundleHandler``, the recovered points (``get_updated_target``:
    gauge-aligned onto the nominal grid) nearer the true bent board than
    the nominal grid is; at 16x100 the float32 cost within 1e-4 relative of
    the port's float64 CPU solve of the same handler. Prints each stage's
    host seconds and the warm solve median beside the ``problems.py``
    self-cal problem's. Before the solves, each kernel of the path on its
    problems' own tensors (``user_path_parity``, recorded in ``out``): A on
    the template stage's problem (grid 104 at 16x100, 12 at 64x12), C on
    the self-cal problem at 16x100 (grid 104: C's last chunk of images is
    ragged), D at 64x12.

    :return: {kernel: {"<shape> (<route>)": launches on the main path}}."""
    import tempfile

    import torch
    from pycamset_tpu_torch.calibration.camera_calibrator import (
        run_stereo_calibration)
    from pycamset_tpu_torch.models.camera_set import CameraSet
    from pycamset_tpu_torch.optim.handlers import (SelfBundleHandler,
                                                   TemplateBundleHandler)
    from pycamset_tpu_torch.optim.structured_driver import (
        build_structured_problem)
    from pycamset_tpu_torch.problems import template_handler
    from pycamset_tpu_torch.utils.saving import load_CameraSet
    counted = wrappers()
    launches = {"selfcal_gram_fused": {}, "selfcal_gram": {},
                "template_gram": {}}
    for shape, (n_cams, n_ims, popts, routes) in SELFCAL_USER.items():
        bench = probs[shape.replace("selfcal_user", "selfcal")]
        dev = bench.uv.device
        own = "selfcal_gram" if popts.get("im_bucket", 8) is None else (
            "selfcal_gram_fused")
        flag = "true" if own.endswith("fused") else "false"
        t0 = time.perf_counter()
        th, rig = template_handler(n_cams, n_ims, options=popts,
                                   template_warp=BOARD_WARP)
        cams, det, target = th.camset, th.detection, th.target
        x_tpl = th.get_initial_params()
        inputs_s = time.perf_counter() - t0
        opts = {"outliers": "n", "verbosity": 0, **popts}
        user_path_parity(out, f"{shape} template stage", "template_gram",
                         build_structured_problem(th, device=dev)[0].problem)
        cpu = None
        for route in routes:
            tag = f"selfcal_user_path {shape} ({route})"
            sec = {"inputs": inputs_s}
            with one_launch_psd(route == "kernel"):
                tpl_h = TemplateBundleHandler(cams, target, det, options=opts)
                tpl_h.set_initial_params(x_tpl)
                solved_t, n_tpl, _, sec["template_stage"] = main_path_counts(
                    counted, "template_gram", f"{tag} template stage",
                    lambda: run_stereo_calibration(
                        None, None, None, param_handler=tpl_h, save=False,
                        device=dev))
                tpl_rms = float(np.sqrt(np.mean(
                    np.asarray(solved_t.calibration_result) ** 2)))

                def selfcal_handler():
                    h = SelfBundleHandler(solved_t, target, det, options=opts)
                    h.set_from_templated_camset(solved_t)
                    return h

                t0 = time.perf_counter()
                sh = selfcal_handler()
                sec["handler"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                solve_fn, residual_fn, x0 = build_structured_problem(
                    sh, device=dev)
                torch.cuda.synchronize()
                sec["build"] = time.perf_counter() - t0
                if route == routes[0]:
                    user_path_parity(out, shape, own, solve_fn.problem)
                x_ref, ref, counts, warm, sec["first_solve"], runner = (
                    solved_through_graph(tag, solve_fn, x0,
                                         route == "kernel"))
                check_selfcal_passes(tag, counts, warm, flag)
                handler_ms = timed(lambda: solve_fn(x0), 5)
                bench_ms = timed(bench.solve, 5)
                t0 = time.perf_counter()
                resid = residual_fn(x_ref)
                sec["residual_fn"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                sh.get_camset(x_ref)
                sec["get_camset"] = time.perf_counter() - t0
                e2e_h = selfcal_handler()
                with tempfile.TemporaryDirectory() as tmp, \
                        timed_method(CameraSet, "save", sec, "save"):
                    path = os.path.join(tmp, "self.camset")
                    solved, n_own, n_psd, sec["run_stereo_calibration"] = (
                        main_path_counts(counted, own, tag, lambda: (
                            run_stereo_calibration(
                                None, None, None, param_handler=e2e_h,
                                save=True, save_loc=path, device=dev))))
                    t0 = time.perf_counter()
                    back = load_CameraSet(path)
                    sec["load"] = time.perf_counter() - t0
                    file_mib = os.path.getsize(path) / 2 ** 20
            check(np.array_equal(solved.calibration_params, x_ref)
                  and np.array_equal(solved.calibration_result,
                                     resid.reshape(-1)),
                  f"{tag}: run_stereo_calibration's parameters or residuals "
                  f"differ from the solve's")
            check(back == solved
                  and type(back.calibration_handler) is SelfBundleHandler
                  and np.array_equal(back.calibration_params,
                                     solved.calibration_params)
                  and np.array_equal(back.calibration_result,
                                     solved.calibration_result),
                  f"{tag}: the loaded CameraSet differs from the returned")
            status, rms = int(ref.status), solve_fn.problem.rms_px(ref.cost)
            check(status in (1, 2), f"{tag}: status {status}")
            check(rms <= 0.36 and rms <= tpl_rms,
                  f"{tag}: rms {rms} (template stage {tpl_rms})")
            vis = sh.visible_feature_mask
            true = rig["template_true"]
            pts = e2e_h.get_updated_target(x_ref)
            rec_mm, nominal_mm = (1e3 * np.sqrt(np.mean(np.sum(
                (p[vis] - true[vis]) ** 2, axis=1)))
                for p in (pts, rig["template"]))
            check(bool(np.isfinite(pts).all()) and rec_mm < nominal_mm,
                  f"{tag}: recovered points {rec_mm} mm from the true board, "
                  f"the nominal grid {nominal_mm} mm")
            fields = {}
            if shape == "selfcal_user 16x100":
                if cpu is None:
                    t0 = time.perf_counter()
                    cpu_fn, _, cpu_x0 = build_structured_problem(
                        selfcal_handler(), device="cpu")
                    cpu = (cpu_fn(cpu_x0)[1], time.perf_counter() - t0)
                rel = abs(float(ref.cost) - float(cpu[0].cost)) / float(
                    cpu[0].cost)
                check(rel <= 1e-4, f"{tag}: cost differs from the float64 "
                                   f"CPU solve by {rel:.3e}")
                fields = dict(cpu_f64_nit=cpu[0].nit,
                              cpu_f64_status=int(cpu[0].status),
                              cpu_f64_s=f"{cpu[1]:.1f}",
                              rel_cost_diff_cpu_f64=f"{rel:.3e}")
            say("selfcal_user_path", shape=shape.replace(" ", "_"),
                dense_solve=route, same_bits=True, nit=ref.nit,
                nfev=ref.nfev, status=status, rms_px=f"{rms:.5f}",
                template_stage_rms_px=f"{tpl_rms:.5f}",
                cost=f"{float(ref.cost):.6f}",
                n_real=solve_fn.problem.blocks.n_real,
                im_grid=solve_fn.problem.blocks.n_ims,
                dense_n=15 * n_cams + 6 * solve_fn.problem.blocks.n_ims,
                **fields, **{f"launches_{k}": v for k, v in counts.items()},
                e2e_launches=f"{own}:{n_own},psd:{n_psd}",
                template_stage_launches=f"template_gram:{n_tpl}",
                capture_ms=f"{runner.capture_ms:.1f}",
                solve_ms_median=f"{np.median(handler_ms):.3f}",
                solve_ms_all=",".join(f"{t:.2f}" for t in handler_ms),
                problems_solve_ms_median=f"{np.median(bench_ms):.3f}",
                points_rms_mm_vs_true=f"{rec_mm:.4f}",
                nominal_rms_mm_vs_true=f"{nominal_mm:.4f}",
                file_mib=f"{file_mib:.1f}",
                **{f"{k}_s": f"{v:.3f}" for k, v in sec.items()})
            launches[own][f"{shape} ({route})"] = n_own
            launches["template_gram"][f"{shape} template stage ({route})"] = (
                n_tpl)
        torch.cuda.empty_cache()
    return launches


def distortion_field_px(cams, rig) -> float:
    """The largest pixel difference, over each camera's observed field (its
    detections normalized by the true intrinsics), between the recovered
    distortion function and the true one: the rule of the JAX package's
    ``tests/test_rational_model.py:107-136`` (a rational's coefficients are
    not separately observable, nor the function beyond the data)."""
    import torch
    from pycamset_tpu_torch.ops.distortion import distort_normalized
    dd, worst = rig["dd"], 0.0
    # each camera's rows in their order, by one stable sort
    order = np.argsort(dd[:, 0], kind="stable")
    ends = np.searchsorted(dd[order, 0], np.arange(len(cams) + 1) - 0.5)
    for c, cam in enumerate(cams):
        true_i = rig["intr"][c]
        got = np.ravel(cam.distortion_coefs)
        check(got.size == true_i.size - 4,
              f"camera {c}: {got.size} distortion coefficients, the model "
              f"has {true_i.size - 4}")
        rows = dd[order[ends[c]:ends[c + 1]]]
        grid = torch.as_tensor(np.stack([(rows[:, 3] - true_i[1]) / true_i[0],
                                         (rows[:, 4] - true_i[3]) / true_i[2]],
                                        axis=-1))
        err = (distort_normalized(grid, torch.as_tensor(got))
               - distort_normalized(grid, torch.as_tensor(true_i[4:])))
        f = torch.as_tensor([true_i[0], true_i[2]])
        worst = max(worst, float((err * f).abs().max()))
    return worst


def prediction_field_px(handler, x, rig, dev) -> tuple[float, float]:
    """(RMS, max) px over every real detection of the recovered rig's
    noise-free prediction (its cameras and target poses, the true board)
    against the true rig's: what the model's coefficients determine
    together, whatever the gauge between the lens and the intrinsics."""
    import torch
    from pycamset_tpu_torch.ops.projection import project_cam_points
    from pycamset_tpu_torch.ops.rotations import rodrigues_to_matrix
    intr, extr, poses = handler.bundlePrimitive.return_bundle_primitives(x)
    dd = torch.as_tensor(rig["dd"][:, :3].astype(np.int64), device=dev)
    cam, im, key = dd.unbind(1)
    pts = torch.as_tensor(rig["template_true"], dtype=torch.float64,
                          device=dev)[key]

    def predict(intr, extr, poses):
        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                   device=dev)
        intr, extr, poses = t(intr), t(extr), t(poses)
        rp, re = (rodrigues_to_matrix(poses[:, :3])[im],
                  rodrigues_to_matrix(extr[:, :3])[cam])
        xw = torch.einsum("nab,nb->na", rp, pts) + poses[im, 3:]
        xc = torch.einsum("nab,nb->na", re, xw) + extr[cam, 3:]
        return project_cam_points(intr[cam], xc)

    err = (predict(intr, extr, poses)
           - predict(rig["intr"], rig["extr"], rig["poses"]))
    return (float(torch.sqrt(torch.mean(err ** 2))),
            float(err.abs().max()))


def camera_model_parity(cg, tag, prob, fused: bool, rec: dict):
    """Kernel A (``fused`` False) or B at the problem's camera width on its
    first evaluation, four losses, against the float64 twin (held as
    ``parity_f32_floor`` holds it: where the float32 twin on the same
    inputs misses TOL too, to twice its error), and a repeat launch;
    worst errors into ``rec``, each case held to the floor in
    ``rec["f32_floor_cases"]``."""
    n_cams, n_ims = prob.blocks.n_cams, prob.blocks.n_ims
    f32 = template_inputs(prob)
    f64 = tuple(t.double() for t in f32)
    for loss, sem in LOSS_CASES:
        kw = dict(loss=loss, f_scale=2.0, loss_semantics=sem)
        ref_gram = cg.template_gram_plain(*f64, **kw)
        if fused:
            got = cg.template_gram_fused(*f32, n_cams, n_ims, **kw)
            ref = cg.reduce_grams(ref_gram, n_cams, n_ims)

            def scaled_of(g, r):
                return cg.scaled_errors_fused(g, r, ref_gram, n_cams, n_ims)

            def twin():
                return cg.template_gram_fused_plain(*f32, n_cams, n_ims,
                                                    **kw)
        else:
            got, ref = (cg.template_gram(*f32, **kw),), (ref_gram,)

            def scaled_of(g, r):
                return cg.scaled_errors(g[0], r[0])

            def twin():
                return (cg.template_gram_plain(*f32, **kw),)
        scaled = scaled_of(got, ref)
        rel = max(max_abs_errors(got, ref))
        case = f"{tag} {loss}/{sem}"
        say("parity_camera_model", case=case.replace(" ", "_"), tol=TOL,
            max_abs=f"{rel:.2e}",
            **{k: f"{v:.2e}" for k, v in scaled.items()})
        if max(scaled.values()) > TOL or rel > TOL:
            rec["f32_floor_cases"].append(case)
        e = parity_f32_floor(case, got, ref, scaled, twin, scaled_of)
        for k, v in e.items():
            rec[k] = max(rec.get(k, 0.0), v)
        del got, ref, ref_gram
    name = "template_gram_fused" if fused else "template_gram"
    same_bits(f"{name} {tag}",
              template_runs(cg, f32, n_cams, n_ims)[name])


def camera_model_times(cg, prob, fused: bool, peak_tflops: float) -> dict:
    """Device time of Kernel A or B at the problem's camera width (the
    launch alone on pre-packed parameters, linear loss), the wrapper's and
    the float32 plain twin's CUDA-event ms, the bound and the rate."""
    n_cams, n_ims = prob.blocks.n_cams, prob.blocks.n_ims
    f32 = template_inputs(prob)
    a = prob.widths.a
    packed = cg.pack_block_params(*f32[:2])
    n_rep = 5 if fused else 20
    if fused:
        t = {"kernel_ms": kernel_ms(lambda: cg._launch_gram_fused(
                 packed, *f32[2:], n_cams, n_ims, 0, 1, 1.0, a - 6)),
             "ms": cuda_ms(lambda: cg.template_gram_fused(*f32, n_cams,
                                                          n_ims), n_rep),
             "plain_ms": cuda_ms(lambda: cg.template_gram_fused_plain(
                 *f32, n_cams, n_ims), n_rep)}
    else:
        t = {"kernel_ms": kernel_ms(lambda: cg._launch_gram(
                 packed, *f32[2:], 0, 1, 1.0, a - 6)),
             "ms": cuda_ms(lambda: cg.template_gram(*f32), n_rep),
             "plain_ms": cuda_ms(lambda: cg.template_gram_plain(*f32),
                                 n_rep)}
    name = "template_gram_fused" if fused else "template_gram"
    t["bound_ms"], t["bound_by"] = bound(name, prob)
    flop = prob.blocks.n_real * flop_per_detection("template", a=a)
    t["gflops"] = flop / (t["kernel_ms"] * 1e6)
    t["of_bound"] = t["bound_ms"] / t["kernel_ms"]
    t["of_fma_probe"] = t["gflops"] / (peak_tflops * 1e3)
    return t


def fresh_template(base, x0):
    """A new handler of ``base``'s rig and options at the start x0: every
    solve from the same state (``get_camset`` writes the primitive)."""
    from pycamset_tpu_torch.optim.handlers import TemplateBundleHandler
    h = TemplateBundleHandler(base.camset, base.target, base.detection,
                              fixed_params=base.fixed_params or None,
                              options=dict(base.problem_opts))
    h.set_initial_params(x0)
    return h


def cpu_f64_cost_check(tag, handler, x0, cost, max_nfev=None) -> dict:
    """A card solve's float32 ``cost`` from ``x0`` against the float64 CPU
    solve of a copy of ``handler`` from the same start (``max_nfev``: its
    budget of evaluations, if given): within 1e-4 relative. Returns the
    CPU solve's nit, its seconds and the gap."""
    from pycamset_tpu_torch.optim.handlers import TemplateBundleHandler
    from pycamset_tpu_torch.optim.structured_driver import (
        build_structured_problem)
    opts = dict(handler.problem_opts)
    if max_nfev is not None:
        opts["max_nfev"] = max_nfev
    h64 = TemplateBundleHandler(handler.camset, handler.target,
                                handler.detection, options=opts)
    h64.set_initial_params(x0)
    t0 = time.perf_counter()
    cpu_fn, _, _ = build_structured_problem(h64, device="cpu")
    cpu = cpu_fn(x0)[1]
    rel = abs(float(cost) - float(cpu.cost)) / float(cpu.cost)
    check(rel <= 1e-4, f"{tag}: cost differs from the float64 CPU solve by "
                       f"{rel:.3e}")
    return {"cpu_f64_nit": cpu.nit,
            "cpu_f64_s": f"{time.perf_counter() - t0:.1f}",
            "rel_cost_diff_cpu_f64": f"{rel:.3e}"}


def phase_camera_models(builds: dict, peak_tflops: float) -> dict:
    """The template user path at the four other camera models, on the rig
    ``utils/synthetic.py`` makes with ``camera_model=m``
    (``problems.template_handler``: the truth perturbed as ``[user_path]``'s
    start, seeded through ``set_initial_params``), at 16 x 100 (the grid's
    104 images: Kernel A) and 64 x 400 (Kernel B), on the library route:

    - the shape's kernel on the handler problem's first evaluation against
      its float64 twin, four losses (``camera_model_parity``), its device
      time beside its bound (``camera_model_times``);
    - ``build_structured_problem`` solved uncaptured, capturing and warm
      (``solved_through_graph``: captured = uncaptured bit for bit; by
      profiler names the model's own ``gram_kernel<intr_w, FUSED>`` (and
      ``cam_reduce_kernel<intr_w>``) once an evaluation and no other gram
      kernel); status > 0, rms < 2 x noise_px; the warm solve median;
    - the main path, ``run_stereo_calibration`` (its counts zeroed just
      before: the shape's wrapper alone, at the model's width alone), its
      parameters the solve's bit for bit; the recovered distortion function
      against the truth over each camera's observed field
      (``distortion_field_px``, held within DIST_FIELD_PX for the models
      of DIST_FIELD_HELD) and the recovered rig's noise-free prediction of
      every real detection (``prediction_field_px``, its RMS within
      PREDICTION_RMS_OF_NOISE of the noise); at 16 x 100 its file loaded
      back with each camera's distortion width and reprojection kept;
    - the float32 cost within 1e-4 relative of the float64 CPU solve of
      the same handler (``cpu_f64_cost_check``): at fisheye 16 x 100, and
      at the tilted model on ``template_handler(4, 100)`` (16 x 100's
      took 33-46 s of the card host's CPU);
    - at tilted 64 x 400 (dense n = 24 x 64 = 1536) also the kernel route
      (``PYCAMSET_PALLAS_CHOL=1``): its cost within 1e-4 of the library
      route's, its SPD kernel once an LM step, its fallbacks; the SPD
      kernel on that solve's first reduced system against its float64
      twin and timed beside the library call.

    :return: {"kernels": {(wrapper, model): record}, "psd": the n = 1536
        record}."""
    import tempfile

    import torch
    from pycamset_tpu_torch.calibration.camera_calibrator import (
        run_stereo_calibration)
    from pycamset_tpu_torch.ops import cuda_cholesky as cc
    from pycamset_tpu_torch.optim import cuda_grams as cg
    from pycamset_tpu_torch.optim.structured_driver import (
        build_structured_problem)
    from pycamset_tpu_torch.problems import template_handler
    from pycamset_tpu_torch.utils.saving import load_CameraSet
    dev = torch.device("cuda", 0)
    counted = wrappers()
    kern, psd = {}, {}
    for model, a in MODEL_WIDTH.items():
        iw = a - 6
        for shape, (n_cams, n_ims, name) in MODEL_SHAPES.items():
            fused = name == "template_gram_fused"
            tag = f"{model} {shape}"
            sec = {}
            t0 = time.perf_counter()
            handler, rig = template_handler(n_cams, n_ims,
                                            camera_model=model)
            x0 = handler.get_initial_params()
            sec["inputs"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            solve_fn, residual_fn, x_init = build_structured_problem(
                handler, device=dev)
            torch.cuda.synchronize()
            sec["build"] = time.perf_counter() - t0
            prob = solve_fn.problem
            check(prob.widths.a == a, f"{tag}: camera width {prob.widths.a}")

            rec = kern.setdefault((name, model), {"f32_floor_cases": []})
            rec.update(builds[(name, model)], shape=shape)
            camera_model_parity(cg, tag, prob, fused, rec)
            rec.update(camera_model_times(cg, prob, fused, peak_tflops))
            say("time", camera_model=model, shape=shape, kernel=name, a=a,
                unit="ms", **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                              for k, v in rec.items()
                              if k not in ("f32_floor_cases", "shape")})

            x_ref, ref, counts, warm, sec["first_solve"], runner = (
                solved_through_graph(f"camera_models {tag}", solve_fn,
                                     x_init, False))
            flag = "true" if fused else "false"
            want = {f"gram_kernel<{iw},{flag}>": warm.nfev}
            if fused:
                want[f"cam_reduce_kernel<{iw}>"] = warm.nfev
            grams = {n: k for n, k in counts.items()
                     if n.split("<")[0] != "psd_solve_kernel"}
            check(grams == want, f"{tag}: gram kernels {grams} in "
                                 f"{warm.nfev} evaluations, {want} expected")
            status, rms = int(ref.status), prob.rms_px(ref.cost)
            check(status > 0 and rms < 2 * rig["noise_px"],
                  f"{tag}: status {status}, rms {rms} px")
            warm_ms = timed(lambda: solve_fn(x_init), 5)

            e2e = fresh_template(handler, x0)
            save = shape == "16x100"
            fields = {}
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "cams.camset")
                (solved, n_own, _,
                 sec["run_stereo_calibration"]) = main_path_counts(
                    counted, name, f"camera_models {tag}",
                    lambda: run_stereo_calibration(
                        None, None, None, param_handler=e2e, save=save,
                        save_loc=path, device=dev))
                by_width = dict(counted[name].launches_by_width)
                check(by_width[a] == n_own and not any(
                    n for w, n in by_width.items() if w != a),
                    f"{tag}: launches by camera width {by_width}")
                if save:
                    t0 = time.perf_counter()
                    back = load_CameraSet(path)
                    sec["load"] = time.perf_counter() - t0
                    pts = rig["template"] + [0.0, 0.0, 0.02]
                    for cs, cb in zip(solved, back):
                        check(np.array_equal(np.ravel(cs.distortion_coefs),
                                             np.ravel(cb.distortion_coefs))
                              and np.array_equal(
                                  cs.project_points(pts, device=dev),
                                  cb.project_points(pts, device=dev)),
                              f"{tag}: camera {cs.name} loaded back differs")
                    fields["file_dist_width"] = np.ravel(
                        back[0].distortion_coefs).size
            check(np.array_equal(solved.calibration_params, x_ref),
                  f"{tag}: run_stereo_calibration's parameters differ from "
                  f"the solve's")
            field_px = distortion_field_px(solved, rig)
            check(field_px < DIST_FIELD_PX or model not in DIST_FIELD_HELD,
                  f"{tag}: the recovered distortion is {field_px:.3f} px from "
                  f"the truth over the observed field")
            pred_rms, pred_max = prediction_field_px(e2e, x_ref, rig, dev)
            check(pred_rms <= PREDICTION_RMS_OF_NOISE * rig["noise_px"],
                  f"{tag}: the recovered rig predicts the true detections "
                  f"to {pred_rms:.4f} px RMS")
            rec.setdefault("launches_by_solve", {})[f"camera_models {tag}"] = (
                n_own)
            rec["solve_ms_median"] = float(np.median(warm_ms))

            if shape == "16x100" and model == "fisheye":
                fields.update(cpu_f64_cost_check(tag, handler, x0, ref.cost))
            if shape == "16x100" and model == "tilted":
                # at 4 x 100: 16 x 100's float64 CPU solve took 33-46 s
                h_s, _ = template_handler(4, 100, camera_model=model)
                x_s = h_s.get_initial_params()
                fn_s, _, xi_s = build_structured_problem(h_s, device=dev)
                ref_s = fn_s(xi_s)[1]
                fields.update({f"{k}_4x100": v for k, v in cpu_f64_cost_check(
                    f"{model} 4x100", h_s, x_s, ref_s.cost).items()},
                    nit_4x100=ref_s.nit, status_4x100=int(ref_s.status))
                del h_s, fn_s
            if shape == "64x400" and model == "tilted":
                f0 = cc.psd_solve.fallbacks
                with one_launch_psd(True):
                    _, ref_k, _, warm_k, _, _ = solved_through_graph(
                        f"camera_models {tag} (kernel route)", solve_fn,
                        x_init, True)
                    systems = capture_reduced_systems({tag: prob})
                n = systems[tag][0].shape[0]
                check(n == a * n_cams, f"{tag}: dense n {n}")
                rel_k = (abs(float(ref_k.cost) - float(ref.cost))
                         / float(ref.cost))
                check(rel_k <= 1e-4, f"{tag}: the kernel route's cost is "
                                     f"{rel_k:.3e} from the library route's")
                e = psd_parity(tag, *systems[tag])
                psd = dict(phase_time_psd(systems)[n], n=n, parity=e,
                           fallbacks=cc.psd_solve.fallbacks - f0,
                           nit=ref_k.nit, status=int(ref_k.status),
                           rel_cost_vs_library=rel_k)
                fields.update(kernel_route_nit=ref_k.nit,
                              kernel_route_status=int(ref_k.status),
                              kernel_route_rel_cost=f"{rel_k:.3e}",
                              kernel_route_fallbacks=psd["fallbacks"],
                              psd_n=n, psd_rel_err=f"{e['rel']:.3e}",
                              psd_library_rel_err=f"{e['rel_lib']:.3e}",
                              psd_res2_over_b2=f"{e['res2_over_b2']:.3e}")
            say("camera_models", model=model, shape=shape, a=a,
                kernel=name, same_bits=True, nit=ref.nit, nfev=ref.nfev,
                status=status, rms_px=f"{rms:.5f}",
                noise_px=rig["noise_px"], dist_field_px=f"{field_px:.4f}",
                dist_field_held=model in DIST_FIELD_HELD,
                prediction_rms_px=f"{pred_rms:.5f}",
                prediction_max_px=f"{pred_max:.4f}",
                n_real=prob.blocks.n_real, im_grid=prob.blocks.n_ims,
                launches_per_eval=f"{grams}/{warm.nfev}",
                e2e_launches=f"{name}:{n_own}",
                capture_ms=f"{runner.capture_ms:.1f}",
                solve_ms_median=f"{np.median(warm_ms):.3f}",
                solve_ms_all=",".join(f"{t:.2f}" for t in warm_ms),
                **fields, **{f"{k}_s": f"{v:.3f}" for k, v in sec.items()})
            del solve_fn, residual_fn, prob, handler, e2e, solved
            gc.collect()
            torch.cuda.empty_cache()
    return {"kernels": kern, "psd": psd}


def selfcal_model_kernels(tag, prob, name, rec: dict, builds: dict):
    """One self-cal or free-point kernel at the problem's camera width on its
    own tensors (``selfcal_inputs`` / ``freepoint_inputs``: moved off the
    start), four losses, against the float64 twin (``parity_f32_floor``;
    the cases held to the float32 twin's floor into
    ``rec["f32_floor_cases"]``), a repeat launch, and one linear-loss call's
    device time (the kernel's passes under torch.profiler), the wrapper's
    and the float32 twin's CUDA-event ms, the peak MiB a call adds and the
    bound (``bound``, ``freepoint_bound``); into ``rec``."""
    import torch
    from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
    n_cams, n_ims = prob.blocks.n_cams, prob.blocks.n_ims
    a = prob.widths.a
    iw = a - 6
    freepoint = name.startswith("freepoint")
    if freepoint:
        f32 = freepoint_inputs(prob)
        cam_b, keyp, uv, mask, cmask, kmask = f32
        im0, imask0 = sg._identity_poses(cam_b)
        runs = freepoint_runs(sg, f32, n_cams, n_ims)
        packed = sg.pack_block_params(cam_b, im0)
        if name == "freepoint_gram":
            launch = (lambda: sg._launch_selfcal(
                packed, keyp, uv, mask, cmask, imask0, kmask, 0, 1, 1.0, iw))
            plain = lambda: sg.freepoint_gram_plain(*f32)
        else:
            launch = (lambda: sg._launch_selfcal_fused(
                packed, keyp, uv, mask, imask0, kmask, n_cams, n_ims, 0, 1,
                1.0, iw))
            plain = (lambda: sg.freepoint_gram_fused_plain(
                cam_b, keyp, uv, mask, kmask, n_cams, n_ims))
    else:
        f32 = selfcal_inputs(prob)
        c32 = (*f32[:5], *f32[6:])
        runs = selfcal_runs(sg, f32, n_cams, n_ims)
        packed = sg.pack_block_params(*f32[:2])
        if name == "selfcal_gram":
            launch = lambda: sg._launch_selfcal(packed, *f32[2:], 0, 1, 1.0,
                                                iw)
            plain = lambda: sg.selfcal_gram_plain(*f32)
        else:
            launch = lambda: sg._launch_selfcal_fused(
                packed, *c32[2:], n_cams, n_ims, 0, 1, 1.0, iw)
            plain = lambda: sg.selfcal_gram_fused_plain(*c32, n_cams, n_ims)
    n_floor = len(F32_FLOOR_CASES)
    for loss, sem in LOSS_CASES:
        kw = dict(loss=loss, f_scale=2.0, loss_semantics=sem)
        res = (freepoint_parities if freepoint else selfcal_parities)(
            sg, f32, n_cams, n_ims, **kw)
        got, ref, scaled = res[name]
        case = f"{name} {tag} {loss}/{sem}"
        say("parity_selfcal_model", case=case.replace(" ", "_"), tol=TOL,
            max_abs=f"{max(max_abs_errors(got, ref)):.2e}",
            **{k: f"{v:.2e}" for k, v in scaled.items()})
        if freepoint:
            e = freepoint_parity(sg, case, f32, n_cams, n_ims, got, ref,
                                 scaled, **kw)
        elif name == "selfcal_gram":
            e = parity_f32_floor(case, got, ref, scaled,
                                 lambda: sg.selfcal_gram_plain(*f32, **kw),
                                 sg.scaled_errors_selfcal)
        else:
            gram = sg.selfcal_gram_plain(
                *(t.double() for t in f32[:5]),
                torch.ones_like(f32[5], dtype=torch.float64),
                *(t.double() for t in f32[6:]), **kw)[0]
            e = parity_f32_floor(
                case, got, ref, scaled,
                lambda: sg.selfcal_gram_fused_plain(*c32, n_cams, n_ims,
                                                    **kw),
                lambda g, r: sg.scaled_errors_selfcal_fused(
                    g, r, gram, n_cams, n_ims))
        for k, v in e.items():
            rec[k] = max(rec.get(k, 0.0), v)
        del res, got, ref
        torch.cuda.empty_cache()
    rec.setdefault("f32_floor_cases", []).extend(F32_FLOOR_CASES[n_floor:])
    same_bits(f"{name} {tag}", runs[name])
    passes = device_ms(launch)
    base = mib_allocated()
    runs[name]()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20 - base
    bound_ms, bound_by = (freepoint_bound(name, prob) if freepoint
                          else bound(name, prob))
    kernel = sum(passes.values())
    rec.update(builds[("selfcal_gram_fused" if name.endswith("fused")
                       else "selfcal_gram", tag.split()[0])],
               shape=tag, kernel_ms=kernel, ms=cuda_ms(runs[name], 10),
               plain_ms=cuda_ms(plain, 3), peak_mib=peak, bound_ms=bound_ms,
               bound_by=bound_by, passes=passes)
    say("time", case=f"{name}_{tag.replace(' ', '_')}", a=a, unit="ms",
        kernel_ms=f"{kernel:.4f}", ms=f"{rec['ms']:.4f}",
        plain_ms=f"{rec['plain_ms']:.4f}", bound_ms=f"{bound_ms:.4f}",
        bound_by=bound_by, of_bound=f"{bound_ms / max(kernel, 1e-9):.4f}",
        peak_mib=f"{peak:.1f}", registers=rec["registers"],
        spill_bytes=rec["spill_bytes"],
        **{f"pass:{k}": f"{v:.4f}" for k, v in passes.items()})
    del f32, packed, runs
    torch.cuda.empty_cache()


def phase_selfcal_models(builds: dict) -> dict:
    """The self-calibration and free-point chains at the four other camera
    models (``MODEL_WIDTH``), each on the rig ``utils/synthetic.py`` makes
    for it, library route:

    - the kernels on their problems' own tensors (``selfcal_model_kernels``):
      C on the self-cal handler's problem at 16 x 100 (grid 104: C's last
      chunk of images is ragged), D on ``problems.selfcal_problem`` at
      64 x 12, the fused free-point wrapper (over C) on
      ``problems.freepoint_problem`` at 16 x 24, the per-block one (over D)
      on the free-point handler's problem at 64 x 12;
    - the self-cal user path at 16 x 100: ``template_handler(template_warp=
      BOARD_WARP, camera_model=m)`` -> ``run_stereo_calibration`` (Kernel A
      at the model) -> ``SelfBundleHandler(..., options={"camera_model":
      m})``, ``set_from_templated_camset`` -> its problem solved
      uncaptured, capturing and warm (captured = uncaptured; by profiler
      names the model's ``mixed_kernel<iw,3,true>`` and its reduction once
      an evaluation, no other gram kernel) -> ``run_stereo_calibration(...,
      param_handler=..., save=True)`` as the main path (its counts zeroed
      just before: C alone, at the model's width alone), its parameters
      the solve's bit for bit, ``calibration_result`` = ``residual_fn(x)``,
      status 1 or 2, rms <= 0.36 px and not above the template stage's, the
      file loaded back equal to the returned set with the model's
      distortion width; the recovered points' RMS distance to the true bent
      board beside the nominal grid's, held nearer;
    - D's main path: ``problems.selfcal_problem(64, 12, camera_model=m)``
      solved uncaptured with the counts zeroed just before (D at the
      model's width, once an evaluation);
    - the free-point user path at 64 x 12: ``freepoint_handler(...,
      options={"im_bucket": None}, camera_model=m)`` ->
      ``run_bundle_adjustment`` as the main path (the per-block wrapper
      alone, at the model's width), its problem solved uncaptured,
      capturing and warm (D's passes once an evaluation), status 1 or 2,
      rms <= 0.36 px.

    :return: {(wrapper, model): record}."""
    import tempfile

    import torch
    from pycamset_tpu_torch.calibration.camera_calibrator import (
        run_stereo_calibration)
    from pycamset_tpu_torch.models.camera_set import CameraSet
    from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
    from pycamset_tpu_torch.optim.handlers import SelfBundleHandler
    from pycamset_tpu_torch.optim.structured_driver import (
        build_structured_problem)
    from pycamset_tpu_torch.problems import (freepoint_handler,
                                             freepoint_problem,
                                             selfcal_problem,
                                             template_handler)
    from pycamset_tpu_torch.utils.saving import load_CameraSet
    dev = torch.device("cuda", 0)
    counted = wrappers()
    kern = {}
    for model, a in MODEL_WIDTH.items():
        iw = a - 6
        t_model = time.perf_counter()
        recs = {name: kern.setdefault((name, model), {})
                for name in ("selfcal_gram_fused", "selfcal_gram",
                             "freepoint_gram_fused", "freepoint_gram")}

        # the self-cal user path at 16 x 100
        sec = {}
        t0 = time.perf_counter()
        th, rig = template_handler(16, 100, template_warp=BOARD_WARP,
                                   camera_model=model)
        cams, det, target = th.camset, th.detection, th.target
        sec["inputs"] = time.perf_counter() - t0
        tag = f"{model} selfcal_user 16x100"
        solved_t, n_tpl, _, sec["template_stage"] = main_path_counts(
            counted, "template_gram", f"{tag} template stage",
            lambda: run_stereo_calibration(None, None, None,
                                           param_handler=th, save=False,
                                           device=dev))
        tpl_rms = float(np.sqrt(np.mean(
            np.asarray(solved_t.calibration_result) ** 2)))
        opts = {"outliers": "n", "verbosity": 0, "camera_model": model}

        def selfcal_handler():
            h = SelfBundleHandler(solved_t, target, det, options=opts)
            h.set_from_templated_camset(solved_t)
            return h

        sh = selfcal_handler()
        t0 = time.perf_counter()
        solve_fn, residual_fn, x0 = build_structured_problem(sh, device=dev)
        torch.cuda.synchronize()
        sec["build"] = time.perf_counter() - t0
        prob = solve_fn.problem
        check(prob.widths.a == a and prob.blocks.n_ims == 104,
              f"{tag}: camera width {prob.widths.a}, grid "
              f"{prob.blocks.n_ims}")
        selfcal_model_kernels(f"{model} selfcal 16x100", prob,
                              "selfcal_gram_fused",
                              recs["selfcal_gram_fused"], builds)
        x_ref, ref, counts, warm, sec["first_solve"], runner = (
            solved_through_graph(tag, solve_fn, x0, False))
        check_selfcal_passes(tag, counts, warm, "true", iw)
        warm_ms = timed(lambda: solve_fn(x0), 3)
        resid = residual_fn(x_ref)
        e2e_h = selfcal_handler()
        with tempfile.TemporaryDirectory() as tmp, \
                timed_method(CameraSet, "save", sec, "save"):
            path = os.path.join(tmp, "self.camset")
            solved, n_own, _, sec["run_stereo_calibration"] = (
                main_path_counts(counted, "selfcal_gram_fused", tag, lambda: (
                    run_stereo_calibration(None, None, None,
                                           param_handler=e2e_h, save=True,
                                           save_loc=path, device=dev))))
            by_width = dict(counted["selfcal_gram_fused"].launches_by_width)
            back = load_CameraSet(path)
        check(by_width[a] == n_own and not any(
            n for w, n in by_width.items() if w != a),
            f"{tag}: launches by camera width {by_width}")
        check(np.array_equal(solved.calibration_params, x_ref)
              and np.array_equal(solved.calibration_result,
                                 resid.reshape(-1)),
              f"{tag}: run_stereo_calibration's parameters or residuals "
              f"differ from the solve's")
        check(back == solved
              and type(back.calibration_handler) is SelfBundleHandler
              and np.array_equal(back.calibration_params,
                                 solved.calibration_params)
              and all(np.ravel(c.distortion_coefs).size == iw - 4
                      for c in back),
              f"{tag}: the loaded CameraSet differs from the returned")
        status, rms = int(ref.status), prob.rms_px(ref.cost)
        check(status in (1, 2), f"{tag}: status {status}")
        check(rms <= 0.36 and rms <= tpl_rms,
              f"{tag}: rms {rms} (template stage {tpl_rms})")
        vis = sh.visible_feature_mask
        true = rig["template_true"]
        pts = e2e_h.get_updated_target(x_ref)
        rec_mm, nominal_mm = (1e3 * np.sqrt(np.mean(np.sum(
            (p[vis] - true[vis]) ** 2, axis=1)))
            for p in (pts, rig["template"]))
        check(bool(np.isfinite(pts).all()) and rec_mm < nominal_mm,
              f"{tag}: recovered points {rec_mm} mm from the true board, "
              f"the nominal grid {nominal_mm} mm")
        recs["selfcal_gram_fused"].setdefault("launches_by_solve", {})[
            tag] = n_own
        say("selfcal_models", model=model, shape="selfcal_user_16x100", a=a,
            same_bits=True, nit=ref.nit, nfev=ref.nfev, status=status,
            rms_px=f"{rms:.5f}", template_stage_rms_px=f"{tpl_rms:.5f}",
            n_real=prob.blocks.n_real, im_grid=prob.blocks.n_ims,
            launches_per_eval=f"{counts}/{warm.nfev}",
            e2e_launches=f"selfcal_gram_fused:{n_own}",
            template_stage_launches=f"template_gram:{n_tpl}",
            file_dist_width=np.ravel(back[0].distortion_coefs).size,
            points_rms_mm_vs_true=f"{rec_mm:.4f}",
            nominal_rms_mm_vs_true=f"{nominal_mm:.4f}",
            capture_ms=f"{runner.capture_ms:.1f}",
            solve_ms_median=f"{np.median(warm_ms):.3f}",
            **{f"{k}_s": f"{v:.3f}" for k, v in sec.items()})
        del (th, sh, e2e_h, solve_fn, residual_fn, prob, runner, solved,
             solved_t, back)

        # D: the bench self-cal problem at 64 x 12
        tag = f"{model} selfcal 64x12"
        prob = selfcal_problem(64, 12, dev, camera_model=model)
        selfcal_model_kernels(tag, prob, "selfcal_gram", recs["selfcal_gram"],
                              builds)
        res, n_own, _, d_s = main_path_counts(
            counted, "selfcal_gram", tag,
            lambda: prob.solve(graph=False))
        check(counted["selfcal_gram"].launches_by_width[a] == n_own
              == res.nfev, f"{tag}: {n_own} launches in {res.nfev} "
                           f"evaluations")
        recs["selfcal_gram"].setdefault("launches_by_solve", {})[tag] = n_own
        say("selfcal_models", model=model, shape="selfcal_64x12", a=a,
            nit=res.nit, nfev=res.nfev, status=int(res.status),
            rms_px=f"{prob.rms_px(res.cost):.5f}",
            e2e_launches=f"selfcal_gram:{n_own}", solve_s=f"{d_s:.3f}")
        del prob

        # the fused free-point wrapper at 16 x 24
        tag = f"{model} freepoint 16x24"
        prob = freepoint_problem(16, 24, dev, camera_model=model)
        selfcal_model_kernels(tag, prob, "freepoint_gram_fused",
                              recs["freepoint_gram_fused"], builds)
        res, n_own, _, f_s = main_path_counts(
            counted, "freepoint_gram_fused", tag,
            lambda: prob.solve(graph=False))
        check(counted["freepoint_gram_fused"].launches_by_width[a] == n_own
              == res.nfev, f"{tag}: {n_own} launches in {res.nfev} "
                           f"evaluations")
        recs["freepoint_gram_fused"].setdefault("launches_by_solve", {})[
            tag] = n_own
        say("selfcal_models", model=model, shape="freepoint_16x24", a=a,
            nit=res.nit, nfev=res.nfev, status=int(res.status),
            rms_px=f"{prob.rms_px(res.cost):.5f}",
            e2e_launches=f"freepoint_gram_fused:{n_own}",
            solve_s=f"{f_s:.3f}")
        del prob

        # the free-point user path at 64 x 12, through D's wrapper
        tag = f"{model} freepoint_user 64x12"
        sec = {}
        handler, scene = freepoint_handler(64, 12,
                                           options={"im_bucket": None},
                                           camera_model=model)
        solve_fn, residual_fn, x0 = build_structured_problem(handler,
                                                             device=dev)
        prob = solve_fn.problem
        check(prob.widths.a == a, f"{tag}: camera width {prob.widths.a}")
        selfcal_model_kernels(f"{model} freepoint 64x12", prob,
                              "freepoint_gram", recs["freepoint_gram"],
                              builds)
        x_ref, ref, counts, warm, sec["first_solve"], runner = (
            solved_through_graph(tag, solve_fn, x0, False))
        check_selfcal_passes(tag, counts, warm, "false", iw)
        resid = residual_fn(x_ref)
        (result, cams), n_own, _, sec["run_bundle_adjustment"] = (
            main_path_counts(counted, "freepoint_gram", tag, lambda: (
                run_bundle_adjustment(handler, device=dev))))
        by_width = dict(counted["freepoint_gram"].launches_by_width)
        check(by_width[a] == n_own and not any(
            n for w, n in by_width.items() if w != a),
            f"{tag}: launches by camera width {by_width}")
        check(np.array_equal(result.x, x_ref)
              and np.array_equal(result.fun, resid.reshape(-1))
              and np.array_equal(cams[0].extrinsic, np.eye(4)),
              f"{tag}: run_bundle_adjustment's x or residuals differ from "
              f"the solve's, or the camera-0 gauge moved")
        status, rms = int(ref.status), prob.rms_px(ref.cost)
        check(status in (1, 2), f"{tag}: status {status}")
        check(rms <= 0.36, f"{tag}: rms {rms} above 0.36 px")
        pts = handler.get_updated_points(result.x)
        seen = scene["seen"]
        err_mm = 1e3 * np.sqrt(np.mean(np.sum(
            (pts[seen] - scene["pts_true"][seen]) ** 2, axis=1)))
        recs["freepoint_gram"].setdefault("launches_by_solve", {})[tag] = (
            n_own)
        say("selfcal_models", model=model, shape="freepoint_user_64x12",
            a=a, same_bits=True, nit=ref.nit, nfev=ref.nfev, status=status,
            rms_px=f"{rms:.5f}", n_real=prob.blocks.n_real,
            keys=prob.mask.shape[1],
            launches_per_eval=f"{counts}/{warm.nfev}",
            e2e_launches=f"freepoint_gram:{n_own}",
            points_rms_mm_vs_true=f"{err_mm:.4f}",
            capture_ms=f"{runner.capture_ms:.1f}",
            **{f"{k}_s": f"{v:.3f}" for k, v in sec.items()})
        del handler, solve_fn, residual_fn, prob, runner, result, cams
        gc.collect()
        torch.cuda.empty_cache()
        say("elapsed", after=f"selfcal_models {model}",
            seconds=f"{time.perf_counter() - t_model:.1f}")
    return kern


def mixed_model_kernel(tag, prob, name, rec: dict):
    """Kernel E (``mixed_gram_fused``) or F (``mixed_gram``) at the
    problem's camera width and key width (cw 9: a mixed problem; 6: a
    grouped one) on its own tensors (``multi_target_inputs``: moved off the
    start), four losses, against the float64 twin in both measures and in
    the per-group sums the solver builds from it (``parity_f32_floor``; the
    cases held to the float32 twin's floor into
    ``rec["f32_floor_cases"]``), a repeat launch, and one linear-loss
    call's device time (the kernel's passes under torch.profiler), the
    wrapper's and the float32 twin's CUDA-event ms, the peak MiB a call
    adds and the bound (``bound``); into ``rec``."""
    import torch
    from pycamset_tpu_torch.optim import cuda_mixed_grams as mg
    n_cams, n_ims = prob.blocks.n_cams, prob.blocks.n_ims
    a = prob.widths.a
    wk = hasattr(prob.x0, "grp")          # the mixed chain: free points
    cw = mg.key_width(wk)
    fused = name == "mixed_gram_fused"
    oh = prob.onehot(prob.uv)
    f32 = multi_target_inputs(prob)
    f64 = tuple(t.double() for t in f32)
    kd = mg.pack_key_group_data(f32[2][:, :6],
                                f32[2][:, 6:9] if wk else f32[3])
    packed = mg.pack_block_params(*f32[:2])
    if fused:
        def run(args=f32, **kw):
            return mg.mixed_gram_fused(*args, n_cams, n_ims,
                                       with_key_cols=wk, **kw)

        def twin(args, **kw):
            return mg.mixed_gram_fused_plain(*args, n_cams, n_ims,
                                             with_key_cols=wk, **kw)

        def launch():
            return mg._launch_mixed_fused(packed, kd, *f32[4:], n_cams,
                                          n_ims, 0, 1, 1.0, a - 6)
    else:
        def run(args=f32, **kw):
            return mg.mixed_gram(*args, with_key_cols=wk, **kw)

        def twin(args, **kw):
            return mg.mixed_gram_plain(*args, with_key_cols=wk, **kw)

        def launch():
            return mg._launch_mixed(packed, kd, *f32[4:], 0, 1, 1.0, a - 6)
    n_floor = len(F32_FLOOR_CASES)
    for loss, sem in LOSS_CASES:
        kw = dict(loss=loss, f_scale=2.0, loss_semantics=sem)
        got, ref = run(**kw), twin(f64, **kw)
        if fused:
            gram = mg.mixed_gram_plain(*f64, with_key_cols=wk, **kw)[0]

            def scaled_of(g, r):
                return {**mg.scaled_errors_mixed_fused(g, r, gram, n_cams,
                                                       n_ims),
                        **mg.scaled_errors_groups(g, r, oh, n_cams, n_ims)}
        else:
            def scaled_of(g, r):
                return {**mg.scaled_errors_mixed(g, r),
                        **mg.scaled_errors_groups(g, r, oh, n_cams, n_ims)}
        scaled = scaled_of(got, ref)
        case = f"{name} {tag} cw{cw} {loss}/{sem}"
        say("parity_mixed_model", case=case.replace(" ", "_"), tol=TOL,
            max_abs=f"{max(max_abs_errors(got, ref)):.2e}",
            **{k: f"{v:.2e}" for k, v in scaled.items()})
        e = parity_f32_floor(case, got, ref, scaled,
                             lambda: twin(f32, **kw), scaled_of)
        for k, v in e.items():
            rec[k] = max(rec.get(k, 0.0), v)
        del got, ref
        torch.cuda.empty_cache()
    rec.setdefault("f32_floor_cases", []).extend(F32_FLOOR_CASES[n_floor:])
    same_bits(f"{name} {tag} cw{cw}", run)
    passes = device_ms(launch)
    base = mib_allocated()
    run()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20 - base
    bound_ms, bound_by = bound(name, prob, cw)
    kernel = sum(passes.values())
    rec.update(shape=tag, kernel_ms=kernel, ms=cuda_ms(run, 10),
               plain_ms=cuda_ms(lambda: twin(f32), 3), peak_mib=peak,
               bound_ms=bound_ms, bound_by=bound_by, passes=passes)
    say("time", case=f"{name}_{tag.replace(' ', '_')}_cw{cw}", a=a, cw=cw,
        unit="ms", kernel_ms=f"{kernel:.4f}", ms=f"{rec['ms']:.4f}",
        plain_ms=f"{rec['plain_ms']:.4f}", bound_ms=f"{bound_ms:.4f}",
        bound_by=bound_by, of_bound=f"{bound_ms / max(kernel, 1e-9):.4f}",
        peak_mib=f"{peak:.1f}", registers=rec["registers"],
        spill_bytes=rec["spill_bytes"], blocks_per_sm=rec["blocks_per_sm"],
        **{f"pass:{k}": f"{v:.4f}" for k, v in passes.items()})
    del f32, f64, packed, kd
    torch.cuda.empty_cache()


def status_class(status: int) -> str:
    """An LM status read as its class: converged (1, 2) or another stop."""
    return "converged" if status in (1, 2) else f"status {status}"


def group_pose_error(prob, x) -> dict:
    """How far the solve's group 1 is from the truth the data were made
    with (``problems.GROUP_TRUE``: the two targets are the halves of one
    board, so group 1's relative pose is the identity): its rotation (mrad)
    and translation (mm) from the truth; for the mixed chain, whose free
    points trade with their group's pose (group 1's points carry no gauge
    pin), also the RMS distance (mm) of group 1's points, mapped through
    the recovered pose, from the true board's (the start's points: the
    bench starts the points at the truth)."""
    import torch
    from pycamset_tpu_torch.ops.rotations import rodrigues_to_matrix
    from pycamset_tpu_torch.problems import GROUP_TRUE
    grp = (x.grp if hasattr(x, "grp") else x.key)[1].double().cpu()
    d = grp.numpy() - GROUP_TRUE[1]
    out = {"group1_rot_mrad": 1e3 * float(np.linalg.norm(d[:3])),
           "group1_trans_mm": 1e3 * float(np.linalg.norm(d[3:]))}
    if hasattr(x, "grp"):
        keys = np.flatnonzero(prob.group_of_key[:prob.blocks.n_keys] == 1)
        pts = x.key.double().cpu()[keys]
        world = pts @ rodrigues_to_matrix(grp[:3]).T + grp[3:]
        true = prob.x0.key.double().cpu()[keys]   # the start: the truth
        out["group1_points_rms_mm"] = 1e3 * float(torch.sqrt(torch.mean(
            torch.sum((world - true) ** 2, dim=1))))
    return out


# [mixed_models]: the multi-target solves at each other camera model ->
# (maker, cameras, images, the kernel it takes, its key width); F at key
# width 6 has no 16 x 100 solve (grouped 16 x 100 takes E), so grouped
# 64 x 12 (12 images pad 16: 33%) is its main path
MIXED_MODEL_SOLVES = {
    "mixed 16x100": ("mixed", 16, 100, "mixed_gram_fused", 9),
    "mixed 64x12": ("mixed", 64, 12, "mixed_gram", 9),
    "grouped 16x100": ("grouped", 16, 100, "mixed_gram_fused", 6),
    "grouped 64x12": ("grouped", 64, 12, "mixed_gram", 6)}


def phase_mixed_models(builds: dict, std_status: dict) -> dict:
    """The multi-target chains at the four other camera models
    (``MODEL_WIDTH``), each on the rig ``utils/synthetic.py`` makes for it
    (``problems.{mixed,grouped}_problem(..., camera_model=m)``: the bench's
    start, true lens, group 1 at ``GROUP_START[1]``), library route:

    - the kernels on their main paths' own tensors (``mixed_model_kernel``):
      E at mixed 16 x 100 (cw 9) and grouped 16 x 100 (cw 6), F at mixed
      64 x 12 (cw 9) and grouped 64 x 12 (cw 6); F at cw 6 also on grouped
      16 x 100's tensors, as ``phase_mixed_kernels`` does at a = 15 (the
      row's ``other_shape``);
    - each of ``MIXED_MODEL_SOLVES`` solved uncaptured as the main path
      (the counts zeroed just before: its own kernel alone, once an
      evaluation, at the model's width and its key width alone; each
      library dense solve held to the kernel route's residual rule,
      ``library_solve_spy``), then capturing and warm (captured =
      uncaptured, bit for bit), its status of the standard model's class
      in the same run (``std_status``: the standard model's statuses of
      the same run; grouped 64 x 12's is solved here), rms <= 0.36 px,
      group 1's recovered pose against the truth (``group_pose_error``),
      the warm captured median;
    - at the tilted model, mixed 64 x 12 on the SPD kernel route too
      (opted in, uncaptured; dense n = 64 x 24 + 12 x 6 + 12 = 1620): its
      fallbacks beside the library route's residual misses on its own
      solve, each fallback only where the library route fails the
      residual rule too on the same system (``fallback_evidence``).

    :return: {(wrapper, model, cw): record}."""
    import torch
    from pycamset_tpu_torch.ops import cuda_cholesky as cc
    from pycamset_tpu_torch.problems import grouped_problem, mixed_problem
    dev = torch.device("cuda", 0)
    counted = wrappers()
    makers = {"mixed": mixed_problem, "grouped": grouped_problem}
    std_status = dict(std_status)
    for shape, (chain, n_cams, n_ims, _, _) in MIXED_MODEL_SOLVES.items():
        if shape not in std_status:     # grouped 64 x 12
            std_status[shape] = int(makers[chain](n_cams, n_ims,
                                                  dev).solve().status)
    kern = {}
    for model, a in MODEL_WIDTH.items():
        t_model = time.perf_counter()
        probs = {}
        for shape, (chain, n_cams, n_ims, _, _) in MIXED_MODEL_SOLVES.items():
            probs[shape] = makers[chain](n_cams, n_ims, dev,
                                         camera_model=model)
            check(probs[shape].widths.a == a,
                  f"{model} {shape}: camera width {probs[shape].widths.a}")

        # each kernel on its main path's tensors (the row's numbers), and F
        # at key width 6 also on grouped 16 x 100's, as phase_mixed_kernels
        # holds it at a = 15 (kept in the row as other_shape)
        for shape, (_, _, _, name, cw) in MIXED_MODEL_SOLVES.items():
            rec = kern.setdefault((name, model, cw), {})
            rec.update(builds[(name, model, cw)])
            mixed_model_kernel(f"{model} {shape}", probs[shape], name, rec)
        other = dict(builds[("mixed_gram", model, 6)])
        mixed_model_kernel(f"{model} grouped 16x100", probs["grouped 16x100"],
                           "mixed_gram", other)
        kern[("mixed_gram", model, 6)]["other_shape"] = {
            k: other[k] for k in ("shape", "kernel_ms", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "peak_mib", "abs",
                                  "rel", "scaled", "f32_floor_cases")}

        for shape, (_, _, _, own, cw) in MIXED_MODEL_SOLVES.items():
            prob, tag = probs[shape], f"{model} {shape}"
            with library_solve_spy() as lib_ok:
                res, n_own, _, solve_s = main_path_counts(
                    counted, own, tag, lambda: prob.solve(graph=False))
            lib_misses = sum(not bool(ok) for ok in lib_ok)
            check(len(lib_ok) == res.nit, f"{tag}: {len(lib_ok)} library "
                                          f"solves in {res.nit} LM steps")
            by_width = dict(counted[own].launches_by_width)
            check(by_width[(a, cw)] == n_own == res.nfev and not any(
                n for key, n in by_width.items() if key != (a, cw)),
                f"{tag}: {n_own} launches in {res.nfev} evaluations, by "
                f"(camera width, key width) {by_width}")
            first = prob.solve()                      # captures
            warm_ms = timed(lambda: prob.solve(), 3)
            warm = prob.solve()
            check(same_solve(first, res) and same_solve(warm, res),
                  f"{tag}: the captured solve differs from the uncaptured")
            status, rms = int(res.status), prob.rms_px(res.cost)
            std = std_status[shape]
            check(status_class(status) == status_class(std),
                  f"{tag}: status {status}, the standard model's {std}")
            check(rms <= 0.36, f"{tag}: rms {rms} above 0.36 px")
            pose = group_pose_error(prob, res.x)
            fields = {}
            if model == "tilted" and shape == "mixed 64x12":
                cc.psd_solve.fallbacks = 0
                cc.psd_solve_raw.launches = 0
                with dense_solve_spy() as calls, one_launch_psd(True):
                    res_k = prob.solve(graph=False)
                torch.cuda.synchronize()
                evidence = [fallback_evidence(*c) for c in calls
                            if c[2] is not None]
                n = calls[0][0].shape[0]
                check(n == 64 * a + 12 * 6 + 12, f"{tag}: dense n {n}")
                check(cc.psd_solve_raw.launches == res_k.nit == len(calls)
                      and len(evidence) == cc.psd_solve.fallbacks,
                      f"{tag} (kernel route): {cc.psd_solve_raw.launches} "
                      f"launches, {len(calls)} dense solves, "
                      f"{len(evidence)} fallbacks seen in {res_k.nit} steps")
                check(not any(e["library_passes"] for e in evidence),
                      f"{tag} (kernel route): a fallback on a system that "
                      f"the library route solves within the residual rule")
                rms_k = prob.rms_px(res_k.cost)
                check(rms_k <= 0.36, f"{tag} (kernel route): rms {rms_k}")
                for e in evidence:
                    say("mixed_models_fallback", model=model,
                        shape=shape.replace(" ", "_"),
                        **{k: (f"{v:.6e}" if isinstance(v, float) else v)
                           for k, v in e.items()})
                fields = dict(kernel_route_n=n, kernel_route_nit=res_k.nit,
                              kernel_route_status=int(res_k.status),
                              kernel_route_rms_px=f"{rms_k:.5f}",
                              kernel_route_fallbacks=len(evidence),
                              library_route_nit=res.nit,
                              library_route_residual_misses=lib_misses)
                kern[(own, model, cw)]["kernel_route"] = fields
            kern.setdefault((own, model, cw), {}).setdefault(
                "launches_by_solve", {})[tag] = n_own
            rec = kern[(own, model, cw)]
            rec.setdefault("solve_ms_median", {})[tag] = float(
                np.median(warm_ms))
            say("mixed_models", model=model, shape=shape.replace(" ", "_"),
                a=a, cw=cw, kernel=own, same_bits=True, nit=res.nit,
                nfev=res.nfev, status=status, standard_status=std,
                rms_px=f"{rms:.5f}", n_real=prob.blocks.n_real,
                launches=f"{own}:{n_own}", launches_per_eval=(
                    f"{n_own}/{res.nfev}"),
                library_residual_misses=lib_misses,
                solve_s=f"{solve_s:.3f}",
                solve_ms_median=f"{np.median(warm_ms):.3f}",
                solve_ms_all=",".join(f"{t:.2f}" for t in warm_ms),
                **{k: f"{v:.4f}" for k, v in pose.items()}, **fields)
        del probs
        gc.collect()
        torch.cuda.empty_cache()
        say("elapsed", after=f"mixed_models {model}",
            seconds=f"{time.perf_counter() - t_model:.1f}")
    return kern


# The handler fleets (``problems.fleet_handlers``: bench.py::fleet_problem's
# 64 rigs of 4 cameras, grid 10, as handlers) that [fleet_handlers] solves
# through ``run_fleet_bundle_adjustment``: (chain, images, handler options,
# the one kernel wrapper its main path launches). 16 images take the fused
# family (B, C, E); 12 with ``im_bucket: None`` pad to 16 at tile 8, 33%
# past the rule's 25%: the per-block one (D, F).
FLEET_HANDLERS = {"template 64x4x16": ("template", 16, None,
                                       "template_gram_fused"),
                  "selfcal 64x4x16": ("selfcal", 16, None,
                                      "selfcal_gram_fused"),
                  "grouped 64x4x16": ("grouped", 16, None,
                                      "mixed_gram_fused"),
                  "mixed 64x4x16": ("mixed", 16, None, "mixed_gram_fused"),
                  "selfcal 64x4x12": ("selfcal", 12, {"im_bucket": None},
                                      "selfcal_gram"),
                  "mixed 64x4x12": ("mixed", 12, {"im_bucket": None},
                                    "mixed_gram")}
# [fleet_mixed_kernel]: each of C-F folded over a fleet's 64 rigs, on that
# fleet's tensors: kernel -> (its wrapper, key width, the fleet); the
# grouped 12-image fleet only gives F its key width 6
FLEET_KEY_KERNELS = {"C": ("selfcal_gram_fused", 3, "selfcal 64x4x16"),
                     "D": ("selfcal_gram", 3, "selfcal 64x4x12"),
                     "E9": ("mixed_gram_fused", 9, "mixed 64x4x16"),
                     "E6": ("mixed_gram_fused", 6, "grouped 64x4x16"),
                     "F9": ("mixed_gram", 9, "mixed 64x4x12"),
                     "F6": ("mixed_gram", 6, "grouped 64x4x12")}
FLEET_KEY_LOSSES = (("linear", "component"), ("huber", "observation"))
# [multi_target_handlers]: the two-target handlers through
# run_bundle_adjustment -> (cameras, images, free points, options, the
# kernel wrapper); the bench problem of the same rig and shape is
# problems.{mixed,grouped}_problem
MULTI_TARGET = {"mixed 16x100": (16, 100, True, {}, "mixed_gram_fused"),
                "grouped 16x100": (16, 100, False, {}, "mixed_gram_fused"),
                "mixed 64x12": (64, 12, True, {"im_bucket": None},
                                "mixed_gram")}


def fleet_of(shape: str, dev, camera_model: str = "standard"):
    """A handler fleet of FLEET_HANDLERS' shapes (or "grouped 64x4x12") on
    the card: (its handlers, the HandlerFleet)."""
    from pycamset_tpu_torch.optim.fleet import build_fleet_problem
    from pycamset_tpu_torch.problems import fleet_handlers
    chain, dims = shape.split()
    n_rigs, n_cams, n_ims = map(int, dims.split("x"))
    opts = {"im_bucket": None} if n_ims == 12 else None
    handlers = fleet_handlers(chain, n_rigs, n_cams, n_ims, options=opts,
                              camera_model=camera_model)
    return handlers, build_fleet_problem(handlers, device=dev)


def fleet_key_operands(prob, cw: int, fused: bool):
    """Every rig's per-block operands of a handler fleet at its start (its
    perturbed cameras and poses), the rig axis first, in the wrapper's
    order: self-cal (cw 3) (cam_b, im_b, keyp, uv, mask, [cmask_b,] imask_b,
    kmask), Kernel C without cmask; multi-target (cam_b, im_b, keyp, tpl,
    uv, mask, cmask_b, imask_b, kmask)."""
    import torch
    x, cm = prob.x0_pieces, prob.colmask
    c, i, r = prob.n_cams, prob.n_ims_grid, prob.n_rigs
    keyp, kmask = prob.key_operands(x, cm)
    blocks = (torch.repeat_interleave(x.cam, i, dim=1),
              x.im.repeat(1, c, 1))
    cmask_b = torch.repeat_interleave(cm.cam, i, dim=1)
    imask_b = cm.im.repeat(1, c, 1)
    if cw == 3:
        return (*blocks, keyp, prob.uv, prob.mask,
                *(() if fused else (cmask_b,)), imask_b, kmask)
    tpl = prob.tpl.expand(r, *prob.tpl.shape).contiguous()
    return (*blocks, keyp, tpl, prob.uv, prob.mask, cmask_b, imask_b, kmask)


def fleet_key_kernel(kernel: str, model: str, prob, builds: dict) -> dict:
    """One of Kernels C-F folded over a handler fleet's rigs (ONE launch
    under torch.func.vmap), two losses: each rig's outputs against its
    float64 twin (the twin under vmap) in both measures, within TOL or, where
    the float32 twin on the rig's inputs misses TOL itself, within twice its
    error (``parity_f32_floor``: the case recorded in F32_FLOOR_CASES); each
    rig's bits against a one-rig launch on its slice; the device time of the
    folded launch beside its rigs' one-rig launches, the wrapper's and the
    float32 twin's CUDA-event ms, the bound, registers and spills."""
    import torch
    from types import SimpleNamespace

    from pycamset_tpu_torch.optim import cuda_mixed_grams as mg
    from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
    name, cw, _ = FLEET_KEY_KERNELS[kernel]
    fused = name.endswith("fused")
    r, c, i = prob.n_rigs, prob.n_cams, prob.n_ims_grid
    a = prob.widths.a
    ops = fleet_key_operands(prob, cw, fused)
    extra = (c, i) if fused else ()
    mod = sg if cw == 3 else mg
    wrapper = getattr(mod, name)
    twin = getattr(mod, name + "_plain")
    kw0 = {} if cw == 3 else {"with_key_cols": cw == 9}
    tag = f"{kernel} {model} fleet {r}x{c}x{i}"

    def one(*x, **kw):
        return wrapper(*x, *extra, **kw0, **kw)

    def folded(**kw):
        return torch.func.vmap(lambda *x: one(*x, **kw))(*ops)

    ops64 = tuple(t.double() for t in ops)
    rec = {"abs": 0.0, "rel": 0.0, "scaled": 0.0}
    n_floor = len(F32_FLOOR_CASES)
    for loss, sem in FLEET_KEY_LOSSES:
        kw = dict(loss=loss, f_scale=2.0, loss_semantics=sem)
        n0 = wrapper.launches
        got = folded(**kw)
        check(wrapper.launches == n0 + 1,
              f"{tag}: the folded kernel took more than one launch")
        ref = torch.func.vmap(lambda *x: twin(*x, *extra, **kw0, **kw))(
            *ops64)
        if fused:       # the per-block grams the fused scaling reads
            if cw == 3:
                def gram_of(*x):
                    return sg.selfcal_gram_plain(
                        *x[:5], torch.ones_like(x[0]), *x[5:], **kw)[0]
            else:
                def gram_of(*x):
                    return mg.mixed_gram_plain(*x, **kw0, **kw)[0]
            grams = torch.func.vmap(gram_of)(*ops64)
        for k in range(r):
            rows = [g[k] for g in got]
            refs = [x[k] for x in ref]
            if fused:
                def scaled_of(g, x, gram=grams[k]):
                    return (sg.scaled_errors_selfcal_fused if cw == 3
                            else mg.scaled_errors_mixed_fused)(
                        g, x, gram, c, i)
            else:
                scaled_of = (sg.scaled_errors_selfcal if cw == 3
                             else mg.scaled_errors_mixed)
            e = parity_f32_floor(
                f"{tag} rig {k} {loss}/{sem}", rows, refs,
                scaled_of(rows, refs),
                lambda k=k: twin(*(x[k] for x in ops), *extra, **kw0, **kw),
                scaled_of)
            for key, v in e.items():
                rec[key] = max(rec[key], v)
        say("fleet_mixed_kernel", kernel=kernel, model=model,
            shape=f"{r}x{c}x{i}", loss=loss, semantics=sem, tol=TOL,
            launches=1, worst_rig_max_abs=f"{rec['rel']:.2e}",
            worst_rig_scaled=f"{rec['scaled']:.2e}",
            f32_floor_cases=len(F32_FLOOR_CASES) - n_floor)
        del got, ref
        torch.cuda.empty_cache()
    rec["f32_floor_cases"] = F32_FLOOR_CASES[n_floor:]
    # each rig's bits against a one-rig launch on its slice
    got = folded()
    same = sum(all(torch.equal(g[k], o) for g, o in zip(
        got, one(*(x[k] for x in ops)))) for k in range(r))
    check(same == r, f"{tag}: {r - same} of {r} rigs' bits differ from "
                     f"their one-rig launches")
    # device time: the folded launch, the rigs' one-rig launches
    packed = mg.pack_block_params(fold(ops[0]), fold(ops[1]))
    packed_r = [mg.pack_block_params(ops[0][k], ops[1][k]) for k in range(r)]
    if cw == 3:
        keys, blocks = ops[2], ops[3:-1]
        kmask = ops[-1]
        launch = sg._launch_selfcal_fused if fused else sg._launch_selfcal
    else:
        keys = mg.pack_key_group_data(ops[2][..., :6],
                                      ops[2][..., 6:9] if cw == 9 else ops[3])
        blocks, kmask = ops[4:-1], ops[-1]
        launch = mg._launch_mixed_fused if fused else mg._launch_mixed
    keys = keys.contiguous()
    t = {"kernel_ms": kernel_ms(lambda: launch(
            packed, keys, *(fold(x) for x in blocks), kmask, *extra, 0, 1,
            1.0, a - 6)),
         "one_rig_launches_kernel_ms": kernel_ms(lambda: [
             launch(packed_r[k], keys[k], *(x[k] for x in blocks), kmask[k],
                    *extra, 0, 1, 1.0, a - 6) for k in range(r)]),
         "ms": cuda_ms(folded, 10),
         # host-bound (64 wrapper calls; the plain twin's vmap): two calls
         "one_rig_launches_ms": cuda_ms(lambda: [
             one(*(x[k] for x in ops)) for k in range(r)], 2, warmup=1),
         "plain_ms": cuda_ms(lambda: torch.func.vmap(
             lambda *x: twin(*x, *extra, **kw0))(*ops), 2, warmup=1)}
    bound_prob = SimpleNamespace(
        mask=fold(prob.mask), widths=SimpleNamespace(a=a),
        blocks=SimpleNamespace(n_cams=r * c, n_real=int(prob.n_real.sum())))
    t["bound_ms"], t["bound_by"] = bound(name, bound_prob,
                                         None if cw == 3 else cw, rigs=r)
    res = builds.get((name, model) if cw == 3 else (name, model, cw))
    if res is None:        # the standard model's, from [build]'s report
        from pycamset_tpu_torch._build import load
        regs, spill = ptxas_entry(
            ptxas_resources(load().ptxas_info),
            f"mixed_kernelILi9ELi{cw}ELb{int(fused)}E", False)
        res = {"registers": regs, "spill_bytes": spill}
    check(res["spill_bytes"] == 0, f"{tag}: {res['spill_bytes']} spill "
                                   f"bytes")
    rec.update(t, shape=f"{model} fleet {r}x{c}x{i}", same_bits_rigs=same,
               launches_per_call=1, registers=res["registers"],
               spill_bytes=res["spill_bytes"])
    say("fleet_mixed_kernel", kernel=kernel, model=model,
        shape=f"{r}x{c}x{i}", unit="ms", same_bits_rigs=f"{same}/{r}",
        registers=res["registers"], spill_bytes=res["spill_bytes"],
        **{k: (f"{v:.4f}" if isinstance(v, float) else v)
           for k, v in t.items()})
    del got, ops, ops64, packed, packed_r, keys
    torch.cuda.empty_cache()
    return rec


def phase_fleet_mixed_kernel(fleets: dict, dev, builds: dict) -> dict:
    """[fleet_mixed_kernel]: Kernels C, D, E (cw 9 and 6) and F (cw 9 and
    6) folded over 64 rigs on the handler fleets' own tensors, at the
    standard model (a = 15) and the tilted one (a = 24, the widest)."""
    import torch
    out = {}
    for model in ("standard", "tilted"):
        for kernel, (_, _, shape) in FLEET_KEY_KERNELS.items():
            prob = (fleets[shape][1] if model == "standard" and shape in
                    fleets else fleet_of(shape, dev, model)[1])
            out[(kernel, model)] = fleet_key_kernel(kernel, model, prob,
                                                    builds)
            del prob
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_fleet_handlers(fleets: dict, counted) -> dict:
    """[fleet_handlers]: each handler fleet through
    ``run_fleet_bundle_adjustment`` as its main path (uncaptured, every
    launch count at 0 just before: its kernel alone, one launch per
    evaluation of the batch or a cohort), the fleet's problem solved
    capturing and warm (captured = uncaptured bit for bit, each rig's nit,
    nfev, status and free vector as the main path's), every rig at status
    1-2 and rms <= 0.36 px, the first 4 rigs' costs within 1e-4 of the
    port's float64 CPU fleet of those rigs, rigs/s of warm solves, the
    family the padding rule picked, and rig 0's ``.camset`` written and
    loaded back."""
    import tempfile

    import torch
    from pycamset_tpu_torch.optim.fleet import (build_fleet_problem,
                                                run_fleet_bundle_adjustment)
    from pycamset_tpu_torch.utils.saving import load_CameraSet
    out = {}
    for shape, (chain, n_ims, _, own) in FLEET_HANDLERS.items():
        t_shape = time.perf_counter()
        handlers, prob = fleets[shape]
        r = prob.n_rigs
        (results, camsets), n_own, _, main_s = main_path_counts(
            counted, own, f"fleet_handlers {shape}",
            lambda: run_fleet_bundle_adjustment(handlers,
                                                device=prob.uv.device,
                                                graph=False))
        runners = prob.graph()
        first = prob.solve_batch()                      # captures
        before = {n: g.steps for n, g in runners.items()}
        warm = prob.solve_batch()
        steps = sum(g.steps - before[n] for n, g in runners.items())
        check(same_fleet(first, warm), f"{shape}: two captured solves "
                                       f"differ")
        for k, res in enumerate(results):
            x_k = prob.extract_free(k, prob.rig_result(warm, k).x)
            check((res.nit, res.nfev, res.status)
                  == (warm.nit[k], warm.nfev[k], int(warm.status[k]))
                  and np.array_equal(res.x, x_k),
                  f"{shape} rig {k}: the captured solve differs from the "
                  f"main path's uncaptured one")
        check(n_own == 1 + steps and n_own < sum(warm.nfev),
              f"{shape}: {own} launched {n_own} times in {steps} batch "
              f"steps (+1 slm_init), {sum(warm.nfev)} rig evaluations")
        status = [int(s) for s in warm.status.tolist()]
        rms = prob.rms_px(warm.cost)
        check(all(s in (1, 2) for s in status), f"{shape}: status {status}")
        check(float(rms.max()) <= 0.36, f"{shape}: rms {rms.max():.4f} "
                                        f"above 0.36 px")
        t0 = time.perf_counter()
        cpu = build_fleet_problem(handlers[:4], device="cpu").solve_batch()
        cpu_s = time.perf_counter() - t0
        rel = ((warm.cost[:4].double().cpu() - cpu.cost) / cpu.cost).abs()
        check(float(rel.max()) <= 1e-4, f"{shape}: cost differs from the "
                                        f"float64 CPU fleet by {rel.max()}")
        warm_ms = timed(prob.solve_batch, 3)
        median = float(np.median(warm_ms))
        with tempfile.TemporaryDirectory() as d:
            camsets[0].save(d + "/rig0.camset")
            back = load_CameraSet(d + "/rig0.camset")
        check(back == camsets[0], f"{shape}: rig 0's camset did not load "
                                  f"back")
        family = {"template_gram_fused": "B", "template_gram": "A",
                  "selfcal_gram_fused": "C", "selfcal_gram": "D",
                  "mixed_gram_fused": "E", "mixed_gram": "F"}[own]
        rec = dict(rigs=r, n_real=int(prob.n_real.sum()), family=family,
                   launches=n_own, batch_evaluations=1 + steps,
                   rig_evaluations=sum(warm.nfev),
                   nit_min=min(warm.nit), nit_max=max(warm.nit),
                   status_counts={s: status.count(s)
                                  for s in sorted(set(status))},
                   rms_px_max=f"{rms.max():.5f}",
                   rel_cost_diff_cpu_f64_4_rigs=f"{rel.max():.3e}",
                   cpu_f64_4_rigs_s=f"{cpu_s:.1f}",
                   main_path_s=f"{main_s:.2f}",
                   solve_ms_median=f"{median:.3f}",
                   solve_ms_all=",".join(f"{x:.2f}" for x in warm_ms),
                   rigs_per_s=f"{r / median * 1e3:.1f}",
                   capture_ms=",".join(
                       f"{n}:{runners[n].capture_ms:.1f}"
                       for n in sorted(runners, reverse=True)
                       if runners[n].capture_ms is not None),
                   camset_loaded=True,
                   seconds=f"{time.perf_counter() - t_shape:.1f}")
        say("fleet_handlers", shape=shape.replace(" ", "_"),
            same_bits=True, **rec)
        out[shape] = {"own": own, "launches": n_own,
                      "solve_ms_median": median, "rigs_per_s":
                      r / median * 1e3}
        del results, camsets, first, warm
        torch.cuda.empty_cache()
    return out


def phase_multi_target_handlers(counted, dev) -> dict:
    """[multi_target_handlers]: the two-target handlers of the bench's
    multi-target rig (``problems.multi_target_handler``:
    ``TwoTargetSelfCalibrator`` and ``TwoTargetCalibrator``, the board's
    halves as the targets, seeded through ``set_initial_params``) through
    ``run_bundle_adjustment`` as the main path (uncaptured inside, counts
    at 0 just before: its kernel alone, once an evaluation) -> its CameraSet
    written and loaded back; the handler's problem solved capturing and
    warm (captured = uncaptured bit for bit), status 1-2 and rms <= 0.36
    px, and the warm solve of its problem within 10% of the bench
    problem's at the same shape (``problems.{mixed,grouped}_problem``,
    timed beside it), by ms an evaluation: their iteration counts differ
    (their starts, and the mixed handler's gauge, are not the bench's),
    and the handler's grid has the bucket's 104 images at 16 x 100. The
    handler's ``solve_fn`` (its host round trip of the free vector
    included) is timed beside them."""
    import tempfile

    import torch
    from pycamset_tpu_torch import problems
    from pycamset_tpu_torch.optim import driver
    from pycamset_tpu_torch.optim import structured_driver as sd
    from pycamset_tpu_torch.utils.saving import load_CameraSet
    out = {}
    for shape, (n_cams, n_ims, mixed, opts, own) in MULTI_TARGET.items():
        t_shape = time.perf_counter()
        handler, _ = problems.multi_target_handler(n_cams, n_ims, mixed,
                                                   options=opts)
        build = (sd.build_mixed_structured_problem if mixed
                 else sd.build_structured_problem)
        solve_fn, residual_fn, x0 = build(handler, device=dev)
        cw = 9 if mixed else 6
        zero_counts(counted)
        x_ref, ref = solve_fn(x0, graph=False)
        launches = {name: fn.launches for name, fn in counted.items()}
        by_cw = counted[own].launches_by_cw[cw]
        check(launches[own] == ref.nfev == by_cw and not any(
            n for name, n in launches.items() if name != own),
            f"multi_target_handlers {shape}: {launches} in {ref.nfev} "
            f"evaluations")
        x_first, first = solve_fn(x0)                 # captures
        x_warm, warm = solve_fn(x0)
        check(same_solve(first, ref) and same_solve(warm, ref)
              and np.array_equal(x_first, x_ref)
              and np.array_equal(x_warm, x_ref),
              f"{shape}: the captured solve differs from the uncaptured")
        solve_fn_ms = float(np.median(timed(lambda: solve_fn(x0), 3)))
        rms = solve_fn.problem.rms_px(ref.cost)
        check(int(ref.status) in (1, 2) and rms <= 0.36,
              f"{shape}: status {int(ref.status)}, rms {rms:.4f}")
        bench = (problems.mixed_problem if mixed
                 else problems.grouped_problem)(n_cams, n_ims, dev)
        bench_res = bench.solve()                   # captures
        pieces = solve_fn.pieces(x0)
        warm_ms, bench_ms = timed_pair(
            lambda: solve_fn.problem.solve(x0=pieces), bench.solve, 5)
        median, bench_median = (float(np.median(warm_ms)),
                                float(np.median(bench_ms)))
        eval_ratio = (median / ref.nfev) / (bench_median / bench_res.nfev)
        check(eval_ratio <= 1.10, f"{shape}: {median / ref.nfev:.3f} ms an "
                                  f"evaluation, the bench problem's "
                                  f"{bench_median / bench_res.nfev:.3f}")
        # the user's entry point
        (res, cams), n_user, _, user_s = main_path_counts(
            counted, own, f"multi_target_handlers {shape}",
            lambda: driver.run_bundle_adjustment(handler, device=dev))
        check(res.status in (1, 2), f"{shape}: run_bundle_adjustment "
                                    f"status {res.status}")
        with tempfile.TemporaryDirectory() as d:
            cams.save(d + "/two_target.camset")
            back = load_CameraSet(d + "/two_target.camset")
        check(back == cams, f"{shape}: the camset did not load back")
        rel = handler.get_relative_pose(res.x)
        say("multi_target_handlers", shape=shape.replace(" ", "_"),
            handler=type(handler).__name__, kernel=own, cw=cw,
            n_real=solve_fn.problem.blocks.n_real,
            grid=f"B={solve_fn.problem.mask.shape[0]},"
                 f"K={solve_fn.problem.mask.shape[1]}",
            launches=launches[own], nfev=ref.nfev, nit=ref.nit,
            status=int(ref.status), rms_px=f"{rms:.5f}", same_bits=True,
            solve_ms_median=f"{median:.3f}",
            solve_ms_all=",".join(f"{x:.2f}" for x in warm_ms),
            solve_fn_ms_median=f"{solve_fn_ms:.3f}",
            bench_problem_ms_median=f"{bench_median:.3f}",
            bench_problem_nit=bench_res.nit,
            ms_per_eval=f"{median / ref.nfev:.4f}",
            bench_problem_ms_per_eval=f"{bench_median / bench_res.nfev:.4f}",
            eval_ratio=f"{eval_ratio:.3f}", user_path_launches=n_user,
            user_path_s=f"{user_s:.2f}", user_path_status=res.status,
            group1_rotation_deg=f"{np.degrees(np.arccos(np.clip((np.trace(rel[:3, :3]) - 1) / 2, -1, 1))):.4f}",
            group1_translation_mm=f"{np.linalg.norm(rel[:3, 3]) * 1e3:.4f}",
            camset_loaded=True,
            seconds=f"{time.perf_counter() - t_shape:.1f}")
        out[shape] = {"own": own, "launches": launches[own] + n_user}
        del solve_fn, residual_fn, handler, first, warm, ref, bench
        gc.collect()
        torch.cuda.empty_cache()
    return out


# [tied_user_path]: the tied (shared-intrinsics) backend on the bench rig
# (problems.template_handler with shared_intrinsics) -> (cameras, images,
# the lens groups: True, one lens, or "alternate", the even cameras one and
# the odd ones another; the camera model; the entry a user calls:
# run_stereo_calibration saved ("saved") or not ("stereo"), or
# run_bundle_adjustment with its get_camset ("rba"); the gram wrapper)
TIED = {"tied 16x100": (16, 100, True, "standard", "saved", "template_gram"),
        "tied_g2 16x100": (16, 100, "alternate", "standard", "stereo",
                           "template_gram"),
        "tied_tilted 16x100": (16, 100, True, "tilted", "stereo",
                               "template_gram"),
        "tied 64x400": (64, 400, True, "standard", "rba",
                        "template_gram_fused")}
# [tied_fleet]: fleet_problem's rigs (64 of 4 cameras x 16 images, grid 10)
# with one lens a rig, as template handlers
TIED_FLEET = (64, 4, 16)
# mixed-model rigs: the camera models cycled over the cameras, the widest
# model's camera width (the het rig's: its selector row), its main-path
# shapes -> (cameras, images, the gram wrapper of the template stage, of
# the self-cal stage (None: none), the entry: "saved" run_stereo_calibration
# with the file loaded back, "rba" run_bundle_adjustment)
MIXED_RIGS = {
    "brown_mix": (("standard", "rational", "thin_prism"), 22, {
        "16x100": (16, 100, "template_gram", "selfcal_gram_fused", "saved"),
        "64x400": (64, 400, "template_gram_fused", None, "rba")}),
    "het_rig": (("fisheye", "standard"), 16, {
        "16x100": (16, 100, None, None, "saved")})}
# each camera model's distortion width
DIST_WIDTH = {"fisheye": 4, "standard": 5, "rational": 8, "thin_prism": 12,
              "tilted": 14}


def same_lens_rows(cams, gid) -> bool:
    """Each lens group's cameras carry bit-identical intrinsics and
    distortion."""
    for c, g in enumerate(gid):
        first = int(np.flatnonzero(np.asarray(gid) == g)[0])
        for attr in ("intrinsic", "distortion_coefs"):
            if not np.array_equal(np.asarray(getattr(cams[c], attr)),
                                  np.asarray(getattr(cams[first], attr))):
                return False
    return True


def phase_tied_user_path(counted, dev) -> dict:
    """[tied_user_path]: the tied backend (``optim/shared_intr.py``) at each
    ``TIED`` shape on both dense-solve routes: a ``TemplateBundleHandler``
    whose rig shares its lenses (``problems.template_handler(...,
    shared_intrinsics=...)``, seeded at the bench's start), its problem
    (``build_shared_structured_problem``: a ``TiedProblem``, dense n = G s
    + 6 C) solved uncaptured, capturing and warm (captured = uncaptured,
    its gram kernel once an evaluation by profiler names, the SPD kernel
    once an LM step on the kernel route), then the user's entry as the main
    path (every count 0 just before; its gram kernel alone), its
    parameters the solve's bit for bit, each lens group's cameras
    identical, status 1-2, rms <= 0.36 px; at tied 16x100 the float32 cost
    within 1e-4 of the float64 CPU solve, the file written and loaded
    back. Prints nit, rms and the warm ms an evaluation.

    :return: {shape: {route: {wrapper: main-path launches}}}."""
    import tempfile

    import torch
    from pycamset_tpu_torch.calibration.camera_calibrator import (
        run_stereo_calibration)
    from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
    from pycamset_tpu_torch.optim.problem import TiedProblem
    from pycamset_tpu_torch.optim.shared_intr import (
        build_shared_structured_problem, resolve_lens_groups)
    from pycamset_tpu_torch.problems import template_handler
    from pycamset_tpu_torch.utils.saving import load_CameraSet
    out = {}
    for shape, (n_cams, n_ims, groups, model, entry, own) in TIED.items():
        t_shape = time.perf_counter()
        base, _ = template_handler(
            n_cams, n_ims, camera_model=model,
            shared_intrinsics=(True if groups is True
                               else [c % 2 for c in range(n_cams)]))
        x0 = base.get_initial_params()
        gid = resolve_lens_groups(base.problem_opts["shared_intrinsics"],
                                  base.cam_names)
        inputs_s = time.perf_counter() - t_shape

        def fresh():
            return fresh_template(base, x0)

        cpu = None
        if shape == "tied 16x100":
            t0 = time.perf_counter()
            cpu_fn, _, _ = build_shared_structured_problem(fresh(),
                                                           device="cpu")
            cpu = (cpu_fn(x0)[1], time.perf_counter() - t0)
        out[shape] = {}
        for route in ("library", "kernel"):
            tag = f"tied_user_path {shape} ({route})"
            with one_launch_psd(route == "kernel"):
                t0 = time.perf_counter()
                solve_fn, residual_fn, x_init = (
                    build_shared_structured_problem(fresh(), device=dev))
                torch.cuda.synchronize()
                build_s = time.perf_counter() - t0
                prob = solve_fn.problem
                check(isinstance(prob, TiedProblem),
                      f"{tag}: the problem is a {type(prob).__name__}")
                x_ref, ref, counts, warm, first_s, runner = (
                    solved_through_graph(tag, solve_fn, x_init,
                                         route == "kernel"))
                gram = {n: k for n, k in counts.items()
                        if n.startswith("gram_kernel")}
                check(list(gram.values()) == [warm.nfev],
                      f"{tag}: gram kernels {gram} in {warm.nfev} "
                      f"evaluations")
                warm_ms = timed(lambda: solve_fn(x_init), 3)
                e2e = fresh()
                with tempfile.TemporaryDirectory() as tmp:
                    path = os.path.join(tmp, "cams.camset")
                    if entry == "rba":
                        def run():
                            return run_bundle_adjustment(e2e, device=dev)
                    else:
                        def run():
                            return run_stereo_calibration(
                                None, None, None, param_handler=e2e,
                                save=entry == "saved", save_loc=path,
                                device=dev)
                    result, n_own, n_psd, e2e_s = main_path_counts(
                        counted, own, tag, run)
                    cams = result[1] if entry == "rba" else result
                    if entry == "saved":
                        back = load_CameraSet(path)
                        check(back == cams and np.array_equal(
                            back.calibration_params,
                            cams.calibration_params),
                            f"{tag}: the loaded CameraSet differs")
            x_main = (result[0].x if entry == "rba"
                      else cams.calibration_params)
            check(np.array_equal(x_main, x_ref),
                  f"{tag}: the user entry's parameters differ from the "
                  f"solve's")
            check(same_lens_rows(cams, gid),
                  f"{tag}: a lens group's cameras differ")
            # the other models: [camera_models]' status rule (their lens
            # coefficients trade with the intrinsics on this rig)
            status, rms = int(ref.status), prob.rms_px(ref.cost)
            check(status in (1, 2) if model == "standard" else status > 0,
                  f"{tag}: status {status}")
            check(rms <= 0.36, f"{tag}: rms {rms} above 0.36 px")
            fields = {}
            if cpu is not None:
                rel = (abs(float(ref.cost) - float(cpu[0].cost))
                       / float(cpu[0].cost))
                check(rel <= 1e-4, f"{tag}: cost differs from the float64 "
                                   f"CPU solve by {rel:.3e}")
                fields = dict(cpu_f64_nit=cpu[0].nit,
                              cpu_f64_s=f"{cpu[1]:.1f}",
                              rel_cost_diff_cpu_f64=f"{rel:.3e}")
            median = float(np.median(warm_ms))
            say("tied_user_path", shape=shape.replace(" ", "_"),
                dense_solve=route, model=model,
                groups=int(gid.max()) + 1, dense_n=(
                    (int(gid.max()) + 1) * prob.layout.s + 6 * n_cams),
                same_bits=True, nit=ref.nit, nfev=ref.nfev, status=status,
                rms_px=f"{rms:.5f}", cost=f"{float(ref.cost):.6f}",
                n_real=prob.blocks.n_real, im_grid=prob.blocks.n_ims,
                gram_mb_per_evaluation=f"{4e-6 * sum(gram_io(own, prob)):.1f}",
                **fields, **{f"launches_{k}": v for k, v in counts.items()},
                e2e=entry, e2e_launches=f"{own}:{n_own},psd:{n_psd}",
                capture_ms=f"{runner.capture_ms:.1f}",
                solve_ms_median=f"{median:.3f}",
                ms_per_evaluation=f"{median / warm.nfev:.3f}",
                solve_ms_all=",".join(f"{t:.2f}" for t in warm_ms),
                inputs_s=f"{inputs_s:.2f}", build_s=f"{build_s:.3f}",
                first_solve_s=f"{first_s:.3f}", e2e_s=f"{e2e_s:.3f}",
                seconds=f"{time.perf_counter() - t_shape:.1f}")
            out[shape][route] = {own: n_own, PSD[0]: n_psd}
            del solve_fn, prob, result, cams
        torch.cuda.empty_cache()
    return out


def pinned_columns_zero(tag, prob):
    """The problem's normal equations at its start on the card: every
    camera column its mask pins (a narrower Brown camera's extra
    coefficients, a het rig's selector and pad slots) exact zeros in hcc,
    gc, wci and wck. Returns the pinned count."""
    neq = prob.neq_fn()(prob.x0)
    pinned = prob.colmask.cam == 0
    check(bool(pinned.any()) and all(bool((x == 0).all()) for x in (
        neq.gc[pinned], neq.hcc[pinned], neq.hcc.transpose(1, 2)[pinned],
        neq.wci.transpose(0, 1)[:, pinned], neq.wck.transpose(1, 2)[pinned])),
        f"{tag}: a pinned column is not exact zeros in the normal equations")
    return int(pinned.sum())


def mixed_rig_times(name: str, prob, builds: dict,
                    peak_tflops: float) -> dict:
    """Kernel ``name``'s device time on a mixed-model problem's own tensors
    (A, B at the start, ``camera_model_times``; C moved as
    ``selfcal_inputs`` moves it, its passes under torch.profiler), the
    wrapper's and the float32 twin's CUDA-event ms, the bound, and the
    registers and spills of its build at the widest model's width."""
    from pycamset_tpu_torch.optim import cuda_grams as cg
    from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
    if name.startswith("template"):
        t = camera_model_times(cg, prob, name.endswith("fused"), peak_tflops)
    else:
        n_cams, n_ims = prob.blocks.n_cams, prob.blocks.n_ims
        f32 = selfcal_inputs(prob)
        c32 = (*f32[:5], *f32[6:])
        packed = sg.pack_block_params(*f32[:2])
        iw = prob.widths.a - 6
        t = {"kernel_ms": kernel_ms(lambda: sg._launch_selfcal_fused(
                 packed, *c32[2:], n_cams, n_ims, 0, 1, 1.0, iw)),
             "ms": cuda_ms(lambda: sg.selfcal_gram_fused(*c32, n_cams,
                                                         n_ims), 10),
             "plain_ms": cuda_ms(lambda: sg.selfcal_gram_fused_plain(
                 *c32, n_cams, n_ims), 3)}
        t["bound_ms"], t["bound_by"] = bound(name, prob)
    build = builds[(name, "thin_prism")]
    t.update(registers=build["registers"], spill_bytes=build["spill_bytes"])
    return t


def mixed_rig_solve(tag, handler, own, n_eval_kernels, counted, dev, entry,
                    path=None):
    """One stage of a mixed-model rig: the handler's problem solved
    uncaptured, capturing and warm (``solved_through_graph``: captured =
    uncaptured), its gram kernel by profiler names once an evaluation
    (``own`` None: no gram kernel at all), the warm ms; then the user's
    entry as the main path (its counts zeroed just before: ``own`` alone,
    or no wrapper), its parameters the solve's bit for bit, status 1-2 and
    rms <= 0.36 px. Returns (the entry's result, its handler, the
    record)."""
    import torch
    from pycamset_tpu_torch.calibration.camera_calibrator import (
        run_stereo_calibration)
    from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
    from pycamset_tpu_torch.optim.structured_driver import (
        build_structured_problem)
    x0 = handler.get_initial_params()
    t0 = time.perf_counter()
    solve_fn, _, x_init = build_structured_problem(handler, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    prob = solve_fn.problem
    x_ref, ref, counts, warm, first_s, runner = solved_through_graph(
        tag, solve_fn, x_init, False)
    grams = {n: k for n, k in counts.items()
             if n.split("<")[0] != "psd_solve_kernel"}
    want = {n: warm.nfev for n in n_eval_kernels}
    check(grams == want, f"{tag}: gram kernels {grams} in {warm.nfev} "
                         f"evaluations, {want} expected")
    warm_ms = timed(lambda: solve_fn(x_init), 3)
    e2e = type(handler)(handler.camset, handler.target, handler.detection,
                        options=dict(handler.problem_opts))
    e2e.missing_poses = handler.missing_poses
    e2e.set_initial_params(x0)
    if entry == "rba":
        def run():
            return run_bundle_adjustment(e2e, device=dev)
    else:
        def run():
            return run_stereo_calibration(
                None, None, None, param_handler=e2e, save=path is not None,
                save_loc=path, device=dev)
    result, n_own, _, e2e_s = main_path_counts(counted, own, tag, run)
    x_main = (result[0].x if entry == "rba"
              else result.calibration_params)
    check(np.array_equal(x_main, x_ref),
          f"{tag}: the entry's parameters differ from the solve's")
    status, rms = int(ref.status), prob.rms_px(ref.cost)
    check(status in (1, 2), f"{tag}: status {status}")
    check(rms <= 0.36, f"{tag}: rms {rms} above 0.36 px")
    median = float(np.median(warm_ms))
    return result, e2e, {
        "prob": prob, "ref": ref, "n_own": n_own, "nit": ref.nit,
        "nfev": ref.nfev, "status": status, "rms_px": rms,
        "ms_per_evaluation": median / warm.nfev, "solve_ms_median": median,
        "launches_per_eval": f"{grams}/{warm.nfev}",
        "capture_ms": runner.capture_ms, "build_s": build_s,
        "first_solve_s": first_s, "e2e_s": e2e_s}


def phase_mixed_rigs(kind: str, counted, dev, kern: dict, builds: dict,
                     peak_tflops: float, user_ms: dict) -> tuple[dict, dict]:
    """[brown_mix] and [het_rig]: rigs with one camera model a camera
    (``problems.template_handler(camera_model=[...])``, the models cycled
    over the cameras, the bench's start), through the user's entry points
    on the library route (``MIXED_RIGS``).

    [brown_mix] (standard / rational / thin-prism, a = 22: the thin-prism
    chain, the narrower cameras' extra coefficients pinned): at 16 x 100
    (grid 104) the template stage on Kernel A, saved by
    ``run_stereo_calibration`` and loaded back (distortion widths 5 / 8 /
    12), then the self-cal stage (``problems.selfcal_stage_handler``) on
    Kernel C; at 64 x 400 ``run_bundle_adjustment`` on Kernel B. Each
    kernel on its problem's own tensors against its float64 twin, four
    losses (``camera_model_parity``: A, B at their start;
    ``user_path_parity``: C moved as ``selfcal_inputs`` moves it), recorded
    in ``kern``, and timed (``mixed_rig_times``); the pinned columns exact
    zeros in the normal equations.
    [het_rig] (fisheye / standard in turn, a = 16): the template stage
    saved and loaded back (widths 4 / 5), then the self-cal stage, with no
    gram kernel: the plain closed form, by its chain.

    Each stage: captured = uncaptured, its kernel once an evaluation by
    profiler names (or none), the entry as the main path, status 1-2, rms
    <= 0.36 px, the warm ms an evaluation beside [user_path]'s (``user_ms``,
    the same run);
    at 4 x 100 the float32 cost within 1e-4 relative of the float64 CPU
    solve of the same rig (``cpu_f64_cost_check``).

    :return: ({kernel: {"<kind> <shape> <stage>": main-path launches}},
        {kernel: {"<kind> <shape>": times}})."""
    import tempfile

    import torch
    from pycamset_tpu_torch.optim import cuda_grams as cg
    from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
    from pycamset_tpu_torch.optim.structured import is_het_chain
    from pycamset_tpu_torch.optim.structured_driver import (
        build_structured_problem)
    from pycamset_tpu_torch.problems import (selfcal_stage_handler,
                                             template_handler)
    from pycamset_tpu_torch.utils.saving import load_CameraSet
    cycle, a, shapes = MIXED_RIGS[kind]
    het = kind == "het_rig"
    launches, times = {}, {}

    def models_of(n_cams):
        return [cycle[c % len(cycle)] for c in range(n_cams)]

    for shape, (n_cams, n_ims, own, own_sc, entry) in shapes.items():
        t_shape = time.perf_counter()
        tag = f"{kind} {shape}"
        models = models_of(n_cams)
        handler, rig = template_handler(n_cams, n_ims, camera_model=models)
        inputs_s = time.perf_counter() - t_shape
        prob = build_structured_problem(handler, device=dev)[0].problem
        check(prob.widths.a == a and is_het_chain(prob.op_fun) == het,
              f"{tag}: camera width {prob.widths.a}")
        n_pinned = pinned_columns_zero(tag, prob)
        if own is not None:
            rec = {"f32_floor_cases": []}
            camera_model_parity(cg, tag, prob, own.endswith("fused"), rec)
            record(kern, own, tag, {k: rec[k] for k in ("abs", "rel",
                                                        "scaled")})
            times.setdefault(own, {})[tag] = mixed_rig_times(
                own, prob, builds, peak_tflops)
            say("time", case=f"{own}_{kind}_{shape}", a=a, unit="ms",
                **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                   for k, v in times[own][tag].items()})
        del prob
        iw = a - 6
        kernels = ([] if own is None else [f"gram_kernel<{iw},false>"]
                   if own == "template_gram" else
                   [f"gram_kernel<{iw},true>", f"cam_reduce_kernel<{iw}>"])
        with tempfile.TemporaryDirectory() as tmp:
            path = (os.path.join(tmp, "cams.camset") if entry == "saved"
                    else None)
            result, e2e, st = mixed_rig_solve(
                f"{tag} template stage", handler, own, kernels, counted, dev,
                entry, path)
            fields = {}
            if path is not None:
                back = load_CameraSet(path)
                widths = [np.ravel(c.distortion_coefs).size for c in back]
                check(back == result and widths == [
                    DIST_WIDTH[m] for m in models]
                    and back.calibration_handler.camera_models == models,
                    f"{tag}: the loaded CameraSet differs (widths {widths})")
                fields["file_dist_widths"] = ",".join(
                    str(w) for w in sorted(set(widths)))
        launches.setdefault(own, {})[f"{tag} template stage"] = st["n_own"]
        uniform = user_ms.get((f"template {shape}", "library"))
        say(kind, shape=shape, stage="template", a=a,
            models="/".join(cycle), pinned_columns=n_pinned,
            kernel=own or "none (plain closed form)",
            same_bits=True, nit=st["nit"], nfev=st["nfev"],
            status=st["status"], rms_px=f"{st['rms_px']:.5f}",
            n_real=st["prob"].blocks.n_real, im_grid=st["prob"].blocks.n_ims,
            launches_per_eval=st["launches_per_eval"],
            e2e_launches=f"{own or 'none'}:{st['n_own']}",
            ms_per_evaluation=f"{st['ms_per_evaluation']:.3f}",
            user_path_ms_per_evaluation=(f"{uniform:.3f}" if uniform
                                         else "not measured"),
            solve_ms_median=f"{st['solve_ms_median']:.3f}",
            capture_ms=f"{st['capture_ms']:.1f}", inputs_s=f"{inputs_s:.2f}",
            build_s=f"{st['build_s']:.3f}",
            first_solve_s=f"{st['first_solve_s']:.3f}",
            e2e_s=f"{st['e2e_s']:.3f}", **fields)
        if shape == "16x100":
            # the float64 CPU solve of the same rig at 4 x 100, at the card
            # solve's budget of evaluations: the Brown models' float64 LM
            # crawls on (99 steps, 30.8 s of the card host's CPU)
            h_s, _ = template_handler(4, 100, camera_model=models_of(4))
            x_s = h_s.get_initial_params()
            fn_s, _, xi_s = build_structured_problem(h_s, device=dev)
            ref_s = fn_s(xi_s)[1]
            say(kind, shape="4x100", stage="template", nit=ref_s.nit,
                nfev=ref_s.nfev, status=int(ref_s.status),
                **cpu_f64_cost_check(f"{kind} 4x100", h_s, x_s, ref_s.cost,
                                     max_nfev=ref_s.nfev))
            del h_s, fn_s
        if shape == "16x100":
            # the self-cal stage: the same rig with its board bent
            # BOARD_WARP m RMS (as [selfcal_user_path]'s: on the flat board
            # the template stage's result is already the self-cal optimum,
            # one LM step), its template stage the warm start
            t0 = time.perf_counter()
            hb, rig_b = template_handler(n_cams, n_ims, camera_model=models,
                                         template_warp=BOARD_WARP)
            (res_b, solved), _, _, warm_start_s = main_path_counts(
                counted, own, f"{tag} bent board template stage",
                lambda: run_bundle_adjustment(hb, device=dev))
            tpl_rms = float(np.sqrt(np.mean(res_b.fun ** 2)))
            check(res_b.status in (1, 2),
                  f"{tag}: the bent board's template stage status "
                  f"{res_b.status}")
            sh = selfcal_stage_handler(solved, hb)
            prob_sc = build_structured_problem(sh, device=dev)[0].problem
            check(prob_sc.widths.a == a, f"{tag}: self-cal width")
            n_pinned = pinned_columns_zero(f"{tag} self-cal", prob_sc)
            if own_sc is not None:
                user_path_parity(kern, f"{tag} self-cal", own_sc, prob_sc)
                times.setdefault(own_sc, {})[f"{tag} self-cal"] = (
                    mixed_rig_times(own_sc, prob_sc, builds, peak_tflops))
                say("time", case=f"{own_sc}_{kind}_{shape}_self-cal", a=a,
                    unit="ms", **{
                        k: (f"{v:.4f}" if isinstance(v, float) else v)
                        for k, v in times[own_sc][f"{tag} self-cal"].items()})
            del prob_sc
            kernels = ([] if own_sc is None else
                       [f"mixed_kernel<{iw},3,true>",
                        f"mixed_reduce_kernel<{iw},3,true>"])
            solved_sc, _, sc = mixed_rig_solve(
                f"{tag} self-cal stage", sh, own_sc, kernels, counted, dev,
                "stereo")
            check(sc["rms_px"] <= tpl_rms,
                  f"{tag}: the self-cal stage's rms {sc['rms_px']} above "
                  f"its template stage's {tpl_rms}")
            # the recovered board against the true bent one
            pts = sh.get_updated_target(solved_sc.calibration_params)
            true = rig_b["template_true"]
            err_mm = 1e3 * float(np.sqrt(np.mean(np.sum(
                (pts - true) ** 2, axis=1))))
            nominal_mm = 1e3 * float(np.sqrt(np.mean(np.sum(
                (rig_b["template"] - true) ** 2, axis=1))))
            check(err_mm < nominal_mm,
                  f"{tag}: the recovered board is {err_mm:.3f} mm from the "
                  f"true one, the nominal {nominal_mm:.3f}")
            launches.setdefault(own_sc, {})[f"{tag} self-cal stage"] = (
                sc["n_own"])
            say(kind, shape=shape, stage="self-cal", a=a,
                kernel=own_sc or "none (plain closed form)", same_bits=True,
                board_warp_m=BOARD_WARP, template_stage_rms_px=f"{tpl_rms:.5f}",
                warm_start_s=f"{warm_start_s:.3f}",
                nit=sc["nit"], nfev=sc["nfev"], status=sc["status"],
                rms_px=f"{sc['rms_px']:.5f}", pinned_columns=n_pinned,
                board_rms_mm=f"{err_mm:.4f}",
                nominal_board_rms_mm=f"{nominal_mm:.4f}",
                launches_per_eval=sc["launches_per_eval"],
                e2e_launches=f"{own_sc or 'none'}:{sc['n_own']}",
                ms_per_evaluation=f"{sc['ms_per_evaluation']:.3f}",
                solve_ms_median=f"{sc['solve_ms_median']:.3f}",
                capture_ms=f"{sc['capture_ms']:.1f}",
                e2e_s=f"{sc['e2e_s']:.3f}",
                seconds=f"{time.perf_counter() - t_shape:.1f}")
        del handler, e2e, result, st
        gc.collect()
        torch.cuda.empty_cache()
    launches.pop(None, None)
    return launches, times


def capture_batched_systems(fleet):
    """The (a_n (R, n, n), rhs_n (R, n)) the first batch step of a fleet
    (opt-in on) hands the batched SPD kernel, cloned on the device: the
    op's calls are watched where its vmap rule makes them, on whole
    tensors."""
    from pycamset_tpu_torch.ops import cuda_cholesky as cc
    from pycamset_tpu_torch.optim.fleet import fleet_solve
    seen, orig = [], cc._psd_solve_batched_op

    def spy(a, b, refine):
        if not seen and not cc._batched(a, b):
            seen.append((a.clone(), b.clone()))
        return orig(a, b, refine)

    cc._psd_solve_batched_op = spy
    try:
        with one_launch_psd(True):
            fleet_solve(fleet.neq_fn(), fleet.x0_pieces, fleet.data(),
                        max_nfev=2, ops=fleet.ops, graph=False)
    finally:
        cc._psd_solve_batched_op = orig
    check(bool(seen), "the fleet's step reached no batched SPD solve")
    return seen[0]


def phase_psd_batch(systems: dict) -> dict:
    """[parity_psd_batch] / [time_psd_batch]: the batched SPD kernel on each
    fleet's first reduced batch (``capture_batched_systems``): every system
    meets the residual rule (no fallback) and is within PSD_BATCH_TOL of the
    float64 twin, a repeat launch gives the same bits; device ms of
    the kernel beside the library route's batch (``_cho_refine_solve``
    under vmap: batched ``cholesky_ex`` and three ``cholesky_solve``
    through cuSOLVER), the wrapper's CUDA-event ms, the float32 twin's and
    the bound (``psd_bound`` with the batch)."""
    import torch
    from pycamset_tpu_torch.ops import cuda_cholesky as cc
    from pycamset_tpu_torch.optim.structured import _cho_refine_solve

    def rel(x, ref):
        return (torch.linalg.norm(x.double() - ref, dim=-1)
                / torch.linalg.norm(ref, dim=-1))

    out = {}
    for shape, (a32, b32) in systems.items():
        r, n = b32.shape
        x, res2, b2 = cc.psd_solve_raw_batched(a32, b32)
        x64 = cc.psd_solve_raw_plain_batched(a32.double(), b32.double())[0]
        library = torch.func.vmap(_cho_refine_solve)(a32, b32)
        err, lib_err = rel(x, x64), rel(library, x64)
        misses = int((~cc.residual_ok(res2, b2)).sum())
        check(misses == 0, f"{shape}: {misses} of {r} systems miss the "
                           f"residual rule (res2 > {cc.RES_TOL:g} b2)")
        check(bool((err <= PSD_BATCH_TOL).all()),
              f"{shape}: batched SPD x off the float64 twin: "
              f"{err.max():.3e} > {PSD_BATCH_TOL:g} (library "
              f"{lib_err.max():.3e})")
        again = cc.psd_solve_raw_batched(a32, b32)
        check(all(torch.equal(p, q) for p, q in zip((x, res2, b2), again)),
              f"{shape}: a repeat launch differs")
        rec = dict(rigs=r, n=n, fallbacks=misses,
                   max_rel_err=float(err.max()),
                   library_max_rel_err=float(lib_err.max()),
                   max_abs_err=float((x.double() - x64).abs().max()),
                   max_res2_over_b2=float((res2 / b2).max()))
        say("parity_psd_batch", shape=shape.replace(" ", "_"),
            **{k: (f"{v:.3e}" if isinstance(v, float) else v)
               for k, v in rec.items()})
        dev_ms = device_ms(lambda: cc.psd_solve_raw_batched(a32, b32))
        k_ms = dev_ms.get(CUDA_EVENTS) or sum(
            t for name, t in dev_ms.items()
            if name.startswith("psd_batched_kernel"))
        lib_k_ms = kernel_ms(
            lambda: torch.func.vmap(_cho_refine_solve)(a32, b32))
        lib_ms = cuda_ms(lambda: torch.func.vmap(_cho_refine_solve)(a32, b32),
                         20)
        w_ms = cuda_ms(lambda: cc.psd_solve_raw_batched(a32, b32), 20)
        p_ms = cuda_ms(lambda: cc.psd_solve_raw_plain_batched(a32, b32), 1,
                       warmup=0)
        b_ms, b_by = psd_bound(n, r)
        rec.update(kernel_ms=k_ms, library_kernel_ms=lib_k_ms,
                   library_ms=lib_ms, ms=w_ms, plain_ms=p_ms, bound_ms=b_ms,
                   bound_by=b_by)
        say("time_psd_batch", shape=shape.replace(" ", "_"), rigs=r, n=n,
            kernel_ms=f"{k_ms:.4f}", library_kernel_ms=f"{lib_k_ms:.4f}",
            wrapper_ms=f"{w_ms:.4f}", library_ms=f"{lib_ms:.4f}",
            plain_ms=f"{p_ms:.2f}", bound_ms=f"{b_ms:.5f}", bound_by=b_by,
            kernel_over_bound=f"{k_ms / b_ms:.1f}",
            library_over_kernel=f"{lib_k_ms / k_ms:.2f}")
        out[shape] = rec
    return out


def fleet_route_run(tag, counted, own, run, dev):
    """A fleet's uncaptured run as its main path (``main_path_counts``) with
    the batched SPD kernel's counts at 0 just before: (run's result, own's
    launches, the batched kernel's launches, the systems that fell back,
    the host seconds); checks no one-system SPD launch and, opted in, one
    batched launch a batch step (own's launches less slm_init's) and no
    system that took the library route's x (each fleet here is seeded and
    well posed: a miss is a kernel fault, not a hostile system)."""
    from pycamset_tpu_torch.ops import cuda_cholesky as cc
    cc.reset_batch_counts()
    result, n_own, n_psd, seconds = main_path_counts(counted, own, tag, run)
    n_batch = cc.psd_solve_raw_batched.launches
    fell = int(cc.batch_misses(dev))
    want = n_own - 1 if cc.psd_opted_in() else 0
    check(n_psd == 0 and n_batch == want,
          f"{tag}: {n_batch} batched and {n_psd} one-system SPD launches in "
          f"{n_own - 1} batch steps")
    check(fell == 0, f"{tag}: {fell} systems fell back to the library route")
    return result, n_own, n_batch, fell, seconds


def fleet_captured(tag, prob, ref):
    """A fleet's problem solved capturing and warm, each bit for bit the
    uncaptured ``ref``; every rig at status 1-2 and rms <= 0.36 px.
    Returns (the warm result, its batch steps, warm ms of 3 solves)."""
    runners = prob.graph()
    first = prob.solve_batch()
    before = {n: g.steps for n, g in runners.items()}
    warm = prob.solve_batch()
    steps = sum(g.steps - before.get(n, 0) for n, g in runners.items())
    check(same_fleet(first, ref) and same_fleet(warm, ref),
          f"{tag}: the captured solve differs from the uncaptured")
    status = [int(s) for s in warm.status.tolist()]
    rms = prob.rms_px(warm.cost)
    check(all(s in (1, 2) for s in status), f"{tag}: status {status}")
    check(float(rms.max()) <= 0.36, f"{tag}: rms {rms.max():.4f} above "
                                    f"0.36 px")
    return warm, steps, timed(prob.solve_batch, 3)


def phase_fleet_handlers_psd(fleets: dict, counted) -> dict:
    """The handler fleets on the SPD kernel route: each fleet's batch solved
    uncaptured (one batched launch a batch step, none of the one-system
    kernel), captured = uncaptured, status 1-2, rms <= 0.36 px, the
    systems that fell back, rigs/s."""
    out = {}
    for shape, (_, _, _, own) in FLEET_HANDLERS.items():
        t_shape = time.perf_counter()
        _, prob = fleets[shape]
        tag = f"fleet_handlers_psd {shape}"
        with one_launch_psd(True):
            ref, n_own, n_batch, fell, main_s = fleet_route_run(
                tag, counted, own, lambda: prob.solve_batch(graph=False),
                prob.uv.device)
            warm, steps, warm_ms = fleet_captured(tag, prob, ref)
        median = float(np.median(warm_ms))
        rms = prob.rms_px(warm.cost)
        say("fleet_handlers_psd", shape=shape.replace(" ", "_"),
            same_bits=True, launches=n_own, psd_batched_launches=n_batch,
            fallbacks=fell, nit_max=max(warm.nit),
            status_counts={s: warm.status.tolist().count(s)
                           for s in sorted(set(warm.status.tolist()))},
            rms_px_max=f"{rms.max():.5f}", uncaptured_s=f"{main_s:.2f}",
            solve_ms_median=f"{median:.3f}",
            rigs_per_s=f"{prob.n_rigs / median * 1e3:.1f}",
            seconds=f"{time.perf_counter() - t_shape:.1f}")
        out[shape] = {"own": own, "launches": n_batch, "fallbacks": fell,
                      "rigs_per_s": prob.n_rigs / median * 1e3}
    return out


def phase_tied_fleet(handlers, counted, dev) -> dict:
    """[tied_fleet]: ``run_fleet_bundle_adjustment`` on the tied handlers
    (one lens a rig) as the main path on both routes (uncaptured: Kernel B
    folded, one launch an evaluation of the batch; opted in, one batched
    SPD launch a batch step), its problem captured = uncaptured, every rig
    at status 1-2 and rms <= 0.36 px with its cameras' lens rows identical,
    rigs/s of warm solves."""
    from types import SimpleNamespace

    from pycamset_tpu_torch.optim.fleet import (build_fleet_problem,
                                                run_fleet_bundle_adjustment)
    out = {}
    n_cams = TIED_FLEET[1]
    for route in ("library", "kernel"):
        t_route = time.perf_counter()
        tag = f"tied_fleet ({route})"
        with one_launch_psd(route == "kernel"):
            (results, camsets), n_own, n_batch, fell, main_s = (
                fleet_route_run(tag, counted, "template_gram_fused",
                                lambda: run_fleet_bundle_adjustment(
                                    handlers, device=dev, graph=False), dev))
            prob = build_fleet_problem(handlers, device=dev)
            ref = prob.solve_batch(graph=False)
            warm, steps, warm_ms = fleet_captured(tag, prob, ref)
        check(n_own == 1 + steps, f"{tag}: B launched {n_own} times in "
                                  f"{steps} batch steps (+1 slm_init)")
        for k, res in enumerate(results):
            x_k = prob.extract_free(k, prob.rig_result(warm, k).x)
            check((res.nit, res.nfev, res.status)
                  == (warm.nit[k], warm.nfev[k], int(warm.status[k]))
                  and np.array_equal(res.x, x_k),
                  f"{tag} rig {k}: the captured solve differs from the "
                  f"main path's")
            check(same_lens_rows(camsets[k], [0] * n_cams),
                  f"{tag} rig {k}: the cameras' lenses differ")
        median = float(np.median(warm_ms))
        rms = prob.rms_px(warm.cost)
        status = warm.status.tolist()
        _, n_groups, s = prob.x0_pieces.shared.shape
        folded = SimpleNamespace(
            mask=fold(prob.mask), widths=prob.widths,
            blocks=SimpleNamespace(n_cams=prob.n_rigs * n_cams))
        say("tied_fleet", dense_solve=route, same_bits=True, rigs=prob.n_rigs,
            n_real=int(prob.n_real.sum()), dense_n=n_groups * s + 6 * n_cams,
            gram_mb_per_evaluation=(
                f"{4e-6 * sum(gram_io('template_gram_fused', folded)):.1f}"),
            launches=n_own, psd_batched_launches=n_batch, fallbacks=fell,
            batch_steps=steps, rig_evaluations=sum(warm.nfev),
            nit_min=min(warm.nit), nit_max=max(warm.nit),
            status_counts={s: status.count(s) for s in sorted(set(status))},
            rms_px_max=f"{rms.max():.5f}", main_path_s=f"{main_s:.2f}",
            solve_ms_median=f"{median:.3f}",
            solve_ms_all=",".join(f"{x:.2f}" for x in warm_ms),
            rigs_per_s=f"{prob.n_rigs / median * 1e3:.1f}",
            seconds=f"{time.perf_counter() - t_route:.1f}")
        out[route] = {"launches": n_own, "psd_batched_launches": n_batch,
                      "fallbacks": fell,
                      "rigs_per_s": prob.n_rigs / median * 1e3}
    return out


# [cg_user_path]: the rigs that the JAX rule ("auto": CG above 4096 reduced
# dimensions) sends to the matrix-free CG reduced solver -> the gram
# wrapper of the CG stage
CG_USER = {"template 288x32": "template_gram_fused",
           "selfcal 16x720": "selfcal_gram_fused"}
# a CG stage's final cost at most this much (relative) above the dense
# reduced solve's of the same problem (on an H100 80GB HBM3 at 700 W the
# dome's two rms agree to 5 digits; the sweep's CG cost lies 0.4% under)
CG_COST_TOL = 1e-3
# [fleet_freepoint]: the wand fleets (problems.fleet_handlers("freepoint",
# ...)) -> (images, options, the free-point wrapper)
FLEET_FREEPOINT = {"freepoint 64x4x16": (16, None, "freepoint_gram_fused"),
                   "freepoint 64x4x12": (12, {"im_bucket": None},
                                         "freepoint_gram")}


@contextlib.contextmanager
def cg_spy():
    """Within the block: the iterations of each CG reduced solve
    (``structured.pcg``, which ``_reduced_cg`` looks up at call time; 0-d
    device counts, read after) and the number of dense reduced solves
    (``structured._psd_solve``). Yields {"k": [...], "dense": n}; for
    uncaptured runs."""
    from pycamset_tpu_torch.optim import structured
    rec = {"k": [], "dense": 0}
    pcg, psd = structured.pcg, structured._psd_solve

    def pcg_spy(*args, **kw):
        x, k = pcg(*args, **kw)
        rec["k"].append(k)
        return x, k

    def psd_spy(*args, **kw):
        rec["dense"] += 1
        return psd(*args, **kw)

    structured.pcg, structured._psd_solve = pcg_spy, psd_spy
    try:
        yield rec
    finally:
        structured.pcg, structured._psd_solve = pcg, psd


def device_events(fn):
    """(every device event of one call of fn under torch.profiler, fn's
    result): what a captured solve's replays launch, all of it."""
    events, out = recorded(fn)
    return len(events), out


def cg_stage(tag, handler, own, counted, dev, kern, flag=None):
    """One CG stage of [cg_user_path]: the handler's problem
    (``build_structured_problem``, "auto" -> CG checked), its gram kernel
    ``own`` first held to its float64 twin on the problem's own tensors
    (``user_path_parity``, recorded in ``kern``), then solved uncaptured
    with its counts at 0 (``own`` once an evaluation, no other wrapper) and
    the CG spy (no dense solve; each LM step's iterations), then capturing
    and warm (one capture, one replay a step, both bit for bit the
    uncaptured solve); one replay under torch.profiler: the kernel's passes
    once (one evaluation a step, as uncaptured), no SPD kernel, and every
    device event of the step (a whole warm solve's events overflow the
    profiler's buffers: about 15,000 a step); the warm median, the
    capture's ms, the peak MiB a solve adds; and the same problem with the
    dense reduced solve (library route: n above the SPD kernel's MAX_N),
    captured, for nit, rms and ms an LM step beside CG's; CG's final cost
    at most ``CG_COST_TOL`` above the dense solve's.

    :return: (the record, the uncaptured SLMResult, x of it, residual_fn)."""
    import dataclasses

    import torch
    from pycamset_tpu_torch.optim.structured_driver import (
        build_structured_problem)
    t0 = time.perf_counter()
    solve_fn, residual_fn, x0 = build_structured_problem(handler, device=dev)
    prob = solve_fn.problem
    build_s = time.perf_counter() - t0
    check(prob.reduced_solver == "cg", f"{tag}: 'auto' gave "
                                       f"{prob.reduced_solver!r}, not CG")
    w, n_cams, n_ims = prob.widths, prob.blocks.n_cams, prob.blocks.n_ims
    # the rule's count: a chain without points eliminates its poses
    dims = n_cams * w.a + (0 if w.c == 0 else n_ims * w.b)
    user_path_parity(kern, tag, own, prob)
    with cg_spy() as spy:
        (x_ref, ref), n_own, n_psd, unc_s = main_path_counts(
            counted, own, f"{tag} uncaptured",
            lambda: solve_fn(x0, graph=False))
    iters = [int(k) for k in spy["k"]]
    check(spy["dense"] == 0 and n_psd == 0 and len(iters) == ref.nit,
          f"{tag}: {spy['dense']} dense solves, {n_psd} SPD launches, "
          f"{len(iters)} CG solves in {ref.nit} LM steps")
    check(n_own == ref.nfev, f"{tag}: {own} launched {n_own} times in "
                             f"{ref.nfev} evaluations")
    runner = prob.graph()
    t0 = time.perf_counter()
    x_first, first = solve_fn(x0)                   # captures
    first_s = time.perf_counter() - t0
    graph, replays = runner.graph, runner.replays
    x_warm, warm = solve_fn(x0)
    check(runner.graph is graph and graph is not None
          and runner.replays - replays == warm.nit,
          f"{tag}: not one capture and one replay a step")
    check(same_solve(first, ref) and same_solve(warm, ref)
          and np.array_equal(x_first, x_ref)
          and np.array_equal(x_warm, x_ref),
          f"{tag}: the captured solve differs from the uncaptured")
    counts, _ = solve_kernel_counts(graph.replay)
    n_step_events, _ = device_events(graph.replay)
    if flag is None:        # Kernel B: its two passes
        want = {"gram_kernel<9,true>": 1, "cam_reduce_kernel<9>": 1}
    else:                   # Kernel C: its two passes
        want = {f"mixed_kernel<9,3,{flag}>": 1,
                f"mixed_reduce_kernel<9,3,{flag}>": 1}
    check(counts == want, f"{tag}: one replay launched {counts}, {want} "
                          f"expected")
    base = mib_allocated()
    solve_fn(x0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20 - base
    cg_ms = timed(lambda: solve_fn(x0), 3)
    status, rms = int(ref.status), prob.rms_px(ref.cost)
    check(status in (1, 2), f"{tag}: status {status}")
    check(rms <= 0.36, f"{tag}: rms {rms:.5f} above 0.36 px")
    # the same problem with the dense reduced solve, for comparison
    dense = dataclasses.replace(prob, reduced_solver="dense", graphs={})
    pieces = solve_fn.pieces(x0)
    with cg_spy() as dspy:
        d_first = dense.solve(x0=pieces)
    check(dspy["dense"] > 0 and not dspy["k"],
          f"{tag}: the dense comparison took CG")
    d_ms = timed(lambda: dense.solve(x0=pieces), 3)
    d_med, c_med = float(np.median(d_ms)), float(np.median(cg_ms))
    cost_ratio = float(ref.cost) / float(d_first.cost)
    check(cost_ratio <= 1 + CG_COST_TOL,
          f"{tag}: the CG solve's cost {float(ref.cost)!r} is "
          f"{cost_ratio!r} times the dense solve's {float(d_first.cost)!r}")
    rec = dict(dims=dims, n_real=prob.blocks.n_real,
               im_grid=prob.blocks.n_ims, nit=ref.nit, nfev=ref.nfev,
               status=status, rms_px=f"{rms:.5f}",
               cg_iters_per_step=",".join(map(str, iters)),
               cg_iters_mean=f"{np.mean(iters):.1f}",
               launches_uncaptured=n_own, same_bits=True,
               capture_ms=f"{runner.capture_ms:.1f}",
               device_events_per_replay=n_step_events,
               peak_mib=f"{peak:.1f}", solve_ms_median=f"{c_med:.3f}",
               solve_ms_all=",".join(f"{t:.2f}" for t in cg_ms),
               ms_per_step=f"{c_med / warm.nit:.3f}",
               uncaptured_s=f"{unc_s:.2f}", first_solve_s=f"{first_s:.2f}",
               build_s=f"{build_s:.2f}",
               dense_nit=d_first.nit, dense_status=int(d_first.status),
               dense_rms_px=f"{dense.rms_px(d_first.cost):.5f}",
               cost_over_dense=repr(cost_ratio),
               dense_solve_ms_median=f"{d_med:.3f}",
               dense_ms_per_step=f"{d_med / d_first.nit:.3f}")
    del dense, d_first
    torch.cuda.empty_cache()
    return rec, ref, x_ref, residual_fn


def phase_cg_user_path(counted, dev, kern) -> dict:
    """[cg_user_path]: the two rigs of ``CG_USER`` through the user path
    with the "auto" reduced solver, which resolves to CG by the JAX rule
    (``cg_stage``): a 288-camera dome (``problems.template_handler(288,
    32)``: 4320 camera dimensions, Kernel B) through ``run_stereo_calibration`` (the
    main path: its counts at 0 just before, B alone, no dense solve), its
    file saved and loaded back; a 16-camera, 720-view sweep of a board
    bent ``BOARD_WARP``: the template stage (dense, n = 240, Kernel B: 720
    images pad nothing at tile 16; B first held to its twin on the stage's
    problem) through ``run_stereo_calibration``, then the self-calibration stage
    (``problems.selfcal_stage_handler``: 240 + 720 * 6 = 4560 dimensions,
    Kernel C) through ``run_stereo_calibration`` (C alone, no dense solve),
    the recovered points nearer the true bent board than the nominal grid.
    Each stage's status 1-2, rms <= 0.36 px, the entry point's parameters
    the uncaptured solve's bit for bit.

    :return: {kernel: {solve: launches on its main path}}."""
    import tempfile

    import torch
    from pycamset_tpu_torch.calibration.camera_calibrator import (
        run_stereo_calibration)
    from pycamset_tpu_torch.optim.structured_driver import (
        build_structured_problem)
    from pycamset_tpu_torch.problems import (selfcal_stage_handler,
                                             template_handler)
    from pycamset_tpu_torch.utils.saving import load_CameraSet
    launches = {"template_gram_fused": {}, "selfcal_gram_fused": {}}

    # the dome
    shape = "template 288x32"
    tag = f"cg_user_path {shape}"
    t0 = time.perf_counter()
    th, _ = template_handler(288, 32)
    inputs_s = time.perf_counter() - t0
    rec, ref, x_ref, residual_fn = cg_stage(tag, th, CG_USER[shape],
                                             counted, dev, kern)
    sec = {}
    with tempfile.TemporaryDirectory() as tmp, cg_spy() as spy:
        path = os.path.join(tmp, "dome.camset")
        from pycamset_tpu_torch.models.camera_set import CameraSet
        with timed_method(CameraSet, "save", sec, "save"):
            solved, n_own, _, e2e_s = main_path_counts(
                counted, CG_USER[shape], tag, lambda: run_stereo_calibration(
                    None, None, None, param_handler=th, save=True,
                    save_loc=path, device=dev))
        t0 = time.perf_counter()
        back = load_CameraSet(path)
        load_s = time.perf_counter() - t0
        file_mib = os.path.getsize(path) / 2 ** 20
    check(spy["dense"] == 0, f"{tag}: the main path made a dense solve")
    check(np.array_equal(solved.calibration_params, x_ref),
          f"{tag}: run_stereo_calibration's parameters differ from the "
          f"uncaptured solve's")
    check(back == solved and np.array_equal(back.calibration_params,
                                            solved.calibration_params),
          f"{tag}: the loaded CameraSet differs from the returned")
    say("cg_user_path", shape=shape.replace(" ", "_"), **rec,
        e2e_launches=n_own, inputs_s=f"{inputs_s:.2f}",
        run_stereo_calibration_s=f"{e2e_s:.2f}",
        save_s=f"{sec.get('save', float('nan')):.2f}",
        load_s=f"{load_s:.2f}", file_mib=f"{file_mib:.1f}")
    launches[CG_USER[shape]][f"cg_user_path {shape}"] = n_own
    del th, solved, back
    gc.collect()
    torch.cuda.empty_cache()

    # the sweep: the template stage, then the self-cal stage on CG
    shape = "selfcal 16x720"
    tag = f"cg_user_path {shape}"
    t0 = time.perf_counter()
    th, rig = template_handler(16, 720, template_warp=BOARD_WARP)
    inputs_s = time.perf_counter() - t0
    user_path_parity(kern, f"{tag} template stage", "template_gram_fused",
                     build_structured_problem(th, device=dev)[0].problem)
    solved_t, n_tpl, _, tpl_s = main_path_counts(
        counted, "template_gram_fused", f"{tag} template stage",
        lambda: run_stereo_calibration(None, None, None, param_handler=th,
                                       save=False, device=dev))
    tpl_rms = float(np.sqrt(np.mean(
        np.asarray(solved_t.calibration_result) ** 2)))
    sh = selfcal_stage_handler(solved_t, th)
    rec, ref, x_ref, residual_fn = cg_stage(tag, sh, CG_USER[shape],
                                             counted, dev, kern, flag="true")
    check(float(rec["rms_px"]) <= tpl_rms,
          f"{tag}: rms {rec['rms_px']} above the template stage's "
          f"{tpl_rms:.5f}")
    e2e_h = selfcal_stage_handler(solved_t, th)
    with cg_spy() as spy:
        solved, n_own, _, e2e_s = main_path_counts(
            counted, CG_USER[shape], tag, lambda: run_stereo_calibration(
                None, None, None, param_handler=e2e_h, save=False,
                device=dev))
    check(spy["dense"] == 0, f"{tag}: the main path made a dense solve")
    check(np.array_equal(solved.calibration_params, x_ref),
          f"{tag}: run_stereo_calibration's parameters differ from the "
          f"uncaptured solve's")
    vis = sh.visible_feature_mask
    true = rig["template_true"]
    pts = e2e_h.get_updated_target(x_ref)
    rec_mm, nominal_mm = (1e3 * np.sqrt(np.mean(np.sum(
        (p[vis] - true[vis]) ** 2, axis=1))) for p in (pts, rig["template"]))
    check(bool(np.isfinite(pts).all()) and rec_mm < nominal_mm,
          f"{tag}: recovered points {rec_mm} mm from the true board, the "
          f"nominal grid {nominal_mm} mm")
    say("cg_user_path", shape=shape.replace(" ", "_"), **rec,
        template_stage_rms_px=f"{tpl_rms:.5f}",
        template_stage_launches=f"template_gram_fused:{n_tpl}",
        template_stage_s=f"{tpl_s:.2f}", e2e_launches=n_own,
        inputs_s=f"{inputs_s:.2f}", run_stereo_calibration_s=f"{e2e_s:.2f}",
        points_rms_mm_vs_true=f"{rec_mm:.4f}",
        nominal_rms_mm_vs_true=f"{nominal_mm:.4f}")
    launches["template_gram_fused"][f"cg_user_path {shape} template stage"] = (
        n_tpl)
    launches[CG_USER[shape]][f"cg_user_path {shape}"] = n_own
    return launches


def fleet_freepoint_kernel(prob, own: str) -> dict:
    """A free-point wrapper (over Kernel C or D) folded over a wand fleet's
    rigs (one launch under torch.func.vmap) on the fleet's own tensors at
    its start, every lens column free but one (``freepoint_inputs``), two
    losses: each rig against its float64 twin in both measures
    (``parity_f32_floor``); each rig's bits against its one-rig call; the
    folded launch's device time beside its rigs' one-rig launches, the
    wrapper's and the float32 twin's CUDA-event ms, and the free-point
    function's bound for the rigs' work (``freepoint_bound``)."""
    import torch
    from types import SimpleNamespace

    from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
    fused = own.endswith("fused")
    r, c, i = prob.n_rigs, prob.n_cams, prob.n_ims_grid
    a = prob.widths.a
    x, cm = prob.x0_pieces, prob.colmask
    cmask = cm.cam.clone()
    cmask[..., :a - 6] = 1.0
    cmask[..., 3] = 0.0
    cam_b = torch.repeat_interleave(x.cam, i, dim=1)
    cmask_b = torch.repeat_interleave(cmask, i, dim=1)
    ops = (cam_b, x.key, prob.uv, prob.mask, cmask_b, cm.key)
    wrapper, twin = getattr(sg, own), getattr(sg, own + "_plain")
    tag = f"{own} fleet {r}x{c}x{i}"

    def one(cb, kp, u, m, cmb, km, **kw):
        if fused:
            return wrapper(cb, kp, u, m, km, c, i, **kw)
        return wrapper(cb, kp, u, m, cmb, km, **kw)

    def plain(cb, kp, u, m, cmb, km, **kw):
        if fused:
            return twin(cb, kp, u, m, km, c, i, **kw)
        return twin(cb, kp, u, m, cmb, km, **kw)

    def scaled_of(g, ref):
        if fused:
            return sg.scaled_errors_freepoint_fused(g, ref, c, i)
        return sg.scaled_errors_freepoint(g, ref)

    def folded(**kw):
        return torch.func.vmap(lambda *y: one(*y, **kw))(*ops)

    ops64 = tuple(t.double() for t in ops)
    rec = {"abs": 0.0, "rel": 0.0, "scaled": 0.0}
    n_floor = len(F32_FLOOR_CASES)
    for loss, sem in FLEET_KEY_LOSSES:
        kw = dict(loss=loss, f_scale=2.0, loss_semantics=sem)
        n0 = wrapper.launches
        got = folded(**kw)
        check(wrapper.launches == n0 + 1,
              f"{tag}: the folded kernel took more than one launch")
        for k in range(r):
            rows = [g[k] for g in got]
            refs = plain(*(y[k] for y in ops64), **kw)
            e = parity_f32_floor(
                f"{tag} rig {k} {loss}/{sem}", rows, refs,
                scaled_of(rows, refs),
                lambda k=k: plain(*(y[k] for y in ops), **kw), scaled_of)
            for key, v in e.items():
                rec[key] = max(rec[key], v)
        say("fleet_freepoint_kernel", wrapper=own, shape=f"{r}x{c}x{i}",
            loss=loss, semantics=sem, tol=TOL, launches=1,
            worst_rig_max_abs=f"{rec['rel']:.2e}",
            worst_rig_scaled=f"{rec['scaled']:.2e}",
            f32_floor_cases=len(F32_FLOOR_CASES) - n_floor)
        del got
        torch.cuda.empty_cache()
    rec["f32_floor_cases"] = F32_FLOOR_CASES[n_floor:]
    got = folded()
    same = sum(all(torch.equal(g[k], o) for g, o in zip(
        got, one(*(y[k] for y in ops)))) for k in range(r))
    check(same == r, f"{tag}: {r - same} of {r} rigs' bits differ from "
                     f"their one-rig calls")
    del got
    im0 = cam_b.new_zeros((r * c * i, 6))
    packed = sg.pack_block_params(fold(cam_b), im0)
    packed_r = [sg.pack_block_params(cam_b[k], im0[:c * i])
                for k in range(r)]
    keyp, kmask = x.key.contiguous(), cm.key.contiguous()
    uv_f, mask_f, cmask_f = fold(prob.uv), fold(prob.mask), fold(cmask_b)
    if fused:
        def launch_all():
            return sg._launch_selfcal_fused(packed, keyp, uv_f, mask_f, im0,
                                            kmask, c, i, 0, 1, 1.0, a - 6)

        def launch_one(k):
            return sg._launch_selfcal_fused(
                packed_r[k], keyp[k], prob.uv[k], prob.mask[k],
                im0[:c * i], kmask[k], c, i, 0, 1, 1.0, a - 6)
    else:
        def launch_all():
            return sg._launch_selfcal(packed, keyp, uv_f, mask_f, cmask_f,
                                      im0, kmask, 0, 1, 1.0, a - 6)

        def launch_one(k):
            return sg._launch_selfcal(
                packed_r[k], keyp[k], prob.uv[k], prob.mask[k], cmask_b[k],
                im0[:c * i], kmask[k], 0, 1, 1.0, a - 6)
    t = {"kernel_ms": kernel_ms(launch_all),
         "one_rig_launches_kernel_ms": kernel_ms(
             lambda: [launch_one(k) for k in range(r)]),
         "ms": cuda_ms(folded, 5),
         "one_rig_launches_ms": cuda_ms(lambda: [
             one(*(y[k] for y in ops)) for k in range(r)], 2),
         "plain_ms": cuda_ms(lambda: torch.func.vmap(plain)(*ops), 2)}
    bound_prob = SimpleNamespace(
        mask=fold(prob.mask), widths=SimpleNamespace(a=a),
        blocks=SimpleNamespace(n_cams=r * c, n_real=int(prob.n_real.sum())))
    t["bound_ms"], t["bound_by"] = freepoint_bound(own, bound_prob, rigs=r)
    rec.update(t, shape=f"fleet {r}x{c}x{i}", same_bits_rigs=same,
               launches_per_call=1)
    say("fleet_freepoint_kernel", wrapper=own, shape=f"{r}x{c}x{i}",
        unit="ms", same_bits_rigs=f"{same}/{r}",
        **{k: (f"{v:.4f}" if isinstance(v, float) else v)
           for k, v in t.items()})
    del ops, ops64, packed, packed_r
    torch.cuda.empty_cache()
    return rec


def phase_fleet_freepoint(counted, dev) -> dict:
    """[fleet_freepoint]: the wand fleets of ``FLEET_FREEPOINT``
    (``problems.fleet_handlers("freepoint", 64, 4, n)``: 64 rigs, seeds
    100 + r, each image's points free, the wand's gauge), the free-point
    wrapper folded over the rigs first (``fleet_freepoint_kernel``), then
    ``run_fleet_bundle_adjustment(graph=False)`` as the main path (its
    counts at 0 just before: the wrapper alone, one launch per evaluation
    of the batch), the fleet captured (= the main path's per-rig results
    bit for bit), every rig at status 1-2 and rms <= 0.36 px, the first 4
    rigs' costs within 1e-4 of the port's float64 CPU fleet, rigs/s of the
    warm batch beside the 64 rigs solved one by one (each its own
    ``build_structured_problem``, captured, warm).

    :return: {shape: {"own", "launches", "kernel": the folded record,
        ...}}."""
    import torch
    from pycamset_tpu_torch.optim.fleet import (build_fleet_problem,
                                                run_fleet_bundle_adjustment)
    from pycamset_tpu_torch.optim.structured_driver import (
        build_structured_problem)
    from pycamset_tpu_torch.problems import fleet_handlers
    out = {}
    for shape, (n_ims, opts, own) in FLEET_FREEPOINT.items():
        t_shape = time.perf_counter()
        tag = f"fleet_freepoint {shape}"
        handlers = fleet_handlers("freepoint", 64, 4, n_ims, options=opts)
        prob = build_fleet_problem(handlers, device=dev)
        setup_s = time.perf_counter() - t_shape
        kern = fleet_freepoint_kernel(prob, own)
        (results, _), n_own, n_psd, main_s = main_path_counts(
            counted, own, tag, lambda: run_fleet_bundle_adjustment(
                handlers, device=dev, graph=False))
        runners = prob.graph()
        first = prob.solve_batch()
        before = {n: g.steps for n, g in runners.items()}
        warm = prob.solve_batch()
        steps = sum(g.steps - before[n] for n, g in runners.items())
        check(same_fleet(first, warm), f"{tag}: two captured solves differ")
        for k, res in enumerate(results):
            x_k = prob.extract_free(k, prob.rig_result(warm, k).x)
            check((res.nit, res.nfev, res.status)
                  == (warm.nit[k], warm.nfev[k], int(warm.status[k]))
                  and np.array_equal(res.x, x_k),
                  f"{tag} rig {k}: the captured solve differs from the "
                  f"main path's uncaptured one")
        check(n_own == 1 + steps and n_own < sum(warm.nfev) and n_psd == 0,
              f"{tag}: {own} launched {n_own} times in {steps} batch steps "
              f"(+1 slm_init), {sum(warm.nfev)} rig evaluations")
        status = [int(s) for s in warm.status.tolist()]
        rms = prob.rms_px(warm.cost)
        check(all(s in (1, 2) for s in status), f"{tag}: status {status}")
        check(float(rms.max()) <= 0.36, f"{tag}: rms {rms.max():.4f} above "
                                        f"0.36 px")
        t0 = time.perf_counter()
        cpu = build_fleet_problem(handlers[:4], device="cpu").solve_batch()
        cpu_s = time.perf_counter() - t0
        rel = ((warm.cost[:4].double().cpu() - cpu.cost) / cpu.cost).abs()
        check(float(rel.max()) <= 1e-4, f"{tag}: cost differs from the "
                                        f"float64 CPU fleet by {rel.max()}")
        warm_ms = timed(prob.solve_batch, 3)
        median = float(np.median(warm_ms))
        # the same rigs one by one: each its own problem, captured, warm
        solos = []
        for h in handlers:
            fn, _, x0 = build_structured_problem(h, device=dev)
            fn(x0)
            solos.append((fn, x0))
        one_ms = timed(lambda: [fn(x0) for fn, x0 in solos], 1)
        del solos
        rec = dict(rigs=prob.n_rigs, n_real=int(prob.n_real.sum()),
                   keys=prob.mask.shape[2], im_grid=prob.n_ims_grid,
                   launches=n_own, batch_evaluations=1 + steps,
                   rig_evaluations=sum(warm.nfev), nit_min=min(warm.nit),
                   nit_max=max(warm.nit),
                   status_counts={s: status.count(s)
                                  for s in sorted(set(status))},
                   rms_px_max=f"{rms.max():.5f}",
                   rel_cost_diff_cpu_f64_4_rigs=f"{rel.max():.3e}",
                   cpu_f64_4_rigs_s=f"{cpu_s:.1f}",
                   main_path_s=f"{main_s:.2f}",
                   solve_ms_median=f"{median:.3f}",
                   solve_ms_all=",".join(f"{t:.2f}" for t in warm_ms),
                   rigs_per_s=f"{prob.n_rigs / median * 1e3:.1f}",
                   one_by_one_ms=f"{one_ms[0]:.3f}",
                   one_by_one_rigs_per_s=(
                       f"{prob.n_rigs / one_ms[0] * 1e3:.1f}"),
                   capture_ms=",".join(
                       f"{n}:{runners[n].capture_ms:.1f}"
                       for n in sorted(runners, reverse=True)
                       if runners[n].capture_ms is not None),
                   setup_s=f"{setup_s:.1f}",
                   seconds=f"{time.perf_counter() - t_shape:.1f}")
        say("fleet_freepoint", shape=shape.replace(" ", "_"), same_bits=True,
            **rec)
        out[shape] = {"own": own, "launches": n_own, "kernel": kern,
                      "rigs_per_s": prob.n_rigs / median * 1e3,
                      "one_by_one_rigs_per_s": prob.n_rigs / one_ms[0] * 1e3}
        del results, first, warm, prob, handlers
        gc.collect()
        torch.cuda.empty_cache()
    return out


# [generic] and [uncertainty]: the generic backend, make_optimisation_function,
# the scipy backend and calibration uncertainty, which reach no kernel of
# the port (the JAX package computes them in XLA and host scipy, with no
# pl.pallas_call): plain PyTorch on the card, float32, held to the same
# code in float64 on the card (itself held to the float64 CPU run at a
# small size, ``small_f64_ties``) and to the structured solve
GENERIC_COST_TOL = 1e-4
SIGMA_TOL = 1e-2
# [generic]: the scipy backend's rig (its lenses fixed: with free lenses
# scipy's TRF stops at max_nfev on these rigs, tests/test_scipy_parity.py)
SCIPY_SHAPE = (16, 24)


def sync(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def peak_mib(dev, base_mib: float) -> float:
    """Peak device MiB above ``base_mib`` since ``mib_allocated()``."""
    import torch
    if torch.device(dev).type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated() / 2 ** 20 - base_mib


def generic_inputs(dev):
    """{name: fresh handler maker} of [generic]: the template user path
    16x100 (grouped layout) and the bent board's self-cal stage 16x100
    (scatter layout), the latter after its template stage on the
    structured backend (Kernel A)."""
    from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
    from pycamset_tpu_torch.problems import (selfcal_stage_handler,
                                             template_handler)
    tpl, _ = template_handler(16, 100)
    x_tpl = tpl.get_initial_params()
    bent, _ = template_handler(16, 100, template_warp=BOARD_WARP)
    _, stage = run_bundle_adjustment(bent, device=dev)
    return {"template 16x100": lambda: fresh_template(tpl, x_tpl),
            "selfcal 16x100": lambda: selfcal_stage_handler(stage, bent)}


def small_f64_ties(dev) -> dict:
    """The card's float64 run of the generic path against the CPU's (the
    port's float64 CPU run is held to the JAX package by
    tests/test_torch_generic.py and tests/test_torch_uncertainty.py) at
    3 x 8, grid 6: the template and self-cal generic solves (same nit, nfev,
    status; cost within 1e-9), make_optimisation_function's CSR (same
    structure, data within 1e-9 of max-abs) and the uncertainty (1e-6)."""
    import torch
    from pycamset_tpu_torch.optim.driver import (make_optimisation_function,
                                                 run_bundle_adjustment)
    from pycamset_tpu_torch.optim.uncertainty import calibration_uncertainty
    from pycamset_tpu_torch.problems import (selfcal_stage_handler,
                                             template_handler)
    f64 = torch.float64
    out = {}
    tpl, _ = template_handler(3, 8, grid=6)
    x0 = tpl.get_initial_params()
    bent, _ = template_handler(3, 8, grid=6, template_warp=BOARD_WARP)
    _, stage = run_bundle_adjustment(bent, device="cpu")
    makers = {"template": lambda: fresh_template(tpl, x0),
              "selfcal": lambda: selfcal_stage_handler(stage, bent)}
    for name, make in makers.items():
        cpu, cams = run_bundle_adjustment(make(), backend="generic",
                                          device="cpu")
        card, _ = run_bundle_adjustment(make(), backend="generic",
                                        device=dev, dtype=f64)
        rel = abs(card.cost - cpu.cost) / cpu.cost
        check(card.status in (1, 2) and cpu.status in (1, 2)
              and rel <= 1e-9,
              f"generic small {name}: card float64 status {card.status}, "
              f"the CPU's {cpu.status}, cost {rel:.2e}")
        _, jc, xc = make_optimisation_function(make(), device="cpu")
        _, jg, _ = make_optimisation_function(make(), device=dev, dtype=f64)
        a, b = jc(cpu.x), jg(cpu.x)
        jac_err = float(np.abs(a.data - b.data).max() / np.abs(a.data).max())
        check(np.array_equal(a.indptr, b.indptr)
              and np.array_equal(a.indices, b.indices) and jac_err <= 1e-9,
              f"generic small {name}: the card's float64 CSR differs "
              f"({jac_err:.2e})")
        u_cpu = calibration_uncertainty(cams, device="cpu")
        u_card = calibration_uncertainty(cams, device=dev, dtype=f64)
        unc_err = sigma_errors(u_card, u_cpu)["max_rel"]
        check(unc_err <= 1e-6, f"generic small {name}: card float64 "
                               f"sigmas {unc_err:.2e} from the CPU's")
        out[name] = {"cost_rel": rel, "jac_rel": jac_err,
                     "sigma_rel": unc_err,
                     "nit_card_cpu": f"{card.nit}/{cpu.nit}",
                     "nfev_card_cpu": f"{card.nfev}/{cpu.nfev}"}
    return out


def generic_case(name, make, dev, counted) -> dict:
    """One [generic] problem: ``run_bundle_adjustment(backend="generic")``
    on the card as the main path (no gram kernel launched), the layout
    (``build_solver``), a warm solve timed by CUDA events (ms an LM step =
    its ms / its nit), the host reads of that solve, its peak MiB; its cost
    against the structured solve on the card and the float64 generic
    solve on the card, each within GENERIC_COST_TOL."""
    import torch
    from pycamset_tpu_torch.optim import lm
    from pycamset_tpu_torch.optim.driver import (build_solver,
                                                 run_bundle_adjustment)
    tag = f"generic {name}"
    zero_counts(counted)
    t0 = time.perf_counter()
    res, cams = run_bundle_adjustment(make(), backend="generic", device=dev)
    main_s = time.perf_counter() - t0
    launched = {k: fn.launches for k, fn in counted.items() if fn.launches}
    check(not launched, f"{tag}: the generic path launched {launched}")
    n_real = res.fun.size // 2
    rms = float(np.sqrt(2.0 * res.cost / res.fun.size))
    check(res.status in (1, 2) and rms <= 0.36,
          f"{tag}: status {res.status}, rms {rms:.5f}")
    solve_fn, _, x0 = build_solver(make(), device=dev)
    base = mib_allocated()
    lm.host_reads = 0
    # float32 sums in the scatter's atomic order: a solve's steps may differ
    # from another's by one (its ms an LM step is its own)
    box = {}
    ms = timed(lambda: box.setdefault("res", solve_fn(x0)[1]), 1,
               warmup=0)[0]
    nit = int(box["res"].nit)
    reads = lm.host_reads
    peak = peak_mib(dev, base)
    structured, solved = run_bundle_adjustment(make(), device=dev)
    f64, _ = run_bundle_adjustment(make(), backend="generic", device=dev,
                                   dtype=torch.float64)
    rel_s = abs(res.cost - structured.cost) / structured.cost
    rel_64 = abs(res.cost - f64.cost) / f64.cost
    check(rel_s <= GENERIC_COST_TOL and rel_64 <= GENERIC_COST_TOL,
          f"{tag}: cost {rel_s:.2e} from the structured solve, "
          f"{rel_64:.2e} from the float64 one")
    rec = {"layout": solve_fn.layout,
           "shape": "x".join(map(str, solve_fn.shape)),
           "n_free": len(x0), "n_real": n_real, "status": res.status,
           "nit": res.nit, "nfev": res.nfev, "rms": f"{rms:.5f}",
           "timed_nit": nit, "solve_ms": f"{ms:.1f}",
           "ms_per_step": f"{ms / nit:.2f}",
           "host_reads": reads, "peak_mib": f"{peak:.0f}",
           "main_path_s": f"{main_s:.2f}",
           "structured_nit": structured.nit,
           "rel_cost_structured": f"{rel_s:.3e}",
           "f64_nit": f64.nit, "rel_cost_f64": f"{rel_64:.3e}"}
    say("generic", case=name.replace(" ", "_"), **rec)
    return rec, solved


def csr_case(make, dev) -> dict:
    """make_optimisation_function at 16x100: loss_fn and jac_fn ms (host
    wall clock: they return numpy; the median of 3 after one warm-up), the
    CSR against the float64 one on the card (same structure, data within
    GENERIC_COST_TOL of max-abs)."""
    import torch
    from pycamset_tpu_torch.optim.driver import make_optimisation_function
    loss_fn, jac_fn, x0 = make_optimisation_function(make(), device=dev)

    def wall_ms(fn):
        fn(x0)
        times = []
        for _ in range(3):
            sync(dev)
            t0 = time.perf_counter()
            fn(x0)
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    loss_ms, jac_ms = wall_ms(loss_fn), wall_ms(jac_fn)
    _, jac64, _ = make_optimisation_function(make(), device=dev,
                                             dtype=torch.float64)
    a, b = jac_fn(x0), jac64(x0)
    err = float(np.abs(a.data - b.data).max() / np.abs(b.data).max())
    check(np.array_equal(a.indptr, b.indptr)
          and np.array_equal(a.indices, b.indices) and err <= TOL,
          f"make_optimisation_function: CSR data {err:.2e} from float64")
    rec = {"loss_ms": f"{loss_ms:.1f}", "jac_ms": f"{jac_ms:.1f}",
           "nnz": a.nnz, "shape": "x".join(map(str, a.shape)),
           "max_abs_err_rel": f"{err:.3e}"}
    say("generic", case="make_optimisation_function_16x100", **rec)
    return rec


def scipy_case(dev) -> dict:
    """``backend="scipy"`` on ``template_handler(16, 24,
    fixed_lenses=True)``: converged (scipy's status 1-4), rms <= 0.36 px,
    the cost within
    GENERIC_COST_TOL of the generic solve's of the same handler."""
    from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
    from pycamset_tpu_torch.problems import template_handler
    base, _ = template_handler(*SCIPY_SHAPE, fixed_lenses=True)
    x0 = base.get_initial_params()
    t0 = time.perf_counter()
    res, _ = run_bundle_adjustment(fresh_template(base, x0), backend="scipy",
                                   device=dev)
    scipy_s = time.perf_counter() - t0
    gen, _ = run_bundle_adjustment(fresh_template(base, x0),
                                   backend="generic", device=dev)
    rms = float(np.sqrt(2.0 * res.cost / res.fun.size))
    rel = abs(res.cost - gen.cost) / gen.cost
    # scipy's codes: 1 gtol, 2 ftol, 3 xtol, 4 ftol and xtol (0: max_nfev)
    check(res.status in (1, 2, 3, 4) and rms <= 0.36
          and rel <= GENERIC_COST_TOL,
          f"scipy 16x24: status {res.status}, rms {rms:.5f}, cost {rel:.2e} "
          f"from the generic solve")
    rec = {"status": res.status, "nfev": res.nfev, "rms": f"{rms:.5f}",
           "seconds": f"{scipy_s:.2f}", "generic_nfev": gen.nfev,
           "rel_cost_generic": f"{rel:.3e}"}
    say("generic", case="scipy_16x24_fixed_lenses", **rec)
    return rec


def phase_generic(dev, counted) -> dict:
    """[generic]: small_f64_ties, then the two 16x100 problems
    (generic_case), make_optimisation_function (csr_case) and the scipy
    backend (scipy_case).

    :return: (records, {name: the CameraSet of its structured solve})."""
    t0 = time.perf_counter()
    ties = small_f64_ties(dev)
    say("generic", case="small_f64_ties", **{
        f"{k}_{m}": v if isinstance(v, str) else f"{v:.2e}"
        for k, r in ties.items() for m, v in r.items()},
        seconds=f"{time.perf_counter() - t0:.1f}")
    makers = generic_inputs(dev)
    out, solved = {}, {}
    for name, make in makers.items():
        out[name], solved[name] = generic_case(name, make, dev, counted)
    out["csr"] = csr_case(makers["template 16x100"], dev)
    out["scipy"] = scipy_case(dev)
    return out, solved


def sigma_errors(got: dict, ref: dict) -> dict:
    """Entry-by-entry relative errors of every camera, pose, point and
    extra sigma of ``got`` against ``ref`` (fixed entries: zero in both)."""
    check(got.keys() == ref.keys() and got["dof"] == ref["dof"],
          "uncertainty: different fields or dof")
    pairs = [(got[k], ref[k]) for k in ("pose_sigma", "point_sigma",
                                         "extra_sigma") if k in ref]
    for name, cam in ref["cameras"].items():
        pairs += [(got["cameras"][name][f], cam[f])
                  for f in ("int_sigma", "ext_sigma")]
    g = np.concatenate([np.ravel(a) for a, _ in pairs])
    r = np.concatenate([np.ravel(b) for _, b in pairs])
    check(np.array_equal(g == 0.0, r == 0.0),
          "uncertainty: the zero (fixed) entries differ")
    live = r > 0
    rel = np.abs(g[live] - r[live]) / r[live]
    return {"max_rel": float(rel.max(initial=0.0)),
            "median_rel": float(np.median(rel)) if rel.size else 0.0,
            "n_sigmas": int(live.sum())}


@contextlib.contextmanager
def evaluation_clock():
    """Within the block: the seconds spent in make_optimisation_function's
    loss_fn and jac_fn (the card's evaluation, its copy back and the CSR
    packing), which ``uncertainty._weighted_r_jac`` looks up at call
    time."""
    from pycamset_tpu_torch.optim import driver
    rec = {"s": 0.0}
    mof = driver.make_optimisation_function

    def timed_mof(*args, **kw):
        loss_fn, jac_fn, x0 = mof(*args, **kw)

        def clocked(fn):
            def run(x):
                t0 = time.perf_counter()
                out = fn(x)
                rec["s"] += time.perf_counter() - t0
                return out
            return run
        return clocked(loss_fn), clocked(jac_fn), x0

    driver.make_optimisation_function = timed_mof
    try:
        yield rec
    finally:
        driver.make_optimisation_function = mof


def uncertainty_inputs(dev) -> dict:
    """{name: solved CameraSet} of [uncertainty] beside [generic]'s (the
    template and self-cal user paths at 16x100): the tied (one lens) user
    path at 16x100 and the free-point user path at 64x12, each solved on
    the structured backend on the card."""
    from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
    from pycamset_tpu_torch.problems import (freepoint_handler,
                                             template_handler)
    out = {}
    tied, _ = template_handler(16, 100, shared_intrinsics=True)
    _, out["tied 16x100"] = run_bundle_adjustment(tied, device=dev)
    fp, _ = freepoint_handler(64, 12)
    _, out["freepoint 64x12"] = run_bundle_adjustment(fp, device=dev)
    return out


def uncertainty_route(cams, unc) -> str:
    from pycamset_tpu_torch.optim import uncertainty
    handler = cams.calibration_handler
    if handler.problem_opts.get("shared_intrinsics"):
        return "tied"
    n_free = int(handler.bundlePrimitive.unfixed_full().sum())
    if n_free <= uncertainty.DENSE_COV_MAX_PARAMS:
        return "dense"
    return "schur" if "point_sigma" in unc else "lu_head_only"


def uncertainty_case(name, cams, dev, in_memory=None) -> tuple[dict, dict]:
    """One [uncertainty] CameraSet: its sigmas on the card (float32; route,
    n_free, sigma2, dof, the evaluation's and the host's seconds, peak
    MiB) against the same code in float64 on the card: within SIGMA_TOL
    relative, or, where the float32 CPU twin itself misses SIGMA_TOL,
    within twice the twin's error (a float32-floor case, named). With
    ``in_memory`` (the sigmas of the CameraSet that was saved) they must
    be those, bit for bit, instead."""
    import torch
    from pycamset_tpu_torch.optim.uncertainty import calibration_uncertainty
    base = mib_allocated()
    with evaluation_clock() as clock:
        t0 = time.perf_counter()
        unc = calibration_uncertainty(cams, device=dev)
        total_s = time.perf_counter() - t0
    peak = peak_mib(dev, base)
    rec = {"route": uncertainty_route(cams, unc),
           "n_free": int(cams.calibration_handler.bundlePrimitive
                         .unfixed_full().sum()),
           "sigma2": f"{unc['sigma2']:.6f}", "dof": unc["dof"],
           "device_s": f"{clock['s']:.2f}",
           "host_s": f"{total_s - clock['s']:.2f}",
           "peak_mib": f"{peak:.0f}", "points": "point_sigma" in unc}
    if in_memory is not None:
        same = sigma_errors(unc, in_memory)["max_rel"]
        check(same == 0.0 and unc["sigma2"] == in_memory["sigma2"],
              f"uncertainty {name}: {same:.2e} from the in-memory sigmas")
        rec["rel_err_in_memory"] = f"{same:.1e}"
        say("uncertainty", case=name.replace(" ", "_"), **rec)
        return rec, unc
    ref = calibration_uncertainty(cams, device=dev, dtype=torch.float64)
    err = sigma_errors(unc, ref)
    rec.update(sigma2_f64=f"{ref['sigma2']:.6f}", n_sigmas=err["n_sigmas"],
               max_rel_err=f"{err['max_rel']:.3e}",
               median_rel_err=f"{err['median_rel']:.3e}")
    if err["max_rel"] > SIGMA_TOL:
        twin = calibration_uncertainty(cams, device="cpu",
                                       dtype=torch.float32)
        twin_err = sigma_errors(twin, ref)["max_rel"]
        rec["cpu_f32_twin_max_rel_err"] = f"{twin_err:.3e}"
        check(twin_err > SIGMA_TOL and err["max_rel"] <= 2 * twin_err,
              f"uncertainty {name}: float32 sigmas {err['max_rel']:.3e} "
              f"from float64, the float32 CPU twin {twin_err:.3e}")
        rec["f32_floor_case"] = True
    say("uncertainty", case=name.replace(" ", "_"), **rec)
    return rec, unc


def phase_uncertainty(dev, solved: dict) -> dict:
    """[uncertainty]: uncertainty_case on each solved CameraSet (``solved``:
    [generic]'s, then uncertainty_inputs'); the template one also written
    to a ``.camset``, loaded back and run again (the file's handler holds
    no start, so no PnP seed runs): the in-memory sigmas bit for bit."""
    import tempfile

    from pycamset_tpu_torch.utils.saving import load_CameraSet
    t0 = time.perf_counter()
    solved = {**solved, **uncertainty_inputs(dev)}
    say("uncertainty", case="inputs",
        seconds=f"{time.perf_counter() - t0:.1f}")
    out, sig = {}, {}
    for name, cams in solved.items():
        out[name], sig[name] = uncertainty_case(name, cams, dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cams.camset")
        solved["template 16x100"].save(path)
        back = load_CameraSet(path)
    check(back.calibration_handler.initial_params is None,
          "the loaded handler holds a start")
    out["loaded 16x100"], _ = uncertainty_case(
        "loaded 16x100", back, dev, in_memory=sig["template 16x100"])
    return out


# The rolling-shutter user path: problems.rs_handler's rig
RS_SHAPE = (16, 100)
# the float64 card solve tied to the CPU's at this size
RS_SMALL = (3, 8)
# tests/test_rolling_shutter.py's bars: readouts and velocities
RS_READOUT_TOL = 0.05
RS_VELOCITY_TOL = 0.02
# the float32 card cost against the float64 card solve's (relative)
F32_COST_TOL = 1e-4
# the heterogeneous multi-target rigs: fisheye and standard cameras in turn
HET_CYCLE = ("fisheye", "standard")
HET_MULTI = {"grouped 16x100": False, "mixed 16x100": True}


@contextlib.contextmanager
def seeded_rs_handlers(x0):
    """Within the block, an ``RSTemplateBundleHandler`` that the user's
    entry builds (``run_stereo_calibration(problem_options={
    "rolling_shutter": r})``) starts at ``x0`` in place of its PnP seed,
    which needs OpenCV (the card's machine has none); no image is
    missing."""
    from pycamset_tpu_torch.optim.handlers import RSTemplateBundleHandler
    orig = RSTemplateBundleHandler.calc_initial_params

    def seed(self):
        self.missing_poses = np.zeros(self.detection.max_ims, dtype=bool)
        return np.array(x0)
    RSTemplateBundleHandler.calc_initial_params = seed
    try:
        yield
    finally:
        RSTemplateBundleHandler.calc_initial_params = orig


def global_shutter_handler(rs):
    """The global-shutter ``TemplateBundleHandler`` of an RS handler's rig
    and detections, started at the RS start's intrinsics, extrinsics and
    pose halves."""
    from pycamset_tpu_torch.optim.handlers import TemplateBundleHandler
    opts = {k: v for k, v in rs.problem_opts.items()
            if k != "rolling_shutter"}
    gs = TemplateBundleHandler(rs.camset, rs.target, rs.detection,
                               options=opts)
    prim = rs.bundlePrimitive
    n_i, n_c = prim.poses.shape[0], prim.intr.shape[0]
    keep = np.ones(prim.base_full().size, dtype=bool)
    ee = (prim.intr_width + 6) * n_c
    keep[ee:ee + 12 * n_i] = np.tile(np.arange(12) < 6, n_i)
    keep[ee + 12 * n_i:] = False
    gs.set_initial_params(np.asarray(rs.get_initial_params())[
        keep[prim.unfixed_full()]])
    return gs


def rs_small_f64_tie(dev) -> dict:
    """The card's float64 RS solve against the CPU's (the port's float64
    CPU solve is held to the JAX package by
    tests/test_torch_rolling_shutter.py) at ``RS_SMALL``: the same nit,
    nfev and status, the cost within 1e-9."""
    import torch
    from pycamset_tpu_torch.optim.structured_driver import (
        build_structured_problem)
    from pycamset_tpu_torch.problems import rs_handler
    h, _ = rs_handler(*RS_SMALL)
    x0 = h.get_initial_params()
    cpu = build_structured_problem(h, device="cpu")[0](x0)[1]
    card = build_structured_problem(h, device=dev,
                                    dtype=torch.float64)[0](x0)[1]
    rel = abs(float(card.cost) - float(cpu.cost)) / float(cpu.cost)
    check((card.nit, card.nfev, int(card.status))
          == (cpu.nit, cpu.nfev, int(cpu.status)) and rel <= 1e-9,
          f"rs_user_path {RS_SMALL}: the card's float64 solve (nit "
          f"{card.nit}, cost {rel:.2e}) differs from the CPU's (nit "
          f"{cpu.nit})")
    return {"small_f64_card_cpu_cost_rel": f"{rel:.2e}",
            "small_f64_nit": cpu.nit}


def phase_rs_user_path(counted, dev, user_ms: dict) -> dict:
    """[rs_user_path]: ``problems.rs_handler(16, 100)`` (the bench rig's
    cameras, readouts drawn in [0.5, 0.9], the target moving within each
    frame, 0.3 px noise; no PnP) through ``run_stereo_calibration(
    problem_options={"rolling_shutter": camera 0's true readout})``, the
    structured backend's forward-mode route (no gram kernel), on both
    dense-solve routes. The handler's problem first: captured = uncaptured
    bit for bit, one replay a step, the SPD kernel once a step on its
    route (launches, fallbacks), ms an LM step and an evaluation (warm,
    captured), host reads, the peak MiB of one evaluation; then the entry
    as the main path (counts zeroed: no gram wrapper), saved and loaded
    back; status 1-2, rms <= 0.36 px, each readout within 0.05 and every
    velocity within 0.02 of the truth; the float32 cost within 1e-4 of the
    card's float64 solve (tied to the CPU at 3 x 8); beside it the global-
    shutter user path's ms an evaluation ([user_path], same run) and the
    global-shutter handler's rms on the same data.

    :return: {"psd_solve": {solve: main-path launches}}."""
    import tempfile

    import torch
    from pycamset_tpu_torch.calibration.camera_calibrator import (
        run_stereo_calibration)
    from pycamset_tpu_torch.models.camera_set import CameraSet
    from pycamset_tpu_torch.ops import cuda_cholesky as cc
    from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
    from pycamset_tpu_torch.optim.handlers import RSTemplateBundleHandler
    from pycamset_tpu_torch.optim.structured import chain_family
    from pycamset_tpu_torch.optim.structured_driver import (
        build_structured_problem)
    from pycamset_tpu_torch.problems import rs_handler
    from pycamset_tpu_torch.utils.saving import load_CameraSet
    n_cams, n_ims = RS_SHAPE
    tag = f"rs_user_path {n_cams}x{n_ims}"
    t0 = time.perf_counter()
    handler, truth = rs_handler(n_cams, n_ims)
    inputs_s = time.perf_counter() - t0
    x0 = handler.get_initial_params()
    t0 = time.perf_counter()
    solve_fn, _, x_init = build_structured_problem(handler, device=dev)
    sync(dev)
    build_s = time.perf_counter() - t0
    prob = solve_fn.problem
    check(chain_family(prob.op_fun, prob.widths) is None
          and prob.uv.shape[-1] == 3,
          f"{tag}: the chain is not on the forward-mode route")
    neq = prob.neq_fn()
    neq(prob.x0)
    base = mib_allocated()
    neq(prob.x0)
    eval_mib = peak_mib(dev, base)
    by_route, launches, out = {}, {}, {}
    for route in ("library", "kernel"):
        with one_launch_psd(route == "kernel"):
            cc.psd_solve.fallbacks = 0
            x_ref, ref, counts, warm, first_s, runner = solved_through_graph(
                f"{tag} ({route})", solve_fn, x_init, route == "kernel")
            grams = {n: k for n, k in counts.items()
                     if n.split("<")[0] != "psd_solve_kernel"}
            check(not grams, f"{tag} ({route}): gram kernels {grams}")
            reads = runner.reads
            ms = float(np.median(timed(lambda: solve_fn(x_init), 3)))
            reads = (runner.reads - reads) / 3
            fell = cc.psd_solve.fallbacks
            with tempfile.TemporaryDirectory() as tmp:
                path = (os.path.join(tmp, "rs.camset") if route == "library"
                        else None)
                sec = {}
                with seeded_rs_handlers(x0), timed_method(
                        CameraSet, "save", sec, "save"):
                    solved, n_own, n_psd, e2e_s = main_path_counts(
                        counted, None, f"{tag} ({route})",
                        lambda: run_stereo_calibration(
                            handler.camset, handler.detection,
                            handler.target, save=path is not None,
                            save_loc=path, problem_options=dict(
                                handler.problem_opts), device=dev))
                files = {}
                if path is not None:
                    t0 = time.perf_counter()
                    back = load_CameraSet(path)
                    mib = os.path.getsize(path) / 2 ** 20
                    files = {"save_s": f"{sec['save']:.2f}",
                             "load_s": f"{time.perf_counter() - t0:.2f}",
                             "file_mib": f"{mib:.1f}"}
                    bh = back.calibration_handler
                    check(back == solved and isinstance(
                        bh, RSTemplateBundleHandler) and np.array_equal(
                        back.calibration_params, solved.calibration_params),
                          f"{tag}: the loaded CameraSet differs")
        sh = solved.calibration_handler
        check(type(sh) is RSTemplateBundleHandler
              and np.array_equal(solved.calibration_params, x_ref),
              f"{tag} ({route}): the entry's parameters differ from the "
              f"problem's solve")
        status, rms = int(ref.status), prob.rms_px(ref.cost)
        ro = sh.get_readouts(x_ref)
        ro_err = [abs(ro[n] - r) for n, r in zip(sh.cam_names,
                                                 truth["readouts"])]
        vel_err = float(np.abs(sh.get_velocities(x_ref)
                               - truth["vels"]).max())
        check(status in (1, 2) and rms <= 0.36,
              f"{tag} ({route}): status {status}, rms {rms}")
        check(max(ro_err) <= RS_READOUT_TOL and vel_err <= RS_VELOCITY_TOL,
              f"{tag} ({route}): readout error {max(ro_err):.4f}, velocity "
              f"error {vel_err:.4f}")
        launches[f"{tag} ({route})"] = n_psd
        by_route[route] = ref
        say("rs_user_path", shape=f"{n_cams}x{n_ims}", route=route,
            backend="structured (forward-mode route)", kernel="none",
            same_bits=True, status=status, nit=ref.nit, nfev=ref.nfev,
            rms_px=f"{rms:.5f}", n_real=prob.blocks.n_real,
            im_grid=prob.blocks.n_ims, k_pad=prob.mask.shape[1],
            readout_err_per_cam=",".join(f"{e:.5f}" for e in ro_err),
            velocity_err_max=f"{vel_err:.5f}",
            solve_ms_median=f"{ms:.3f}",
            ms_per_lm_step=f"{ms / warm.nit:.3f}",
            ms_per_evaluation=f"{ms / warm.nfev:.3f}",
            user_path_ms_per_evaluation=(
                f"{user_ms[('template 16x100', 'library')]:.3f}"
                if ("template 16x100", "library") in user_ms
                else "not measured"),
            host_reads_per_solve=f"{reads:.1f}",
            spd_launches_warm=sum(
                n for name, n in counts.items()
                if name.split("<")[0] == "psd_solve_kernel"),
            spd_launches_main_path=n_psd, psd_fallbacks=fell,
            eval_peak_mib=f"{eval_mib:.0f}",
            capture_ms=f"{runner.capture_ms:.1f}",
            first_solve_s=f"{first_s:.3f}", inputs_s=f"{inputs_s:.2f}",
            build_s=f"{build_s:.3f}",
            run_stereo_calibration_s=f"{e2e_s:.2f}", **files)
    # the float32 card cost against the float64 card solve
    ref64 = build_structured_problem(handler, device=dev,
                                     dtype=torch.float64)[0](x_init)[1]
    rel = abs(float(by_route["library"].cost) - float(ref64.cost)) / float(
        ref64.cost)
    check(rel <= F32_COST_TOL,
          f"{tag}: the float32 cost is {rel:.3e} from the float64 card's")
    out.update(rs_small_f64_tie(dev))
    # the failure mode the chain removes: a global-shutter calibration of
    # the same rolling-shutter data
    gs_res, _ = run_bundle_adjustment(global_shutter_handler(handler),
                                      device=dev)
    gs_rms = float(np.sqrt(np.mean(gs_res.fun ** 2)))
    check(gs_rms > 10 * 0.3, f"{tag}: the global-shutter handler's rms "
                             f"{gs_rms:.3f} px on rolling-shutter data")
    say("rs_user_path", shape=f"{n_cams}x{n_ims}", check="f64",
        f64_nit=ref64.nit, f64_status=int(ref64.status),
        rel_cost_diff_f64_card=f"{rel:.3e}",
        global_shutter_rms_px=f"{gs_rms:.3f}",
        global_shutter_status=int(gs_res.status), **out)
    return {PSD[0]: launches}


def het_models(n_cams: int) -> list:
    return [HET_CYCLE[c % len(HET_CYCLE)] for c in range(n_cams)]


def phase_het_multi_target(counted, dev) -> dict:
    """[het_multi_target]: the grouped and mixed multi-target problems of a
    heterogeneous rig (``problems.{grouped,mixed}_problem(16, 100,
    camera_model=[fisheye, standard, ...])``: ``ProjectionHet``, a = 16,
    the forward-mode route) solved uncaptured as the main path (counts
    zeroed: no gram wrapper launched), then captured (= uncaptured bit for
    bit); status 1-2, rms <= 0.36 px; ms an evaluation (warm, captured)
    beside the uniform standard-model problem's on Kernel E (timed in
    turn); the peak MiB of one evaluation; the float32 cost within 1e-4
    of the float64 card solve's. Returns {shape: record}."""
    import torch
    from pycamset_tpu_torch.optim.structured import chain_family
    from pycamset_tpu_torch.optim.structured_mixed import kernel_chain
    from pycamset_tpu_torch.problems import grouped_problem, mixed_problem
    out = {}
    for shape, mixed in HET_MULTI.items():
        tag = f"het_multi_target {shape}"
        n_cams, n_ims = (int(v) for v in shape.split()[1].split("x"))
        maker = mixed_problem if mixed else grouped_problem
        models = het_models(n_cams)
        prob = maker(n_cams, n_ims, dev, camera_model=models)
        route = (not kernel_chain(prob.op_fun, prob.widths) if mixed else
                 chain_family(prob.op_fun, prob.widths) is None)
        check(route and prob.widths.a == 16,
              f"{tag}: not the forward-mode route (a = {prob.widths.a})")
        neq = prob.neq_fn()
        neq(prob.x0)
        base = mib_allocated()
        neq(prob.x0)
        eval_mib = peak_mib(dev, base)
        ref, _, _, main_s = main_path_counts(
            counted, None, tag, lambda: prob.solve(graph=False))
        first, warm = prob.solve(), prob.solve()
        check(same_solve(first, ref) and same_solve(warm, ref),
              f"{tag}: the captured solve differs from the uncaptured")
        status, rms = int(ref.status), prob.rms_px(ref.cost)
        check(status in (1, 2) and rms <= 0.36,
              f"{tag}: status {status}, rms {rms}")
        uniform = maker(n_cams, n_ims, dev)
        uni = uniform.solve()
        het_ms, uni_ms = timed_pair(prob.solve, uniform.solve, 3)
        prob64 = maker(n_cams, n_ims, dev, dtype=torch.float64,
                       camera_model=models)
        ref64 = prob64.solve()
        rel = abs(float(ref.cost) - float(ref64.cost)) / float(ref64.cost)
        check(rel <= F32_COST_TOL, f"{tag}: the float32 cost is {rel:.3e} "
                                   f"from the float64 card's")
        rec = {"status": status, "nit": ref.nit, "nfev": ref.nfev,
               "rms_px": f"{rms:.5f}",
               "ms_per_evaluation": f"{np.median(het_ms) / ref.nfev:.3f}",
               "uniform_kernel_e_ms_per_evaluation":
                   f"{np.median(uni_ms) / uni.nfev:.3f}",
               "uniform_nit": uni.nit,
               "eval_peak_mib": f"{eval_mib:.0f}",
               "rel_cost_diff_f64_card": f"{rel:.3e}",
               "f64_nit": ref64.nit, "main_path_s": f"{main_s:.2f}"}
        say("het_multi_target", shape=shape.replace(" ", "_"),
            models="/".join(HET_CYCLE), a=prob.widths.a,
            kernel="none (forward-mode route)", same_bits=True,
            n_real=prob.blocks.n_real, **rec)
        out[shape] = rec
        del prob, prob64, uniform
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_auto_dispatch(dev) -> dict:
    """[auto_dispatch]: the backend ``run_bundle_adjustment(backend="auto")``
    chooses (read from its log) and the gram route of each chain at 4 x 16:
    the rolling-shutter and the skew chains take the structured backend's
    forward-mode route; the template, self-calibration, free-point and
    grouped chains the structured backend and the mixed chain the mixed one
    on their kernels, as before. Each solve status 1-2."""
    import logging

    from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
    from pycamset_tpu_torch.optim.structured import (chain_family,
                                                     chain_widths)
    from pycamset_tpu_torch.problems import (freepoint_handler,
                                             multi_target_handler,
                                             rs_handler,
                                             selfcal_stage_handler,
                                             skew_handler,
                                             template_handler)

    class Said(logging.Handler):
        def __init__(self):
            super().__init__(logging.INFO)
            self.backends = []

        def emit(self, record):
            msg = record.getMessage()
            if msg.startswith("Using the") or "falling back" in msg:
                self.backends.append(msg)

    def selfcal():
        h, _ = template_handler(4, 16, template_warp=BOARD_WARP)
        _, solved = run_bundle_adjustment(h, device=dev)
        return selfcal_stage_handler(solved, h)

    cases = {
        "rolling_shutter": (lambda: rs_handler(4, 16)[0], "structured"),
        "skew": (lambda: skew_handler(4, 16), "structured"),
        "template": (lambda: template_handler(4, 16)[0], "structured"),
        "selfcal": (selfcal, "structured"),
        "freepoint": (lambda: freepoint_handler(4, 16)[0], "structured"),
        "grouped": (lambda: multi_target_handler(4, 16, mixed=False)[0],
                    "structured"),
        "mixed": (lambda: multi_target_handler(4, 16, mixed=True)[0],
                  "mixed")}
    root = logging.getLogger()
    level = root.level
    out = {}
    for name, (make, want) in cases.items():
        handler = make()
        said = Said()
        root.addHandler(said)
        root.setLevel(logging.INFO)
        try:
            res, _ = run_bundle_adjustment(handler, backend="auto",
                                           device=dev)
        finally:
            root.removeHandler(said)
            root.setLevel(level)
        backend = ("mixed" if any("mixed" in m for m in said.backends)
                   else "structured" if any("(Schur)" in m
                                            for m in said.backends)
                   else "generic")
        if backend == "mixed":
            gram = "kernel E/F"
        else:
            family = chain_family(handler.op_fun, chain_widths(handler.op_fun))
            gram = (f"closed form ({family})" if family
                    else "forward-mode route")
        check(backend == want and int(res.status) in (1, 2),
              f"auto_dispatch {name}: backend {backend} ({said.backends}), "
              f"status {res.status}")
        out[name] = f"{backend}: {gram}"
    say("auto_dispatch", **{k: v.replace(" ", "_") for k, v in out.items()})
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = phase_device()
    builds = phase_build()
    peak_rec = phase_peak(smi)

    from pycamset_tpu_torch.problems import (fleet_problem, grouped_problem,
                                             mixed_problem, selfcal_problem,
                                             standard_problem)
    dev = torch.device("cuda", 0)
    probs = {"template 16x100": standard_problem(16, 100, dev),
             "template 64x400": standard_problem(64, 400, dev),
             "selfcal 16x100": selfcal_problem(16, 100, dev),
             "selfcal 64x12": selfcal_problem(64, 12, dev),
             "mixed 16x100": mixed_problem(16, 100, dev),
             "mixed 64x12": mixed_problem(64, 12, dev),
             "grouped 16x100": grouped_problem(16, 100, dev)}
    say("problems", **{s.replace(" ", "_"):
                       f"B={p.mask.shape[0]},K={p.mask.shape[1]},"
                       f"n_real={p.blocks.n_real}" for s, p in probs.items()})
    kern = {name: {} for name in KERNELS}
    phase_template_kernels(probs, kern, peak_rec["tflops"])
    phase_selfcal_kernels(probs, kern, peak_rec["tflops"])
    phase_mixed_kernels(probs, kern, peak_rec["tflops"])
    bounds = {name: bound(name, probs[shape], MAIN_PATH[shape][1])
              for name, (_, _, shape) in KERNELS.items()}
    systems = capture_reduced_systems(probs)
    psd_err = phase_parity_psd(systems)
    psd_time = phase_time_psd(systems)
    say("elapsed", after="kernels",
        seconds=f"{time.perf_counter() - t_start:.1f}")
    launches = phase_main_path(probs)
    phase_graph(probs)
    say("elapsed", after="graph",
        seconds=f"{time.perf_counter() - t_start:.1f}")
    cpu_of = {"template 16x100": standard_problem,
              "selfcal 16x100": selfcal_problem,
              "mixed 16x100": mixed_problem,
              "grouped 16x100": grouped_problem}
    ab, std_status = {}, {}
    for shape, prob in probs.items():
        # the multi-target solves have a budget of 60 evaluations and no
        # iteration bound of their own (bench.py::mixed_problem)
        max_nit = None if MAIN_PATH[shape][1] else 10
        cpu_ref = (cpu_f64_solve(cpu_of[shape], prob) if shape in cpu_of
                   else None)
        with one_launch_psd(False):
            library = prob.solve()
        with one_launch_psd(True):
            kernel = prob.solve()
        t_lib = phase_solve(shape, prob, library, "library", cpu_ref,
                            max_nit)
        t_ker = phase_solve(shape, prob, kernel, "kernel", cpu_ref, max_nit)
        std_status[shape] = int(library.status)
        ab[shape] = {"library": t_lib[0], "kernel": t_ker[0],
                     "library_uncaptured": t_lib[1],
                     "kernel_uncaptured": t_ker[1]}
        say("ab", shape=shape.replace(" ", "_"), nit_library=library.nit,
            nit_kernel=kernel.nit,
            solve_ms_median_library=f"{t_lib[0]:.3f}",
            solve_ms_median_kernel=f"{t_ker[0]:.3f}",
            solve_ms_median_library_uncaptured=f"{t_lib[1]:.3f}",
            solve_ms_median_kernel_uncaptured=f"{t_ker[1]:.3f}")
    say("elapsed", after="solves",
        seconds=f"{time.perf_counter() - t_start:.1f}")
    torch.cuda.empty_cache()
    fleet = fleet_problem(*FLEET, dev)
    fleet_a = fleet_problem(*FLEET_A, dev)
    say("problems", **{f"fleet_{'x'.join(map(str, shape))}":
                       f"R={f.n_rigs},B={f.mask.shape[1]},K={f.mask.shape[2]}"
                       f",n_real={int(f.n_real.sum())}"
                       for shape, f in ((FLEET, fleet), (FLEET_A, fleet_a))})
    fleet_kern = phase_fleet_kernel(fleet, fleet_a)
    del fleet_a
    fleet_rec = phase_fleet(fleet)
    say("elapsed", after="fleet",
        seconds=f"{time.perf_counter() - t_start:.1f}")
    del fleet
    torch.cuda.empty_cache()
    user_ms = {}
    user = phase_user_path(probs, {}, user_ms)
    say("elapsed", after="user_path",
        seconds=f"{time.perf_counter() - t_start:.1f}")
    for shape, by_route in user.items():
        for route, counts in by_route.items():
            for name, n in counts.items():
                launches[name][f"user_path {shape} ({route})"] = n
    torch.cuda.empty_cache()
    selfcal_user = phase_selfcal_user_path(probs, kern)
    say("elapsed", after="selfcal_user_path",
        seconds=f"{time.perf_counter() - t_start:.1f}")
    for name, by_shape in selfcal_user.items():
        launches[name].update(by_shape)
    del probs, systems, prob, library, kernel
    gc.collect()            # the dead problems' graphs sit in reference cycles
    torch.cuda.empty_cache()
    from pycamset_tpu_torch.problems import freepoint_problem
    fp_probs = {shape: freepoint_problem(n_cams, n_ims, dev)
                for shape, (n_cams, n_ims, _) in FREEPOINT.items()}
    say("problems", **{s.replace(" ", "_"):
                       f"B={p.mask.shape[0]},K={p.mask.shape[1]},"
                       f"n_real={p.blocks.n_real}"
                       for s, p in fp_probs.items()})
    fp_kern = {name: {} for name in FREEPOINT_KERNELS}
    phase_freepoint_kernels(fp_probs, fp_kern)
    launches.update(phase_freepoint(fp_probs))
    say("elapsed", after="freepoint",
        seconds=f"{time.perf_counter() - t_start:.1f}")
    gc.collect()
    torch.cuda.empty_cache()
    models = phase_camera_models(builds, peak_rec["tflops"])
    say("elapsed", after="camera_models",
        seconds=f"{time.perf_counter() - t_start:.1f}")
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    sc_models = phase_selfcal_models(builds)
    say("elapsed", after="selfcal_models",
        seconds=f"{time.perf_counter() - t_start:.1f}",
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}")
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    mx_models = phase_mixed_models(builds, std_status)
    say("elapsed", after="mixed_models",
        seconds=f"{time.perf_counter() - t_start:.1f}",
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}")
    gc.collect()
    torch.cuda.empty_cache()
    counted = wrappers()
    t_phase = time.perf_counter()
    multi = phase_multi_target_handlers(counted, dev)
    say("elapsed", after="multi_target_handlers",
        seconds=f"{time.perf_counter() - t_start:.1f}",
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}")
    t_phase = time.perf_counter()
    fleets = {shape: fleet_of(shape, dev) for shape in FLEET_HANDLERS}
    say("problems", **{f"fleet_handlers_{s.replace(' ', '_')}":
                       f"R={f.n_rigs},B={f.mask.shape[1]},"
                       f"K={f.mask.shape[2]},n_real={int(f.n_real.sum())}"
                       for s, (_, f) in fleets.items()},
        seconds=f"{time.perf_counter() - t_phase:.1f}")
    fleet_keys = phase_fleet_mixed_kernel(fleets, dev, builds)
    say("elapsed", after="fleet_mixed_kernel",
        seconds=f"{time.perf_counter() - t_start:.1f}",
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}")
    t_phase = time.perf_counter()
    fleet_h = phase_fleet_handlers(fleets, counted)
    say("elapsed", after="fleet_handlers",
        seconds=f"{time.perf_counter() - t_start:.1f}",
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}")
    t_phase = time.perf_counter()
    fleet_psd = phase_fleet_handlers_psd(fleets, counted)
    say("elapsed", after="fleet_handlers_psd",
        seconds=f"{time.perf_counter() - t_start:.1f}",
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}")
    t_phase = time.perf_counter()
    from pycamset_tpu_torch.optim.fleet import build_fleet_problem
    from pycamset_tpu_torch.problems import fleet_handlers
    tied_handlers = fleet_handlers("template", *TIED_FLEET,
                                   shared_intrinsics=True)
    batch_systems = {
        "tied 64x4x16": capture_batched_systems(
            build_fleet_problem(tied_handlers, device=dev)),
        **{shape: capture_batched_systems(f)
           for shape, (_, f) in fleets.items()}}
    del fleets
    psd_batch = phase_psd_batch(batch_systems)
    del batch_systems
    say("elapsed", after="psd_batch",
        seconds=f"{time.perf_counter() - t_start:.1f}",
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}")
    t_phase = time.perf_counter()
    tied_fleet = phase_tied_fleet(tied_handlers, counted, dev)
    del tied_handlers
    say("elapsed", after="tied_fleet",
        seconds=f"{time.perf_counter() - t_start:.1f}",
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}")
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tied_user = phase_tied_user_path(counted, dev)
    say("elapsed", after="tied_user_path",
        seconds=f"{time.perf_counter() - t_start:.1f}",
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}")
    mixed_launches, mixed_times = {}, {}
    for kind in MIXED_RIGS:
        gc.collect()
        torch.cuda.empty_cache()
        t_phase = time.perf_counter()
        by_kernel, by_time = phase_mixed_rigs(
            kind, counted, dev, kern, builds, peak_rec["tflops"], user_ms)
        for name, by_solve in by_kernel.items():
            mixed_launches.setdefault(name, {}).update(by_solve)
        for name, by_shape in by_time.items():
            mixed_times.setdefault(name, {}).update(by_shape)
        say("elapsed", after=kind,
            seconds=f"{time.perf_counter() - t_start:.1f}",
            phase_seconds=f"{time.perf_counter() - t_phase:.1f}")
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    for name, by_solve in phase_cg_user_path(counted, dev, kern).items():
        launches[name].update(by_solve)
    say("elapsed", after="cg_user_path",
        seconds=f"{time.perf_counter() - t_start:.1f}",
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}")
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    fleet_fp = phase_fleet_freepoint(counted, dev)
    for shape, rec in fleet_fp.items():
        launches[rec["own"]][f"fleet_freepoint {shape}"] = rec["launches"]
    say("elapsed", after="fleet_freepoint",
        seconds=f"{time.perf_counter() - t_start:.1f}",
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}")
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    _, solved = phase_generic(dev, counted)
    say("elapsed", after="generic",
        seconds=f"{time.perf_counter() - t_start:.1f}",
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}")
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    phase_uncertainty(dev, solved)
    del solved
    say("elapsed", after="uncertainty",
        seconds=f"{time.perf_counter() - t_start:.1f}",
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}")
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    for name, by_solve in phase_rs_user_path(counted, dev, user_ms).items():
        launches[name].update(by_solve)
    say("elapsed", after="rs_user_path",
        seconds=f"{time.perf_counter() - t_start:.1f}",
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}")
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    phase_het_multi_target(counted, dev)
    say("elapsed", after="het_multi_target",
        seconds=f"{time.perf_counter() - t_start:.1f}",
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}")
    t_phase = time.perf_counter()
    phase_auto_dispatch(dev)
    say("elapsed", after="auto_dispatch",
        seconds=f"{time.perf_counter() - t_start:.1f}",
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}")
    for name, by_solve in mixed_launches.items():
        launches[name].update(by_solve)
    for phase, recs in (("multi_target_handlers", multi),
                        ("fleet_handlers", fleet_h)):
        for shape, rec in recs.items():
            launches[rec["own"]][f"{phase} {shape}"] = rec["launches"]
    for shape, by_route in tied_user.items():
        for route, counts in by_route.items():
            for name, n in counts.items():
                launches[name][f"tied_user_path {shape} ({route})"] = n
    for route, rec in tied_fleet.items():
        launches["template_gram_fused"][f"tied_fleet 64x4x16 ({route})"] = (
            rec["launches"])

    fleet_shape = f"fleet {'x'.join(map(str, FLEET))}"
    launches["template_gram_fused"][fleet_shape] = fleet_rec["launches"]
    kernels = []
    for name, (source, replaces, shape) in KERNELS.items():
        rec = kern[name][shape]
        bound_ms, bound_by = bounds[name]
        extra = {}
        if name == "template_gram_fused":
            extra["fleet"] = {k: v for k, v in fleet_kern.items()
                              if k != "kernel_a"}
            extra["fleet"].update(
                launches_uncaptured=fleet_rec["launches"],
                launches_captured=fleet_rec["launches_captured"],
                solve_ms_median=fleet_rec["solve_ms_median"],
                one_by_one_ms_median=fleet_rec["one_by_one_ms_median"])
        elif name == "template_gram":
            extra["fleet"] = fleet_kern["kernel_a"]
        else:       # C-F folded over the handler fleets' rigs
            extra["fleet"] = {
                f"{kernel} {model}": rec
                for (kernel, model), rec in fleet_keys.items()
                if FLEET_KEY_KERNELS[kernel][0] == name}
        handler_fleets = {shape: {k: v for k, v in rec.items() if k != "own"}
                          for shape, rec in fleet_h.items()
                          if rec["own"] == name}
        if handler_fleets:
            extra["fleet_handlers"] = handler_fleets
        if name in mixed_times:     # the pinned-column mixed Brown rigs
            extra["mixed_rigs"] = mixed_times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(launches[name].values()),
            "launches_by_solve": launches[name],
            "max_abs_err": max(r["abs"] for r in kern[name].values()),
            "max_rel_err": max(r["rel"] for r in kern[name].values()),
            "max_scaled_err": max(r["scaled"] for r in kern[name].values()),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "kernel_ms": rec["kernel_ms"], "bmm_ms": rec["bmm_ms"],
            "shape": shape, "card": smi, **extra})
    for name, (source, replaces, shape) in FREEPOINT_KERNELS.items():
        rec = fp_kern[name][shape]
        bound_ms, bound_by = freepoint_bound(name, fp_probs[shape])
        # the shapes' records and the wrapper folded over a wand fleet
        held = [*fp_kern[name].values(),
                *(r["kernel"] for r in fleet_fp.values() if r["own"] == name)]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(launches[name].values()),
            "launches_by_solve": launches[name],
            "max_abs_err": max(r["abs"] for r in held),
            "max_rel_err": max(r["rel"] for r in held),
            "max_scaled_err": max(r["scaled"] for r in held),
            "fleet": {f"fleet_freepoint {s}": {
                **{k: v for k, v in r["kernel"].items()
                   if k not in ("abs", "rel", "scaled")},
                "rigs_per_s": r["rigs_per_s"],
                "one_by_one_rigs_per_s": r["one_by_one_rigs_per_s"]}
                for s, r in fleet_fp.items() if r["own"] == name},
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "kernel_ms": rec["kernel_ms"], "peak_mib": rec["peak_mib"],
            "kernel_ms_other_shape": {
                s: r["kernel_ms"] for s, r in fp_kern[name].items()
                if s != shape},
            "wrapper_over": ("selfcal_gram_fused (Kernel C)"
                             if name.endswith("fused")
                             else "selfcal_gram (Kernel D)"),
            "shape": shape, "card": smi})
    for (name, model), rec in models["kernels"].items():
        source, replaces, _ = KERNELS[name]
        kernels.append({
            "name": f"{name}[{model}]", "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(rec["launches_by_solve"].values()),
            "launches_by_solve": rec["launches_by_solve"],
            "max_abs_err": rec["abs"], "max_rel_err": rec["rel"],
            "max_scaled_err": rec["scaled"],
            "f32_floor_cases": rec["f32_floor_cases"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None, "kernel_ms": rec["kernel_ms"],
            "camera_width": MODEL_WIDTH[model],
            "registers": rec["registers"], "spill_bytes": rec["spill_bytes"],
            "solve_ms_median": rec["solve_ms_median"],
            "shape": f"{model} {rec['shape']}", "card": smi})
    for (name, model), rec in sc_models.items():
        source, replaces, _ = {**KERNELS, **FREEPOINT_KERNELS}[name]
        kernels.append({
            "name": f"{name}[{model}]", "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(rec["launches_by_solve"].values()),
            "launches_by_solve": rec["launches_by_solve"],
            "max_abs_err": rec["abs"], "max_rel_err": rec["rel"],
            "max_scaled_err": rec["scaled"],
            "f32_floor_cases": rec["f32_floor_cases"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None, "kernel_ms": rec["kernel_ms"],
            "camera_width": MODEL_WIDTH[model],
            "registers": rec["registers"], "spill_bytes": rec["spill_bytes"],
            "peak_mib": rec["peak_mib"], "shape": rec["shape"],
            "card": smi})
    for (name, model, cw), rec in mx_models.items():
        source, replaces, _ = KERNELS[name]
        kernels.append({
            "name": f"{name}[{model},cw{cw}]", "route": "cuda",
            "source": source.replace(
                "mixed_grams.cu", "mixed_models_e.cu" if name.endswith(
                    "fused") else "mixed_models_f.cu"),
            "replaces": replaces,
            "launches": sum(rec["launches_by_solve"].values()),
            "launches_by_solve": rec["launches_by_solve"],
            "max_abs_err": rec["abs"], "max_rel_err": rec["rel"],
            "max_scaled_err": rec["scaled"],
            "f32_floor_cases": rec["f32_floor_cases"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None, "kernel_ms": rec["kernel_ms"],
            "camera_width": MODEL_WIDTH[model], "key_width": cw,
            "registers": rec["registers"], "spill_bytes": rec["spill_bytes"],
            "blocks_per_sm": rec["blocks_per_sm"],
            "dynamic_smem_bytes": rec["dynamic_smem_bytes"],
            "peak_mib": rec["peak_mib"],
            "solve_ms_median": rec["solve_ms_median"],
            **{k: rec[k] for k in ("kernel_route", "other_shape")
               if k in rec},
            "shape": rec["shape"], "card": smi})
    widest = psd_time[max(psd_time)]
    kernels.append({
        "name": PSD[0], "route": "cuda", "source": PSD[1],
        "replaces": PSD[2], "launches": sum(launches[PSD[0]].values()),
        "launches_by_solve": launches[PSD[0]],
        "max_abs_err": max(e["abs"] for e in psd_err.values()),
        "max_rel_err": max(e["rel"] for e in psd_err.values()),
        "ms": widest["ms"], "plain_ms": widest["plain_ms"],
        "bound_ms": widest["bound_ms"], "bound_by": widest["bound_by"],
        "library_ms": widest["library_ms"], "checked_ms": widest["checked_ms"],
        "kernel_ms": widest["kernel_ms"],
        "library_kernel_ms": widest["library_kernel_ms"],
        "diag_tile_ms": widest["diag_tile_ms"],
        "shape": f"{widest['shape']} (n={max(psd_time)})",
        "ms_by_n": {n: t["ms"] for n, t in psd_time.items()},
        "kernel_ms_by_n": {n: t["kernel_ms"] for n, t in psd_time.items()},
        "library_ms_by_n": {n: t["library_ms"] for n, t in psd_time.items()},
        "library_kernel_ms_by_n": {n: t["library_kernel_ms"]
                                   for n, t in psd_time.items()},
        "solve_ms_median_ab": ab,
        "tilted_64x400": models["psd"],
        "card": smi})
    tied_b = psd_batch["tied 64x4x16"]
    kernels.append({
        "name": PSD_BATCH[0], "route": "cuda", "source": PSD_BATCH[1],
        "replaces": PSD_BATCH[2],
        "launches": tied_fleet["kernel"]["psd_batched_launches"],
        "launches_by_solve": {
            "tied_fleet 64x4x16 (kernel)":
                tied_fleet["kernel"]["psd_batched_launches"],
            **{f"fleet_handlers_psd {s}": r["launches"]
               for s, r in fleet_psd.items()}},
        "fallbacks_by_solve": {
            "tied_fleet 64x4x16 (kernel)": tied_fleet["kernel"]["fallbacks"],
            **{f"fleet_handlers_psd {s}": r["fallbacks"]
               for s, r in fleet_psd.items()}},
        "max_abs_err": max(r["max_abs_err"] for r in psd_batch.values()),
        "max_rel_err": max(r["max_rel_err"] for r in psd_batch.values()),
        "ms": tied_b["ms"], "plain_ms": tied_b["plain_ms"],
        "bound_ms": tied_b["bound_ms"], "bound_by": tied_b["bound_by"],
        "library_ms": tied_b["library_ms"], "kernel_ms": tied_b["kernel_ms"],
        "library_kernel_ms": tied_b["library_kernel_ms"],
        "by_batch": {s: {k: r[k] for k in (
            "rigs", "n", "fallbacks", "kernel_ms", "library_kernel_ms", "ms",
            "library_ms", "plain_ms", "bound_ms", "bound_by", "max_rel_err",
            "library_max_rel_err")} for s, r in psd_batch.items()},
        "rigs_per_s": {"tied_fleet": {k: r["rigs_per_s"]
                                      for k, r in tied_fleet.items()},
                       **{f"fleet_handlers_psd {s}": r["rigs_per_s"]
                          for s, r in fleet_psd.items()}},
        "shape": f"tied 64x4x16 ({tied_b['rigs']} systems, n={tied_b['n']})",
        "card": smi})
    kernels.append({
        "name": PEAK[0], "route": "cuda", "source": PEAK[1],
        "replaces": PEAK[2], "launches": 0, "on_main_path": False,
        "max_abs_err": peak_rec["abs"], "ms": peak_rec["ms"],
        "plain_ms": peak_rec["plain_ms"], "bound_ms": peak_rec["bound_ms"],
        "bound_by": "operations", "library_ms": None,
        "fp32_fma_tflops": peak_rec["tflops"], "shape": "(32768, 128)",
        "card": smi})
    say("profiler", **PROFILER)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
