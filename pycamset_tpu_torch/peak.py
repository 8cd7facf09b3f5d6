"""The card's achievable FP32 FMA rate: CUDA probe and its plain twin.

Counterpart of ``benchmarks/peak.py::vpu_peak``. A hand-written Hopper kernel
(``csrc/peak.cu``) replaces the Pallas FMA-chain kernel: each element starts
four independent chains 0.5 x + 0.1 k and runs ``iters`` iterations of four
dependent FMAs on each, with the TPU kernel's constants; the output is the
sum of the four chains. FLOP = elements x iters x 16 x 2.

``fma_chain`` launches the kernel for a CUDA float32 tensor and raises on any
other CUDA input; a CPU tensor runs the plain twin ``fma_chain_plain``. It
counts its launches in ``fma_chain.launches``. ``measure_fp32_peak`` times
the probe at the JAX probe's size with CUDA events after a warm-up. The
bounds of the port's kernels keep dividing by the published 67 TFLOP/s;
the measured rate is printed beside it.
"""
from __future__ import annotations

import numpy as np
import torch

ROWS = 64 * 512       # the JAX probe's grid x block rows
LANES = 128
ITERS = 1024
_STEPS = ((0.999999, 0.0001), (1.000001, -0.0001), (0.999998, 0.0001),
          (1.000002, -0.0001))


def flops(numel: int, iters: int = ITERS) -> int:
    return numel * iters * 16 * 2


def fma_chain_plain(a: torch.Tensor, iters: int = ITERS) -> torch.Tensor:
    """Plain twin: the four chains elementwise, in the input's dtype."""
    chains = [a * 0.5 + 0.1 * k for k in range(4)]
    for _ in range(iters):
        for k, v in enumerate(chains):
            for mul, add in _STEPS:
                v = v * mul + add
            chains[k] = v
    return chains[0] + chains[1] + chains[2] + chains[3]


def fma_chain(a: torch.Tensor, iters: int = ITERS) -> torch.Tensor:
    """The probe on ``a`` (any shape): the sum of its four chains."""
    if a.device.type == "cpu":
        return fma_chain_plain(a, iters)
    if a.dtype != torch.float32:
        raise TypeError(f"a is {a.dtype}; the CUDA kernel takes "
                        f"torch.float32")
    if not a.is_contiguous():
        raise ValueError("a must be contiguous")
    from pycamset_tpu_torch._build import load
    with torch.cuda.device(a.device):
        out = torch.empty_like(a)
        rc = load().lib.pct_fma_chain(
            a.data_ptr(), out.data_ptr(), a.numel(), int(iters),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fma_chain launch failed: cudaError {rc}")
    fma_chain.launches += 1
    return out


fma_chain.launches = 0


def measure_fp32_peak(device, reps: int = 20, warmup: int = 3,
                      seed: int = 0) -> dict:
    """FP32 FMA rate of the probe on a (ROWS, LANES) array on ``device``:
    the mean of ``reps`` launches timed with CUDA events after ``warmup``.

    :return: {"tflops", "ms", "gflop"}.
    """
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the FP32 peak is a card's: {device} is not CUDA")
    rng = np.random.default_rng(seed)
    a = torch.as_tensor(rng.uniform(0.5, 1.0, (ROWS, LANES)),
                        dtype=torch.float32, device=device)
    for _ in range(warmup):
        fma_chain(a)
    torch.cuda.synchronize(device)
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fma_chain(a)
    t1.record()
    torch.cuda.synchronize(device)
    ms = t0.elapsed_time(t1) / reps
    work = flops(a.numel())
    return {"tflops": work / (ms * 1e-3) / 1e12, "ms": ms,
            "gflop": work / 1e9}
