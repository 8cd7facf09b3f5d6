"""The FP32 FMA peak probe (peak.py) on the CPU: its plain twin.

The probe's CUDA kernel runs on a card only (``tests/test_torch_cuda.py``);
here the CPU wrapper runs the twin and launches nothing, the twin in float32
stays within float32's rounding of 4096 dependent operations of its float64
run (4096 x 2^-24 ~ 2.4e-4 of the output's scale), the twin's chains agree
with the Pallas kernel of ``benchmarks/peak.py::vpu_peak`` run in interpret
mode, and the probe's size and FLOP count are that probe's.
"""
import functools

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from benchmarks import peak as jax_peak
from pycamset_tpu_torch import peak

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)

ROUNDING = 4096 * 2.0 ** -24   # 1024 iterations x 4 dependent FMAs in f32


def _inputs(n=512, seed=0):
    return np.random.default_rng(seed).uniform(0.5, 1.0, n)


def test_cpu_wrapper_runs_the_twin_and_launches_nothing():
    a = torch.tensor(_inputs(), dtype=torch.float32)
    before = peak.fma_chain.launches
    out = peak.fma_chain(a, iters=64)
    assert peak.fma_chain.launches == before
    assert torch.equal(out, peak.fma_chain_plain(a, iters=64))


def test_float32_twin_within_rounding_of_float64():
    x = _inputs()
    f32 = peak.fma_chain_plain(torch.tensor(x, dtype=torch.float32), 1024)
    f64 = peak.fma_chain_plain(torch.tensor(x), 1024)
    assert bool(torch.isfinite(f32).all())
    err = float((f32.double() - f64).abs().max()) / float(f64.abs().max())
    assert err < ROUNDING
    # the chains stay near their start (no overflow, no denormals)
    start = 4 * torch.tensor(x) * 0.5 + 0.6
    assert float((f64 - start).abs().max()) < 0.5


class _Fetched(Exception):
    """Raised by the stand-in for ``fetch_scalar`` to stop ``vpu_peak``
    after its first launch, before its timing loop."""


def test_twin_matches_the_pallas_probe_in_interpret_mode(monkeypatch):
    # vpu_peak looks up pl.pallas_call, its sizes and fetch_scalar at call
    # time: run its kernel at 2 x 8 rows in interpret mode and take the sum
    # of its output, the first value it fetches. The two float32 chains
    # differ only in rounding (XLA may contract a multiply and an add into
    # one FMA) and summation order, so they agree within ROUNDING; a
    # constant off by 1e-6 in one step moves the sum by ~1e-3 of its value.
    fetched = []

    def fetch(value):
        fetched.append(float(value))
        raise _Fetched

    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jax_peak, "GRID", 2)
    monkeypatch.setattr(jax_peak, "BLK", 8)
    monkeypatch.setattr(jax_peak, "fetch_scalar", fetch)
    with pytest.raises(_Fetched):
        jax_peak.vpu_peak()
    a = np.random.default_rng(0).uniform(0.5, 1.0, (2 * 8, jax_peak.LANES))
    f32 = float(peak.fma_chain_plain(
        torch.tensor(a, dtype=torch.float32), jax_peak.ITERS).sum())
    f64 = float(peak.fma_chain_plain(torch.tensor(a), jax_peak.ITERS).sum())
    assert abs(fetched[0] - f32) <= ROUNDING * abs(f64)
    assert abs(fetched[0] - f64) <= ROUNDING * abs(f64)


def test_probe_size_and_flops_are_the_jax_probes():
    assert peak.ROWS == jax_peak.GRID * jax_peak.BLK
    assert (peak.LANES, peak.ITERS) == (jax_peak.LANES, jax_peak.ITERS)
    numel = peak.ROWS * peak.LANES
    assert peak.flops(numel) == (jax_peak.GRID * jax_peak.BLK
                                 * jax_peak.LANES * jax_peak.ITERS * 16 * 2)
