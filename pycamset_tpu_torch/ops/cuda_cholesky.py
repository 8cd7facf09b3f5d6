"""Dense SPD factor + solve in one launch: CUDA wrapper and its plain twin.

Counterpart of ``pycamset_tpu/ops/pallas_cholesky.py``. A hand-written
Hopper kernel (``csrc/psd_solve.cu``) replaces the Pallas kernel
``_pallas_psd_solve_raw``: on the Jacobi-normalised, ridged SPD system of
the LM's reduced (Schur) step it runs a blocked Cholesky with the pivots
clamped at 1e-8, forward and backward substitution, ``refine`` passes of
iterative refinement, and returns the solution with res2 = |b - a x|^2 and
b2 = |b|^2, all in one cooperative launch: the factor and substitutions in
float32, the refinement's residuals and carried solution in float64 (so
that it converges below float32's residual noise, which late LM steps
otherwise sit at, above the fallback threshold; see ``csrc/psd_solve.cu``).

- ``psd_solve_raw`` launches the kernel for a CUDA float32 tensor and raises
  on any other CUDA input; a CPU tensor runs the plain twin
  ``psd_solve_raw_plain`` (the same clamp and refinement count, in the
  input's dtype). It counts its launches in ``psd_solve_raw.launches``.
- ``psd_solve`` adds the reference's residual check: the fallback runs only
  when res2 > 1e-8 b2. JAX decides that on the device (``lax.cond``); here it
  costs one host read of the flag per call, unless the caller defers it
  (``deferred_residual_checks``: the LM's captured step stacks the flag with
  its ``status`` and redoes a failed step with the fallback).
  ``psd_solve.fallbacks`` counts the fallbacks taken. Under vmap it does
  what ``jax.vmap`` makes of ``lax.cond``: the fallback runs on the whole
  batch and each system takes the kernel's x where its residual passes, the
  fallback's where it does not, decided on the device with no host read;
  ``deferred_residual_checks`` is bypassed there (no flag, no rerun).
- ``use_cuda_psd`` is the dispatch rule of ``use_pallas_psd``: opt-in with
  ``PYCAMSET_PALLAS_CHOL=1``, off under ``PYCAMSET_NO_PALLAS``
  (``psd_opted_in``), on a CUDA device, for float32 and n <= MAX_N only.
- ``psd_solve_raw_batched`` is the kernel with a batch axis (the form
  ``jax.vmap`` gives the Pallas kernel, whose grid gains the batch): a
  ``torch.library.custom_op`` (``pycamset_tpu_torch::psd_solve_batched``)
  over (R, n, n) systems, one ordinary launch of one block a system
  (``pct_psd_solve_batched``), which a CUDA graph captures at any batch.
  Its vmap rule folds the batch axis into the op's, so ``psd_solve_raw``
  under ``torch.func.vmap`` (the fleet's LM step) makes one launch a call.
  On CPU tensors it runs the plain twin system by system
  (``psd_solve_raw_plain_batched``). It counts its launches in
  ``psd_solve_raw_batched.launches``; under vmap, the systems whose residual
  misses the rule are counted on the device (``batch_misses``).
- ``psd_diag_tile`` is a debug entry that the solve never calls: the
  kernel's diagonal path alone (one diagonal tile's update by the panel
  beside it, its factor and the factor's inverse) in an ordinary launch of
  one block, for timing that path and holding its inverse against float64
  (``psd_diag_tile_plain``; ``psd_diag_tile_scratch`` builds its input).
"""
from __future__ import annotations

import contextlib
import os

import torch
from torch import Tensor

BLK = 64              # the kernel's panel width
MAX_N = 2048          # a and its factor (8 n^2 bytes) stay in the 50 MB L2
PIV_FLOOR = 1e-8      # pivot clamp of the rank-1 loop (normalised diag ~1)
RES_TOL = 1e-8        # fallback when res2 > RES_TOL * b2 (|r| > 1e-4 |b|)


def clamped_cholesky(a: torch.Tensor) -> torch.Tensor:
    """The kernel's factor of the lower triangle of a, in a's dtype: the
    rank-1 loop with each pivot clamped at PIV_FLOOR."""
    n = a.shape[0]
    chol = torch.zeros_like(a)
    for j in range(n):
        col = a[j:, j] - chol[j:, :j] @ chol[j, :j]
        piv = torch.clamp(col[0], min=PIV_FLOOR)
        chol[j:, j] = col / torch.sqrt(piv)
    return chol


def psd_solve_raw_plain(a_n: torch.Tensor, rhs_n: torch.Tensor,
                        refine: int = 2):
    """Plain twin of the kernel: (x, res2, b2) in the input's dtype. The
    factor and the substitutions run in the input's dtype; the refinement
    carries x and forms its residuals in float64, and res2 is the residual
    of that carried x (the returned x is it, rounded)."""
    chol = clamped_cholesky(a_n)

    def solve(rhs):
        y = torch.linalg.solve_triangular(chol, rhs[:, None], upper=False)
        return torch.linalg.solve_triangular(chol.T, y, upper=True)[:, 0]

    a64, b64 = a_n.double(), rhs_n.double()
    x = solve(rhs_n).double()
    for _ in range(refine):
        x = x + solve((b64 - a64 @ x).to(a_n.dtype)).double()
    r = b64 - a64 @ x
    dtype = a_n.dtype
    return (x.to(dtype), torch.sum(r * r).to(dtype),
            torch.sum(b64 * b64).to(dtype))


def psd_solve_raw_plain_batched(a_n: torch.Tensor, rhs_n: torch.Tensor,
                                refine: int = 2):
    """The plain twin over a leading batch axis, (R, n, n) and (R, n) ->
    x (R, n), res2 (R,), b2 (R,): each system by ``psd_solve_raw_plain``.
    For CPU tensors only (the batched kernel's counterpart)."""
    outs = [psd_solve_raw_plain(a, b, refine) for a, b in zip(a_n, rhs_n)]
    return tuple(torch.stack(t) for t in zip(*outs))


def _check_cuda_inputs(a_n: torch.Tensor, rhs_n: torch.Tensor,
                       batched: bool = False):
    """The kernels' input rule: float32 on one device, (n, n) and (n,)
    contiguous for the one-system kernel; (..., n, n) and (..., n) for the
    batched one, which makes its own contiguous copy; 1 <= n <= MAX_N."""
    for name, t in (("a_n", a_n), ("rhs_n", rhs_n)):
        if t.device != a_n.device:
            raise ValueError(f"{name} is on {t.device}, a_n on {a_n.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the CUDA kernel takes "
                            f"torch.float32")
        if not batched and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    shape = tuple(a_n.shape)
    n = shape[-1] if len(shape) >= 2 else -1
    lead = shape[:-2] if batched else ()
    if shape != (*lead, n, n) or tuple(rhs_n.shape) != (*lead, n):
        form = "(..., n, n) and (..., n)" if batched else "(n, n) and (n,)"
        raise ValueError(f"a_n {shape} and rhs_n {tuple(rhs_n.shape)} are "
                         f"not {form}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"n = {n} is outside the kernel's range 1..{MAX_N}")


def psd_solve_raw(a_n: torch.Tensor, rhs_n: torch.Tensor, refine: int = 2):
    """Solve the normalised SPD system a_n x = rhs_n in one kernel launch;
    returns (x, res2, b2), the last two as 0-d tensors on the device. Under
    ``torch.func.vmap`` the batched kernel solves the whole batch in one
    launch (``psd_solve_raw_batched``)."""
    if _batched(a_n, rhs_n):
        return psd_solve_raw_batched(a_n, rhs_n, refine)
    if a_n.device.type == "cpu":
        return psd_solve_raw_plain(a_n, rhs_n, refine)
    _check_cuda_inputs(a_n, rhs_n)
    if refine < 0:
        raise ValueError(f"refine = {refine} < 0")
    from pycamset_tpu_torch._build import load
    n = a_n.shape[0]
    p = -(-n // BLK)
    dev = a_n.device
    with torch.cuda.device(dev):
        out = torch.empty(n + 2, dtype=torch.float32, device=dev)
        l, minv, w, y = torch.empty(
            n * n + p * BLK * BLK + 2 * n, dtype=torch.float32,
            device=dev).split([n * n, p * BLK * BLK, n, n])
        xd, rd = torch.empty(2 * n, dtype=torch.float64, device=dev).split(n)
        rc = load().lib.pct_psd_solve(
            a_n.data_ptr(), rhs_n.data_ptr(), n, int(refine),
            out.data_ptr(), out[n:].data_ptr(), l.data_ptr(), minv.data_ptr(),
            w.data_ptr(), y.data_ptr(), xd.data_ptr(), rd.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"psd_solve_raw launch failed: cudaError {rc}")
    psd_solve_raw.launches += 1
    return out[:n], out[n], out[n + 1]


psd_solve_raw.launches = 0


def batch_smem_max_n() -> int:
    """The largest n whose factor the batched kernel keeps in shared memory
    (above it, in a device scratch it is given); asks the built library."""
    from pycamset_tpu_torch._build import load
    return int(load().lib.pct_psd_batched_smem_max_n())


@torch.library.custom_op("pycamset_tpu_torch::psd_solve_batched",
                         mutates_args=())
def _psd_solve_batched_op(a_n: Tensor, rhs_n: Tensor,
                          refine: int) -> tuple[Tensor, Tensor, Tensor]:
    """(..., n, n), (..., n) -> x (..., n), res2 (...), b2 (...): every
    system in one launch of the batched kernel (CPU tensors: the plain
    twin, system by system)."""
    if refine < 0:
        raise ValueError(f"refine = {refine} < 0")
    lead, n = a_n.shape[:-2], a_n.shape[-1]
    a3 = a_n.reshape(-1, n, n)
    b2d = rhs_n.reshape(-1, n)
    if a_n.device.type == "cpu":
        x, res2, b2 = psd_solve_raw_plain_batched(a3, b2d, refine)
        return x.reshape(*lead, n), res2.reshape(lead), b2.reshape(lead)
    _check_cuda_inputs(a_n, rhs_n, batched=True)
    from pycamset_tpu_torch._build import load
    lib = load().lib
    r = a3.shape[0]
    dev = a_n.device
    with torch.cuda.device(dev):
        a3, b2d = a3.contiguous(), b2d.contiguous()
        x = torch.empty((r, n), dtype=torch.float32, device=dev)
        res2 = torch.empty(r, dtype=torch.float32, device=dev)
        b2 = torch.empty(r, dtype=torch.float32, device=dev)
        scratch = (torch.empty(r * n * (n | 1), dtype=torch.float32,
                               device=dev)
                   if n > batch_smem_max_n() else None)
        rc = lib.pct_psd_solve_batched(
            a3.data_ptr(), b2d.data_ptr(), r, n, int(refine), x.data_ptr(),
            res2.data_ptr(), b2.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"psd_solve_raw_batched launch failed: cudaError {rc}")
    psd_solve_raw_batched.launches += 1
    return x.reshape(*lead, n), res2.reshape(lead), b2.reshape(lead)


# per device: the systems under vmap whose residual missed the rule (0-d
# int64 tensors, made on the first, uncaptured, call on that device)
_batch_misses: dict = {}


def _device_key(device) -> torch.device:
    """``device`` with its index: a CUDA device named without one is the
    current device, so "cuda" and "cuda:0" name one counter."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def batch_misses(device) -> torch.Tensor:
    """The device counter of the systems, solved by the batched kernel
    under vmap, whose residual missed the rule (res2 > RES_TOL b2): under
    ``psd_solve`` each took the fallback's x. Made at 0 on first use (a
    graph that captures the count must follow an uncaptured call)."""
    device = _device_key(device)
    if device not in _batch_misses:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the batched SPD kernel's miss counter is "
                               "made by an uncaptured call first")
        _batch_misses[device] = torch.zeros((), dtype=torch.int64,
                                            device=device)
    return _batch_misses[device]


def reset_batch_counts():
    """Zero the batched kernel's launch count and every device's miss
    counter (in place: a captured graph keeps adding to the same one)."""
    psd_solve_raw_batched.launches = 0
    for t in _batch_misses.values():
        t.zero_()


@_psd_solve_batched_op.register_vmap
def _psd_solve_batched_vmap(info, in_dims, a_n, rhs_n, refine):
    r = info.batch_size

    def lead(t, d):
        return (t.movedim(d, 0) if d is not None
                else t.expand(r, *t.shape))

    x, res2, b2 = _psd_solve_batched_op(lead(a_n, in_dims[0]),
                                        lead(rhs_n, in_dims[1]), refine)
    misses = batch_misses(x.device)
    misses.add_((~residual_ok(res2, b2)).sum())
    return (x, res2, b2), (0, 0, 0)


def psd_solve_raw_batched(a_n: torch.Tensor, rhs_n: torch.Tensor,
                          refine: int = 2):
    """The batched kernel on (R, n, n) systems and (R, n) right-hand
    sides -> (x (R, n), res2 (R,), b2 (R,)), one launch (CPU tensors: the
    plain twin). Under ``torch.func.vmap`` its rule folds the vmapped axis
    into R, so a vmapped call is one launch too."""
    return _psd_solve_batched_op(a_n, rhs_n, int(refine))


psd_solve_raw_batched.launches = 0


def _tile_bounds(n: int, k: int) -> tuple[int, int]:
    """First row and row count of tile k + 1, checked against n."""
    t0 = (k + 1) * BLK
    if not (k >= -1 and t0 < n):
        raise ValueError(f"k = {k}: tile k + 1 is not a tile of n = {n}")
    return t0, min(BLK, n - t0)


def psd_diag_tile_scratch(a_n: torch.Tensor, k: int) -> torch.Tensor:
    """The kernel's factor buffer as it stands before panel step k + 1,
    from the float64 factor of a_n, in a_n's dtype: tile k + 1 updated by
    the panels before k, the panel k's rows beside it holding their L, the
    other entries a_n's."""
    t0, tb = _tile_bounds(a_n.shape[0], k)
    a64 = a_n.double()
    l = a64.clone()
    if k >= 0:
        chol = clamped_cholesky(a64)
        rows = slice(t0, t0 + tb)
        done = chol[rows, :k * BLK]
        l[rows, rows] = a64[rows, rows] - done @ done.T
        l[rows, k * BLK:t0] = chol[rows, k * BLK:t0]
    return l.to(a_n.dtype).contiguous()


def psd_diag_tile_plain(l: torch.Tensor, k: int) -> torch.Tensor:
    """Plain twin of the diagonal path, in l's dtype: tile k + 1 of l
    (lower triangle) less P P^T, P the panel k's rows beside it (none for
    k = -1), padded to 64 with the identity, factored by the clamped loop;
    returns the factor's inverse (64, 64)."""
    t0, tb = _tile_bounds(l.shape[0], k)
    rows = slice(t0, t0 + tb)
    tile = l[rows, rows]
    if k >= 0:
        p = l[rows, k * BLK:t0]
        tile = tile - p @ p.T
    a = torch.eye(BLK, dtype=l.dtype, device=l.device)
    a[:tb, :tb] = tile
    return torch.linalg.solve_triangular(clamped_cholesky(a), torch.eye(
        BLK, dtype=l.dtype, device=l.device), upper=False)


def psd_diag_tile(l: torch.Tensor, k: int) -> torch.Tensor:
    """The SPD kernel's diagonal path alone on tile k + 1 of the factor
    buffer l (``psd_diag_tile_scratch``): the inverse (64, 64) of the tile's
    factor after its update by panel k, by the kernel's own device function
    in one ordinary launch of one block. A debug entry: the solve never
    calls it. Counts its launches in ``psd_diag_tile.launches``."""
    if l.device.type == "cpu":
        return psd_diag_tile_plain(l, k)
    if l.dtype != torch.float32:
        raise TypeError(f"l is {l.dtype}; the CUDA kernel takes torch.float32")
    if l.dim() != 2 or l.shape[0] != l.shape[1] or not l.is_contiguous():
        raise ValueError(f"l {tuple(l.shape)} is not a contiguous (n, n)")
    n = l.shape[0]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"n = {n} is outside the kernel's range 1..{MAX_N}")
    _tile_bounds(n, k)
    from pycamset_tpu_torch._build import load
    with torch.cuda.device(l.device):
        out = torch.empty(BLK, BLK, dtype=torch.float32, device=l.device)
        rc = load().lib.pct_psd_diag_tile(
            l.data_ptr(), n, int(k), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"psd_diag_tile launch failed: cudaError {rc}")
    psd_diag_tile.launches += 1
    return out


psd_diag_tile.launches = 0


def _batched(*ts) -> bool:
    """Whether any of ``ts`` is batched by ``torch.func.vmap``."""
    return any(torch._C._functorch.is_batchedtensor(t) for t in ts)


def residual_ok(res2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The reference's acceptance rule for a dense solve, res2 <= RES_TOL b2
    (false where either is NaN), as a boolean tensor on their device."""
    return res2 <= RES_TOL * b2


class _Deferred:
    """The open ``deferred_residual_checks``: its flags, and whether it
    takes the fallback outright."""

    def __init__(self, take_fallback: bool):
        self.flags: list[torch.Tensor] = []
        self.take_fallback = take_fallback


_deferred: _Deferred | None = None


@contextlib.contextmanager
def deferred_residual_checks(take_fallback: bool = False):
    """Inside it, ``psd_solve`` with a fallback reads no flag on the host:
    it appends ``residual_ok(res2, b2)`` (a 0-d boolean on the device) to
    the yielded list and returns the kernel's x, so that a caller can read
    every flag later with its own data, in one read. A caller whose flag
    is false does that work again under ``take_fallback=True``, where
    ``psd_solve`` launches no kernel, counts a fallback and returns the
    fallback's x: the result of the undeferred call on the same system."""
    global _deferred
    outer, _deferred = _deferred, _Deferred(take_fallback)
    try:
        yield _deferred.flags
    finally:
        _deferred = outer


def psd_solve(a_n: torch.Tensor, rhs_n: torch.Tensor, *, refine: int = 2,
              fallback=None) -> torch.Tensor:
    """Solve the Jacobi-normalised SPD system a_n x = rhs_n in one kernel.

    :param fallback: optional (a_n, rhs_n) -> x, run instead when the
        kernel's final relative residual exceeds 1e-4 (res2 > 1e-8 b2):
        numerically hostile systems where the float32 factor and its
        refinement did not converge. Each fallback taken adds one to
        ``psd_solve.fallbacks``. The check reads a flag on the host unless
        it is deferred (``deferred_residual_checks``).
    """
    if fallback is not None and _batched(a_n, rhs_n):
        # jax.vmap of lax.cond: both branches, selected per system on the
        # device (batch_misses counts the systems that took the fallback)
        x, res2, b2 = psd_solve_raw(a_n, rhs_n, refine=refine)
        return torch.where(residual_ok(res2, b2), x,
                           fallback(a_n, rhs_n).to(x.dtype))
    if fallback is not None and _deferred is not None \
            and _deferred.take_fallback:
        psd_solve.fallbacks += 1
        return fallback(a_n, rhs_n).to(a_n.dtype)
    x, res2, b2 = psd_solve_raw(a_n, rhs_n, refine=refine)
    if fallback is None:
        return x
    ok = residual_ok(res2, b2)
    if _deferred is not None:
        _deferred.flags.append(ok)
        return x
    if bool(ok):                        # one host read per call
        return x
    psd_solve.fallbacks += 1
    return fallback(a_n, rhs_n).to(x.dtype)


psd_solve.fallbacks = 0


def psd_opted_in() -> bool:
    """The opt-in half of the dispatch rule: ``PYCAMSET_PALLAS_CHOL=1`` and
    no ``PYCAMSET_NO_PALLAS``, read at call time."""
    return (not os.environ.get("PYCAMSET_NO_PALLAS")
            and os.environ.get("PYCAMSET_PALLAS_CHOL") == "1")


def use_cuda_psd(n: int, dtype, device) -> bool:
    """Dispatch rule (``use_pallas_psd``'s): OPT-IN via
    ``PYCAMSET_PALLAS_CHOL=1``, off under ``PYCAMSET_NO_PALLAS``; a CUDA
    device, float32 and 1 <= n <= MAX_N required. Read at call time."""
    return (torch.device(device).type == "cuda"
            and dtype == torch.float32
            and 1 <= n <= MAX_N
            and psd_opted_in())
