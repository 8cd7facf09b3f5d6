"""Port parity: the one-launch dense SPD solve (ops/cuda_cholesky.py).

On CPU tensors ``psd_solve_raw`` runs its plain twin, which is held against
the JAX package's Pallas kernel ``_pallas_psd_solve_raw`` in interpret mode
on the systems of ``tests/test_pallas_cholesky.py`` (float32 on both sides)
and against ``np.linalg.solve`` in float64; its batched form (the batched
kernel's op) against ``jax.vmap`` of the Pallas kernel. Then the zero
right-hand side,
the residual fallback and its count, the opt-in dispatch rule, and the
template and self-cal LM solves with the one-launch route forced in both
packages.

Tolerances. x: the JAX test's own bound for each case, on the difference of
the two float32 solves relative to |x64| (each float32 solve is within that
bound of float64, and they sum in different orders). sqrt(res2 / b2): the
same bound (each is the float32 factor's backward error). b2: 1e-6 relative
(one float32 sum of n squares in two orders). Float64: 1e-9 relative to
np.linalg.solve (condition <= 1e6 times float64 rounding).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pycamset_tpu.ops.pallas_cholesky as pc
import test_torch_selfcal
import test_torch_slice
from pycamset_tpu_torch.ops import cuda_cholesky as cc
from pycamset_tpu_torch.optim import structured as ts
from pycamset_tpu_torch.problems import selfcal_problem, standard_problem
from test_pallas_cholesky import _normalized_spd

CASES = [(64, 1e3, 1e-4), (128, 1e2, 1e-4), (200, 1e4, 1e-3),
         (384, 1e6, 2e-2)]


@pytest.mark.parametrize("n,cond,tol", CASES)
def test_plain_twin_matches_the_pallas_kernel(n, cond, tol):
    a_n, rhs = _normalized_spd(n, cond)
    xj, rj, bj = pc._pallas_psd_solve_raw(jnp.asarray(a_n, jnp.float32),
                                          jnp.asarray(rhs, jnp.float32),
                                          interpret=True)
    xt, rt, bt = cc.psd_solve_raw(torch.tensor(a_n, dtype=torch.float32),
                                  torch.tensor(rhs, dtype=torch.float32))
    assert xt.dtype == torch.float32 and xt.shape == (n,)
    x_ref = np.linalg.solve(a_n, rhs)
    scale = np.linalg.norm(x_ref)
    xt = xt.double().numpy()
    assert np.linalg.norm(xt - x_ref) / scale < tol
    assert np.linalg.norm(xt - np.asarray(xj, np.float64)) / scale < tol
    assert abs(np.sqrt(float(rt) / float(bt))
               - np.sqrt(float(rj) / float(bj))) < tol
    assert abs(float(bt) / float(bj) - 1.0) < 1e-6


@pytest.mark.parametrize("n,cond,tol", [(33, 1e3, 1e-4), (64, 1e3, 1e-4)])
def test_batched_twin_matches_the_vmapped_pallas_kernel(n, cond, tol):
    """The batched kernel's op on CPU tensors (its twin, system by system)
    and ``psd_solve_raw`` under torch.func.vmap against ``jax.vmap`` of the
    Pallas kernel (a batch axis in its grid) in interpret mode: a batch of
    3, each system under the one-system cases' bounds; the vmapped call is
    the op's result bit for bit."""
    import jax
    a_n, rhs = (np.stack(t) for t in zip(
        *(_normalized_spd(n, cond, seed=s) for s in range(3))))
    xj, rj, bj = jax.vmap(functools.partial(
        pc._pallas_psd_solve_raw, interpret=True))(
            jnp.asarray(a_n, jnp.float32), jnp.asarray(rhs, jnp.float32))
    a32 = torch.tensor(a_n, dtype=torch.float32)
    b32 = torch.tensor(rhs, dtype=torch.float32)
    xt, rt, bt = cc.psd_solve_raw_batched(a32, b32)
    assert xt.shape == (3, n) and rt.shape == bt.shape == (3,)
    for p, q in zip(torch.func.vmap(cc.psd_solve_raw)(a32, b32),
                    (xt, rt, bt)):
        assert torch.equal(p, q)
    for i in range(3):
        x_ref = np.linalg.solve(a_n[i], rhs[i])
        scale = np.linalg.norm(x_ref)
        x = xt[i].double().numpy()
        assert np.linalg.norm(x - x_ref) / scale < tol
        assert np.linalg.norm(x - np.asarray(xj[i], np.float64)) / scale < tol
        assert abs(np.sqrt(float(rt[i]) / float(bt[i]))
                   - np.sqrt(float(rj[i]) / float(bj[i]))) < tol
        assert abs(float(bt[i]) / float(bj[i]) - 1.0) < 1e-6


def test_vmapped_fallback_selects_per_system():
    """``psd_solve`` with a fallback under vmap: the fallback runs on the
    whole batch, and each system takes the kernel's x where its residual
    passes and the fallback's where it does not (a NaN system here),
    counted on the device; the deferred checks are bypassed."""
    a_n, rhs = (np.stack(t) for t in zip(
        *(_normalized_spd(32, 1e2, seed=s) for s in range(3))))
    a = torch.tensor(a_n, dtype=torch.float32)
    a[1, 3, 5] = float("nan")
    b = torch.tensor(rhs, dtype=torch.float32)
    marker = torch.full((32,), 7.0)
    misses = int(cc.batch_misses("cpu"))
    with cc.deferred_residual_checks() as flags:
        x = torch.func.vmap(lambda a_, b_: cc.psd_solve(
            a_, b_, fallback=lambda *_: marker))(a, b)
    assert flags == []
    assert torch.equal(x[1], marker)
    for i in (0, 2):
        assert torch.equal(x[i], cc.psd_solve_raw(a[i], b[i])[0])
    assert int(cc.batch_misses("cpu")) == misses + 1


# The kernels' one input rule: the one-system kernel takes (n, n) and (n,)
# contiguous, the batched kernel any leading axes, (..., n, n) and (..., n).
@pytest.mark.parametrize("a_shape,b_shape,batched,ok", [
    ((5, 5), (5,), False, True),
    ((1, 5, 5), (1, 5), False, False),
    ((5, 5), (4,), False, False),
    ((2, 3, 5, 5), (2, 3, 5), True, True),
    ((5, 5), (5,), True, True),
    ((2, 5, 5), (3, 5), True, False),
    ((2, 5, 4), (2, 5), True, False),
    ((5,), (5,), True, False),
])
def test_kernel_input_rule(a_shape, b_shape, batched, ok):
    a, b = torch.ones(a_shape), torch.ones(b_shape)
    if ok:
        cc._check_cuda_inputs(a, b, batched=batched)
    else:
        with pytest.raises(ValueError, match="are not"):
            cc._check_cuda_inputs(a, b, batched=batched)
    with pytest.raises(TypeError):
        cc._check_cuda_inputs(a.double(), b.double(), batched=batched)


def test_input_rule_contiguity_is_the_one_system_kernels():
    a, b = torch.ones(6, 6)[:, :5][:5], torch.ones(5)
    with pytest.raises(ValueError, match="contiguous"):
        cc._check_cuda_inputs(a, b)
    cc._check_cuda_inputs(a, b, batched=True)
    with pytest.raises(ValueError, match="outside"):
        cc._check_cuda_inputs(torch.ones(1, 0, 0), torch.ones(1, 0),
                              batched=True)


def test_miss_counter_names_a_cuda_device_by_its_index(monkeypatch):
    """"cuda" is the current device: one counter key with "cuda:<index>"."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert cc._device_key("cuda") == torch.device("cuda", 1)
    assert cc._device_key("cuda:1") == cc._device_key(torch.device("cuda"))
    assert cc._device_key("cuda:0") == torch.device("cuda", 0)
    assert cc._device_key("cpu") == torch.device("cpu")


@pytest.mark.parametrize("n,cond,tol", CASES)
def test_plain_twin_float64_matches_numpy(n, cond, tol):
    a_n, rhs = _normalized_spd(n, cond)
    x, res2, b2 = cc.psd_solve_raw(torch.tensor(a_n), torch.tensor(rhs))
    assert x.dtype == torch.float64
    x_ref = np.linalg.solve(a_n, rhs)
    assert (np.linalg.norm(x.numpy() - x_ref) / np.linalg.norm(x_ref)
            < 1e-9)
    assert float(res2) <= 1e-20 * float(b2)
    assert float(b2) == pytest.approx(float(rhs @ rhs), rel=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_zero_rhs_gives_zero_solution(dtype):
    a_n, _ = _normalized_spd(200, 1e3)
    x, res2, b2 = cc.psd_solve_raw(torch.tensor(a_n, dtype=dtype),
                                   torch.zeros(200, dtype=dtype))
    assert torch.equal(x, torch.zeros_like(x))
    assert float(res2) == 0.0 and float(b2) == 0.0


def test_residual_fallback_is_taken_and_counted_on_a_hostile_system():
    """A NaN entry must fail the residual check and route through the
    fallback, counted; a healthy system must not."""
    a_n, rhs = _normalized_spd(128, 1e2)
    a_bad = a_n.copy()
    a_bad[3, 5] = a_bad[5, 3] = np.nan
    calls = []

    def fallback(a, b):
        calls.append(1)
        return torch.zeros_like(b) + 7.0

    f32 = functools.partial(torch.tensor, dtype=torch.float32)
    before = cc.psd_solve.fallbacks
    x = cc.psd_solve(f32(a_bad), f32(rhs), fallback=fallback)
    assert calls and cc.psd_solve.fallbacks == before + 1
    assert torch.equal(x, torch.full_like(x, 7.0))

    x_ok = cc.psd_solve(f32(a_n), f32(rhs), fallback=fallback)
    assert len(calls) == 1 and cc.psd_solve.fallbacks == before + 1
    x_ref = np.linalg.solve(a_n, rhs)
    assert (np.linalg.norm(x_ok.double().numpy() - x_ref)
            / np.linalg.norm(x_ref) < 1e-4)


@pytest.mark.parametrize("res2, b2, ok", [
    (1e-8, 1.0, True), (2e-8, 1.0, False), (0.0, 0.0, True),
    (float("nan"), 1.0, False), (0.0, float("nan"), False)])
def test_residual_rule_is_the_references(res2, b2, ok):
    """``residual_ok`` is ``pallas_psd_solve``'s res2 <= 1e-8 b2, NaN
    failing it, in float32 as the kernel returns them."""
    f32 = functools.partial(torch.tensor, dtype=torch.float32)
    assert bool(cc.residual_ok(f32(res2), f32(b2))) is ok


def test_cpu_wrapper_launches_nothing():
    a_n, rhs = _normalized_spd(64, 1e2)
    before = cc.psd_solve_raw.launches
    cc.psd_solve_raw(torch.tensor(a_n), torch.tensor(rhs))
    assert cc.psd_solve_raw.launches == before


# The diagonal-path entry's plain twin and its input: on the factor buffer
# before panel step k + 1 (psd_diag_tile_scratch), the inverse of tile k +
# 1's factor, against numpy's Cholesky factor of the whole system in
# float64 (1e-9 of the inverse's max-abs: condition <= 1e4 times float64
# rounding). n = 200: three full tiles and a last one of 8 rows, padded
# with the identity.
@pytest.mark.parametrize("k", [-1, 0, 1, 2])
@pytest.mark.parametrize("cond", [1e2, 1e4])
def test_diag_tile_twin_inverts_the_factor_tile(k, cond):
    n, t0 = 200, (k + 1) * cc.BLK
    a_n, _ = _normalized_spd(n, cond)
    l = cc.psd_diag_tile_scratch(torch.tensor(a_n), k)
    before = cc.psd_diag_tile.launches
    got = cc.psd_diag_tile(l, k).numpy()
    assert cc.psd_diag_tile.launches == before
    tb = min(cc.BLK, n - t0)
    ref = np.eye(cc.BLK)
    ref[:tb, :tb] = np.linalg.inv(
        np.linalg.cholesky(a_n)[t0:t0 + tb, t0:t0 + tb])
    assert np.abs(got - ref).max() <= 1e-9 * np.abs(ref).max()
    assert not np.triu(got, 1).any()


def test_diag_tile_float32_twin_is_within_the_card_tests_bound():
    """The float32 twin on the float32 buffer against the float64 twin on
    the same buffer, at the card test's 1e-4 of the max-abs."""
    a_n, _ = _normalized_spd(200, 1e4)
    for k in (-1, 0, 2):
        l = cc.psd_diag_tile_scratch(torch.tensor(a_n, dtype=torch.float32),
                                     k)
        got = cc.psd_diag_tile(l, k)
        ref = cc.psd_diag_tile_plain(l.double(), k)
        assert got.dtype == torch.float32
        assert (got.double() - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize("k", [-2, 3])
def test_diag_tile_rejects_a_tile_outside_the_system(k):
    l = torch.eye(200)
    with pytest.raises(ValueError):
        cc.psd_diag_tile(l, k)


def test_dispatch_rule(monkeypatch):
    """Opt-in only (as use_pallas_psd): CUDA, float32, n <= MAX_N; the
    reference's two variables, read at call time. No card is needed: the
    rule only looks at the device's type."""
    cuda = torch.device("cuda", 0)
    monkeypatch.delenv("PYCAMSET_PALLAS_CHOL", raising=False)
    monkeypatch.delenv("PYCAMSET_NO_PALLAS", raising=False)
    assert not cc.use_cuda_psd(852, torch.float32, cuda)   # off by default
    monkeypatch.setenv("PYCAMSET_PALLAS_CHOL", "1")
    assert cc.use_cuda_psd(852, torch.float32, cuda)
    assert cc.use_cuda_psd(cc.MAX_N, torch.float32, "cuda")
    assert cc.MAX_N >= 1088                # the 1032/1044-wide 64x12 systems
    assert not cc.use_cuda_psd(cc.MAX_N + 1, torch.float32, cuda)
    assert not cc.use_cuda_psd(852, torch.float64, cuda)
    assert not cc.use_cuda_psd(852, torch.float32, torch.device("cpu"))
    monkeypatch.setenv("PYCAMSET_PALLAS_CHOL", "0")
    assert not cc.use_cuda_psd(852, torch.float32, cuda)
    monkeypatch.setenv("PYCAMSET_PALLAS_CHOL", "1")
    monkeypatch.setenv("PYCAMSET_NO_PALLAS", "1")
    assert not cc.use_cuda_psd(852, torch.float32, cuda)


def test_default_psd_solve_is_the_library_route(monkeypatch):
    """Without the opt-in, _psd_solve is cholesky_ex + refinement, bit for
    bit, and never reaches psd_solve."""
    monkeypatch.delenv("PYCAMSET_PALLAS_CHOL", raising=False)
    monkeypatch.setattr(ts, "psd_solve", None)
    rng = np.random.default_rng(3)
    base = rng.normal(size=(60, 76))
    amat = torch.tensor(base @ base.T / 60 + np.diag(rng.uniform(1, 5, 60)))
    rhs = torch.tensor(rng.normal(size=60))
    d = torch.sqrt(torch.diagonal(amat))
    a_n = amat / d[:, None] / d[None, :] + 10 * torch.finfo(
        torch.float64).eps * torch.eye(60, dtype=torch.float64)
    want = ts._cho_refine_solve(a_n, rhs / d) / d
    assert torch.equal(ts._psd_solve(amat, rhs), want)


def _force_one_launch_route(monkeypatch):
    """Both packages take their one-launch route: JAX's Pallas kernel in
    interpret mode (test-side patches only), the port's psd_solve (the
    plain twin on CPU tensors). Returns the port's call count."""
    interp = functools.partial(pc.pallas_psd_solve, interpret=True)
    monkeypatch.setattr(pc, "use_pallas_psd", lambda n, dtype: True)
    monkeypatch.setattr(pc, "pallas_psd_solve", interp)
    calls = []
    orig = ts.psd_solve

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(ts, "use_cuda_psd", lambda n, dtype, device: True)
    monkeypatch.setattr(ts, "psd_solve", counted)
    return calls


# The JAX kernel solves each reduced system in float32 (then refines it)
# inside the float64 LM, the port's twin in float64: the steps differ by
# float32's solve error, which the LM's acceptance absorbs on these rigs.
# Required: the same status and iterations, the final costs (both at the
# 0.3 px noise floor) within 1e-9 relative (7e-13 seen).
@pytest.mark.parametrize("chain", ["template", "selfcal"])
def test_lm_with_the_one_launch_route_matches_jax(monkeypatch, chain):
    calls = _force_one_launch_route(monkeypatch)
    if chain == "template":
        ref = test_torch_slice._jax_solve(3, 5, 6, "linear")
        prob = standard_problem(3, 5, "cpu", grid=6, k_pad_multiple=8)
    else:
        ref = test_torch_selfcal._jax_solve(3, 5, "linear")
        prob = selfcal_problem(3, 5, "cpu", grid=6, k_pad_multiple=8)
    got = prob.solve()
    assert len(calls) == got.nit         # one dense solve per LM step
    assert int(got.status) == int(ref.status) and int(got.status) in (1, 2)
    assert got.nit == int(ref.nit)
    assert abs(float(got.cost) - float(ref.cost)) <= 1e-9 * float(ref.cost)
