"""Port parity: the structured normal equations and the Schur step.

The same numpy inputs go through pycamset_tpu.optim.structured and its
pycamset_tpu_torch counterpart (float64, JAX on the CPU). Tolerances are
relative to each output's max-abs scale; layout helpers must be identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycamset_tpu.optim import structured as js
from pycamset_tpu.optim.blocks import Extrinsic3D, Projection, TemplatePoints
from pycamset_tpu.optim.chain import OptimFunction
from pycamset_tpu.utils.synthetic import make_synthetic_rig
from pycamset_tpu_torch.from_jax import grid_from_numpy, pieces_from_numpy
from pycamset_tpu_torch.optim import blocks as tb
from pycamset_tpu_torch.optim import structured as ts
from pycamset_tpu_torch.optim.chain import OptimFunction as TOptimFunction


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if not ref.size:
        return 0.0
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)


def _spd_blocks(n, size, seed):
    """Batched SPD blocks with a wide diagonal scale spread (like the
    fx^2-vs-rotation disparity of the real pose/camera blocks)."""
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(n, size, size + 4))
    a = m @ m.transpose(0, 2, 1) + 0.1 * np.eye(size)
    d = 10.0 ** rng.uniform(-2, 4, size=(n, size))
    return a * d[:, :, None] * d[:, None, :]


@pytest.mark.parametrize("size", [1, 2, 3, 6])
def test_normalized_inv_matches_jax(size):
    a = _spd_blocks(7, size, seed=size)
    ref = np.asarray(js._normalized_inv(jnp.asarray(a)))
    got = ts._normalized_inv(torch.tensor(a)).numpy()
    assert _rel(got, ref) <= 1e-9


def test_psd_solve_matches_jax():
    a = _spd_blocks(1, 45, seed=5)[0]
    rhs = np.random.default_rng(6).normal(size=45)
    ref = np.asarray(js._psd_solve(jnp.asarray(a), jnp.asarray(rhs)))
    got = ts._psd_solve(torch.tensor(a), torch.tensor(rhs)).numpy()
    assert _rel(got, ref) <= 1e-9


def test_block_diag_helpers_match_jax():
    blocks = _spd_blocks(4, 3, seed=1)
    full = np.random.default_rng(2).normal(size=(4, 4, 3, 3))
    assert np.array_equal(
        ts.block_diag_dense(torch.tensor(blocks)).numpy(),
        np.asarray(js.block_diag_dense(jnp.asarray(blocks))))
    assert np.array_equal(
        ts._block_diag_add(torch.tensor(full), torch.tensor(blocks)).numpy(),
        np.asarray(js._block_diag_add(jnp.asarray(full),
                                      jnp.asarray(blocks))))


def _problem(n_cams, n_ims, seed=0):
    rig = make_synthetic_rig(n_cams=n_cams, n_ims=n_ims, grid=5,
                             visibility=0.8, noise_px=0.5, seed=seed)
    n_keys = rig["n_keys"]
    jop = OptimFunction([Projection(), Extrinsic3D(), TemplatePoints()])
    top = TOptimFunction([tb.Projection(), tb.Extrinsic3D(),
                          tb.TemplatePoints()])
    full = np.concatenate([rig["intr"].ravel(), rig["extr"].ravel(),
                           rig["poses"].ravel()])
    full = full + np.random.default_rng(seed + 1).normal(size=full.size) * 1e-3
    return rig, n_keys, jop, top, full


def test_build_block_arrays_identical():
    rig, n_keys, *_ = _problem(3, 5)
    ref = js.build_block_arrays(rig["dd"], 3, 5, n_keys, k_pad_multiple=8)
    got = ts.build_block_arrays(rig["dd"], 3, 5, n_keys, k_pad_multiple=8)
    assert np.array_equal(got.uv, ref.uv)
    assert np.array_equal(got.mask, ref.mask)
    assert (got.n_cams, got.n_ims, got.n_keys, got.n_real) == (
        ref.n_cams, ref.n_ims, ref.n_keys, ref.n_real)


def test_split_merge_round_trip_identical():
    rig, n_keys, jop, top, full = _problem(3, 5)
    jw, tw = js.chain_widths(jop), ts.chain_widths(top)
    assert (tw.a, tw.b, tw.c) == (jw.a, jw.b, jw.c) == (15, 6, 0)
    jst, tst = jop.param_struct(3, 5, n_keys), top.param_struct(3, 5, n_keys)
    assert tst.total == jst.total and np.array_equal(tst.starts, jst.starts)
    ref = js.split_full_params(jnp.asarray(full), jop, jst, 3, 5, n_keys, jw)
    got = ts.split_full_params(torch.tensor(full), top, tst, 3, 5, n_keys, tw)
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))
    back = ts.merge_pieces_to_full(got, top, tst, 3, 5, n_keys)
    assert np.array_equal(back.numpy(), full)
    assert np.array_equal(
        back.numpy(), np.asarray(js.merge_pieces_to_full(ref, jop, jst, 3, 5,
                                                         n_keys)))


def _neqs(n_cams, n_ims, loss="linear", semantics="component"):
    """The JAX and port NormalEq of one rig at the same parameters."""
    rig, n_keys, jop, top, full = _problem(n_cams, n_ims)
    jw, tw = js.chain_widths(jop), ts.chain_widths(top)
    st = jop.param_struct(n_cams, n_ims, n_keys)
    blocks = js.build_block_arrays(rig["dd"], n_cams, n_ims, n_keys,
                                   k_pad_multiple=8)
    k_pad = blocks.uv.shape[1]
    tpl = js.pad_template_table(rig["template"], True, n_keys, k_pad)
    p = js.split_full_params(full, jop, st, n_cams, n_ims, n_keys, jw, xp=np)
    cm_cam = np.ones((n_cams, 15))
    cm_cam[1, 4] = 0.0
    cm_im = np.ones((n_ims, 6))
    cm_im[0] = 0.0
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    jneq = js.make_structured_neq(jop, jw, n_cams, n_ims, **kw)(
        js.ParamPieces(jnp.asarray(p.cam), jnp.asarray(p.im),
                       jnp.zeros((k_pad, 0))),
        jnp.asarray(blocks.uv), jnp.asarray(blocks.mask), jnp.asarray(tpl),
        js.ParamPieces(cm_cam, cm_im, np.ones((k_pad, 0))))
    f64 = torch.float64
    tneq = ts.make_structured_neq(top, tw, n_cams, n_ims, **kw)(
        pieces_from_numpy(np.asarray(p.cam), np.asarray(p.im),
                          np.zeros((k_pad, 0)), "cpu", f64),
        *grid_from_numpy(blocks.uv, blocks.mask, tpl, "cpu", f64),
        pieces_from_numpy(cm_cam, cm_im, np.ones((k_pad, 0)), "cpu", f64))
    return jneq, tneq


# (3, 5) pads past 5% at tile 16 -> per-block kernel family;
# (3, 16) pads nothing -> fused family
@pytest.mark.parametrize("n_ims", [5, 16])
@pytest.mark.parametrize("loss,semantics", [("linear", "component"),
                                            ("huber", "observation")])
def test_make_structured_neq_matches_jax(n_ims, loss, semantics):
    jneq, tneq = _neqs(3, n_ims, loss, semantics)
    for name, g, r in zip(js.NormalEq._fields, tneq, jneq):
        assert _rel(g.numpy(), r) <= 1e-9, name


def test_neq_diag_matvec_and_schur_solve_match_jax():
    jneq, tneq = _neqs(3, 5)
    rng = np.random.default_rng(9)
    dx = [rng.normal(size=tuple(x.shape)) for x in (tneq.gc, tneq.gi,
                                                     tneq.gk)]
    jd = js.neq_diag(jneq)
    td = ts.neq_diag(tneq)
    for g, r in zip(td, jd):
        assert _rel(g.numpy(), r) <= 1e-12
    jmv = js.neq_matvec(jneq, js.ParamPieces(*map(jnp.asarray, dx)))
    tmv = ts.neq_matvec(tneq, ts.ParamPieces(*map(torch.tensor, dx)))
    for g, r in zip(tmv, jmv):
        assert _rel(g.numpy(), r) <= 1e-9
    damp = [1e-3 * np.maximum(np.asarray(d), 1e-8) for d in jd]
    jsol = js.schur_solve(jneq, js.ParamPieces(*map(jnp.asarray, damp)))
    tsol = ts.schur_solve(tneq, ts.ParamPieces(*map(torch.tensor, damp)))
    for g, r in zip(tsol, jsol):
        assert _rel(g.numpy(), r) <= 1e-9


def test_unported_chains_and_solvers_raise():
    # the pose-free free-point chain is served now (b = 0, c = 3); a chain
    # outside every family still raises
    top = TOptimFunction([tb.Projection(), tb.Extrinsic3D(),
                          tb.FreePoint()])
    assert ts.chain_family(top, ts.chain_widths(top)) == "freepoint"
    assert callable(ts.make_structured_neq(top, ts.chain_widths(top), 2, 3))
    other = TOptimFunction([tb.Projection(), tb.Extrinsic3D(),
                            tb.RigidTform3d(), tb.TemplatePoints()])
    with pytest.raises(ts.UnsupportedChain, match="not ported yet"):
        ts.make_structured_neq(other, ts.chain_widths(other), 2, 3)
    # both reduced solvers are served (CG: tests/test_torch_cg.py); a name
    # outside them raises
    _, tneq = _neqs(3, 5)
    damp = ts.neq_diag(tneq)
    with pytest.raises(ValueError, match="'dense' and 'cg'"):
        ts.schur_solve(tneq, damp, method="qr")


def test_point_fn_and_assembler_match_analytic_and_jax():
    """The chain's per-detection prediction (block composition) agrees with
    the closed-form residual of block_rj_template and with the JAX chain."""
    from pycamset_tpu_torch.optim.analytic import block_rj_template
    rig, n_keys, jop, top, full = _problem(2, 3)
    cam = np.concatenate([rig["intr"], rig["extr"]], axis=1)[1]
    pose = rig["poses"][2]
    tpl = rig["template"]
    local = top.make_local_assembler()(
        torch.tensor(cam), torch.tensor(pose), torch.zeros(0,
                                                           dtype=torch.float64))
    pred = top.make_point_fn()(local.expand(n_keys, -1), torch.tensor(tpl))
    jfn = jop.make_point_fn()
    jlocal = jop.make_local_assembler()(jnp.asarray(cam), jnp.asarray(pose),
                                        jnp.zeros(0))
    ref = np.stack([np.asarray(jfn(jlocal, jnp.asarray(t))) for t in tpl])
    assert _rel(pred.numpy(), ref) <= 1e-12
    r, *_ = block_rj_template(torch.tensor(cam), torch.tensor(pose),
                              torch.tensor(tpl), torch.zeros(n_keys, 2,
                                                             dtype=torch.float64))
    assert _rel(r.numpy(), ref) <= 1e-12
