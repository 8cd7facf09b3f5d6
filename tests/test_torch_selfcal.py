"""Port parity: the self-calibration bundle adjustment (free target points).

The plain twins of Kernel D (per-block self-cal grams) and Kernel C (fused
reduction) — what the wrappers run for CPU tensors — are held against the
JAX package's XLA closed form (``make_block_grams``) and its Pallas kernels
in interpret mode, with a fixed camera column, a fixed pose column and
frozen keys. Then the point-block Schur step, the structured normal
equations, and the whole self-cal LM against ``bench.py``'s self-cal
problem, in float64 on the CPU: the same iterations, evaluations and
status, the cost within 1e-9 relative and the parameters within 1e-7 of
their scale. Also the float32 twin's floor under the kernels' 1e-4 bound,
and the scaled measure catching a doubled point column.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from pycamset_tpu.optim import structured as js
from pycamset_tpu.optim.blocks import (Extrinsic3D, FreePoint, Projection,
                                       RigidTform3d)
from pycamset_tpu.optim.chain import OptimFunction
from pycamset_tpu.optim.structured_lm import structured_lm_solve
from pycamset_tpu.utils.synthetic import make_synthetic_rig
from pycamset_tpu_torch.from_jax import (grid_from_numpy, pieces_from_numpy,
                                         tensor_from_numpy)
from pycamset_tpu_torch.optim import blocks as tb
from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
from pycamset_tpu_torch.optim import structured as ts
from pycamset_tpu_torch.optim.chain import OptimFunction as TOptimFunction
from pycamset_tpu_torch.problems import selfcal_problem
from test_torch_grams import _interp_shim

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)

NAMES = ["gcc_b", "gii_b", "wci_b", "hkk", "wck_b", "wik_b", "gc_b", "gi_b",
         "gk", "cost"]
FUSED_NAMES = ["hcc", "hii", "hkk", "wci", "wck", "wik", "gc", "gi", "gk",
               "cost"]
LOSS_CASES = [("linear", "component"), ("huber", "component"),
              ("huber", "observation"), ("cauchy", "component"),
              ("cauchy", "observation"), ("soft_l1", "component"),
              ("soft_l1", "observation")]
BOUND = 1e-4   # the kernels' check against their float64 twins


def _op_funs():
    return (OptimFunction([Projection(), Extrinsic3D(), RigidTform3d(),
                           FreePoint()]),
            TOptimFunction([tb.Projection(), tb.Extrinsic3D(),
                            tb.RigidTform3d(), tb.FreePoint()]))


def _block_inputs(n_cams=3, n_ims=5, noise_px=2.0, seed=3):
    """Per-block numpy inputs of a small perturbed self-cal rig: grid 5
    (25 keys, 7 pad keys at K = 32), a camera column and a pose column
    fixed, pad keys, key 0 and one coordinate of key 2 frozen, pose 0 at
    exactly zero."""
    rig = make_synthetic_rig(n_cams=n_cams, n_ims=n_ims, grid=5,
                             visibility=0.8, noise_px=noise_px, seed=seed)
    n_keys = rig["n_keys"]
    op_fun, _ = _op_funs()
    widths = js.chain_widths(op_fun)
    struct = op_fun.param_struct(n_cams, n_ims, n_keys)
    blocks = js.build_block_arrays(rig["dd"], n_cams, n_ims, n_keys,
                                   k_pad_multiple=8)
    k_pad = blocks.uv.shape[1]
    full = np.concatenate([rig["intr"].ravel(), rig["extr"].ravel(),
                           rig["poses"].ravel(), rig["template"].ravel()])
    full = full + np.random.default_rng(seed).normal(size=full.size) * 1e-3
    p = js.split_full_params(full, op_fun, struct, n_cams, n_ims, n_keys,
                             widths, xp=np)
    im = np.array(p.im)
    im[0] = 0.0
    keyp = np.tile(np.asarray(p.key)[:1], (k_pad, 1))
    keyp[:n_keys] = p.key
    bb = n_cams * n_ims
    cmask = np.ones((bb, 15))
    cmask[:, 3] = 0.0
    imask = np.ones((bb, 6))
    imask[:, 5] = 0.0
    kmask = np.ones((k_pad, 3))
    kmask[n_keys:] = 0.0
    kmask[0] = 0.0
    kmask[2, 1] = 0.0
    return dict(
        op_fun=op_fun, widths=widths, n_cams=n_cams, n_ims=n_ims,
        cam_b=np.repeat(np.asarray(p.cam), n_ims, axis=0),
        im_b=np.tile(im, (n_cams, 1)), keyp=keyp, uv=blocks.uv,
        mask=blocks.mask, cmask=cmask, imask=imask, kmask=kmask, k_pad=k_pad,
        cam=np.asarray(p.cam), im=im)


def _t(a, dtype=torch.float64):
    return tensor_from_numpy(a, "cpu", dtype)


def _assert_close(got, ref, tol, name):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    if ref.size:
        assert np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30) <= tol, name


def _jargs(d):
    return (jnp.asarray(d["cam_b"]), jnp.asarray(d["im_b"]),
            jnp.asarray(d["keyp"]), jnp.zeros((d["k_pad"], 3)),
            jnp.asarray(d["uv"]), jnp.asarray(d["mask"]),
            jnp.asarray(d["cmask"]), jnp.asarray(d["imask"]),
            jnp.asarray(d["kmask"]))


def _targs(d, dtype=torch.float64):
    return tuple(_t(d[k], dtype) for k in ("cam_b", "im_b", "keyp", "uv",
                                           "mask", "cmask", "imask", "kmask"))


@pytest.mark.parametrize("loss,semantics", LOSS_CASES)
def test_kernel_d_plain_twin_matches_jax(monkeypatch, loss, semantics):
    """All 10 outputs of the per-block builder vs make_block_grams (XLA)
    and the Pallas self-cal kernel."""
    pg = _interp_shim(monkeypatch)
    d = _block_inputs()
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    jargs = _jargs(d)
    ref_xla = js.make_block_grams(d["op_fun"], d["widths"], **kw)(*jargs)
    ref_pl = pg.make_pallas_selfcal_grams(d["widths"], **kw)(*jargs)
    _, top = _op_funs()
    grams = ts.resolve_block_grams(top, ts.GroupWidths(15, 6, 3), **kw)
    cam_b, im_b, keyp, uv, mask, cmask, imask, kmask = _targs(d)
    got = grams(cam_b, im_b, keyp, torch.zeros(d["k_pad"], 3,
                dtype=torch.float64), uv, mask, cmask, imask, kmask)
    for name, g, rx, rp in zip(NAMES, got, ref_xla, ref_pl):
        _assert_close(g.numpy(), rx, 1e-9, name)
        _assert_close(g.numpy(), rp, 1e-9, name)


@pytest.mark.parametrize("loss,semantics,tile,n_ims", [
    ("linear", "component", None, 5),      # JAX pads 5 -> 16 images
    ("huber", "component", None, 5),
    ("cauchy", "observation", None, 5),
    ("soft_l1", "observation", None, 16),  # no padding
    ("linear", "component", 4, 8),         # JAX accumulates over 2 steps
])
def test_kernel_c_plain_twin_matches_jax(monkeypatch, loss, semantics, tile,
                                         n_ims):
    """The fused builder's ten reduced pieces vs the fused Pallas kernel
    and vs make_block_grams reduced on the host."""
    pg = _interp_shim(monkeypatch)
    d = _block_inputs(n_ims=n_ims)
    n_cams, k_pad = d["n_cams"], d["k_pad"]
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    jargs = _jargs(d)
    ref_pl = pg.make_pallas_selfcal_grams_fused(
        d["widths"], n_cams, n_ims, tile=tile, **kw)(
        *jargs[:3], *jargs[4:])
    (gcc_b, gii_b, wci_b, hkk, wck_b, wik_b, gc_b, gi_b, gk,
     cost) = js.make_block_grams(d["op_fun"], d["widths"], **kw)(*jargs)
    # the per-block builder masks the camera columns per block; reduced
    # over images they equal the fused builder's post-reduction masking
    ref_xla = (gcc_b.reshape(n_cams, n_ims, 15, 15).sum(1),
               gii_b.reshape(n_cams, n_ims, 6, 6).sum(0), hkk,
               wci_b.reshape(n_cams, n_ims, 15, 6),
               wck_b.reshape(n_cams, n_ims, k_pad, 15, 3).sum(1),
               wik_b.reshape(n_cams, n_ims, k_pad, 6, 3).sum(0),
               gc_b.reshape(n_cams, n_ims, 15).sum(1),
               gi_b.reshape(n_cams, n_ims, 6).sum(0), gk, cost)
    cam_b, im_b, keyp, uv, mask, cmask, imask, kmask = _targs(d)
    got = sg.make_cuda_selfcal_grams_fused(
        ts.GroupWidths(15, 6, 3), n_cams, n_ims, **kw)(
        cam_b, im_b, keyp, uv, mask, cmask, imask, kmask)
    for name, g, rp, rx in zip(FUSED_NAMES, got, ref_pl, ref_xla):
        _assert_close(g.numpy(), rp, 1e-9, name)
        _assert_close(g.numpy(), rx, 1e-9, name)


def test_cpu_selfcal_wrappers_run_plain_twins_and_launch_nothing():
    d = _block_inputs()
    cam_b, im_b, keyp, uv, mask, cmask, imask, kmask = _targs(d)
    counts = sg.selfcal_gram.launches, sg.selfcal_gram_fused.launches
    sg.selfcal_gram.launches = sg.selfcal_gram_fused.launches = 0
    try:
        per_block = sg.selfcal_gram(cam_b, im_b, keyp, uv, mask, cmask,
                                    imask, kmask, loss="huber")
        fused = sg.selfcal_gram_fused(cam_b, im_b, keyp, uv, mask, imask,
                                      kmask, d["n_cams"], d["n_ims"])
        assert sg.selfcal_gram.launches == 0
        assert sg.selfcal_gram_fused.launches == 0
    finally:
        sg.selfcal_gram.launches, sg.selfcal_gram_fused.launches = counts
    for x, y in zip(per_block, sg.selfcal_gram_plain(
            cam_b, im_b, keyp, uv, mask, cmask, imask, kmask, loss="huber")):
        assert torch.equal(x, y)
    for x, y in zip(fused, sg.selfcal_gram_fused_plain(
            cam_b, im_b, keyp, uv, mask, imask, kmask, d["n_cams"],
            d["n_ims"])):
        assert torch.equal(x, y)


def test_selfcal_cuda_input_check_rejects_a_bad_mask():
    d = _block_inputs()
    args = [torch.as_tensor(d[k], dtype=torch.float32).contiguous()
            for k in ("cam_b", "im_b", "keyp", "uv", "mask")]
    from pycamset_tpu_torch.optim.cuda_grams import _check_cuda_inputs
    kmask = torch.ones(d["k_pad"] - 1, 3)
    with pytest.raises(ValueError, match="kmask"):
        _check_cuda_inputs(*args, kmask=kmask)
    with pytest.raises(TypeError, match="imask_b"):
        _check_cuda_inputs(*args, imask_b=torch.ones(len(d["mask"]), 6,
                                                     dtype=torch.float64))


def test_selfcal_widths_check():
    """The self-cal builders take the five camera models' widths; a = 16
    (a heterogeneous rig's selector row) and a chain without key columns
    raise."""
    with pytest.raises(NotImplementedError, match="make_het_grams"):
        sg.make_cuda_selfcal_grams(ts.GroupWidths(16, 6, 3))
    with pytest.raises(NotImplementedError, match="make_het_grams"):
        sg.make_cuda_selfcal_grams_fused(ts.GroupWidths(15, 6, 0), 2, 3)
    for a in (14, 15, 18, 22, 24):
        sg.make_cuda_selfcal_grams(ts.GroupWidths(a, 6, 3))
        sg.make_cuda_selfcal_grams_fused(ts.GroupWidths(a, 6, 3), 2, 3)


def _neqs(n_ims, loss="linear", semantics="component", n_cams=3):
    """The JAX and port self-cal NormalEq of one rig at the same
    parameters."""
    d = _block_inputs(n_cams=n_cams, n_ims=n_ims)
    jop, top = _op_funs()
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    cm_cam = np.ones((n_cams, 15))
    cm_cam[1, 4] = 0.0
    cm_im = np.ones((n_ims, 6))
    cm_im[0] = 0.0
    jneq = js.make_structured_neq(jop, js.chain_widths(jop), n_cams, n_ims,
                                  **kw)(
        js.ParamPieces(jnp.asarray(d["cam"]), jnp.asarray(d["im"]),
                       jnp.asarray(d["keyp"])),
        jnp.asarray(d["uv"]), jnp.asarray(d["mask"]),
        jnp.zeros((d["k_pad"], 3)),
        js.ParamPieces(cm_cam, cm_im, d["kmask"]))
    f64 = torch.float64
    tneq = ts.make_structured_neq(top, ts.chain_widths(top), n_cams, n_ims,
                                  **kw)(
        pieces_from_numpy(d["cam"], d["im"], d["keyp"], "cpu", f64),
        *grid_from_numpy(d["uv"], d["mask"], np.zeros((d["k_pad"], 3)),
                         "cpu", f64),
        pieces_from_numpy(cm_cam, cm_im, d["kmask"], "cpu", f64))
    return jneq, tneq


# (3, 5) pads 5 -> 8 (60% > 25%) -> per-block family (Kernel D);
# (3, 16) pads nothing -> fused family (Kernel C)
@pytest.mark.parametrize("n_ims", [5, 16])
@pytest.mark.parametrize("loss,semantics", [("linear", "component"),
                                            ("huber", "observation")])
def test_make_structured_neq_selfcal_matches_jax(n_ims, loss, semantics):
    jneq, tneq = _neqs(n_ims, loss, semantics)
    for name, g, r in zip(js.NormalEq._fields, tneq, jneq):
        _assert_close(g.numpy(), r, 1e-9, name)


def test_kernel_family_follows_the_jax_padding_rule():
    """Tile 16 or 8, whichever pads less, and at most 25% padding."""
    _, top = _op_funs()
    w = ts.chain_widths(top)
    fused = {n: ts.resolve_fused_grams(top, w, 2, n) is not None
             for n in (5, 12, 16, 20, 100, 104)}
    assert fused == {5: False, 12: False, 16: True, 20: True, 100: True,
                     104: True}
    assert (ts.selfcal_pad_tile(100), ts.selfcal_pad_tile(12)) == (8, 16)


def test_schur_solve_with_point_blocks_matches_jax():
    """One damped self-cal NormalEq carried across: the same step."""
    jneq, _ = _neqs(5)
    tneq = ts.NormalEq(*(torch.tensor(np.asarray(x)) for x in jneq))
    jd = js.neq_diag(jneq)
    damp = [1e-3 * np.maximum(np.asarray(x), 1e-8) for x in jd]
    jsol = js.schur_solve(jneq, js.ParamPieces(*map(jnp.asarray, damp)))
    tsol = ts.schur_solve(tneq, ts.ParamPieces(*map(torch.tensor, damp)))
    for g, r in zip(tsol, jsol):
        _assert_close(g.numpy(), r, 1e-9, "dx")
    # the step solves the damped system: (H + D) dx = -g, piece by piece
    hdx = ts.neq_matvec(tneq, tsol)
    for h, dmp, x, gr in zip(hdx, ts.ParamPieces(*map(torch.tensor, damp)),
                             tsol, (tneq.gc, tneq.gi, tneq.gk)):
        _assert_close((h + dmp * x).numpy(), (-gr).numpy(), 1e-8, "resid")


def test_pose_free_schur_step_raises():
    """The self-cal NormalEq with its pose piece stripped (b = 0: the
    pose-free free-point chain's layout) no longer raises: it takes the
    JAX package's pose-free step, with a zero-width image piece, and the
    step solves the damped system."""
    _, tneq = _neqs(5)
    z = tneq.hii.new_zeros
    neq = tneq._replace(hii=z((5, 0, 0)), wci=z((3, 5, 15, 0)),
                        wik=z((5, tneq.hkk.shape[0], 0, 3)), gi=z((5, 0)))
    jneq = js.NormalEq(*(jnp.asarray(x.numpy()) for x in neq))
    damp = [1e-3 * np.maximum(np.asarray(x), 1e-8)
            for x in js.neq_diag(jneq)]
    jsol = js.schur_solve(jneq, js.ParamPieces(*map(jnp.asarray, damp)))
    tsol = ts.schur_solve(neq, ts.ParamPieces(*map(torch.tensor, damp)))
    assert tsol.im.shape == (5, 0)
    for g, r in zip(tsol, jsol):
        _assert_close(g.numpy(), r, 1e-9, "dx")
    hdx = ts.neq_matvec(neq, tsol)
    for h, dmp, x, gr in zip(hdx, ts.ParamPieces(*map(torch.tensor, damp)),
                             tsol, (neq.gc, neq.gi, neq.gk)):
        _assert_close((h + dmp * x).numpy(), (-gr).numpy(), 1e-8, "resid")


def _jax_solve(n_cams, n_ims, loss):
    """bench.py::selfcal_problem's solve at grid 6, with ``loss`` and
    k_pad_multiple 8."""
    rig = make_synthetic_rig(n_cams=n_cams, n_ims=n_ims, grid=6,
                             visibility=0.85, noise_px=0.3, seed=0)
    n_keys = rig["n_keys"]
    op, _ = _op_funs()
    w = js.chain_widths(op)
    st = op.param_struct(n_cams, n_ims, n_keys)
    bl = js.build_block_arrays(rig["dd"], n_cams, n_ims, n_keys,
                               k_pad_multiple=8)
    k_pad = bl.uv.shape[1]
    full = np.concatenate([rig["intr"].ravel(), rig["extr"].ravel(),
                           rig["poses"].ravel(), rig["template"].ravel()])
    p = js.split_full_params(jnp.asarray(full), op, st, n_cams, n_ims,
                             n_keys, w)
    key = jnp.tile(p.key[:1], (k_pad, 1)).at[:n_keys].set(p.key)
    p = js.ParamPieces(p.cam, p.im, key)
    cm = bench.selfcal_colmask(n_cams, n_ims, n_keys, k_pad, w, np.float64)
    neq = js.make_structured_neq(op, w, n_cams, n_ims, loss=loss)
    uv, mask = bl.as_device(jnp.float64)
    tpl = np.zeros((k_pad, 3))
    return jax.jit(lambda pp: structured_lm_solve(
        lambda q: neq(q, uv, mask, tpl, cm), pp, max_nfev=100))(p)


# (3, 16): fused family (Kernel C's twin); (3, 5): per-block (Kernel D's)
@pytest.mark.parametrize("n_cams,n_ims,loss", [(3, 16, "linear"),
                                               (3, 5, "linear"),
                                               (3, 5, "huber")])
def test_selfcal_lm_matches_jax_package(n_cams, n_ims, loss):
    ref = _jax_solve(n_cams, n_ims, loss)
    prob = selfcal_problem(n_cams, n_ims, "cpu", grid=6, k_pad_multiple=8,
                           loss=loss)
    got = prob.solve()
    assert (got.nit, got.nfev, int(got.status)) == (
        int(ref.nit), int(ref.nfev), int(ref.status))
    assert int(got.status) in (1, 2)
    assert abs(float(got.cost) - float(ref.cost)) <= 1e-9 * float(ref.cost)
    for g, r in zip(got.x, ref.x):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 1e-7 * np.abs(r).max()
    n = got.nit + 1
    assert np.abs(got.history[:n].numpy() - np.asarray(ref.history)[:n]
                  ).max() <= 1e-9 * float(ref.history[0])


def test_selfcal_problem_matches_bench():
    """The port's problem is bench.py's: start, grid and column masks (the
    port's synthetic rig rounds some extrinsics and detections differently
    in the last ulp)."""
    _, pieces, (uv, mask), blocks = bench.selfcal_problem(3, 16, grid=6)
    prob = selfcal_problem(3, 16, "cpu", grid=6)
    for g, r in zip(prob.x0, pieces):
        _assert_close(g.numpy(), r, 1e-15, "x0")
    _assert_close(prob.uv.numpy(), uv, 1e-15, "uv")
    assert np.array_equal(prob.mask.numpy(), np.asarray(mask))
    k_pad = prob.mask.shape[1]
    ref_cm = bench.selfcal_colmask(3, 16, blocks.n_keys, k_pad,
                                   prob.widths, np.float64)
    for g, r in zip(prob.colmask, ref_cm):
        assert np.array_equal(g.numpy(), r)
    assert not prob.tpl.any()


def test_pieces_from_numpy_carries_a_key_piece():
    key = np.random.default_rng(0).normal(size=(32, 3))
    p = pieces_from_numpy(np.ones((2, 15)), np.ones((3, 6)), key, "cpu",
                          torch.float64)
    assert p.key.shape == (32, 3) and p.key.is_contiguous()
    assert np.array_equal(p.key.numpy(), key)
    p32 = pieces_from_numpy(np.ones((2, 15)), np.ones((3, 6)),
                            np.asfortranarray(key), "cpu", torch.float32)
    assert p32.key.dtype == torch.float32 and p32.key.is_contiguous()
    assert np.array_equal(p32.key.numpy(), key.astype(np.float32))


def _twins(dtype, loss="linear", semantics="component", n_ims=6):
    d = _block_inputs(n_ims=n_ims)
    cam_b, im_b, keyp, uv, mask, cmask, imask, kmask = _targs(d, dtype)
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    per_block = sg.selfcal_gram_plain(cam_b, im_b, keyp, uv, mask, cmask,
                                      imask, kmask, **kw)
    fused = sg.selfcal_gram_fused_plain(cam_b, im_b, keyp, uv, mask, imask,
                                        kmask, d["n_cams"], n_ims, **kw)
    # the per-block gram of the fused family's inputs (no camera mask), for
    # the scale of the fused per-block pieces
    gram = sg.selfcal_gram_plain(cam_b, im_b, keyp, uv, mask,
                                 torch.ones_like(cmask), imask, kmask, **kw)[0]
    return d, per_block, fused, gram


@pytest.mark.parametrize("loss,semantics", LOSS_CASES)
def test_selfcal_float32_twin_within_the_kernel_bound(loss, semantics):
    """The float32 plain twins meet the 1e-4 bound of the kernels' check
    against the float64 twins, per output, in the Jacobi scaling."""
    d, ref_d, ref_c, gram = _twins(torch.float64, loss, semantics)
    _, got_d, got_c, _ = _twins(torch.float32, loss, semantics)
    errs_d = sg.scaled_errors_selfcal(got_d, ref_d)
    assert max(errs_d.values()) <= BOUND, errs_d
    errs_c = sg.scaled_errors_selfcal_fused(got_c, ref_c, gram, d["n_cams"],
                                            d["n_ims"])
    assert max(errs_c.values()) <= BOUND, errs_c


@pytest.mark.parametrize("col", range(3))
def test_scaled_errors_catch_a_doubled_point_column(col):
    """A kernel that doubled one column of Jk fails the scaled check, in
    every output the column reaches: wck, wik, hkk, gk."""
    d, ref_d, ref_c, gram = _twins(torch.float64)
    g, wck_b, wik_b, hkk, gk = ref_d
    twice = hkk.clone()
    twice[:, col, :] *= 2.0
    twice[:, :, col] *= 2.0
    bad = [(g, wck_b.clone(), wik_b, hkk, gk), (g, wck_b, wik_b.clone(), hkk,
                                                gk),
           (g, wck_b, wik_b, twice, gk), (g, wck_b, wik_b, hkk, gk.clone())]
    bad[0][1][..., col] *= 2.0
    bad[1][2][..., col] *= 2.0
    bad[3][4][..., col] *= 2.0
    # one (block, key) coupling is small beside its row's and column's
    # diagonals (about 1/sqrt(the block's keys x the key's blocks) of
    # them), so doubling it reads ~0.1 there: three orders above the bound
    for b, name in zip(bad, ("wck", "wik", "hkk", "gk")):
        assert sg.scaled_errors_selfcal(b, ref_d)[name] > 100 * BOUND, name
    assert max(sg.scaled_errors_selfcal(ref_d, ref_d).values()) == 0.0
    bad_c = list(ref_c)
    bad_c[2] = ref_c[2].clone()
    bad_c[2][..., col] *= 2.0
    bad_c[8] = twice
    errs = sg.scaled_errors_selfcal_fused(bad_c, ref_c, gram, d["n_cams"],
                                          d["n_ims"])
    assert min(errs["wck"], errs["hkk"]) > 100 * BOUND, errs


def test_float32_floor_of_the_per_slot_couplings():
    """The max-abs measure leaves the per-(block, key) couplings (Kernel D's
    wck_b and wik_b, Kernel C's wik) little room: each entry is one slot's
    product, which nothing averages, and under a robust loss it carries the
    float32 error of the slot's IRLS weight. On the smoke's kind of input (a
    2 x 100 rig at chip_smoke.py's perturbed start, huber) the float32 twin
    on the CPU already misses them by more than 1e-4 of their max-abs,
    while every other output, and every output in the Jacobi scaling, stays
    within 1e-4. (At the smoke's own shapes the same twin stays under it,
    so the smoke holds every output to 1e-4 and prints this floor.)"""
    from chip_smoke import TOL, selfcal_inputs
    prob = selfcal_problem(2, 100, "cpu", torch.float64)
    f32 = tuple(x.float() for x in selfcal_inputs(prob))
    f64 = tuple(x.double() for x in f32)
    kw = dict(loss="huber", f_scale=2.0, loss_semantics="component")
    got, ref = sg.selfcal_gram_plain(*f32, **kw), sg.selfcal_gram_plain(
        *f64, **kw)
    rel = [float((g.double() - r).abs().max() / r.abs().max())
           for g, r in zip(got, ref)]
    assert TOL < max(rel[1:3]) <= 5 * TOL, rel
    assert max(rel[:1] + rel[3:]) <= TOL, rel
    assert max(sg.scaled_errors_selfcal(got, ref).values()) <= TOL
