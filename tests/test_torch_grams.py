"""Port parity: the template gram kernels' plain twins and their wrappers.

The plain twins of Kernel A (per-block grams) and Kernel B (fused
reduction) — what the wrappers run for CPU tensors — are held against the
JAX package's XLA closed form (``make_block_grams``) and its Pallas kernels
in interpret mode, as ``tests/test_pallas_grams.py`` runs them. Float64
throughout; tolerances relative to each output's max-abs scale. The CUDA
kernels themselves run only on a card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycamset_tpu.optim.blocks import Extrinsic3D, Projection, TemplatePoints
from pycamset_tpu.optim.chain import OptimFunction
from pycamset_tpu.optim.structured import (build_block_arrays, chain_widths,
                                           make_block_grams,
                                           pad_template_table,
                                           split_full_params)
from pycamset_tpu.utils.synthetic import make_synthetic_rig
from pycamset_tpu_torch.from_jax import tensor_from_numpy
from pycamset_tpu_torch.optim import cuda_grams as cg
from pycamset_tpu_torch.optim import structured as ts

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)

NAMES = ["gcc_b", "gii_b", "wci_b", "hkk", "wck_b", "wik_b", "gc_b", "gi_b",
         "gk", "cost"]
LOSS_CASES = [("linear", "component"), ("huber", "component"),
              ("huber", "observation"), ("cauchy", "component"),
              ("cauchy", "observation"), ("soft_l1", "component"),
              ("soft_l1", "observation")]


def _interp_shim(monkeypatch):
    from jax.experimental import pallas as pl

    import pycamset_tpu.optim.pallas_grams as pg
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    shim = type(pl)("pl_shim")
    shim.pallas_call = interp
    shim.BlockSpec = pl.BlockSpec
    shim.when = pl.when
    shim.program_id = pl.program_id
    monkeypatch.setattr(pg, "pl", shim)
    return pg


def _block_inputs(n_cams=3, n_ims=5, noise_px=2.0, seed=3):
    """Per-block numpy inputs of a small perturbed template rig, with a
    camera column and a pose column fixed, pose 0 at exactly zero."""
    rig = make_synthetic_rig(n_cams=n_cams, n_ims=n_ims, grid=4,
                             visibility=0.8, noise_px=noise_px, seed=seed)
    n_keys = rig["n_keys"]
    op_fun = OptimFunction([Projection(), Extrinsic3D(), TemplatePoints()])
    widths = chain_widths(op_fun)
    struct = op_fun.param_struct(n_cams, n_ims, n_keys)
    blocks = build_block_arrays(rig["dd"], n_cams, n_ims, n_keys,
                                k_pad_multiple=8)
    k_pad = blocks.uv.shape[1]
    full = np.concatenate([rig["intr"].ravel(), rig["extr"].ravel(),
                           rig["poses"].ravel()])
    full = full + np.random.default_rng(seed).normal(size=full.size) * 1e-3
    pieces = split_full_params(full, op_fun, struct, n_cams, n_ims, n_keys,
                               widths, xp=np)
    im = np.array(pieces.im)
    im[0] = 0.0
    bb = n_cams * n_ims
    cmask = np.ones((bb, 15))
    cmask[:, 3] = 0.0
    imask = np.ones((bb, 6))
    imask[:, 5] = 0.0
    return dict(
        op_fun=op_fun, widths=widths, n_cams=n_cams, n_ims=n_ims,
        cam_b=np.repeat(np.asarray(pieces.cam), n_ims, axis=0),
        im_b=np.tile(im, (n_cams, 1)),
        tpl=pad_template_table(rig["template"], True, n_keys, k_pad),
        uv=blocks.uv, mask=blocks.mask, cmask=cmask, imask=imask,
        k_pad=k_pad)


def _t(a):
    return tensor_from_numpy(a, "cpu", torch.float64)


def _assert_close(got, ref, tol, name):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    if ref.size:
        assert np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30) <= tol, name


def _port_block_grams(d, **kw):
    grams = ts.resolve_block_grams(
        _port_op_fun(), ts.GroupWidths(15, 6, 0), **kw)
    return grams(_t(d["cam_b"]), _t(d["im_b"]), torch.zeros(d["k_pad"], 0,
                 dtype=torch.float64), _t(d["tpl"]), _t(d["uv"]),
                 _t(d["mask"]), _t(d["cmask"]), _t(d["imask"]),
                 torch.ones(d["k_pad"], 0, dtype=torch.float64))


def _port_op_fun():
    from pycamset_tpu_torch.optim import blocks as tb
    from pycamset_tpu_torch.optim.chain import OptimFunction as TOpt
    return TOpt([tb.Projection(), tb.Extrinsic3D(), tb.TemplatePoints()])


def test_pack_block_params_matches_jax():
    import pycamset_tpu.optim.pallas_grams as pg
    d = _block_inputs()
    ref = np.asarray(pg.pack_block_params(jnp.asarray(d["cam_b"]),
                                          jnp.asarray(d["im_b"])))
    got = cg.pack_block_params(_t(d["cam_b"]), _t(d["im_b"])).numpy()
    assert got.shape == ref.shape == (d["cam_b"].shape[0], cg.PPB)
    _assert_close(got, ref, 1e-12, "packed")


@pytest.mark.parametrize("loss,semantics", LOSS_CASES)
def test_kernel_a_plain_twin_matches_jax(monkeypatch, loss, semantics):
    """All 10 outputs vs make_block_grams (XLA) and the Pallas kernel."""
    pg = _interp_shim(monkeypatch)
    d = _block_inputs()
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    jargs = (jnp.asarray(d["cam_b"]), jnp.asarray(d["im_b"]),
             jnp.zeros((d["k_pad"], 0)), jnp.asarray(d["tpl"]),
             jnp.asarray(d["uv"]), jnp.asarray(d["mask"]),
             jnp.asarray(d["cmask"]), jnp.asarray(d["imask"]),
             jnp.ones((d["k_pad"], 0)))
    ref_xla = make_block_grams(d["op_fun"], d["widths"], **kw)(*jargs)
    ref_pl = pg.make_pallas_template_grams(d["widths"], **kw)(*jargs)
    got = _port_block_grams(d, **kw)
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
def test_kernel_b_plain_twin_matches_jax(monkeypatch, loss, semantics, tile,
                                         n_ims):
    """The fused builder's reduced pieces vs the fused Pallas kernel."""
    pg = _interp_shim(monkeypatch)
    d = _block_inputs(n_ims=n_ims)
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    ref = pg.make_pallas_template_grams_fused(
        d["widths"], d["n_cams"], n_ims, tile=tile, **kw)(
        jnp.asarray(d["cam_b"]), jnp.asarray(d["im_b"]),
        jnp.asarray(d["tpl"]), jnp.asarray(d["uv"]), jnp.asarray(d["mask"]),
        jnp.asarray(d["cmask"]), jnp.asarray(d["imask"]))
    got = cg.make_cuda_template_grams_fused(
        ts.GroupWidths(15, 6, 0), d["n_cams"], n_ims, **kw)(
        _t(d["cam_b"]), _t(d["im_b"]), _t(d["tpl"]), _t(d["uv"]),
        _t(d["mask"]), _t(d["cmask"]), _t(d["imask"]))
    for name, g, r in zip(["hcc", "hii", "wci", "gc", "gi", "cost"], got,
                          ref):
        _assert_close(g.numpy(), r, 1e-9, name)


def test_cpu_wrappers_run_plain_twins_and_launch_nothing():
    d = _block_inputs()
    args = tuple(_t(d[k]) for k in ("cam_b", "im_b", "tpl", "uv", "mask"))
    a0, b0 = cg.template_gram.launches, cg.template_gram_fused.launches
    cg.template_gram.launches = cg.template_gram_fused.launches = 0
    try:
        g = cg.template_gram(*args, loss="huber")
        f = cg.template_gram_fused(*args, d["n_cams"], d["n_ims"])
        assert cg.template_gram.launches == 0
        assert cg.template_gram_fused.launches == 0
    finally:
        cg.template_gram.launches, cg.template_gram_fused.launches = a0, b0
    assert torch.equal(g, cg.template_gram_plain(*args, loss="huber"))
    for x, y in zip(f, cg.template_gram_fused_plain(*args, d["n_cams"],
                                                    d["n_ims"])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "width"])
def test_cuda_input_check_rejects(bad):
    d = _block_inputs()
    args = [torch.as_tensor(d[k], dtype=torch.float32).contiguous()
            for k in ("cam_b", "im_b", "tpl", "uv", "mask")]
    err = ValueError
    if bad == "dtype":
        args[3] = args[3].double()
        err = TypeError
    elif bad == "shape":
        args[2] = args[2][:-1].contiguous()
    elif bad == "contiguity":
        args[3] = args[3].transpose(1, 2).contiguous().transpose(1, 2)
    else:                       # a = 16: the het selector row, no kernel
        args[0] = torch.cat([args[0], args[0][:, :1]], dim=1)
        err = NotImplementedError
    with pytest.raises(err):
        cg._check_cuda_inputs(*args)


def test_other_widths_raise():
    """Kernels A-F (template, self-cal, free-point and the multi-target
    ones at both key widths) serve the five camera models' widths (14, 15,
    18, 22, 24); a heterogeneous rig's selector row ([sel | fx px fy py | 5
    coefficients], a = 16) has no kernel yet."""
    from pycamset_tpu_torch.optim import cuda_mixed_grams as mg
    from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
    refusals = [
        lambda: sg.make_cuda_selfcal_grams(ts.GroupWidths(16, 6, 3)),
        lambda: sg.make_cuda_selfcal_grams_fused(ts.GroupWidths(16, 6, 3),
                                                 2, 3),
        lambda: sg.make_cuda_freepoint_grams(ts.GroupWidths(16, 0, 3)),
        lambda: mg.make_cuda_mixed_grams(ts.GroupWidths(16, 6, 9)),
        lambda: mg.make_cuda_mixed_grams_fused(ts.GroupWidths(16, 6, 9), 2,
                                               3),
        lambda: cg.make_cuda_template_grams(ts.GroupWidths(16, 6, 0)),
        lambda: cg.make_cuda_template_grams_fused(ts.GroupWidths(16, 6, 0),
                                                  2, 3)]
    for refuse in refusals:
        with pytest.raises(NotImplementedError, match="Queue A item 7"):
            refuse()
    for a in cg.TEMPLATE_WIDTHS:
        cg.make_cuda_template_grams(ts.GroupWidths(a, 6, 0))
        cg.make_cuda_template_grams_fused(ts.GroupWidths(a, 6, 0), 2, 3)
        sg.make_cuda_selfcal_grams(ts.GroupWidths(a, 6, 3))
        sg.make_cuda_selfcal_grams_fused(ts.GroupWidths(a, 6, 3), 2, 3)
        sg.make_cuda_freepoint_grams(ts.GroupWidths(a, 0, 3))
        sg.make_cuda_freepoint_grams_fused(ts.GroupWidths(a, 0, 3), 2, 3)
        mg.make_cuda_mixed_grams(ts.GroupWidths(a, 6, 9))
        mg.make_cuda_grouped_grams(ts.GroupWidths(a, 6, 6))
        mg.make_cuda_mixed_grams_fused(ts.GroupWidths(a, 6, 9), 2, 3)
        mg.make_cuda_mixed_grams_fused(ts.GroupWidths(a, 6, 6), 2, 3,
                                       with_key_cols=False)


def _twin_grams(dtype, loss="linear", semantics="component"):
    d = _block_inputs(n_ims=6)
    args = [tensor_from_numpy(d[k], "cpu", dtype)
            for k in ("cam_b", "im_b", "tpl", "uv", "mask")]
    return d, cg.template_gram_plain(*args, loss=loss, f_scale=2.0,
                                     loss_semantics=semantics)


@pytest.mark.parametrize("col", range(cg.GRAM_W))
def test_scaled_errors_catch_a_doubled_column(col):
    """A kernel that doubles any one column of [J | r] fails the scaled
    check, however small the column's entries are next to the gram's
    largest (the principal point and distortion columns)."""
    d, ref = _twin_grams(torch.float64)
    bad = ref.clone()
    bad[:, col, :] *= 2.0
    bad[:, :, col] *= 2.0
    assert max(cg.scaled_errors(bad, ref).values()) > 1.0
    fused = cg.scaled_errors_fused(
        cg.reduce_grams(bad, d["n_cams"], d["n_ims"]),
        cg.reduce_grams(ref, d["n_cams"], d["n_ims"]), ref, d["n_cams"],
        d["n_ims"])
    assert max(fused.values()) > 1.0
    assert max(cg.scaled_errors(ref, ref).values()) == 0.0


@pytest.mark.parametrize("loss,semantics", LOSS_CASES)
def test_float32_twin_within_the_kernel_bound(loss, semantics):
    """The float32 plain twin meets the 1e-4 bound of the kernels' check
    against the float64 twin, per output, in the Jacobi scaling."""
    d, ref = _twin_grams(torch.float64, loss, semantics)
    _, got = _twin_grams(torch.float32, loss, semantics)
    assert max(cg.scaled_errors(got, ref).values()) <= 1e-4
    n_cams, n_ims = d["n_cams"], d["n_ims"]
    fused = cg.scaled_errors_fused(cg.reduce_grams(got, n_cams, n_ims),
                                   cg.reduce_grams(ref, n_cams, n_ims), ref,
                                   n_cams, n_ims)
    assert max(fused.values()) <= 1e-4, fused
