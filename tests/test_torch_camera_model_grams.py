"""Port parity: Kernels A and B at the other camera models' widths.

The plain twins of Kernel A (per-block grams) and Kernel B (fused
reduction), what the wrappers run for CPU tensors, are held against the JAX
package's Pallas kernels in interpret mode (``make_pallas_template_grams``
and ``make_pallas_template_grams_fused``, run as
``tests/test_pallas_grams.py`` runs them) for the model/loss pairs of its
extended-model test: rational (a = 18), thin-prism (22), tilted (24) and
fisheye (14). Float64 throughout, every output within 1e-9 of its max-abs
scale. The fisheye kernels' arctan is the Mosaic polynomial
``_kernel_atan`` (max error 5.3e-11, which moves gc 5e-9 of its scale); the
port computes the exact arctan (``atanf`` on the card), so these cases swap
in ``jnp.arctan`` for it (``_interp_shim``). Interpret mode traces each
kernel anew (6-23 s a case here). The
Jacobi-scaled parity measure (``scaled_errors``) is checked at each width
to catch one doubled column. The CUDA kernels themselves run only on a card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycamset_tpu.optim.blocks import (Extrinsic3D, Projection,
                                       ProjectionFisheye, ProjectionRational,
                                       ProjectionThinPrism, ProjectionTilted,
                                       TemplatePoints)
from pycamset_tpu.optim.chain import OptimFunction
from pycamset_tpu.optim.structured import (build_block_arrays, chain_widths,
                                           split_full_params)
from pycamset_tpu.utils.synthetic import make_synthetic_rig
from pycamset_tpu_torch.from_jax import tensor_from_numpy
from pycamset_tpu_torch.optim import cuda_grams as cg
from pycamset_tpu_torch.optim import structured as ts

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)

NAMES = ["gcc_b", "gii_b", "wci_b", "hkk", "wck_b", "wik_b", "gc_b", "gi_b",
         "gk", "cost"]
PROJ = {"standard": Projection, "rational": ProjectionRational,
        "thin_prism": ProjectionThinPrism, "tilted": ProjectionTilted,
        "fisheye": ProjectionFisheye}
WIDTHS = {"fisheye": 14, "standard": 15, "rational": 18, "thin_prism": 22,
          "tilted": 24}
# tests/test_pallas_grams.py's model/loss pairs for the extended models
PAIRS = [("rational", "linear"), ("rational", "cauchy"),
         ("thin_prism", "linear"), ("thin_prism", "huber"),
         ("tilted", "linear"), ("tilted", "huber"),
         ("fisheye", "linear"), ("fisheye", "huber")]


def _interp_shim(monkeypatch):
    from jax.experimental import pallas as pl

    import pycamset_tpu.optim.pallas_grams as pg
    monkeypatch.setattr(pg, "_kernel_atan", jnp.arctan)
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


def _block_inputs(model, n_cams=3, n_ims=5, seed=6):
    """Per-block numpy inputs of the JAX test's rig (grid 4, 2 px noise) at
    ``model``, with a camera column and a pose column fixed."""
    rig = make_synthetic_rig(n_cams=n_cams, n_ims=n_ims, grid=4,
                             visibility=0.8, noise_px=2.0, seed=seed,
                             camera_model=model)
    n_keys = rig["n_keys"]
    op_fun = OptimFunction([PROJ[model](), Extrinsic3D(), TemplatePoints()])
    widths = chain_widths(op_fun)
    assert widths.a == WIDTHS[model]
    struct = op_fun.param_struct(n_cams, n_ims, n_keys)
    blocks = build_block_arrays(rig["dd"], n_cams, n_ims, n_keys,
                                k_pad_multiple=8)
    k_pad = blocks.uv.shape[1]
    tpl = np.zeros((k_pad, 3))
    tpl[:n_keys] = rig["template"]
    full = np.concatenate([rig["intr"].ravel(), rig["extr"].ravel(),
                           rig["poses"].ravel()])
    pieces = split_full_params(full, op_fun, struct, n_cams, n_ims, n_keys,
                               widths, xp=np)
    bb = n_cams * n_ims
    cmask = np.ones((bb, widths.a))
    cmask[:, 3] = 0.0
    imask = np.ones((bb, 6))
    imask[:, 5] = 0.0
    return dict(
        widths=ts.GroupWidths(widths.a, 6, 0), n_cams=n_cams, n_ims=n_ims,
        cam_b=np.repeat(np.asarray(pieces.cam), n_ims, axis=0),
        im_b=np.tile(np.asarray(pieces.im), (n_cams, 1)), tpl=tpl,
        uv=blocks.uv, mask=blocks.mask, cmask=cmask, imask=imask,
        k_pad=k_pad)


def _t(a):
    return tensor_from_numpy(a, "cpu", torch.float64)


def _assert_close(got, ref, tol, name):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    if ref.size:
        err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)
        assert err <= tol, (name, err)


@pytest.mark.parametrize("model,loss", PAIRS)
def test_kernel_a_plain_twin_matches_pallas(monkeypatch, model, loss):
    """The per-block builder's 10 outputs vs the Pallas kernel."""
    pg = _interp_shim(monkeypatch)
    d = _block_inputs(model)
    jargs = (jnp.asarray(d["cam_b"]), jnp.asarray(d["im_b"]),
             jnp.zeros((d["k_pad"], 0)), jnp.asarray(d["tpl"]),
             jnp.asarray(d["uv"]), jnp.asarray(d["mask"]),
             jnp.asarray(d["cmask"]), jnp.asarray(d["imask"]),
             jnp.ones((d["k_pad"], 0)))
    ref = pg.make_pallas_template_grams(d["widths"], loss=loss,
                                        f_scale=2.0)(*jargs)
    got = cg.make_cuda_template_grams(d["widths"], loss=loss, f_scale=2.0)(
        _t(d["cam_b"]), _t(d["im_b"]), torch.zeros(d["k_pad"], 0,
                                                   dtype=torch.float64),
        _t(d["tpl"]), _t(d["uv"]), _t(d["mask"]), _t(d["cmask"]),
        _t(d["imask"]), torch.ones(d["k_pad"], 0, dtype=torch.float64))
    for name, g, r in zip(NAMES, got, ref):
        _assert_close(g.numpy(), r, 1e-9, name)


@pytest.mark.parametrize("model,loss", PAIRS)
def test_kernel_b_plain_twin_matches_pallas(monkeypatch, model, loss):
    """The fused builder's reduced pieces vs the fused Pallas kernel (5
    images: the JAX kernel pads them to its tile of 16)."""
    pg = _interp_shim(monkeypatch)
    d = _block_inputs(model)
    ref = pg.make_pallas_template_grams_fused(
        d["widths"], d["n_cams"], d["n_ims"], loss=loss, f_scale=2.0)(
        jnp.asarray(d["cam_b"]), jnp.asarray(d["im_b"]),
        jnp.asarray(d["tpl"]), jnp.asarray(d["uv"]), jnp.asarray(d["mask"]),
        jnp.asarray(d["cmask"]), jnp.asarray(d["imask"]))
    got = cg.make_cuda_template_grams_fused(
        d["widths"], d["n_cams"], d["n_ims"], loss=loss, f_scale=2.0)(
        _t(d["cam_b"]), _t(d["im_b"]), _t(d["tpl"]), _t(d["uv"]),
        _t(d["mask"]), _t(d["cmask"]), _t(d["imask"]))
    for name, g, r in zip(["hcc", "hii", "wci", "gc", "gi", "cost"], got,
                          ref):
        _assert_close(g.numpy(), r, 1e-9, name)


@pytest.mark.parametrize("model", list(WIDTHS))
def test_scaled_errors_catch_a_doubled_column_at_each_width(model):
    """At every camera width, a kernel that doubles any one column of
    [J | r] fails the scaled check of A and of B, however small the
    column's entries are next to the gram's largest."""
    d = _block_inputs(model, n_ims=6)
    args = [_t(d[k]) for k in ("cam_b", "im_b", "tpl", "uv", "mask")]
    ref = cg.template_gram_plain(*args, loss="huber", f_scale=2.0)
    gw = WIDTHS[model] + 7
    assert ref.shape[1:] == (gw, gw)
    n_cams, n_ims = d["n_cams"], d["n_ims"]
    for col in range(gw):
        bad = ref.clone()
        bad[:, col, :] *= 2.0
        bad[:, :, col] *= 2.0
        assert max(cg.scaled_errors(bad, ref).values()) > 1.0, col
        fused = cg.scaled_errors_fused(
            cg.reduce_grams(bad, n_cams, n_ims),
            cg.reduce_grams(ref, n_cams, n_ims), ref, n_cams, n_ims)
        assert max(fused.values()) > 1.0, col
    assert max(cg.scaled_errors(ref, ref).values()) == 0.0


@pytest.mark.parametrize("model", list(WIDTHS))
def test_wrappers_on_cpu_tensors_run_the_twins(model):
    """On CPU tensors the wrappers run the plain twins at every width and
    count no launch; the fused twin is the per-block one reduced."""
    d = _block_inputs(model)
    args = tuple(_t(d[k]) for k in ("cam_b", "im_b", "tpl", "uv", "mask"))
    a0, b0 = cg.template_gram.launches, cg.template_gram_fused.launches
    cg.template_gram.launches = cg.template_gram_fused.launches = 0
    try:
        g = cg.template_gram(*args, loss="cauchy", f_scale=2.0)
        f = cg.template_gram_fused(*args, d["n_cams"], d["n_ims"],
                                   loss="cauchy", f_scale=2.0)
        assert cg.template_gram.launches == 0
        assert cg.template_gram_fused.launches == 0
    finally:
        cg.template_gram.launches, cg.template_gram_fused.launches = a0, b0
    ref = cg.template_gram_plain(*args, loss="cauchy", f_scale=2.0)
    assert torch.equal(g, ref)
    for x, y in zip(f, cg.reduce_grams(ref, d["n_cams"], d["n_ims"])):
        assert torch.equal(x, y)


def test_packed_widths_follow_the_jax_layout():
    """PPB at each intrinsic width, as ``pallas_grams._layout`` gives it,
    and the packing at that width."""
    from pycamset_tpu.optim.pallas_grams import _layout
    for model, a in WIDTHS.items():
        assert cg.packed_width(a - 6) == _layout(a - 6)[1], model
        d = _block_inputs(model, n_ims=2)
        assert cg.pack_block_params(_t(d["cam_b"]), _t(d["im_b"])).shape == (
            d["cam_b"].shape[0], _layout(a - 6)[1])
