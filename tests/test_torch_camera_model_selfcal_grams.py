"""Port parity: Kernels C and D, and the free-point wrappers over them, at
the other camera models' widths.

The plain twins of Kernel D (per-block self-cal grams), Kernel C (fused
reduction) and the two free-point wrappers (D and C at identity poses),
what the wrappers run for CPU tensors, are held against the JAX package's
XLA closed form (``make_block_grams``, reduced on the host for the fused
contracts) at the rational (a = 18), thin-prism (22), tilted (24) and
fisheye (14) models, each under one of the four losses, with a fixed camera
column, a fixed pose column and frozen keys; float64, every output within
1e-9 of its max-abs scale. One case per kernel also runs the JAX package's
Pallas kernel in interpret mode, as ``tests/test_torch_camera_model_grams.py``
runs A and B (each traces anew, 6-23 s): D at the tilted model under
huber, and C at the fisheye model, whose kernel's Mosaic arctan is swapped
for ``jnp.arctan`` (``_interp_shim``). The Jacobi-scaled measures of D, C
and both free-point wrappers are checked at each width to catch one
doubled camera column. The CUDA kernels themselves run only on a card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycamset_tpu.optim import structured as js
from pycamset_tpu.optim.blocks import (Extrinsic3D, FreePoint, RigidTform3d)
from pycamset_tpu.optim.chain import OptimFunction
from pycamset_tpu.utils.synthetic import make_synthetic_rig
from pycamset_tpu_torch.from_jax import tensor_from_numpy
from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
from pycamset_tpu_torch.optim import structured as ts
from test_torch_camera_model_grams import PROJ, WIDTHS, _interp_shim

NAMES = ["gcc_b", "gii_b", "wci_b", "hkk", "wck_b", "wik_b", "gc_b", "gi_b",
         "gk", "cost"]
FUSED_NAMES = ["hcc", "hii", "hkk", "wci", "wck", "wik", "gc", "gi", "gk",
               "cost"]
FP_FUSED_NAMES = ["hcc", "hkk", "wck", "gc", "gk", "cost"]
# each model under one of the four losses (both semantics among them)
MODEL_LOSS = [("rational", "cauchy", "observation"),
              ("thin_prism", "huber", "component"),
              ("tilted", "soft_l1", "observation"),
              ("fisheye", "linear", "component")]


def _block_inputs(model, free_point=False, n_cams=3, n_ims=5, seed=3):
    """Per-block numpy inputs of a small perturbed self-cal rig at
    ``model`` (grid 5: 25 keys, 7 pad keys at K = 32): a camera column and a
    pose column fixed, pad keys, key 0 and one coordinate of key 2 frozen,
    pose 0 at exactly zero. ``free_point``: the pose-free chain's inputs
    (poses zero-width; the keys are the points of image 0 in its world
    frame, which the free-point chain reads at identity poses)."""
    rig = make_synthetic_rig(n_cams=n_cams, n_ims=n_ims, grid=5,
                             visibility=0.8, noise_px=2.0, seed=seed,
                             camera_model=model)
    n_keys = rig["n_keys"]
    chain = ([PROJ[model](), Extrinsic3D(), FreePoint()] if free_point else
             [PROJ[model](), Extrinsic3D(), RigidTform3d(), FreePoint()])
    op_fun = OptimFunction(chain)
    widths = js.chain_widths(op_fun)
    assert widths.a == WIDTHS[model]
    blocks = js.build_block_arrays(rig["dd"], n_cams, n_ims, n_keys,
                                   k_pad_multiple=8)
    k_pad = blocks.uv.shape[1]
    rng = np.random.default_rng(seed)
    cam = np.concatenate([rig["intr"], rig["extr"]], axis=1)
    cam = cam * (1.0 + rng.normal(size=cam.shape) * 1e-4)
    im = rig["poses"] + rng.normal(size=rig["poses"].shape) * 1e-3
    im[0] = 0.0
    keyp = np.tile(rig["template"][:1], (k_pad, 1))
    keyp[:n_keys] = rig["template"] + rng.normal(size=(n_keys, 3)) * 1e-3
    bb = n_cams * n_ims
    cmask = np.ones((bb, widths.a))
    cmask[:, 3] = 0.0
    imask = np.ones((bb, 6))
    imask[:, 5] = 0.0
    kmask = np.ones((k_pad, 3))
    kmask[n_keys:] = 0.0
    kmask[0] = 0.0
    kmask[2, 1] = 0.0
    if free_point:
        im, imask = np.zeros((n_ims, 0)), np.zeros((bb, 0))
    return dict(op_fun=op_fun, widths=widths, n_cams=n_cams, n_ims=n_ims,
                k_pad=k_pad, a=widths.a,
                cam_b=np.repeat(cam, n_ims, axis=0),
                im_b=np.tile(im, (n_cams, 1)), keyp=keyp, uv=blocks.uv,
                mask=blocks.mask, cmask=cmask, imask=imask, kmask=kmask)


def _t(a):
    return tensor_from_numpy(a, "cpu", torch.float64)


def _assert_close(got, ref, tol, name):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    if ref.size:
        err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)
        assert err <= tol, (name, err)


def _jargs(d):
    return (jnp.asarray(d["cam_b"]), jnp.asarray(d["im_b"]),
            jnp.asarray(d["keyp"]), jnp.zeros((d["k_pad"], 3)),
            jnp.asarray(d["uv"]), jnp.asarray(d["mask"]),
            jnp.asarray(d["cmask"]), jnp.asarray(d["imask"]),
            jnp.asarray(d["kmask"]))


def _targs(d):
    return (_t(d["cam_b"]), _t(d["im_b"]), _t(d["keyp"]),
            torch.zeros(d["k_pad"], 3, dtype=torch.float64), _t(d["uv"]),
            _t(d["mask"]), _t(d["cmask"]), _t(d["imask"]), _t(d["kmask"]))


def _reduced(ref, d):
    """make_block_grams' 10-tuple reduced on the host into the fused
    builder's ten pieces (the per-block camera masks, summed over images,
    equal the fused builder's post-reduction masking)."""
    n_cams, n_ims, k_pad, a = d["n_cams"], d["n_ims"], d["k_pad"], d["a"]
    b = d["im_b"].shape[1]
    gcc_b, gii_b, wci_b, hkk, wck_b, wik_b, gc_b, gi_b, gk, cost = ref
    return (gcc_b.reshape(n_cams, n_ims, a, a).sum(1),
            gii_b.reshape(n_cams, n_ims, b, b).sum(0), hkk,
            wci_b.reshape(n_cams, n_ims, a, b),
            wck_b.reshape(n_cams, n_ims, k_pad, a, 3).sum(1),
            wik_b.reshape(n_cams, n_ims, k_pad, b, 3).sum(0),
            gc_b.reshape(n_cams, n_ims, a).sum(1),
            gi_b.reshape(n_cams, n_ims, b).sum(0), gk, cost)


@pytest.mark.parametrize("model,loss,semantics", MODEL_LOSS)
def test_kernel_d_plain_twin_matches_xla(model, loss, semantics):
    """The per-block self-cal builder's 10 outputs vs make_block_grams."""
    d = _block_inputs(model)
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    ref = js.make_block_grams(d["op_fun"], d["widths"], **kw)(*_jargs(d))
    widths = ts.GroupWidths(d["a"], 6, 3)
    got = sg.make_cuda_selfcal_grams(widths, **kw)(*_targs(d))
    assert got[0].shape == (d["cam_b"].shape[0], d["a"], d["a"])
    for name, g, r in zip(NAMES, got, ref):
        _assert_close(g.numpy(), r, 1e-9, name)


@pytest.mark.parametrize("model,loss,semantics", MODEL_LOSS)
def test_kernel_c_plain_twin_matches_xla(model, loss, semantics):
    """The fused self-cal builder's ten reduced pieces vs make_block_grams
    reduced on the host."""
    d = _block_inputs(model, n_ims=8)
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    ref = js.make_block_grams(d["op_fun"], d["widths"], **kw)(*_jargs(d))
    args = _targs(d)
    got = sg.make_cuda_selfcal_grams_fused(
        ts.GroupWidths(d["a"], 6, 3), d["n_cams"], d["n_ims"], **kw)(
        *args[:3], *args[4:])
    for name, g, r in zip(FUSED_NAMES, got, _reduced(ref, d)):
        _assert_close(g.numpy(), r, 1e-9, name)


@pytest.mark.parametrize("model,loss,semantics", MODEL_LOSS)
def test_freepoint_plain_twins_match_xla(model, loss, semantics):
    """Both free-point builders (over D per block, over C fused) vs
    make_block_grams of the pose-free chain, the fused one reduced on the
    host; the zero-width pose fields included."""
    d = _block_inputs(model, free_point=True, n_ims=8)
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    ref = js.make_block_grams(d["op_fun"], d["widths"], **kw)(*_jargs(d))
    widths = ts.GroupWidths(d["a"], 0, 3)
    args = _targs(d)
    got = sg.make_cuda_freepoint_grams(widths, **kw)(*args)
    for name, g, r in zip(NAMES, got, ref):
        _assert_close(g.numpy(), r, 1e-9, name)
    got = sg.make_cuda_freepoint_grams_fused(
        widths, d["n_cams"], d["n_ims"], **kw)(*args[:3], *args[4:])
    red = _reduced(ref, d)
    for name, g, r in zip(FP_FUSED_NAMES, got,
                          [red[i] for i in (0, 2, 4, 6, 8, 9)]):
        _assert_close(g.numpy(), r, 1e-9, name)


def test_kernel_d_plain_twin_matches_pallas_tilted(monkeypatch):
    """D's builder vs the JAX package's Pallas self-cal kernel in interpret
    mode at the tilted model (the homography's dXc rows feed the point
    columns) under huber."""
    pg = _interp_shim(monkeypatch)
    d = _block_inputs("tilted")
    kw = dict(loss="huber", f_scale=2.0, loss_semantics="component")
    ref = pg.make_pallas_selfcal_grams(d["widths"], **kw)(*_jargs(d))
    got = sg.make_cuda_selfcal_grams(ts.GroupWidths(24, 6, 3), **kw)(
        *_targs(d))
    for name, g, r in zip(NAMES, got, ref):
        _assert_close(g.numpy(), r, 1e-9, name)


def test_kernel_c_plain_twin_matches_pallas_fisheye(monkeypatch):
    """C's builder vs the fused Pallas self-cal kernel in interpret mode at
    the fisheye model (5 images: the JAX kernel pads them to its tile),
    its arctan swapped for the exact one."""
    pg = _interp_shim(monkeypatch)
    d = _block_inputs("fisheye")
    kw = dict(loss="cauchy", f_scale=2.0, loss_semantics="observation")
    jargs = _jargs(d)
    ref = pg.make_pallas_selfcal_grams_fused(
        d["widths"], d["n_cams"], d["n_ims"], **kw)(*jargs[:3], *jargs[4:])
    args = _targs(d)
    got = sg.make_cuda_selfcal_grams_fused(
        ts.GroupWidths(14, 6, 3), d["n_cams"], d["n_ims"], **kw)(
        *args[:3], *args[4:])
    for name, g, r in zip(FUSED_NAMES, got, ref):
        _assert_close(g.numpy(), r, 1e-9, name)


@pytest.mark.parametrize("model", list(WIDTHS))
def test_scaled_errors_catch_a_doubled_camera_column(model):
    """At every camera width, outputs with any one camera column doubled
    fail the Jacobi-scaled measure of D, C and both free-point wrappers,
    however small the column's entries; the twins' own outputs read 0."""
    d = _block_inputs(model, n_ims=6)
    cam_b, im_b, keyp, _, uv, mask, cmask, imask, kmask = _targs(d)
    n_cams, n_ims, a = d["n_cams"], d["n_ims"], d["a"]
    kw = dict(loss="huber", f_scale=2.0)
    per_block = sg.selfcal_gram_plain(cam_b, im_b, keyp, uv, mask, cmask,
                                      imask, kmask, **kw)
    fused = sg.selfcal_gram_fused_plain(cam_b, im_b, keyp, uv, mask, imask,
                                        kmask, n_cams, n_ims, **kw)
    gram = sg.selfcal_gram_plain(cam_b, im_b, keyp, uv, mask,
                                 torch.ones_like(cmask), imask, kmask,
                                 **kw)[0]
    fp = sg.freepoint_gram_plain(cam_b, keyp, uv, mask, cmask, kmask, **kw)
    fpc = sg.freepoint_gram_fused_plain(cam_b, keyp, uv, mask, kmask, n_cams,
                                        n_ims, **kw)
    assert per_block[0].shape[-1] == a + 7 and fp[0].shape[-1] == a
    measures = (
        (per_block, sg.scaled_errors_selfcal, (0, 1)),
        (fused, lambda g, r: sg.scaled_errors_selfcal_fused(
            g, r, gram, n_cams, n_ims), (0, 2)),
        (fp, sg.scaled_errors_freepoint, (0, 3)),
        (fpc, lambda g, r: sg.scaled_errors_freepoint_fused(
            g, r, n_cams, n_ims), (0, 2)))
    for ref, scaled, (gram_i, wck_i) in measures:
        assert max(scaled(ref, ref).values()) == 0.0
        for col in range(a):
            if not bool(ref[gram_i][:, col, col].any()):
                continue                 # a masked column is zero anyway
            bad = [t.clone() for t in ref]
            bad[gram_i][:, col, :] *= 2.0
            bad[gram_i][:, :, col] *= 2.0
            bad[wck_i][..., col, :] *= 2.0
            assert max(scaled(bad, ref).values()) > 1.0, (model, col)
