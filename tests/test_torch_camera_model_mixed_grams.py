"""Port parity: Kernels E and F at the other camera models' widths.

The plain twins of Kernel F (per-block grams) and Kernel E (fused
reduction), what the wrappers run for CPU tensors, are held against the JAX
package's XLA closed form (``make_block_grams``, reduced on the host for
the fused contract) at the fisheye (a = 14), rational (18), thin-prism (22)
and tilted (24) models, at both key widths (the mixed chain's cw = 9, the
grouped chain's cw = 6), each under one of the four losses, with a fixed
camera column, a fixed pose column, the fixed group 0 and frozen keys;
float64, every output within 1e-9 of its max-abs scale (F and E share
one XLA reference a case). One case per kernel also runs the JAX package's
Pallas kernel in interpret mode, as ``tests/test_torch_mixed.py`` runs
them: E at the rational model, cw 9, and F at the fisheye model, cw 6,
its arctan swapped for the exact one (``_interp_shim``). Interpret mode
traces a kernel anew, 13-40 s a case here (the tilted ones the longest),
so the tilted model is held to the XLA form only. The Jacobi-scaled
measures of E and F and of the per-group sums the solver builds from them
(``scaled_errors_groups``) are checked at each width to catch one doubled
lens column or group column. The CUDA kernels themselves run only on a
card (``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycamset_tpu.optim import structured as js
from pycamset_tpu.optim.blocks import (Extrinsic3D, FreePoint,
                                       GroupRigidTform3d,
                                       GroupTemplatePoints, RigidTform3d)
from pycamset_tpu.optim.chain import OptimFunction
from pycamset_tpu.utils.synthetic import make_synthetic_rig
from pycamset_tpu_torch.from_jax import tensor_from_numpy
from pycamset_tpu_torch.optim import cuda_mixed_grams as mg
from pycamset_tpu_torch.optim import structured as ts
from pycamset_tpu_torch.problems import GROUP_START
from test_torch_camera_model_grams import PROJ, WIDTHS, _interp_shim

NAMES = ["gcc_b", "gii_b", "wci_b", "hkk", "wck_b", "wik_b", "gc_b", "gi_b",
         "gk", "cost"]
FUSED_NAMES = ["hcc", "hii", "hkk", "wci", "wck", "wik", "gc", "gi", "gk",
               "cost"]
N_GROUPS = 2
# each model under one of the four losses (both semantics among them), at
# both key widths
MODEL_LOSS = [("fisheye", "linear", "component"),
              ("rational", "cauchy", "observation"),
              ("thin_prism", "huber", "component"),
              ("tilted", "soft_l1", "observation")]
CASES = [(m, loss, sem, wk) for m, loss, sem in MODEL_LOSS
         for wk in (True, False)]


def _jax_chain(model, with_key_cols):
    """The JAX chain at ``model``: mixed (cw = 9) or grouped (cw = 6)."""
    tail = ([RigidTform3d(), GroupRigidTform3d(), FreePoint()]
            if with_key_cols else [RigidTform3d(), GroupTemplatePoints()])
    return OptimFunction([PROJ[model](), Extrinsic3D(), *tail])


def _rig(model, n_cams=3, n_ims=6, seed=3):
    """A small perturbed two-target rig at ``model`` (grid 5: 25 keys,
    K = 32 with 7 pad keys), as ``tests/test_torch_mixed.py``'s: camera
    column 2 and pose column 4 fixed, pose 0 at exactly zero, group 0
    fixed, the pad keys, key 0 and one coordinate of key 2 frozen."""
    rig = make_synthetic_rig(n_cams=n_cams, n_ims=n_ims, grid=5,
                             visibility=0.85, noise_px=2.0, seed=seed,
                             camera_model=model)
    n_keys = rig["n_keys"]
    blocks = js.build_block_arrays(rig["dd"], n_cams, n_ims, n_keys,
                                   k_pad_multiple=8)
    k_pad = blocks.uv.shape[1]
    rng = np.random.default_rng(seed)
    cam = np.concatenate([rig["intr"], rig["extr"]], 1)
    a = cam.shape[1]
    assert a == WIDTHS[model]
    cam = cam * (1.0 + rng.normal(size=cam.shape) * 1e-4)
    im = rig["poses"] + rng.normal(size=rig["poses"].shape) * 1e-3
    im[0] = 0.0
    pts = np.tile(rig["template"][:1], (k_pad, 1))
    pts[:n_keys] = rig["template"] + rng.normal(size=(n_keys, 3)) * 1e-3
    gok = np.zeros(k_pad, np.int64)
    gok[:n_keys] = np.arange(n_keys) >= n_keys // 2
    cm_cam = np.ones((n_cams, a))
    cm_cam[:, 2] = 0.0
    cm_im = np.ones((n_ims, 6))
    cm_im[0] = 0.0
    cm_im[:, 4] = 0.0
    cm_key = np.ones((k_pad, 3))
    cm_key[n_keys:] = 0.0
    cm_key[0] = 0.0
    cm_key[2, 1] = 0.0
    cm_grp = np.ones((N_GROUPS, 6))
    cm_grp[0] = 0.0
    tpl = ts.pad_template_table(rig["template"], True, n_keys, k_pad)
    return dict(model=model, a=a, n_cams=n_cams, n_ims=n_ims,
                n_keys=n_keys, k_pad=k_pad, uv=blocks.uv, mask=blocks.mask,
                gok=gok, cam=cam, im=im, pts=pts, grp=GROUP_START.copy(),
                tpl=tpl, cm_cam=cm_cam, cm_im=cm_im, cm_key=cm_key,
                cm_grp=cm_grp)


def _block_inputs(d, with_key_cols):
    """The per-block numpy operands of one chain:
    (cam_b, im_b, keyp, tpl, uv, mask, cmask_b, imask_b, kmask)."""
    n_cams, n_ims = d["n_cams"], d["n_ims"]
    oh = ts.group_onehot(d["gok"], N_GROUPS)
    if with_key_cols:
        keyp = np.concatenate([oh @ d["grp"], d["pts"]], 1)
        kmask = np.concatenate([oh @ d["cm_grp"], d["cm_key"]], 1)
        tpl = np.zeros((d["k_pad"], 3))
    else:
        keyp, tpl = oh @ d["grp"], d["tpl"]
        kmask = oh @ d["cm_grp"]
        kmask[d["n_keys"]:] = 0.0
    return (np.repeat(d["cam"], n_ims, 0), np.tile(d["im"], (n_cams, 1)),
            keyp, tpl, d["uv"], d["mask"],
            np.repeat(d["cm_cam"], n_ims, 0), np.tile(d["cm_im"], (n_cams, 1)),
            kmask)


def _t(args):
    return tuple(tensor_from_numpy(a, "cpu", torch.float64) for a in args)


def _assert_close(got, ref, tol, name):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    if ref.size:
        err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)
        assert err <= tol, (name, err)


@functools.cache
def _xla_refs(model, with_key_cols, loss, semantics):
    """The rig at ``model`` (8 images) and make_block_grams (XLA) on it
    under one loss: its per-block 10-tuple and the same reduced as the
    fused builder reduces it."""
    d = _rig(model, n_ims=8)
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    n_cams, n_ims, k_pad, a = d["n_cams"], d["n_ims"], d["k_pad"], d["a"]
    cw = mg.key_width(with_key_cols)
    per_block = js.make_block_grams(
        _jax_chain(d["model"], with_key_cols), js.GroupWidths(a, 6, cw),
        **kw)(*(jnp.asarray(x) for x in _block_inputs(d, with_key_cols)))
    (gcc_b, gii_b, wci_b, hkk, wck_b, wik_b, gc_b, gi_b, gk,
     cost) = per_block
    reduced = (gcc_b.reshape(n_cams, n_ims, a, a).sum(1),
               gii_b.reshape(n_cams, n_ims, 6, 6).sum(0), hkk,
               wci_b.reshape(n_cams, n_ims, a, 6),
               wck_b.reshape(n_cams, n_ims, k_pad, a, cw).sum(1),
               wik_b.reshape(n_cams, n_ims, k_pad, 6, cw).sum(0),
               gc_b.reshape(n_cams, n_ims, a).sum(1),
               gi_b.reshape(n_cams, n_ims, 6).sum(0), gk, cost)
    return d, per_block, reduced


@pytest.mark.parametrize("model,loss,semantics,with_key_cols", CASES)
def test_kernel_f_plain_twin_matches_xla(model, loss, semantics,
                                         with_key_cols):
    """The per-block builder (mixed, or grouped) on Kernel F's twin: all 10
    outputs vs make_block_grams at the model's width."""
    d, ref, _ = _xla_refs(model, with_key_cols, loss, semantics)
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    widths = ts.GroupWidths(d["a"], 6, mg.key_width(with_key_cols))
    make = (mg.make_cuda_mixed_grams if with_key_cols
            else mg.make_cuda_grouped_grams)
    got = make(widths, **kw)(*_t(_block_inputs(d, with_key_cols)))
    assert got[0].shape == (d["n_cams"] * d["n_ims"], d["a"], d["a"])
    for name, g, r in zip(NAMES, got, ref):
        _assert_close(g.numpy(), r, 1e-9, name)


@pytest.mark.parametrize("model,loss,semantics,with_key_cols", CASES)
def test_kernel_e_plain_twin_matches_xla(model, loss, semantics,
                                         with_key_cols):
    """The fused builder on Kernel E's twin: its ten reduced pieces vs
    make_block_grams reduced on the host, at the model's width."""
    d, _, ref = _xla_refs(model, with_key_cols, loss, semantics)
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    widths = ts.GroupWidths(d["a"], 6, mg.key_width(with_key_cols))
    got = mg.make_cuda_mixed_grams_fused(
        widths, d["n_cams"], d["n_ims"], with_key_cols=with_key_cols, **kw)(
        *_t(_block_inputs(d, with_key_cols)))
    assert got[0].shape == (d["n_cams"], d["a"], d["a"])
    for name, g, r in zip(FUSED_NAMES, got, ref):
        _assert_close(g.numpy(), r, 1e-9, name)


def test_kernel_e_plain_twin_matches_pallas_rational(monkeypatch):
    """E's builder (cw 9) vs the fused Pallas mixed kernel in interpret mode
    at the rational model (the lens ratio's dXc rows feed every key
    column), 6 images at tile 4 (padded to 8: two grid steps a camera)."""
    pg = _interp_shim(monkeypatch)
    d = _rig("rational")
    kw = dict(loss="huber", f_scale=2.0, loss_semantics="observation")
    args = _block_inputs(d, True)
    ref = pg.make_pallas_mixed_grams_fused(
        js.GroupWidths(18, 6, 9), d["n_cams"], d["n_ims"],
        with_key_cols=True, tile=4, **kw)(*(jnp.asarray(x) for x in args))
    got = mg.make_cuda_mixed_grams_fused(
        ts.GroupWidths(18, 6, 9), d["n_cams"], d["n_ims"], **kw)(*_t(args))
    for name, g, r in zip(FUSED_NAMES, got, ref):
        _assert_close(g.numpy(), r, 1e-9, name)


def test_kernel_f_plain_twin_matches_pallas_fisheye(monkeypatch):
    """F's grouped builder (cw 6) vs the per-block Pallas grouped kernel in
    interpret mode at the fisheye model (its group columns through the
    Kannala-Brandt dXc rows)."""
    pg = _interp_shim(monkeypatch)
    d = _rig("fisheye")
    kw = dict(loss="cauchy", f_scale=2.0, loss_semantics="component")
    args = _block_inputs(d, False)
    ref = pg.make_pallas_grouped_grams(js.GroupWidths(14, 6, 6), **kw)(
        *(jnp.asarray(x) for x in args))
    got = mg.make_cuda_grouped_grams(ts.GroupWidths(14, 6, 6), **kw)(
        *_t(args))
    for name, g, r in zip(NAMES, got, ref):
        _assert_close(g.numpy(), r, 1e-9, name)


@pytest.mark.parametrize("with_key_cols", [True, False])
@pytest.mark.parametrize("model", ["fisheye", "rational", "thin_prism",
                                   "tilted"])
def test_scaled_errors_catch_a_doubled_lens_or_group_column(model,
                                                            with_key_cols):
    """At every camera width and key width, outputs with any one lens
    column doubled fail the Jacobi-scaled measure of F and of E, however
    small the column's entries; a doubled group column fails the per-group
    measure (hgg, wcg, wig, gg) of both; the twins' own outputs read 0."""
    d = _rig(model, n_ims=8)
    args = _t(_block_inputs(d, with_key_cols))
    n_cams, n_ims, a = d["n_cams"], d["n_ims"], d["a"]
    oh = ts.group_onehot(d["gok"], N_GROUPS)
    oh = torch.as_tensor(oh, dtype=torch.float64)
    kw = dict(with_key_cols=with_key_cols, loss="huber", f_scale=2.0)
    f_ref = mg.mixed_gram_plain(*args, **kw)
    e_ref = mg.mixed_gram_fused_plain(*args, n_cams, n_ims, **kw)
    assert f_ref[0].shape[-1] == a + 7 and e_ref[0].shape[-1] == a
    # (outputs, their measure, the gram's index, the camera couplings')
    measures = (
        (f_ref, mg.scaled_errors_mixed, 0, 1),
        (e_ref, lambda g, r: mg.scaled_errors_mixed_fused(
            g, r, f_ref[0], n_cams, n_ims), 0, 2))
    for ref, scaled, gram_i, wcc_i in measures:
        assert max(scaled(ref, ref).values()) == 0.0
        assert max(mg.scaled_errors_groups(ref, ref, oh, n_cams,
                                           n_ims).values()) == 0.0
        for col in range(a - 6):        # the lens columns
            if not bool(ref[gram_i][:, col, col].any()):
                continue                 # a masked column is zero anyway
            bad = [t.clone() for t in ref]
            bad[gram_i][:, col, :] *= 2.0
            bad[gram_i][:, :, col] *= 2.0
            bad[wcc_i][..., col, :] *= 2.0
            assert max(scaled(bad, ref).values()) > 1.0, (model, col)
        for col in range(6):            # group 1's pose columns
            bad = [t.clone() for t in ref]
            hkk, gk = len(ref) - 2, len(ref) - 1
            bad[hkk][:, col, :] *= 2.0
            bad[hkk][:, :, col] *= 2.0
            bad[gk][:, col] *= 2.0
            groups = mg.scaled_errors_groups(bad, ref, oh, n_cams, n_ims)
            assert max(groups.values()) > 1.0, (model, col)
