"""Port parity: the multi-target bundle adjustment (mixed and grouped).

Two chains put a per-GROUP SE(3), the relative pose of one of several
rigidly coupled targets, between the image pose and the point. The mixed
chain (``GroupRigidTform3d + FreePoint``) also frees the points, so its key
axis carries cw = 9 columns [group pose 6 | point 3]; the grouped template
chain (``GroupTemplatePoints``) carries the 6 group-pose columns and takes
its points from the template.

The plain twins of Kernel F (per-block grams) and Kernel E (fused
reduction), what the wrappers run for CPU tensors, are held against the JAX
package's XLA closed form (``make_block_grams``, 1e-9 relative) and its
Pallas kernels in interpret mode (1e-6, ``test_pallas_grams``' bound), with
a fixed camera column, a fixed pose column, the fixed group 0 and frozen
keys. Then the mixed normal equations, the mixed LM ops, the grouped
normal equations, and the whole mixed LM against ``bench.py``'s mixed
problem in float64 on the CPU: the same iterations, evaluations and status,
the cost within 1e-9 relative. A 3 x 6 rig pads 6 -> 8 images (33% > 25%),
so the per-block family (F) serves it, as it serves a 2 x 5 rig; a 3 x 8 rig
pads nothing and takes the fused family (E).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from pycamset_tpu.optim import analytic as ja
from pycamset_tpu.optim import structured as js
from pycamset_tpu.optim import structured_mixed as jm
from pycamset_tpu.optim.blocks import (Extrinsic3D, FreePoint,
                                       GroupRigidTform3d,
                                       GroupTemplatePoints, Projection,
                                       RigidTform3d)
from pycamset_tpu.optim.chain import OptimFunction
from pycamset_tpu.optim.structured_lm import structured_lm_solve
from pycamset_tpu.utils.synthetic import make_synthetic_rig
from pycamset_tpu_torch.from_jax import (mixed_pieces_from_numpy,
                                         pieces_from_numpy, tensor_from_numpy)
from pycamset_tpu_torch.optim import analytic as ta
from pycamset_tpu_torch.optim import blocks as tb
from pycamset_tpu_torch.optim import cuda_mixed_grams as mg
from pycamset_tpu_torch.optim import structured as ts
from pycamset_tpu_torch.optim import structured_mixed as tm
from pycamset_tpu_torch.optim.chain import OptimFunction as TOptimFunction
from pycamset_tpu_torch.optim.structured_lm import (
    structured_lm_solve as t_structured_lm_solve)
from pycamset_tpu_torch.problems import (GROUP_START, grouped_problem,
                                         mixed_problem, selfcal_problem,
                                         standard_problem)
from test_torch_grams import _interp_shim

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)

NAMES = ["gcc_b", "gii_b", "wci_b", "hkk", "wck_b", "wik_b", "gc_b", "gi_b",
         "gk", "cost"]
FUSED_NAMES = ["hcc", "hii", "hkk", "wci", "wck", "wik", "gc", "gi", "gk",
               "cost"]
# the linear loss reads the same under either semantics
LOSS_CASES = [("linear", "component"), ("huber", "component"),
              ("huber", "observation")]
N_GROUPS = 2


def _op_funs(with_key_cols: bool):
    """The JAX and port chains: mixed (cw = 9) or grouped (cw = 6)."""
    if with_key_cols:
        return (OptimFunction([Projection(), Extrinsic3D(), RigidTform3d(),
                               GroupRigidTform3d(), FreePoint()]),
                TOptimFunction([tb.Projection(), tb.Extrinsic3D(),
                                tb.RigidTform3d(), tb.GroupRigidTform3d(),
                                tb.FreePoint()]))
    return (OptimFunction([Projection(), Extrinsic3D(), RigidTform3d(),
                           GroupTemplatePoints()]),
            TOptimFunction([tb.Projection(), tb.Extrinsic3D(),
                            tb.RigidTform3d(), tb.GroupTemplatePoints()]))


def _rig(n_cams=3, n_ims=6, seed=3):
    """A small perturbed two-target rig, grid 5 (25 keys, K = 32 with 7 pad
    keys), its per-link pieces and column masks: camera column 2 and pose
    column 4 fixed, pose 0 at exactly zero, group 0 fixed, the pad keys,
    key 0 and one coordinate of key 2 frozen."""
    rig = make_synthetic_rig(n_cams=n_cams, n_ims=n_ims, grid=5,
                             visibility=0.85, noise_px=2.0, seed=seed)
    n_keys = rig["n_keys"]
    blocks = js.build_block_arrays(rig["dd"], n_cams, n_ims, n_keys,
                                   k_pad_multiple=8)
    k_pad = blocks.uv.shape[1]
    rng = np.random.default_rng(seed)
    cam = np.concatenate([rig["intr"], rig["extr"]], 1)
    cam = cam + rng.normal(size=cam.shape) * 1e-3
    im = rig["poses"] + rng.normal(size=rig["poses"].shape) * 1e-3
    im[0] = 0.0
    pts = np.tile(rig["template"][:1], (k_pad, 1))
    pts[:n_keys] = rig["template"] + rng.normal(size=(n_keys, 3)) * 1e-3
    gok = np.zeros(k_pad, np.int64)
    gok[:n_keys] = np.arange(n_keys) >= n_keys // 2
    cm_cam = np.ones((n_cams, 15))
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
    return dict(n_cams=n_cams, n_ims=n_ims, n_keys=n_keys, k_pad=k_pad,
                uv=blocks.uv, mask=blocks.mask, gok=gok, cam=cam, im=im,
                pts=pts, grp=GROUP_START.copy(), tpl=tpl, cm_cam=cm_cam,
                cm_im=cm_im, cm_key=cm_key, cm_grp=cm_grp)


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


def _t(args, dtype=torch.float64):
    return tuple(tensor_from_numpy(a, "cpu", dtype) for a in args)


def _assert_close(got, ref, tol, name):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    if ref.size:
        assert np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30) <= tol, name


def _xla_refs(d, with_key_cols, kw):
    """make_block_grams (XLA) on the rig: its per-block 10-tuple and the
    same reduced as the fused builder reduces it."""
    n_cams, n_ims, k_pad = d["n_cams"], d["n_ims"], d["k_pad"]
    cw = mg.key_width(with_key_cols)
    jop, _ = _op_funs(with_key_cols)
    per_block = js.make_block_grams(jop, js.GroupWidths(15, 6, cw), **kw)(
        *(jnp.asarray(a) for a in _block_inputs(d, with_key_cols)))
    (gcc_b, gii_b, wci_b, hkk, wck_b, wik_b, gc_b, gi_b, gk,
     cost) = per_block
    reduced = (gcc_b.reshape(n_cams, n_ims, 15, 15).sum(1),
               gii_b.reshape(n_cams, n_ims, 6, 6).sum(0), hkk,
               wci_b.reshape(n_cams, n_ims, 15, 6),
               wck_b.reshape(n_cams, n_ims, k_pad, 15, cw).sum(1),
               wik_b.reshape(n_cams, n_ims, k_pad, 6, cw).sum(0),
               gc_b.reshape(n_cams, n_ims, 15).sum(1),
               gi_b.reshape(n_cams, n_ims, 6).sum(0), gk, cost)
    return per_block, reduced


def _port_builders(d, with_key_cols, kw):
    """The port's per-block (Kernel F) and fused (Kernel E) builders' outputs
    on the rig, float64 on the CPU (the plain twins)."""
    cw = mg.key_width(with_key_cols)
    widths = ts.GroupWidths(15, 6, cw)
    make = (mg.make_cuda_mixed_grams if with_key_cols
            else mg.make_cuda_grouped_grams)
    args = _t(_block_inputs(d, with_key_cols))
    return (make(widths, **kw)(*args),
            mg.make_cuda_mixed_grams_fused(widths, d["n_cams"], d["n_ims"],
                                           with_key_cols=with_key_cols,
                                           **kw)(*args))


@pytest.mark.parametrize("with_key_cols", [True, False])
@pytest.mark.parametrize("loss,semantics", LOSS_CASES)
def test_kernel_twins_match_jax_xla(with_key_cols, loss, semantics):
    """All 10 outputs of the per-block builders (mixed and grouped) vs
    make_block_grams, and the fused builder's ten reduced pieces vs the
    same reduced on the host."""
    d = _rig()
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    ref_block, ref_reduced = _xla_refs(d, with_key_cols, kw)
    got_block, got_fused = _port_builders(d, with_key_cols, kw)
    for name, g, r in zip(NAMES, got_block, ref_block):
        _assert_close(g.numpy(), r, 1e-9, name)
    for name, g, r in zip(FUSED_NAMES, got_fused, ref_reduced):
        _assert_close(g.numpy(), r, 1e-9, name)


# one case per Pallas builder: the per-block mixed (cw = 9) and grouped
# (cw = 6) kernels, and the fused kernel at both widths, which pads 6 -> 8
# images at tile 4 (two grid steps per camera) or takes 6 images in two
# steps of 3 with no padding
@pytest.mark.parametrize("kernel,with_key_cols,loss,semantics,tile", [
    ("per_block", True, "huber", "component", None),
    ("per_block", False, "linear", "component", None),
    ("fused", True, "huber", "observation", 4),
    ("fused", False, "linear", "component", 3),
])
def test_kernel_twins_match_pallas_interpret(monkeypatch, kernel,
                                             with_key_cols, loss, semantics,
                                             tile):
    pg = _interp_shim(monkeypatch)
    d = _rig()
    cw = mg.key_width(with_key_cols)
    widths = js.GroupWidths(15, 6, cw)
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    jargs = tuple(jnp.asarray(a) for a in _block_inputs(d, with_key_cols))
    got_block, got_fused = _port_builders(d, with_key_cols, kw)
    if kernel == "per_block":
        make = (pg.make_pallas_mixed_grams if with_key_cols
                else pg.make_pallas_grouped_grams)
        ref, got, names = make(widths, **kw)(*jargs), got_block, NAMES
    else:
        ref = pg.make_pallas_mixed_grams_fused(
            widths, d["n_cams"], d["n_ims"], with_key_cols=with_key_cols,
            tile=tile, **kw)(*jargs)
        got, names = got_fused, FUSED_NAMES
    for name, g, r in zip(names, got, ref):
        _assert_close(g.numpy(), r, 1e-6, name)


def test_closed_forms_and_key_group_data_match_jax():
    """analytic.block_rj_{mixed_selfcal,grouped_template} vs the JAX
    functions vmapped over blocks, and pack_key_group_data vs the JAX
    operand."""
    import pycamset_tpu.optim.pallas_grams as pg
    d = _rig()
    for with_key_cols in (True, False):
        cam_b, im_b, keyp, tpl, uv, *_ = _block_inputs(d, with_key_cols)
        if with_key_cols:
            ref = jax.jit(jax.vmap(ja.block_rj_mixed_selfcal,
                                   in_axes=(0, 0, None, 0)))(
                cam_b, im_b, keyp, uv)
            got = ta.block_rj_mixed_selfcal(*_t((cam_b, im_b, keyp, uv)))
        else:
            ref = jax.jit(jax.vmap(ja.block_rj_grouped_template,
                                   in_axes=(0, 0, None, None, 0)))(
                cam_b, im_b, keyp, tpl, uv)
            got = ta.block_rj_grouped_template(
                *_t((cam_b, im_b, keyp, tpl, uv)))
        for name, g, r in zip(("r", "jc", "ji", "jk"), got, ref):
            _assert_close(g.numpy(), r, 1e-12, name)
        pts = keyp[:, 6:9] if with_key_cols else tpl
        _assert_close(mg.pack_key_group_data(*_t((keyp[:, :6], pts))).numpy(),
                      jax.jit(pg.pack_key_group_data)(
                          jnp.asarray(keyp[:, :6]), jnp.asarray(pts)),
                      1e-12, "kd")


def test_cpu_mixed_wrappers_run_plain_twins_and_launch_nothing():
    d = _rig()
    args = _t(_block_inputs(d, True))
    n_cams, n_ims = d["n_cams"], d["n_ims"]
    before = (mg.mixed_gram.launches, mg.mixed_gram_fused.launches,
              dict(mg.mixed_gram.launches_by_cw),
              dict(mg.mixed_gram_fused.launches_by_cw))
    per_block = mg.mixed_gram(*args, loss="huber")
    fused = mg.mixed_gram_fused(*args, n_cams, n_ims)
    assert before == (mg.mixed_gram.launches, mg.mixed_gram_fused.launches,
                      mg.mixed_gram.launches_by_cw,
                      mg.mixed_gram_fused.launches_by_cw)
    for x, y in zip(per_block, mg.mixed_gram_plain(*args, loss="huber")):
        assert torch.equal(x, y)
    for x, y in zip(fused, mg.mixed_gram_fused_plain(*args, n_cams, n_ims)):
        assert torch.equal(x, y)


def test_mixed_widths_and_chains_checked():
    with pytest.raises(NotImplementedError, match="make_het_grams"):
        mg.make_cuda_mixed_grams(ts.GroupWidths(16, 6, 9))
    with pytest.raises(NotImplementedError, match="make_het_grams"):
        mg.make_cuda_mixed_grams_fused(ts.GroupWidths(15, 6, 9), 2, 3,
                                       with_key_cols=False)
    _, top = _op_funs(True)
    w = tm.mixed_chain_widths(top)
    assert (w.a, w.b, w.ck, w.cg, w.grp_cols, w.key_cols) == (
        15, 6, 3, 6, (0, 1, 2, 3, 4, 5), (6, 7, 8))
    # the mixed chain is not a pure structured chain; the grouped one is
    with pytest.raises(ts.UnsupportedChain, match="mixing PER_KEY"):
        ts.chain_widths(top)
    _, tgrp = _op_funs(False)
    assert ts.chain_family(tgrp, ts.chain_widths(tgrp)) == "grouped"
    # the grouped family's kernels take the five camera widths; at any
    # other width (the selector row's a = 16) the chain has no kernel and
    # takes the forward-mode route
    for a in (14, 15, 18, 22, 24):
        assert ts.chain_family(tgrp, ts.GroupWidths(a, 6, 6)) == "grouped"
    assert ts.chain_family(tgrp, ts.GroupWidths(16, 6, 6)) is None
    with pytest.raises(tm.UnsupportedChain, match="BOTH"):
        tm.mixed_chain_widths(tgrp)
    # a mixed chain whose c-axis is [point | group pose] has no kernel: it
    # takes the forward-mode route (the JAX package's make_block_grams),
    # its c-axis packed and split by the chain's own layout
    flipped = TOptimFunction([tb.Projection(), tb.Extrinsic3D(),
                              tb.RigidTform3d(), tb.FreePoint(),
                              tb.GroupRigidTform3d()])
    fw = tm.mixed_chain_widths(flipped)
    assert (fw.key_cols, fw.grp_cols) == ((0, 1, 2), (3, 4, 5, 6, 7, 8))
    assert not tm.kernel_chain(flipped, fw)
    assert tm.kernel_chain(top, w)
    assert tm.resolve_mixed_grams_fused(flipped, fw, 2, 8) is None
    assert tm.resolve_mixed_grams(flipped, fw).__qualname__.startswith(
        "_grams_of_rj")
    pack, take_key, take_grp = tm.c_axis_layout(fw)
    keyp = pack(torch.zeros(4, 3), torch.ones(4, 6))
    assert keyp[:, :3].eq(0).all() and keyp[:, 3:].eq(1).all()
    assert take_key(keyp, 1).eq(0).all() and take_grp(keyp, 1).eq(1).all()
    # the pose-free free-point chain is a structured family; a chain
    # outside every family selects no closed form (None), not an error
    fp = TOptimFunction([tb.Projection(), tb.Extrinsic3D(), tb.FreePoint()])
    assert ts.chain_family(fp, ts.chain_widths(fp)) == "freepoint"
    assert ts.chain_family(flipped, ts.GroupWidths(15, 6, 9)) is None


def test_multi_target_family_follows_the_jax_padding_rule():
    """Tile 8 and at most 25% padding, for the mixed and grouped chains."""
    _, top = _op_funs(True)
    w = tm.mixed_chain_widths(top)
    _, tgrp = _op_funs(False)
    wg = ts.chain_widths(tgrp)
    for n_ims, fused in ((5, False), (6, False), (8, True), (12, False),
                         (100, True), (104, True)):
        assert (tm.resolve_mixed_grams_fused(top, w, 2, n_ims)
                is not None) == fused
        assert (ts.resolve_fused_grams(tgrp, wg, 2, n_ims)
                is not None) == fused


def _mixed_neqs(n_ims, loss="linear", semantics="component", n_cams=3):
    """The JAX and port MixedNormalEq of one rig at the same parameters."""
    d = _rig(n_cams=n_cams, n_ims=n_ims)
    jop, top = _op_funs(True)
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    jneq_fn = jm.make_mixed_structured_neq(
        jop, jm.mixed_chain_widths(jop), n_cams, n_ims, d["gok"], N_GROUPS,
        **kw)
    jneq = jneq_fn(
        jm.MixedPieces(*(jnp.asarray(d[k]) for k in ("cam", "im", "pts",
                                                     "grp"))),
        jnp.asarray(d["uv"]), jnp.asarray(d["mask"]),
        jnp.zeros((d["k_pad"], 3)),
        jm.MixedPieces(*(d[k] for k in ("cm_cam", "cm_im", "cm_key",
                                        "cm_grp"))))
    f64 = torch.float64
    tneq = tm.make_mixed_structured_neq(
        top, tm.mixed_chain_widths(top), n_cams, n_ims, d["gok"], N_GROUPS,
        **kw)(
        mixed_pieces_from_numpy(d["cam"], d["im"], d["pts"], d["grp"], "cpu",
                                f64),
        *_t((d["uv"], d["mask"], np.zeros((d["k_pad"], 3)))),
        mixed_pieces_from_numpy(d["cm_cam"], d["cm_im"], d["cm_key"],
                                d["cm_grp"], "cpu", f64))
    return jneq, tneq, jneq_fn.onehot


# (3, 6): per-block family (Kernel F's twin); (3, 8): fused (Kernel E's)
@pytest.mark.parametrize("n_ims", [6, 8])
@pytest.mark.parametrize("loss,semantics", [("linear", "component"),
                                            ("huber", "observation")])
def test_make_mixed_structured_neq_matches_jax(n_ims, loss, semantics):
    jneq, tneq, _ = _mixed_neqs(n_ims, loss, semantics)
    for name, g, r in zip(jm.MixedNormalEq._fields, tneq, jneq):
        _assert_close(g.numpy(), r, 1e-9, name)


def test_mixed_ops_match_jax():
    """matvec and the damped solve on one MixedNormalEq carried across, and
    the step solves the damped system piece by piece."""
    jneq, _, onehot = _mixed_neqs(6)
    tneq = tm.MixedNormalEq(*(torch.tensor(np.asarray(x)) for x in jneq))
    jdiag, jmv, jsolve, _ = jm.make_mixed_ops(onehot)
    tdiag, tmv, tsolve, tgrad = tm.make_mixed_ops(onehot)
    damp = [1e-3 * np.maximum(np.asarray(x), 1e-8) for x in jdiag(jneq)]
    for g, r in zip(tdiag(tneq), jdiag(jneq)):
        _assert_close(g.numpy(), r, 0.0, "diag")
    jsol = jsolve(jneq, jm.MixedPieces(*map(jnp.asarray, damp)))
    tdamp = tm.MixedPieces(*map(torch.tensor, damp))
    tsol = tsolve(tneq, tdamp)
    for g, r in zip(tsol, jsol):
        _assert_close(g.numpy(), r, 1e-9, "dx")
    for g, r in zip(tmv(tneq, tsol), jmv(jneq, jsol)):
        _assert_close(g.numpy(), r, 1e-9, "matvec")
    for h, dmp, x, gr in zip(tmv(tneq, tsol), tdamp, tsol, tgrad(tneq)):
        _assert_close((h + dmp * x).numpy(), (-gr).numpy(), 1e-8, "resid")


def _grouped_neqs(n_ims, loss="linear", semantics="component", n_cams=3):
    """The JAX and port grouped NormalEq of one rig (group rows per GROUP)."""
    d = _rig(n_cams=n_cams, n_ims=n_ims)
    jop, top = _op_funs(False)
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    jneq = js.make_structured_neq(
        jop, js.chain_widths(jop), n_cams, n_ims, group_of_key=d["gok"],
        n_groups=N_GROUPS, **kw)(
        js.ParamPieces(*(jnp.asarray(d[k]) for k in ("cam", "im", "grp"))),
        jnp.asarray(d["uv"]), jnp.asarray(d["mask"]), jnp.asarray(d["tpl"]),
        js.ParamPieces(*(d[k] for k in ("cm_cam", "cm_im", "cm_grp"))))
    f64 = torch.float64
    tneq = ts.make_structured_neq(
        top, ts.chain_widths(top), n_cams, n_ims, group_of_key=d["gok"],
        n_groups=N_GROUPS, **kw)(
        pieces_from_numpy(d["cam"], d["im"], d["grp"], "cpu", f64),
        *_t((d["uv"], d["mask"], d["tpl"])),
        pieces_from_numpy(d["cm_cam"], d["cm_im"], d["cm_grp"], "cpu", f64))
    return jneq, tneq


@pytest.mark.parametrize("n_ims", [6, 8])
@pytest.mark.parametrize("loss,semantics", [("linear", "component"),
                                            ("huber", "observation")])
def test_make_structured_neq_grouped_matches_jax(n_ims, loss, semantics):
    jneq, tneq = _grouped_neqs(n_ims, loss, semantics)
    for name, g, r in zip(js.NormalEq._fields, tneq, jneq):
        _assert_close(g.numpy(), r, 1e-9, name)
    assert tuple(tneq.hkk.shape) == (N_GROUPS, 6, 6)


def test_grouped_chain_needs_its_group_map():
    _, top = _op_funs(False)
    with pytest.raises(ValueError, match="group_of_key"):
        ts.make_structured_neq(top, ts.chain_widths(top), 2, 3)


def _assert_same_lm(got, ref, x_tol):
    assert (got.nit, got.nfev, int(got.status)) == (
        int(ref.nit), int(ref.nfev), int(ref.status))
    assert abs(float(got.cost) - float(ref.cost)) <= 1e-9 * float(ref.cost)
    n = got.nit + 1
    assert np.abs(got.history[:n].numpy() - np.asarray(ref.history)[:n]
                  ).max() <= 1e-9 * float(ref.history[0])
    for g, r in zip(got.x, ref.x):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= x_tol * np.abs(r).max()


# (3, 6) and (2, 5): per-block family (F's twin), (2, 5) runs into its
# budget of 60 evaluations (status 4); (3, 8): fused (E's twin). The
# parameters agree to 1e-6 of their scale: the two-target gauge leaves a
# weakly determined direction that float64 round-off moves along.
@pytest.mark.parametrize("n_cams,n_ims", [(3, 6), (2, 5), (3, 8)])
def test_mixed_lm_matches_jax_package(n_cams, n_ims):
    solve, pieces, args, _ = bench.mixed_problem(n_cams, n_ims, grid=5)
    ref = solve(pieces, *args)
    prob = mixed_problem(n_cams, n_ims, "cpu", grid=5)
    _assert_same_lm(prob.solve(), ref, 1e-6)


def _jax_grouped_solve(n_cams, n_ims):
    """The JAX structured LM on problems.grouped_problem's rig, start and
    gauge (grid 5, k_pad_multiple 128, max_nfev 60)."""
    rig = make_synthetic_rig(n_cams=n_cams, n_ims=n_ims, grid=5,
                             visibility=0.85, noise_px=0.3, seed=5)
    n_keys = rig["n_keys"]
    jop, _ = _op_funs(False)
    bl = js.build_block_arrays(rig["dd"], n_cams, n_ims, n_keys)
    k_pad = bl.uv.shape[1]
    cm, gok = bench.mixed_colmask_groups(n_cams, n_ims, n_keys, k_pad,
                                         np.float64)
    neq = js.make_structured_neq(jop, js.chain_widths(jop), n_cams, n_ims,
                                 group_of_key=gok, n_groups=N_GROUPS)
    uv, mask = bl.as_device(jnp.float64)
    tpl = ts.pad_template_table(rig["template"], True, n_keys, k_pad)
    x0 = js.ParamPieces(
        jnp.asarray(np.concatenate([rig["intr"], rig["extr"]], 1)),
        jnp.asarray(rig["poses"]), jnp.asarray(GROUP_START))
    colmask = js.ParamPieces(cm.cam, cm.im, cm.grp)
    return jax.jit(lambda p: structured_lm_solve(
        lambda q: neq(q, uv, mask, tpl, colmask), p, max_nfev=60))(x0)


@pytest.mark.parametrize("n_cams,n_ims", [(3, 6)])
def test_grouped_lm_matches_jax_package(n_cams, n_ims):
    ref = _jax_grouped_solve(n_cams, n_ims)
    prob = grouped_problem(n_cams, n_ims, "cpu", grid=5)
    _assert_same_lm(prob.solve(), ref, 1e-6)


def test_mixed_problem_matches_bench():
    """The port's mixed problem is bench.py's: start, grid, group map and
    column masks."""
    _, pieces, (uv, mask, tpl), blocks = bench.mixed_problem(3, 6, grid=5)
    prob = mixed_problem(3, 6, "cpu", grid=5)
    for g, r in zip(prob.x0, pieces):
        _assert_close(g.numpy(), r, 1e-15, "x0")
    _assert_close(prob.uv.numpy(), uv, 1e-15, "uv")
    assert np.array_equal(prob.mask.numpy(), np.asarray(mask))
    k_pad = prob.mask.shape[1]
    ref_cm, ref_gok = bench.mixed_colmask_groups(3, 6, blocks.n_keys, k_pad,
                                                 np.float64)
    for g, r in zip(prob.colmask, ref_cm):
        assert np.array_equal(g.numpy(), r)
    assert np.array_equal(prob.group_of_key, ref_gok)
    assert not prob.tpl.any() and prob.max_nfev == 60


def test_full_vector_round_trip_matches_jax():
    """split_full_mixed / pad_mixed_pieces / merge_mixed_to_full against the
    JAX functions on one full parameter vector."""
    d = _rig()
    jop, top = _op_funs(True)
    n_keys, k_pad = d["n_keys"], d["k_pad"]
    struct = top.param_struct(3, 6, n_keys, n_groups=N_GROUPS)
    full = np.random.default_rng(0).normal(size=struct.total)
    jstruct = jop.param_struct(3, 6, n_keys, n_groups=N_GROUPS)
    ref = jm.split_full_mixed(full, jop, jstruct, 3, 6, n_keys, N_GROUPS,
                              xp=np)
    got = tm.split_full_mixed(torch.tensor(full), top, struct, 3, 6, n_keys,
                              N_GROUPS)
    for g, r in zip(got, ref):
        _assert_close(g.numpy(), r, 0.0, "split")
    padded = tm.pad_mixed_pieces(got, n_keys, k_pad, 6, 8)
    ref_pad = jm.pad_mixed_pieces(ref, n_keys, k_pad, 6, 8, xp=np)
    for g, r in zip(padded, ref_pad):
        _assert_close(g.numpy(), r, 0.0, "pad")
    assert np.array_equal(
        tm.merge_mixed_to_full(padded, top, struct, 3, 6, n_keys, N_GROUPS),
        full)


@pytest.mark.parametrize("col", [0, 4, 7])
def test_scaled_errors_catch_a_doubled_key_column(col):
    """A kernel that doubled one key column (group rotation 0, group
    translation 1, point 1) fails the scaled check in hkk, and through the
    group sums in hgg, or in hkk alone for a point column."""
    d = _rig(n_ims=8)
    args = _t(_block_inputs(d, True))
    ref = mg.mixed_gram_fused_plain(*args, 3, 8)
    bad = list(ref)
    bad[8] = ref[8].clone()
    bad[8][:, col, :] *= 2.0
    bad[8][:, :, col] *= 2.0
    errs = mg.scaled_errors_mixed_fused(bad, ref, mg.mixed_gram_plain(
        *args)[0], 3, 8)
    assert errs["hkk"] > 0.1, errs
    oh = torch.tensor(ts.group_onehot(d["gok"], N_GROUPS))
    grp = mg.scaled_errors_groups(bad, ref, oh, 3, 8)
    assert (grp["hgg"] > 0.1) == (col < 6), grp
    assert max(mg.scaled_errors_groups(ref, ref, oh, 3, 8).values()) == 0.0


def test_ops_none_leaves_the_lm_sequence_unchanged():
    """The structured defaults, passed as ops, give the default's bits on
    the template and self-cal problems."""
    from pycamset_tpu_torch.optim.structured import (neq_diag, neq_matvec,
                                                     schur_solve)
    for make in (standard_problem, selfcal_problem):
        prob = make(3, 5, "cpu", grid=6, k_pad_multiple=8)
        base = prob.solve()
        ops = t_structured_lm_solve(prob.neq_fn(), prob.x0,
                                    ops=(neq_diag, neq_matvec, schur_solve,
                                         None))
        assert (base.nit, base.nfev) == (ops.nit, ops.nfev)
        assert torch.equal(base.history, ops.history)
        for a, b in zip(base.x, ops.x):
            assert torch.equal(a, b)
