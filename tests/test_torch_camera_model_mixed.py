"""Port parity: the multi-target normal equations at the other camera
models.

For the fisheye (a = 14), rational (18), thin-prism (22) and tilted (24)
models, held against the JAX package on the CPU in float64:
``make_mixed_structured_neq`` of the mixed chain (Projection* +
Extrinsic3D + RigidTform3d + GroupRigidTform3d + FreePoint) and
``make_structured_neq`` of the grouped chain (... + RigidTform3d +
GroupTemplatePoints) at the same pieces and masks, each under one of the
four losses, within 1e-9 of each field's max-abs; each chain takes the
fused family (8 images, Kernel E's twin) at two models and the per-block
one (6 images, 33% padding at tile 8: Kernel F's) at the other two. The
solves of both chains at each model: ``test_torch_camera_model_mixed_lm.py``.
"""
import numpy as np
import pytest
import torch

from pycamset_tpu.optim import structured as js
from pycamset_tpu.optim import structured_mixed as jm
from pycamset_tpu_torch.from_jax import (mixed_pieces_from_numpy,
                                         pieces_from_numpy)
from pycamset_tpu_torch.optim import structured as ts
from pycamset_tpu_torch.optim import structured_mixed as tm
from pycamset_tpu_torch.optim.blocks import (Extrinsic3D, FreePoint,
                                             GroupRigidTform3d,
                                             GroupTemplatePoints,
                                             RigidTform3d)
from pycamset_tpu_torch.optim.chain import OptimFunction
from pycamset_tpu_torch.optim.handlers import _projection_block
from test_torch_camera_model_mixed_grams import (N_GROUPS, WIDTHS,
                                                 _jax_chain, _rig)

# (model, loss, image count): 8 images the fused family (E), 6 the
# per-block one (F); the grouped chain takes at each model the family the
# mixed one does not
MIXED_NEQ = [("fisheye", "linear", "component", 8),
             ("rational", "huber", "observation", 6),
             ("thin_prism", "cauchy", "component", 8),
             ("tilted", "soft_l1", "observation", 6)]
GROUPED_NEQ = [(m, loss, sem, 14 - n) for m, loss, sem, n in MIXED_NEQ]


def _assert_close(got, ref, tol, name):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    if ref.size:
        err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)
        assert err <= tol, (name, err)


def _port_chain(model, with_key_cols):
    tail = ([RigidTform3d(), GroupRigidTform3d(), FreePoint()]
            if with_key_cols else [RigidTform3d(), GroupTemplatePoints()])
    return OptimFunction([_projection_block(model), Extrinsic3D(), *tail])


@pytest.mark.parametrize("model,loss,semantics,n_ims", MIXED_NEQ)
def test_make_mixed_structured_neq_matches_jax(model, loss, semantics,
                                               n_ims):
    """The mixed normal equations (every MixedNormalEq field) at the model,
    through the fused (8 images) or the per-block family (6)."""
    import jax.numpy as jnp
    d = _rig(model, n_ims=n_ims)
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    jop, top = _jax_chain(model, True), _port_chain(model, True)
    widths = tm.mixed_chain_widths(top)
    assert widths.a == WIDTHS[model]
    assert (tm.resolve_mixed_grams_fused(top, widths, 3, n_ims)
            is not None) == (n_ims == 8)
    jneq = jm.make_mixed_structured_neq(
        jop, jm.mixed_chain_widths(jop), 3, n_ims, d["gok"], N_GROUPS,
        **kw)(
        jm.MixedPieces(*(jnp.asarray(d[k]) for k in ("cam", "im", "pts",
                                                     "grp"))),
        jnp.asarray(d["uv"]), jnp.asarray(d["mask"]),
        jnp.zeros((d["k_pad"], 3)),
        jm.MixedPieces(*(d[k] for k in ("cm_cam", "cm_im", "cm_key",
                                        "cm_grp"))))
    f64 = torch.float64
    tneq = tm.make_mixed_structured_neq(top, widths, 3, n_ims, d["gok"],
                                        N_GROUPS, **kw)(
        mixed_pieces_from_numpy(d["cam"], d["im"], d["pts"], d["grp"], "cpu",
                                f64),
        torch.as_tensor(d["uv"]), torch.as_tensor(d["mask"]),
        torch.zeros(d["k_pad"], 3, dtype=f64),
        mixed_pieces_from_numpy(d["cm_cam"], d["cm_im"], d["cm_key"],
                                d["cm_grp"], "cpu", f64))
    for name, g, r in zip(jm.MixedNormalEq._fields, tneq, jneq):
        _assert_close(g.numpy(), r, 1e-9, name)


@pytest.mark.parametrize("model,loss,semantics,n_ims", GROUPED_NEQ)
def test_make_structured_neq_grouped_matches_jax(model, loss, semantics,
                                                 n_ims):
    """The grouped normal equations (group rows per GROUP) at the model,
    through the fused (8 images) or the per-block family (6)."""
    import jax.numpy as jnp
    d = _rig(model, n_ims=n_ims)
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    jop, top = _jax_chain(model, False), _port_chain(model, False)
    widths = ts.chain_widths(top)
    assert ts.chain_family(top, widths) == "grouped"
    assert (ts.resolve_fused_grams(top, widths, 3, n_ims)
            is not None) == (n_ims == 8)
    jneq = js.make_structured_neq(
        jop, js.chain_widths(jop), 3, n_ims, group_of_key=d["gok"],
        n_groups=N_GROUPS, **kw)(
        js.ParamPieces(*(jnp.asarray(d[k]) for k in ("cam", "im", "grp"))),
        jnp.asarray(d["uv"]), jnp.asarray(d["mask"]), jnp.asarray(d["tpl"]),
        js.ParamPieces(*(d[k] for k in ("cm_cam", "cm_im", "cm_grp"))))
    f64 = torch.float64
    tneq = ts.make_structured_neq(
        top, widths, 3, n_ims, group_of_key=d["gok"], n_groups=N_GROUPS,
        **kw)(
        pieces_from_numpy(d["cam"], d["im"], d["grp"], "cpu", f64),
        torch.as_tensor(d["uv"]), torch.as_tensor(d["mask"]),
        torch.as_tensor(d["tpl"]),
        pieces_from_numpy(d["cm_cam"], d["cm_im"], d["cm_grp"], "cpu", f64))
    for name, g, r in zip(js.NormalEq._fields, tneq, jneq):
        _assert_close(g.numpy(), r, 1e-9, name)
    assert tuple(tneq.hkk.shape) == (N_GROUPS, 6, 6)
