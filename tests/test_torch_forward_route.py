"""Port parity: the structured backend's forward-mode route (float64, CPU).

``structured.make_block_grams`` is the JAX package's ``make_block_grams``
on a chain with no closed form (its ``jax.jacfwd`` branch): every chain
that ``chain_widths`` (or, mixed, ``mixed_chain_widths``) accepts and no
kernel family serves. Held here, at 3 cameras, 6-8 images and a 7 x 7
grid:

- against the JAX jacfwd route, all ten outputs within 1e-9 relative, the
  linear and Huber losses under both loss semantics, on the
  rolling-shutter chain, a chain with a block of the caller's own
  (``problems.skew_block``: a per-camera pixel skew in front of the
  template chain, built for both packages), and the heterogeneous grouped and mixed chains (fisheye and
  standard cameras in turn: ``ProjectionHet``), and their normal equations
  (``make_structured_neq`` / ``make_mixed_structured_neq``);
- against the port's closed-form twin on the standard template chain;
- ``run_bundle_adjustment(backend="auto")`` on the rolling-shutter and the
  skew chains: both packages take the structured backend, with the same
  nit, nfev and status and the cost within 1e-9 relative (before the route
  existed the port took the generic backend for such chains);
- the dispatch: a chain reaches a kernel by its block names only, and the
  heterogeneous multi-target problems (``problems.grouped_problem`` /
  ``mixed_problem`` with a per-camera model list) solve on the route.
"""
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycamset_tpu.optim import blocks as jb
from pycamset_tpu.optim.analytic import analytic_block_rj_for_chain
from pycamset_tpu.optim import structured as js
from pycamset_tpu.optim import structured_mixed as jm
from pycamset_tpu.optim.chain import OptimFunction as JChain
from pycamset_tpu.optim.driver import run_bundle_adjustment as jax_rba
from pycamset_tpu_torch import problems
from pycamset_tpu_torch.optim import blocks as tb
from pycamset_tpu_torch.optim import structured as ts
from pycamset_tpu_torch.optim import structured_mixed as tm
from pycamset_tpu_torch.optim.chain import OptimFunction as TChain
from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
from pycamset_tpu_torch.optim.structured_driver import (
    build_structured_problem)
from test_fleet import _template_handler
from test_torch_fleet_handlers import _port_handler

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)

HET = ["fisheye", "standard", "fisheye"]
LOSSES = [("linear", "component"), ("huber", "component"),
          ("huber", "observation")]
CHAINS = ["rs", "skew", "het_grouped", "het_mixed"]


def _skew_pair():
    """The JAX test rig's template handler (PnP-seeded) and the port's,
    each with the skew block in front."""
    jhandler, _ = _template_handler(n_cams=3, n_ims=6, grid=5, seed=5,
                                    options={"verbosity": 0})
    x0 = np.array(jhandler.get_initial_params())
    port = _port_handler(jhandler, "template", options={"verbosity": 0})
    port.missing_poses = jhandler.missing_poses
    return (problems.with_skew(jhandler, x0, jb, jnp),
            problems.with_skew(port, x0))


def _jax_chain(op_fun):
    """The JAX package's chain of a port chain, block by block."""
    out = []
    for bk in op_fun.blocks:
        name = type(bk).__name__
        if name == "ProjectionHet":
            out.append(jb.ProjectionHet(bk.brown_model))
        elif name == "Skew":
            out.append(problems.skew_block(jb, jnp))
        else:
            out.append(getattr(jb, name)())
    return JChain(out)


def _problem(chain):
    """A port problem of ``chain`` on the CPU (BAProblem or MixedProblem)."""
    if chain == "rs":
        handler, _ = problems.rs_handler(3, 6, grid=7)
        return build_structured_problem(handler, device="cpu")[0].problem
    if chain == "skew":
        return build_structured_problem(_skew_pair()[1],
                                        device="cpu")[0].problem
    maker = (problems.grouped_problem if chain == "het_grouped"
             else problems.mixed_problem)
    return maker(3, 8, "cpu", grid=7, camera_model=HET)


def _block_inputs(prob, skew=0.0):
    """make_block_grams' operands at a problem's start, torch and numpy."""
    x0 = prob.x0
    if skew:     # move the skew off zero: its column is non-trivial
        x0 = x0._replace(cam=x0.cam.clone())
        x0.cam[:, 0] = skew * torch.arange(1.0, x0.cam.shape[0] + 1,
                                           dtype=torch.float64)
    cam_b, im_b, cmask_b, imask_b = ts._block_params(
        x0, prob.colmask, prob.blocks.n_cams, prob.blocks.n_ims)
    keyp, kmask = prob.key_operands(x0, prob.colmask)
    args = (cam_b, im_b, keyp, prob.tpl, prob.uv, prob.mask, cmask_b,
            imask_b, kmask)
    return args, [jnp.asarray(a.numpy()) for a in args]


def _rel(got, ref) -> float:
    ref = np.asarray(ref)
    got = np.asarray(got)
    assert got.shape == ref.shape
    if not ref.size:
        return 0.0
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


@pytest.fixture(scope="module")
def problems_by_chain():
    return {c: _problem(c) for c in CHAINS}


@pytest.mark.parametrize("loss,semantics", LOSSES)
@pytest.mark.parametrize("chain", CHAINS)
def test_block_grams_match_jacfwd(chain, loss, semantics,
                                  problems_by_chain):
    prob = problems_by_chain[chain]
    assert ts.chain_family(prob.op_fun, ts.GroupWidths(
        prob.widths.a, prob.widths.b, prob.widths.c)) is None
    args, jargs = _block_inputs(prob, skew=1e-3 if chain == "skew" else 0)
    jop = _jax_chain(prob.op_fun)
    jw = js.GroupWidths(prob.widths.a, prob.widths.b, prob.widths.c)
    assert analytic_block_rj_for_chain(jop) is None      # jacfwd there
    kw = dict(loss=loss, f_scale=0.5, loss_semantics=semantics)
    got = ts.make_block_grams(prob.op_fun, ts.GroupWidths(
        prob.widths.a, prob.widths.b, prob.widths.c), **kw)(*args)
    ref = js.make_block_grams(jop, jw, **kw)(*jargs)
    for name, g, r in zip(("gcc_b", "gii_b", "wci_b", "hkk", "wck_b",
                           "wik_b", "gc_b", "gi_b", "gk", "cost"), got, ref):
        assert _rel(g.numpy(), r) <= 1e-9, name


@pytest.mark.parametrize("loss,semantics", LOSSES)
def test_block_grams_match_the_closed_form_twin(loss, semantics):
    """On the standard template chain (Kernel A's chain) the forward-mode
    route gives the closed-form twin's grams: an independent check of the
    route."""
    prob = problems.standard_problem(3, 6, "cpu", grid=7)
    args, _ = _block_inputs(prob)
    kw = dict(loss=loss, f_scale=0.5, loss_semantics=semantics)
    got = ts.make_block_grams(prob.op_fun, prob.widths, **kw)(*args)
    ref = ts.resolve_block_grams(prob.op_fun, prob.widths, **kw)(*args)
    for g, r in zip(got, ref):
        assert _rel(g.numpy(), r.numpy()) <= 1e-9


@pytest.mark.parametrize("chain", ["het_grouped", "het_mixed"])
def test_multi_target_normal_equations_match_jax(chain, problems_by_chain):
    """The whole normal equations of the heterogeneous multi-target chains
    (group expansion and reduction around the route) against the JAX
    package's builders."""
    prob = problems_by_chain[chain]
    jop = _jax_chain(prob.op_fun)
    n_c, n_i = prob.blocks.n_cams, prob.blocks.n_ims
    data = [jnp.asarray(t.numpy()) for t in (prob.uv, prob.mask, prob.tpl)]
    if chain == "het_grouped":
        jneq = js.make_structured_neq(
            jop, js.chain_widths(jop), n_c, n_i, loss="huber", f_scale=0.5,
            group_of_key=prob.group_of_key, n_groups=prob.n_groups)
        pieces = js.ParamPieces
    else:
        jneq = jm.make_mixed_structured_neq(
            jop, jm.mixed_chain_widths(jop), n_c, n_i, prob.group_of_key,
            prob.n_groups, loss="huber", f_scale=0.5)
        pieces = jm.MixedPieces
    got = type(prob)(**{**prob.__dict__, "loss": "huber", "f_scale": 0.5,
                        "graphs": {}}).neq_fn()(prob.x0)
    ref = jneq(pieces(*(jnp.asarray(t.numpy()) for t in prob.x0)), *data,
               pieces(*(jnp.asarray(t.numpy()) for t in prob.colmask)))
    for g, r in zip(got, ref):
        assert _rel(g.numpy(), r) <= 1e-9


def _auto_pair(chain):
    if chain == "skew":
        return _skew_pair()
    from test_torch_rolling_shutter import _capture, _pair
    cams, tpl, dd, _p, _v = _capture(6, 0.1, 2)
    return _pair(cams, tpl, dd)


@pytest.mark.parametrize("chain", ["rs", "skew"])
def test_auto_takes_the_structured_backend_as_jax(chain, caplog):
    """``backend="auto"`` on a chain of no kernel family: both packages
    log the structured backend and solve alike."""
    jhandler, port = _auto_pair(chain)
    caplog.set_level(logging.INFO)
    jres, _ = jax_rba(jhandler, backend="auto")
    jlog = [r.getMessage() for r in caplog.records]
    caplog.clear()
    pres, _ = run_bundle_adjustment(port, backend="auto", device="cpu")
    plog = [r.getMessage() for r in caplog.records]
    for log in (jlog, plog):
        assert "Using the structured (Schur) backend" in log
        assert not any("falling back" in m for m in log)
    assert (pres.nit, pres.nfev, pres.status) == (jres.nit, jres.nfev,
                                                  jres.status)
    assert abs(pres.cost - jres.cost) <= 1e-9 * jres.cost


def test_kernels_are_chosen_by_block_names(monkeypatch):
    """The rolling-shutter and the heterogeneous selector chains both have
    a = 16, and a skew chain's width is the standard one's plus one: no
    chain outside the families reaches a kernel, whatever its width; the
    families keep theirs."""
    monkeypatch.setattr(ts, "make_block_grams", lambda *a, **k: "route")
    monkeypatch.setattr(tm, "make_block_grams", lambda *a, **k: "route")
    rs = TChain([tb.Projection(), tb.Extrinsic3D(), tb.RSPoseVel(),
                 tb.RSTemplateTime()])
    het_grouped = TChain([tb.ProjectionHet("standard"), tb.Extrinsic3D(),
                          tb.RigidTform3d(), tb.GroupTemplatePoints()])
    for op_fun in (rs, het_grouped):
        w = ts.chain_widths(op_fun)
        assert w.a == 16 and ts.chain_family(op_fun, w) is None
        assert ts.resolve_fused_grams(op_fun, w, 3, 8) is None
        assert ts.resolve_block_grams(op_fun, w) == "route"
    # the same widths under a family's names take its kernel
    tpl = TChain([tb.Projection(), tb.Extrinsic3D(), tb.TemplatePoints()])
    assert ts.chain_family(tpl, ts.GroupWidths(15, 6, 0)) == "template"
    assert ts.chain_family(tpl, ts.GroupWidths(16, 6, 0)) is None
    mixed = TChain([tb.ProjectionHet("standard"), tb.Extrinsic3D(),
                    tb.RigidTform3d(), tb.GroupRigidTform3d(),
                    tb.FreePoint()])
    mw = tm.mixed_chain_widths(mixed)
    assert not tm.kernel_chain(mixed, mw)
    assert tm.resolve_mixed_grams(mixed, mw) == "route"
    assert tm.resolve_mixed_grams_fused(mixed, mw, 3, 8) is None


@pytest.mark.parametrize("chain", ["het_grouped", "het_mixed"])
def test_het_multi_target_problems_solve(chain, problems_by_chain):
    """The heterogeneous multi-target problems solve on the route, with no
    gram kernel launched."""
    from pycamset_tpu_torch.optim import cuda_mixed_grams as mg
    prob = problems_by_chain[chain]
    before = (mg.mixed_gram.launches, mg.mixed_gram_fused.launches)
    res = prob.solve()
    assert (mg.mixed_gram.launches, mg.mixed_gram_fused.launches) == before
    assert int(res.status) in (1, 2)
    assert prob.rms_px(res.cost) <= 0.36
