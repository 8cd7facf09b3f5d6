"""Port parity: the matrix-free CG reduced solver.

``schur_solve(method="cg")`` and the LM with ``reduced_solver="cg"`` of
``pycamset_tpu_torch.optim`` against ``pycamset_tpu.optim`` on the same
numpy inputs, float64 on the CPU (JAX's ``jax.scipy.sparse.linalg.cg`` is
the reference loop):

- the CG step on the template chain (c = 0: the whole cam + pose system
  through wci; two padded pose slots and the gauge pose fixed, as
  ``tests/test_structured.py``'s pose-elimination test), the self-cal chain
  (b = 6, c = 3; that file's CG test rig) and the pose-free free-point chain
  (b = 0: a zero-width image piece): within 1e-9 of max-abs at
  ``cg_tol=1e-12, cg_maxiter=2000`` and at the defaults (1e-6, 250), and
  within 1e-6 of the dense step at the tight tolerance;
- the masked fixed-count loop (``structured.pcg``) against an early-exit
  loop of JAX's iteration, bit for bit, and under ``torch.func.vmap``
  against each system's own loop;
- ``auto_reduced_solver`` against JAX's on a grid of (a, b, c, C, I) with
  4096 and 4097 reduced dimensions;
- ``structured_lm_solve(reduced_solver="cg")`` on the three chains: the same
  nit, nfev and status, the cost within 1e-9 relative.

The handler paths with CG are ``tests/test_torch_cg_handlers.py``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycamset_tpu.optim import structured as js
from pycamset_tpu.optim import structured_lm as jlm
from pycamset_tpu.optim.blocks import (Extrinsic3D, FreePoint, Projection,
                                       RigidTform3d, TemplatePoints)
from pycamset_tpu.optim.chain import OptimFunction
from pycamset_tpu.utils.synthetic import make_synthetic_rig
from pycamset_tpu_torch import problems
from pycamset_tpu_torch.from_jax import pieces_from_numpy
from pycamset_tpu_torch.optim import structured as ts
from pycamset_tpu_torch.optim import structured_lm as tlm

F64 = torch.float64
TIGHT = dict(cg_tol=1e-12, cg_maxiter=2000)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if not ref.size:
        return 0.0
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)


def _chain(name):
    """The JAX and port op funcs of a chain."""
    from pycamset_tpu_torch.optim import blocks as tb
    from pycamset_tpu_torch.optim.chain import OptimFunction as TOpt
    if name == "template":
        return (OptimFunction([Projection(), Extrinsic3D(),
                               TemplatePoints()]),
                TOpt([tb.Projection(), tb.Extrinsic3D(),
                      tb.TemplatePoints()]))
    if name == "freepoint":
        return (OptimFunction([Projection(), Extrinsic3D(), FreePoint()]),
                TOpt([tb.Projection(), tb.Extrinsic3D(), tb.FreePoint()]))
    return (OptimFunction([Projection(), Extrinsic3D(), RigidTform3d(),
                           FreePoint()]),
            TOpt([tb.Projection(), tb.Extrinsic3D(), tb.RigidTform3d(),
                  tb.FreePoint()]))


def _neq_pair(name, n_cams, n_ims, uv, mask, tpl, x0, cm):
    """Both packages' NormalEq of one chain at the numpy pieces x0 and
    column masks cm."""
    jop, top = _chain(name)
    jneq = js.make_structured_neq(jop, js.chain_widths(jop), n_cams, n_ims)(
        js.ParamPieces(*map(jnp.asarray, x0)), jnp.asarray(uv),
        jnp.asarray(mask), jnp.asarray(tpl),
        js.ParamPieces(*map(jnp.asarray, cm)))
    tneq = ts.make_structured_neq(top, ts.chain_widths(top), n_cams, n_ims)(
        pieces_from_numpy(*x0, "cpu", F64), torch.tensor(uv),
        torch.tensor(mask), torch.tensor(tpl),
        pieces_from_numpy(*cm, "cpu", F64))
    return jneq, tneq


def _template_neqs():
    """``tests/test_structured.py::test_pose_elimination_with_padded_and_
    fixed_poses``' rig: two padded pose slots, pose 0 fixed."""
    rig = make_synthetic_rig(n_cams=4, n_ims=6, grid=5, visibility=0.9,
                             noise_px=0.4, seed=11)
    n_cams, n_keys, n_ims = 4, rig["n_keys"], rig["n_ims"] + 2
    blocks = js.build_block_arrays(rig["dd"], n_cams, n_ims, n_keys,
                                   k_pad_multiple=8)
    k_pad = blocks.uv.shape[1]
    tpl = np.zeros((k_pad, 3))
    tpl[:n_keys] = rig["template"]
    im = np.concatenate([rig["poses"], np.tile(rig["poses"][:1], (2, 1))])
    cm_im = np.ones((n_ims, 6))
    cm_im[0] = 0.0
    cm_im[rig["n_ims"]:] = 0.0
    x0 = (np.concatenate([rig["intr"], rig["extr"]], axis=1), im,
          np.zeros((k_pad, 0)))
    cm = (np.ones((n_cams, 15)), cm_im, np.ones((k_pad, 0)))
    return _neq_pair("template", n_cams, n_ims, blocks.uv, blocks.mask, tpl,
                     x0, cm)


def _selfcal_neqs():
    """``tests/test_structured.py::test_cg_reduced_solver_matches_dense``'
    rig: pose 0 fixed, pad keys frozen."""
    rig = make_synthetic_rig(n_cams=3, n_ims=6, grid=4, visibility=0.85,
                             noise_px=0.4, seed=8)
    n_cams, n_ims, n_keys = 3, 6, rig["n_keys"]
    blocks = js.build_block_arrays(rig["dd"], n_cams, n_ims, n_keys,
                                   k_pad_multiple=8)
    k_pad = blocks.uv.shape[1]
    key = np.tile(rig["template"][:1], (k_pad, 1))
    key[:n_keys] = rig["template"]
    x0 = (np.concatenate([rig["intr"], rig["extr"]], axis=1), rig["poses"],
          key)
    cm_im = np.ones((n_ims, 6))
    cm_im[0] = 0.0
    cm_key = np.ones((k_pad, 3))
    cm_key[n_keys:] = 0.0
    cm = (np.ones((n_cams, 15)), cm_im, cm_key)
    return _neq_pair("selfcal", n_cams, n_ims, blocks.uv, blocks.mask,
                     np.zeros((k_pad, 3)), x0, cm)


def _freepoint_neqs():
    """``problems.freepoint_problem(3, 8)`` at grid 5 (the wand's gauge:
    lenses and camera 0 fixed, one coordinate pinned, unseen keys frozen),
    the other cameras' extrinsics moved by 1e-3."""
    prob = problems.freepoint_problem(3, 8, "cpu", grid=5, seed=3,
                                      k_pad_multiple=8)
    cam = prob.x0.cam.numpy() + np.random.default_rng(4).normal(
        size=(3, 15)) * np.r_[np.zeros(9), np.full(6, 1e-3)]
    x0 = (cam, prob.x0.im.numpy(), prob.x0.key.numpy())
    cm = tuple(t.numpy() for t in prob.colmask)
    return _neq_pair("freepoint", 3, 8, prob.uv.numpy(), prob.mask.numpy(),
                     prob.tpl.numpy(), x0, cm)


NEQS = {"template": _template_neqs, "selfcal": _selfcal_neqs,
        "freepoint": _freepoint_neqs}


def _damp(jneq, lam=1e-3):
    return [lam * np.maximum(np.asarray(x), 1e-8) for x in js.neq_diag(jneq)]


@pytest.mark.parametrize("a", [14, 15, 24])
def test_normalized_inv_matches_jax_at_camera_widths(a):
    """The camera blocks' preconditioner (the LU branch: inv_ex here)."""
    rng = np.random.default_rng(a)
    m = rng.normal(size=(5, a, a + 4))
    blocks = m @ m.transpose(0, 2, 1) + 0.1 * np.eye(a)
    d = 10.0 ** rng.uniform(-2, 4, size=(5, a))
    blocks = blocks * d[:, :, None] * d[:, None, :]
    ref = np.asarray(js._normalized_inv(jnp.asarray(blocks)))
    got = ts._normalized_inv(torch.tensor(blocks)).numpy()
    assert _rel(got, ref) <= 1e-9


@pytest.mark.parametrize("tol", ["tight", "default"])
@pytest.mark.parametrize("chain", list(NEQS))
def test_cg_schur_step_matches_jax(chain, tol):
    """At cg_tol 1e-12 both packages' steps lie within 1e-9 of each other
    (and 1e-6 of the dense step). At the defaults CG stops at a residual
    of 1e-6, and its iterate there moves with the inputs' last bits: JAX's
    own step moves by up to ~4e-6 of max-abs when gc moves by 1e-15
    relative (the self-cal rig); the port's is held to 1e-9, or to 10x
    that one-ulp sensitivity of JAX's where it is larger."""
    jneq, tneq = NEQS[chain]()
    damp = _damp(jneq)
    jdamp = js.ParamPieces(*map(jnp.asarray, damp))
    kw = TIGHT if tol == "tight" else {}
    jsol = js.schur_solve(jneq, jdamp, method="cg", **kw)
    tsol = ts.schur_solve(tneq, ts.ParamPieces(*map(torch.tensor, damp)),
                          method="cg", **kw)
    bound = [1e-9] * 3
    if tol == "default":
        noise = np.random.default_rng(0).normal(size=jneq.gc.shape)
        moved = js.schur_solve(jneq._replace(gc=jneq.gc * (1 + 1e-15 * noise)),
                               jdamp, method="cg")
        bound = [max(1e-9, 10 * _rel(m, r)) for m, r in zip(moved, jsol)]
    for name, g, r, lim in zip(("cam", "im", "key"), tsol, jsol, bound):
        assert g.shape == r.shape, name
        assert _rel(g.numpy(), r) <= lim, name
    if chain == "freepoint":
        assert tsol.im.shape == (8, 0)
    if tol == "tight":
        dense = ts.schur_solve(tneq, ts.ParamPieces(*map(torch.tensor,
                                                         damp)))
        for name, g, r in zip(("cam", "im", "key"), tsol, dense):
            assert _rel(g.numpy(), r.numpy()) <= 1e-6, name


def test_cg_template_step_keeps_fixed_poses_at_zero():
    """Padded and gauge-fixed pose slots take exact zero steps through CG
    as through the dense elimination."""
    _, tneq = _template_neqs()
    damp = [1e-3 * torch.clamp(x, min=1e-8) for x in ts.neq_diag(tneq)]
    dx = ts.schur_solve(tneq, ts.ParamPieces(*damp), method="cg", **TIGHT)
    assert torch.all(dx.im[0] == 0) and torch.all(dx.im[6:] == 0)


def _spd_system(seed, n_sys=None):
    """A two-leaf SPD operator (dense (n, n) on the flattened leaves) and
    its block-diagonal preconditioner; with n_sys, a batch of them."""
    rng = np.random.default_rng(seed)
    shape = () if n_sys is None else (n_sys,)
    m = rng.normal(size=shape + (20, 26))
    a = m @ np.swapaxes(m, -1, -2) + 0.05 * np.eye(20)
    d = 10.0 ** rng.uniform(-1, 2, size=shape + (20,))
    a = a * d[..., :, None] * d[..., None, :]
    b = (rng.normal(size=shape + (3, 4)), rng.normal(size=shape + (2, 4)))
    return torch.tensor(a), tuple(torch.tensor(x) for x in b)


def _ops(a):
    inv = torch.linalg.inv(a[:12, :12]), torch.linalg.inv(a[12:, 12:])

    def matvec(x):
        y = a @ torch.cat([x[0].reshape(-1), x[1].reshape(-1)])
        return y[:12].reshape(3, 4), y[12:].reshape(2, 4)

    def precond(x):
        return ((inv[0] @ x[0].reshape(-1)).reshape(3, 4),
                (inv[1] @ x[1].reshape(-1)).reshape(2, 4))

    return matvec, precond


def _early_exit_cg(matvec, precond, b, tol, maxiter):
    """JAX's ``_cg_solve`` loop (x0 = 0) as written, exiting on the data."""
    dot = ts._tdot
    atol2 = torch.clamp(tol ** 2 * dot(b, b), min=0.0)
    x = tuple(torch.zeros_like(t) for t in b)
    r = b
    p = z = precond(r)
    gamma = dot(r, z)
    k = 0
    while bool(dot(r, r) > atol2) and k < maxiter:
        ap = matvec(p)
        alpha = gamma / dot(p, ap)
        x = tuple(xl + alpha * pl for xl, pl in zip(x, p))
        r = tuple(rl - alpha * al for rl, al in zip(r, ap))
        z = precond(r)
        gamma_new = dot(r, z)
        beta = gamma_new / gamma
        gamma = gamma_new
        p = tuple(zl + beta * pl for zl, pl in zip(z, p))
        k += 1
    return x, k


@pytest.mark.parametrize("tol,maxiter", [(1e-10, 200), (1e-12, 7)])
def test_masked_cg_loop_equals_early_exit_loop(tol, maxiter):
    """Converging before maxiter (frozen iterations follow) and cut at
    maxiter: the same bits and the same count."""
    a, b = _spd_system(3)
    matvec, precond = _ops(a)
    x, k = ts.pcg(matvec, precond, b, tol, maxiter)
    x_ref, k_ref = _early_exit_cg(matvec, precond, b, tol, maxiter)
    assert int(k) == k_ref
    assert (k_ref < maxiter) == (tol == 1e-10)
    for g, r in zip(x, x_ref):
        assert torch.equal(g, r)


def test_masked_cg_loop_under_vmap_stops_each_system_on_its_own():
    """torch.func.vmap over 3 systems: each gets its own loop's solution
    (to the batched products' rounding) and iteration count, where the
    counts differ."""
    a, b = _spd_system(4, n_sys=3)
    a[1] = a[1] + 50.0 * torch.eye(20, dtype=F64) * a[1].diagonal().max()

    def one(a_r, b0, b1):
        matvec, precond = _ops(a_r)
        return ts.pcg(matvec, precond, (b0, b1), 1e-10, 100)

    x, k = torch.func.vmap(one)(a, *b)
    counts = []
    for r in range(3):
        matvec, precond = _ops(a[r])
        x_ref, k_ref = _early_exit_cg(matvec, precond, (b[0][r], b[1][r]),
                                      1e-10, 100)
        counts.append(k_ref)
        assert int(k[r]) == k_ref
        for g, ref in zip(x, x_ref):
            assert _rel(g[r].numpy(), ref.numpy()) <= 1e-12
    assert len(set(counts)) > 1


def test_auto_reduced_solver_matches_jax():
    cases = 0
    for a, b, c in ((15, 6, 0), (15, 6, 3), (15, 0, 3), (24, 6, 3),
                    (14, 6, 6)):
        for n_cams in (1, 16, 272, 273, 274, 288):
            for n_ims in (0, 1, 100, 641, 642, 643, 680, 720):
                ref = js.auto_reduced_solver(js.GroupWidths(a, b, c),
                                             n_cams, n_ims)
                got = ts.auto_reduced_solver(ts.GroupWidths(a, b, c),
                                             n_cams, n_ims)
                assert got == ref, (a, b, c, n_cams, n_ims)
                cases += 1
    # the rule's edge: 4096 reduced dimensions dense, 4097 CG
    for n_ims, want in ((642, "dense"), (643, "cg")):
        # 16 * 15 + 6 * 642 = 4092; with c = 3 the count is C*a + I*b
        dims = 16 * 15 + 6 * n_ims
        assert (dims > 4096) == (want == "cg")
    w = ts.GroupWidths(16, 6, 3)
    assert ts.auto_reduced_solver(w, 16, 640) == js.auto_reduced_solver(
        js.GroupWidths(16, 6, 3), 16, 640) == "dense"      # 256 + 3840
    w = ts.GroupWidths(1, 1, 3)
    assert ts.auto_reduced_solver(w, 4096, 0) == "dense"
    assert ts.auto_reduced_solver(w, 4097, 0) == "cg"
    assert js.auto_reduced_solver(js.GroupWidths(1, 1, 3), 4096, 0) == "dense"
    assert js.auto_reduced_solver(js.GroupWidths(1, 1, 3), 4097, 0) == "cg"
    assert cases == 240


def _lm_problem(chain):
    """A port problem on the CPU and the same problem's numpy arrays."""
    kw = dict(device="cpu", grid=5, k_pad_multiple=8)
    if chain == "template":
        prob = problems.standard_problem(3, 6, **kw)
    elif chain == "selfcal":
        prob = problems.selfcal_problem(3, 6, **kw)
    else:
        prob = problems.freepoint_problem(3, 5, seed=3, **kw)
    return prob


@pytest.mark.parametrize("chain", ["template", "selfcal", "freepoint"])
def test_structured_lm_with_cg_matches_jax(chain):
    prob = _lm_problem(chain)
    n_cams, n_ims = prob.blocks.n_cams, prob.blocks.n_ims
    jop, _ = _chain("selfcal" if chain == "selfcal" else "template")
    if chain == "freepoint":
        jop = OptimFunction([Projection(), Extrinsic3D(), FreePoint()])
    jraw = js.make_structured_neq(jop, js.chain_widths(jop), n_cams, n_ims)
    npy = [t.numpy() for t in (prob.uv, prob.mask, prob.tpl)]
    cm = js.ParamPieces(*(jnp.asarray(t.numpy()) for t in prob.colmask))

    @jax.jit
    def jsolve(x0):
        return jlm.structured_lm_solve(
            lambda p: jraw(p, *map(jnp.asarray, npy), cm), x0,
            max_nfev=prob.max_nfev, reduced_solver="cg")

    j = jsolve(js.ParamPieces(*(jnp.asarray(t.numpy()) for t in prob.x0)))
    t = tlm.structured_lm_solve(prob.neq_fn(), prob.x0,
                                max_nfev=prob.max_nfev, reduced_solver="cg")
    assert (t.nit, t.nfev, int(t.status)) == (int(j.nit), int(j.nfev),
                                              int(j.status))
    assert int(t.status) in (1, 2, 3)
    assert abs(float(t.cost) - float(j.cost)) <= 1e-9 * float(j.cost)
    for g, r in zip(t.x, j.x):
        assert _rel(g.numpy(), r) <= 1e-8
