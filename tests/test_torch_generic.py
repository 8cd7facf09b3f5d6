"""Port parity: the generic backend, ``make_optimisation_function`` and the
scipy backend against the JAX package (float64, CPU).

Small rigs: 3 cameras x 8 images, grid 6 (``utils/synthetic.py``, 0.3 px
noise), as ``tests/test_uncertainty.py`` builds them, as a template handler
and a self-calibration handler of the JAX package, carried to the port as
numpy; both packages start from the JAX package's PnP seed:

- the detection arrays (flat and grouped) equal; ``make_residual_fn`` and
  ``make_local_jac_fn``, ``make_neq_fn`` and ``make_grouped_neq_fn``
  within 1e-9 of their scale, under the linear, huber and cauchy losses
  with both ``loss_semantics``;
- ``lm_solve`` (and ``lm_solve_masked``, its bits) and
  ``run_bundle_adjustment(backend="generic")`` (the template rig on the
  grouped layout, the self-calibration rig on the flat scatter): the same
  nit, nfev and status, the cost within 1e-9 relative;
- ``make_optimisation_function``: the same CSR structure, its data within
  1e-9;
- ``backend="scipy"`` on a rig with fixed lenses (where scipy's TRF
  converges: with free lenses it stops at ``max_nfev`` on these rigs,
  ``tests/test_scipy_parity.py``, and its lsmr steps amplify rounding):
  the same status and nfev, the cost within 1e-8 relative;
- the new entry points default to the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycamset_tpu.optim import residuals as jr
from pycamset_tpu.optim.driver import (make_optimisation_function as jax_mof,
                                       run_bundle_adjustment as jax_rba)
from pycamset_tpu.optim.lm import lm_solve as jax_lm_solve
from pycamset_tpu_torch.optim import residuals as pr
from pycamset_tpu_torch.optim.driver import (build_solver,
                                             make_optimisation_function,
                                             run_bundle_adjustment)
from pycamset_tpu_torch.optim.lm import lm_solve, lm_solve_masked
from test_torch_fleet_handlers import _port_handler

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)

LOSSES = [("linear", "component"), ("huber", "component"),
          ("huber", "observation"), ("cauchy", "component"),
          ("cauchy", "observation")]


def _jax_handler(chain, seed=3, fixed_lenses=False, options=None):
    from pycamset_tpu.models.camera_set import CameraSet, make_cam_dict
    from pycamset_tpu.models.detections import TargetDetection
    from pycamset_tpu.optim.handlers import (FreePointTarget,
                                             SelfBundleHandler,
                                             TemplateBundleHandler)
    from pycamset_tpu.utils.general_utils import make_4x4h_tform
    from pycamset_tpu.utils.synthetic import make_synthetic_rig

    rig = make_synthetic_rig(n_cams=3, n_ims=8, grid=6, visibility=1.0,
                             noise_px=0.3, seed=seed)
    names = ["a", "b", "c"]
    k_mats = [np.array([[i9[0], 0, i9[1]], [0, i9[2], i9[3]], [0, 0, 1]])
              for i9 in rig["intr"]]
    dists = [i9[4:] for i9 in rig["intr"]]
    cams = CameraSet(camera_dict=make_cam_dict(
        names, [make_4x4h_tform(e[:3], e[3:]) for e in rig["extr"]],
        k_mats, dists, [[1600, 1200]] * 3))
    fixed = ({n: {"int": k, "dst": d} for n, k, d in zip(names, k_mats,
                                                         dists)}
             if fixed_lenses else None)
    cls = TemplateBundleHandler if chain == "template" else SelfBundleHandler
    return cls(cams, FreePointTarget(rig["template"].reshape(1, -1, 3)),
               TargetDetection(cam_names=names, data=rig["dd"]),
               fixed_params=fixed,
               options={"outliers": "n", "verbosity": 0, **(options or {})})


def _pair(chain, **kw):
    """(JAX handler, port handler) of one rig, both at the JAX PnP seed."""
    jh = _jax_handler(chain, **kw)
    ph = _port_handler(jh, chain, options={"verbosity": 0,
                                           **kw.get("options", {})},
                       fixed_params=jh.fixed_params or None)
    x0 = jh.get_initial_params()
    ph.set_initial_params(np.array(x0))
    return jh, ph


@pytest.fixture(scope="module", params=["template", "selfcal"])
def problem(request):
    """Both packages' detection arrays and a full parameter vector (the
    start, moved by a seeded step so that both loss regimes occur)."""
    jh, ph = _pair(request.param)
    js, jd = jh.build_problem()
    ps, pd = ph.build_problem()
    x = jh.get_initial_params()
    full = jh.bundlePrimitive.base_full()
    unfixed = jh.bundlePrimitive.unfixed_full()
    full[unfixed] = x + np.random.default_rng(7).normal(size=x.size) * (
        1e-3 * np.maximum(np.abs(x), 1e-2))
    return dict(chain=request.param, jh=jh, ph=ph, jd=jd, pd=pd, js=js,
                ps=ps, full=full)


def _close(got, ref, tol=1e-9):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * max(np.abs(ref).max(), 1e-300)


def _jax_args(det):
    return det.as_device(jnp.float64)


def _port_args(det):
    return det.as_device("cpu", torch.float64)


def test_the_same_detection_arrays(problem):
    jd, pd = problem["jd"], problem["pd"]
    for name in ("cols", "template", "uv", "mask"):
        assert np.array_equal(getattr(jd, name), getattr(pd, name)), name
    assert jd.n_real == pd.n_real
    assert problem["js"].total == problem["ps"].total
    jg = jr.build_grouped_detection_arrays(problem["jh"].op_fun,
                                           problem["js"], None, None,
                                           precomputed=jd)
    pg = pr.build_grouped_detection_arrays(problem["ph"].op_fun,
                                           problem["ps"], None, None,
                                           precomputed=pd)
    # the template rig groups by (camera, image); self-cal rows are unique
    assert (jg is None) == (pg is None) == (problem["chain"] == "selfcal")
    if jg is not None:
        for name in ("u_rows", "template", "uv", "mask"):
            assert np.array_equal(getattr(jg, name), getattr(pg, name))


def test_residuals_and_local_jacobians(problem):
    full = problem["full"]
    jop, pop = problem["jh"].op_fun, problem["ph"].op_fun
    ja, pa = _jax_args(problem["jd"]), _port_args(problem["pd"])
    pfull = torch.as_tensor(full)
    _close(pr.make_residual_fn(pop)(pfull, *pa),
           jr.make_residual_fn(jop)(jnp.asarray(full), *ja))
    _close(pr.make_cost_fn(pop)(pfull, *pa),
           jr.make_cost_fn(jop)(jnp.asarray(full), *ja))
    got = pr.make_local_jac_fn(pop)(pfull, *pa)
    ref = jr.make_local_jac_fn(jop)(jnp.asarray(full), *ja)
    for g, r in zip(got, ref):
        _close(g, r)
    assert torch.isfinite(got[1]).all()


@pytest.mark.parametrize("loss,semantics", LOSSES)
def test_normal_equations(problem, loss, semantics):
    full = problem["full"]
    jop, pop = problem["jh"].op_fun, problem["ph"].op_fun
    kw = dict(loss=loss, f_scale=0.5, loss_semantics=semantics)
    ref = jr.make_neq_fn(jop, **kw)(jnp.asarray(full),
                                    *_jax_args(problem["jd"]))
    got = pr.make_neq_fn(pop, **kw)(torch.as_tensor(full),
                                    *_port_args(problem["pd"]))
    for g, r in zip(got, ref):
        _close(g, r)
    if problem["chain"] == "template":
        jg = jr.build_grouped_detection_arrays(jop, problem["js"], None,
                                               None, precomputed=problem["jd"])
        pg = pr.build_grouped_detection_arrays(pop, problem["ps"], None,
                                               None, precomputed=problem["pd"])
        gref = jr.make_grouped_neq_fn(jop, **kw)(
            jnp.asarray(full), *jg.as_device(jnp.float64))
        ggot = pr.make_grouped_neq_fn(pop, **kw)(
            torch.as_tensor(full), *pg.as_device("cpu", torch.float64))
        for g, r, flat in zip(ggot, gref, ref):
            _close(g, r)
            _close(g, flat)     # both layouts build one system


def test_lm_solve():
    """The LM alone on the template rig's grouped normal equations, over
    its free vector (``lm_solve``, and ``lm_solve_masked`` over the full
    system)."""
    jh, ph = _pair("template")
    js, jd = jh.build_problem()
    ps, pd = ph.build_problem()
    x0 = jh.get_initial_params()
    base = jh.bundlePrimitive.base_full()
    free = np.where(jh.bundlePrimitive.unfixed_full())[0]
    jg = jr.build_grouped_detection_arrays(jh.op_fun, js, None, None,
                                           precomputed=jd)
    pg = pr.build_grouped_detection_arrays(ph.op_fun, ps, None, None,
                                           precomputed=pd)
    jneq, pneq = jr.make_grouped_neq_fn(jh.op_fun), pr.make_grouped_neq_fn(
        ph.op_fun)
    ja, pa = jg.as_device(jnp.float64), pg.as_device("cpu", torch.float64)
    free_t = torch.as_tensor(free)
    base_t = torch.as_tensor(base)

    def jax_neq(x):
        jtj, g, c = jneq(jnp.asarray(base).at[free].set(x), *ja)
        return jtj[free][:, free], g[free], c

    def port_neq(x):
        jtj, g, c = pneq(base_t.index_put((free_t,), x), *pa)
        return jtj[free_t][:, free_t], g[free_t], c

    ref = jax.jit(lambda x: jax_lm_solve(jax_neq, x, max_nfev=40))(
        jnp.asarray(x0))
    got = lm_solve(port_neq, torch.as_tensor(x0), max_nfev=40)
    assert (int(got.nit), int(got.nfev), int(got.status)) == (
        int(ref.nit), int(ref.nfev), int(ref.status))
    assert int(got.status) in (1, 2)
    assert abs(float(got.cost) - float(ref.cost)) <= 1e-9 * float(ref.cost)
    hist = np.asarray(ref.history)
    _close(got.history[:int(got.nit) + 1], hist[:int(ref.nit) + 1])
    # lm_solve_masked over the full system's free rows: port_neq's own
    # gather, so lm_solve's bits (held to the JAX package above)
    masked = lm_solve_masked(lambda full: pneq(full, *pa), base_t, free,
                             torch.as_tensor(x0), max_nfev=40)
    assert (int(masked.nit), int(masked.nfev), int(masked.status)) == (
        int(got.nit), int(got.nfev), int(got.status))
    assert torch.equal(masked.x, got.x) and torch.equal(masked.cost, got.cost)


@pytest.mark.parametrize("chain", ["template", "selfcal"])
def test_generic_backend(chain):
    jh, ph = _pair(chain)
    ref, _ = jax_rba(jh, backend="generic")
    got, cams = run_bundle_adjustment(ph, backend="generic", device="cpu")
    solve_fn, _, _ = build_solver(ph, device="cpu")
    assert solve_fn.layout == ("grouped" if chain == "template"
                               else "scatter")
    assert (got.nit, got.nfev, got.status) == (ref.nit, ref.nfev, ref.status)
    assert got.status in (1, 2)
    assert abs(got.cost - ref.cost) <= 1e-9 * ref.cost
    _close(got.x, ref.x, 1e-7)
    assert cams.calibration_handler is ph


@pytest.mark.parametrize("chain", ["template", "selfcal"])
def test_make_optimisation_function(chain):
    jh, ph = _pair(chain)
    jl, jj, jx0 = jax_mof(jh)
    pl, pj, px0 = make_optimisation_function(ph, device="cpu")
    assert np.array_equal(jx0, px0)
    x = jx0 + np.random.default_rng(2).normal(size=jx0.size) * 1e-4
    _close(pl(x), jl(x))
    a, b = jj(x), pj(x)
    assert a.shape == b.shape
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices, b.indices)
    _close(b.data, a.data)


def test_scipy_backend():
    jh, ph = _pair("template", fixed_lenses=True)
    ref, _ = jax_rba(jh, backend="scipy")
    got, _ = run_bundle_adjustment(ph, backend="scipy", device="cpu")
    assert (got.nfev, got.status) == (ref.nfev, ref.status)
    assert got.status in (1, 2, 3, 4)
    assert abs(got.cost - ref.cost) <= 1e-8 * ref.cost


@pytest.mark.parametrize("entry", ["generic", "scipy",
                                   "make_optimisation_function"])
def test_entry_points_default_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, ph = _pair("template")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        if entry == "make_optimisation_function":
            make_optimisation_function(ph)
        else:
            run_bundle_adjustment(ph, backend=entry)
