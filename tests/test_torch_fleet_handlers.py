"""Port parity: the handler-level fleet, ``run_fleet_bundle_adjustment``.

The JAX package's own fleet rigs (``tests/test_fleet.py``: 3 cameras x 6
images; template grid 4, seeds 5 and 6; self-calibration grid 5, seeds 29
and 31; grouped and mixed two-target rigs grid 4, seeds 11 and 13, 17 and
19) are carried to the port as numpy (``from_jax``) and both packages run
their fleet in float64 on the CPU, each seeded by its own PnP:

- the starts bit for bit; per rig the same nit, nfev and status, the cost
  within 1e-9 relative, x within 1e-8 of its scale and the returned
  cameras within 1e-8 of theirs;
- ragged image counts (4 and 6, padded to the fleet's grid) and per-rig
  fixed patterns (rig 1's camera 0 lens fixed, kept bit for bit), against
  the JAX package's fleet;
- the structural checks (``FleetMismatch``) and every part of the JAX fleet
  the port does not have yet raising, naming its ROADMAP item;
- the vmap rules of Kernels C-F's operators on CPU tensors: one call over
  R rigs equal to R one-rig calls, bit for bit;
- the fleet's step runners (the CUDA graphs of a card) run uncaptured on
  the mixed chain and give the host loop's bits; ``problems.
  fleet_handlers``' template fleet is ``fleet_problem``'s, bit for bit; the
  entry points default to the card.
"""
import numpy as np
import pytest
import torch

from pycamset_tpu.optim.fleet import run_fleet_bundle_adjustment as jax_fleet
from pycamset_tpu_torch import problems
from pycamset_tpu_torch.examples import extend_param_handler as ex
from pycamset_tpu_torch.from_jax import (camset_from_numpy,
                                         detection_from_numpy)
from pycamset_tpu_torch.optim import handlers as ph
from pycamset_tpu_torch.optim.fleet import (FleetMismatch,
                                            build_fleet_problem, fleet_solve,
                                            run_fleet_bundle_adjustment)
from test_fleet import (_grouped_handler, _mixed_handler, _selfcal_handler,
                        _template_handler)
from test_torch_cuda import _mixed_inputs, _rig_batch, _selfcal_inputs

SEEDS = {"template": (5, 6), "selfcal": (29, 31), "grouped": (11, 13),
         "mixed": (17, 19)}


def _jax_handler(chain, seed, **kw):
    if chain == "template":
        return _template_handler(n_cams=3, n_ims=kw.pop("n_ims", 6), grid=4,
                                 seed=seed, **kw)[0]
    if chain == "selfcal":
        return _selfcal_handler(seed=seed, **kw)[0]
    return (_grouped_handler if chain == "grouped" else _mixed_handler)(
        seed=seed)


def _port_handler(jh, chain, options=None, fixed_params=None):
    """The JAX handler's CameraSet, targets and detections, carried over
    as numpy."""
    c = jh.camset
    cams = camset_from_numpy(c.get_names(), [x.extrinsic for x in c],
                             [x.intrinsic for x in c],
                             [x.distortion_coefs for x in c],
                             [x.res for x in c])

    def det(d):
        return detection_from_numpy(d.cam_names, d.get_data(), d.max_ims)

    opts = {"outliers": "n", **(options or {})}
    if chain in ("grouped", "mixed"):
        cls = (ex.TwoTargetCalibrator if chain == "grouped"
               else ex.TwoTargetSelfCalibrator)
        return cls(cams, ph.FreePointTarget(jh.target.point_data),
                   ph.FreePointTarget(jh.extra_target.point_data),
                   det(jh.detection), det(jh.extra_detection), options=opts)
    cls = (ph.TemplateBundleHandler if chain == "template"
           else ph.SelfBundleHandler)
    return cls(cams, ph.FreePointTarget(jh.target.point_data),
               det(jh.detection), options=opts, fixed_params=fixed_params)


def _assert_same_rigs(jax_out, port_out):
    (jr, jc), (pr, pc) = jax_out, port_out
    assert len(jr) == len(pr) == len(jc) == len(pc)
    for j, p in zip(jr, pr):
        assert (p.nit, p.nfev, p.status) == (j.nit, j.nfev, j.status)
        assert abs(p.cost - j.cost) <= 1e-9 * j.cost
        assert p.x.shape == j.x.shape
        assert np.abs(p.x - j.x).max() <= 1e-8 * np.abs(j.x).max()
    for cj, cp in zip(jc, pc):
        for a, b in zip(cj, cp):
            assert a.name == b.name
            for attr in ("intrinsic", "distortion_coefs", "extrinsic"):
                ref = np.asarray(getattr(a, attr), dtype=float)
                got = np.asarray(getattr(b, attr), dtype=float)
                assert np.abs(got - ref).max() <= 1e-8 * max(
                    np.abs(ref).max(), 1e-12)


def _target_gauged(h):
    """A mixed handler of either package with ``problems.target_gauge``'s
    point gauge (7 coordinates on target 0, 6 on target 1; unseen points
    frozen) in place of the example's, which leaves the board's rotations
    free and the LM crawling (ROADMAP Queue C 8: seeds 17 and 19 take 18
    and 99 iterations; with this gauge 11 and 10)."""
    pts3 = np.asarray(h.point_data).reshape(-1, 3)
    gok = np.asarray(h.group_of_key())
    seen = np.unique(h.get_detection_data(flatten=True)[:, 2].astype(int))
    unfixed = np.repeat(np.isin(np.arange(len(pts3)), seen), 3)
    for g, similarity in ((0, True), (1, False)):
        idx = np.where(gok == g)[0]
        unfixed[[3 * idx[0] + j
                 for j in problems.target_gauge(pts3[idx], similarity)]] = False
    h.bundlePrimitive.bdpt_unfixed = unfixed
    return h


@pytest.fixture(scope="module", params=list(SEEDS))
def solved(request):
    """Both packages' fleets of one chain, and their starts (the mixed
    chain's handlers in both packages at ``_target_gauged``'s gauge)."""
    chain = request.param
    jhs = [_jax_handler(chain, s) for s in SEEDS[chain]]
    phs = [_port_handler(jh, chain) for jh in jhs]
    if chain == "mixed":
        jhs = [_target_gauged(h) for h in jhs]
        phs = [_target_gauged(h) for h in phs]
    starts = [(jh.get_initial_params(), h.get_initial_params())
              for jh, h in zip(jhs, phs)]
    return dict(chain=chain, starts=starts, jax=jax_fleet(jhs),
                port=run_fleet_bundle_adjustment(phs, device="cpu"))


def test_the_same_starts(solved):
    for x_jax, x_port in solved["starts"]:
        assert np.array_equal(x_jax, x_port)


def test_the_same_solves_and_cameras(solved):
    _assert_same_rigs(solved["jax"], solved["port"])
    for res in solved["port"][0]:
        assert res.status in (1, 2, 4) and np.isfinite(res.cost)


def test_the_same_residuals(solved):
    for j, p in zip(solved["jax"][0], solved["port"][0]):
        ref = np.asarray(j.fun)
        assert np.abs(p.fun - ref).max() <= 1e-7 * np.abs(ref).max()


def test_ragged_image_counts_match_jax():
    """Rigs of 4 and 6 images share one grid (8): the shorter pads with
    fully-masked images, in both packages alike."""
    spec = [(4, 11), (6, 12)]
    jhs = [_jax_handler("template", s, n_ims=n) for n, s in spec]
    _assert_same_rigs(jax_fleet(jhs), run_fleet_bundle_adjustment(
        [_port_handler(jh, "template") for jh in jhs], device="cpu"))


def test_per_rig_fixed_patterns_match_jax():
    """Rig 1 fixes camera 0's lens: its column masks ride the rig axis,
    and the lens comes back bit for bit."""
    rig = _template_handler(n_cams=3, n_ims=6, grid=4, seed=6)[1]
    i9 = rig["intr"][0]
    fixed = {"cam0": {"int": np.array([[i9[0], 0, i9[1]], [0, i9[2], i9[3]],
                                       [0, 0, 1]]), "dst": i9[4:]}}
    jhs = [_jax_handler("template", 5),
           _jax_handler("template", 6, fixed_params=fixed)]
    phs = [_port_handler(jhs[0], "template"),
           _port_handler(jhs[1], "template", fixed_params=fixed)]
    ref = jax_fleet(jhs)
    got = run_fleet_bundle_adjustment(phs, device="cpu")
    _assert_same_rigs(ref, got)
    assert got[0][1].x.shape[0] == got[0][0].x.shape[0] - 9
    cam = got[1][1]["cam0"]
    got_i9 = np.concatenate([cam.intrinsic[[0, 0, 1, 1], [0, 2, 1, 2]],
                             np.ravel(cam.distortion_coefs)])
    assert np.array_equal(got_i9, i9)


@pytest.mark.parametrize("what,match", [
    ("keys", "keys"), ("cameras", "cameras"), ("chain", "chain"),
    ("options", "options"), ("empty", "empty")])
def test_structural_mismatch_raises(what, match):
    h0 = _port_handler(_jax_handler("template", 5), "template")
    other = {
        "keys": lambda: _port_handler(_template_handler(
            n_cams=3, n_ims=6, grid=5, seed=6)[0], "template"),
        "cameras": lambda: _port_handler(_template_handler(
            n_cams=2, n_ims=6, grid=4, seed=6)[0], "template"),
        "chain": lambda: _port_handler(_jax_handler("selfcal", 29),
                                       "selfcal"),
        "options": lambda: _port_handler(_jax_handler("template", 6),
                                         "template", {"loss": "huber"}),
    }
    fleet = [] if what == "empty" else [h0, other[what]()]
    with pytest.raises(FleetMismatch, match=match):
        build_fleet_problem(fleet, device="cpu")


def test_different_targets_of_one_size_raise():
    jhs = [_jax_handler("template", 5), _jax_handler("template", 6)]
    phs = [_port_handler(jh, "template") for jh in jhs]
    phs[1].point_data = phs[1].point_data + 1e-3
    with pytest.raises(FleetMismatch, match="one calibration target"):
        build_fleet_problem(phs, device="cpu")


@pytest.mark.parametrize("what,item", [("mesh", "Queue A item 11")])
def test_unported_fleet_paths_raise(what, item):
    # the CG reduced solver and the free-point chain's fleet are served
    # (tests/test_torch_cg_handlers.py, tests/test_torch_fleet_freepoint.py)
    phs = [_port_handler(_jax_handler("template", s), "template")
           for s in SEEDS["template"]]
    with pytest.raises(NotImplementedError, match=item):
        run_fleet_bundle_adjustment(phs, device="cpu", mesh=object())


@pytest.mark.parametrize("kernel", ["C", "D", "E9", "E6", "F9", "F6"])
def test_vmap_rules_equal_per_rig_calls(kernel):
    """Each operator under torch.func.vmap over 3 rigs (CPU tensors: the
    plain twin rig by rig) gives every rig the bits of its own call, and
    a key mask may come without a rig axis (every rig's). The rigs and
    their inputs are the card test's (``test_torch_cuda``), on the CPU."""
    from pycamset_tpu_torch.optim import cuda_mixed_grams as mg
    from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
    cpu, n_cams, n_ims = torch.device("cpu"), 2, 4
    kw = dict(loss="huber", f_scale=2.0, loss_semantics="observation")
    if kernel in ("C", "D"):
        f = _selfcal_inputs(cpu, n_cams, n_ims, 5)
        if kernel == "C":
            f, key_at = (*f[:5], *f[6:]), (2, 6)
            wrapper, extra = sg.selfcal_gram_fused, (n_cams, n_ims)
        else:
            wrapper, extra, key_at = sg.selfcal_gram, (), (2, 7)
    else:
        kw["with_key_cols"] = kernel[1] == "9"
        f = _mixed_inputs(cpu, n_cams, n_ims, 5, kw["with_key_cols"])
        wrapper = mg.mixed_gram_fused if kernel[0] == "E" else mg.mixed_gram
        extra = (n_cams, n_ims) if kernel[0] == "E" else ()
        key_at = (2, 8)
    rigs = _rig_batch(f, 3, key_at)

    def one(*x):
        return wrapper(*x, *extra, **kw)

    got = torch.func.vmap(one)(*rigs)
    for r in range(3):
        for g, a in zip(got, one(*(x[r] for x in rigs))):
            assert torch.equal(g[r], a)
    # the key mask without a rig axis: every rig's
    dims = [0] * len(rigs)
    dims[key_at[1]] = None
    shared = list(rigs)
    shared[key_at[1]] = f[key_at[1]]
    got = torch.func.vmap(one, in_dims=tuple(dims))(*shared)
    for r in range(3):
        rig = [x[r] for x in rigs]
        rig[key_at[1]] = f[key_at[1]]
        for g, a in zip(got, one(*rig)):
            assert torch.equal(g[r], a)


def test_mixed_fleet_step_runners_give_the_host_loops_bits():
    """The mixed fleet through its step runners (FleetGraph, one per cohort
    size; on the CPU their bodies run uncaptured) and through the host
    loop: the same bits."""
    prob = build_fleet_problem(problems.fleet_handlers("mixed", 3, 2, 6,
                                                       grid=5),
                               device="cpu")
    ref = prob.solve_batch(graph=False)
    runners = {}
    got = fleet_solve(prob.neq_fn(), prob.x0_pieces, prob.data(),
                      max_nfev=prob.max_nfev, ops=prob.ops, graph=runners)
    assert sorted(runners) == [1, 3]
    assert (got.nit, got.nfev) == (ref.nit, ref.nfev)
    for a, b in zip([*got.x, got.cost, got.status, got.history],
                    [*ref.x, ref.cost, ref.status, ref.history]):
        assert torch.equal(a, b)
    assert all(s in (1, 2) for s in ref.status.tolist())


@pytest.mark.parametrize("chain", ["selfcal", "grouped", "mixed"])
def test_fleet_handlers_converge(chain):
    """``problems.fleet_handlers``' self-calibration, grouped and mixed
    fleets (3 rigs of 3 x 8, grid 5) solve to status 1 or 2 at the noise
    (0.3 px)."""
    prob = build_fleet_problem(problems.fleet_handlers(chain, 3, 3, 8,
                                                       grid=5),
                               device="cpu")
    _, res = prob.solve()
    assert all(s in (1, 2) for s in res.status.tolist())
    assert float(prob.rms_px(res.cost).max()) <= 0.36


def test_template_fleet_handlers_are_fleet_problems_rigs():
    prob = build_fleet_problem(problems.fleet_handlers("template", 3, 3, 8,
                                                       grid=5),
                               device="cpu")
    _, res = prob.solve()
    ref = problems.fleet_problem(3, 3, 8, "cpu", grid=5).solve()
    assert (res.nit, res.nfev) == (ref.nit, ref.nfev)
    assert torch.equal(res.cost, ref.cost)
    for a, b in zip(res.x[:2], ref.x[:2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("entry", ["build", "run"])
def test_fleet_entry_points_default_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    hs = problems.fleet_handlers("template", 2, 2, 4, grid=4)
    fn = build_fleet_problem if entry == "build" else \
        run_fleet_bundle_adjustment
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        fn(hs)
