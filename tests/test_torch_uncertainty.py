"""Port parity: calibration uncertainty against the JAX package (float64,
CPU).

The rigs of ``tests/test_torch_generic.py`` (3 cameras x 8 images, grid 6)
are solved by the port's structured backend; both packages' handlers then
give their ``calibration_uncertainty`` at that solution, and every camera,
pose, point and extra sigma agrees within 1e-6 relative, with the same
dof and sigma2 within 1e-12 (the residuals agree to rounding, not to the
bit):

- the dense route (template; self-calibration with point sigmas) and
  ``parameter_covariance``;
- the sparse routes, reached by lowering ``DENSE_COV_MAX_PARAMS`` in both
  packages as ``tests/test_uncertainty.py`` does: the Schur selected
  inverse (self-calibration, points solved) and the batched LU head-only
  route (template);
- the tied route (one lens; two groups), the two-target handlers'
  ``extra_sigma`` (grouped; mixed with points), and robust-loss weights
  (huber and cauchy, both semantics);
- a rolling-shutter (aux-input) chain raises as in the JAX package; a
  ``.camset`` written by the JAX package gives the port the JAX package's
  sigmas, and one written and loaded by the port its in-memory ones;
- the entry points default to the card.
"""
import functools

import numpy as np
import pytest
import torch

from pycamset_tpu.optim import uncertainty as JU
from pycamset_tpu_torch.optim import uncertainty as PU
from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
from pycamset_tpu_torch.utils.saving import load_CameraSet
from test_fleet import _grouped_handler, _mixed_handler, _tied_handler
from test_torch_fleet_handlers import _port_handler
from test_torch_generic import _pair

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)

ROBUST = [("huber", "component"), ("huber", "observation"),
          ("cauchy", "component"), ("cauchy", "observation")]


def _jax_camset(jh, x, fun):
    cams = jh.get_camset(x)
    cams.set_calibration_history({"x": x, "fun": fun}, jh)
    return cams


def _solved(jh, ph):
    """The port's structured solve of ``ph`` from the JAX handler's start;
    both packages' CameraSets at its solution."""
    ph.set_initial_params(np.array(jh.get_initial_params()))
    res, cams = run_bundle_adjustment(ph, device="cpu")
    return res.x, _jax_camset(jh, res.x, res.fun), cams


@functools.lru_cache
def _solved_rig(chain):
    jh, ph = _pair(chain)
    x, jc, pc = _solved(jh, ph)
    return dict(chain=chain, jh=jh, ph=ph, x=x, jc=jc, pc=pc)


@pytest.fixture(scope="module", params=["template", "selfcal"])
def solved(request):
    return _solved_rig(request.param)


def _same_sigmas(got, ref, rtol=1e-6):
    assert got.keys() == ref.keys()
    assert got["dof"] == ref["dof"]
    assert abs(got["sigma2"] - ref["sigma2"]) <= 1e-12 * ref["sigma2"]
    pairs = [(got[k], ref[k]) for k in ("pose_sigma", "point_sigma",
                                         "extra_sigma") if k in ref]
    for name, cam in ref["cameras"].items():
        pairs += [(got["cameras"][name][f], cam[f])
                  for f in ("int_sigma", "ext_sigma")]
    for g, r in pairs:
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape
        assert np.array_equal(g == 0.0, r == 0.0)   # fixed entries
        assert np.all(np.abs(g - r) <= rtol * np.abs(r))


def test_dense_route(solved):
    ref = JU.calibration_uncertainty(solved["jc"], x=solved["x"])
    got = PU.calibration_uncertainty(solved["pc"], x=solved["x"],
                                     device="cpu")
    _same_sigmas(got, ref)
    assert ("point_sigma" in got) == (solved["chain"] == "selfcal")
    # the default x is the CameraSet's own solution
    _same_sigmas(solved["pc"].calibration_uncertainty(device="cpu"), got,
                 1e-12)


def test_parameter_covariance(solved):
    ref = JU.parameter_covariance(solved["jh"], solved["x"])
    got = PU.parameter_covariance(solved["ph"], solved["x"], device="cpu")
    cov_r, cov_g = ref[0], got[0]
    scale = np.sqrt(np.outer(np.diag(cov_r), np.diag(cov_r)))
    assert np.all(np.abs(cov_g - cov_r) <= 1e-6 * scale)
    assert np.all(np.abs(got[1] - ref[1]) <= 1e-6 * ref[1])
    assert got[3] == ref[3]
    assert abs(got[2] - ref[2]) <= 1e-12 * ref[2]


def test_sparse_routes(solved, monkeypatch):
    """Self-calibration: the Schur route, points solved; template: no
    point tail, the LU head-only route."""
    monkeypatch.setattr(JU, "DENSE_COV_MAX_PARAMS", 1)
    monkeypatch.setattr(PU, "DENSE_COV_MAX_PARAMS", 1)
    ref = JU.calibration_uncertainty(solved["jc"], x=solved["x"])
    got = PU.calibration_uncertainty(solved["pc"], x=solved["x"],
                                     device="cpu")
    assert ("point_sigma" in got) == (solved["chain"] == "selfcal")
    _same_sigmas(got, ref)


@pytest.mark.parametrize("groups", [True, [0, 1, 0]])
def test_tied_route(groups):
    jh, _ = _tied_handler(shared_opt=groups)
    ph = _port_handler(jh, "template",
                       options={"shared_intrinsics": groups})
    x, jc, pc = _solved(jh, ph)
    got = PU.calibration_uncertainty(pc, x=x, device="cpu")
    _same_sigmas(got, JU.calibration_uncertainty(jc, x=x))
    # every camera of a lens group reports the group's sigmas
    gid = np.zeros(3, dtype=int) if groups is True else np.array(groups)
    cams = list(got["cameras"].values())
    for a in range(3):
        for b in range(3):
            if gid[a] == gid[b]:
                assert np.array_equal(cams[a]["int_sigma"],
                                      cams[b]["int_sigma"])


@pytest.mark.parametrize("chain", ["grouped", "mixed"])
def test_two_target_extra_sigma(chain):
    make = _grouped_handler if chain == "grouped" else _mixed_handler
    jh = make()
    ph = _port_handler(jh, chain)
    ph.set_initial_params(np.array(jh.get_initial_params()))
    x, jc, pc = _solved(jh, ph)
    got = PU.calibration_uncertainty(pc, x=x, device="cpu")
    assert got["extra_sigma"].shape == (6 * ph.n_groups(),)
    assert ("point_sigma" in got) == (chain == "mixed")
    _same_sigmas(got, JU.calibration_uncertainty(jc, x=x))


@pytest.mark.parametrize("loss,semantics", ROBUST)
def test_robust_loss_weights(loss, semantics):
    """On the template rig, at its linear solution."""
    solved = _solved_rig("template")
    opts = {"loss": loss, "f_scale": 0.5, "loss_semantics": semantics}
    jh, ph = _pair("template", options=opts)
    x = solved["x"]
    ref = JU.calibration_uncertainty(_jax_camset(jh, x, None), x=x)
    cams = ph.get_camset(x)
    cams.set_calibration_history({"x": x, "fun": None}, ph)
    got = PU.calibration_uncertainty(cams, x=x, device="cpu")
    _same_sigmas(got, ref)
    plain = PU.calibration_uncertainty(solved["pc"], x=x, device="cpu")
    assert got["sigma2"] != plain["sigma2"]


def test_rolling_shutter_chain_raises():
    """The port's real rolling-shutter handler (its chain reads an aux
    channel): the uncertainty refuses it as the JAX package's refuses its
    own, and the generic backend as the JAX package's does."""
    from pycamset_tpu.optim.handlers import RSTemplateBundleHandler
    from test_torch_rolling_shutter import _capture, _pair

    cams, tpl, dd, _p, _v = _capture(4, 0.1, 2)
    jrs, prs = _pair(cams, tpl, dd)
    assert isinstance(jrs, RSTemplateBundleHandler)
    x = prs.get_initial_params()
    cams = prs.get_camset(x)
    cams.set_calibration_history({"x": x, "fun": None}, prs)
    jcams = jrs.get_camset(jrs.get_initial_params())
    jcams.set_calibration_history({"x": None, "fun": None}, jrs)
    with pytest.raises(NotImplementedError) as ref:
        JU.calibration_uncertainty(jcams, x=np.zeros(3))
    with pytest.raises(NotImplementedError) as got:
        PU.calibration_uncertainty(cams, device="cpu")
    assert str(got.value) == str(ref.value)
    # the generic and scipy backends refuse such a chain as JAX's do
    with pytest.raises(ValueError, match="aux inputs"):
        run_bundle_adjustment(prs, backend="generic", device="cpu")


def test_jax_saved_camset(solved, tmp_path):
    path = tmp_path / "jax.camset"
    solved["jc"].save(path)
    back = load_CameraSet(path)
    assert back.calibration_handler is not None
    got = PU.calibration_uncertainty(back, device="cpu")
    _same_sigmas(got, JU.calibration_uncertainty(solved["jc"],
                                                 x=solved["x"]))


def test_loaded_camset_gives_the_in_memory_result(solved, tmp_path):
    path = tmp_path / "port.camset"
    solved["pc"].save(path)
    back = load_CameraSet(path)
    assert back.calibration_handler.initial_params is None
    _same_sigmas(back.calibration_uncertainty(device="cpu"),
                 solved["pc"].calibration_uncertainty(device="cpu"), 1e-12)


@pytest.mark.parametrize("entry", ["function", "method",
                                   "parameter_covariance"])
def test_entry_points_default_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    solved = _solved_rig("template")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        if entry == "function":
            PU.calibration_uncertainty(solved["pc"])
        elif entry == "method":
            solved["pc"].calibration_uncertainty()
        else:
            PU.parameter_covariance(solved["ph"], solved["x"])
