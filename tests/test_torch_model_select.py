"""Port parity: camera-model selection (float64, CPU).

``pycamset_tpu_torch.calibration.model_select`` against the JAX package's
``calibration/model_select.py``:

- ``subset_ims``, ``split_detection_images`` (the same images for the same
  seed), ``pick_model`` and ``pick_model_per_camera`` on the tables of
  ``tests/test_model_select.py``, parametrised;
- ``select_camera_model`` on ``_rig_cams_det``'s rig (3 cameras, 10
  images, standard data at 0.05 px) with ("standard", "rational") at
  ``max_nfev`` 10, jointly, from the PnP start: the same pick, every
  score within 1e-9 relative (per camera:
  ``test_torch_model_select_per_camera.py``);
- ``start="rig"``: a finite pick with no OpenCV;
- ``initial_cams=None`` raises ``NotImplementedError`` naming item 3.
"""
import numpy as np
import pytest
import torch

from pycamset_tpu.calibration import model_select as jms
from pycamset_tpu_torch.calibration import model_select as pms
from pycamset_tpu_torch.from_jax import camset_from_jax, detection_from_jax
from pycamset_tpu_torch.models.abstract_target import FreePointTarget
from pycamset_tpu_torch.models.detections import TargetDetection
from tests.test_model_select import _rig_cams_det, _table

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)

OPTS = {"max_nfev": 10}


def _both(n_cams=2, n_ims=6, n_keys=4):
    jdet = _table(n_cams, n_ims, n_keys)
    return jdet, TargetDetection(cam_names=jdet.cam_names,
                                 data=jdet.get_data())


def _same_det(got, ref):
    assert got.max_ims == ref.max_ims
    assert list(got.cam_names) == list(ref.cam_names)
    np.testing.assert_array_equal(got.get_data(), ref.get_data())


@pytest.mark.parametrize("ids", [[1, 4, 5], [0], [5, 0, 3, 3]])
def test_subset_ims_matches_jax(ids):
    jdet, pdet = _both()
    _same_det(pms.subset_ims(pdet, ids), jms.subset_ims(jdet, ids))


@pytest.mark.parametrize("n_ims,frac,seed,min_train", [
    (8, 0.25, 3, 4), (5, 0.9, 0, 4), (12, 0.25, 0, 4), (20, 0.4, 7, 4)])
def test_split_matches_jax(n_ims, frac, seed, min_train):
    jdet, pdet = _both(n_ims=n_ims)
    ref = jms.split_detection_images(jdet, holdout_fraction=frac, seed=seed,
                                     min_train=min_train)
    got = pms.split_detection_images(pdet, holdout_fraction=frac, seed=seed,
                                     min_train=min_train)
    for g, r in zip(got, ref):
        _same_det(g, r)


def test_split_refusal_matches_jax():
    jdet, pdet = _both(n_ims=4)
    for mod, det in ((jms, jdet), (pms, pdet)):
        with pytest.raises(ValueError, match="images"):
            mod.split_detection_images(det, min_train=4, min_holdout=1)


PICKS = [
    ([("standard", 9, 0.30, 0.50), ("rational", 12, 0.10, 0.12)], 0.02),
    ([("rational", 12, 0.09, 0.1000), ("standard", 9, 0.11, 0.1015)], 0.02),
    ([("rational", 12, 0.09, 0.1000), ("standard", 9, 0.11, 0.1015)], 1e-4),
    ([("rational", 12, 0.1, float("nan")), ("standard", 9, 0.3, 0.50)],
     0.02),
    ([("standard", 9, 0.3, 0.50), ("rational", 12, 0.1, float("nan"))],
     0.02),
    ([("tilted", 18, 0.1, 0.2), ("thin_prism", 16, 0.1, 0.203),
      ("rational", 12, 0.1, 0.25)], 0.02),
]


@pytest.mark.parametrize("rows,tol", PICKS)
def test_pick_model_matches_jax(rows, tol):
    ref = jms.pick_model([jms.ModelScore(*r, 100, 20) for r in rows],
                         parsimony_tol=tol)
    got = pms.pick_model([pms.ModelScore(*r, 100, 20) for r in rows],
                         parsimony_tol=tol)
    assert tuple(got) == tuple(ref)


def test_pick_model_refusals_match_jax():
    nan = [("rational", 12, 0.1, float("nan"))]
    for mod in (jms, pms):
        with pytest.raises(ValueError):
            mod.pick_model([])
        with pytest.raises(ValueError, match="finite"):
            mod.pick_model([mod.ModelScore(*nan[0], 100, 20)])


PER_CAM = [
    {"standard": {"a": 0.10, "b": 0.20}, "rational": {"a": 0.05,
                                                      "b": 0.199}},
    {"standard": {"a": 0.10, "b": 0.20}, "rational": {"a": 0.0995,
                                                      "b": 0.1999}},
    {"standard": {"a": np.nan, "b": 0.20}, "fisheye": {"a": 0.3,
                                                       "b": 0.5}},
    {"standard": {"a": 0.4}, "thin_prism": {"a": 0.1, "b": 0.1},
     "tilted": {"a": 0.0999, "b": 0.05}},
]


@pytest.mark.parametrize("table", PER_CAM)
def test_pick_model_per_camera_matches_jax(table):
    ref = jms.pick_model_per_camera(table, ["a", "b"])
    got = pms.pick_model_per_camera(table, ["a", "b"])
    assert got == ref
    with pytest.raises(ValueError, match="finite"):
        pms.pick_model_per_camera({"standard": {"a": np.nan}}, ["a"])


@pytest.fixture(scope="module")
def rig():
    cams, target, det, _ = _rig_cams_det("standard", seed=22, n_ims=10)
    return {"cams": cams, "target": target, "det": det,
            "pcams": camset_from_jax(cams), "pdet": detection_from_jax(det),
            "ptarget": FreePointTarget(np.asarray(target.point_data))}


def _same_scores(got, ref):
    assert [s.model for s in got] == [s.model for s in ref]
    for g, r in zip(got, ref):
        assert (g.n_intr, g.n_train_dets, g.n_holdout_dets) == (
            r.n_intr, r.n_train_dets, r.n_holdout_dets)
        for f in ("train_rms", "holdout_rms"):
            a, b = getattr(g, f), getattr(r, f)
            assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= 1e-9 * b


def select_matches_jax(rig, per_camera):
    """The JAX package's pick and scores and the port's (float64, CPU)."""
    kw = dict(candidates=("standard", "rational"), problem_options=OPTS,
              per_camera=per_camera)
    ref_pick, ref = jms.select_camera_model(
        rig["det"], rig["target"], initial_cams=rig["cams"], **kw)
    got_pick, got = pms.select_camera_model(
        rig["pdet"], rig["ptarget"], initial_cams=rig["pcams"],
        device="cpu", **kw)
    assert got_pick == ref_pick
    _same_scores(got, ref)


def test_select_matches_jax(rig):
    select_matches_jax(rig, per_camera=False)


def test_rig_start_and_refusals(rig):
    pick, scores = pms.select_camera_model(
        rig["pdet"], rig["ptarget"], initial_cams=rig["pcams"],
        candidates=("standard", "rational"), problem_options=OPTS,
        start="rig", device="cpu")
    assert pick in ("standard", "rational")
    assert all(np.isfinite(s.holdout_rms) and s.holdout_rms < 0.2
               for s in scores), scores
    with pytest.raises(NotImplementedError, match="item 3"):
        pms.select_camera_model(rig["pdet"], rig["ptarget"],
                                cam_res=[[1600, 1200]] * 3, device="cpu")
    with pytest.raises(ValueError, match="unknown camera model"):
        pms.select_camera_model(rig["pdet"], rig["ptarget"],
                                initial_cams=rig["pcams"],
                                candidates=("standard", "nosuch"),
                                device="cpu")
