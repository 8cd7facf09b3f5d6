"""Port parity: temporal synchronisation (float64, CPU).

``pycamset_tpu_torch.calibration.sync`` against the JAX package's
``calibration/sync.py`` on the rig and target of its own tests
(``tests/test_sync.py::_ring_rig``, ``_grid_target``, ``N_FRAMES = 40``):

- ``utils/synthetic.moving_capture`` with skews and frame-rate ratios
  against that test's ``_moving_capture`` table at the same seed (1e-9 px);
- ``estimate_integer_shifts`` equal, plain and at mixed rates;
- ``calibrate_time_offsets`` with the integer-shift search (offsets only),
  skew and rolling shutter together, a mixed-rate rig and a static target
  (its unobservability warning in both packages): the same nit and
  status, the cost to 1e-9 relative, offsets / skews / readouts and their
  sigmas to 1e-9 of their scale, the same report string; no status read
  in the port's LM loop;
- the refusals: one camera, a capture under 4 frames, a static signal.
"""
import logging

import numpy as np
import pytest
import torch

from pycamset_tpu.calibration import sync as jsync
from pycamset_tpu.models.detections import TargetDetection as JDetection
from pycamset_tpu_torch.calibration import sync as psync
from pycamset_tpu_torch.from_jax import camset_from_jax
from pycamset_tpu_torch.models.abstract_target import FreePointTarget
from pycamset_tpu_torch.models.detections import TargetDetection
from pycamset_tpu_torch.optim import lm
from pycamset_tpu_torch.utils.synthetic import (grid_target, moving_capture,
                                                ring_rig)
from tests.test_sync import N_FRAMES, _grid_target, _moving_capture, _ring_rig

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)

# each case: the capture's clocks and the estimator's options
CASES = {
    "integer_shifts": (dict(offsets=[0.0, 3.4, -2.25], noise=0.2, seed=1),
                       dict(max_shift=6)),
    "skew_rolling_shutter": (
        dict(offsets=[0.0, 0.15, -0.2], skews=[0.0, 3e-3, -2e-3],
             readouts=[0.6, 0.75, 0.5], noise=0.1, seed=5),
        dict(estimate_skew=True, estimate_rolling_shutter=True)),
    "mixed_rate": (dict(offsets=[0.0, 0.2, -3.3], ratios=[1.0, 0.5, 0.5],
                        noise=0.2, seed=7),
                   dict(frame_rates=[30.0, 60.0, 60.0], max_shift=5)),
    "static": (dict(offsets=[0.0, 0.0, 0.0], noise=0.2, seed=3,
                    static=True), {}),
}


@pytest.fixture(scope="module")
def rig():
    cams = _ring_rig()
    _, target = _grid_target()
    return {"cams": cams, "target": target, "pcams": camset_from_jax(cams),
            "ptarget": FreePointTarget(np.asarray(target.point_data))}


def _capture(case):
    gen = {k: (np.asarray(v) if isinstance(v, list) else v)
           for k, v in CASES[case][0].items()}
    rows, _ = moving_capture(ring_rig(), grid_target(), N_FRAMES,
                             gen.pop("offsets"), **gen)
    return rows


def _scale_close(got, ref, tol=1e-9):
    if ref is None:
        assert got is None
        return
    scale = max(float(np.abs(ref).max()), 1e-300)
    assert np.abs(np.asarray(got) - np.asarray(ref)).max() <= tol * scale


@pytest.mark.parametrize("kw", [dict(skews=np.array([0.0, 4e-3, -2.5e-3])),
                                dict(ratios=np.array([1.0, 0.5, 0.5]),
                                     offsets=np.array([0.0, 0.2, -3.3]))])
def test_moving_capture_skews_ratios_vs_jax(rig, kw):
    kw = dict(kw)
    offsets = kw.pop("offsets", np.array([0.0, 0.21, -0.12]))
    det, knots = _moving_capture(rig["cams"], _grid_target()[0], N_FRAMES,
                                 offsets, noise=0.1, seed=2, **kw)
    rows, kn = moving_capture(ring_rig(), grid_target(), N_FRAMES, offsets,
                              noise=0.1, seed=2, **kw)
    np.testing.assert_array_equal(kn, knots)
    assert rows.shape == det.get_data().shape
    np.testing.assert_allclose(rows, det.get_data(), rtol=0, atol=1e-9)


@pytest.mark.parametrize("case", ["integer_shifts", "mixed_rate"])
def test_integer_shifts_match_jax(case):
    rows = _capture(case)
    k = grid_target().shape[0]
    n_ims = int(rows[:, 1].max()) + 1
    uv = np.zeros((3, n_ims, k, 2))
    mask = np.zeros((3, n_ims, k))
    ci, ji, ki = (rows[:, i].astype(int) for i in range(3))
    uv[ci, ji, ki] = rows[:, 3:5]
    mask[ci, ji, ki] = 1.0
    ratios = (None if case == "integer_shifts"
              else np.array([1.0, 0.5, 0.5]))
    ref = jsync.estimate_integer_shifts(uv, mask, 6, ratios=ratios)
    got = psync.estimate_integer_shifts(uv, mask, 6, ratios=ratios)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", list(CASES))
def test_calibrate_time_offsets_matches_jax(rig, case, caplog):
    rows = _capture(case)
    names = rig["cams"].get_names()
    kw = CASES[case][1]
    with caplog.at_level(logging.WARNING):
        ref = jsync.calibrate_time_offsets(
            rig["cams"], JDetection(cam_names=names, data=rows),
            rig["target"], **kw)
    jax_warned = "observable" in caplog.text
    caplog.clear()
    reads = lm.host_reads
    with caplog.at_level(logging.WARNING):
        got = psync.calibrate_time_offsets(
            rig["pcams"], TargetDetection(cam_names=names, data=rows),
            rig["ptarget"], device="cpu", **kw)
    assert lm.host_reads == reads          # no status read in the LM loop
    assert ("observable" in caplog.text) == jax_warned
    assert jax_warned == (case == "static")
    assert (got.info["nit"], got.info["status"]) == (ref.info["nit"],
                                                     ref.info["status"])
    assert abs(got.info["cost"] - ref.info["cost"]) <= 1e-9 * ref.info["cost"]
    for field in ("offsets", "offset_sigma", "skew", "skew_sigma", "readout",
                  "readout_sigma"):
        _scale_close(getattr(got, field), getattr(ref, field))
    assert abs(got.rms - ref.rms) <= 1e-9 * ref.rms
    for key in ("n_knots", "n_detections"):
        assert got.info[key] == ref.info[key]
    np.testing.assert_array_equal(got.info["integer_shifts"],
                                  ref.info["integer_shifts"])
    _scale_close(got.info["trajectory"], ref.info["trajectory"])
    assert (psync.format_sync_report(got, fps=30.0)
            == jsync.format_sync_report(ref, fps=30.0))


def test_refusals_match_jax(rig):
    one = camset_from_jax(_ring_rig(n=1))
    det = TargetDetection(cam_names=one.get_names(),
                          data=np.array([[0, 0, 0, 800.0, 600.0]]))
    with pytest.raises(ValueError, match=">= 2 cameras"):
        psync.calibrate_time_offsets(one, det, rig["ptarget"], device="cpu")
    short = TargetDetection(cam_names=rig["pcams"].get_names(),
                            data=np.array([[0, 2, 0, 800.0, 600.0]]))
    with pytest.raises(ValueError, match=">= 4"):
        psync.calibrate_time_offsets(rig["pcams"], short, rig["ptarget"],
                                     device="cpu")
    jshort = JDetection(cam_names=rig["cams"].get_names(),
                        data=np.array([[0, 2, 0, 800.0, 600.0]]))
    with pytest.raises(ValueError, match=">= 4"):
        jsync.calibrate_time_offsets(rig["cams"], jshort, rig["target"])
    k = grid_target().shape[0]
    uv = np.zeros((3, N_FRAMES, k, 2))
    mask = np.ones((3, N_FRAMES, k))
    for mod in (jsync, psync):
        with pytest.raises(ValueError, match="motion"):
            mod.estimate_integer_shifts(uv, mask, max_shift=4)
