"""Port parity: the wand's extrinsic calibration (float64, CPU).

``pycamset_tpu_torch.calibration.wand`` against the JAX package's
``calibration/wand.py`` on the capture of its own tests
(``tests/test_wand.py``: the 4-camera ring, the 3-marker wand, 60
frames at 0.2 px):

- ``_normalized_obs`` to 1e-12, and the incremental registration on the
  same observations: the extrinsics and points to 1e-12, the same order;
- ``calibrate_extrinsics_from_wand`` from scrambled extrinsics, with and
  without a template: the extrinsics to 1e-9, the report's fields equal
  (floats to 1e-9 relative) — the port's handler table puts every
  detection in image 0, the same normal equations on a smaller grid;
- the disconnected-camera and bad ``seed_pair`` errors: the same type and
  message;
- ``start="rig"`` (no OpenCV) from the truth moved by 1 degree and 2 cm
  a camera: the PnP start's metric extrinsics to 1e-7 m.
"""
import logging

import numpy as np
import pytest
import torch

from pycamset_tpu.calibration import wand as jw
from pycamset_tpu_torch.calibration import wand as pw
from pycamset_tpu_torch.from_jax import camset_from_jax
from pycamset_tpu_torch.utils.general_utils import make_4x4h_tform
from tests.test_wand import WAND, _ring_rig, _wand_capture

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)

FRAMES = 60


@pytest.fixture(scope="module")
def capture():
    truth = _ring_rig()
    return {"truth": truth, "dd": _wand_capture(truth, n_frames=FRAMES,
                                                noise=0.2, seed=1),
            "stale": _ring_rig(scramble=True)}


def _obs(norm, dd, n_cams=4):
    obs = {c: {} for c in range(n_cams)}
    g = dd[:, 1].astype(int) * 3 + dd[:, 2].astype(int)
    for i in range(len(dd)):
        obs[int(dd[i, 0])][int(g[i])] = norm[i]
    return obs


def test_registration_matches_jax(capture):
    dd = capture["dd"]
    ref_norm = jw._normalized_obs(capture["truth"], dd)
    norm = pw._normalized_obs(camset_from_jax(capture["truth"]), dd,
                              device="cpu")
    np.testing.assert_allclose(norm, ref_norm, rtol=0, atol=1e-12)
    obs = _obs(ref_norm, dd)
    r_exts, r_pts, r_order = jw.register_cameras_incremental(
        obs, 4, ransac_norm=2.0 / 1400)
    exts, pts, order = pw.register_cameras_incremental(
        obs, 4, ransac_norm=2.0 / 1400)
    assert order == r_order and sorted(pts) == sorted(r_pts)
    for c in r_exts:
        np.testing.assert_allclose(exts[c], r_exts[c], rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.stack([pts[k] for k in sorted(pts)]),
                               np.stack([r_pts[k] for k in sorted(r_pts)]),
                               rtol=0, atol=1e-12)


def _same_report(got, ref):
    assert set(ref) <= set(got)
    for key, r in ref.items():
        g = got[key]
        if key == "cameras":
            for name, rc in r.items():
                assert g[name]["n_detections"] == rc["n_detections"]
                assert abs(g[name]["rms_px"] - rc["rms_px"]) <= (
                    1e-9 * rc["rms_px"])
        elif key == "wand_lengths":
            assert g["n_segments"] == r["n_segments"]
            assert abs(g["relative_spread_rms"] - r["relative_spread_rms"]
                       ) <= 1e-9 * r["relative_spread_rms"] + 1e-15
        elif key == "wand_points":
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-9)
        elif isinstance(r, float):
            assert abs(g - r) <= 1e-9 * abs(r), (key, g, r)
        else:
            assert g == r, (key, g, r)


@pytest.mark.parametrize("template", [True, False])
def test_calibrate_matches_jax(capture, template):
    wand = WAND if template else None
    ref_cams, ref = jw.calibrate_extrinsics_from_wand(
        capture["stale"], capture["dd"], wand_template=wand)
    cams, rep = pw.calibrate_extrinsics_from_wand(
        camset_from_jax(capture["stale"]), capture["dd"],
        wand_template=wand, device="cpu")
    for n in ref_cams.get_names():
        np.testing.assert_allclose(cams[n].extrinsic, ref_cams[n].extrinsic,
                                   rtol=0, atol=1e-9)
    _same_report(rep, ref)
    assert rep["scale_from"] == ("wand_template" if template
                                 else "seed pair baseline")


def test_errors_match_jax(capture):
    truth = capture["truth"]
    skipped = _wand_capture(truth, n_frames=FRAMES, seed=3, skip_cam=3)
    solo = np.concatenate([skipped, [[3.0, 0, 0, 800.0, 600.0]]])
    for kw in ({"wand_template": WAND}, {"seed_pair": (0, 3)}):
        errors = []
        for mod, cams in ((jw, truth), (pw, camset_from_jax(truth))):
            extra = {} if mod is jw else {"device": "cpu"}
            with pytest.raises(Exception) as err:
                mod.calibrate_extrinsics_from_wand(cams, solo, **kw, **extra)
            errors.append((type(err.value), str(err.value)))
        assert errors[0] == errors[1]


def _moved(cams, deg=1.0, shift=0.02, seed=5):
    """The rig with each camera turned by ``deg`` about a random axis and
    shifted ``shift`` m in a random direction."""
    import copy
    rng = np.random.default_rng(seed)
    out = copy.deepcopy(cams)
    for n in out.get_names():
        axis = rng.normal(size=3)
        step = rng.normal(size=3)
        d = make_4x4h_tform(axis / np.linalg.norm(axis) * np.deg2rad(deg),
                            step / np.linalg.norm(step) * shift)
        out[n].set_extrinsic(d @ out[n].extrinsic)
    return out


def test_rig_start_reaches_the_pnp_solution(capture, caplog):
    stored = _moved(camset_from_jax(capture["truth"]))
    pnp, rep_p = pw.calibrate_extrinsics_from_wand(
        stored, capture["dd"], wand_template=WAND, device="cpu")
    own, rep_r = pw.calibrate_extrinsics_from_wand(
        stored, capture["dd"], wand_template=WAND, start="rig",
        device="cpu")
    assert rep_r["registration_order"] == stored.get_names()
    assert rep_r["scale_from"] == "wand_template"
    assert abs(rep_r["rms_px"] - rep_p["rms_px"]) <= 1e-9 * rep_p["rms_px"]
    for n in stored.get_names():
        np.testing.assert_allclose(own[n].extrinsic[:3, 3],
                                   pnp[n].extrinsic[:3, 3], rtol=0,
                                   atol=1e-7)
        np.testing.assert_allclose(own[n].extrinsic[:3, :3],
                                   pnp[n].extrinsic[:3, :3], rtol=0,
                                   atol=1e-7)
    with caplog.at_level(logging.WARNING):
        _, rep = pw.calibrate_extrinsics_from_wand(
            stored, capture["dd"], start="rig", device="cpu")
    assert rep["scale_from"] == "stored rig" and rep["scale_applied"] == 1.0
    assert any("stored rig's scale" in r.message for r in caplog.records)
