"""Port parity: tracker artifacts (``pycamset_tpu_torch/serving.py``, CPU).

One artifact, exported from the port's tracker on the rig of the JAX
package's serving tests (``tests/test_tracking.py::_rig``, 12 frames) and
loaded back, held to the live port tracker at the JAX tests' tolerances
(``tests/test_serving.py:26-38``: poses 1e-9, rms 1e-12, pose_sigma 1e-6
relative): the 12-frame table and a 5-frame one through the one export
(its frame axis is symbolic), the stream round trip with an explicit and
a device-seeded start, the skip of a non-stereo first frame, no calibration
stack on the loaded side, and the refusals: a file that is not an artifact,
and an artifact for ``"cuda"`` loaded where only the CPU serves.
"""
import io
import json
import zipfile

import numpy as np
import pytest
import torch

from pycamset_tpu_torch.from_jax import camset_from_jax, detection_from_jax
from pycamset_tpu_torch.models.detections import TargetDetection
from pycamset_tpu_torch.optim.handlers import FreePointTarget
from pycamset_tpu_torch.serving import (ServingTracker, export_tracker,
                                        load_tracker_artifact)
from pycamset_tpu_torch.tracking import TargetTracker
from tests.test_tracking import _rig

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    cams, target, det, true, _ = _rig(n_ims=12)
    tracker = TargetTracker(camset_from_jax(cams),
                            FreePointTarget(np.asarray(target.point_data)),
                            device="cpu")
    path = export_tracker(tracker,
                          tmp_path_factory.mktemp("srv") / "rig.trkz")
    return tracker, detection_from_jax(det), true, path, \
        load_tracker_artifact(path)


def _held(got, want):
    (poses, info), (ref, ref_info) = got, want
    np.testing.assert_allclose(poses, ref, rtol=0, atol=1e-9)
    np.testing.assert_allclose(info["rms"], ref_info["rms"], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(info["pose_sigma"], ref_info["pose_sigma"],
                               rtol=1e-6)


def test_batch_roundtrip_matches_live_tracker(artifact):
    tracker, det, true, _, st = artifact
    want = tracker.track_batch(det, seed_mode="device")
    got = st.track_batch(det)
    _held(got, want)
    np.testing.assert_array_equal(got[1]["nit"], want[1]["nit"])
    np.testing.assert_allclose(got[0], true, atol=2e-2)


def test_symbolic_frame_axis_serves_other_counts(artifact):
    tracker, det, true, _, st = artifact
    rows = det.get_data()
    small = TargetDetection(cam_names=det.cam_names,
                            data=rows[rows[:, 1] < 5], max_ims=5)
    got = st.track_batch(small)
    assert got[0].shape == (5, 4, 4)
    _held(got, tracker.track_batch(small, seed_mode="device"))
    np.testing.assert_allclose(got[0], true[:5], atol=2e-2)


def test_stream_roundtrip(artifact):
    tracker, det, true, _, st = artifact
    _held(st.track_stream(det, init=true[0]),
          tracker.track_stream(det, init=true[0]))
    # the default start: the device seed of the first seedable frame
    poses, _ = st.track_stream(det)
    np.testing.assert_allclose(poses, true, atol=2e-2)


def test_stream_seed_skips_non_stereo_frames(artifact):
    """Frame 0 seen by two cameras with disjoint keys cannot be seeded:
    the default start comes from a later stereo frame."""
    _, det, true, _, st = artifact
    rows = det.get_data()
    f0 = rows[:, 1] == 0
    keep = ~f0 | ((rows[:, 0] == 0) & (rows[:, 2] < 6)) \
        | ((rows[:, 0] == 1) & (rows[:, 2] >= 6) & (rows[:, 2] < 12))
    det2 = TargetDetection(cam_names=det.cam_names, data=rows[keep],
                           max_ims=int(det.max_ims))
    poses, _ = st.track_stream(det2)
    np.testing.assert_allclose(poses[1:], true[1:], atol=2e-2)


def test_artifact_needs_no_calibration_stack(artifact):
    tracker, _, _, path, st = artifact
    assert isinstance(st, ServingTracker)
    assert not hasattr(st, "camset") and not hasattr(st, "core")
    assert st.meta["cam_names"] == ["a", "b", "c"]
    assert st.meta["format"] == "pycamset_tpu_torch.tracker_artifact.v1"
    assert (st.meta["platform"], st.meta["dtype"]) == ("cpu", "float64")
    assert st.max_detections == tracker.max_detections
    with zipfile.ZipFile(path) as z:
        assert sorted(z.namelist()) == ["meta.json", "solve_batch.pt2",
                                        "solve_stream.pt2", "template.npy"]


def test_bad_file_and_wrong_platform_raise(artifact, tmp_path):
    p = tmp_path / "not_an_artifact.trkz"
    with zipfile.ZipFile(p, "w") as z:
        z.writestr("meta.json", "{}")
    with pytest.raises(ValueError, match="not a tracker artifact"):
        load_tracker_artifact(p)
    # the same programs, labelled for a card
    _, _, _, path, _ = artifact
    cuda = tmp_path / "cuda.trkz"
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(cuda, "w") as dst:
        for name in src.namelist():
            data = src.read(name)
            if name == "meta.json":
                meta = json.load(io.BytesIO(data))
                meta["platform"] = "cuda"
                data = json.dumps(meta).encode()
            dst.writestr(name, data)
    with pytest.raises(ValueError, match="exported for 'cuda'"):
        load_tracker_artifact(cuda, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            load_tracker_artifact(cuda)
