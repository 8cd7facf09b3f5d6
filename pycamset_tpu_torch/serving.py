"""Serving artifacts: a tracker's device programs frozen by ``torch.export``.

Counterpart of ``pycamset_tpu/serving.py``. A process that answers "where
is the target in this frame" needs the solver programs and the rig header,
not the calibration stack. ``export_tracker`` writes one zip file:

- ``meta.json``: the rig header (format
  ``pycamset_tpu_torch.tracker_artifact.v1``, platform ``"cuda"`` or
  ``"cpu"``, dtype, detection capacity, key and camera counts, camera
  names, key dims, state width);
- ``solve_batch.pt2``: the seeded batch solve (device triangulation and
  rigid-fit seeding, then the batched LM) and ``solve_stream.pt2``: the
  warm-start stream (a ``scan`` over frames), each an ``ExportedProgram``
  (``torch.export.save``) with a symbolic frame axis: one artifact serves
  any number of frames; the rig's constants are its buffers;
- ``template.npy``.

``load_tracker_artifact`` restores a ``ServingTracker`` that answers
``track_batch`` / ``track_stream`` with the exported programs alone: no
``TargetTracker``, no ``CameraSet``, no retrace. An artifact runs on the
device type it was exported on; loading it on another raises (as
``jax.export``'s platform check does). Host PnP needs the full rig and is
not part of an artifact: the batch is seeded on the device, the stream
from ``init`` or the device seed of its first seedable frame.
"""
from __future__ import annotations

import io
import json
import types
import zipfile
from pathlib import Path

import numpy as np
import torch

from pycamset_tpu_torch.config import resolve_device
from pycamset_tpu_torch.utils.general_utils import ext_4x4_to_rod

_FORMAT = "pycamset_tpu_torch.tracker_artifact.v1"


class _BatchProgram(torch.nn.Module):
    def __init__(self, core):
        super().__init__()
        self.core = core

    def forward(self, uv_grid, mask_grid, cam_i, key_i, uv, mask):
        return self.core.solve_batch_seeded(uv_grid, mask_grid, cam_i, key_i,
                                            uv, mask)


class _StreamProgram(torch.nn.Module):
    def __init__(self, core):
        super().__init__()
        self.core = core

    def forward(self, pose0, cam_i, key_i, uv, mask):
        from torch._higher_order_ops.scan import scan

        def step(carry, frame):
            nxt, row = self.core.stream_step(carry, *frame)
            return nxt.clone(), row
        _, rows = scan(step, pose0, (cam_i, key_i, uv, mask))
        return rows


def _saved(program: torch.export.ExportedProgram) -> bytes:
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_tracker(tracker, path: Path | str) -> Path:
    """Freeze ``tracker``'s device programs into an artifact file.

    :param tracker: a constructed TargetTracker (its rig constants are the
        programs' buffers; its device is the artifact's platform).
    :param path: destination file (conventionally ``.trkz``).
    """
    core = tracker.core
    dev, dtype = tracker.device, tracker._tdtype
    n, n_keys, n_cams = tracker.max_detections, tracker.n_keys, tracker.n_cams
    frames = torch.export.Dim("frames", min=1)
    # two example frames; the frame axis stays symbolic
    ex = 2

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)
    table = (zeros(ex, n, dt=torch.int64), zeros(ex, n, dt=torch.int64),
             zeros(ex, n, 2), zeros(ex, n))
    table_dims = ({0: frames},) * 4
    core.lm_as_scan = True
    try:
        exp_batch = torch.export.export(
            _BatchProgram(core), (zeros(ex, n_keys, n_cams, 2),
                                  zeros(ex, n_keys, n_cams), *table),
            dynamic_shapes=({0: frames}, {0: frames}, *table_dims),
            strict=False)
        exp_stream = torch.export.export(
            _StreamProgram(core), (zeros(tracker._n_state), *table),
            dynamic_shapes=(None, *table_dims), strict=False)
    finally:
        core.lm_as_scan = False

    meta = {
        "format": _FORMAT,
        "platform": dev.type,
        "dtype": np.dtype(tracker._dtype).name,
        "max_detections": n,
        "n_keys": n_keys,
        "n_cams": n_cams,
        "cam_names": list(tracker.camset.get_names()),
        "keydims": [int(d) for d in tracker.target.point_data.shape[:-1]],
        "n_state": int(tracker._n_state),
    }
    out = Path(path)
    with zipfile.ZipFile(out, "w", compression=zipfile.ZIP_DEFLATED) as z:
        z.writestr("meta.json", json.dumps(meta, indent=1))
        z.writestr("solve_batch.pt2", _saved(exp_batch))
        z.writestr("solve_stream.pt2", _saved(exp_stream))
        buf = io.BytesIO()
        np.save(buf, np.asarray(tracker._tpl))
        z.writestr("template.npy", buf.getvalue())
    return out


class ServingTracker:
    """Pose serving from an artifact: packing and the exported programs.

    The API mirrors the tracker's batch and stream calls; construction
    traces nothing and needs no CameraSet. The host-side packing and
    finalize are the live tracker's own methods (they read only attributes
    this class carries), so a batch gives ``TargetTracker.track_batch(...,
    seed_mode="device")``'s results.
    """

    def __init__(self, meta: dict, exp_batch, exp_stream,
                 template: np.ndarray, device):
        self.meta = meta
        self.device = device
        self._batch = exp_batch.module()
        self._stream = exp_stream.module()
        self._dtype = np.dtype(meta["dtype"])
        self._tdtype = (torch.float64 if self._dtype == np.float64
                        else torch.float32)
        self.max_detections = int(meta["max_detections"])
        self.n_keys = int(meta["n_keys"])
        self.n_cams = int(meta["n_cams"])
        self._tpl = template
        self._n_state = int(meta.get("n_state", 6))
        # _pack_table reads target.point_data.shape[:-1] (the key dims)
        self.target = types.SimpleNamespace(
            point_data=np.zeros(tuple(meta["keydims"]) + (3,)))
        self._last_pose = None

    def _tensor(self, a, dtype=None):
        from pycamset_tpu_torch.tracking import TargetTracker
        return TargetTracker._tensor(self, a, dtype)

    def _pack_table(self, detection):
        from pycamset_tpu_torch.tracking import TargetTracker
        return TargetTracker._pack_table(self, detection)

    def _grids(self, dd_all, n_frames):
        from pycamset_tpu_torch.tracking import TargetTracker
        return TargetTracker._obs_grids(self, dd_all, n_frames)

    def _finalize(self, out, mask):
        from pycamset_tpu_torch.tracking import TargetTracker
        return TargetTracker._finalize_batch(
            self, out.double().cpu().numpy(), mask)

    def track_batch(self, detection):
        """Poses for every image in the table (device seeding)."""
        dd_all, bounds, n_frames, mask, dev_args = self._pack_table(detection)
        uv_grid, mask_grid = self._grids(dd_all, n_frames)
        out, _seeds = self._batch(self._tensor(uv_grid),
                                  self._tensor(mask_grid), *dev_args)
        return self._finalize(out, mask)

    def track_stream(self, detection, init=None):
        """Sequential warm-start tracking; ``init`` seeds frame 0 (6-vector
        or 4x4). Default: the device seed of the first frame whose keys
        two cameras see (the batch program's seed output)."""
        dd_all, bounds, n_frames, mask, dev_args = self._pack_table(detection)
        if init is None:
            init = self._device_seed(dd_all, n_frames, dev_args)
        if init is None:
            raise ValueError("no stereo-seedable frame found and no init "
                             "given for track_stream")
        init = np.asarray(init, dtype=float)
        if init.shape == (4, 4):
            init = np.concatenate(ext_4x4_to_rod(init))
        init = np.ravel(init)
        if init.size == 6 and self._n_state == 12:
            init = np.concatenate([init, np.zeros(6)])
        out = self._stream(self._tensor(init), *dev_args)
        return self._finalize(out, mask)

    def _device_seed(self, dd_all, n_frames, dev_args):
        """The device seed of the first genuinely seedable frame: >= 3 keys
        each seen by >= 2 cameras (the seeder's own rule; a weaker test
        would warm-start the stream from its zeros fallback)."""
        im_c = dd_all[:, 1].astype(int)
        for i in range(n_frames):
            rows = dd_all[im_c == i]
            if not len(rows):
                continue
            pairs = np.unique(rows[:, [0, -3]].astype(int), axis=0)
            _keys, ncams = np.unique(pairs[:, 1], return_counts=True)
            if int((ncams >= 2).sum()) < 3:
                continue
            r = rows.copy()
            r[:, 1] = 0  # the single frame renumbered for a one-frame grid
            uv_g, m_g = self._grids(r, 1)
            _out, seeds = self._batch(
                self._tensor(uv_g), self._tensor(m_g),
                *(a[i:i + 1] for a in dev_args))
            return seeds[0].double().cpu().numpy()
        return None


def load_tracker_artifact(path: Path | str, device=None) -> ServingTracker:
    """Restore a ServingTracker from :func:`export_tracker`'s file.

    :param device: where to serve; default the artifact's platform (a
        ``"cuda"`` artifact needs a card). Another device type raises.
    """
    with zipfile.ZipFile(Path(path), "r") as z:
        meta = json.loads(z.read("meta.json"))
        if meta.get("format") != _FORMAT:
            raise ValueError(f"not a tracker artifact: {path}")
        platform = meta["platform"]
        device = resolve_device(platform if device is None else device)
        if device.type != platform:
            raise ValueError(
                f"the artifact was exported for {platform!r} and cannot run "
                f"on {device.type!r}; export it on the serving platform")
        exp_batch = torch.export.load(io.BytesIO(z.read("solve_batch.pt2")))
        exp_stream = torch.export.load(io.BytesIO(z.read(
            "solve_stream.pt2")))
        template = np.load(io.BytesIO(z.read("template.npy")))
    return ServingTracker(meta, exp_batch, exp_stream, template, device)
