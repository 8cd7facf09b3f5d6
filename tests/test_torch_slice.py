"""Port parity: the whole template bundle adjustment, end to end.

A small perturbed rig, built as ``bench.py::standard_problem`` builds the
north-star problem, is solved in float64 on the CPU by pycamset_tpu's
``structured_lm_solve`` and by pycamset_tpu_torch's: the same iterations,
evaluations and status, the final cost within 1e-9 relative and the
parameters within 1e-7 of their scale. Also: pause/resume at ``nfev_cap``,
the package's import boundary, the user path's card path run with jax and
cv2 unimportable, and the refusal of a CUDA device without one.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycamset_tpu.optim import structured as js
from pycamset_tpu.optim.blocks import Extrinsic3D, Projection, TemplatePoints
from pycamset_tpu.optim.chain import OptimFunction
from pycamset_tpu.optim.structured_lm import structured_lm_solve
from pycamset_tpu.utils.synthetic import make_synthetic_rig
from pycamset_tpu_torch.optim.structured_lm import (slm_init, slm_result,
                                                    slm_run)
from pycamset_tpu_torch.problems import (perturbed_start, standard_problem,
                                         template_colmask)

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _jax_solve(n_cams, n_ims, grid, loss):
    """bench.py::standard_problem's solve at a small size (pad rows of the
    template replicate key 0, as in the port)."""
    rig = make_synthetic_rig(n_cams=n_cams, n_ims=n_ims, grid=grid,
                             visibility=0.85, noise_px=0.3, seed=0)
    n_keys = rig["n_keys"]
    op = OptimFunction([Projection(), Extrinsic3D(), TemplatePoints()])
    w = js.chain_widths(op)
    st = op.param_struct(n_cams, n_ims, n_keys)
    bl = js.build_block_arrays(rig["dd"], n_cams, n_ims, n_keys,
                               k_pad_multiple=8)
    k_pad = bl.uv.shape[1]
    tpl = jnp.asarray(js.pad_template_table(rig["template"], True, n_keys,
                                            k_pad))
    p = js.split_full_params(jnp.asarray(perturbed_start(rig, st)), op, st,
                             n_cams, n_ims, n_keys, w)
    p = js.ParamPieces(p.cam, p.im, jnp.zeros((k_pad, 0)))
    cm = js.ParamPieces(*template_colmask(n_cams, n_ims, w, k_pad))
    neq = js.make_structured_neq(op, w, n_cams, n_ims, loss=loss)
    uv, mask = bl.as_device(jnp.float64)
    return jax.jit(lambda pp: structured_lm_solve(
        lambda q: neq(q, uv, mask, tpl, cm), pp, max_nfev=100))(p)


# (4, 16): no image padding at tile 16 -> the fused-reduction family;
# (3, 5): pads past 5% -> the per-block family
@pytest.mark.parametrize("n_cams,n_ims,loss", [(4, 16, "linear"),
                                               (3, 5, "linear"),
                                               (3, 5, "huber")])
def test_template_lm_matches_jax_package(n_cams, n_ims, loss):
    ref = _jax_solve(n_cams, n_ims, 6, loss)
    prob = standard_problem(n_cams, n_ims, "cpu", grid=6, k_pad_multiple=8,
                            loss=loss)
    got = prob.solve()
    assert (got.nit, got.nfev, int(got.status)) == (
        int(ref.nit), int(ref.nfev), int(ref.status))
    assert int(got.status) in (1, 2)
    assert abs(float(got.cost) - float(ref.cost)) <= 1e-9 * float(ref.cost)
    for g, r in zip(got.x, ref.x):
        r = np.asarray(r)
        if r.size:
            assert np.abs(g.numpy() - r).max() <= 1e-7 * np.abs(r).max()
    n = got.nit + 1
    assert np.abs(got.history[:n].numpy() - np.asarray(ref.history)[:n]
                  ).max() <= 1e-9 * float(ref.history[0])


def test_nfev_cap_pause_resume_is_bit_identical():
    prob = standard_problem(3, 5, "cpu", grid=6, k_pad_multiple=8)
    neq_fn = prob.neq_fn()
    whole = prob.solve()
    state = slm_init(neq_fn, prob.x0, max_nfev=100)
    paused = slm_run(neq_fn, state, max_nfev=100, nfev_cap=3)
    assert paused.nfev == 3 and int(paused.status) == 0
    resumed = slm_result(slm_run(neq_fn, paused, max_nfev=100))
    assert (resumed.nit, resumed.nfev, int(resumed.status)) == (
        whole.nit, whole.nfev, int(whole.status))
    assert torch.equal(resumed.cost, whole.cost)
    assert torch.equal(resumed.history, whole.history)
    for a, b in zip(resumed.x, whole.x):
        assert torch.equal(a, b)


def test_max_nfev_budget_sets_status_4():
    prob = standard_problem(3, 5, "cpu", grid=6, k_pad_multiple=8)
    res = prob.solve(max_nfev=3)
    assert (res.nfev, int(res.status)) == (3, 4)


def test_package_imports_neither_jax_nor_cv2():
    """Every module of the package, found by walking it (a module added
    later is held too), imports none of jax, cv2 and pycamset_tpu."""
    code = ("import importlib, pkgutil, sys, pycamset_tpu_torch as p; "
            "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
            "p.__name__ + '.')]; "
            "[importlib.import_module(n) for n in names]; "
            "assert len(names) > 40 and 'pycamset_tpu_torch.serving' in names"
            ", names; "
            "bad = [m for m in ('jax', 'cv2', 'pycamset_tpu') "
            "if m in sys.modules]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_user_path_does_not_load_the_bench():
    """The user's entry point sits below the bench's problems: importing it
    loads neither ``problems.py`` nor the synthetic rigs or the fleet."""
    code = ("import sys, pycamset_tpu_torch.calibration.camera_calibrator; "
            "bad = [m for m in ('pycamset_tpu_torch.problems', "
            "'pycamset_tpu_torch.utils.synthetic', "
            "'pycamset_tpu_torch.optim.fleet') if m in sys.modules]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


# The card path with jax and cv2 unimportable: a handler seeded through
# set_initial_params, run_stereo_calibration, the saved file loaded back
# and its calibration uncertainty (the loaded handler holds no start: no
# PnP); then the self-calibration warm-started from it and the free-point
# handler, each saved and loaded back; the generic and scipy backends; the
# tracker's device-seeded batch and an init= frame, and its PnP seed
# refused; target poses on the fixed rig and the wand's solve from the
# stored rig, their PnP starts refused, a COLMAP round trip; on the CPU at
# a tiny size.
CARD_PATH = """
import sys, tempfile
sys.modules["cv2"] = None
sys.modules["jax"] = None
import numpy as np
from pycamset_tpu_torch.problems import template_handler
from pycamset_tpu_torch.calibration.camera_calibrator import (
    run_stereo_calibration)
from pycamset_tpu_torch.utils.saving import load_CameraSet
handler, _ = template_handler(3, 5, grid=5)
with tempfile.TemporaryDirectory() as d:
    cams = run_stereo_calibration(None, None, None, param_handler=handler,
                                  save_loc=d + "/cams.camset", device="cpu")
    back = load_CameraSet(d + "/cams.camset")
assert back == cams and back.calibration_handler is not None
assert np.array_equal(back.calibration_result, cams.calibration_result)
unc = cams.calibration_uncertainty(device="cpu")
unc_back = back.calibration_uncertainty(device="cpu")
assert unc["dof"] == unc_back["dof"] and unc["sigma2"] == unc_back["sigma2"]
assert np.array_equal(unc["pose_sigma"], unc_back["pose_sigma"])
# the self-calibration after the template one, and the pose-free
# free-point handler: both saved and loaded back with their handler class
from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
from pycamset_tpu_torch.optim.handlers import (FreePointBundleHandler,
                                               SelfBundleHandler)
from pycamset_tpu_torch.problems import freepoint_handler
selfcal = SelfBundleHandler(cams, handler.target, handler.detection,
                            options={"outliers": "n", "verbosity": 0})
selfcal.set_from_templated_camset(cams)
fp, _ = freepoint_handler(3, 4, grid=4, k_pad_multiple=8)
with tempfile.TemporaryDirectory() as d:
    scams = run_stereo_calibration(None, None, None, param_handler=selfcal,
                                   save_loc=d + "/self.camset", device="cpu")
    sback = load_CameraSet(d + "/self.camset")
    _, fcams = run_bundle_adjustment(fp, device="cpu")
    fcams.save(d + "/fp.camset")
    fback = load_CameraSet(d + "/fp.camset")
assert sback == scams and type(sback.calibration_handler) is SelfBundleHandler
assert type(fback.calibration_handler) is FreePointBundleHandler
assert np.array_equal(fback.calibration_params, fcams.calibration_params)
for backend in ("generic", "scipy"):
    h, _ = template_handler(3, 5, grid=5, options={"max_nfev": 8})
    res, _ = run_bundle_adjustment(h, backend=backend, device="cpu")
    assert res.nfev <= 8 and np.isfinite(res.cost), (backend, res)
bad = [m for m in ("pycamset_tpu", "pycamset_tpu.config") if m in sys.modules]
assert not bad, bad
try:
    handler.initial_params = None
    handler.get_initial_params()
except ImportError as err:
    assert "set_initial_params" in str(err), err
else:
    raise AssertionError("the PnP seed ran without cv2")
# the serving path: device seeding and init= run, a needed PnP step raises
from pycamset_tpu_torch.problems import tracking_scene
from pycamset_tpu_torch.tracking import TargetTracker
sc = tracking_scene("moving", 6)
tr = TargetTracker(sc["cams"], sc["target"], device="cpu")
poses, info = tr.track_batch(sc["det"], seed_mode="device")
assert np.abs(poses - sc["true"]).max() < 2e-2, poses
pose, _ = tr.track(sc["det"].get_image_list()[0], init=sc["true"][0])
assert np.abs(pose - sc["true"][0]).max() < 2e-2
tr._last_pose = None
for call in (lambda: tr.track_batch(sc["det"], seed_mode="pnp"),
             lambda: tr.track(sc["det"].get_image_list()[0])):
    try:
        call()
    except ImportError as err:
        assert "seed_mode='device'" in str(err), err
    else:
        raise AssertionError("the tracker's PnP seed ran without cv2")
# target poses on the fixed rig and the wand from the stored rig; their
# PnP starts refused; the interop exports, model selection's split
import pycamset_tpu_torch.calibration.model_select as ms
import pycamset_tpu_torch.reconstruction.acmmp_utils
from pycamset_tpu_torch.calibration.wand import calibrate_extrinsics_from_wand
from pycamset_tpu_torch.optim.find_target import (
    estimate_poses_with_fixed_cameras)
from pycamset_tpu_torch.utils.interop import export_colmap, import_colmap
from pycamset_tpu_torch.utils.synthetic import ring_rig, wand_capture
poses, res = estimate_poses_with_fixed_cameras(
    sc["cams"], sc["target"], sc["det"], start="rig", device="cpu")
assert np.abs(poses - sc["true"]).max() < 2e-2 and res.status in (1, 2, 3)
wand = np.array([[0.0, 0, 0], [0.25, 0, 0], [0.5, 0, 0]])
rig = ring_rig(4, radius=1.6, z=0.7, f=1400.0)
rows, _ = wand_capture(rig, wand, 40, seed=1)
wcams, rep = calibrate_extrinsics_from_wand(rig, rows, wand, start="rig",
                                            device="cpu")
assert rep["rms_px"] < 0.3 and rep["scale_from"] == "wand_template", rep
for call in (lambda: estimate_poses_with_fixed_cameras(
                 sc["cams"], sc["target"], sc["det"], device="cpu"),
             lambda: calibrate_extrinsics_from_wand(rig, rows, wand,
                                                    device="cpu")):
    try:
        call()
    except ImportError as err:
        assert "start='rig'" in str(err), err
    else:
        raise AssertionError("a PnP start ran without cv2")
with tempfile.TemporaryDirectory() as d:
    back = import_colmap(export_colmap(wcams, d + "/model"))
assert back.get_names() == wcams.get_names()
train, hold = ms.split_detection_images(sc["det"], seed=0)
assert train.max_ims + hold.max_ims == 6
bad = [m for m in ("pycamset_tpu", "pycamset_tpu.config") if m in sys.modules]
assert not bad, bad
"""


def test_card_path_needs_neither_jax_nor_cv2():
    subprocess.run([sys.executable, "-c", CARD_PATH], cwd=REPO, check=True,
                   timeout=120)


# The calibration extras with jax and cv2 unimportable, each on its
# OpenCV-free path at a tiny size on the CPU: sync on a moving capture,
# rig_health and the recalibrations from the stored rig (their PnP start
# refused), hand-eye, a model conversion and the planner from the truth.
CALIBRATION_EXTRAS = """
import sys
sys.modules["cv2"] = None
sys.modules["jax"] = None
import numpy as np
from pycamset_tpu_torch.calibration import (
    calibrate_hand_eye, calibrate_time_offsets, convert_camera_set,
    plan_calibration, recalibrate_extrinsics, recalibrate_intrinsics,
    rig_health, synthesize_detections)
from pycamset_tpu_torch.models.abstract_target import FreePointTarget
from pycamset_tpu_torch.models.detections import TargetDetection
from pycamset_tpu_torch.utils.general_utils import make_4x4h_tform
from pycamset_tpu_torch.utils.synthetic import (grid_target, moving_capture,
                                                ring_rig)
cams = ring_rig()
tpl = grid_target()
target = FreePointTarget(tpl.reshape(1, -1, 3))
rows, _ = moving_capture(cams, tpl, 12, np.array([0.0, 1.2, -0.3]),
                         noise=0.1, seed=1)
res = calibrate_time_offsets(cams, TargetDetection(cams.get_names(), rows),
                             target, max_shift=2, device="cpu")
assert np.abs(res.offsets - [0.0, 1.2, -0.3]).max() < 0.05, res.offsets
det, poses = synthesize_detections(cams, tpl, 6, noise_px=0.1, seed=2,
                                   device="cpu")
assert rig_health(cams, det, target, device="cpu")["drifted"] == []
_, rep = recalibrate_extrinsics(cams, det, target, start="rig",
                                device="cpu")
assert rep["rms_px"] < 0.3, rep
_, rep = recalibrate_intrinsics(cams, det, target, refresh=["cam1"],
                                start="rig", device="cpu")
assert rep["rms_px"] < 0.3, rep
for call in (lambda: recalibrate_extrinsics(cams, det, target,
                                            device="cpu"),
             lambda: plan_calibration(cams, tpl, n_ims=4, device="cpu")):
    try:
        call()
    except ImportError as err:
        assert "start=" in str(err), err
    else:
        raise AssertionError("a PnP start ran without cv2")
p = np.stack([make_4x4h_tform(q[:3], q[3:]) for q in poses])
x = make_4x4h_tform(np.array([0.1, -0.2, 0.3]), np.array([0.05, 0.0, 0.1]))
g = np.stack([np.linalg.inv(pi) @ np.linalg.inv(x) for pi in p])
he = calibrate_hand_eye(cams, det, g, target, device="cpu")
assert np.abs(he.x - x).max() < 1e-2 and he.info["status"] > 0
_, reps = convert_camera_set(cams, to="rational", grid=12, device="cpu")
assert max(r["rms_px"] for r in reps.values()) < 1e-3, reps
plan = plan_calibration(cams, tpl, n_ims=6, start="truth", device="cpu")
assert plan["result"].status in (1, 2, 3) and "cam2" in plan["cameras"]
bad = [m for m in ("pycamset_tpu", "pycamset_tpu.config") if m in sys.modules]
assert not bad, bad
"""


def test_calibration_extras_need_neither_jax_nor_cv2():
    subprocess.run([sys.executable, "-c", CALIBRATION_EXTRAS], cwd=REPO,
                   check=True, timeout=120)


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        standard_problem(3, 5, "cuda", grid=4, k_pad_multiple=8)
