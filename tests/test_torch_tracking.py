"""Port parity: the serving path's tracker (float64, CPU).

``pycamset_tpu_torch.tracking.TargetTracker`` against the JAX package's
``TargetTracker`` on the rig of its own tests (``tests/test_tracking.py::
_rig``: 3 cameras, grid 6, 12 frames), one JAX tracker of each kind a
module:

- ``matrix_to_rodrigues`` near 0, near pi and generic (1e-12); the
  inhomogeneous triangulation, uniform and het rows (1e-9);
- the device LM (``optim/lm.lm_solve_device``) under ``torch.func.vmap``
  against the JAX tracker's vmapped ``lm_solve`` (x to 1e-9; nit, nfev and
  status equal), and on one frame against the host-looped ``lm_solve``
  bit for bit; no host read on the batched path;
- ``seed_batch`` (1e-9), ``track_batch`` with device and auto seeding and
  the auto rescue of monocular frames (poses 1e-9, rms 1e-9 relative, nit
  and status equal, sigmas and covariances 1e-6 relative),
  ``track_stream``, warm-started ``track``, the cauchy loss, capacity
  truncation and the refusals, a het rig (fisheye beside Brown cameras)
  and the 12-dof timed state (readouts, once). The warm starts, the het
  rig and the timed state (its velocity nearly flat under the 1e-8 prior)
  end frames at the float64 noise floor of the cost, where nit is decided
  by rounding (``_held``): there poses, rms and sigmas are held, not nit.
"""
import numpy as np
import pytest
import torch

from pycamset_tpu.models.detections import TargetDetection as JDetection
from pycamset_tpu.tracking import TargetTracker as JTracker
from pycamset_tpu_torch.from_jax import camset_from_jax, detection_from_jax
from pycamset_tpu_torch.models.detections import TargetDetection
from pycamset_tpu_torch.optim import lm
from pycamset_tpu_torch.optim.handlers import FreePointTarget
from pycamset_tpu_torch.tracking import TargetTracker
from tests.test_tracking import _rig, _temporal_capture

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)

N_IMS = 12


def _port(cams, target, det):
    return (camset_from_jax(cams),
            FreePointTarget(np.asarray(target.point_data)),
            detection_from_jax(det))


def _held(p_jax, i_jax, p_port, i_port, sigmas=True, same_nit=True):
    """Poses 1e-9, rms 1e-9 relative, sigmas and covariances 1e-6
    relative; nit equal with ``same_nit``. Without it, frames whose last
    steps move the cost by less than its float64 resolution: there each
    accept or reject follows the last digits of the cost (the two packages'
    predictions differ by ~1e-13 px of rounding), so one package stops on
    ftol where the other rejects a few steps first, at the same cost."""
    np.testing.assert_allclose(p_port, p_jax, rtol=0, atol=1e-9)
    np.testing.assert_allclose(i_port["rms"], i_jax["rms"], rtol=1e-9)
    if same_nit:
        np.testing.assert_array_equal(i_port["nit"], i_jax["nit"])
    if sigmas:
        np.testing.assert_allclose(i_port["pose_sigma"], i_jax["pose_sigma"],
                                   rtol=1e-6)
        np.testing.assert_allclose(i_port["pose_cov"], i_jax["pose_cov"],
                                   rtol=1e-6, atol=1e-6 * np.abs(
                                       i_jax["pose_cov"]).max())


@pytest.fixture(scope="module")
def rig():
    cams, target, det, true, raw = _rig(n_ims=N_IMS)
    pcams, ptarget, pdet = _port(cams, target, det)
    return {"cams": cams, "target": target, "det": det, "true": true,
            "raw": raw, "jax": JTracker(cams, target),
            "port": TargetTracker(pcams, ptarget, device="cpu"),
            "pcams": pcams, "ptarget": ptarget, "pdet": pdet}


def _grids(tr, det):
    dd_all, _, n_frames, _, _ = tr._pack_table(det)
    return tr._obs_grids(dd_all, n_frames)


# ------------------------------------------------------------- the pieces

@pytest.mark.parametrize("case", ["zero", "small", "generic", "near_pi",
                                  "pi"])
def test_matrix_to_rodrigues_vs_jax(case):
    import jax.numpy as jnp

    from pycamset_tpu.ops.rotations import matrix_to_rodrigues_batch as jm
    from pycamset_tpu.ops.rotations import rodrigues_to_matrix_batch as jr
    from pycamset_tpu_torch.ops.rotations import matrix_to_rodrigues

    rng = np.random.default_rng(3)
    axes = rng.normal(size=(8, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angle = {"zero": 0.0, "small": 1e-9, "generic": 1.3,
             "near_pi": np.pi - 1e-7, "pi": np.pi}[case]
    mats = np.asarray(jr(jnp.asarray(axes * angle)))
    want = np.asarray(jm(jnp.asarray(mats)))
    got = matrix_to_rodrigues(torch.as_tensor(mats)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("het", [False, True])
def test_inhomogeneous_triangulation_vs_jax(het):
    import jax.numpy as jnp

    from pycamset_tpu.models.camera_set import stack_cam_dists
    from pycamset_tpu.ops.triangulation import (
        triangulate_observations as jax_tri)
    from pycamset_tpu.utils.general_utils import make_4x4h_tform
    from pycamset_tpu.utils.synthetic import make_synthetic_rig
    from pycamset_tpu_torch.ops.triangulation import triangulate_observations

    models = ["fisheye", "standard", "standard", "rational"] if het else \
        "standard"
    rig = make_synthetic_rig(n_cams=4, n_ims=3, grid=6, visibility=0.8,
                             noise_px=0.2, seed=5, camera_model=models)
    intr = rig["intr"]
    kmats = np.stack([np.array([[i[0], 0, i[1]], [0, i[2], i[3]],
                                [0, 0, 1]]) for i in intr])
    widths = rig["camera_models"]
    wd = {"fisheye": 4, "standard": 5, "rational": 8}
    dists, het_rows = stack_cam_dists([i[4:4 + wd[m]]
                                       for i, m in zip(intr, widths)])
    assert het_rows == het
    exts = np.stack([make_4x4h_tform(e[:3], e[3:]) for e in rig["extr"]])
    proj = np.einsum("cij,cjk->cik", kmats, exts[:, :3, :])
    dd = rig["dd"]
    n_pts = 3 * 36
    uv = np.zeros((n_pts, 4, 2))
    mask = np.zeros((n_pts, 4))
    rows = (dd[:, 1] * 36 + dd[:, 2]).astype(int)
    uv[rows, dd[:, 0].astype(int)] = dd[:, 3:5]
    mask[rows, dd[:, 0].astype(int)] = 1.0
    cam_idx = np.broadcast_to(np.arange(4), (n_pts, 4))
    args = (proj, kmats, dists, cam_idx, uv, mask)
    want = np.asarray(jax_tri(*map(jnp.asarray, args),
                              method="inhomogeneous", het=het))
    got = triangulate_observations(*map(torch.as_tensor, args),
                                   method="inhomogeneous", het=het).numpy()
    seen = mask.sum(axis=1) >= 2
    np.testing.assert_allclose(got[seen], want[seen], rtol=0, atol=1e-9)
    assert np.all(np.isfinite(got))      # padding points stay finite
    with pytest.raises(ValueError, match="method"):
        triangulate_observations(*map(torch.as_tensor, args), method="dlt")


# ------------------------------------------------------------ the device LM

def _perturbed_seeds(rig, scale=0.01, far=0.0):
    rng = np.random.default_rng(11)
    seeds = rig["raw"]["poses"] + rng.normal(size=(N_IMS, 6)) * scale
    seeds[3] += far                        # one frame far from its pose
    return seeds


@pytest.mark.parametrize("scale,far", [(0.01, 0.0), (0.03, 0.3)])
def test_device_lm_under_vmap_vs_jax(rig, scale, far):
    """x to 1e-9 from seeds 0.01 and 0.03 (one frame 0.3) off the poses;
    nit, nfev and status equal from the near seeds. From the far ones a
    few frames end at the float64 noise floor, where each accept or reject
    is decided by the last digits of the cost: the residuals of the two
    packages differ by ~1e-14 relative (closed form against jacfwd's
    trace), and there nit differs (4 against 10) while x agrees."""
    import jax.numpy as jnp

    from pycamset_tpu_torch.optim.lm import lm_solve_device

    jt, pt = rig["jax"], rig["port"]
    seeds = _perturbed_seeds(rig, scale, far)
    _, _, _, _, dev_args = pt._pack_table(rig["pdet"])
    _, _, _, _, jargs = jt._pack_table(rig["det"])
    res, _ = jt._solve_batch(jnp.asarray(seeds), *jargs)
    core = pt.core

    def one(x0, ci, ki, uv, m):
        return tuple(lm_solve_device(lambda p: core.neq(p, ci, ki, uv, m),
                                     x0, max_nfev=25))
    got = torch.func.vmap(one)(torch.as_tensor(seeds), *dev_args)
    got = lm.LMResult(*got)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(res.x), rtol=0,
                               atol=1e-9)
    if far:
        return
    for f in ("nit", "nfev", "status"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(res, f)))
    assert int(np.asarray(res.nit).min()) > 2       # more than a polish


def test_device_lm_one_frame_is_the_host_loop(rig):
    from pycamset_tpu_torch.optim.lm import lm_solve, lm_solve_device

    pt = rig["port"]
    seeds = torch.as_tensor(_perturbed_seeds(rig, 0.03, 0.3))
    _, _, _, _, dev_args = pt._pack_table(rig["pdet"])
    frame = [a[3] for a in dev_args]

    def neq(p):
        return pt.core.neq(p, *frame)
    host = lm_solve(neq, seeds[3], max_nfev=25)
    dev = lm_solve_device(neq, seeds[3], max_nfev=25)
    for a, b in zip(host, dev):
        assert torch.equal(a, b)


def test_batched_path_reads_nothing(rig):
    lm.host_reads = 0
    rig["port"].track_batch(rig["pdet"], seed_mode="device")
    rig["port"].track_batch(rig["pdet"], inits=rig["true"])
    assert lm.host_reads == 0


# --------------------------------------------------------------- the tracker

def test_seed_batch_vs_jax(rig):
    import jax.numpy as jnp
    ug, mg = _grids(rig["port"], rig["pdet"])
    want = np.asarray(rig["jax"]._seed_batch(jnp.asarray(ug),
                                             jnp.asarray(mg)))
    got = rig["port"].core.seed_batch(torch.as_tensor(ug),
                                  torch.as_tensor(mg)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("seed_mode", ["device", "auto"])
def test_track_batch_vs_jax(rig, seed_mode):
    import jax.numpy as jnp
    p_jax, i_jax = rig["jax"].track_batch(rig["det"], seed_mode=seed_mode)
    p_port, i_port = rig["port"].track_batch(rig["pdet"],
                                             seed_mode=seed_mode)
    _held(p_jax, i_jax, p_port, i_port)
    # status: column S + 2 of JAX's packed rows
    ug, mg = _grids(rig["port"], rig["pdet"])
    _, _, _, _, jargs = rig["jax"]._pack_table(rig["det"])
    out, _ = rig["jax"]._solve_batch_seeded(jnp.asarray(ug), jnp.asarray(mg),
                                            *jargs)
    np.testing.assert_array_equal(i_port["status"],
                                  np.asarray(out)[:, 8].astype(int))
    np.testing.assert_allclose(p_port, rig["true"], atol=2e-2)


def test_auto_rescues_monocular_frames_vs_jax(rig):
    dd = rig["det"].get_data()
    mono = np.isin(dd[:, 1], [1, 4]) & (dd[:, 0] != 0)
    jdet = JDetection(cam_names=rig["det"].cam_names, data=dd[~mono],
                      max_ims=N_IMS)
    p_jax, i_jax = rig["jax"].track_batch(jdet)
    p_port, i_port = rig["port"].track_batch(detection_from_jax(jdet))
    _held(p_jax, i_jax, p_port, i_port)
    assert np.abs(p_port[:, :3, 3] - rig["true"][:, :3, 3]).max() < 1e-3


def test_track_stream_and_warm_track_vs_jax(rig):
    p_jax, i_jax = rig["jax"].track_stream(rig["det"], init=rig["true"][0])
    p_port, i_port = rig["port"].track_stream(rig["pdet"],
                                              init=rig["true"][0])
    _held(p_jax, i_jax, p_port, i_port, same_nit=False)
    frames_j = rig["det"].get_image_list()[:4]
    frames_p = rig["pdet"].get_image_list()[:4]
    rig["jax"]._last_pose = rig["port"]._last_pose = None
    for k, (fj, fp) in enumerate(zip(frames_j, frames_p)):
        init = rig["raw"]["poses"][0] if k == 0 else None
        pj, ij = rig["jax"].track(fj, init=init)
        pp, ip = rig["port"].track(fp, init=init)
        np.testing.assert_allclose(pp, pj, rtol=0, atol=1e-9)
        np.testing.assert_allclose(ip["rms"], ij["rms"], rtol=1e-9)
        assert ip["n_used"] == ij["n_used"]
        np.testing.assert_allclose(ip["pose_sigma"], ij["pose_sigma"],
                                   rtol=1e-6)


def test_stream_lost_frame_vs_jax(rig):
    dd = rig["det"].get_data()
    rows_lost = np.nonzero(dd[:, 1] == 3)[0]
    keep = np.ones(len(dd), bool)
    keep[rows_lost[2:]] = False
    jdet = JDetection(cam_names=rig["det"].cam_names, data=dd[keep],
                      max_ims=N_IMS)
    p_jax, i_jax = rig["jax"].track_stream(jdet, init=rig["true"][0])
    p_port, i_port = rig["port"].track_stream(detection_from_jax(jdet),
                                              init=rig["true"][0])
    _held(p_jax, i_jax, p_port, i_port, same_nit=False)
    assert np.isinf(i_port["rms"][3]) and np.isinf(i_port["pose_sigma"][3]
                                                   ).all()
    np.testing.assert_array_equal(p_port[3], p_port[2])


def test_cauchy_loss_vs_jax(rig):
    dd = rig["det"].get_data().copy()
    rng = np.random.default_rng(0)
    bad = rng.choice(len(dd), len(dd) // 10, replace=False)
    dd[bad, -2:] += rng.normal(size=(len(bad), 2)) * 60.0
    jdet = JDetection(cam_names=rig["det"].cam_names, data=dd, max_ims=N_IMS)
    p_plain, _ = rig["port"].track_batch(detection_from_jax(jdet))
    robust_j = JTracker(rig["cams"], rig["target"], loss="cauchy",
                        f_scale=1.0, max_nfev=60)
    robust_p = TargetTracker(rig["pcams"], rig["ptarget"], loss="cauchy",
                             f_scale=1.0, max_nfev=60, device="cpu")
    p_jax, i_jax = robust_j.track_batch(jdet, inits=p_plain)
    p_port, i_port = robust_p.track_batch(detection_from_jax(jdet),
                                          inits=p_plain)
    _held(p_jax, i_jax, p_port, i_port)
    assert np.abs(p_port[:, :3, 3] - rig["true"][:, :3, 3]).max() < 5e-4


def test_capacity_truncation_and_refusals(rig, caplog):
    small_j = JTracker(rig["cams"], rig["target"], max_detections=10)
    small_p = TargetTracker(rig["pcams"], rig["ptarget"], max_detections=10,
                            device="cpu")
    init = rig["raw"]["poses"][0]
    pj, ij = small_j.track(rig["det"].get_image_list()[0], init=init)
    pp, ip = small_p.track(rig["pdet"].get_image_list()[0], init=init)
    assert ip["n_used"] == ij["n_used"] == 10
    assert "truncating" in caplog.text
    np.testing.assert_allclose(pp, pj, rtol=0, atol=1e-9)
    tr = rig["port"]
    with pytest.raises(ValueError, match="no detections"):
        tr.track(TargetDetection(cam_names=["a", "b", "c"], data=None))
    with pytest.raises(ValueError, match="seed_mode"):
        tr.track_batch(rig["pdet"], seed_mode="Device")
    with pytest.raises(ValueError, match="4x4, a 6-vector"):
        tr.track_batch(rig["pdet"], inits=np.zeros((N_IMS, 5)))


def test_het_rig_vs_jax():
    from pycamset_tpu.models.camera_set import CameraSet, make_cam_dict
    from pycamset_tpu.optim.handlers import FreePointTarget as JTarget
    from pycamset_tpu.utils.general_utils import make_4x4h_tform
    from pycamset_tpu.utils.synthetic import make_synthetic_rig

    models = ["fisheye", "standard", "standard"]
    rig = make_synthetic_rig(n_cams=3, n_ims=4, grid=6, visibility=0.9,
                             noise_px=0.2, seed=8, camera_model=models)
    wd = {"fisheye": 4, "standard": 5}
    cams = CameraSet(camera_dict=make_cam_dict(
        ["a", "b", "c"],
        [make_4x4h_tform(e[:3], e[3:]) for e in rig["extr"]],
        [np.array([[i[0], 0, i[1]], [0, i[2], i[3]], [0, 0, 1]])
         for i in rig["intr"]],
        [i[4:4 + wd[m]] for i, m in zip(rig["intr"], models)],
        [[1600, 1200]] * 3))
    target = JTarget(rig["template"].reshape(1, -1, 3))
    det = JDetection(cam_names=["a", "b", "c"], data=rig["dd"])
    p_jax, i_jax = JTracker(cams, target).track_batch(det,
                                                      seed_mode="device")
    pcams, ptarget, pdet = _port(cams, target, det)
    tr = TargetTracker(pcams, ptarget, device="cpu")
    assert tr.core.het
    p_port, i_port = tr.track_batch(pdet, seed_mode="device")
    _held(p_jax, i_jax, p_port, i_port, same_nit=False)


def test_timed_state_readouts_vs_jax():
    readouts = np.array([0.7, 0.7, 0.7])
    cams, target, det, knots = _temporal_capture(readouts=readouts)
    j_rs = JTracker(cams, target, rolling_shutter=readouts)
    p_jax, i_jax = j_rs.track_batch(det)
    pcams, ptarget, pdet = _port(cams, target, det)
    tr = TargetTracker(pcams, ptarget, rolling_shutter=readouts,
                       device="cpu")
    p_port, i_port = tr.track_batch(pdet)
    _held(p_jax, i_jax, p_port, i_port, same_nit=False)
    # the velocity is the state's near-flat direction: where the two stop
    # at different steps of the noise floor it moves by a few 1e-9
    same = i_port["nit"] == i_jax["nit"]
    assert same.sum() >= len(same) // 2
    np.testing.assert_allclose(i_port["velocity"][same],
                               i_jax["velocity"][same], rtol=0, atol=1e-9)
    np.testing.assert_allclose(i_port["velocity"], i_jax["velocity"],
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(i_port["velocity_sigma"],
                               i_jax["velocity_sigma"], rtol=1e-6)
    assert i_port["rms"].mean() < 0.11
