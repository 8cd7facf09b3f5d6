"""Port parity: the free-point (wand) fleet.

The pose-free free-point chain (Projection + Extrinsic3D + FreePoint, b =
0) through ``run_fleet_bundle_adjustment``, float64 on the CPU:

- three wand rigs (``tests/test_torch_freepoint.py``'s z = 0-safe set-up
  at three seeds: 3 cameras, one image of a 7 x 7 grid, the wand's gauge)
  in both packages' fleets, rig by rig: the same nit, nfev and status, the
  cost within 1e-9 relative, x and the cameras within 1e-8 of their scale;
  with the image bucket of 8 (the fused family: Kernel C's wrapper) and
  with none (the per-block one: Kernel D's);
- the free-point wrappers under ``torch.func.vmap`` over three rigs go
  through their operators' vmap rules (one call of the plain twin for
  three rigs here, one launch on a card) and give each rig the bits of its
  own call;
- ``problems.fleet_handlers("freepoint", ...)``: the image grid counts
  ``detection.max_ims`` (as the JAX fleet's, with and without the bucket),
  the step runners (a card's CUDA graphs, uncaptured here) give the host
  loop's bits, the rigs converge at the noise, and rigs of other image
  counts (other key counts) raise ``FleetMismatch``.
"""
import numpy as np
import pytest
import torch

from pycamset_tpu.models.camera_set import CameraSet as JCameraSet
from pycamset_tpu.models.camera_set import make_cam_dict
from pycamset_tpu.models.detections import TargetDetection as JDetection
from pycamset_tpu.optim import handlers as jh
from pycamset_tpu.optim.fleet import run_fleet_bundle_adjustment as jax_fleet
from pycamset_tpu.utils.general_utils import make_4x4h_tform
from pycamset_tpu.utils.synthetic import make_synthetic_rig
from pycamset_tpu_torch import problems
from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
from pycamset_tpu_torch.optim.fleet import (FleetMismatch,
                                            build_fleet_problem, fleet_solve,
                                            run_fleet_bundle_adjustment)
from test_torch_fleet_handlers import _assert_same_rigs
from test_torch_freepoint import _port_of

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)

WAND_SEEDS = (31, 37, 41)


def _jax_wand(seed, options):
    """``test_torch_freepoint._jax_wand_handler``'s set-up with the rig's
    seed ``seed`` and its noise, start and motion seeds offset by it."""
    rig = make_synthetic_rig(n_cams=3, n_ims=1, grid=7, visibility=1.0,
                             noise_px=0.1, seed=seed)
    names = ["a", "b", "c"]
    exts = [make_4x4h_tform(e[:3], e[3:]) for e in rig["extr"]]
    exts[0] = np.eye(4)
    kmats = [np.array([[i9[0], 0, i9[1]], [0, i9[2], i9[3]], [0, 0, 1]])
             for i9 in rig["intr"]]
    cams = JCameraSet(camera_dict=make_cam_dict(
        names, exts, kmats, [i9[4:] for i9 in rig["intr"]],
        [[1600, 1200]] * 3))
    world = rig["template"] + [0.0, 0.0, 1.0]
    dd = rig["dd"].copy()
    for c in range(3):
        rows = dd[:, 0] == c
        dd[rows, 3:5] = cams[c].project_points(world[dd[rows, 2].astype(int)])
    dd[:, 3:5] += np.random.default_rng(seed + 2).normal(
        size=(len(dd), 2)) * 0.2
    pts0 = world + np.random.default_rng(seed + 1).normal(
        size=world.shape) * 1e-3
    start = [e @ make_4x4h_tform(d[:3], d[3:]) for e, d in zip(
        exts, np.random.default_rng(seed + 5).normal(size=(3, 6)) * 1e-2)]
    start[0] = np.eye(4)
    for name, e in zip(names, start):
        cams[name].extrinsic = e
        cams[name]._update_state()
    fixed = {n: {"int": np.asarray(cams[n].intrinsic, dtype=float),
                 "dst": np.ravel(cams[n].distortion_coefs)} for n in names}
    fixed[names[0]]["ext"] = np.eye(4)
    handler = jh.FreePointBundleHandler(
        cams, jh.FreePointTarget(pts0.reshape(1, -1, 3)),
        JDetection(cam_names=names, data=dd), fixed_params=fixed,
        options={"outliers": "n", "verbosity": 0, **options})
    pin = int(np.argmax(np.abs(pts0.reshape(-1))))
    handler.feat_unfixed[pin] = False
    handler.bundlePrimitive.calc_free_poses()
    return handler, pin


@pytest.mark.parametrize("im_bucket", [8, None], ids=["fused", "per_block"])
def test_freepoint_fleet_matches_jax_rig_by_rig(im_bucket):
    options = {"im_bucket": im_bucket}
    jhs, phs = [], []
    for seed in WAND_SEEDS:
        jhandler, pin = _jax_wand(seed, options)
        port = _port_of(jhandler, pin, options)
        # the same start to Rodrigues' rounding (OpenCV there, numpy
        # here): both fleets start from the JAX one
        port.set_initial_params(np.array(jhandler.get_initial_params()))
        jhs.append(jhandler)
        phs.append(port)
    jax_out = jax_fleet(jhs)
    launches = (sg.freepoint_gram_fused.launches,
                sg.freepoint_gram.launches)
    port_out = run_fleet_bundle_adjustment(phs, device="cpu")
    _assert_same_rigs(jax_out, port_out)
    assert all(r.status in (1, 2) for r in port_out[0])
    # CPU tensors: the plain twins, no launch
    assert (sg.freepoint_gram_fused.launches,
            sg.freepoint_gram.launches) == launches


def _rig_inputs(n_rigs=3, n_cams=2, n_ims=4):
    """Per-rig wrapper inputs of ``problems.freepoint_problem`` at three
    seeds (grid 4, keys padded to 8 an image), the cameras moved by 1e-3."""
    rigs = []
    for r in range(n_rigs):
        prob = problems.freepoint_problem(n_cams, n_ims, "cpu", grid=4,
                                          seed=r, k_pad_multiple=8)
        cam = prob.x0.cam + torch.tensor(np.random.default_rng(r).normal(
            size=(n_cams, 15)) * np.r_[np.zeros(9), np.full(6, 1e-3)])
        rigs.append(dict(
            cam_b=torch.repeat_interleave(cam, n_ims, dim=0),
            keyp=prob.x0.key, uv=prob.uv, mask=prob.mask,
            cmask_b=torch.repeat_interleave(prob.colmask.cam, n_ims, dim=0),
            kmask=prob.colmask.key))
    return {k: torch.stack([r[k] for r in rigs]) for k in rigs[0]}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_block"])
def test_freepoint_wrappers_under_vmap_equal_per_rig_calls(fused,
                                                           monkeypatch):
    n_cams, n_ims = 2, 4
    f = _rig_inputs(n_cams=n_cams, n_ims=n_ims)
    kw = dict(loss="huber", f_scale=2.0, loss_semantics="observation")
    if fused:
        def one(cam_b, keyp, uv, mask, cmask_b, kmask):
            return sg.freepoint_gram_fused(cam_b, keyp, uv, mask, kmask,
                                           n_cams, n_ims, **kw)
    else:
        def one(cam_b, keyp, uv, mask, cmask_b, kmask):
            return sg.freepoint_gram(cam_b, keyp, uv, mask, cmask_b, kmask,
                                     **kw)
    calls = []
    real = sg._per_rig
    monkeypatch.setattr(sg, "_per_rig",
                        lambda n, fn: calls.append(n) or real(n, fn))
    args = [f[k] for k in ("cam_b", "keyp", "uv", "mask", "cmask_b",
                           "kmask")]
    got = torch.func.vmap(one)(*args)
    assert calls == [3]     # one operator call for the three rigs
    for r in range(3):
        for g, a in zip(got, one(*(x[r] for x in args))):
            assert torch.equal(g[r], a)


@pytest.mark.parametrize("im_bucket", [8, None], ids=["bucket8", "nobucket"])
def test_freepoint_fleet_handlers(im_bucket):
    hs = problems.fleet_handlers("freepoint", 3, 2, 3, grid=4,
                                 options={"im_bucket": im_bucket})
    prob = build_fleet_problem(hs, device="cpu")
    assert prob.n_ims_grid == (8 if im_bucket else 3)
    assert prob.x0_pieces.im.shape[1:] == (prob.n_ims_grid, 0)
    assert prob.reduced_solver == "dense" and prob.mask.shape[2] == 384
    ref = prob.solve_batch(graph=False)
    runners = {}
    got = fleet_solve(prob.neq_fn(), prob.x0_pieces, prob.data(),
                      max_nfev=prob.max_nfev, ops=prob.ops, graph=runners)
    assert (got.nit, got.nfev) == (ref.nit, ref.nfev)
    for a, b in zip([*got.x, got.cost, got.status, got.history],
                    [*ref.x, ref.cost, ref.status, ref.history]):
        assert torch.equal(a, b)
    assert all(s in (1, 2) for s in ref.status.tolist())
    assert float(prob.rms_px(ref.cost).max()) <= 0.36


def test_freepoint_rigs_of_other_image_counts_raise():
    """A wand's keys are image x stride + point: rigs of other image counts
    have other key counts, which the fleet refuses as the JAX one does."""
    hs = [problems.freepoint_handler(2, n, grid=4, seed=100 + n)[0]
          for n in (3, 4)]
    with pytest.raises(FleetMismatch, match="one calibration target"):
        build_fleet_problem(hs, device="cpu")
