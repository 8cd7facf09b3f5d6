"""Port parity: the pose-free free-point bundle adjustment.

The chain Projection + Extrinsic3D + FreePoint (no image parameters: b = 0,
c = 3) has no kernel of its own in either package: the free-point wrappers
run the self-calibration kernels (Kernel D per block, Kernel C fused) at
identity poses. Their plain twins (what the wrappers run for CPU tensors)
are held against the JAX package's XLA closed form (``make_block_grams``)
and its free-point Pallas builders in interpret mode, with a fixed camera
column and frozen keys, under the four losses. Then the kernel family rule
at ``im_bucket`` 8 and None, the b = 0 Schur step and the structured normal
equations, ``FreePointBundleHandler`` -> ``run_bundle_adjustment`` against
the JAX package's with the wand's gauge, and ``problems.freepoint_problem``
(the problem a handler builds) against its scene's layout. All in float64 on the CPU, at 1e-9
unless stated.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycamset_tpu.models.camera_set import CameraSet as JCameraSet
from pycamset_tpu.models.camera_set import make_cam_dict
from pycamset_tpu.models.detections import TargetDetection as JDetection
from pycamset_tpu.optim import handlers as jh
from pycamset_tpu.optim import structured as js
from pycamset_tpu.optim.blocks import Extrinsic3D, FreePoint, Projection
from pycamset_tpu.optim.chain import OptimFunction
from pycamset_tpu.optim.driver import run_bundle_adjustment as jax_rba
from pycamset_tpu.utils.general_utils import make_4x4h_tform
from pycamset_tpu.utils.synthetic import make_synthetic_rig
from pycamset_tpu_torch.from_jax import (camset_from_numpy,
                                         detection_from_numpy,
                                         handler_pieces_from_numpy,
                                         pieces_from_numpy, tensor_from_numpy)
from pycamset_tpu_torch.optim import blocks as tb
from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
from pycamset_tpu_torch.optim import handlers as ph
from pycamset_tpu_torch.optim import structured as ts
from pycamset_tpu_torch.optim.chain import OptimFunction as TOptimFunction
from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
from pycamset_tpu_torch.optim.structured_driver import (
    build_structured_problem)
from pycamset_tpu_torch.problems import (freepoint_handler,
                                         freepoint_problem, freepoint_scene)
from test_torch_grams import _interp_shim

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)

NAMES = ["gcc_b", "gii_b", "wci_b", "hkk", "wck_b", "wik_b", "gc_b", "gi_b",
         "gk", "cost"]
FUSED_NAMES = ["hcc", "hkk", "wck", "gc", "gk", "cost"]
LOSS_CASES = [("linear", "component"), ("huber", "component"),
              ("cauchy", "observation"), ("soft_l1", "observation")]
WIDTHS = ts.GroupWidths(15, 0, 3)


def _op_funs():
    return (OptimFunction([Projection(), Extrinsic3D(), FreePoint()]),
            TOptimFunction([tb.Projection(), tb.Extrinsic3D(),
                            tb.FreePoint()]))


def _block_inputs(n_cams=3, n_ims=5):
    """Per-block numpy inputs of ``freepoint_scene`` at grid 5 (25 points
    an image, stride 32 at k_pad_multiple 8) at its noisy start, cameras
    moved by 1e-3 more; a camera column fixed, the problem's frozen keys
    and pinned coordinate."""
    sc = freepoint_scene(n_cams, n_ims, grid=5, seed=3, k_pad_multiple=8)
    prob = freepoint_problem(n_cams, n_ims, "cpu", grid=5, seed=3,
                             k_pad_multiple=8)
    cam = prob.x0.cam.numpy() + np.random.default_rng(4).normal(
        size=(n_cams, 15)) * np.r_[np.zeros(9), np.full(6, 1e-3)]
    bb = n_cams * n_ims
    cmask = np.repeat(prob.colmask.cam.numpy(), n_ims, axis=0)
    cmask[:, :9] = 1.0      # free lenses here: every camera column counts
    cmask[:, 3] = 0.0
    return dict(n_cams=n_cams, n_ims=n_ims, k_pad=sc["n_keys"], cam=cam,
                cam_b=np.repeat(cam, n_ims, axis=0),
                im_b=np.zeros((bb, 0)), keyp=prob.x0.key.numpy(),
                uv=prob.uv.numpy(), mask=prob.mask.numpy(), cmask=cmask,
                imask=np.zeros((bb, 0)), kmask=prob.colmask.key.numpy())


def _t(a):
    return tensor_from_numpy(a, "cpu", torch.float64)


def _assert_close(got, ref, tol, name):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    if ref.size:
        assert np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30) <= tol, name


def _jargs(d):
    return (jnp.asarray(d["cam_b"]), jnp.asarray(d["im_b"]),
            jnp.asarray(d["keyp"]), jnp.zeros((d["k_pad"], 3)),
            jnp.asarray(d["uv"]), jnp.asarray(d["mask"]),
            jnp.asarray(d["cmask"]), jnp.asarray(d["imask"]),
            jnp.asarray(d["kmask"]))


def _targs(d):
    return tuple(_t(d[k]) for k in ("cam_b", "im_b", "keyp")) + (
        torch.zeros(d["k_pad"], 3, dtype=torch.float64),) + tuple(
        _t(d[k]) for k in ("uv", "mask", "cmask", "imask", "kmask"))


@pytest.mark.parametrize("loss,semantics", LOSS_CASES)
def test_freepoint_plain_twin_matches_xla(loss, semantics):
    """The per-block builder (the wrapper over Kernel D) vs
    make_block_grams, all 10 outputs, zero-width pose fields included."""
    d = _block_inputs()
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    jop, top = _op_funs()
    ref = js.make_block_grams(jop, js.chain_widths(jop), **kw)(*_jargs(d))
    got = ts.resolve_block_grams(top, WIDTHS, **kw)(*_targs(d))
    for name, g, r in zip(NAMES, got, ref):
        _assert_close(g.numpy(), r, 1e-9, name)


@pytest.mark.parametrize("loss,semantics", LOSS_CASES)
def test_freepoint_fused_plain_twin_matches_xla(loss, semantics):
    """The fused builder (the wrapper over Kernel C) vs make_block_grams
    reduced over each camera's images."""
    d = _block_inputs(n_ims=8)
    n_cams, n_ims, k_pad = d["n_cams"], d["n_ims"], d["k_pad"]
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    jop, _ = _op_funs()
    (gcc_b, _, _, hkk, wck_b, _, gc_b, _, gk,
     cost) = js.make_block_grams(jop, js.chain_widths(jop), **kw)(*_jargs(d))
    ref = (gcc_b.reshape(n_cams, n_ims, 15, 15).sum(1), hkk,
           wck_b.reshape(n_cams, n_ims, k_pad, 15, 3).sum(1),
           gc_b.reshape(n_cams, n_ims, 15).sum(1), gk, cost)
    args = _targs(d)
    got = sg.make_cuda_freepoint_grams_fused(WIDTHS, n_cams, n_ims, **kw)(
        *args[:3], *args[4:])
    for name, g, r in zip(FUSED_NAMES, got, ref):
        _assert_close(g.numpy(), r, 1e-9, name)


@pytest.mark.parametrize("loss,semantics", [("linear", "component"),
                                            ("cauchy", "observation")])
def test_freepoint_plain_twins_match_pallas(monkeypatch, loss, semantics):
    """Both builders vs the JAX free-point Pallas builders in interpret
    mode (make_pallas_freepoint_grams over D's Pallas twin,
    make_pallas_freepoint_grams_fused over C's; the fused one at 8 images,
    tile 8, no padding)."""
    pg = _interp_shim(monkeypatch)
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    for fused in (False, True):
        d = _block_inputs(n_ims=8 if fused else 5)
        jargs, targs = _jargs(d), _targs(d)
        if fused:
            ref = pg.make_pallas_freepoint_grams_fused(
                js.GroupWidths(15, 0, 3), d["n_cams"], d["n_ims"], tile=8,
                **kw)(*jargs[:3], *jargs[4:])
            got = sg.make_cuda_freepoint_grams_fused(
                WIDTHS, d["n_cams"], d["n_ims"], **kw)(*targs[:3],
                                                       *targs[4:])
            names = FUSED_NAMES
        else:
            ref = pg.make_pallas_freepoint_grams(js.GroupWidths(15, 0, 3),
                                                 **kw)(*jargs)
            got = sg.make_cuda_freepoint_grams(WIDTHS, **kw)(*targs)
            names = NAMES
        for name, g, r in zip(names, got, ref):
            _assert_close(g.numpy(), r, 1e-9, f"{name} fused={fused}")


def test_cpu_freepoint_wrappers_run_plain_twins_and_launch_nothing():
    d = _block_inputs()
    cam_b, _, keyp, _, uv, mask, cmask, _, kmask = _targs(d)
    counts = (sg.freepoint_gram.launches, sg.freepoint_gram_fused.launches,
              sg.selfcal_gram.launches, sg.selfcal_gram_fused.launches)
    for fn in (sg.freepoint_gram, sg.freepoint_gram_fused, sg.selfcal_gram,
               sg.selfcal_gram_fused):
        fn.launches = 0
    try:
        per_block = sg.freepoint_gram(cam_b, keyp, uv, mask, cmask, kmask,
                                      loss="huber")
        fused = sg.freepoint_gram_fused(cam_b, keyp, uv, mask, kmask,
                                        d["n_cams"], d["n_ims"])
        assert (sg.freepoint_gram.launches, sg.freepoint_gram_fused.launches,
                sg.selfcal_gram.launches,
                sg.selfcal_gram_fused.launches) == (0, 0, 0, 0)
    finally:
        (sg.freepoint_gram.launches, sg.freepoint_gram_fused.launches,
         sg.selfcal_gram.launches, sg.selfcal_gram_fused.launches) = counts
    for x, y in zip(per_block, sg.freepoint_gram_plain(
            cam_b, keyp, uv, mask, cmask, kmask, loss="huber")):
        assert torch.equal(x, y)
    for x, y in zip(fused, sg.freepoint_gram_fused_plain(
            cam_b, keyp, uv, mask, kmask, d["n_cams"], d["n_ims"])):
        assert torch.equal(x, y)
    # the scaled measures read zero on the twin's own outputs and see a
    # doubled camera column
    assert max(sg.scaled_errors_freepoint(per_block, per_block).values()) == 0
    bad = list(fused)
    bad[0] = bad[0].clone()
    bad[0][:, 4, :] *= 2.0
    assert sg.scaled_errors_freepoint_fused(
        bad, fused, d["n_cams"], d["n_ims"])["hcc"] > 1e-2


def test_freepoint_widths_check():
    """The free-point builders take the five camera models' widths; a = 16
    (a heterogeneous rig's selector row) and the other chains' widths
    raise."""
    with pytest.raises(NotImplementedError, match="free-point chain"):
        sg.make_cuda_freepoint_grams(ts.GroupWidths(15, 6, 3))
    with pytest.raises(NotImplementedError, match="make_het_grams"):
        sg.make_cuda_freepoint_grams_fused(ts.GroupWidths(16, 0, 3), 2, 3)
    with pytest.raises(NotImplementedError, match="self-calibration chain"):
        sg.make_cuda_selfcal_grams(WIDTHS)
    for a in (14, 15, 18, 22, 24):
        sg.make_cuda_freepoint_grams(ts.GroupWidths(a, 0, 3))
        sg.make_cuda_freepoint_grams_fused(ts.GroupWidths(a, 0, 3), 2, 3)


@pytest.mark.parametrize("im_bucket", [8, None])
def test_kernel_family_follows_the_jax_padding_rule(im_bucket):
    """The self-cal rule (tile 16 or 8, at most 25% padding) on the
    handler's bucketed image count: with the default bucket of 8 the fused
    family always; with no bucket, 12 images take the per-block one."""
    _, top = _op_funs()
    assert ts.chain_family(top, ts.chain_widths(top)) == "freepoint"
    fused = {n: ts.resolve_fused_grams(top, WIDTHS, 2, n) is not None
             for n in (5, 12, 16, 24, 100, 104)}
    assert fused == {5: False, 12: False, 16: True, 24: True, 100: True,
                     104: True}
    for n_ims in (5, 12):
        handler, _ = freepoint_handler(2, n_ims, grid=3, k_pad_multiple=8,
                                       options={"im_bucket": im_bucket})
        fn, _, _ = build_structured_problem(handler, device="cpu",
                                            k_pad_multiple=8)
        grid = fn.problem.blocks.n_ims
        assert grid == (8 * -(-n_ims // 8) if im_bucket else n_ims)
        family = ts.resolve_fused_grams(top, WIDTHS, 2, grid)
        assert (family is not None) == bool(im_bucket), (n_ims, im_bucket)


def _neqs(n_ims, loss="linear", semantics="component"):
    """The JAX and port free-point NormalEq of one rig at the same
    parameters (a lens column fixed on camera 1)."""
    d = _block_inputs(n_ims=n_ims)
    n_cams = d["n_cams"]
    jop, top = _op_funs()
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    cm_cam = np.ones((n_cams, 15))
    cm_cam[1, 4] = 0.0
    cm_im = np.zeros((n_ims, 0))
    jneq = js.make_structured_neq(jop, js.chain_widths(jop), n_cams, n_ims,
                                  **kw)(
        js.ParamPieces(jnp.asarray(d["cam"]), jnp.zeros((n_ims, 0)),
                       jnp.asarray(d["keyp"])),
        jnp.asarray(d["uv"]), jnp.asarray(d["mask"]),
        jnp.zeros((d["k_pad"], 3)),
        js.ParamPieces(cm_cam, cm_im, d["kmask"]))
    f64 = torch.float64
    tneq = ts.make_structured_neq(top, WIDTHS, n_cams, n_ims, **kw)(
        pieces_from_numpy(d["cam"], cm_im, d["keyp"], "cpu", f64),
        _t(d["uv"]), _t(d["mask"]), torch.zeros(d["k_pad"], 3, dtype=f64),
        pieces_from_numpy(cm_cam, cm_im, d["kmask"], "cpu", f64))
    return jneq, tneq


# 5 images pad past 25% at tile 8 -> the per-block family (over Kernel D);
# 8 images pad nothing -> the fused family (over Kernel C)
@pytest.mark.parametrize("n_ims,loss,semantics", [
    (5, "linear", "component"), (8, "linear", "component"),
    (8, "huber", "observation")])
def test_make_structured_neq_freepoint_matches_jax(n_ims, loss, semantics):
    jneq, tneq = _neqs(n_ims, loss, semantics)
    for name, g, r in zip(js.NormalEq._fields, tneq, jneq):
        _assert_close(g.numpy(), r, 1e-9, name)


@pytest.mark.parametrize("n_ims", [5, 8])
def test_pose_free_schur_step_matches_jax(n_ims):
    """The b = 0 step: the points eliminated, the (C*a) camera system
    solved, a zero-width image piece."""
    jneq, tneq = _neqs(n_ims)
    jd = js.neq_diag(jneq)
    damp = [1e-3 * np.maximum(np.asarray(x), 1e-8) for x in jd]
    jsol = js.schur_solve(jneq, js.ParamPieces(*map(jnp.asarray, damp)))
    tsol = ts.schur_solve(tneq, ts.ParamPieces(*map(torch.tensor, damp)))
    assert tsol.im.shape == (n_ims, 0)
    for g, r in zip(tsol, jsol):
        _assert_close(g.numpy(), r, 1e-9, "dx")
    hdx = ts.neq_matvec(tneq, tsol)
    for h, dmp, x, gr in zip(hdx, ts.ParamPieces(*map(torch.tensor, damp)),
                             tsol, (tneq.gc, tneq.gi, tneq.gk)):
        _assert_close((h + dmp * x).numpy(), (-gr).numpy(), 1e-8, "resid")


def _jax_wand_handler(options):
    """The z = 0-safe free-point set-up of
    ``test_review_regressions.py::test_padded_key_slots_stay_finite_with_
    identity_camera`` (3 cameras, one image of a 7 x 7 grid moved to
    z = 1, camera 0 at the origin), with 0.2 px of seeded noise on the
    observations, and the wand's gauge (``calibration/wand.py:361-388``):
    every lens fixed, camera 0's extrinsic the identity, the largest start
    coordinate pinned. The rig is ``make_synthetic_rig``'s for the options'
    ``camera_model`` (standard by default)."""
    rig = make_synthetic_rig(n_cams=3, n_ims=1, grid=7, visibility=1.0,
                             noise_px=0.1, seed=31,
                             camera_model=options.get("camera_model",
                                                      "standard"))
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
    dd[:, 3:5] += np.random.default_rng(2).normal(size=(len(dd), 2)) * 0.2
    pts0 = world + np.random.default_rng(1).normal(size=world.shape) * 1e-3
    # the other cameras start moved, as the bench's start moves them
    start = [e @ make_4x4h_tform(d[:3], d[3:]) for e, d in zip(
        exts, np.random.default_rng(5).normal(size=(3, 6)) * 1e-2)]
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


def _port_of(jhandler, pin, options):
    cams = jhandler.camset
    port_cams = camset_from_numpy(
        cams.get_names(), [c.extrinsic for c in cams],
        [c.intrinsic for c in cams], [c.distortion_coefs for c in cams],
        [c.res for c in cams])
    det = jhandler.detection
    handler = ph.FreePointBundleHandler(
        port_cams, ph.FreePointTarget(jhandler.target.point_data),
        detection_from_numpy(det.cam_names, det.get_data(), det.max_ims),
        fixed_params=jhandler.fixed_params,
        options={"outliers": "n", "verbosity": 0, **options})
    handler.feat_unfixed[pin] = False
    handler.bundlePrimitive.calc_free_poses()
    return handler


@pytest.fixture(scope="module", params=[8, None], ids=["bucket8", "nobucket"])
def wand_solved(request):
    """Both packages' free-point solves; the image bucket of 8 pads the one
    image to 8 (the fused family), None keeps it (the per-block one)."""
    options = {"im_bucket": request.param}
    jhandler, pin = _jax_wand_handler(options)
    port = _port_of(jhandler, pin, options)
    x_jax = np.array(jhandler.get_initial_params())
    x_port = np.array(port.get_initial_params())
    # the same start to Rodrigues' rounding (OpenCV there, numpy here);
    # the solves start from the JAX one
    assert np.abs(x_port - x_jax).max() <= 1e-12 * np.abs(x_jax).max()
    port.set_initial_params(x_jax.copy())
    jres, jcams = jax_rba(jhandler, backend="structured")
    pres, pcams = run_bundle_adjustment(port, backend="structured",
                                        device="cpu")
    return dict(jh=jhandler, port=port, jres=jres, jcams=jcams, pres=pres,
                pcams=pcams, pin=pin, options=options)


def test_freepoint_handler_solve_matches_jax(wand_solved):
    j, p = wand_solved["jres"], wand_solved["pres"]
    assert (p.nit, p.nfev, p.status) == (j.nit, j.nfev, j.status)
    assert p.status in (1, 2)
    assert abs(p.cost - j.cost) <= 1e-9 * j.cost
    _assert_close(p.x, np.asarray(j.x), 1e-9, "x")
    _assert_close(wand_solved["port"].get_updated_points(p.x),
                  wand_solved["jh"].get_updated_points(np.asarray(j.x)),
                  1e-9, "points")
    for cj, cp in zip(wand_solved["jcams"], wand_solved["pcams"]):
        for attr in ("intrinsic", "distortion_coefs", "extrinsic"):
            _assert_close(np.asarray(getattr(cp, attr)),
                          np.asarray(getattr(cj, attr)), 1e-9, attr)
    # the gauge held: camera 0 at the identity, the pinned coordinate still
    pts = wand_solved["port"].get_updated_points(p.x).reshape(-1)
    assert np.array_equal(wand_solved["pcams"][0].extrinsic, np.eye(4))
    assert pts[wand_solved["pin"]] == (
        wand_solved["jh"].target.point_data.reshape(-1)[wand_solved["pin"]])


def test_freepoint_handler_pieces_carry_over(wand_solved):
    """The JAX handler's start and masks, carried as numpy by
    ``from_jax.handler_pieces_from_numpy``, are the port's problem's."""
    port, jhandler = wand_solved["port"], wand_solved["jh"]
    fn, _, _ = build_structured_problem(port, device="cpu")
    prob = fn.problem
    prim = jhandler.bundlePrimitive
    full = prim.base_full()
    full[prim.unfixed_full()] = np.asarray(jhandler.get_initial_params())
    start, colmask = handler_pieces_from_numpy(
        port.op_fun, full, prim.unfixed_full(), 3, 0, port.n_keys(),
        prob.blocks.n_ims, prob.mask.shape[1], "cpu", torch.float64)
    assert start.im.shape == colmask.im.shape == (prob.blocks.n_ims, 0)
    for a, b in zip(start, prob.x0):
        assert torch.equal(a, b)
    for a, b in zip(colmask, prob.colmask):
        assert torch.equal(a, b)
    # pad keys replicate key 0 and are never free
    n_keys = port.n_keys()
    assert torch.equal(prob.x0.key[n_keys:],
                       prob.x0.key[:1].expand(prob.mask.shape[1] - n_keys, 3))
    assert not prob.colmask.key[n_keys:].any()


def test_freepoint_file_loads_in_both_packages(wand_solved, tmp_path):
    from pycamset_tpu.utils.saving import load_CameraSet as jax_load
    from pycamset_tpu_torch.utils.saving import load_CameraSet
    for name, cams in (("port", wand_solved["pcams"]),
                       ("jax", wand_solved["jcams"])):
        path = tmp_path / f"{name}.camset"
        cams.save(path)
        back, jback = load_CameraSet(path), jax_load(path)
        assert isinstance(back.calibration_handler,
                          ph.FreePointBundleHandler)
        assert isinstance(jback.calibration_handler,
                          jh.FreePointBundleHandler)
        for ca, cb, cc in zip(back, jback, cams):
            for attr in ("intrinsic", "distortion_coefs", "extrinsic"):
                assert np.array_equal(np.asarray(getattr(ca, attr)),
                                      np.asarray(getattr(cc, attr)))
                assert np.array_equal(np.asarray(getattr(cb, attr)),
                                      np.asarray(getattr(cc, attr)))
        assert np.array_equal(back.calibration_params,
                              np.asarray(cams.calibration_params))


def test_freepoint_problem_is_the_handlers():
    """``problems.freepoint_problem`` is the problem ``freepoint_handler``'s
    handler builds, and it holds ``freepoint_scene``'s layout: every
    detection at block cam x n_ims + im and key im x stride + point, the
    start (the extrinsics through a Rodrigues round trip of the
    CameraSet's), the wand's gauge in the column masks, the loss options;
    and its solve converges."""
    prob = freepoint_problem(3, 8, "cpu", grid=5, k_pad_multiple=8,
                             loss="huber", f_scale=2.0)
    sc = freepoint_scene(3, 8, grid=5, k_pad_multiple=8)
    n_keys, dd = sc["n_keys"], sc["dd"]
    assert prob.blocks.n_ims == 8 and prob.x0.im.shape == (8, 0)
    assert prob.mask.shape == (24, n_keys) and prob.widths == WIDTHS
    blk = (dd[:, 0] * 8 + dd[:, 1]).astype(int)
    key = dd[:, 2].astype(int)
    assert float(prob.mask.sum()) == len(dd)
    assert bool(prob.mask[blk, key].eq(1).all())
    assert np.array_equal(prob.uv[blk, key].numpy(), dd[:, 3:5])
    cam = prob.x0.cam.numpy()
    assert np.array_equal(cam[:, :9], sc["intr"])
    assert not cam[0, 9:].any()
    assert np.abs(cam[1:, 9:] - sc["extr_start"][1:]).max() <= 1e-14
    assert np.array_equal(prob.x0.key.numpy(), sc["pts_start"])
    assert not prob.tpl.any()
    # the wand's gauge: every lens and camera 0's extrinsic fixed, the
    # pinned coordinate and the never-observed keys frozen
    cm = prob.colmask
    assert not cm.cam[:, :9].any() and not cm.cam[0].any()
    assert bool(cm.cam[1:, 9:].eq(1).all())
    assert np.array_equal(cm.key.numpy().reshape(-1),
                          sc["pts_unfixed"].astype(float))
    assert (prob.loss, prob.f_scale, prob.loss_semantics) == (
        "huber", 2.0, "component")
    ref = prob.solve()
    assert int(ref.status) in (1, 2) and prob.rms_px(ref.cost) <= 0.36
    # the seeded scene: camera 0 at the origin, every projection kept
    assert not sc["extr_true"][0].any() and sc["pin"] < 3 * sc["n_keys"]
    assert sc["seen"].reshape(8, -1)[:, 25:].sum() == 0
