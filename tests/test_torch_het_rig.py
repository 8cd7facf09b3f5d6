"""Port parity: mixed-model rigs (per-camera ``camera_model`` maps).

Two rig patterns, held against the JAX package on the CPU in float64, each
package's handlers built from the same data (the JAX package's
``make_synthetic_rig`` rig as its CameraSet and TargetDetection, carried
over as numpy):

- heterogeneous rigs, fisheye beside Brown cameras (the selector chain
  ``ProjectionHet``, rows [sel | fx px fy py | dist slots]);
- Brown models of several widths (the widest model's chain, the narrower
  cameras' extra columns pinned by the per-column intrinsic mask).

Checked: ``parse_camera_models`` on the JAX test's cases
(``tests/test_het_rig.py::test_het_model_map_validation``) and both
column masks, equal; ``project_cam_points_het``, the heterogeneous
distortion pair and ``pack_rig_intrinsics`` within 1e-12; the closed form
``analytic.block_rj_het`` against ``make_block_rj_het`` on the template,
self-calibration and free-point chains within 1e-12; ``make_structured_neq``
on each chain at the handlers' own pieces and masks within 1e-9 entry by
entry in the Jacobi scaling; the handlers' layout and PnP start bit for
bit; ``run_bundle_adjustment`` with the same ``nit``, ``nfev`` and
``status`` and the cost within 1e-9 relative (the Brown rig at a budget of
``BUDGET`` evaluations: its extra coefficients crawl through a flat valley
where the two packages' float64 roundings grow apart, ROADMAP Queue C 6;
at 20 evaluations they part by 2e-9); the self-calibration stage on a het
rig; the cameras at their own family's width; ``.camset`` files in both
packages; ``multi_cam_triangulate`` on a het set within 1e-9; and the
refusals (the tied backend ``UnsupportedChain``, as the JAX package's; the
two-target handlers and the handler fleet ``NotImplementedError``); the het
grouped chain selects no closed form (the forward-mode route,
``tests/test_torch_forward_route.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pycamset_tpu.ops.distortion as jd
import pycamset_tpu.ops.projection as jp
from pycamset_tpu.models.camera_set import CameraSet as JCameraSet
from pycamset_tpu.models.camera_set import make_cam_dict
from pycamset_tpu.models.detections import TargetDetection as JDetection
from pycamset_tpu.optim import analytic as ja
from pycamset_tpu.optim import handlers as jh
from pycamset_tpu.optim import structured as js
from pycamset_tpu.optim.driver import run_bundle_adjustment as jax_rba
from pycamset_tpu.utils.general_utils import make_4x4h_tform
from pycamset_tpu.utils.saving import load_CameraSet as jax_load
from pycamset_tpu.utils.synthetic import make_synthetic_rig
from pycamset_tpu_torch.from_jax import (camset_from_numpy,
                                         detection_from_numpy,
                                         handler_pieces_from_numpy)
from pycamset_tpu_torch.ops import distortion as td
from pycamset_tpu_torch.ops import projection as tp
from pycamset_tpu_torch.optim import analytic as ta
from pycamset_tpu_torch.optim import handlers as ph
from pycamset_tpu_torch.optim import structured as ts
from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
from pycamset_tpu_torch.optim.structured_driver import (
    build_structured_problem)
from pycamset_tpu_torch.utils.saving import load_CameraSet

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)

DIST_W = {"fisheye": 4, "standard": 5, "rational": 8, "thin_prism": 12,
          "tilted": 14}
HET = ("fisheye", "standard", "fisheye", "standard")
MIXED = ("rational", "standard", "rational")
# the Brown rigs' budget where their solves are compared (module docstring)
BUDGET = 12
F64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _close(got, ref, tol, what=""):
    got, ref = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if ref.size:
        err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-300)
        assert err <= tol, (what, err)


def _jax_rig(models, seed=11, n_ims=6, grid=6, noise=0.1,
             cls=jh.TemplateBundleHandler, options=None):
    """The JAX package's handler of a mixed-model rig (its own
    ``make_synthetic_rig``, each camera's distortion at its model's width;
    the ``camera_model`` option a {name: model} map), and the rig."""
    rig = make_synthetic_rig(n_cams=len(models), n_ims=n_ims, grid=grid,
                             visibility=0.95, noise_px=noise, seed=seed,
                             camera_model=list(models))
    names = [f"cam{c}" for c in range(len(models))]
    kmats, exts, dists = [], [], []
    for c, m in enumerate(models):
        row = rig["intr"][c]
        kmats.append(np.array([[row[0], 0, row[1]], [0, row[2], row[3]],
                               [0, 0, 1]]))
        dists.append(row[4:4 + DIST_W[m]])
        exts.append(make_4x4h_tform(rig["extr"][c][:3], rig["extr"][c][3:]))
    cams = JCameraSet(camera_dict=make_cam_dict(
        names, exts, kmats, dists, [[1600, 1200]] * len(models)))
    opts = {"outliers": "n", "camera_model": dict(zip(names, models)),
            **(options or {})}
    handler = cls(cams, jh.FreePointTarget(rig["template"].reshape(1, -1, 3)),
                  JDetection(cam_names=names, data=rig["dd"]), options=opts)
    return handler, rig


def _carry(cams):
    return camset_from_numpy(cams.get_names(), [c.extrinsic for c in cams],
                             [c.intrinsic for c in cams],
                             [c.distortion_coefs for c in cams],
                             [c.res for c in cams])


def _port(jhandler, cls=ph.TemplateBundleHandler, camset=None):
    """The port's handler of the same class on the JAX handler's data."""
    det = jhandler.detection
    return cls(camset or _carry(jhandler.camset),
               ph.FreePointTarget(jhandler.target.point_data),
               detection_from_numpy(det.cam_names, det.get_data(),
                                    det.max_ims),
               options=dict(jhandler.problem_opts))


# ------------------------------------------------------------ the model map

@pytest.mark.parametrize("opt,names", [
    ({"a": "fisheye"}, ["a", "b"]),
    ({"a": "fish", "b": "standard"}, ["a", "b"]),
    (["fisheye", "rational", "standard"], ["a", "b", "c"]),
    (["rational", "standard"], ["a", "b"]),
    (["fisheye", "fisheye"], ["a", "b"]),
    ("tilted", ["a", "b"]),
    (["standard", "thin_prism", "tilted", "fisheye"], list("abcd")),
    (["standard"], ["a", "b"])])
def test_parse_camera_models_matches_jax(opt, names):
    try:
        ref = jh.parse_camera_models(opt, names)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:20]):
            ph.parse_camera_models(opt, names)
        return
    got = ph.parse_camera_models(opt, names)
    assert got == ref
    models, het, base = got
    if base is None:
        return
    if het:
        w = jh._het_intr_width(base)
        assert ph._het_intr_width(base) == w
        assert np.array_equal(ph._het_intr_colmask(models, w),
                              jh._het_intr_colmask(models, w))
    else:
        w = jh._CAMERA_MODELS[base]
        assert np.array_equal(ph._brown_mix_colmask(models, w),
                              jh._brown_mix_colmask(models, w))


# --------------------------------------------------------------- the ops

def test_het_projection_and_distortion_match_jax():
    rng = np.random.default_rng(3)
    handler, _ = _jax_rig(("fisheye", "rational", "standard"))
    cams = handler.camset
    rows, proj_fn = tp.pack_rig_intrinsics(
        [c.intrinsic for c in cams], [c.distortion_coefs for c in cams])
    ref_rows, _ = jp.pack_rig_intrinsics(
        [c.intrinsic for c in cams], [c.distortion_coefs for c in cams])
    assert np.array_equal(rows, np.asarray(ref_rows))
    xc = rng.normal(size=(25, 3)) * [0.3, 0.3, 0.1] + [0, 0, 1.2]
    xc[0, :2] = 0.0                           # on the optical axis
    xy = rng.uniform(-0.45, 0.45, size=(25, 2))
    for row in rows:
        _close(proj_fn(_t(row), _t(xc)),
               jp.project_cam_points_het(jnp.asarray(row), jnp.asarray(xc),
                                         brown_n_dist=8), 1e-12, "proj")
        hdist = np.concatenate([row[:1], row[5:]])
        ref = np.asarray(jd.distort_normalized_het(jnp.asarray(xy),
                                                   jnp.asarray(hdist)))
        _close(td.distort_normalized_het(_t(xy), _t(hdist)), ref, 1e-12)
        _close(td.undistort_normalized_het(_t(ref), _t(hdist)),
               jd.undistort_normalized_het(jnp.asarray(ref),
                                           jnp.asarray(hdist)), 1e-12)
        kmat = np.array([[row[1], 0, row[2]], [0, row[3], row[4]],
                         [0, 0, 1]])
        uv = xy * row[[1, 3]] + row[[2, 4]]
        _close(td.undistort_pixels_het(_t(uv), _t(kmat), _t(hdist)),
               jd.undistort_pixels_het(jnp.asarray(uv), jnp.asarray(kmat),
                                       jnp.asarray(hdist)), 1e-12)


@pytest.mark.parametrize("family,bm,bnd", [
    ("template", "rational", 8), ("selfcal", "standard", 5),
    ("freepoint", "rational", 8)])
def test_het_closed_form_matches_jax(family, bm, bnd):
    """``block_rj_het`` against the JAX package's ``make_block_rj_het``
    (through ``analytic_block_rj_for_chain``) over blocks of both
    families, a = 16 (standard) or 19 (rational)."""
    from pycamset_tpu.optim.blocks import (Extrinsic3D, FreePoint,
                                           ProjectionHet, RigidTform3d,
                                           TemplatePoints)
    from pycamset_tpu.optim.chain import OptimFunction
    rng = np.random.default_rng(2)
    tail = {"template": [Extrinsic3D(), TemplatePoints()],
            "selfcal": [Extrinsic3D(), RigidTform3d(), FreePoint()],
            "freepoint": [Extrinsic3D(), FreePoint()]}[family]
    pts = rng.normal(size=(7, 3)) * 0.2
    rj = ja.analytic_block_rj_for_chain(
        OptimFunction([ProjectionHet(bm), *tail]))
    cam_b = []
    for fish in (1.0, 0.0, 1.0):
        kvec = [620, 800, 615, 600] if fish else [1500, 800, 1490, 600]
        n = 4 if fish else bnd
        dist = np.zeros(bnd)
        dist[:n] = rng.normal(size=n) * 1e-2
        extr = rng.normal(size=6) * 0.1 + [0, 0, 0, 0, 0, 1.5]
        cam_b.append(np.concatenate([[fish], kvec, dist, extr]))
    cam_b = np.array(cam_b)
    im_b = rng.normal(size=(3, 6)) * 0.1
    uv = rng.normal(size=(3, 7, 2)) * 50 + 600
    ref = jax.jit(jax.vmap(rj, in_axes=(0, 0, None, None, 0)))(
        jnp.asarray(cam_b), jnp.asarray(im_b), jnp.asarray(pts),
        jnp.asarray(pts), jnp.asarray(uv))
    got = ta.block_rj_het(family, bnd)(_t(cam_b), _t(im_b), _t(pts), _t(uv))
    for name, g, r in zip(("r", "jc", "ji", "jk"), got, ref):
        _close(g.numpy(), r, 1e-12, name)
    assert torch.all(got[1][..., 0] == 0)             # the selector column


# ------------------------------------------------- the normal equations

def _scaled_errors(got, ref) -> dict:
    """Worst |g - r| of each NormalEq field in the Jacobi scaling of the
    reference's diagonals (a gradient entry against sqrt(diag * cost));
    a pinned column's zero diagonal must come out zero."""
    ref = [np.asarray(x, dtype=float) for x in ref]
    got = [g.numpy() for g in got]
    hcc, hii, hkk = ref[:3]

    def s(h):
        return np.sqrt(np.maximum(np.diagonal(h, axis1=-2, axis2=-1),
                                  1e-300))
    sc, si, sk = s(hcc), s(hii), s(hkk)
    cost = float(ref[9])
    scales = [sc[:, :, None] * sc[:, None, :], si[:, :, None] * si[:, None],
              sk[:, :, None] * sk[:, None],
              sc[:, None, :, None] * si[None, :, None, :],
              sc[:, None, :, None] * sk[None, :, None, :],
              si[:, None, :, None] * sk[None, :, None, :],
              sc * np.sqrt(cost), si * np.sqrt(cost), sk * np.sqrt(cost),
              cost]
    names = ("hcc", "hii", "hkk", "wci", "wck", "wik", "gc", "gi", "gk",
             "cost")
    out = {}
    for name, g, r, sc_ in zip(names, got, ref, scales):
        assert g.shape == r.shape, (name, g.shape, r.shape)
        out[name] = float(np.max(np.abs(g - r) / sc_)) if r.size else 0.0
    return out


CHAIN_CLS = {"template": (jh.TemplateBundleHandler, ph.TemplateBundleHandler),
             "selfcal": (jh.SelfBundleHandler, ph.SelfBundleHandler),
             "freepoint": (jh.FreePointBundleHandler,
                           ph.FreePointBundleHandler)}


@pytest.mark.parametrize("models,opts", [
    (("fisheye", "standard", "fisheye"), {}),
    (("rational", "fisheye", "rational"), {"im_bucket": None}),
    (("rational", "standard", "standard"), {}),
    (("standard", "thin_prism", "tilted"), {"im_bucket": None})])
@pytest.mark.parametrize("chain", ["template", "selfcal", "freepoint"])
def test_make_structured_neq_matches_jax(models, opts, chain):
    """Both packages' normal equations at the port handler's own start,
    grid and column masks (the selector, a fisheye camera's pad slots and
    a narrower Brown camera's extra coefficients pinned); huber loss."""
    jcls, pcls = CHAIN_CLS[chain]
    jhandler, _ = _jax_rig(models, n_ims=6, grid=5, cls=jcls, options=opts)
    port = _port(jhandler, pcls)
    port.set_initial_params(np.asarray(jhandler.get_initial_params()))
    prob = build_structured_problem(port, dtype=F64, device="cpu")[0].problem
    het = "fisheye" in models
    assert ts.is_het_chain(prob.op_fun) == het
    assert (ts.resolve_fused_grams(prob.op_fun, prob.widths,
                                   prob.blocks.n_cams, prob.blocks.n_ims)
            is None) == (het or (chain == "template")
                         or opts.get("im_bucket", 8) is None)
    n_cams, n_ims = prob.blocks.n_cams, prob.blocks.n_ims
    kw = dict(loss="huber", f_scale=2.0, loss_semantics="component")
    got = ts.make_structured_neq(prob.op_fun, prob.widths, n_cams, n_ims,
                                 **kw)(prob.x0, prob.uv, prob.mask, prob.tpl,
                                       prob.colmask)

    def j(p):
        return js.ParamPieces(*(jnp.asarray(x.numpy()) for x in p))
    ref = jax.jit(js.make_structured_neq(
        jhandler.op_fun, js.chain_widths(jhandler.op_fun), n_cams, n_ims,
        **kw))(j(prob.x0), jnp.asarray(prob.uv.numpy()),
              jnp.asarray(prob.mask.numpy()), jnp.asarray(prob.tpl.numpy()),
              j(prob.colmask))
    errs = _scaled_errors(got, ref)
    assert max(errs.values()) <= 1e-9, errs
    # the pinned columns: exact zeros in the camera blocks
    pinned = prob.colmask.cam == 0
    assert pinned.any()
    assert torch.all(got.gc[pinned] == 0)
    assert torch.all(got.hcc.diagonal(dim1=1, dim2=2)[pinned] == 0)


# ------------------------------------------------------ handlers, solves

@functools.lru_cache(maxsize=None)
def _solved(kind: str) -> dict:
    """Both packages' template handlers of one rig ("het" or "mixed"),
    their start and solves."""
    het = kind == "het"
    models = HET if het else MIXED
    jhandler, rig = _jax_rig(models, options=None if het else {
        "max_nfev": BUDGET})
    port = _port(jhandler)
    x_jax, x_port = jhandler.get_initial_params(), port.get_initial_params()
    base = (jhandler.bundlePrimitive.base_full(),
            port.bundlePrimitive.base_full())
    jax_res, jax_cams = jax_rba(jhandler, backend="structured")
    port_res, port_cams = run_bundle_adjustment(port, backend="structured",
                                                device="cpu")
    return dict(models=models, het=het, rig=rig, jh=jhandler, port=port,
                x_jax=x_jax, x_port=x_port, base=base, jax_res=jax_res,
                jax_cams=jax_cams, port_res=port_res, port_cams=port_cams)


@pytest.fixture(params=["het", "mixed"])
def solved(request):
    return _solved(request.param)


def test_layout_and_start_bit_for_bit(solved):
    jhandler, port = solved["jh"], solved["port"]
    assert (port.camera_models, port.is_het, port.camera_model,
            port.intr_width, port.mixed_models) == (
        jhandler.camera_models, jhandler.is_het, jhandler.camera_model,
        jhandler.intr_width, jhandler.mixed_models)
    jp_, pp = jhandler.bundlePrimitive, port.bundlePrimitive
    assert np.array_equal(pp.intr_colmask, jp_.intr_colmask)
    assert np.array_equal(pp.unfixed_full(), jp_.unfixed_full())
    assert np.array_equal(*solved["base"])
    assert type(port.op_fun.blocks[0]).__name__ == type(
        jhandler.op_fun.blocks[0]).__name__
    assert port.op_fun.blocks[0].params.n == jhandler.op_fun.blocks[0].params.n
    assert np.array_equal(solved["x_jax"], solved["x_port"])
    n_ims = solved["rig"]["n_ims"]
    if solved["het"]:      # the JAX test's count: fisheye 8, Brown 9 free
        assert solved["x_port"].size == 2 * 8 + 2 * 9 + 4 * 6 + (
            n_ims - 1) * 6
    else:                  # rational 12, standard 9
        assert solved["x_port"].size == 2 * 12 + 9 + 3 * 6 + (n_ims - 1) * 6


def test_the_same_solve(solved):
    j, p = solved["jax_res"], solved["port_res"]
    assert (p.nit, p.nfev, p.status) == (j.nit, j.nfev, j.status)
    assert abs(p.cost - j.cost) <= 1e-9 * j.cost
    rms = np.sqrt(np.mean(np.asarray(p.fun) ** 2))
    assert rms < 2.0 * solved["rig"]["noise_px"]


def test_cameras_keep_their_family_width(solved):
    for m, cj, cp in zip(solved["models"], solved["jax_cams"],
                         solved["port_cams"]):
        assert np.ravel(cp.distortion_coefs).size == DIST_W[m]
        assert np.ravel(cj.distortion_coefs).size == DIST_W[m]
        for attr in ("intrinsic", "distortion_coefs", "extrinsic"):
            ref = np.asarray(getattr(cj, attr))
            assert np.abs(np.asarray(getattr(cp, attr)) - ref).max() <= (
                1e-6 * np.abs(ref).max())


def test_camset_files_both_ways(solved, tmp_path):
    for name, cams in (("port", solved["port_cams"]),
                       ("jax", solved["jax_cams"])):
        path = tmp_path / f"{name}.camset"
        cams.save(path)
        a, b = load_CameraSet(path), jax_load(path)
        assert a.get_names() == b.get_names() == cams.get_names()
        for ca, cb, m in zip(a, b, solved["models"]):
            assert np.ravel(ca.distortion_coefs).size == DIST_W[m]
            for attr in ("intrinsic", "distortion_coefs", "extrinsic"):
                assert np.array_equal(np.asarray(getattr(ca, attr)),
                                      np.asarray(getattr(cb, attr))), attr
        assert a.calibration_handler.camera_models == (
            b.calibration_handler.camera_models)
        assert a.calibration_handler.is_het == solved["het"]
        assert np.array_equal(a.calibration_params, b.calibration_params)


def test_jax_handler_pieces_carry_over(solved):
    """The JAX handler's start and masks (the column mask folded in),
    carried as numpy, are the port problem's."""
    port, jhandler = solved["port"], solved["jh"]
    prob = build_structured_problem(port, dtype=F64, device="cpu")[0].problem
    prim = jhandler.bundlePrimitive
    full = prim.base_full()
    full[prim.unfixed_full()] = np.asarray(solved["x_jax"])
    start, colmask = handler_pieces_from_numpy(
        port.op_fun, full, prim.unfixed_full(), len(port.cam_names),
        prim.poses.shape[0], port.n_keys(), prob.blocks.n_ims,
        prob.mask.shape[1], "cpu", F64)
    for a, b in zip(start, prob.x0):
        assert torch.equal(a, b)
    for a, b in zip(colmask, prob.colmask):
        assert torch.equal(a, b)


def test_het_triangulation_matches_jax():
    """``multi_cam_triangulate`` on a het CameraSet (the [sel | coefs]
    undistortion) recovers the board of image 0 as the JAX package does."""
    jhandler, rig = _jax_rig(HET, seed=5, noise=0.0)
    dd = rig["dd"]
    d0 = dd[dd[:, 1] == 0]
    ref = jhandler.camset.multi_cam_triangulate(d0)
    got = _carry(jhandler.camset).multi_cam_triangulate(d0, device="cpu")
    _close(got, ref, 1e-9)
    # the points in order of first appearance, each seen twice or more
    keys, first, counts = np.unique(d0[:, 2].astype(int), return_index=True,
                                    return_counts=True)
    keys = keys[np.argsort(first)][counts[np.argsort(first)] >= 2]
    assert np.abs(got - rig["template"][keys]).max() <= 1e-6


def test_het_selfcal_stage_matches_jax(tmp_path):
    """The self-calibration stage after the het template calibration: the
    JAX package's solved set, its file loaded by the port, warm-starts both
    packages' ``SelfBundleHandler``: the same solve."""
    solved = _solved("het")
    jcams = solved["jax_cams"]
    path = tmp_path / "template.camset"
    jcams.save(path)
    jhandler = solved["jh"]
    jsh = jh.SelfBundleHandler(jcams, jhandler.target, jhandler.detection,
                               options=dict(jhandler.problem_opts))
    jsh.set_from_templated_camset(jcams)
    psh = _port(jhandler, ph.SelfBundleHandler, load_CameraSet(path))
    psh.set_from_templated_camset(load_CameraSet(path))
    assert np.array_equal(jsh.get_initial_params(), psh.get_initial_params())
    j, jc = jax_rba(jsh, backend="structured")
    p, pc = run_bundle_adjustment(psh, backend="structured", device="cpu")
    assert (p.nit, p.nfev, p.status) == (j.nit, j.nfev, j.status)
    assert abs(p.cost - j.cost) <= 1e-9 * j.cost
    assert [np.ravel(c.distortion_coefs).size for c in pc] == [
        DIST_W[m] for m in HET]
    _close(psh.get_updated_target(p.x), jsh.get_updated_target(j.x), 1e-6)


# ------------------------------------------------------------- refusals

def test_refusals():
    from pycamset_tpu_torch.examples.extend_param_handler import (
        TwoTargetCalibrator)
    from pycamset_tpu_torch.optim.fleet import build_fleet_problem
    from pycamset_tpu_torch.problems import template_handler
    for models in (HET[:3], MIXED):
        h, _ = template_handler(3, 4, grid=5, camera_model=list(models),
                                options={"shared_intrinsics": True})
        with pytest.raises(ts.UnsupportedChain, match="fixed intrinsics"):
            run_bundle_adjustment(h, device="cpu")
        jhandler, _ = _jax_rig(models, n_ims=4, grid=5,
                               options={"shared_intrinsics": True})
        with pytest.raises(js.UnsupportedChain):
            jax_rba(jhandler, backend="structured")
        fleet = [template_handler(3, 4, grid=5, seed=s,
                                  camera_model=list(models))[0]
                 for s in (0, 1)]
        with pytest.raises(NotImplementedError, match="item 7"):
            build_fleet_problem(fleet, device="cpu")
        h = fleet[0]
        with pytest.raises(NotImplementedError, match="item 7"):
            TwoTargetCalibrator(h.camset, h.target, h.target, h.detection,
                                h.detection, options=dict(h.problem_opts))
    from pycamset_tpu_torch.optim.blocks import (Extrinsic3D, ProjectionHet,
                                                 RigidTform3d)
    from pycamset_tpu_torch.optim.blocks import GroupTemplatePoints
    from pycamset_tpu_torch.optim.chain import OptimFunction
    grouped = OptimFunction([ProjectionHet("standard"), Extrinsic3D(),
                             RigidTform3d(), GroupTemplatePoints()])
    # the het grouped chain has no closed form in either package: it takes
    # the forward-mode route (tests/test_torch_forward_route.py)
    assert ts.chain_family(grouped, ts.chain_widths(grouped)) is None
    assert ts.resolve_fused_grams(grouped, ts.chain_widths(grouped), 3,
                                  8) is None
