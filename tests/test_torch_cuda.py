"""The CUDA kernels on a card: each against its float64 plain twin.

Kernels A and B (template chain, ``cuda_grams``, at the five camera
models' widths), Kernels C and D
(self-calibration chain, ``cuda_selfcal_grams``, and the pose-free
free-point wrappers over them) and Kernels E and F
(multi-target chains, ``cuda_mixed_grams``, at both key widths: the mixed
chain's cw = 9 and the grouped chain's cw = 6), each at the five camera
models' widths.

Imports torch and pycamset_tpu_torch only (the card's machine has no jax),
so on a card it runs without the JAX-forcing conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Without a card every test skips. Tolerance: 1e-4 of each output's max-abs
scale, and 1e-4 entry by entry in the solver's Jacobi scaling
(``cuda_grams.scaled_errors``): float32 sums of up to 2K terms per gram
entry vs float64; the free-point wrappers, where the float32 twin on the
same inputs misses that itself, within twice the twin's error. Each fused
kernel, and Kernel D, gives the same bits on a repeat launch (no float
atomics). A Brown rig of several widths runs Kernels A-D at the widest
width, its pinned columns exact zeros; a rig mixing fisheye with Brown
cameras launches no kernel. The LM step captured as a CUDA graph gives the
uncaptured step's bits on both dense-solve routes, and a capture
that cannot proceed raises. Under torch.func.vmap (the fleet) Kernels A and
B fold every rig into one launch, each rig's rows equal to its own
launch's; the fleet's captured cascade gives the uncaptured bits. The SPD
kernel with a batch axis (one block a system) is held to its float64 twin,
within twice the float32 library route's error, and to the one-system
kernel, and a fleet opted in to it launches it once a batch step. The CG
reduced solver's LM step captured gives the uncaptured bits, and its
float32 solve at 4 x 100 the float64 CPU solve's cost; the free-point
wrappers under vmap fold a wand fleet into one launch, each rig its own
launch's bits.
"""
import numpy as np
import pytest
import torch

from pycamset_tpu_torch.optim.cuda_grams import FUSED_CHUNK
from pycamset_tpu_torch.optim.cuda_mixed_grams import MIXED_CHUNK
from pycamset_tpu_torch.optim.cuda_selfcal_grams import (SELFCAL_CHUNK,
                                                         SELFCAL_CHUNK_D)

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)

TOL = 1e-4
LOSS_CASES = [("linear", "component"), ("huber", "component"),
              ("huber", "observation"), ("cauchy", "component"),
              ("cauchy", "observation"), ("soft_l1", "component"),
              ("soft_l1", "observation")]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _inputs(dev, n_cams, n_ims, grid, noise_px=3.0, n_keys=None,
            dark_cam=None):
    """Float32 per-block inputs of a perturbed rig (pose 0 exactly zero):
    the first ``n_keys`` keys only, if given; every slot of camera
    ``dark_cam`` masked, if given."""
    from pycamset_tpu_torch.problems import standard_problem
    prob = standard_problem(n_cams, n_ims, dev, torch.float32, grid=grid,
                            k_pad_multiple=8)
    rng = np.random.default_rng(0)
    uv = prob.uv + torch.as_tensor(rng.normal(size=tuple(prob.uv.shape))
                                   * noise_px, dtype=torch.float32,
                                   device=dev) * prob.mask[..., None]
    cam_b = torch.repeat_interleave(prob.x0.cam, n_ims, dim=0)
    im_b = prob.x0.im.repeat(n_cams, 1)
    k = n_keys or prob.mask.shape[1]
    mask = prob.mask[:, :k].clone()
    if dark_cam is not None:
        mask[dark_cam * n_ims:(dark_cam + 1) * n_ims] = 0.0
    return (cam_b, im_b, prob.tpl[:k].contiguous(), uv[:, :k].contiguous(),
            mask)


def _assert_close(got, ref, name):
    got, ref = got.double().cpu(), ref.double().cpu()
    assert got.shape == ref.shape, name
    assert bool(torch.isfinite(got).all()), name
    scale = float(ref.abs().max()) + 1e-30
    assert float((got - ref).abs().max()) / scale <= TOL, name


def _assert_scaled(errs: dict, name):
    """Every output within TOL in the solver's Jacobi scaling."""
    assert max(errs.values()) <= TOL, (name, errs)


# Kernels A and B take keys in tiles of 128 slots (masked slots give no
# row) and Kernel B takes FUSED_CHUNK images of one camera per thread block.
# grid 4: K = 16, one partial tile; grid 14: K = 200, a full and a partial
# tile; K 13 and 361: ragged tiles (the first keys of grids 4 and 19).
# n_ims 20 = five chunks; 1, FUSED_CHUNK - 1 and 3 < one chunk;
# FUSED_CHUNK + 1 = a chunk and one image. dark_cam: a camera whose every
# slot is masked, whose hcc/gc and per-block pieces must be exact zeros.
@pytest.mark.cuda
@pytest.mark.parametrize("n_cams,n_ims,grid,n_keys,dark_cam", [
    (4, 20, 4, None, None), (3, 3, 14, None, None), (2, 1, 6, None, None),
    (2, FUSED_CHUNK - 1, 6, None, None), (2, FUSED_CHUNK + 1, 6, None, None),
    (3, 5, 4, 13, None), (2, 3, 19, 361, None), (3, 6, 6, None, 1)])
@pytest.mark.parametrize("loss,semantics", LOSS_CASES)
def test_kernels_match_plain_twins(card, n_cams, n_ims, grid, n_keys,
                                   dark_cam, loss, semantics):
    from pycamset_tpu_torch.optim import cuda_grams as cg
    f32 = _inputs(card, n_cams, n_ims, grid, n_keys=n_keys,
                  dark_cam=dark_cam)
    f64 = tuple(x.double() for x in f32)
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    n_a, n_b = cg.template_gram.launches, cg.template_gram_fused.launches
    a_got = cg.template_gram(*f32, **kw)
    a_ref = cg.template_gram_plain(*f64, **kw)
    _assert_close(a_got, a_ref, "A")
    _assert_scaled(cg.scaled_errors(a_got, a_ref), "A")
    got = cg.template_gram_fused(*f32, n_cams, n_ims, **kw)
    ref = cg.template_gram_fused_plain(*f64, n_cams, n_ims, **kw)
    for name, g, r in zip(["hcc", "gc", "wci", "gii", "gi", "corner"], got,
                          ref):
        _assert_close(g, r, name)
    _assert_scaled(cg.scaled_errors_fused(got, ref, a_ref, n_cams, n_ims),
                   "B")
    assert torch.equal(cg.template_gram(*f32, **kw), a_got)
    for a, b in zip(cg.template_gram_fused(*f32, n_cams, n_ims, **kw), got):
        assert torch.equal(a, b)
    if dark_cam is not None:
        dark = slice(dark_cam * n_ims, (dark_cam + 1) * n_ims)
        assert not bool(a_got[dark].any())
        assert not bool(got[0][dark_cam].any())
        assert not bool(got[1][dark_cam].any())
        for piece in got[2:]:
            assert not bool(piece[dark].any())
    assert (cg.template_gram.launches, cg.template_gram_fused.launches) == (
        n_a + 2, n_b + 2)


@pytest.mark.cuda
def test_kernel_b_is_reproducible(card):
    from pycamset_tpu_torch.optim import cuda_grams as cg
    f32 = _inputs(card, 4, 20, 6)
    first = cg.template_gram_fused(*f32, 4, 20, loss="huber")
    again = cg.template_gram_fused(*f32, 4, 20, loss="huber")
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_wrappers_raise_instead_of_falling_back(card):
    from pycamset_tpu_torch.optim import cuda_grams as cg
    f32 = _inputs(card, 2, 3, 4)
    with pytest.raises(TypeError):
        cg.template_gram(*(x.double() for x in f32))
    with pytest.raises(ValueError):
        cg.template_gram(f32[0], f32[1], f32[2].cpu(), *f32[3:])
    with pytest.raises(ValueError):
        cg.template_gram_fused(*f32, 2, 4)


# Kernels A and B at the other camera models' widths (a = 18 rational, 22
# thin-prism, 24 tilted, 14 fisheye): the model's rig
# (problems.template_handler, its perturbed start) with 3 px of noise on
# the detections. grid 4: K = 16, FUSED_CHUNK + 1 images (a chunk and one
# more); grid 14: K = 200, two key tiles. Held as the free-point wrappers
# are (_assert_within_f32_floor).
CAMERA_MODELS = ("rational", "thin_prism", "tilted", "fisheye")


def _model_inputs(dev, model, n_cams, n_ims, grid, noise_px=3.0):
    from pycamset_tpu_torch.optim.structured_driver import (
        build_structured_problem)
    from pycamset_tpu_torch.problems import template_handler
    handler, _ = template_handler(n_cams, n_ims, grid=grid,
                                  camera_model=model,
                                  options={"im_bucket": None})
    prob = build_structured_problem(handler, dtype=torch.float32,
                                    device=dev, k_pad_multiple=8)[0].problem
    rng = np.random.default_rng(2)
    uv = prob.uv + torch.as_tensor(rng.normal(size=tuple(prob.uv.shape))
                                   * noise_px, dtype=torch.float32,
                                   device=dev) * prob.mask[..., None]
    return (torch.repeat_interleave(prob.x0.cam, n_ims, dim=0),
            prob.x0.im.repeat(n_cams, 1), prob.tpl, uv.contiguous(),
            prob.mask)


@pytest.mark.cuda
@pytest.mark.parametrize("model", CAMERA_MODELS)
@pytest.mark.parametrize("n_cams,n_ims,grid", [(3, FUSED_CHUNK + 1, 4),
                                               (2, 3, 14)])
@pytest.mark.parametrize("loss,semantics", [
    ("linear", "component"), ("huber", "component"),
    ("cauchy", "observation"), ("soft_l1", "observation")])
def test_camera_model_kernels_match_plain_twins(card, model, n_cams, n_ims,
                                                grid, loss, semantics):
    from pycamset_tpu_torch.optim import cuda_grams as cg
    f32 = _model_inputs(card, model, n_cams, n_ims, grid)
    a = f32[0].shape[1]
    assert a == {"rational": 18, "thin_prism": 22, "tilted": 24,
                 "fisheye": 14}[model]
    f64 = tuple(x.double() for x in f32)
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    n_a = cg.template_gram.launches_by_width[a]
    n_b = cg.template_gram_fused.launches_by_width[a]
    a_got = cg.template_gram(*f32, **kw)
    a_ref = cg.template_gram_plain(*f64, **kw)
    assert a_got.shape == (f32[0].shape[0], a + 7, a + 7)
    _assert_within_f32_floor(
        (a_got,), (a_ref,), (cg.template_gram_plain(*f32, **kw),),
        lambda g, r: cg.scaled_errors(g[0], r[0]), "A")
    got = cg.template_gram_fused(*f32, n_cams, n_ims, **kw)
    ref = cg.template_gram_fused_plain(*f64, n_cams, n_ims, **kw)
    _assert_within_f32_floor(
        got, ref, cg.template_gram_fused_plain(*f32, n_cams, n_ims, **kw),
        lambda g, r: cg.scaled_errors_fused(g, r, a_ref, n_cams, n_ims),
        "B")
    assert torch.equal(cg.template_gram(*f32, **kw), a_got)
    for x, y in zip(cg.template_gram_fused(*f32, n_cams, n_ims, **kw), got):
        assert torch.equal(x, y)
    assert (cg.template_gram.launches_by_width[a],
            cg.template_gram_fused.launches_by_width[a]) == (n_a + 2,
                                                             n_b + 2)


@pytest.mark.cuda
def test_camera_width_without_a_kernel_raises(card):
    """A heterogeneous rig's selector row (a = 16) has no kernel: the
    wrappers raise on the card, whatever its plain twin would do."""
    from pycamset_tpu_torch.optim import cuda_grams as cg
    f32 = list(_inputs(card, 2, 3, 4))
    f32[0] = torch.cat([f32[0][:, :1], f32[0]], dim=1).contiguous()
    with pytest.raises(NotImplementedError, match="make_het_grams"):
        cg.template_gram(*f32)
    with pytest.raises(NotImplementedError, match="make_het_grams"):
        cg.template_gram_fused(*f32, 2, 3)
    from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
    s32 = list(_selfcal_inputs(card, 2, 3, 4))
    for i in (0, 5):                 # cam_b and cmask_b at a = 16
        s32[i] = torch.cat([s32[i][:, :1], s32[i]], dim=1).contiguous()
    n_d, n_c = sg.selfcal_gram.launches, sg.selfcal_gram_fused.launches
    with pytest.raises(NotImplementedError, match="make_het_grams"):
        sg.selfcal_gram(*s32)
    with pytest.raises(NotImplementedError, match="make_het_grams"):
        sg.selfcal_gram_fused(*s32[:5], *s32[6:], 2, 3)
    assert (sg.selfcal_gram.launches, sg.selfcal_gram_fused.launches) == (
        n_d, n_c)
    from pycamset_tpu_torch.optim import cuda_mixed_grams as mg
    for with_key_cols in (True, False):
        m32 = list(_mixed_inputs(card, 2, 3, 4, with_key_cols))
        for i in (0, 6):             # cam_b and cmask_b at a = 16
            m32[i] = torch.cat([m32[i][:, :1], m32[i]], dim=1).contiguous()
        kw = dict(with_key_cols=with_key_cols)
        n_f, n_e = mg.mixed_gram.launches, mg.mixed_gram_fused.launches
        with pytest.raises(NotImplementedError, match="make_het_grams"):
            mg.mixed_gram(*m32, **kw)
        with pytest.raises(NotImplementedError, match="make_het_grams"):
            mg.mixed_gram_fused(*m32, 2, 3, **kw)
        assert (mg.mixed_gram.launches, mg.mixed_gram_fused.launches) == (
            n_f, n_e)


def _selfcal_inputs(dev, n_cams, n_ims, grid, start="noisy", noise_px=3.0,
                    n_keys=None, dark_cam=None, dark_key=None,
                    camera_model="standard"):
    """Float32 per-block inputs of a self-cal rig (``camera_model``'s rig
    and projection block, ``problems.selfcal_problem``), a camera column fixed
    beside the problem's own masks (pose 0, the point gauge, the pad keys).
    ``start`` "noisy": the true start with noisy detections; "perturbed":
    ``chip_smoke.py``'s start (``selfcal_inputs``: cameras, poses and free
    points moved off the truth). The first ``n_keys`` keys only, if given;
    every slot of camera ``dark_cam`` masked, and every column of key
    ``dark_key`` (its kmask row zero), if given."""
    from pycamset_tpu_torch.problems import selfcal_problem
    prob = selfcal_problem(n_cams, n_ims, dev, torch.float32, grid=grid,
                           k_pad_multiple=8, camera_model=camera_model)
    if start == "perturbed":
        from chip_smoke import selfcal_inputs
        cam_b, im_b, keyp, uv, mask, cmask_b, imask_b, kmask = (
            selfcal_inputs(prob))
    else:
        rng = np.random.default_rng(1)
        uv = prob.uv + torch.as_tensor(rng.normal(size=tuple(prob.uv.shape))
                                       * noise_px, dtype=torch.float32,
                                       device=dev) * prob.mask[..., None]
        cmask = prob.colmask.cam.clone()
        cmask[:, 3] = 0.0
        cam_b, im_b, keyp, mask, cmask_b, imask_b, kmask = (
            torch.repeat_interleave(prob.x0.cam, n_ims, dim=0),
            prob.x0.im.repeat(n_cams, 1), prob.x0.key, prob.mask,
            torch.repeat_interleave(cmask, n_ims, dim=0),
            prob.colmask.im.repeat(n_cams, 1), prob.colmask.key)
    k = n_keys or mask.shape[1]
    mask, kmask = mask[:, :k].clone(), kmask[:k].clone()
    if dark_cam is not None:
        mask[dark_cam * n_ims:(dark_cam + 1) * n_ims] = 0.0
    if dark_key is not None:
        kmask[dark_key] = 0.0
    return (cam_b, im_b, keyp[:k].contiguous(), uv[:, :k].contiguous(), mask,
            cmask_b, imask_b, kmask)


# Kernels C and D take keys in tiles of 128 slots; C takes SELFCAL_CHUNK
# images of one camera per thread block, D SELFCAL_CHUNK_D blocks. Each case
# is (n_cams, n_ims, grid, n_keys, dark_cam, dark_key). grid 5: K = 32, one
# partial tile; grid 14: K = 200, a full and a partial tile; K 13 and 361:
# ragged tiles (the first keys of grids 4 and 19). n_ims 20 and 3: several
# chunks, and less than one; n_ims 1; SELFCAL_CHUNK +- 1 images and, on one
# camera, SELFCAL_CHUNK_D +- 1 blocks: a chunk and one more, one short of a
# chunk. dark_cam: a camera whose every slot is masked (its hcc, gc and
# wck, and its blocks' pieces, exact zeros); dark_key: a key whose kmask
# row is zero (its hkk, gk and couplings exact zeros).
SELFCAL_CASES = [
    (4, 20, 5, None, None, None), (3, 3, 14, None, None, None),
    (3, 1, 6, None, None, None), (2, SELFCAL_CHUNK - 1, 6, None, None, None),
    (2, SELFCAL_CHUNK + 1, 6, None, None, None),
    (1, SELFCAL_CHUNK_D - 1, 6, None, None, None),
    (1, SELFCAL_CHUNK_D + 1, 6, None, None, None),
    (3, 5, 4, 13, None, None), (2, 3, 19, 361, None, None),
    (3, 6, 6, None, 1, 3)]

# The first two cases run at both starts, the others at the perturbed one.
# At the noisy true start gc and gi are sums that cancel close to float32's
# rounding: there the float32 plain twin itself misses TOL of their max-abs
# in three of the other cases (up to 3.8e-4 at K = 361), and the first
# port's kernels and the redesigned ones miss it in four, by the same
# amounts. tools/selfcal_f32_floor.py prints, for every case at the noisy
# start, each kernel version's errors beside the float32 twin's.
@pytest.mark.cuda
@pytest.mark.parametrize(
    "start,n_cams,n_ims,grid,n_keys,dark_cam,dark_key",
    [("noisy", *c) for c in SELFCAL_CASES[:2]]
    + [("perturbed", *c) for c in SELFCAL_CASES])
@pytest.mark.parametrize("loss,semantics", LOSS_CASES)
def test_selfcal_kernels_match_plain_twins(card, start, n_cams, n_ims, grid,
                                           n_keys, dark_cam, dark_key, loss,
                                           semantics):
    from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
    f32 = _selfcal_inputs(card, n_cams, n_ims, grid, start, n_keys=n_keys,
                          dark_cam=dark_cam, dark_key=dark_key)
    f64 = tuple(x.double() for x in f32)
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    n_c, n_d = sg.selfcal_gram_fused.launches, sg.selfcal_gram.launches
    d_got = sg.selfcal_gram(*f32, **kw)
    d_ref = sg.selfcal_gram_plain(*f64, **kw)
    for name, g, r in zip(["gram", "wck_b", "wik_b", "hkk", "gk"], d_got,
                          d_ref):
        _assert_close(g, r, name)
    _assert_scaled(sg.scaled_errors_selfcal(d_got, d_ref), "D")
    no_cmask = (*f32[:5], *f32[6:])
    c_got = sg.selfcal_gram_fused(*no_cmask, n_cams, n_ims, **kw)
    c_ref = sg.selfcal_gram_fused_plain(*(x.double() for x in no_cmask),
                                        n_cams, n_ims, **kw)
    for name, g, r in zip(["hcc", "gc", "wck", "wik", "wci", "gii", "gi",
                           "corner", "hkk", "gk"], c_got, c_ref):
        _assert_close(g, r, name)
    gram = sg.selfcal_gram_plain(*f64[:5], torch.ones_like(f64[5]),
                                 *f64[6:], **kw)[0]
    _assert_scaled(sg.scaled_errors_selfcal_fused(c_got, c_ref, gram,
                                                  n_cams, n_ims), "C")
    for a, b in zip(sg.selfcal_gram(*f32, **kw), d_got):
        assert torch.equal(a, b)
    for a, b in zip(sg.selfcal_gram_fused(*no_cmask, n_cams, n_ims, **kw),
                    c_got):
        assert torch.equal(a, b)
    if dark_cam is not None:
        dark = slice(dark_cam * n_ims, (dark_cam + 1) * n_ims)
        for piece in d_got[:3]:          # gram, wck_b, wik_b
            assert not bool(piece[dark].any())
        for piece in c_got[:3]:          # hcc, gc, wck
            assert not bool(piece[dark_cam].any())
        for piece in c_got[3:8]:         # wik, wci, gii, gi, corner
            assert not bool(piece[dark].any())
    if dark_key is not None:
        for piece in (d_got[1], d_got[2], c_got[2], c_got[3]):  # couplings
            assert not bool(piece[:, dark_key].any())
        for piece in (d_got[3], d_got[4], c_got[8], c_got[9]):  # hkk, gk
            assert not bool(piece[dark_key].any())
    assert (sg.selfcal_gram_fused.launches, sg.selfcal_gram.launches) == (
        n_c + 2, n_d + 2)


# Kernels C and D at the other camera models' widths (a = 18 rational, 22
# thin-prism, 24 tilted, 14 fisheye), on the model's self-cal rig at
# chip_smoke.py's perturbed start: grid 5 (K = 32, one partial key tile)
# over SELFCAL_CHUNK + 1 images (a chunk and one more), and grid 14 (K =
# 200, two tiles) over SELFCAL_CHUNK_D + 1 blocks. Each against its float64
# twin, held as the camera-model A/B test holds them
# (_assert_within_f32_floor), and the free-point wrappers over them on the
# same cameras and points; a repeat launch gives the same bits and each
# launch counts at the model's width.
@pytest.mark.cuda
@pytest.mark.parametrize("model", CAMERA_MODELS)
@pytest.mark.parametrize("n_cams,n_ims,grid", [(2, SELFCAL_CHUNK + 1, 5),
                                               (SELFCAL_CHUNK_D + 1, 1, 14)])
@pytest.mark.parametrize("loss,semantics", [
    ("linear", "component"), ("huber", "component"),
    ("cauchy", "observation"), ("soft_l1", "observation")])
def test_selfcal_camera_model_kernels_match_plain_twins(
        card, model, n_cams, n_ims, grid, loss, semantics):
    from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
    f32 = _selfcal_inputs(card, n_cams, n_ims, grid, "perturbed",
                          camera_model=model)
    a = f32[0].shape[1]
    assert a == {"rational": 18, "thin_prism": 22, "tilted": 24,
                 "fisheye": 14}[model]
    f64 = tuple(x.double() for x in f32)
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    counted = (sg.selfcal_gram, sg.selfcal_gram_fused, sg.freepoint_gram,
               sg.freepoint_gram_fused)
    before = [fn.launches_by_width[a] for fn in counted]
    d_got = sg.selfcal_gram(*f32, **kw)
    assert d_got[0].shape == (f32[0].shape[0], a + 7, a + 7)
    assert d_got[1].shape[2:] == (a, 3)
    _assert_within_f32_floor(d_got, sg.selfcal_gram_plain(*f64, **kw),
                             sg.selfcal_gram_plain(*f32, **kw),
                             sg.scaled_errors_selfcal, "D")
    no_cmask = (*f32[:5], *f32[6:])
    c_got = sg.selfcal_gram_fused(*no_cmask, n_cams, n_ims, **kw)
    gram = sg.selfcal_gram_plain(*f64[:5], torch.ones_like(f64[5]),
                                 *f64[6:], **kw)[0]
    _assert_within_f32_floor(
        c_got, sg.selfcal_gram_fused_plain(*f64[:5], *f64[6:], n_cams, n_ims,
                                           **kw),
        sg.selfcal_gram_fused_plain(*no_cmask, n_cams, n_ims, **kw),
        lambda g, r: sg.scaled_errors_selfcal_fused(g, r, gram, n_cams,
                                                    n_ims), "C")
    cam_b, _, keyp, uv, mask, cmask_b, _, kmask = f32
    fp = (cam_b, keyp, uv, mask, cmask_b, kmask)
    fp64 = tuple(x.double() for x in fp)
    _assert_within_f32_floor(
        sg.freepoint_gram(*fp, **kw), sg.freepoint_gram_plain(*fp64, **kw),
        sg.freepoint_gram_plain(*fp, **kw), sg.scaled_errors_freepoint,
        "freepoint D")
    fpc, fpc64 = fp[:4] + fp[5:], fp64[:4] + fp64[5:]
    _assert_within_f32_floor(
        sg.freepoint_gram_fused(*fpc, n_cams, n_ims, **kw),
        sg.freepoint_gram_fused_plain(*fpc64, n_cams, n_ims, **kw),
        sg.freepoint_gram_fused_plain(*fpc, n_cams, n_ims, **kw),
        lambda g, r: sg.scaled_errors_freepoint_fused(g, r, n_cams, n_ims),
        "freepoint C")
    for x, y in zip(sg.selfcal_gram(*f32, **kw), d_got):
        assert torch.equal(x, y)
    for x, y in zip(sg.selfcal_gram_fused(*no_cmask, n_cams, n_ims, **kw),
                    c_got):
        assert torch.equal(x, y)
    assert [fn.launches_by_width[a] for fn in counted] == [
        before[0] + 2, before[1] + 2, before[2] + 1, before[3] + 1]


@pytest.mark.cuda
def test_selfcal_kernels_are_reproducible(card):
    from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
    f32 = _selfcal_inputs(card, 4, 20, 6)
    no_cmask = (*f32[:5], *f32[6:])
    for run in (lambda: sg.selfcal_gram(*f32, loss="huber"),
                lambda: sg.selfcal_gram_fused(*no_cmask, 4, 20,
                                              loss="huber")):
        first, again = run(), run()
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_selfcal_wrappers_raise_instead_of_falling_back(card):
    from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
    f32 = _selfcal_inputs(card, 2, 3, 4)
    with pytest.raises(TypeError):
        sg.selfcal_gram(*(x.double() for x in f32))
    with pytest.raises(ValueError):
        sg.selfcal_gram(*f32[:7], f32[7].cpu())
    with pytest.raises(ValueError):
        sg.selfcal_gram_fused(*f32[:5], *f32[6:], 2, 4)


def _freepoint_inputs(dev, n_cams, n_ims, grid):
    """Float32 per-block inputs of ``problems.freepoint_problem`` (the
    wand's gauge; never-observed keys frozen) with the other cameras moved
    by 1e-2 more and every lens column free but one: (cam_b, keyp, uv,
    mask, cmask_b, kmask)."""
    from pycamset_tpu_torch.problems import freepoint_problem
    prob = freepoint_problem(n_cams, n_ims, dev, torch.float32, grid=grid,
                             k_pad_multiple=8)
    step = torch.as_tensor(np.random.default_rng(2).normal(
        size=(n_cams, 15)) * 1e-2, dtype=torch.float32, device=dev)
    cam = prob.x0.cam + step * prob.colmask.cam
    cmask = prob.colmask.cam.clone()
    cmask[:, :9] = 1.0
    cmask[:, 3] = 0.0
    return (torch.repeat_interleave(cam, n_ims, dim=0), prob.x0.key,
            prob.uv, prob.mask, torch.repeat_interleave(cmask, n_ims, dim=0),
            prob.colmask.key)


def _assert_within_f32_floor(got, ref, f32_twin, scaled_errors, name):
    """Every output within TOL of the float64 twin's in both measures or,
    where the float32 plain twin on the same inputs (``f32_twin``) misses
    TOL itself, within twice the twin's error: at these starts a few slots
    sit where a robust loss's weight cancels to float32's rounding, and the
    twin misses 1e-4 there as the kernel does (``chip_smoke.py``'s
    ``within_f32_floor``)."""
    def errs(out):
        rel = {i: float((g.double().cpu() - r.double().cpu()).abs().max())
               / (float(r.double().abs().max()) + 1e-30)
               for i, (g, r) in enumerate(zip(out, ref))}
        return rel, scaled_errors(out, ref)
    for g in got:
        assert bool(torch.isfinite(g).all()), name
    (rel, scaled), (rel_f, scaled_f) = errs(got), errs(f32_twin)
    for mine, floor in ((rel, rel_f), (scaled, scaled_f)):
        assert all(mine[k] <= max(TOL, 2 * floor[k]) for k in mine), (
            name, mine, floor)


# The free-point wrappers launch D (per block) and C (fused) at identity
# poses with every pose column masked, and keep the pose-free outputs.
# n_ims 1 and SELFCAL_CHUNK + 1: a partial and a ragged chunk of C;
# grid 19: 361 points an image, 368 keys a stride at k_pad_multiple 8.
@pytest.mark.cuda
@pytest.mark.parametrize("n_cams,n_ims,grid", [
    (3, 1, 6), (4, SELFCAL_CHUNK + 1, 5), (2, 3, 19)])
@pytest.mark.parametrize("loss,semantics", LOSS_CASES)
def test_freepoint_wrappers_match_plain_twins(card, n_cams, n_ims, grid,
                                              loss, semantics):
    from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
    cam_b, keyp, uv, mask, cmask, kmask = _freepoint_inputs(
        card, n_cams, n_ims, grid)
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    counts = (sg.freepoint_gram.launches, sg.freepoint_gram_fused.launches,
              sg.selfcal_gram.launches, sg.selfcal_gram_fused.launches)
    d_args = (cam_b, keyp, uv, mask, cmask, kmask)
    d_got = sg.freepoint_gram(*d_args, **kw)
    d_ref = sg.freepoint_gram_plain(*(x.double() for x in d_args), **kw)
    _assert_within_f32_floor(
        d_got, d_ref, sg.freepoint_gram_plain(*d_args, **kw),
        sg.scaled_errors_freepoint, "D")
    c_args = (cam_b, keyp, uv, mask, kmask)
    c_got = sg.freepoint_gram_fused(*c_args, n_cams, n_ims, **kw)
    c_ref = sg.freepoint_gram_fused_plain(*(x.double() for x in c_args),
                                          n_cams, n_ims, **kw)
    _assert_within_f32_floor(
        c_got, c_ref,
        sg.freepoint_gram_fused_plain(*c_args, n_cams, n_ims, **kw),
        lambda g, r: sg.scaled_errors_freepoint_fused(g, r, n_cams, n_ims),
        "C")
    # each wrapper counts its own launches, not the self-cal wrappers'
    assert (sg.freepoint_gram.launches, sg.freepoint_gram_fused.launches,
            sg.selfcal_gram.launches, sg.selfcal_gram_fused.launches) == (
        counts[0] + 1, counts[1] + 1, counts[2], counts[3])
    for a, b in zip(sg.freepoint_gram_fused(*c_args, n_cams, n_ims, **kw),
                    c_got):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_freepoint_wrappers_raise_instead_of_falling_back(card):
    from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
    cam_b, keyp, uv, mask, cmask, kmask = _freepoint_inputs(card, 2, 3, 4)
    with pytest.raises(TypeError):
        sg.freepoint_gram(cam_b.double(), keyp, uv, mask, cmask, kmask)
    with pytest.raises(ValueError):
        sg.freepoint_gram(cam_b, keyp, uv, mask, cmask, kmask.cpu())
    with pytest.raises(ValueError):
        sg.freepoint_gram_fused(cam_b, keyp, uv, mask, kmask, 2, 4)


def _mixed_inputs(dev, n_cams, n_ims, grid, with_key_cols, noise_px=3.0,
                  n_keys=None, dark_cam=None, dark_key=None,
                  camera_model="standard"):
    """Float32 per-block inputs of a multi-target rig with noisy detections
    (the mixed chain, cw = 9, or the grouped one, cw = 6; ``camera_model``'s
    rig and projection block): the group poses expanded per key, a camera
    column fixed beside the problem's own masks (pose 0, group 0, the point
    gauge, the pad keys). The first ``n_keys`` keys only, if given; every
    slot of camera ``dark_cam`` masked, and every column of key
    ``dark_key`` (its kmask row zero), if given."""
    from pycamset_tpu_torch.problems import grouped_problem, mixed_problem
    make = mixed_problem if with_key_cols else grouped_problem
    prob = make(n_cams, n_ims, dev, torch.float32, grid=grid,
                k_pad_multiple=8, camera_model=camera_model)
    rng = np.random.default_rng(2)
    uv = prob.uv + torch.as_tensor(rng.normal(size=tuple(prob.uv.shape))
                                   * noise_px, dtype=torch.float32,
                                   device=dev) * prob.mask[..., None]
    cmask = prob.colmask.cam.clone()
    cmask[:, 3] = 0.0
    keyp, kmask = prob.key_operands(prob.x0, prob.colmask)
    k = n_keys or prob.mask.shape[1]
    mask, kmask = prob.mask[:, :k].clone(), kmask[:k].clone()
    if dark_cam is not None:
        mask[dark_cam * n_ims:(dark_cam + 1) * n_ims] = 0.0
    if dark_key is not None:
        kmask[dark_key] = 0.0
    return (torch.repeat_interleave(prob.x0.cam, n_ims, dim=0),
            prob.x0.im.repeat(n_cams, 1), keyp[:k].contiguous(),
            prob.tpl[:k].contiguous(), uv[:, :k].contiguous(), mask,
            torch.repeat_interleave(cmask, n_ims, dim=0),
            prob.colmask.im.repeat(n_cams, 1), kmask)


# Kernels E and F take keys in tiles of 128 slots; E takes MIXED_CHUNK
# images of one camera per thread block, F MIXED_CHUNK_F blocks. grid 5:
# K = 32, one partial tile; grid 14: K = 200, a full and a partial tile;
# K 13 and 361: ragged tiles (the first keys of grids 4 and 19). n_ims 20 =
# two chunks of 8 and a partial one; 1, 3 and MIXED_CHUNK - 1 < one chunk;
# MIXED_CHUNK + 1 = a chunk and one image (3 x 1 blocks: F's chunk and one
# block). dark_cam: a camera whose every slot is masked (its hcc, gc and wcc
# exact zeros); dark_key: a key whose kmask row is zero (its hkk and gk
# exact zeros).
@pytest.mark.cuda
@pytest.mark.parametrize("with_key_cols", [True, False])
@pytest.mark.parametrize("n_cams,n_ims,grid,n_keys,dark_cam,dark_key", [
    (4, 20, 5, None, None, None), (3, 3, 14, None, None, None),
    (3, 1, 6, None, None, None), (2, MIXED_CHUNK - 1, 6, None, None, None),
    (2, MIXED_CHUNK + 1, 6, None, None, None), (3, 5, 4, 13, None, None),
    (2, 3, 19, 361, None, None), (3, 6, 6, None, 1, 3)])
@pytest.mark.parametrize("loss,semantics", LOSS_CASES)
def test_mixed_kernels_match_plain_twins(card, with_key_cols, n_cams, n_ims,
                                         grid, n_keys, dark_cam, dark_key,
                                         loss, semantics):
    from pycamset_tpu_torch.optim import cuda_mixed_grams as mg
    f32 = _mixed_inputs(card, n_cams, n_ims, grid, with_key_cols,
                        n_keys=n_keys, dark_cam=dark_cam, dark_key=dark_key)
    f64 = tuple(x.double() for x in f32)
    cw = 9 if with_key_cols else 6
    kw = dict(with_key_cols=with_key_cols, loss=loss, f_scale=2.0,
              loss_semantics=semantics)
    n_e, n_f = (mg.mixed_gram_fused.launches_by_cw[cw],
                mg.mixed_gram.launches_by_cw[cw])
    f_got = mg.mixed_gram(*f32, **kw)
    f_ref = mg.mixed_gram_plain(*f64, **kw)
    for name, g, r in zip(["gram", "wcc_b", "wic_b", "hkk", "gk"], f_got,
                          f_ref):
        _assert_close(g, r, name)
    _assert_scaled(mg.scaled_errors_mixed(f_got, f_ref), "F")
    e_got = mg.mixed_gram_fused(*f32, n_cams, n_ims, **kw)
    e_ref = mg.mixed_gram_fused_plain(*f64, n_cams, n_ims, **kw)
    for name, g, r in zip(["hcc", "gc", "wcc", "wic", "wci", "gii", "gi",
                           "corner", "hkk", "gk"], e_got, e_ref):
        _assert_close(g, r, name)
    _assert_scaled(mg.scaled_errors_mixed_fused(e_got, e_ref, f_ref[0],
                                                n_cams, n_ims), "E")
    for a, b in zip(mg.mixed_gram(*f32, **kw), f_got):
        assert torch.equal(a, b)
    for a, b in zip(mg.mixed_gram_fused(*f32, n_cams, n_ims, **kw), e_got):
        assert torch.equal(a, b)
    if dark_cam is not None:
        for piece in e_got[:3]:          # hcc, gc, wcc
            assert not bool(piece[dark_cam].any())
    if dark_key is not None:
        for piece in (f_got[3], f_got[4], e_got[8], e_got[9]):  # hkk, gk
            assert not bool(piece[dark_key].any())
    assert (mg.mixed_gram_fused.launches_by_cw[cw],
            mg.mixed_gram.launches_by_cw[cw]) == (n_e + 2, n_f + 2)


# Kernels E and F at the other camera models, both key widths: grid 5
# (K = 32) over MIXED_CHUNK + 1 images (a chunk and one more), and grid 14
# (K = 200, two key tiles) over 3 x 3 blocks. Each against its float64
# twin, with the per-group sums the solver builds from it, held as the
# self-cal model kernels are (_assert_within_f32_floor); a repeat launch
# gives the same bits and each launch counts at its (camera width, key
# width).
@pytest.mark.cuda
@pytest.mark.parametrize("model", CAMERA_MODELS)
@pytest.mark.parametrize("with_key_cols", [True, False])
@pytest.mark.parametrize("n_cams,n_ims,grid", [(2, MIXED_CHUNK + 1, 5),
                                               (3, 3, 14)])
@pytest.mark.parametrize("loss,semantics", [
    ("linear", "component"), ("huber", "component"),
    ("cauchy", "observation"), ("soft_l1", "observation")])
def test_mixed_camera_model_kernels_match_plain_twins(
        card, model, with_key_cols, n_cams, n_ims, grid, loss, semantics):
    from pycamset_tpu_torch.optim import cuda_mixed_grams as mg
    from pycamset_tpu_torch.problems import grouped_problem, mixed_problem
    f32 = _mixed_inputs(card, n_cams, n_ims, grid, with_key_cols,
                        camera_model=model)
    a, cw = f32[0].shape[1], 9 if with_key_cols else 6
    assert a == {"rational": 18, "thin_prism": 22, "tilted": 24,
                 "fisheye": 14}[model]
    prob = (mixed_problem if with_key_cols else grouped_problem)(
        n_cams, n_ims, card, torch.float32, grid=grid, k_pad_multiple=8,
        camera_model=model)
    oh = prob.onehot(prob.uv)
    f64 = tuple(x.double() for x in f32)
    kw = dict(with_key_cols=with_key_cols, loss=loss, f_scale=2.0,
              loss_semantics=semantics)
    before = (mg.mixed_gram.launches_by_width[(a, cw)],
              mg.mixed_gram_fused.launches_by_width[(a, cw)])
    f_got = mg.mixed_gram(*f32, **kw)
    f_ref = mg.mixed_gram_plain(*f64, **kw)
    assert f_got[0].shape == (f32[0].shape[0], a + 7, a + 7)
    assert f_got[1].shape[2:] == (a, cw)

    def f_errs(g, r):
        return {**mg.scaled_errors_mixed(g, r),
                **mg.scaled_errors_groups(g, r, oh, n_cams, n_ims)}
    _assert_within_f32_floor(f_got, f_ref, mg.mixed_gram_plain(*f32, **kw),
                             f_errs, "F")
    e_got = mg.mixed_gram_fused(*f32, n_cams, n_ims, **kw)
    e_ref = mg.mixed_gram_fused_plain(*f64, n_cams, n_ims, **kw)
    assert e_got[0].shape == (n_cams, a, a)

    def e_errs(g, r):
        return {**mg.scaled_errors_mixed_fused(g, r, f_ref[0], n_cams,
                                               n_ims),
                **mg.scaled_errors_groups(g, r, oh, n_cams, n_ims)}
    _assert_within_f32_floor(
        e_got, e_ref, mg.mixed_gram_fused_plain(*f32, n_cams, n_ims, **kw),
        e_errs, "E")
    for x, y in zip(mg.mixed_gram(*f32, **kw), f_got):
        assert torch.equal(x, y)
    for x, y in zip(mg.mixed_gram_fused(*f32, n_cams, n_ims, **kw), e_got):
        assert torch.equal(x, y)
    assert (mg.mixed_gram.launches_by_width[(a, cw)],
            mg.mixed_gram_fused.launches_by_width[(a, cw)]) == (
        before[0] + 2, before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("with_key_cols", [True, False])
def test_mixed_kernels_are_reproducible(card, with_key_cols):
    from pycamset_tpu_torch.optim import cuda_mixed_grams as mg
    f32 = _mixed_inputs(card, 4, 20, 6, with_key_cols)
    kw = dict(with_key_cols=with_key_cols, loss="huber")
    for run in (lambda: mg.mixed_gram(*f32, **kw),
                lambda: mg.mixed_gram_fused(*f32, 4, 20, **kw)):
        first, again = run(), run()
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_mixed_wrappers_raise_instead_of_falling_back(card):
    from pycamset_tpu_torch.optim import cuda_mixed_grams as mg
    f32 = _mixed_inputs(card, 2, 3, 4, True)
    with pytest.raises(TypeError):
        mg.mixed_gram(*(x.double() for x in f32))
    with pytest.raises(ValueError):
        mg.mixed_gram(*f32[:8], f32[8].cpu())
    with pytest.raises(ValueError):   # a cw = 9 operand as the grouped chain
        mg.mixed_gram(*f32, with_key_cols=False)
    with pytest.raises(ValueError):
        mg.mixed_gram_fused(*f32, 2, 4)


# What the device makes of C-F's first passes (pct_mixed_occupancy): at the
# other camera models the device holds at least the blocks an SM that the
# launch bounds ask for (mixed_kernels.cuh's Occupancy counts the shared
# memory), at the runtime's registers within that register cap; every key
# width of every camera width answers, and an unbuilt pair raises.
@pytest.mark.cuda
@pytest.mark.parametrize("a", [14, 15, 18, 22, 24])
@pytest.mark.parametrize("cw,fused", [(3, True), (3, False), (9, True),
                                      (9, False), (6, True), (6, False)])
def test_mixed_first_pass_occupancy(card, a, cw, fused):
    from pycamset_tpu_torch.optim import cuda_mixed_grams as mg
    occ = mg.first_pass_occupancy(a, cw, fused)
    asked = occ["launch_bound_blocks"]
    assert occ["registers"] <= 65536 // (128 * asked), occ
    assert occ["dynamic_smem_bytes"] > 0 and occ["blocks_per_sm"] >= 1, occ
    if a != 15:      # the standard model keeps the bounds it was built with
        assert occ["blocks_per_sm"] >= asked, occ
    with pytest.raises(ValueError):
        mg.first_pass_occupancy(16, cw, fused)


def _normalized_spd(n, cond, seed=0):
    """Unit-diagonal SPD of the given condition plus the production ridge
    (``tests/test_pallas_cholesky.py::_normalized_spd``, kept here because
    this file imports no jax)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    a = (q * np.logspace(0, -np.log10(cond), n)) @ q.T
    d = np.sqrt(np.diag(a))
    a_n = (a / d[:, None] / d[None, :]
           + 10 * np.finfo(np.float32).eps * np.eye(n))
    return a_n, rng.normal(size=n)


# The one-launch SPD solve against its float64 twin: float32 factor + 2
# refinement passes; the error bound is the JAX kernel test's at the same
# condition (1e-4 at 1e2, 1e-3 at 1e4, 2e-2 at 1e6). Widths: the tile edges
# (one entry; one short of, at, and one past a 64-wide tile and two) and
# the seven main-path solves' widths.
@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 64, 65, 128, 129,
                               240, 840, 852, 960, 1032, 1044])
@pytest.mark.parametrize("cond,tol", [(1e2, 1e-4), (1e4, 1e-3)])
def test_psd_solve_matches_float64_twin(card, n, cond, tol):
    from pycamset_tpu_torch.ops import cuda_cholesky as cc
    a_n, rhs = _normalized_spd(n, cond)
    a32 = torch.tensor(a_n, dtype=torch.float32, device=card)
    b32 = torch.tensor(rhs, dtype=torch.float32, device=card)
    before = cc.psd_solve_raw.launches
    x, res2, b2 = cc.psd_solve_raw(a32, b32)
    assert cc.psd_solve_raw.launches == before + 1
    x64, _, b2_64 = cc.psd_solve_raw_plain(a32.double(), b32.double())
    rel = float(torch.linalg.norm(x.double() - x64) / torch.linalg.norm(x64))
    assert rel < tol, (n, cond, rel)
    assert float(res2) <= tol ** 2 * float(b2)
    assert abs(float(b2) / float(b2_64) - 1) < 1e-6


# The kernel's diagonal path alone (one block): the inverse of a diagonal
# tile's factor after its update by the panel beside it, against the
# float64 twin on the same float32 factor buffer (the refinement of a whole
# solve partly hides an inexact factor in x and res2). 1e-4 of its max-abs:
# float32 sums of 64 + 64 terms, inverted through a tile of condition up to
# sqrt(cond). k = 14: a full tile; k = 15: the last tile of n = 1044, 20
# rows padded with the identity; k = -1: tile 0 with no update.
@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(1044, -1), (1044, 14), (1044, 15)])
@pytest.mark.parametrize("cond", [1e2, 1e4])
def test_psd_diag_tile_matches_float64_twin(card, n, k, cond):
    from pycamset_tpu_torch.ops import cuda_cholesky as cc
    a_n, _ = _normalized_spd(n, cond)
    l = cc.psd_diag_tile_scratch(
        torch.tensor(a_n, dtype=torch.float32, device=card), k)
    before = cc.psd_diag_tile.launches
    got = cc.psd_diag_tile(l, k)
    assert cc.psd_diag_tile.launches == before + 1
    ref = cc.psd_diag_tile_plain(l.double(), k)
    assert bool(torch.isfinite(got).all())
    err = float((got.double() - ref).abs().max() / ref.abs().max())
    assert err <= TOL, (n, k, cond, err)
    assert not bool(torch.triu(got, 1).any())
    assert torch.equal(cc.psd_diag_tile(l, k), got)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 1044])
def test_psd_solve_is_reproducible(card, n):
    from pycamset_tpu_torch.ops import cuda_cholesky as cc
    a_n, rhs = _normalized_spd(n, 1e3)
    a32 = torch.tensor(a_n, dtype=torch.float32, device=card)
    b32 = torch.tensor(rhs, dtype=torch.float32, device=card)
    first, again = cc.psd_solve_raw(a32, b32), cc.psd_solve_raw(a32, b32)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_psd_solve_raises_instead_of_falling_back(card):
    from pycamset_tpu_torch.ops import cuda_cholesky as cc
    a_n, rhs = _normalized_spd(64, 1e2)
    a32 = torch.tensor(a_n, dtype=torch.float32, device=card)
    b32 = torch.tensor(rhs, dtype=torch.float32, device=card)
    with pytest.raises(TypeError):
        cc.psd_solve_raw(a32.double(), b32.double())
    with pytest.raises(ValueError):
        cc.psd_solve_raw(a32, b32.cpu())
    with pytest.raises(ValueError):
        cc.psd_solve_raw(a32.T, b32)            # not contiguous
    n = cc.MAX_N + 1
    with pytest.raises(ValueError):
        cc.psd_solve_raw(torch.eye(n, device=card),
                         torch.ones(n, device=card))
    with pytest.raises(TypeError):
        cc.psd_diag_tile(a32.double(), 0)
    with pytest.raises(ValueError):
        cc.psd_diag_tile(a32, 0)              # tile 1 is past n = 64


@pytest.mark.cuda
def test_fma_probe_matches_its_twin(card):
    from pycamset_tpu_torch import peak
    x = np.random.default_rng(0).uniform(0.5, 1.0, (64, 128))
    a = torch.tensor(x, dtype=torch.float32, device=card)
    before = peak.fma_chain.launches
    got = peak.fma_chain(a, iters=256)
    assert peak.fma_chain.launches == before + 1
    ref = peak.fma_chain_plain(a.double(), iters=256)
    err = float((got.double() - ref).abs().max()) / float(ref.abs().max())
    assert err < 1024 * 2.0 ** -24    # 1024 dependent float32 operations
    with pytest.raises(TypeError):
        peak.fma_chain(a.double())


def _same_solve(a, b):
    assert (a.nit, a.nfev, int(a.status)) == (b.nit, b.nfev, int(b.status))
    assert torch.equal(a.cost, b.cost) and torch.equal(a.history, b.history)
    for p, q in zip(a.x, b.x):
        assert torch.equal(p, q)


# The LM step as one CUDA graph, owned by the problem, on both dense-solve
# routes: the solve that captures it and a warm one (every step a replay)
# give the uncaptured step's bits and fallbacks.
@pytest.mark.cuda
@pytest.mark.parametrize("route", ["library", "kernel"])
@pytest.mark.parametrize("chain", ["template", "selfcal", "mixed"])
def test_captured_solve_is_bit_identical_to_uncaptured(card, monkeypatch,
                                                       chain, route):
    from pycamset_tpu_torch import problems
    from pycamset_tpu_torch.ops import cuda_cholesky as cc
    monkeypatch.delenv("PYCAMSET_PALLAS_CHOL", raising=False)
    if route == "kernel":
        monkeypatch.setenv("PYCAMSET_PALLAS_CHOL", "1")
    make = {"template": problems.standard_problem,
            "selfcal": problems.selfcal_problem,
            "mixed": problems.mixed_problem}[chain]
    prob = make(4, 16, card, grid=6)
    cc.psd_solve.fallbacks = 0
    ref = prob.solve(graph=False)
    fell = cc.psd_solve.fallbacks
    runner = prob.graph()
    for _ in range(2):
        cc.psd_solve.fallbacks = 0
        _same_solve(prob.solve(), ref)
        assert cc.psd_solve.fallbacks == fell
        assert runner.graph is not None
    assert runner.replays >= 2 * ref.nit - 1


# The user path: a TemplateBundleHandler's problem (optim/structured_driver)
# owns its graphs as the bench problems do. Captured = uncaptured bit for
# bit, x merged on the host included; the float32 cost within 1e-4 of the
# float64 CPU solve of the same handler. 16 images need no padding (Kernel
# B); 5 pad to the bucket's 8, and 8 to the fused tile's 16 is past 5%
# (Kernel A).
@pytest.mark.cuda
@pytest.mark.parametrize("route", ["library", "kernel"])
@pytest.mark.parametrize("n_ims", [16, 5])
def test_handler_path_captured_and_against_float64(card, monkeypatch, route,
                                                   n_ims):
    from pycamset_tpu_torch.optim.structured_driver import (
        build_structured_problem)
    from pycamset_tpu_torch.problems import template_handler
    monkeypatch.delenv("PYCAMSET_PALLAS_CHOL", raising=False)
    if route == "kernel":
        monkeypatch.setenv("PYCAMSET_PALLAS_CHOL", "1")
    handler, _ = template_handler(4, n_ims, grid=6)
    solve_fn, residual_fn, x0 = build_structured_problem(handler,
                                                         device=card)
    x_ref, ref = solve_fn(x0, graph=False)
    for _ in range(2):
        x, got = solve_fn(x0)
        _same_solve(got, ref)
        assert np.array_equal(x, x_ref)
    assert solve_fn.problem.graph().graph is not None
    assert int(ref.status) in (1, 2)
    cpu_fn, _, _ = build_structured_problem(handler, device="cpu")
    _, cpu = cpu_fn(x0)
    assert abs(float(ref.cost) - float(cpu.cost)) <= 1e-4 * float(cpu.cost)
    r = residual_fn(x_ref)
    assert r.shape == (handler.detection.get_data().shape[0], 2)
    assert abs(float((r * r).sum()) - float(ref.cost)) <= (
        1e-4 * float(ref.cost))


# The fleet: R rigs under torch.func.vmap fold into ONE launch of Kernel B
# (16 images: R * C cameras) or Kernel A (12 images, where the fused rule
# declines B: R * B blocks). Each rig's rows against the float64 twin on
# that rig, and their bits against a one-rig launch on its slice.
@pytest.mark.cuda
@pytest.mark.parametrize("kernel,n_ims", [("B", 16), ("A", 12)])
@pytest.mark.parametrize("loss,semantics", LOSS_CASES)
def test_folded_kernels_match_plain_twins_per_rig(card, kernel, n_ims, loss,
                                                  semantics):
    from pycamset_tpu_torch.optim import cuda_grams as cg
    from pycamset_tpu_torch.problems import fleet_problem
    n_rigs, n_cams = 5, 3
    fleet = fleet_problem(n_rigs, n_cams, n_ims, card, grid=6)
    ops = (torch.repeat_interleave(fleet.x0.cam, n_ims, dim=1),
           fleet.x0.im.repeat(1, n_cams, 1), fleet.uv, fleet.mask)
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    tpl = fleet.tpl
    if kernel == "B":
        wrapper = cg.template_gram_fused

        def one(c, i, u, m):
            return cg.template_gram_fused(c, i, tpl, u, m, n_cams, n_ims,
                                          **kw)
    else:
        wrapper = cg.template_gram

        def one(c, i, u, m):
            return (cg.template_gram(c, i, tpl, u, m, **kw),)
    n0 = wrapper.launches
    got = torch.func.vmap(one)(*ops)
    assert wrapper.launches == n0 + 1
    for r in range(n_rigs):
        rig = tuple(x[r] for x in ops)
        rig64 = tuple(x.double() for x in rig)
        gram = cg.template_gram_plain(rig64[0], rig64[1], tpl.double(),
                                      *rig64[2:], **kw)
        rows = [g[r] for g in got]
        if kernel == "B":
            ref = cg.template_gram_fused_plain(
                rig64[0], rig64[1], tpl.double(), *rig64[2:], n_cams, n_ims,
                **kw)
            _assert_scaled(cg.scaled_errors_fused(rows, ref, gram, n_cams,
                                                  n_ims), f"B rig {r}")
        else:
            ref = (gram,)
            _assert_scaled(cg.scaled_errors(rows[0], gram), f"A rig {r}")
        for name, g, x in zip("0123456", rows, ref):
            _assert_close(g, x, f"{kernel} rig {r} output {name}")
        alone = one(*rig)
        for g, a in zip(rows, alone):
            assert torch.equal(g, a)


def _rig_batch(f32, n_rigs, key_at, seed=4):
    """R rigs' inputs from one rig's (the rig axis first): each rig's
    cameras, per-key rows and detections moved by its own noise, and its
    own key r's key mask row zero, so that a rig that read another's
    per-key data would differ. ``key_at``: the indices of the per-key
    operands (keyp, kmask; tpl, which stays shared)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, x in enumerate(f32):
        rigs = []
        for r in range(n_rigs):
            y = x.clone()
            if i == 0:                            # cam_b
                y = y + torch.as_tensor(rng.normal(size=tuple(y.shape))
                                        * 1e-4, dtype=y.dtype,
                                        device=y.device)
            elif i == key_at[0] and r:            # keyp
                y = y + torch.as_tensor(rng.normal(size=tuple(y.shape))
                                        * 1e-3, dtype=y.dtype,
                                        device=y.device)
            elif i == key_at[1]:                  # kmask
                y[r % y.shape[0]] = 0.0
            rigs.append(y)
        out.append(torch.stack(rigs))
    return out


# Kernels C, D, E and F (both key widths) under torch.func.vmap over 5 rigs:
# ONE launch of each for every rig, each rig's outputs bit for bit those
# of a one-rig launch on its slice, and within TOL of its float64 twin in
# both measures. Each rig has its own cameras, free points or group poses
# and key masks, so each rig must read its own per-key rows.
@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["C", "D", "E9", "E6", "F9", "F6"])
@pytest.mark.parametrize("loss,semantics", [("linear", "component"),
                                            ("huber", "observation")])
def test_folded_key_kernels_match_one_rig_launches(card, kernel, loss,
                                                   semantics):
    from pycamset_tpu_torch.optim import cuda_mixed_grams as mg
    from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
    n_rigs, n_cams = 5, 3
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    if kernel in ("C", "D"):
        # the perturbed start: at the noisy true start the gradients cancel
        # to float32's rounding (SELFCAL_CASES' note)
        n_ims = SELFCAL_CHUNK + 1 if kernel == "C" else SELFCAL_CHUNK_D + 1
        f32 = _selfcal_inputs(card, n_cams, n_ims, 6, start="perturbed")
        if kernel == "C":       # no cmask
            f32 = (*f32[:5], *f32[6:])
            wrapper, twin = sg.selfcal_gram_fused, sg.selfcal_gram_fused_plain
            extra, key_at = (n_cams, n_ims), (2, 6)
        else:
            wrapper, twin = sg.selfcal_gram, sg.selfcal_gram_plain
            extra, key_at = (), (2, 7)
    else:
        fused, wk = kernel[0] == "E", kernel[1] == "9"
        n_ims = MIXED_CHUNK + 1
        f32 = _mixed_inputs(card, n_cams, n_ims, 6, wk)
        wrapper = mg.mixed_gram_fused if fused else mg.mixed_gram
        twin = mg.mixed_gram_fused_plain if fused else mg.mixed_gram_plain
        extra = (n_cams, n_ims) if fused else ()
        kw["with_key_cols"] = wk
        key_at = (2, 8)
    rigs = _rig_batch(f32, n_rigs, key_at)

    def one(*x):
        return wrapper(*x, *extra, **kw)

    n0 = wrapper.launches
    got = torch.func.vmap(one)(*rigs)
    assert wrapper.launches == n0 + 1
    for r in range(n_rigs):
        rig = tuple(x[r] for x in rigs)
        rows = [g[r] for g in got]
        for g, a in zip(rows, one(*rig)):
            assert torch.equal(g, a), f"{kernel} rig {r}"
        ref = twin(*(x.double() for x in rig), *extra, **kw)
        for j, (g, x) in enumerate(zip(rows, ref)):
            _assert_close(g, x, f"{kernel} rig {r} output {j}")
        if kernel in ("D", "F9", "F6"):
            scaled = (sg.scaled_errors_selfcal if kernel == "D"
                      else mg.scaled_errors_mixed)(rows, ref)
        else:
            r64 = tuple(x.double() for x in rig)
            if kernel == "C":
                gram = sg.selfcal_gram_plain(
                    *r64[:5], torch.ones_like(r64[0]), *r64[5:], **kw)[0]
                scaled = sg.scaled_errors_selfcal_fused(rows, ref, gram,
                                                        n_cams, n_ims)
            else:
                gram = mg.mixed_gram_plain(*r64, **kw)[0]
                scaled = mg.scaled_errors_mixed_fused(rows, ref, gram,
                                                      n_cams, n_ims)
        _assert_scaled(scaled, f"{kernel} rig {r}")


# The SPD kernel with a batch axis (one block a system): each system
# against the float64 twin, within twice the float32 library route's error
# on the same system (floor 1e-6: at n = 1 both are exact), its residual
# within the rule, and against the one-system kernel system by system; at
# the fleets' widths (33: 4 cameras and one lens, tied; 60 and 168: the
# handler fleets), at 600, at the largest n whose factor the kernel keeps in
# shared memory and at one above it (the device-memory form).
def _spd_batch(n, batch, cond=1e3):
    a, b = zip(*(_normalized_spd(n, cond, seed=s) for s in range(batch)))
    return np.stack(a), np.stack(b)


def _library_x(a32, b32):
    from pycamset_tpu_torch.optim.structured import _cho_refine_solve
    return torch.stack([_cho_refine_solve(a, b) for a, b in zip(a32, b32)])


def _rel(x, ref):
    return (torch.linalg.norm(x.double() - ref, dim=-1)
            / torch.linalg.norm(ref, dim=-1))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 7, 64])
@pytest.mark.parametrize("n", [1, 33, 60, 168, 600, "smem", "smem+1"])
def test_psd_batched_matches_float64_twin(card, batch, n):
    from pycamset_tpu_torch.ops import cuda_cholesky as cc
    if isinstance(n, str):
        n = cc.batch_smem_max_n() + (n == "smem+1")
    a_n, rhs = _spd_batch(n, batch)
    a32 = torch.tensor(a_n, dtype=torch.float32, device=card)
    b32 = torch.tensor(rhs, dtype=torch.float32, device=card)
    before = cc.psd_solve_raw_batched.launches
    x, res2, b2 = cc.psd_solve_raw_batched(a32, b32)
    assert cc.psd_solve_raw_batched.launches == before + 1
    assert x.shape == (batch, n) and res2.shape == b2.shape == (batch,)
    x64, _, b2_64 = cc.psd_solve_raw_plain_batched(a32.double(),
                                                   b32.double())
    err = _rel(x, x64)
    lib_err = _rel(_library_x(a32, b32), x64)
    assert bool((err <= torch.clamp(2 * lib_err, min=1e-6)).all()), (
        n, batch, err.max(), lib_err.max())
    assert bool((res2 <= cc.RES_TOL * b2).all()), (res2 / b2).max()
    assert bool(((b2.double() / b2_64 - 1).abs() < 1e-6).all())
    one = torch.stack([cc.psd_solve_raw(a, b)[0] for a, b in zip(a32, b32)])
    both = torch.maximum(err, _rel(one, x64))
    assert bool((_rel(x, one.double()) <= torch.clamp(2 * both, min=1e-6))
                .all())
    again = cc.psd_solve_raw_batched(a32, b32)
    for p, q in zip((x, res2, b2), again):
        assert torch.equal(p, q)


@pytest.mark.cuda
def test_psd_batched_under_vmap_is_one_launch(card):
    """``psd_solve_raw`` under torch.func.vmap: one launch of the batched
    kernel, its bits; the misses counter counts no system that passes."""
    from pycamset_tpu_torch.ops import cuda_cholesky as cc
    a_n, rhs = _spd_batch(33, 5)
    a32 = torch.tensor(a_n, dtype=torch.float32, device=card)
    b32 = torch.tensor(rhs, dtype=torch.float32, device=card)
    ref = cc.psd_solve_raw_batched(a32, b32)
    cc.reset_batch_counts()
    n_one = cc.psd_solve_raw.launches
    got = torch.func.vmap(cc.psd_solve_raw)(a32, b32)
    assert cc.psd_solve_raw_batched.launches == 1
    assert cc.psd_solve_raw.launches == n_one
    for p, q in zip(got, ref):
        assert torch.equal(p, q)
    assert int(cc.batch_misses(card)) == 0
    with torch.cuda.device(card):
        assert cc.batch_misses("cuda") is cc.batch_misses(card)


@pytest.mark.cuda
def test_psd_batched_raises_instead_of_falling_back(card):
    from pycamset_tpu_torch.ops import cuda_cholesky as cc
    a_n, rhs = _spd_batch(8, 2)
    a32 = torch.tensor(a_n, dtype=torch.float32, device=card)
    b32 = torch.tensor(rhs, dtype=torch.float32, device=card)
    with pytest.raises(TypeError):
        cc.psd_solve_raw_batched(a32.double(), b32.double())
    with pytest.raises(ValueError):
        cc.psd_solve_raw_batched(a32, b32[:, :4].contiguous())
    n = cc.MAX_N + 1
    with pytest.raises(ValueError):
        cc.psd_solve_raw_batched(torch.eye(n, device=card)[None],
                                 torch.ones(1, n, device=card))


# A fleet opted in to the SPD kernel: one batched launch a batch step (each
# step solves every rig's reduced system at once), none of the one-system
# kernel, and the captured cascade gives the uncaptured bits.
@pytest.mark.cuda
def test_opt_in_fleet_takes_the_batched_kernel(card, monkeypatch):
    from pycamset_tpu_torch.ops import cuda_cholesky as cc
    from pycamset_tpu_torch.optim import cuda_grams as cg
    from pycamset_tpu_torch.problems import fleet_problem
    monkeypatch.setenv("PYCAMSET_PALLAS_CHOL", "1")
    fleet = fleet_problem(3, 2, 16, card, grid=5)
    cc.reset_batch_counts()
    n_b, n_one = cg.template_gram_fused.launches, cc.psd_solve_raw.launches
    ref = fleet.solve(graph=False)
    steps = cg.template_gram_fused.launches - n_b - 1
    assert cc.psd_solve_raw_batched.launches == steps > 0
    assert cc.psd_solve_raw.launches == n_one
    assert all(s in (1, 2) for s in ref.status.tolist())
    got = fleet.solve()
    for a, b in zip([*got.x, got.cost, got.status, got.history],
                    [*ref.x, ref.cost, ref.status, ref.history]):
        assert torch.equal(a, b)


# The fleet's cascade with its graphs (one per cohort size), owned by the
# problem: the capturing solve and a warm one give the uncaptured bits, and
# Kernel B launches once per evaluation of the batch or a cohort.
@pytest.mark.cuda
def test_captured_fleet_is_bit_identical_to_uncaptured(card, monkeypatch):
    from pycamset_tpu_torch.optim import cuda_grams as cg
    from pycamset_tpu_torch.problems import fleet_problem
    monkeypatch.delenv("PYCAMSET_PALLAS_CHOL", raising=False)
    fleet = fleet_problem(8, 3, 16, card, grid=6)
    n0 = cg.template_gram_fused.launches
    ref = fleet.solve(graph=False)
    launches = cg.template_gram_fused.launches - n0
    assert all(s in (1, 2) for s in ref.status.tolist())
    runners = fleet.graph()
    for _ in range(2):
        got = fleet.solve()
        assert (got.nit, got.nfev) == (ref.nit, ref.nfev)
        for a, b in zip([*got.x, got.cost, got.status, got.history],
                        [*ref.x, ref.cost, ref.status, ref.history]):
            assert torch.equal(a, b)
    assert sorted(runners) == [1, 4, 8]
    assert all(g.graph is not None or g.steps <= 1 for g in runners.values())
    steps = sum(g.steps for g in runners.values()) // 2
    assert launches == 1 + steps < sum(ref.nfev)


# Mixed-model rigs. A Brown rig of several widths (standard / rational /
# thin-prism in turn) runs the thin-prism chain (a = 22) with the narrower
# cameras' extra coefficients pinned by the column mask; at its handler's
# start the structured normal equations come from Kernel A (5 images: the
# fused rule declines B), B (FUSED_CHUNK * 4 images), D (self-cal, 10
# images: both tiles pad past 25%) or C (8 images), each held to the float64
# CPU twins' normal equations in the Jacobi scaling (or to twice the float32
# twin's error), every pinned column exact zeros.
MIX_MODELS = ("standard", "rational", "thin_prism")


def _mixed_model_problem(dev, chain, models, n_ims, grid=6):
    """The handler problem of a rig with one camera model a camera
    (``problems.template_handler(camera_model=models)``, no image bucket),
    on the template or, from the template start and the nominal points,
    the self-cal chain."""
    from pycamset_tpu_torch.optim.handlers import SelfBundleHandler
    from pycamset_tpu_torch.optim.structured_driver import (
        build_structured_problem)
    from pycamset_tpu_torch.problems import template_handler
    handler, _ = template_handler(len(models), n_ims, grid=grid,
                                  camera_model=list(models),
                                  options={"im_bucket": None})
    if chain == "selfcal":
        th = handler
        handler = SelfBundleHandler(th.camset, th.target, th.detection,
                                    options=dict(th.problem_opts))
        handler.set_initial_params(np.concatenate([
            th.get_initial_params(),
            th.target.point_data.reshape(-1)[handler.feat_unfixed]]))
    return handler, build_structured_problem(handler, device=dev)[0].problem


def _neq_scaled_errors(got, ref) -> dict:
    """Worst error of each NormalEq field in the Jacobi scaling of the
    reference's diagonals (a gradient entry against sqrt(diag * cost))."""
    ref = [r.double().cpu() for r in ref]
    got = [g.double().cpu() for g in got]

    def s(h):
        return torch.sqrt(torch.clamp(torch.diagonal(h, dim1=-2, dim2=-1),
                                      min=1e-300))
    sc, si, sk = s(ref[0]), s(ref[1]), s(ref[2])
    rc = float(ref[9]) ** 0.5
    scales = [sc[:, :, None] * sc[:, None], si[:, :, None] * si[:, None],
              sk[:, :, None] * sk[:, None],
              sc[:, None, :, None] * si[None, :, None, :],
              sc[:, None, :, None] * sk[None, :, None, :],
              si[:, None, :, None] * sk[None, :, None, :],
              sc * rc, si * rc, sk * rc, rc * rc]
    return {i: float(((g - r).abs() / sc_).max()) if r.numel() else 0.0
            for i, (g, r, sc_) in enumerate(zip(got, ref, scales))}


@pytest.mark.cuda
@pytest.mark.parametrize("chain,n_ims,family", [
    ("template", 5, "A"), ("template", 4 * FUSED_CHUNK, "B"),
    ("selfcal", 10, "D"), ("selfcal", 8, "C")])
@pytest.mark.parametrize("loss,semantics", [
    ("linear", "component"), ("huber", "component"),
    ("cauchy", "observation")])
def test_mixed_brown_widths_on_the_kernels(card, chain, n_ims, family, loss,
                                           semantics):
    from pycamset_tpu_torch.optim import cuda_grams as cg
    from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
    from pycamset_tpu_torch.optim.structured import (ParamPieces,
                                                     make_structured_neq)
    _, prob = _mixed_model_problem(card, chain, MIX_MODELS, n_ims)
    assert prob.widths.a == 22
    pinned = (prob.colmask.cam == 0).cpu()
    assert int(pinned.sum()) == 7 + 4            # standard 7, rational 4
    wrapper = {"A": cg.template_gram, "B": cg.template_gram_fused,
               "C": sg.selfcal_gram_fused, "D": sg.selfcal_gram}[family]
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    n_cams, n_grid = prob.blocks.n_cams, prob.blocks.n_ims
    n0 = wrapper.launches_by_width[22]
    got = make_structured_neq(prob.op_fun, prob.widths, n_cams, n_grid,
                              **kw)(prob.x0, prob.uv, prob.mask, prob.tpl,
                                    prob.colmask)
    assert wrapper.launches_by_width[22] == n0 + 1

    def on_cpu(dtype):
        def t(p):
            return ParamPieces(*(x.to("cpu", dtype) for x in p))
        return make_structured_neq(prob.op_fun, prob.widths, n_cams, n_grid,
                                   **kw)(
            t(prob.x0), prob.uv.to("cpu", dtype), prob.mask.to("cpu", dtype),
            prob.tpl.to("cpu", dtype), t(prob.colmask))
    ref, twin = on_cpu(torch.float64), on_cpu(torch.float32)

    def errs(out):
        rel = {i: float((g.double().cpu() - r).abs().max())
               / (float(r.abs().max()) + 1e-30)
               for i, (g, r) in enumerate(zip(out, ref)) if r.numel()}
        return rel, _neq_scaled_errors(out, ref)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    (rel, scaled), (rel_f, scaled_f) = errs(got), errs(twin)
    for mine, floor in ((rel, rel_f), (scaled, scaled_f)):
        assert all(mine[k] <= max(TOL, 2 * floor[k]) for k in mine), (
            family, loss, semantics, mine, floor)
    # the pinned columns: exact zeros in every camera piece
    hcc, gc, wci, wck = (x.cpu() for x in (got.hcc, got.gc, got.wci,
                                             got.wck))
    assert torch.all(gc[pinned] == 0)
    assert torch.all(hcc.transpose(1, 2)[pinned] == 0)
    assert torch.all(hcc[pinned] == 0)
    assert torch.all(wci.transpose(0, 1)[:, pinned] == 0)
    assert torch.all(wck.transpose(1, 2)[pinned] == 0)


@pytest.mark.cuda
def test_het_rig_takes_no_kernel(card):
    """A heterogeneous rig (fisheye beside standard cameras, a = 16) runs
    the plain closed form on the card, chosen by its chain: no gram
    kernel launches, and its float32 solve agrees with the float64 CPU
    solve; the captured solve gives the uncaptured bits."""
    from pycamset_tpu_torch.optim import cuda_grams as cg
    from pycamset_tpu_torch.optim import cuda_mixed_grams as mg
    from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
    from pycamset_tpu_torch.optim.structured import is_het_chain
    from pycamset_tpu_torch.optim.structured_driver import (
        build_structured_problem)
    wrappers = (cg.template_gram, cg.template_gram_fused, sg.selfcal_gram,
                sg.selfcal_gram_fused, sg.freepoint_gram,
                sg.freepoint_gram_fused, mg.mixed_gram, mg.mixed_gram_fused)
    for chain in ("template", "selfcal"):
        handler, prob = _mixed_model_problem(
            card, chain, ("fisheye", "standard") * 2, 8)
        assert is_het_chain(prob.op_fun) and prob.widths.a == 16
        before = [w.launches for w in wrappers]
        solve_fn, _, x0 = build_structured_problem(handler, device=card)
        x_ref, ref = solve_fn(x0, graph=False)
        x, got = solve_fn(x0)
        assert [w.launches for w in wrappers] == before
        _same_solve(got, ref)
        assert np.array_equal(x, x_ref)
        cpu_fn, _, _ = build_structured_problem(handler, device="cpu")
        _, cpu = cpu_fn(x0)
        assert abs(float(ref.cost) - float(cpu.cost)) <= (
            1e-4 * float(cpu.cost))


# Last in the file: a failed capture leaves the card usable, but nothing
# else should run beside it.
@pytest.mark.cuda
def test_a_capture_that_cannot_proceed_raises(card):
    from pycamset_tpu_torch.optim.structured_lm import (SLMGraph, slm_init,
                                                        slm_run)
    from pycamset_tpu_torch.problems import standard_problem
    prob = standard_problem(4, 16, card, grid=6)
    neq = prob.neq_fn()

    def syncing(p):              # a host read in the step: not capturable
        out = neq(p)
        assert float(out.cost) > 0.0
        return out

    runner = SLMGraph()
    with pytest.raises(RuntimeError):
        slm_run(syncing, slm_init(syncing, prob.x0), graph=runner)
    assert runner.graph is None and runner.steps == 2


# The matrix-free CG reduced solver inside the captured LM step (a fixed
# count of masked iterations: no host read): the capturing solve and a warm
# one give the uncaptured bits, with no dense solve.
@pytest.mark.cuda
@pytest.mark.parametrize("chain", ["template", "selfcal", "freepoint"])
def test_cg_captured_solve_is_bit_identical_to_uncaptured(card, monkeypatch,
                                                          chain):
    from pycamset_tpu_torch import problems
    from pycamset_tpu_torch.optim import structured
    monkeypatch.delenv("PYCAMSET_PALLAS_CHOL", raising=False)
    if chain == "freepoint":
        prob = problems.freepoint_problem(4, 8, card, grid=6)
    else:
        make = {"template": problems.standard_problem,
                "selfcal": problems.selfcal_problem}[chain]
        prob = make(4, 16, card, grid=6)
    prob.reduced_solver = "cg"
    dense = []
    real = structured._psd_solve
    monkeypatch.setattr(structured, "_psd_solve",
                        lambda *a: dense.append(1) or real(*a))
    ref = prob.solve(graph=False)
    runner = prob.graph()
    for _ in range(2):
        _same_solve(prob.solve(), ref)
    assert runner.graph is not None and runner.replays >= 2 * ref.nit - 1
    assert dense == [] and int(ref.status) in (1, 2)


# The user path with {"reduced_solver": "cg"} at 4 x 100: the float32 card
# solve's cost within 1e-4 of the float64 CPU solve of the same handler at
# the card solve's budget (its nfev), captured = uncaptured.
@pytest.mark.cuda
def test_cg_handler_solve_against_float64(card):
    from pycamset_tpu_torch.optim.handlers import TemplateBundleHandler
    from pycamset_tpu_torch.optim.structured_driver import (
        build_structured_problem)
    from pycamset_tpu_torch.problems import template_handler
    handler, _ = template_handler(4, 100,
                                  options={"reduced_solver": "cg"})
    solve_fn, _, x0 = build_structured_problem(handler, device=card)
    assert solve_fn.problem.reduced_solver == "cg"
    x_ref, ref = solve_fn(x0, graph=False)
    x, got = solve_fn(x0)
    _same_solve(got, ref)
    assert np.array_equal(x, x_ref) and int(ref.status) in (1, 2)
    h64 = TemplateBundleHandler(
        handler.camset, handler.target, handler.detection,
        options={**handler.problem_opts, "max_nfev": ref.nfev})
    h64.set_initial_params(x0)
    cpu_fn, _, _ = build_structured_problem(h64, device="cpu")
    cpu = cpu_fn(x0)[1]
    assert cpu_fn.problem.reduced_solver == "cg"
    assert abs(float(ref.cost) - float(cpu.cost)) <= 1e-4 * float(cpu.cost)


# The free-point wrappers under torch.func.vmap over a wand fleet's rigs
# (problems.fleet_handlers("freepoint", ...), every lens column free but
# one): ONE launch of C (16 images) or D (12, no bucket), each rig within
# TOL of its float64 twin in both measures (or twice the float32 twin's
# error where that misses TOL) and bit for bit its own one-rig launch.
@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False], ids=["C", "D"])
@pytest.mark.parametrize("loss,semantics", [("linear", "component"),
                                            ("huber", "observation")])
def test_folded_freepoint_wrappers_match_one_rig_launches(card, fused, loss,
                                                          semantics):
    from pycamset_tpu_torch.optim import cuda_selfcal_grams as sg
    from pycamset_tpu_torch.optim.fleet import build_fleet_problem
    from pycamset_tpu_torch.problems import fleet_handlers
    n_rigs, c, i = 3, 3, (16 if fused else 12)
    prob = build_fleet_problem(fleet_handlers(
        "freepoint", n_rigs, c, i, grid=6,
        options=None if fused else {"im_bucket": None}), device=card)
    x, cm = prob.x0_pieces, prob.colmask
    cmask = cm.cam.clone()
    cmask[..., :9] = 1.0
    cmask[..., 3] = 0.0
    ops = (torch.repeat_interleave(x.cam, i, dim=1), x.key, prob.uv,
           prob.mask, torch.repeat_interleave(cmask, i, dim=1), cm.key)
    kw = dict(loss=loss, f_scale=2.0, loss_semantics=semantics)
    wrapper = sg.freepoint_gram_fused if fused else sg.freepoint_gram
    twin = sg.freepoint_gram_fused_plain if fused else sg.freepoint_gram_plain

    def call(fn, cb, kp, u, m, cmb, km):
        if fused:
            return fn(cb, kp, u, m, km, c, i, **kw)
        return fn(cb, kp, u, m, cmb, km, **kw)

    def scaled(g, r):
        if fused:
            return sg.scaled_errors_freepoint_fused(g, r, c, i)
        return sg.scaled_errors_freepoint(g, r)

    n0, self0 = wrapper.launches, (sg.selfcal_gram.launches,
                                   sg.selfcal_gram_fused.launches)
    got = torch.func.vmap(lambda *y: call(wrapper, *y))(*ops)
    assert wrapper.launches == n0 + 1
    assert (sg.selfcal_gram.launches,
            sg.selfcal_gram_fused.launches) == self0
    for r in range(n_rigs):
        rig = tuple(y[r] for y in ops)
        rows = [g[r] for g in got]
        _assert_within_f32_floor(
            rows, call(twin, *(y.double() for y in rig)), call(twin, *rig),
            scaled, f"{'C' if fused else 'D'} rig {r}")
        for g, a in zip(rows, call(wrapper, *rig)):
            assert torch.equal(g, a)
