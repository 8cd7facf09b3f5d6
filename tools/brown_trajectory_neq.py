#!/usr/bin/env python3
"""The Brown models' solves in both packages, held iterate by iterate on
the JAX package's own trajectory (CPU, float64).

    JAX_PLATFORMS=cpu python3 tools/brown_trajectory_neq.py \
        [--chain template|selfcal|mixed|grouped] [models...]

Four scenarios, each for the Brown models (rational, thin-prism, tilted by
default; every chain unless ``--chain`` names one):

- template: the 3-camera x 4-image rig of
  ``tests/test_torch_camera_models.py`` (``make_synthetic_rig(3, 4,
  grid=7, visibility=0.95, noise_px=0.2, seed=7)``) and its
  ``TemplateBundleHandler``;
- selfcal: the rig of the JAX package's rational self-calibration test
  (``tests/test_rational_model.py::test_rational_self_calibration_end_to_end``:
  ``make_synthetic_rig(3, 8, grid=5, visibility=0.95, noise_px=0.1,
  seed=5)``) and its ``SelfBundleHandler``, PnP-seeded in both packages
  (the same start bit for bit);
- mixed and grouped: the multi-target problems of
  ``tests/test_torch_camera_model_mixed.py``,
  ``problems.{mixed,grouped}_problem(3, n_ims, grid=5, camera_model=m)`` at
  8 images (the fused family, Kernel E's twin) and 6 (the per-block one,
  F's), and the JAX package's LM on the same rig, start and gauge
  (``jax_multi_target``, mirrored from ``bench.py::mixed_problem`` with
  the model's projection block; each package makes the rig with its own
  Rodrigues conversion, so the starts agree to rounding), budget 60.

For each (the multi-target chains: their ``structured_lm_solve`` in place
of the handler's ``run_bundle_adjustment``, and besides step 3 the cost
gap of both packages' solves at smaller budgets, ``[budget_gap]``):

1. the JAX package's handler solved by
   ``run_bundle_adjustment(backend="structured")`` at its default budget of
   100 evaluations, with every x its LM evaluates recorded and the normal
   equations it builds there (the script wraps ``structured_driver``'s
   ``structured_lm_solve`` for the run, feeding each evaluation to a
   ``jax.debug.callback``; nothing in either package is changed);
2. the port's ``make_structured_neq`` (its handler's problem, the same
   pieces) at each recorded x: each NormalEq field's worst error against
   the JAX one's over the trajectory, relative to the field's max-abs and
   in the solver's Jacobi scaling (an entry by sqrt(h_ii h_jj) of the
   JAX diagonals, a gradient entry by sqrt(h_ii cost), the cost
   relative); the first evaluation where a field parts by more than
   1e-12 in the Jacobi scaling; and beside it the rounding sensitivity of
   the same evaluation, the port at x against the port at
   ``np.nextafter(x, inf)`` (one ulp) in the same scaling;
3. the port's own solve at the same budget: its nit / nfev / status and
   its cost against JAX's;
4. the JAX package against itself: the solve again from
   ``np.nextafter(x0, inf)``, one ulp away, and the relative difference
   of the final costs.

Prints one line per model and step. Imports both packages (the CPU only).
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

MODELS = ("rational", "thin_prism", "tilted")
NAMES = ["a", "b", "c"]
FIELDS = ("hcc", "hii", "hkk", "wci", "wck", "wik", "gc", "gi", "gk", "cost")


MIXED_FIELDS = ("hcc", "hii", "hkk", "hgg", "wci", "wck", "wik", "wcg",
                "wig", "wkg", "gc", "gi", "gk", "gg", "cost")
# the multi-target chains' small problems: (cameras, images), grid 5
MULTI_SHAPES = ((3, 8), (3, 6))
MULTI_BUDGET = 60
BUDGETS = (10, 15, 20, 30)


def _jacobi(d):
    """sqrt of a gram diagonal; a zero (a fixed column, zero in both
    packages) scales by 1."""
    d = np.sqrt(np.maximum(d, 0.0))
    return np.where(d > 0, d, 1.0)


def _pair(s_r, s_c):
    """The (..., rows, cols) scale of a coupling block between two pieces
    of leading axes (R, n) and (C, m): (R, C, n, m)."""
    return s_r[:, None, :, None] * s_c[None, :, None, :]


def scaled_errors(got, ref, group_of_key=None) -> dict:
    """Each NormalEq (or, with ``group_of_key``, MixedNormalEq) field's
    worst error in the Jacobi scaling of ``ref`` (numpy pieces; the key
    fields where the chain has key columns)."""
    if group_of_key is None:
        hcc, hii, hkk, wci, _, _, gc, gi, _, cost = ref
        fields = FIELDS
    else:
        hcc, hii, hkk, hgg = ref[:4]
        cost = ref[-1]
        fields = MIXED_FIELDS
    s_c, s_i, s_k = (_jacobi(np.diagonal(h, axis1=1, axis2=2))
                     for h in (hcc, hii, hkk))
    root = np.sqrt(cost)
    scale = {"hcc": s_c[:, :, None] * s_c[:, None, :],
             "hii": s_i[:, :, None] * s_i[:, None, :],
             "hkk": s_k[:, :, None] * s_k[:, None, :],
             "wci": _pair(s_c, s_i), "wck": _pair(s_c, s_k),
             "wik": _pair(s_i, s_k),
             "gc": s_c * root, "gi": s_i * root, "gk": s_k * root,
             "cost": cost}
    if group_of_key is not None:
        s_g = _jacobi(np.diagonal(hgg, axis1=1, axis2=2))
        scale.update(hgg=s_g[:, :, None] * s_g[:, None, :],
                     wcg=_pair(s_c, s_g), wig=_pair(s_i, s_g),
                     wkg=s_k[:, :, None] * s_g[group_of_key][:, None, :],
                     gg=s_g * root)
    return {k: float((np.abs(np.asarray(g) - r) / scale[k]).max())
            for k, g, r in zip(fields, got, ref) if np.size(r)}


# chain -> the rig of its scenario
RIGS = {"template": dict(n_cams=3, n_ims=4, grid=7, visibility=0.95,
                         noise_px=0.2, seed=7),
        "selfcal": dict(n_cams=3, n_ims=8, grid=5, visibility=0.95,
                        noise_px=0.1, seed=5)}


def jax_handler(chain, model, rig, x0=None):
    from pycamset_tpu.models.camera_set import CameraSet, make_cam_dict
    from pycamset_tpu.models.detections import TargetDetection
    from pycamset_tpu.optim import handlers as jh
    from pycamset_tpu.utils.general_utils import make_4x4h_tform
    k = [np.array([[i[0], 0, i[1]], [0, i[2], i[3]], [0, 0, 1]])
         for i in rig["intr"]]
    ext = [make_4x4h_tform(e[:3], e[3:]) for e in rig["extr"]]
    cams = CameraSet(camera_dict=make_cam_dict(
        NAMES, ext, k, [i[4:] for i in rig["intr"]], [[1600, 1200]] * 3))
    cls = (jh.TemplateBundleHandler if chain == "template"
           else jh.SelfBundleHandler)
    h = cls(cams, jh.FreePointTarget(rig["template"].reshape(1, -1, 3)),
            TargetDetection(cam_names=NAMES, data=rig["dd"]),
            options={"outliers": "n", "camera_model": model})
    if x0 is not None:
        h.initial_params = x0
    return h


def port_handler(chain, jh):
    from pycamset_tpu_torch.from_jax import (camset_from_numpy,
                                             detection_from_numpy)
    from pycamset_tpu_torch.optim import handlers as ph
    cams = jh.camset
    cls = (ph.TemplateBundleHandler if chain == "template"
           else ph.SelfBundleHandler)
    return cls(
        camset_from_numpy(cams.get_names(), [c.extrinsic for c in cams],
                          [c.intrinsic for c in cams],
                          [c.distortion_coefs for c in cams],
                          [c.res for c in cams]),
        ph.FreePointTarget(jh.target.point_data),
        detection_from_numpy(jh.detection.cam_names, jh.detection.get_data(),
                             jh.detection.max_ims),
        options=dict(jh.problem_opts))


def recorded_jax_solve(jh):
    """The JAX solve with each evaluation's (x pieces, NormalEq) recorded,
    in evaluation order."""
    import jax

    from pycamset_tpu.optim import structured_driver as sd
    from pycamset_tpu.optim.driver import run_bundle_adjustment
    seen = []
    orig = sd.structured_lm_solve

    def spy(neq_fn, x0, **kw):
        def recorded(p):
            neq = neq_fn(p)
            jax.debug.callback(
                lambda pp, nn: seen.append((
                    [np.asarray(t) for t in pp],
                    [np.asarray(t) for t in nn])), p, neq, ordered=True)
            return neq
        return orig(recorded, x0, **kw)

    sd.structured_lm_solve = spy
    try:
        res, _ = run_bundle_adjustment(jh, backend="structured")
    finally:
        sd.structured_lm_solve = orig
    return res, seen


def jax_multi_target(chain, model, n_cams, n_ims):
    """The JAX package's side of ``problems.{mixed,grouped}_problem(n_cams,
    n_ims, grid=5, camera_model=model)`` on the CPU (float64), mirrored
    from ``bench.py::mixed_problem`` (and the grouped chain's
    ``make_structured_neq``) with the model's projection block: the same
    rig, start (the true lens, group 1 at ``GROUP_START[1]``) and gauge
    (``bench.py::mixed_colmask_groups``, its camera mask at the model's
    width). Returns (neq_fn(pieces) -> the normal equations, the start
    pieces, the LM ops: the mixed ones, or None)."""
    import jax.numpy as jnp

    import bench
    from pycamset_tpu.optim import blocks as jb
    from pycamset_tpu.optim import structured as js
    from pycamset_tpu.optim import structured_mixed as jm
    from pycamset_tpu.optim.chain import OptimFunction
    from pycamset_tpu.utils.synthetic import make_synthetic_rig
    from pycamset_tpu_torch.optim.structured import pad_template_table
    from pycamset_tpu_torch.problems import GROUP_START
    proj = {"standard": jb.Projection, "rational": jb.ProjectionRational,
            "thin_prism": jb.ProjectionThinPrism,
            "tilted": jb.ProjectionTilted,
            "fisheye": jb.ProjectionFisheye}[model]
    rig = make_synthetic_rig(n_cams=n_cams, n_ims=n_ims, grid=5,
                             visibility=0.85, noise_px=0.3, seed=5,
                             camera_model=model)
    n_keys = rig["n_keys"]
    bl = js.build_block_arrays(rig["dd"], n_cams, n_ims, n_keys)
    k_pad = bl.uv.shape[1]
    cm, gok = bench.mixed_colmask_groups(n_cams, n_ims, n_keys, k_pad,
                                         np.float64)
    cm = cm._replace(cam=np.ones((n_cams, rig["intr"].shape[1] + 6)))
    uv, mask = bl.as_device(jnp.float64)
    cam = jnp.asarray(np.concatenate([rig["intr"], rig["extr"]], 1))
    poses, grp = jnp.asarray(rig["poses"]), jnp.asarray(GROUP_START)
    if chain == "mixed":
        op_fun = OptimFunction([proj(), jb.Extrinsic3D(), jb.RigidTform3d(),
                                jb.GroupRigidTform3d(), jb.FreePoint()])
        neq = jm.make_mixed_structured_neq(
            op_fun, jm.mixed_chain_widths(op_fun), n_cams, n_ims, gok, 2)
        tpl = jnp.zeros((k_pad, 3))
        key = np.concatenate([rig["template"], np.repeat(
            rig["template"][:1], k_pad - n_keys, 0)])
        return (lambda p: neq(p, uv, mask, tpl, cm),
                jm.MixedPieces(cam, poses, jnp.asarray(key), grp),
                jm.make_mixed_ops(neq.onehot))
    op_fun = OptimFunction([proj(), jb.Extrinsic3D(), jb.RigidTform3d(),
                            jb.GroupTemplatePoints()])
    neq = js.make_structured_neq(op_fun, js.chain_widths(op_fun), n_cams,
                                 n_ims, group_of_key=gok, n_groups=2)
    tpl = jnp.asarray(pad_template_table(rig["template"], True, n_keys,
                                         k_pad))
    colmask = js.ParamPieces(cm.cam, cm.im, cm.grp)
    return (lambda p: neq(p, uv, mask, tpl, colmask),
            js.ParamPieces(cam, poses, grp), None)


def jax_lm(neq_fn, x0, ops, max_nfev, seen=None):
    """The JAX structured LM (jitted); with ``seen``, each evaluation's
    (x pieces, normal equations) appended to it in evaluation order."""
    import jax

    from pycamset_tpu.optim.structured_lm import structured_lm_solve

    def recorded(p):
        neq = neq_fn(p)
        if seen is not None:
            jax.debug.callback(
                lambda pp, nn: seen.append((
                    [np.asarray(t) for t in pp],
                    [np.asarray(t) for t in nn])), p, neq, ordered=True)
        return neq

    return jax.jit(lambda p: structured_lm_solve(
        recorded, p, max_nfev=max_nfev, ops=ops))(x0)


def trajectory_report(tag, neq, pieces_of, seen, group_of_key=None):
    """The port's normal equations (``neq(pieces)``) at each recorded x of
    the JAX trajectory against the JAX ones: one line of each field's worst
    error of its max-abs, one in the Jacobi scaling beside the port's own
    sensitivity to one ulp of x and the first evaluation past 1e-12."""
    import torch
    worst, worst_s, worst_ulp = {}, {}, {}
    first_over = None
    fields = FIELDS if group_of_key is None else MIXED_FIELDS
    for n, (xp, jn) in enumerate(seen):
        got = [t.numpy() for t in neq(pieces_of(
            *(torch.as_tensor(np.array(t)) for t in xp)))]
        ulp = [t.numpy() for t in neq(pieces_of(
            *(torch.as_tensor(np.nextafter(t, np.inf)) for t in xp)))]
        for name, g, r in zip(fields, got, jn):
            if g.size:
                worst[name] = max(worst.get(name, 0.0), float(
                    np.abs(g - r).max() / (np.abs(r).max() + 1e-300)))
        e = scaled_errors(got, jn, group_of_key)
        e_ulp = scaled_errors(ulp, got, group_of_key)
        for name in e:
            worst_s[name] = max(worst_s.get(name, 0.0), e[name])
            worst_ulp[name] = max(worst_ulp.get(name, 0.0), e_ulp[name])
        over = [k for k, v in e.items() if v > 1e-12]
        if over and first_over is None:
            first_over = (f"evaluation {n + 1}: " + ",".join(
                f"{k} {e[k]:.2e} (one ulp of x: {e_ulp[k]:.2e})"
                for k in over))
    print(f"[neq_on_jax_trajectory] {tag} evaluations="
          f"{len(seen)} of_max_abs: " + " ".join(
              f"{k}={v:.2e}" for k, v in worst.items()), flush=True)
    print(f"[neq_on_jax_trajectory] {tag} jacobi_scaled: "
          + " ".join(f"{k}={v:.2e}" for k, v in worst_s.items())
          + " | port at x vs at x + one ulp, jacobi_scaled: "
          + " ".join(f"{k}={v:.2e}" for k, v in worst_ulp.items())
          + f" | first over 1e-12: {first_over}", flush=True)


def _lm_line(res) -> str:
    return (f"(nit {int(res.nit)}, nfev {int(res.nfev)}, status "
            f"{int(res.status)}, cost {float(res.cost)!r})")


def multi_target(chain, model):
    """Steps 1-4 for one multi-target chain and model, at each of
    ``MULTI_SHAPES``, and the cost gap at ``BUDGETS``."""
    import jax.numpy as jnp

    from pycamset_tpu_torch.problems import grouped_problem, mixed_problem
    for n_cams, n_ims in MULTI_SHAPES:
        tag = f"chain={chain} model={model} shape={n_cams}x{n_ims}"
        neq_fn, x0, ops = jax_multi_target(chain, model, n_cams, n_ims)
        seen = []
        j_res = jax_lm(neq_fn, x0, ops, MULTI_BUDGET, seen)
        prob = (mixed_problem if chain == "mixed" else grouped_problem)(
            n_cams, n_ims, "cpu", grid=5, camera_model=model)
        # the starts agree to rounding: each package's synthetic rig rotates
        # its extrinsics by its own Rodrigues conversion
        dx0 = max(float(np.abs(g.numpy() - np.asarray(r)).max())
                  for g, r in zip(prob.x0, x0))
        trajectory_report(tag, prob.neq_fn(), type(prob.x0), seen,
                          prob.group_of_key if chain == "mixed" else None)
        p_res = prob.solve(MULTI_BUDGET)
        gap = abs(float(p_res.cost) - float(j_res.cost)) / float(j_res.cost)
        print(f"[port_vs_jax] {tag} jax={_lm_line(j_res)} port="
              f"{_lm_line(p_res)} rel_cost_gap={gap:.3e} "
              f"start_max_abs_diff={dx0:.2e}", flush=True)
        gaps = []
        for budget in BUDGETS:
            jr, pr = jax_lm(neq_fn, x0, ops, budget), prob.solve(budget)
            gaps.append(f"{budget}: nit {int(jr.nit)}/{pr.nit} status "
                        f"{int(jr.status)}/{int(pr.status)} gap "
                        f"{abs(float(pr.cost) - float(jr.cost)) / float(jr.cost):.3e}")
        print(f"[budget_gap] {tag} (jax/port) " + "; ".join(gaps), flush=True)
        x_ulp = type(x0)(*(jnp.asarray(np.nextafter(np.asarray(t), np.inf))
                           for t in x0))
        j_ulp = jax_lm(neq_fn, x_ulp, ops, MULTI_BUDGET)
        ulp = abs(float(j_ulp.cost) - float(j_res.cost)) / float(j_res.cost)
        print(f"[jax_vs_jax_one_ulp] {tag} nit {int(j_ulp.nit)} "
              f"nfev {int(j_ulp.nfev)} status {int(j_ulp.status)} "
              f"rel_cost_gap={ulp:.3e}", flush=True)


def main(chains, models) -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")

    from pycamset_tpu.optim.driver import run_bundle_adjustment as jax_rba
    from pycamset_tpu.utils.synthetic import make_synthetic_rig
    from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
    from pycamset_tpu_torch.optim.structured import ParamPieces
    from pycamset_tpu_torch.optim.structured_driver import (
        build_structured_problem)
    for chain, model in ((c, m) for c in chains for m in models):
        if chain in ("mixed", "grouped"):
            multi_target(chain, model)
            continue
        rig = make_synthetic_rig(**RIGS[chain], camera_model=model)
        jh = jax_handler(chain, model, rig)
        port = port_handler(chain, jh)
        assert np.array_equal(np.asarray(port.get_initial_params()),
                              np.asarray(jh.get_initial_params()))
        j_res, seen = recorded_jax_solve(jh)
        tag = f"chain={chain} model={model}"
        prob = build_structured_problem(port, device="cpu")[0].problem
        neq = prob.neq_fn()
        trajectory_report(tag, neq, ParamPieces, seen)
        p_res, _ = run_bundle_adjustment(port, backend="structured",
                                         device="cpu")
        gap = abs(float(p_res.cost) - float(j_res.cost)) / float(j_res.cost)
        print(f"[port_vs_jax] {tag} jax=(nit {int(j_res.nit)}, nfev "
              f"{int(j_res.nfev)}, status {int(j_res.status)}, cost "
              f"{float(j_res.cost)!r}) port=(nit {p_res.nit}, nfev "
              f"{p_res.nfev}, status {p_res.status}, cost "
              f"{float(p_res.cost)!r}) rel_cost_gap={gap:.3e}", flush=True)
        x0 = np.asarray(jh.get_initial_params(), dtype=np.float64)
        j_ulp, _ = jax_rba(jax_handler(chain, model, rig,
                                       np.nextafter(x0, np.inf)),
                           backend="structured")
        ulp = abs(float(j_ulp.cost) - float(j_res.cost)) / float(j_res.cost)
        print(f"[jax_vs_jax_one_ulp] {tag} nit {int(j_ulp.nit)} "
              f"nfev {int(j_ulp.nfev)} status {int(j_ulp.status)} "
              f"rel_cost_gap={ulp:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    chains = (*RIGS, "mixed", "grouped")
    if "--chain" in args:
        i = args.index("--chain")
        chains = (args[i + 1],)
        del args[i:i + 2]
    sys.exit(main(chains, args or MODELS))
