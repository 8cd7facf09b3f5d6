#!/usr/bin/env python3
"""The Brown models' solves in both packages, held iterate by iterate on
the JAX package's own trajectory (CPU, float64).

    JAX_PLATFORMS=cpu python3 tools/brown_trajectory_neq.py \
        [--chain template|selfcal] [models...]

Two scenarios, each for the Brown models (rational, thin-prism, tilted by
default; both chains unless ``--chain`` names one):

- template: the 3-camera x 4-image rig of
  ``tests/test_torch_camera_models.py`` (``make_synthetic_rig(3, 4,
  grid=7, visibility=0.95, noise_px=0.2, seed=7)``) and its
  ``TemplateBundleHandler``;
- selfcal: the rig of the JAX package's rational self-calibration test
  (``tests/test_rational_model.py::test_rational_self_calibration_end_to_end``:
  ``make_synthetic_rig(3, 8, grid=5, visibility=0.95, noise_px=0.1,
  seed=5)``) and its ``SelfBundleHandler``, PnP-seeded in both packages
  (the same start bit for bit).

For each:

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


def scaled_errors(got, ref) -> dict:
    """Each NormalEq field's worst error in the Jacobi scaling of ``ref``
    (numpy pieces; the key fields where the chain has key columns): a zero
    diagonal (a fixed column, zero in both) scales by 1."""
    def s(d):
        d = np.sqrt(np.maximum(d, 0.0))
        return np.where(d > 0, d, 1.0)
    hcc, hii, hkk, wci, _, _, gc, gi, _, cost = ref
    s_c = s(np.diagonal(hcc, axis1=1, axis2=2))
    s_i = s(np.diagonal(hii, axis1=1, axis2=2))
    s_k = s(np.diagonal(hkk, axis1=1, axis2=2))
    root = np.sqrt(cost)
    scale = {"hcc": s_c[:, :, None] * s_c[:, None, :],
             "hii": s_i[:, :, None] * s_i[:, None, :],
             "hkk": s_k[:, :, None] * s_k[:, None, :],
             "wci": s_c[:, None, :, None] * s_i[None, :, None, :],
             "wck": s_c[:, None, :, None] * s_k[None, :, None, :],
             "wik": s_i[:, None, :, None] * s_k[None, :, None, :],
             "gc": s_c * root, "gi": s_i * root, "gk": s_k * root,
             "cost": cost}
    return {k: float((np.abs(np.asarray(g) - r) / scale[k]).max())
            for k, g, r in zip(FIELDS, got, ref) if np.size(r)}


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


def main(chains, models) -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch

    from pycamset_tpu.optim.driver import run_bundle_adjustment as jax_rba
    from pycamset_tpu.utils.synthetic import make_synthetic_rig
    from pycamset_tpu_torch.optim.driver import run_bundle_adjustment
    from pycamset_tpu_torch.optim.structured import ParamPieces
    from pycamset_tpu_torch.optim.structured_driver import (
        build_structured_problem)
    for chain, model in ((c, m) for c in chains for m in models):
        rig = make_synthetic_rig(**RIGS[chain], camera_model=model)
        jh = jax_handler(chain, model, rig)
        port = port_handler(chain, jh)
        assert np.array_equal(np.asarray(port.get_initial_params()),
                              np.asarray(jh.get_initial_params()))
        j_res, seen = recorded_jax_solve(jh)
        tag = f"chain={chain} model={model}"
        prob = build_structured_problem(port, device="cpu")[0].problem
        neq = prob.neq_fn()
        worst, worst_s, worst_ulp = {}, {}, {}
        first_over = None
        for n, (xp, jn) in enumerate(seen):
            got = [t.numpy() for t in neq(ParamPieces(
                *(torch.as_tensor(np.array(t)) for t in xp)))]
            ulp = [t.numpy() for t in neq(ParamPieces(
                *(torch.as_tensor(np.nextafter(t, np.inf)) for t in xp)))]
            for name, g, r in zip(FIELDS, got, jn):
                if g.size:
                    worst[name] = max(worst.get(name, 0.0), float(
                        np.abs(g - r).max() / (np.abs(r).max() + 1e-300)))
            e, e_ulp = scaled_errors(got, jn), scaled_errors(ulp, got)
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
    chains = tuple(RIGS)
    if "--chain" in args:
        i = args.index("--chain")
        chains = (args[i + 1],)
        del args[i:i + 2]
    sys.exit(main(chains, args or MODELS))
