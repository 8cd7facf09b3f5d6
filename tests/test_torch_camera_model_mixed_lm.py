"""Port parity: the multi-target solves at the other camera models.

For the fisheye (a = 14), rational (18), thin-prism (22) and tilted (24)
models, the mixed and grouped LM of ``problems.{mixed,grouped}_problem(3,
n_ims, grid=5, camera_model=m)`` in float64 on the CPU against the JAX
package's ``structured_lm_solve`` on the same rig, start and gauge
(``tools/brown_trajectory_neq.py::jax_multi_target``: ``bench.py::
mixed_problem`` mirrored with the model's projection block; each package
makes the rig with its own Rodrigues conversion, so the starts agree to one
ulp): the same ``nit``, ``nfev`` and ``status``, the cost and the cost
history within 1e-9 relative. Each model takes E (3 x 8, the fused family)
on one chain and F (3 x 6, the per-block one) on the other.

The Brown models' multi-target solves crawl to the budget of 60
evaluations on these small rigs, and float64 rounding grows between the
two packages in a flat valley (ROADMAP Queue C 6):
``tools/brown_trajectory_neq.py --chain mixed`` / ``--chain grouped``
holds both packages' normal equations on the JAX LM's own 60 iterates to
the rounding of one ulp of x (worst 4.2e-11 in the Jacobi scaling against
4.5e-11 for one ulp, rational mixed 3 x 8), and the JAX package parts from
itself, from a start one ulp away, by up to 9.6e-5 of the cost at 60
evaluations (thin-prism grouped 3 x 6), the port from it by 9.4e-5 there.
At 15 evaluations the packages' costs part by at most 4.4e-11. So the
Brown models' solves are compared at a budget of 15 evaluations
(``BUDGET``); the fisheye's run their problems' own budget of 60.
"""
import numpy as np
import pytest

from pycamset_tpu_torch.problems import grouped_problem, mixed_problem
from test_torch_camera_model_mixed_grams import WIDTHS
from tools.brown_trajectory_neq import jax_lm, jax_multi_target

# the Brown models' budget where the packages' solves are compared (see
# the module docstring)
BUDGET = 15


def _assert_same_lm(got, ref):
    assert (got.nit, got.nfev, int(got.status)) == (
        int(ref.nit), int(ref.nfev), int(ref.status))
    assert abs(float(got.cost) - float(ref.cost)) <= 1e-9 * float(ref.cost)
    n = got.nit + 1
    assert np.abs(got.history[:n].numpy() - np.asarray(ref.history)[:n]
                  ).max() <= 1e-9 * float(ref.history[0])


# each model: E (3 x 8) on one chain, F (3 x 6) on the other
@pytest.mark.parametrize("model,chain,n_ims", [
    ("fisheye", "mixed", 6), ("fisheye", "grouped", 8),
    ("rational", "mixed", 8), ("rational", "grouped", 6),
    ("thin_prism", "mixed", 6), ("thin_prism", "grouped", 8),
    ("tilted", "mixed", 8), ("tilted", "grouped", 6)])
def test_multi_target_lm_matches_jax_package(model, chain, n_ims):
    neq_fn, x0, ops = jax_multi_target(chain, model, 3, n_ims)
    prob = (mixed_problem if chain == "mixed" else grouped_problem)(
        3, n_ims, "cpu", grid=5, camera_model=model)
    assert prob.widths.a == WIDTHS[model] and prob.max_nfev == 60
    budget = 60 if model == "fisheye" else BUDGET
    for g, r in zip(prob.x0, x0):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 1e-15 * np.abs(r).max()
    got = prob.solve(budget)
    _assert_same_lm(got, jax_lm(neq_fn, x0, ops, budget))
    assert prob.rms_px(got.cost) <= 0.36
