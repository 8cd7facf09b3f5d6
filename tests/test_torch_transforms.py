"""Port parity: the ops transform surface (float64, CPU).

``pycamset_tpu_torch.ops`` against ``pycamset_tpu.ops`` on inputs made from
a seed with numpy, to 1e-12: the thirteen transforms of
``ops/transforms.py`` (single and, where the port takes leading dims,
batched against ``jax.vmap``), ``project_world_points`` and
``project_target_points`` of ``ops/projection.py``, and the package's
exported names (every name of ``pycamset_tpu/ops/__init__.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pycamset_tpu.ops as jops
import pycamset_tpu_torch.ops as tops

# One intra-op thread a process: the xdist workers share the host's cores.
torch.set_num_threads(1)

RNG = np.random.default_rng(26)
POSES = np.concatenate([RNG.normal(size=(5, 3)) * 0.8,
                        RNG.normal(size=(5, 3))], axis=1)
# near the identity and near a half turn: the Rodrigues branches
POSES[3, :3] = [1e-9, -2e-9, 0.5e-9]
POSES[4, :3] = np.array([0.3, -0.5, 0.81]) / np.linalg.norm(
    [0.3, -0.5, 0.81]) * (np.pi - 1e-7)
PTS = RNG.normal(size=(7, 3)) + np.array([0.0, 0.0, 4.0])


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(got, ref, tol=1e-12):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * max(1.0, np.abs(ref).max())


def test_exported_names_cover_the_jax_package():
    missing = [n for n in dir(jops) if not n.startswith("_")
               and callable(getattr(jops, n)) and not hasattr(tops, n)]
    assert not missing, missing
    assert set(tops.__all__) <= set(dir(tops))


@pytest.mark.parametrize("i", range(len(POSES)))
def test_pose_conversions_match_jax(i):
    p = POSES[i]
    se3 = jops.pose_to_se3(jnp.asarray(p))
    _close(tops.pose_to_se3(_t(p)), se3)
    _close(tops.pose_to_h4(_t(p)), jops.pose_to_h4(jnp.asarray(p)))
    _close(tops.se3_to_pose(_t(se3)), jops.se3_to_pose(se3))
    _close(tops.pose_inv(_t(p)), jops.pose_inv(jnp.asarray(p)))
    _close(tops.se3_inv(_t(se3)), jops.se3_inv(se3))
    _close(tops.se3_apply(_t(se3), _t(PTS)), jops.se3_apply(se3, PTS))
    _close(tops.pose_apply(_t(p), _t(PTS)),
           jops.pose_apply(jnp.asarray(p), PTS))


def test_batched_forms_match_jax_vmap():
    jp = jnp.asarray(POSES)
    _close(tops.pose_to_se3(_t(POSES)), jax.vmap(jops.pose_to_se3)(jp))
    _close(tops.pose_to_h4(_t(POSES)), jax.vmap(jops.pose_to_h4)(jp))
    se3 = jax.vmap(jops.pose_to_se3)(jp)
    _close(tops.se3_inv(_t(se3)), jax.vmap(jops.se3_inv)(se3))
    _close(tops.se3_compose(_t(se3[:-1]), _t(se3[1:])),
           jax.vmap(jops.se3_compose)(se3[:-1], se3[1:]))
    _close(tops.pose_inv(_t(POSES)), jax.vmap(jops.pose_inv)(jp))
    _close(tops.se3_to_pose(_t(se3)), jax.vmap(jops.se3_to_pose)(se3))


def test_compose_and_homogeneous_match_jax():
    a = jops.pose_to_se3(jnp.asarray(POSES[0]))
    b = jops.pose_to_se3(jnp.asarray(POSES[1]))
    _close(tops.se3_compose(_t(a), _t(b)), jops.se3_compose(a, b))
    h4 = np.asarray(jops.pose_to_h4(jnp.asarray(POSES[2])))
    proj = h4.copy()
    proj[3] = [0.01, -0.02, 0.3, 1.1]          # a full projective 4x4
    for m in (h4, h4[:3], proj):
        for fill in (1.0, 0.0):
            _close(tops.h_tform(_t(PTS), _t(m), fill=fill),
                   jops.h_tform(jnp.asarray(PTS), jnp.asarray(m), fill=fill))
    p34 = RNG.normal(size=(3, 4)) + np.array([[0, 0, 0, 0], [0, 0, 0, 0],
                                              [0, 0, 0, 5.0]])
    _close(tops.project_h(_t(PTS), _t(p34)), jops.project_h(PTS, p34))


def test_point_sets_match_jax():
    cloud = RNG.normal(size=(40, 3))
    cloud[:3] += 25.0                          # outliers the median ignores
    _close(tops.geometric_median(_t(cloud)), jops.geometric_median(cloud))
    _close(tops.pairwise_dist(_t(cloud), _t(PTS)),
           jops.pairwise_dist(cloud, PTS))
    polar = np.stack([RNG.uniform(-1.5, 1.5, 9), RNG.uniform(-3, 3, 9)], -1)
    _close(tops.make_cartesian(_t(polar)), jops.make_cartesian(polar))
    xyz = RNG.normal(size=(9, 3))
    _close(tops.make_polar(_t(xyz)), jops.make_polar(xyz))


def test_projection_chains_match_jax():
    intr = np.array([1500.0, 800.0, 1490.0, 600.0, -0.1, 0.02, 1e-4, -1e-4,
                     0.001])
    extr, pose = POSES[0] * 0.2, POSES[1] * 0.2
    _close(tops.project_world_points(_t(intr), _t(extr), _t(PTS)),
           jops.project_world_points(jnp.asarray(intr), jnp.asarray(extr),
                                     PTS))
    _close(tops.project_target_points(_t(intr), _t(extr), _t(pose),
                                      _t(PTS * 0.1)),
           jops.project_target_points(jnp.asarray(intr), jnp.asarray(extr),
                                      jnp.asarray(pose), PTS * 0.1))
