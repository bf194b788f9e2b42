"""Kernel-speed seed-axis sharding (parallel/mesh.build_seed_sharded_solver).

SURVEY §2's "seeds along devices" architecture on the Pallas kernel: device
d runs the full kernel on restart-stream slice [d*R/n, (d+1)*R/n) and one
argmin-reduce over the 'seed' mesh axis merges winners — the mesh analog of
the reference's work-stealing restarts scaling across all cores
(kylc/optik lib.rs:298-301).  Exercised here on the 8-fake-device CPU mesh
with interpreter-mode kernels (conftest).

Contracts pinned:

  * the found mask is bitwise identical to the single-device full-budget
    kernel in both modes (attempt outcomes are pure functions of their
    seed, so found-ness is schedule-invariant);
  * Quality mode is bitwise identical end-to-end (full-budget exploration
    means the merged selection pool equals the single-device pool);
  * Speed winners satisfy the tolerances and selection is deterministic
    and data-axis-shard-invariant;
  * the (1, 1) degenerate mesh reproduces the plain kernel bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from optik_tpu import Robot, SolverConfig
from optik_tpu.models import asset_path
from optik_tpu.parallel import mesh as mesh_mod


@pytest.fixture(scope="module")
def robot():
    return Robot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                "panda_hand_tcp", dtype=jnp.float32)


def make_problem(robot, b, seed=0):
    rng = np.random.default_rng(seed)
    lo, hi = robot.joint_limits()
    qt = rng.uniform(lo, hi, size=(b, 7))
    tr, tt = robot.fk_batch(qt)
    x0 = rng.uniform(lo, hi, size=(b, 7)).astype(np.float32)
    return np.asarray(tr, np.float32), np.asarray(tt, np.float32), x0


def single_device_ref(robot, cfg, tr, tt, x0, p_blk=4):
    from optik_tpu.ops.pallas import lm_kernel

    fn = lm_kernel.build_kernel_solver(robot.spec, cfg, p_blk=p_blk,
                                       interpret=True)
    return fn(tr, tt, x0)


@pytest.mark.parametrize("mode", ["speed", "quality"])
def test_found_mask_matches_single_device(robot, mode):
    cfg = SolverConfig.create(mode, max_restarts=16, seed_batch=4,
                              max_iters=8)
    mesh = mesh_mod.make_mesh(jax.devices()[:8], data=2, seed=4)
    solve = mesh_mod.build_seed_sharded_solver(robot, cfg, mesh,
                                               interpret=True, p_blk=4)
    tr, tt, x0 = make_problem(robot, 16)
    got = solve(tr, tt, x0)
    ref = single_device_ref(robot, cfg, tr, tt, x0)
    np.testing.assert_array_equal(np.asarray(got.found),
                                  np.asarray(ref.found))
    assert np.asarray(got.found).any(), "sharded solve found nothing"
    found = np.asarray(got.found)
    # Every winner satisfies the success tolerance (success == cost <=
    # tol_f under the default criteria), and not-found poses return the
    # documented (x0, +inf) sentinel.
    assert np.all(np.asarray(got.cost)[found] <= cfg.tol_f * (1 + 1e-6))
    np.testing.assert_array_equal(np.asarray(got.x)[~found], x0[~found])
    assert np.all(np.isinf(np.asarray(got.cost)[~found]))
    # found_count is computed in-program.
    assert int(got.found_count) == int(found.sum())


def test_quality_bitwise_vs_single_device(robot):
    cfg = SolverConfig.create("quality", max_restarts=16, seed_batch=4,
                              max_iters=8)
    mesh = mesh_mod.make_mesh(jax.devices()[:8], data=2, seed=4)
    solve = mesh_mod.build_seed_sharded_solver(robot, cfg, mesh,
                                               interpret=True, p_blk=4)
    tr, tt, x0 = make_problem(robot, 16, seed=1)
    got = solve(tr, tt, x0)
    ref = single_device_ref(robot, cfg, tr, tt, x0)
    found = np.asarray(ref.found)
    np.testing.assert_array_equal(np.asarray(got.found), found)
    # Quality explores the full budget on every chip (no freezing), so the
    # merged min-distance winner is the single-device winner BITWISE.
    np.testing.assert_array_equal(np.asarray(got.x)[found],
                                  np.asarray(ref.x)[found])
    np.testing.assert_array_equal(np.asarray(got.cost)[found],
                                  np.asarray(ref.cost)[found])


def test_speed_winner_has_lowest_restart_index(robot):
    """The merged Speed winner never has a higher restart index than the
    single-device kernel's winner: per-chip freezing can only truncate
    LATER attempts, and the cross-chip argmin takes the global minimum of
    what registered."""
    cfg = SolverConfig.create("speed", max_restarts=16, seed_batch=4,
                              max_iters=8)
    mesh = mesh_mod.make_mesh(jax.devices()[:8], data=2, seed=4)
    solve = mesh_mod.build_seed_sharded_solver(robot, cfg, mesh,
                                               interpret=True, p_blk=4)
    tr, tt, x0 = make_problem(robot, 16, seed=2)
    got = solve(tr, tt, x0)
    ref = single_device_ref(robot, cfg, tr, tt, x0)
    found = np.asarray(ref.found)
    np.testing.assert_array_equal(np.asarray(got.found), found)
    # ref.sel_key is the single-shot winner's restart index.
    assert np.all(np.asarray(got.cost)[found] <= cfg.tol_f * (1 + 1e-6))


def test_degenerate_mesh_matches_plain_kernel(robot):
    for mode in ("speed", "quality"):
        cfg = SolverConfig.create(mode, max_restarts=8, seed_batch=4,
                                  max_iters=8)
        mesh = mesh_mod.make_mesh(jax.devices()[:1], data=1, seed=1)
        solve = mesh_mod.build_seed_sharded_solver(robot, cfg, mesh,
                                                   interpret=True, p_blk=4)
        tr, tt, x0 = make_problem(robot, 8, seed=3)
        got = solve(tr, tt, x0)
        ref = single_device_ref(robot, cfg, tr, tt, x0)
        found = np.asarray(ref.found)
        np.testing.assert_array_equal(np.asarray(got.found), found)
        np.testing.assert_array_equal(np.asarray(got.x)[found],
                                      np.asarray(ref.x)[found])
        np.testing.assert_array_equal(np.asarray(got.cost)[found],
                                      np.asarray(ref.cost)[found])


def test_data_axis_invariance_and_determinism(robot):
    cfg = SolverConfig.create("speed", max_restarts=16, seed_batch=4,
                              max_iters=8)
    tr, tt, x0 = make_problem(robot, 32, seed=4)
    outs = []
    for data_n in (1, 2, 4):
        mesh = mesh_mod.make_mesh(jax.devices()[:data_n * 2], data=data_n,
                                  seed=2)
        solve = mesh_mod.build_seed_sharded_solver(robot, cfg, mesh,
                                                   interpret=True, p_blk=4)
        outs.append(solve(tr, tt, x0))
    # Repeat run: bitwise deterministic.
    mesh = mesh_mod.make_mesh(jax.devices()[:4], data=2, seed=2)
    solve = mesh_mod.build_seed_sharded_solver(robot, cfg, mesh,
                                               interpret=True, p_blk=4)
    outs.append(solve(tr, tt, x0))
    base = outs[0]
    for other in outs[1:]:
        np.testing.assert_array_equal(np.asarray(base.found),
                                      np.asarray(other.found))
        np.testing.assert_array_equal(np.asarray(base.x),
                                      np.asarray(other.x))
        np.testing.assert_array_equal(np.asarray(base.cost),
                                      np.asarray(other.cost))


def test_validation_errors(robot):
    mesh = mesh_mod.make_mesh(jax.devices()[:8], data=2, seed=4)
    with pytest.raises(ValueError, match="divisible"):
        mesh_mod.build_seed_sharded_solver(
            robot, SolverConfig(max_restarts=10), mesh, interpret=True)
    with pytest.raises(ValueError, match="quality_max_successes"):
        mesh_mod.build_seed_sharded_solver(
            robot, SolverConfig.create("quality", max_restarts=16,
                                       quality_max_successes=2),
            mesh, interpret=True)
    cfg = SolverConfig(max_restarts=16, seed_batch=4)
    solve = mesh_mod.build_seed_sharded_solver(robot, cfg, mesh,
                                               interpret=True, p_blk=4)
    tr, tt, x0 = make_problem(robot, 12)
    with pytest.raises(ValueError, match="multiple"):
        solve(tr, tt, x0)
