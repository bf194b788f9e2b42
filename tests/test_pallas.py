"""Pallas LM kernel vs the XLA SoA path (Triton route, interpreter mode on
the CPU).

The kernel reuses the exact same loop core (solver/lm_soa.lm_loop) with the
same exact transcendentals, so the results must match the XLA path up to
reduction ordering; we require identical found-masks and solutions to float
tolerance.  ``p_blk`` is the number of poses per kernel block.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from optik_tpu import Robot, SolverConfig
from optik_tpu.models import asset_path


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


@pytest.mark.parametrize("mode,restarts,seed_batch", [
    ("speed", 8, 8),        # no reseed
    ("speed", 24, 8),       # reseed
    ("quality", 24, 8),     # full-budget exploration
])
def test_kernel_matches_xla(robot, mode, restarts, seed_batch):
    from optik_tpu.ops import soa
    from optik_tpu.ops.pallas import lm_kernel
    from optik_tpu.solver import ik as ik_mod

    cfg = SolverConfig.create(mode, max_restarts=restarts,
                              seed_batch=seed_batch, max_iters=32)
    B = 16
    tr, tt, x0 = make_problem(robot, B)

    ref_fn = ik_mod.build_batch_solver(robot.spec, cfg, jnp.float32)
    ref = ref_fn(jnp.asarray(tr), jnp.asarray(tt), jnp.asarray(x0))
    fn = lm_kernel.build_kernel_solver(robot.spec, cfg, p_blk=8,
                                       interpret=True)
    got = fn(tr, tt, x0)

    np.testing.assert_array_equal(np.asarray(got.found),
                                  np.asarray(ref.found))
    found = np.asarray(ref.found)
    np.testing.assert_allclose(np.asarray(got.x)[found],
                               np.asarray(ref.x)[found], atol=1e-5)
    assert np.all(np.asarray(got.cost)[found] <= cfg.tol_f * (1 + 1e-5))

    # The public API on the CPU runs the XLA path: the same found set.
    exact = robot.ik_batch(cfg, tr, tt, x0)
    np.testing.assert_array_equal(np.asarray(got.found),
                                  np.asarray(exact.found))


@pytest.mark.parametrize("mode,restarts,seed_batch", [
    ("speed", 24, 4),       # 4 seed lanes per pose, reseed
    ("speed", 4, 4),        # no reseed
    ("speed", 24, 2),       # 2 seed lanes
    ("speed", 24, 1),       # 1 seed lane (pure sequential restarts)
    ("quality", 24, 4),     # quality
])
def test_packed_kernel_matches_xla(robot, mode, restarts, seed_batch):
    """Small seed-lane counts share a block among many poses ((P, S) lanes,
    P = max(8, 16 / S) here, so 1-2 blocks): a pure layout change, so the
    kernel must reproduce the XLA SoA path's found mask exactly and its
    solutions to float tolerance.  (Blocks of fewer than 8 poses make the
    CPU backend compile the interpreted body's transcendentals differently,
    which moves solutions in the last bits.)"""
    from optik_tpu.ops.pallas import lm_kernel
    from optik_tpu.solver import ik as ik_mod

    cfg = SolverConfig.create(mode, max_restarts=restarts,
                              seed_batch=seed_batch, max_iters=32)
    B = 16
    tr, tt, x0 = make_problem(robot, B, seed=7)

    ref_fn = ik_mod.build_batch_solver(robot.spec, cfg, jnp.float32)
    ref = ref_fn(tr, tt, x0)
    fn = lm_kernel.build_kernel_solver(robot.spec, cfg,
                                       p_blk=max(8, 16 // seed_batch),
                                       interpret=True)
    got = fn(tr, tt, x0)

    np.testing.assert_array_equal(np.asarray(got.found),
                                  np.asarray(ref.found))
    found = np.asarray(ref.found)
    np.testing.assert_allclose(np.asarray(got.x)[found],
                               np.asarray(ref.x)[found], atol=1e-5)
    assert np.all(np.asarray(got.cost)[found] <= cfg.tol_f * (1 + 1e-5))


@pytest.mark.parametrize("mode,restarts,seed_batch", [
    ("speed", 8, 8),
    ("speed", 24, 4),       # 4 seed lanes + reseed
    ("quality", 24, 8),
])
def test_kernel_weighted_matches_xla(robot, mode, restarts, seed_batch):
    """Per-axis weights reach the kernel (round-1 regression: the kernel
    silently dropped them, solving the unweighted objective).  The kernel
    must reproduce the *weighted* XLA path exactly, and must NOT match the
    unweighted one."""
    from optik_tpu.ops.pallas import lm_kernel
    from optik_tpu.solver import ik as ik_mod

    cfg = SolverConfig.create(mode, max_restarts=restarts,
                              seed_batch=seed_batch, max_iters=32,
                              linear_weight=(0.0, 1.0, 1.0),
                              angular_weight=(0.5, 1.0, 2.0))
    B = 16
    tr, tt, x0 = make_problem(robot, B, seed=11)

    ref_fn = ik_mod.build_batch_solver(robot.spec, cfg, jnp.float32)
    ref = ref_fn(tr, tt, x0)
    fn = lm_kernel.build_kernel_solver(robot.spec, cfg, p_blk=8,
                                       interpret=True)
    got = fn(tr, tt, x0)
    un_fn = ik_mod.build_batch_solver(
        robot.spec, cfg.replace(linear_weight=(1.0, 1.0, 1.0),
                                angular_weight=(1.0, 1.0, 1.0)),
        jnp.float32)
    unweighted = un_fn(tr, tt, x0)

    np.testing.assert_array_equal(np.asarray(got.found),
                                  np.asarray(ref.found))
    found = np.asarray(ref.found)
    np.testing.assert_allclose(np.asarray(got.x)[found],
                               np.asarray(ref.x)[found], atol=1e-5)
    assert np.all(np.asarray(got.cost)[found] <= cfg.tol_f * (1 + 1e-5))
    # The weighted solve must actually differ from the unweighted one
    # (zero x-weight admits solutions with x-translation error).
    assert not np.allclose(np.asarray(got.x), np.asarray(unweighted.x),
                           atol=1e-3)


@pytest.mark.parametrize("seed_batch", [8, 4])
def test_kernel_ee_offset_matches_xla(robot, seed_batch):
    """A constant ee_offset folds into the kernel's chain tip: results must
    match the XLA path's runtime ee threading (reference contract:
    lib.rs:241-247, kinematics.rs:163)."""
    from optik_tpu.ops.pallas import lm_kernel
    from optik_tpu.solver import ik as ik_mod

    ee = np.eye(4)
    ee[:3, :3] = np.array([[0.0, -1.0, 0.0],
                           [1.0, 0.0, 0.0],
                           [0.0, 0.0, 1.0]])
    ee[:3, 3] = [0.03, -0.01, 0.12]

    cfg = SolverConfig.create("speed", max_restarts=24,
                              seed_batch=seed_batch, max_iters=32)
    B = 16
    rng = np.random.default_rng(13)
    lo, hi = robot.joint_limits()
    qt = rng.uniform(lo, hi, size=(B, 7))
    tr, tt = robot.fk_batch(qt, ee_offset=ee)
    tr = np.asarray(tr, np.float32)
    tt = np.asarray(tt, np.float32)
    x0 = rng.uniform(lo, hi, size=(B, 7)).astype(np.float32)

    ee_r = jnp.asarray(ee[:3, :3], jnp.float32)
    ee_t = jnp.asarray(ee[:3, 3], jnp.float32)
    ref_fn = ik_mod.build_batch_solver(robot.spec, cfg, jnp.float32)
    ref = ref_fn(tr, tt, x0, ee_r, ee_t)
    fn = lm_kernel.build_kernel_solver(
        robot.spec, cfg, p_blk=8, interpret=True,
        ee_offset=(ee[:3, :3], ee[:3, 3]))
    got = fn(tr, tt, x0)

    np.testing.assert_array_equal(np.asarray(got.found),
                                  np.asarray(ref.found))
    found = np.asarray(ref.found)
    # Build-time tip folding (f64 compose -> f32 constants) rounds
    # differently from the XLA path's runtime ee threading, so iterates
    # diverge; a pose can even converge on a different (equally valid) IK
    # branch when another restart wins the perturbed race.  The contract is
    # therefore behavioral: identical found mask, costs meet the tolerance,
    # and FK through the offset reaches the target.
    assert np.all(np.asarray(got.cost)[found] <= cfg.tol_f * (1 + 1e-5))
    xr, xt = robot.fk_batch(np.asarray(got.x)[found], ee_offset=ee)
    np.testing.assert_allclose(np.asarray(xr), tr[found], atol=2e-3)
    np.testing.assert_allclose(np.asarray(xt), tt[found], atol=2e-3)


def test_cascade_matches_single_shot(robot):
    """Cascade scheduling: identical found mask, valid solutions."""
    from optik_tpu.solver import cascade

    cfg = SolverConfig.create("speed", max_restarts=48, seed_batch=8,
                              max_iters=32)
    B = 32
    tr, tt, x0 = make_problem(robot, B, seed=3)

    ref = robot.ik_batch(cfg, tr, tt, x0)
    fn = cascade.build_cascade_solver(robot.spec, cfg, p_blk=8, tail_div=2,
                                      interpret=True)
    got = fn(jnp.asarray(tr), jnp.asarray(tt), jnp.asarray(x0))

    np.testing.assert_array_equal(np.asarray(got.found),
                                  np.asarray(ref.found))
    found = np.asarray(got.found)
    assert np.all(np.asarray(got.cost)[found] <= cfg.tol_f * (1 + 1e-5))
    # Reported solutions actually reach their targets.
    xr, xt = robot.fk_batch(np.asarray(got.x)[found])
    np.testing.assert_allclose(np.asarray(xr), np.asarray(tr)[found],
                               atol=2e-3)
    np.testing.assert_allclose(np.asarray(xt), np.asarray(tt)[found],
                               atol=2e-3)


def test_cascade_tail_overflow(robot):
    """More failures than the tail batch: overflow keeps phase-1 failure,
    everything still deterministic and well-formed."""
    from optik_tpu.solver import cascade

    cfg = SolverConfig.create("speed", max_restarts=48, seed_batch=8,
                              max_iters=4)  # tiny budget -> many failures
    B = 16
    tr, tt, x0 = make_problem(robot, B, seed=4)
    fn = cascade.build_cascade_solver(robot.spec, cfg, p_blk=8, tail_div=8,
                                      interpret=True)
    got = fn(jnp.asarray(tr), jnp.asarray(tt), jnp.asarray(x0))
    got2 = fn(jnp.asarray(tr), jnp.asarray(tt), jnp.asarray(x0))
    np.testing.assert_array_equal(np.asarray(got.found),
                                  np.asarray(got2.found))
    np.testing.assert_array_equal(np.asarray(got.x), np.asarray(got2.x))


def test_cascade_packed_screen(robot):
    """A narrower phase-1 screen (phase1_seeds < seed_batch): the found mask
    must cover the single-shot mask, every reported success must meet the
    tolerance and reach its target, and repeat solves are bitwise equal."""
    from optik_tpu.solver import cascade

    cfg = SolverConfig.create("speed", max_restarts=48, seed_batch=8,
                              max_iters=32)
    B = 32
    tr, tt, x0 = make_problem(robot, B, seed=5)

    ref = robot.ik_batch(cfg, tr, tt, x0)
    fn = cascade.build_cascade_solver(robot.spec, cfg, p_blk=4, tail_div=2,
                                      p_blk2=8, phase1_seeds=2,
                                      phase1_rounds=2, phase1_iters=24,
                                      interpret=True)
    got = fn(jnp.asarray(tr), jnp.asarray(tt), jnp.asarray(x0))
    got2 = fn(jnp.asarray(tr), jnp.asarray(tt), jnp.asarray(x0))

    assert np.all(np.asarray(got.found) >= np.asarray(ref.found))
    found = np.asarray(got.found)
    assert np.all(np.asarray(got.cost)[found] <= cfg.tol_f * (1 + 1e-5))
    xr, xt = robot.fk_batch(np.asarray(got.x)[found])
    np.testing.assert_allclose(np.asarray(xr), np.asarray(tr)[found],
                               atol=2e-3)
    np.testing.assert_allclose(np.asarray(xt), np.asarray(tt)[found],
                               atol=2e-3)
    np.testing.assert_array_equal(np.asarray(got.found),
                                  np.asarray(got2.found))
    np.testing.assert_array_equal(np.asarray(got.x), np.asarray(got2.x))


def test_cascade_multiphase(robot):
    """Three-phase cascade: 2-seed screen -> 8-seed re-screen -> replay.
    Found mask covers single-shot, solutions meet tolerance, deterministic."""
    from optik_tpu.solver import cascade

    cfg = SolverConfig.create("speed", max_restarts=48, seed_batch=8,
                              max_iters=32)
    B = 32
    tr, tt, x0 = make_problem(robot, B, seed=6)

    ref = robot.ik_batch(cfg, tr, tt, x0)
    fn = cascade.build_multiphase_solver(
        robot.spec, cfg,
        screens=[{"seeds": 2, "rounds": 1, "p_blk": 4, "keep_div": 2},
                 {"seeds": 8, "rounds": 1, "p_blk": 8, "keep_div": 2}],
        final_p_blk=8, interpret=True)
    got = fn(jnp.asarray(tr), jnp.asarray(tt), jnp.asarray(x0))
    got2 = fn(jnp.asarray(tr), jnp.asarray(tt), jnp.asarray(x0))

    assert np.all(np.asarray(got.found) >= np.asarray(ref.found))
    found = np.asarray(got.found)
    assert np.all(np.asarray(got.cost)[found] <= cfg.tol_f * (1 + 1e-5))
    xr, xt = robot.fk_batch(np.asarray(got.x)[found])
    np.testing.assert_allclose(np.asarray(xr), np.asarray(tr)[found],
                               atol=2e-3)
    np.testing.assert_allclose(np.asarray(xt), np.asarray(tt)[found],
                               atol=2e-3)
    np.testing.assert_array_equal(np.asarray(got.found),
                                  np.asarray(got2.found))
    np.testing.assert_array_equal(np.asarray(got.x), np.asarray(got2.x))


def test_lane_iters_work_accounting(robot):
    """IKResult.lane_iters: total executed lane-iterations, the work
    numerator for the bench's roofline/MFU accounting.

    Kernel: sum over blocks of (block loop count x lanes per block).
    XLA path: global loop count x total lanes.  Cascade: phase sum.
    """
    from optik_tpu.ops.pallas import lm_kernel
    from optik_tpu.solver import cascade

    cfg = SolverConfig.create("speed", max_restarts=24, seed_batch=8,
                              max_iters=32)
    B = 16
    tr, tt, x0 = make_problem(robot, B, seed=5)

    ref = robot.ik_batch(cfg, tr, tt, x0)
    assert ref.lane_iters is not None
    # One lockstep loop over B*S lanes; budget caps the loop length.
    max_total = (cfg.max_iters + 1) * 3  # 3 reseed rounds of 8
    assert 0 < int(ref.lane_iters) <= max_total * B * cfg.seed_batch

    fn = lm_kernel.build_kernel_solver(robot.spec, cfg, p_blk=8,
                                       interpret=True)
    got = fn(tr, tt, x0)
    assert got.lane_iters is not None
    # Two blocks of 8 poses x 8 seed lanes, each running <= the full budget.
    assert 0 < int(got.lane_iters) <= max_total * B * cfg.seed_batch
    # Blocks stop independently, so the kernel never does MORE work than
    # the single lockstep XLA loop (which runs until the slowest pose).
    assert int(got.lane_iters) <= int(ref.lane_iters)

    csc = cascade.build_cascade_solver(robot.spec, cfg, p_blk=8, tail_div=2,
                                       interpret=True)
    cres = csc(jnp.asarray(tr), jnp.asarray(tt), jnp.asarray(x0))
    assert cres.lane_iters is not None and int(cres.lane_iters) > 0


@pytest.mark.parametrize("mode,restarts,seed_batch", [
    ("speed", 16, 16),      # 16 seed lanes per pose
    ("quality", 48, 16),    # + reseed + full-budget exploration
    ("speed", 64, 64),      # 64 seed lanes (BASELINE config 2 shape)
])
def test_tall_seed_layouts_match_xla(robot, mode, restarts, seed_batch):
    """Wide seed-lane counts, where a block holds few poses with many lanes
    each; pin them against the XLA path — this is the layout Quality-mode
    high-seed configs (BASELINE config 2, 256 seeds) run through."""
    from optik_tpu.ops.pallas import lm_kernel

    cfg = SolverConfig.create(mode, max_restarts=restarts,
                              seed_batch=seed_batch, max_iters=24)
    B = 8
    tr, tt, x0 = make_problem(robot, B, seed=6)

    ref = robot.ik_batch(cfg, tr, tt, x0)
    fn = lm_kernel.build_kernel_solver(robot.spec, cfg, p_blk=8,
                                       interpret=True)
    got = fn(tr, tt, x0)

    np.testing.assert_array_equal(np.asarray(got.found),
                                  np.asarray(ref.found))
    found = np.asarray(ref.found)
    assert np.all(np.asarray(got.cost)[found] <= cfg.tol_f * (1 + 1e-5))
    xr, xt = robot.fk_batch(np.asarray(got.x)[found])
    np.testing.assert_allclose(np.asarray(xr), np.asarray(tr)[found],
                               atol=2e-3)
    np.testing.assert_allclose(np.asarray(xt), np.asarray(tt)[found],
                               atol=2e-3)


@pytest.mark.parametrize("restarts,expect_phases", [
    (64, 3),   # budget > 3 rounds -> 3-phase schedule
    (20, 2),   # small budget -> 2-phase fallback
])
def test_default_solver_schedule(robot, restarts, expect_phases):
    """build_default_solver (the production ik_batch route): found mask is
    a superset of the single-shot kernel's, solutions valid, deterministic,
    and the returned block unit divides the batch after padding."""
    from optik_tpu.solver import cascade

    cfg = SolverConfig.create("speed", max_restarts=restarts, seed_batch=8,
                              max_iters=32)
    fn, unit = cascade.build_default_solver(robot.spec, cfg, p_blk=8,
                                            interpret=True)
    assert unit == 8
    B = 32
    tr, tt, x0 = make_problem(robot, B, seed=8)

    ref = robot.ik_batch(cfg, tr, tt, x0)
    got = fn(jnp.asarray(tr), jnp.asarray(tt), jnp.asarray(x0))
    got2 = fn(jnp.asarray(tr), jnp.asarray(tt), jnp.asarray(x0))

    assert np.all(np.asarray(got.found) >= np.asarray(ref.found))
    found = np.asarray(got.found)
    assert np.all(np.asarray(got.cost)[found] <= cfg.tol_f * (1 + 1e-5))
    xr, xt = robot.fk_batch(np.asarray(got.x)[found])
    np.testing.assert_allclose(np.asarray(xr), np.asarray(tr)[found],
                               atol=2e-3)
    np.testing.assert_array_equal(np.asarray(got.found),
                                  np.asarray(got2.found))
    np.testing.assert_array_equal(np.asarray(got.x), np.asarray(got2.x))


def test_quality_cap_packed_kernel(robot):
    """quality_max_successes through the kernel (a seed-axis group sum):
    found must equal the uncapped kernel's."""
    from optik_tpu.ops.pallas import lm_kernel

    base = SolverConfig.create("quality", max_restarts=12, seed_batch=4,
                               max_iters=32)
    B = 16
    tr, tt, x0 = make_problem(robot, B, seed=21)
    f0 = lm_kernel.build_kernel_solver(robot.spec, base, p_blk=4,
                                       interpret=True)
    f1 = lm_kernel.build_kernel_solver(
        robot.spec, base.replace(quality_max_successes=1), p_blk=4,
        interpret=True)
    r0 = f0(tr, tt, x0)
    r1 = f1(tr, tt, x0)
    np.testing.assert_array_equal(np.asarray(r0.found),
                                  np.asarray(r1.found))
    found = np.asarray(r0.found)
    assert np.all(np.asarray(r1.cost)[found] <= base.tol_f * (1 + 1e-5))
    d0 = np.linalg.norm(np.asarray(r0.x) - x0, axis=-1)
    d1 = np.linalg.norm(np.asarray(r1.x) - x0, axis=-1)
    assert np.all(d0[found] <= d1[found] + 1e-6)


def test_default_cascade_success_floor(robot):
    """The production 3-phase default schedule loses ZERO poses vs the
    single-shot kernel at a production-shaped batch with realistic failure
    rates (tail capacity can silently trade success, so the default's floor
    is pinned here; the on-card twin runs in tests/test_gpu.py).

    The batch mixes ~99% random reachable poses (~0.3% screen-failure rate)
    with 8 unreachable ones (translations far outside the workspace) so the
    mid and final tails both receive genuine traffic.
    """
    from optik_tpu.solver import cascade
    from optik_tpu.ops.pallas import lm_kernel

    cfg = SolverConfig.create("speed", max_restarts=64, seed_batch=8,
                              max_iters=32)
    B = 2048
    tr, tt, x0 = make_problem(robot, B, seed=33)
    tt = tt.copy()
    tt[::256] = tt[::256] + 10.0  # 8 unreachable poses, spread across blocks

    solve, unit = cascade.build_default_solver(robot.spec, cfg,
                                               interpret=True)
    assert B % unit == 0
    got = solve(jnp.asarray(tr), jnp.asarray(tt), jnp.asarray(x0))

    single = lm_kernel.build_kernel_solver(robot.spec, cfg, interpret=True)
    ref = single(tr, tt, x0)

    got_f = np.asarray(got.found)
    ref_f = np.asarray(ref.found)
    np.testing.assert_array_equal(got_f, ref_f)
    assert not got_f[::256].any()          # unreachables failed everywhere
    assert got_f.sum() >= (B - 8) * 0.99   # realistic success floor
    assert np.all(np.asarray(got.cost)[got_f] <= cfg.tol_f * (1 + 1e-5))


def test_unroll_equivalent(robot):
    """lm_loop unroll: identical schedule semantics at any unroll factor —
    same found mask and solutions to float tolerance (the compiler may
    contract the unrolled body differently, so bitwise equality only holds
    within one compiled program; see lm_loop docstring), and repeat solves
    of the unrolled program are bitwise deterministic."""
    from optik_tpu.ops.pallas import lm_kernel

    cfg = SolverConfig.create("speed", max_restarts=24, seed_batch=8,
                              max_iters=16)
    B = 16
    tr, tt, x0 = make_problem(robot, B, seed=44)
    f1 = lm_kernel.build_kernel_solver(robot.spec, cfg, p_blk=8,
                                       interpret=True, unroll=1)
    f3 = lm_kernel.build_kernel_solver(robot.spec, cfg, p_blk=8,
                                       interpret=True, unroll=3)
    r1 = f1(tr, tt, x0)
    r3 = f3(tr, tt, x0)
    np.testing.assert_array_equal(np.asarray(r1.found),
                                  np.asarray(r3.found))
    found = np.asarray(r1.found)
    np.testing.assert_allclose(np.asarray(r1.x)[found],
                               np.asarray(r3.x)[found], atol=1e-3)
    assert np.all(np.asarray(r3.cost)[found] <= cfg.tol_f * (1 + 1e-5))
    # The trailing no-op iterations are the only difference in work.
    assert int(r3.lane_iters) >= int(r1.lane_iters)
    # Determinism within the unrolled program.
    r3b = f3(tr, tt, x0)
    np.testing.assert_array_equal(np.asarray(r3.x), np.asarray(r3b.x))
