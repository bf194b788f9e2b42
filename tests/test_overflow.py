"""Cascade capacity overflow: observability + rescue.

The cascade's replay phases have static capacities (solver/cascade.py); a
batch whose screen-failure rate exceeds them used to silently leave the
overflow poses with less than their full restart budget.  These tests pin
the new contract:

  * ``IKResult.overflow_count`` counts budget-denied poses device-side;
  * the public ``Robot.ik_batch`` (rescue_overflow=True, the default)
    restores the single-shot found mask on an all-hard curated batch —
    the reference never load-shrinks a pose's budget (lib.rs:273-277);
  * easy batches report zero overflow and skip the rescue entirely.

Runs the real cascade path on CPU via the Robot._interpret test hook
(interpreter-mode Pallas kernels; the same code compiles through Triton on
the GPU, where tests/test_gpu.py re-checks the public path on the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from optik_tpu import Robot, SolverConfig
from optik_tpu.models import asset_path
from optik_tpu import robot as robot_mod


CFG = SolverConfig(max_restarts=24, seed_batch=8, max_iters=16)


@pytest.fixture(scope="module")
def robot():
    r = Robot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                             "panda_hand_tcp", dtype=jnp.float32)
    r._interpret = True  # route the kernel/cascade paths on CPU
    return r


@pytest.fixture(scope="module")
def hard_batch(robot):
    """A 512-pose batch with 300 screen-failing but full-budget-solvable
    poses — exceeding the 2-phase cascade's 64-pose replay capacity."""
    from optik_tpu.ops.pallas import lm_kernel

    rng = np.random.default_rng(7)
    lo, hi = robot.joint_limits()
    n = 256
    qt = rng.uniform(lo, hi, size=(n, 7))
    tr, tt = robot.fk_batch(qt)
    tr = np.asarray(tr, np.float32)
    tt = np.asarray(tt, np.float32)
    x0 = rng.uniform(lo, hi, size=(n, 7)).astype(np.float32)

    # The cascade's screen phase for CFG is exactly the first 8 restarts
    # at full iteration budget (build_default_solver 2-phase form).
    k_scr = lm_kernel.build_kernel_solver(
        robot.spec, CFG.replace(max_restarts=8), interpret=True)
    k_full = lm_kernel.build_kernel_solver(robot.spec, CFG, interpret=True)
    scr = np.asarray(k_scr(tr, tt, x0).found)
    full = np.asarray(k_full(tr, tt, x0).found)
    hard = np.flatnonzero(~scr & full)
    easy = np.flatnonzero(scr)
    assert hard.size >= 1, "no screen-hard poses found; loosen the budget"
    assert easy.size >= 212

    idx = np.concatenate([np.resize(hard, 300), easy[:212]])
    return (tr[idx], tt[idx], x0[idx])


def single_shot(robot, tr, tt, x0):
    from optik_tpu.ops.pallas import lm_kernel

    fn = lm_kernel.build_kernel_solver(robot.spec, CFG, interpret=True)
    return fn(tr, tt, x0)


def test_overflow_observed_without_rescue(robot, hard_batch, monkeypatch):
    monkeypatch.setattr(robot_mod, "_CASCADE_MIN_BLOCKS", 1)
    tr, tt, x0 = hard_batch
    res = robot.ik_batch(CFG, tr, tt, x0, validate_seeds=False,
                         rescue_overflow=False)
    assert res.overflow_count is not None
    assert int(res.overflow_count) > 0
    ref = single_shot(robot, tr, tt, x0)
    got_f = np.asarray(res.found)
    ref_f = np.asarray(ref.found)
    # The overflow poses kept their screen failure: strictly fewer found.
    assert got_f.sum() < ref_f.sum()
    # Never MORE found than the full budget, and every miss is explained
    # by the overflow count.
    assert not np.any(got_f & ~ref_f)
    assert (ref_f.sum() - got_f.sum()) <= int(res.overflow_count)


def test_public_rescue_restores_single_shot(robot, hard_batch, monkeypatch):
    monkeypatch.setattr(robot_mod, "_CASCADE_MIN_BLOCKS", 1)
    tr, tt, x0 = hard_batch
    res = robot.ik_batch(CFG, tr, tt, x0, validate_seeds=False)
    ref = single_shot(robot, tr, tt, x0)
    np.testing.assert_array_equal(np.asarray(res.found),
                                  np.asarray(ref.found))
    found = np.asarray(res.found)
    assert found.sum() >= 300  # every hard replica rescued
    assert np.all(np.asarray(res.cost)[found] <= CFG.tol_f * (1 + 1e-6))
    # Pre-rescue capacity pressure stays observable.
    assert int(res.overflow_count) > 0
    assert int(res.found_count) == int(found.sum())


def test_easy_batch_zero_overflow(robot, monkeypatch):
    monkeypatch.setattr(robot_mod, "_CASCADE_MIN_BLOCKS", 1)
    rng = np.random.default_rng(11)
    lo, hi = robot.joint_limits()
    qt = rng.uniform(lo, hi, size=(512, 7))
    tr, tt = robot.fk_batch(qt)
    x0 = rng.uniform(lo, hi, size=(512, 7)).astype(np.float32)
    res = robot.ik_batch(CFG, np.asarray(tr, np.float32),
                         np.asarray(tt, np.float32), x0,
                         validate_seeds=False)
    assert int(res.overflow_count) == 0
    assert np.asarray(res.found).mean() > 0.95


def test_packed_kernel_padding_unit(monkeypatch):
    """ik_batch pads the batch to the kernel block of the config's
    seed-lane count (seed_batch=4: 16 poses per block) and runs the kernel
    without warnings."""
    import warnings

    robot = Robot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                 "panda_hand_tcp", dtype=jnp.float32)
    robot._interpret = True
    rng = np.random.default_rng(2)
    lo, hi = robot.joint_limits()
    qt = rng.uniform(lo, hi, size=(64, 7))
    tr, tt = robot.fk_batch(qt)
    x0 = rng.uniform(lo, hi, size=(64, 7)).astype(np.float32)
    cfg = SolverConfig(max_restarts=16, seed_batch=4, max_iters=8)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = robot.ik_batch(cfg, np.asarray(tr[:60], np.float32),
                             np.asarray(tt[:60], np.float32), x0[:60])
    assert ("kernel", cfg, None) in robot._solvers
    found = np.asarray(res.found)
    assert found.any()
    assert np.all(np.asarray(res.cost)[found] <= cfg.tol_f * (1 + 1e-6))


def test_all_hard_batch_matches_single_shot(robot, hard_batch, monkeypatch):
    """The VERDICT bar verbatim: a batch of 100% hard poses through the
    public ik_batch matches the single-shot found mask (every pose
    overflows every compaction; the rescue replays the full budget)."""
    monkeypatch.setattr(robot_mod, "_CASCADE_MIN_BLOCKS", 1)
    tr, tt, x0 = hard_batch
    # hard_batch's first 300 rows are the screen-hard replicas; tile a
    # 512-pose batch from them alone.
    idx = np.resize(np.arange(300), 512)
    trh, tth, x0h = tr[idx], tt[idx], x0[idx]
    res = robot.ik_batch(CFG, trh, tth, x0h, validate_seeds=False)
    ref = single_shot(robot, trh, tth, x0h)
    np.testing.assert_array_equal(np.asarray(res.found),
                                  np.asarray(ref.found))
    found = np.asarray(res.found)
    assert found.all()  # hard = screen-fails but full-budget-solvable
    assert int(res.overflow_count) > 0
    assert np.all(np.asarray(res.cost)[found] <= CFG.tol_f * (1 + 1e-6))
