"""Which batched solver Robot.ik_batch runs, and that kernel errors raise.

The kernel and cascade path is taken on the GPU only; the CPU runs the XLA
path (and the same route as the GPU under the ``_interpret`` test hook).
A kernel that fails to build or run raises: there is no silent fallback
to the XLA path.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest

from optik_tpu import Robot, SolverConfig
from optik_tpu import robot as robot_mod
from optik_tpu.config import SolutionMode
from optik_tpu.models import asset_path
from optik_tpu.ops.pallas import lm_kernel

SPEED = SolverConfig(max_restarts=16, seed_batch=8, max_iters=8)
QUALITY = SolverConfig.create("quality", max_restarts=16, seed_batch=8,
                              max_iters=8)


def fresh_robot():
    return Robot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                "panda_hand_tcp", dtype=jnp.float32)


def problem(robot, b=8):
    rng = np.random.default_rng(0)
    lo, hi = robot.joint_limits()
    tr, tt = robot.fk_batch(rng.uniform(lo, hi, size=(b, 7)))
    x0 = rng.uniform(lo, hi, size=(b, 7)).astype(np.float32)
    return np.asarray(tr, np.float32), np.asarray(tt, np.float32), x0


def fake_platform(monkeypatch, platform):
    dev = types.SimpleNamespace(platform=platform)
    monkeypatch.setattr(robot_mod.jax, "devices", lambda *a: [dev])


@pytest.mark.parametrize("platform,cfg,route", [
    ("cpu", SPEED, "xla"),
    ("cpu", QUALITY, "xla"),
    ("gpu", SPEED, robot_mod._GPU_ROUTE[SolutionMode.SPEED]),
    ("gpu", QUALITY, robot_mod._GPU_ROUTE[SolutionMode.QUALITY]),
])
def test_route_by_platform(monkeypatch, platform, cfg, route):
    robot = fresh_robot()
    fake_platform(monkeypatch, platform)
    assert robot._route(cfg) == route
    assert route != "xla" or platform == "cpu"


def test_cpu_ik_batch_builds_no_kernel(monkeypatch):
    robot = fresh_robot()
    tr, tt, x0 = problem(robot)

    def boom(*a, **k):
        raise AssertionError("kernel built on the CPU")

    monkeypatch.setattr(lm_kernel, "build_kernel_solver", boom)
    res = robot.ik_batch(SPEED, tr, tt, x0)
    assert np.asarray(res.found).any()
    assert not any(isinstance(k, tuple) for k in robot._solvers)


def test_kernel_build_error_raises(monkeypatch):
    robot = fresh_robot()
    robot._interpret = True
    tr, tt, x0 = problem(robot)

    def broken(*a, **k):
        raise RuntimeError("kernel build failed")

    monkeypatch.setattr(lm_kernel, "build_kernel_solver", broken)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        robot.ik_batch(SPEED, tr, tt, x0)
    assert not robot._solvers  # no XLA solver was built as a fallback


def test_kernel_run_error_raises(monkeypatch):
    robot = fresh_robot()
    robot._interpret = True
    tr, tt, x0 = problem(robot)

    def broken_solver(*a, **k):
        def run(*args, **kw):
            raise RuntimeError("kernel launch failed")
        return run

    monkeypatch.setattr(lm_kernel, "build_kernel_solver", broken_solver)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        robot.ik_batch(QUALITY, tr, tt, x0)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        robot.ik_batch(QUALITY, tr, tt, x0)
    assert QUALITY not in robot._solvers


def test_non_power_of_two_seed_lanes_take_xla(monkeypatch):
    """The Triton lowering needs power-of-two shapes: 6 seed lanes route to
    the XLA path by shape, on any platform."""
    robot = fresh_robot()
    robot._interpret = True
    cfg = SolverConfig(max_restarts=6, seed_batch=6, max_iters=8)
    assert robot._kernel_solver(cfg) is None
    assert robot._cascade_solver(cfg) is None
    tr, tt, x0 = problem(robot)
    res = robot.ik_batch(cfg, tr, tt, x0)
    assert cfg in robot._solvers
    assert np.asarray(res.found).shape == (8,)
