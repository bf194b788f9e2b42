"""Every float32 contraction of the public programs runs at HIGHEST
precision (utils/precision.with_f32_matmuls): on the GPU a DEFAULT-precision
float32 dot may run in TF32, which keeps about three decimal digits."""

import jax
import jax.numpy as jnp
import pytest

from optik_tpu import Robot, SolverConfig
from optik_tpu import robot as robot_mod
from optik_tpu.models import asset_path
from optik_tpu.solver import diffik
from optik_tpu.utils.precision import with_f32_matmuls

F32 = jnp.float32


def S(*shape):
    return jax.ShapeDtypeStruct(shape, F32)


@pytest.fixture(scope="module")
def robot():
    return Robot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                "panda_hand_tcp", dtype=F32)


def _programs(robot):
    cfg = SolverConfig(max_restarts=16, seed_batch=8, max_iters=8)
    return {
        "ik_batch": lambda: robot._solver(cfg).lower(S(8, 3, 3), S(8, 3),
                                                     S(8, 7)),
        "diff_ik_batch": lambda: robot._diffik_solver().lower(
            S(8, 7), S(8, 6), S(8, 7)),
        "diff_ik_rescue": lambda: diffik.diff_ik_admm_batch.lower(
            robot.params, S(8, 7), S(8, 6), S(8, 7), None, None),
        "fk_batch": lambda: robot._fk_batch_fn().lower(S(8, 7), None, None),
        "jacobian_batch": lambda: robot._jac_batch_fn().lower(
            S(8, 7), None, None),
        "fk": lambda: robot_mod._fk_jit.lower(robot.params, S(7), None,
                                              None),
        "joint_jacobian": lambda: robot_mod._jac_jit.lower(
            robot.params, S(7), None, None),
    }


@pytest.mark.parametrize("name", ["ik_batch", "diff_ik_batch",
                                  "diff_ik_rescue", "fk_batch",
                                  "jacobian_batch", "fk", "joint_jacobian"])
def test_dot_generals_are_highest(robot, name):
    text = _programs(robot)[name]().as_text()
    dots = [ln for ln in text.splitlines() if "stablehlo.dot_general" in ln]
    for ln in dots:
        assert "precision = [HIGHEST, HIGHEST]" in ln, ln


def test_precision_check_sees_dots(robot):
    """The check above is not vacuous: the scalar FK and the ADMM rescue
    contain float32 dots, and an undecorated jit lowers them at DEFAULT."""
    progs = _programs(robot)
    for name in ("fk", "diff_ik_rescue"):
        assert "stablehlo.dot_general" in progs[name]().as_text()

    @jax.jit
    def plain(a, b):
        return a @ b

    assert "HIGHEST" not in plain.lower(S(3, 3), S(3, 3)).as_text()
    assert "HIGHEST" in with_f32_matmuls(plain).lower(
        S(3, 3), S(3, 3)).as_text()
