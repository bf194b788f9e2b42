"""SoA (component) compute path vs the array reference path.

The SoA path (ops/soa.py + solver/lm_soa.py) is the production fast path on
accelerators; the array path (ops/kinematics.py + solver/lm.py) is the readable
reference.  They must agree to float tolerance on every intermediate the
solver consumes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from optik_tpu import Robot, SolverConfig
from optik_tpu.models import asset_path
from optik_tpu.ops import objective as O, soa
from optik_tpu.solver import ik as ik_mod, lm, lm_soa


@pytest.fixture(scope="module", params=["ur3e", "panda"])
def robot(request):
    if request.param == "ur3e":
        return Robot.from_urdf_str(asset_path("ur3e.urdf").read_text(),
                                   "ur_base_link", "ur_ee_link")
    return Robot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                "panda_hand_tcp")


def random_targets(robot, rng, b):
    lo, hi = robot.joint_limits()
    qt = rng.uniform(lo, hi, size=(b, robot.num_positions()))
    r, t = robot.fk_batch(qt)
    return jnp.asarray(np.asarray(r)), jnp.asarray(np.asarray(t))


@pytest.mark.parametrize("weights", [(None, None),
                                     ((0.0, 5.0, 0.25), (0.005, 1.0, 0.99))])
def test_residual_jacobian_equivalence(robot, weights):
    wl, wa = weights
    rng = np.random.default_rng(0)
    B = 16
    a = robot.num_positions()
    q = jnp.asarray(rng.standard_normal((B, a)))
    tr, tt = random_targets(robot, rng, B)

    # Array path.
    r_ref, j_ref = jax.vmap(lambda qi, ri, ti: O.residual_and_jacobian(
        robot.params, qi, ri, ti, wl=wl, wa=wa))(q, tr, tt)

    # SoA path.
    consts = soa.chain_constants(robot.spec)
    qs = [q[:, j] for j in range(a)]
    tgtm = [[tr[:, i, j] for j in range(3)] for i in range(3)]
    tgtt = [tt[:, i] for i in range(3)]
    w6 = soa.weight6_from_config(tgtm, wl, wa)
    e, jt = soa.residual_and_jtask(consts, qs, tgtm, tgtt, weight6=w6)

    e_arr = np.stack([np.asarray(c) for c in e], axis=-1)
    np.testing.assert_allclose(e_arr, np.asarray(r_ref), atol=1e-10)
    for i in range(6):
        for p in range(a):
            np.testing.assert_allclose(np.asarray(jt[i][p]),
                                       np.asarray(j_ref)[:, i, p], atol=1e-9)


def test_fk_ee_equivalence(robot):
    rng = np.random.default_rng(1)
    a = robot.num_positions()
    q = rng.standard_normal((8, a))
    consts = soa.chain_constants(robot.spec)
    qs = [jnp.asarray(q[:, j]) for j in range(a)]
    _, r_ee, t_ee = soa.fk_joints(consts, qs)
    r_ref, t_ref = robot.fk_batch(q)
    for i in range(3):
        np.testing.assert_allclose(np.asarray(t_ee[i]),
                                   np.asarray(t_ref)[:, i], atol=1e-12)
        for j in range(3):
            np.testing.assert_allclose(np.asarray(r_ee[i][j]),
                                       np.asarray(r_ref)[:, i, j], atol=1e-12)


def test_solver_equivalence(robot):
    """Full LM solve: SoA vs array path find the same solutions."""
    rng = np.random.default_rng(2)
    a = robot.num_positions()
    B = 8
    tr, tt = random_targets(robot, rng, B)
    lo, hi = robot.joint_limits()
    x0 = jnp.asarray(np.clip(np.zeros((B, a)), lo, hi))

    opts = ik_mod.options_from_config(SolverConfig(max_restarts=1))

    res_ref = lm.solve(robot.params, x0, tr, tt, opts)
    consts = soa.chain_constants(robot.spec)
    res_soa = lm_soa.solve_soa(consts, [float(v) for v in lo],
                               [float(v) for v in hi], opts, x0, tr, tt)

    # The SoA loop evaluates cost through the fused residual (one FK per
    # iteration), so borderline lanes can diverge by float round-off; demand
    # agreement on the vast majority and matching solutions where both
    # converged.
    s_soa = np.asarray(res_soa.success)
    s_ref = np.asarray(res_ref.success)
    assert (s_soa == s_ref).mean() >= 0.9
    both = s_soa & s_ref
    np.testing.assert_allclose(np.asarray(res_soa.x)[both],
                               np.asarray(res_ref.x)[both], atol=1e-5)


def test_robot_ik_uses_soa_and_matches_reference_path(robot):
    """robot.ik (SoA fast path) vs the array-path ik_one oracle.

    Speed-mode winners may differ between the paths (the fast path freezes a
    pose at the earliest success in iteration order; the oracle picks the
    lowest restart index after running everything), so compare found-ness
    and that the fast path's solution genuinely reaches the target — and
    compare solutions exactly in Quality mode, where both paths explore the
    full restart set.
    """
    rng = np.random.default_rng(3)
    tr, tt = random_targets(robot, rng, 4)
    lo, hi = robot.joint_limits()
    x0 = np.clip(np.zeros(robot.num_positions()), lo, hi)
    for mode in ("speed", "quality"):
        cfg = SolverConfig.create(mode, max_restarts=8)
        for i in range(4):
            m = np.eye(4)
            m[:3, :3] = np.asarray(tr[i])
            m[:3, 3] = np.asarray(tt[i])
            sol = robot.ik(cfg, m, x0)
            ref = ik_mod.ik_one(robot.params, cfg, tr[i], tt[i],
                                jnp.asarray(x0, robot.dtype))
            assert (sol is not None) == bool(ref.found)
            if sol is None:
                continue
            assert sol[1] <= cfg.tol_f * (1 + 1e-6)
            if mode == "quality":
                np.testing.assert_allclose(sol[0], np.asarray(ref.x),
                                           atol=1e-5)
