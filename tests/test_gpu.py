"""On-card contracts: the *compiled* Triton kernel and the GPU routes.

Every Pallas test elsewhere runs ``interpret=True`` on the CPU; these run
the compiled kernel on the card and pin its behavioral contract against the
XLA path *on the same device*:

  * the found set agrees with the XLA path's (same budget, same seeds; the
    two differ only in FMA contraction and reduction order, so at most a
    few marginal poses may flip);
  * every reported cost <= tol_f;
  * FK(solution) reaches the target;
  * repeat solves are bitwise identical;
  * seed-lane counts S in {1, 2, 4, 8, 64};
  * an ee_offset folded into the kernel, the 2-phase and 3-phase cascades,
    unlimited restarts through the traced ``restart_offset``, and overflow
    rescue through the compiled cascade.

``python chip_smoke.py`` runs this file in its own process on the card.
Each kernel program compiles for ~20 s (~55 s for a cascade), so the
``compiled`` fixture builds every solver the tests run once, compiles them
all at once in threads, and the tests share them through the module's
Robot (``Robot._kernel_solver`` and ``_cascade_solver`` cache them).
Without a GPU every test skips (the ``gpu`` fixture decides).
"""

import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from optik_tpu import Robot, SolverConfig
from optik_tpu.models import asset_path

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: python chip_smoke.py runs these on the "
                    "card")


# chip_smoke.py's Speed configuration and batch.
SPEED = SolverConfig(max_restarts=64, seed_batch=8, max_iters=32, tol_f=1e-6)
SPEED_B = 131072
SEED_LANES = [1, 2, 4, 8, 64]
CONTRACT_B = 1024


def contract_cfg(seed_batch):
    return SolverConfig.create("speed", max_restarts=max(16, seed_batch),
                               seed_batch=seed_batch, max_iters=24)


WEIGHTED = contract_cfg(8).replace(linear_weight=(0.0, 1.0, 1.0),
                                   angular_weight=(0.5, 1.0, 2.0))

# ee_offset contract: a constant tool transform folded into the kernel.
EE = np.eye(4)
EE[:3, :3] = np.array([[0.0, -1.0, 0.0],
                       [1.0, 0.0, 0.0],
                       [0.0, 0.0, 1.0]])
EE[:3, 3] = [0.03, -0.01, 0.12]
EE_CFG = contract_cfg(8)
EE_B = 128

# Unlimited restarts: a deliberately weak per-attempt budget (4 iterations)
# leaves failures for later rounds.  Its rounds_cap makes the first round's
# config (max_restarts = DEFAULT_RESTARTS = 64) equal to UNL_ROUND, so both
# share one compiled kernel.  UNL_B is below the cascade's minimum batch, so
# every round runs the single-shot kernel.
UNL_ROUND = SolverConfig(max_restarts=64, seed_batch=8, max_iters=4,
                         unlimited_rounds_cap=8)
UNL = UNL_ROUND.replace(max_restarts=0)
UNL_B = 128

# Overflow rescue: 24 restarts = 3 rounds of 8 lanes, so ik_batch takes
# the 2-phase cascade, whose replay holds B / 8 poses.
OVF = SolverConfig(max_restarts=24, seed_batch=8, max_iters=16)
OVF_SCREEN = OVF.replace(max_restarts=8)
OVF_B = 1024


@pytest.fixture(scope="module")
def compiled(gpu):
    """The module's Robot and its uncached solvers, every program compiled.

    The compiles overlap in threads; the XLA reference solvers land in the
    persistent compilation cache, where the tests' own builds find them.
    Every solver is built before the threads start, so each is built once.
    """
    from optik_tpu.parallel import mesh as mesh_mod
    from optik_tpu.solver import cascade
    from optik_tpu.solver import ik as ik_mod

    robot = Robot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                 "panda_hand_tcp", dtype=jnp.float32)
    seed_sharded = mesh_mod.build_seed_sharded_solver(
        robot, SPEED, mesh_mod.make_mesh(jax.devices()[:1], data=1, seed=1))
    two_phase = cascade.build_cascade_solver(robot.spec, SPEED,
                                             phase1_rounds=1, tail_div=8)

    def inputs(b):
        return (jnp.tile(jnp.eye(3, dtype=jnp.float32), (b, 1, 1)),
                jnp.zeros((b, 3), jnp.float32), jnp.zeros((b, 7), jnp.float32))

    def kernel(cfg):
        return robot._kernel_solver(cfg)[0]

    small, big = inputs(CONTRACT_B), inputs(SPEED_B)
    small_cfgs = [contract_cfg(s) for s in SEED_LANES]
    xla = {c: ik_mod.build_batch_solver(robot.spec, c, jnp.float32)
           for c in small_cfgs}
    kernels = {c: kernel(c) for c in small_cfgs + [WEIGHTED, SPEED,
                                                   UNL_ROUND, OVF_SCREEN,
                                                   OVF]}
    speed_cascade = robot._cascade_solver(SPEED)[0]
    ovf_cascade = robot._cascade_solver(OVF)[0]
    jobs = [lambda c=c: kernels[c](*small) for c in small_cfgs + [WEIGHTED]]
    jobs += [lambda c=c: xla[c](*small) for c in small_cfgs]
    jobs += [lambda: speed_cascade(*big), lambda: kernels[SPEED](*big),
             lambda: seed_sharded(*big),
             lambda: two_phase(*inputs(OVF_B)),
             # The ee_offset solver is built (and cached) inside ik_batch.
             lambda: robot.ik_batch(EE_CFG, *inputs(EE_B), ee_offset=EE,
                                    validate_seeds=False),
             lambda: kernels[UNL_ROUND](*inputs(UNL_B)),
             lambda: kernels[OVF_SCREEN](*inputs(2 * OVF_B)),
             lambda: kernels[OVF](*inputs(2 * OVF_B)),
             lambda: kernels[OVF](*inputs(OVF_B)),
             lambda: ovf_cascade(*inputs(OVF_B)),
             # The rescue re-solves the ~472 overflowed poses as one
             # power-of-two bucket through the traced restart_offset.
             lambda: kernels[OVF](*inputs(OVF_B // 2), restart_offset=0)]
    # Unlimited rounds after the first: power-of-two buckets of the
    # unconverged poses, padded to at least one block.
    jobs += [lambda n=n: kernels[UNL_ROUND](*inputs(n), restart_offset=64)
             for n in (8, 16, 32, 64, 128)]
    with ThreadPoolExecutor(len(jobs)) as ex:
        for fut in [ex.submit(lambda j=j: jax.block_until_ready(j()))
                    for j in jobs]:
            fut.result()
    return types.SimpleNamespace(robot=robot, seed_sharded=seed_sharded,
                                 two_phase=two_phase)


@pytest.fixture(scope="module")
def robot(compiled):
    return compiled.robot


def make_problem(robot, b, seed=0):
    rng = np.random.default_rng(seed)
    lo, hi = robot.joint_limits()
    qt = rng.uniform(lo, hi, size=(b, 7))
    tr, tt = robot.fk_batch(qt)
    x0 = rng.uniform(lo, hi, size=(b, 7)).astype(np.float32)
    return (jnp.asarray(tr, jnp.float32), jnp.asarray(tt, jnp.float32),
            jnp.asarray(x0))


def _fetch(res):
    return (np.asarray(res.found), np.asarray(res.x), np.asarray(res.cost))


def _reaches(robot, xs, tr, tt):
    xr, xt = robot.fk_batch(xs)
    np.testing.assert_allclose(np.asarray(xr), np.asarray(tr), atol=2e-3)
    np.testing.assert_allclose(np.asarray(xt), np.asarray(tt), atol=2e-3)


@pytest.mark.parametrize("seed_batch", SEED_LANES)
def test_compiled_kernel_contract(robot, seed_batch):
    """The compiled kernel at every seed-lane count."""
    from optik_tpu.solver import ik as ik_mod

    cfg = contract_cfg(seed_batch)
    B = CONTRACT_B
    tr, tt, x0 = make_problem(robot, B, seed=seed_batch)

    fn, _unit = robot._kernel_solver(cfg)
    found, xs, cost = _fetch(fn(tr, tt, x0))
    ref = ik_mod.build_batch_solver(robot.spec, cfg, jnp.float32)(tr, tt, x0)
    ref_found = np.asarray(ref.found)

    assert int(np.sum(found != ref_found)) <= max(2, B // 500)
    assert np.all(cost[found] <= cfg.tol_f * (1 + 1e-5))
    _reaches(robot, xs[found], np.asarray(tr)[found], np.asarray(tt)[found])

    found2, xs2, cost2 = _fetch(fn(tr, tt, x0))
    np.testing.assert_array_equal(found, found2)
    np.testing.assert_array_equal(xs, xs2)
    np.testing.assert_array_equal(cost, cost2)


def test_compiled_kernel_weighted(robot):
    """Weighted configs on the compiled kernel: the weighted solve differs
    from the unweighted one and meets the weighted tolerance."""
    tr, tt, x0 = make_problem(robot, CONTRACT_B, seed=99)
    fu, xu, _ = _fetch(robot._kernel_solver(contract_cfg(8))[0](tr, tt, x0))
    fw, xw, cw = _fetch(robot._kernel_solver(WEIGHTED)[0](tr, tt, x0))
    assert np.all(cw[fw] <= WEIGHTED.tol_f * (1 + 1e-5))
    assert not np.allclose(xw, xu, atol=1e-3)


def test_compiled_kernel_ee_offset(robot):
    """ee_offset folded into the compiled kernel's tip (through ik_batch's
    single-shot kernel) reaches the offset target through FK."""
    rng = np.random.default_rng(7)
    lo, hi = robot.joint_limits()
    qt = rng.uniform(lo, hi, size=(EE_B, 7))
    tr, tt = robot.fk_batch(qt, ee_offset=EE)
    tr = jnp.asarray(tr, jnp.float32)
    tt = jnp.asarray(tt, jnp.float32)
    x0 = jnp.asarray(rng.uniform(lo, hi, size=(EE_B, 7)).astype(np.float32))

    found, xs, cost = _fetch(robot.ik_batch(EE_CFG, tr, tt, x0,
                                            ee_offset=EE))
    assert found.sum() >= 0.9 * EE_B
    assert np.all(cost[found] <= EE_CFG.tol_f * (1 + 1e-5))
    xr, xt = robot.fk_batch(xs[found], ee_offset=EE)
    np.testing.assert_allclose(np.asarray(xr), np.asarray(tr)[found],
                               atol=2e-3)
    np.testing.assert_allclose(np.asarray(xt), np.asarray(tt)[found],
                               atol=2e-3)


def test_compiled_cascade(compiled):
    """The explicit 2-phase cascade (cascade.build_cascade_solver) on the
    card: deterministic, all reported costs within tolerance, FK reaches
    targets."""
    robot = compiled.robot
    tr, tt, x0 = make_problem(robot, OVF_B, seed=5)
    found, xs, cost = _fetch(compiled.two_phase(tr, tt, x0))
    found2, xs2, _ = _fetch(compiled.two_phase(tr, tt, x0))
    np.testing.assert_array_equal(found, found2)
    np.testing.assert_array_equal(xs, xs2)

    assert found.sum() >= 0.99 * OVF_B
    assert np.all(cost[found] <= SPEED.tol_f * (1 + 1e-5))
    _reaches(robot, xs[found], np.asarray(tr)[found], np.asarray(tt)[found])


def test_ik_batch_routes_cascade(robot):
    """Large Speed-mode batches through the public ik_batch take the
    cascade over the compiled kernel, with padding, deterministically."""
    cfg = SPEED
    assert robot._route(cfg) == "cascade"
    B = SPEED_B - 8  # not a block multiple: exercises padding too
    tr, tt, x0 = make_problem(robot, B, seed=7)
    found, xs, cost = _fetch(robot.ik_batch(cfg, tr, tt, x0))
    assert found.shape == (B,)
    assert found.sum() >= 0.99 * B
    assert np.all(cost[found] <= cfg.tol_f * (1 + 1e-5))
    _reaches(robot, xs[found], np.asarray(tr)[found], np.asarray(tt)[found])
    found2, xs2, _ = _fetch(robot.ik_batch(cfg, tr, tt, x0))
    np.testing.assert_array_equal(found, found2)
    np.testing.assert_array_equal(xs, xs2)


def test_default_cascade_success_floor_on_device(robot):
    """Default 3-phase schedule on the compiled kernel: found mask equals
    the single-shot kernel's.  Unreachable poses give the mid and final
    phases traffic."""
    cfg = SPEED
    B = SPEED_B
    tr, tt, x0 = make_problem(robot, B, seed=61)
    tt = np.asarray(tt).copy()
    tt[::1024] = tt[::1024] + 10.0  # 128 unreachable poses across blocks
    solve, unit = robot._cascade_solver(cfg)  # cascade.build_default_solver
    assert B % unit == 0
    got = solve(tr, jnp.asarray(tt), x0)
    ref = robot._kernel_solver(cfg)[0](tr, jnp.asarray(tt), x0)
    got_f = np.asarray(got.found)
    np.testing.assert_array_equal(got_f, np.asarray(ref.found))
    assert not got_f[::1024].any()
    assert got_f.sum() >= (B - 128) * 0.99


def test_diff_ik_gauge_on_device(robot):
    """The closed-form gauge diff-IK in float32 on the card: bounds,
    tracking, and LP optimality (vs scipy on the host)."""
    scipy_opt = pytest.importorskip("scipy.optimize")
    rng = np.random.default_rng(11)
    lo, hi = robot.joint_limits()
    B = SPEED_B  # chip_smoke.py's diff-IK batch: its compiled program
    x0 = rng.uniform(lo, hi, size=(B, 7))
    v_we = rng.standard_normal((B, 6))
    v_max = rng.uniform(0.3, 1.5, size=(B, 7))

    alpha, v, ok = map(np.asarray, robot.diff_ik_batch(x0, v_we, v_max))
    assert ok.mean() > 0.99
    assert np.all(alpha[ok] >= -1e-6) and np.all(alpha[ok] <= 1 + 1e-6)
    assert np.all(np.abs(v[ok]) <= v_max[ok] + 1e-5)
    for i in range(0, B, B // 5):
        if not ok[i]:
            continue
        j = robot.joint_jacobian(x0[i])
        r = robot.fk(x0[i])[:3, :3]
        jw = np.vstack([r @ j[:3], r @ j[3:]])
        c = np.zeros(8)
        c[7] = -1.0
        res = scipy_opt.linprog(
            c, A_eq=np.hstack([jw, -v_we[i][:, None]]), b_eq=np.zeros(6),
            bounds=[(-v_max[i][k], v_max[i][k]) for k in range(7)]
            + [(0.0, 1.0)], method="highs")
        assert res.success
        np.testing.assert_allclose(alpha[i], res.x[7], atol=5e-4)
        np.testing.assert_allclose(
            jw @ v[i], alpha[i] * v_we[i],
            atol=2e-5 * (1 + np.abs(v_we[i]).max()))


def test_unlimited_restarts_on_device(robot):
    """The compiled kernel's traced restart_offset path: unlimited mode
    (max_restarts=0) rescues poses a weak single round misses, with the
    first round's results preserved bitwise."""
    tr, tt, x0 = make_problem(robot, UNL_B, seed=5)
    r1 = robot.ik_batch(UNL_ROUND, tr, tt, x0, validate_seeds=False)
    ru = robot.ik_batch(UNL, tr, tt, x0, validate_seeds=False)
    f1, fu = np.asarray(r1.found), np.asarray(ru.found)
    # Superset + bitwise-preserved first-round winners.
    assert (fu | ~f1).all()
    np.testing.assert_array_equal(np.asarray(ru.x)[f1],
                                  np.asarray(r1.x)[f1])
    # The weak budget must leave failures for later rounds to rescue —
    # otherwise this test proves nothing.
    assert (~f1).sum() > 0, "weak budget solved everything; tighten it"
    assert fu.sum() > f1.sum(), "unlimited rounds rescued nothing"
    cost_u = np.asarray(ru.cost)
    assert np.all(cost_u[fu] <= UNL_ROUND.tol_f * 1.001)


def test_seed_sharded_degenerate_on_device(compiled):
    """The seed-sharded entry compiled on the (1, 1) mesh: bitwise equal to
    the plain single-shot kernel (same schedule), exercising shard_map and
    the pmin/psum merge through the real compiler."""
    robot = compiled.robot
    tr, tt, x0 = make_problem(robot, SPEED_B, seed=9)
    got = compiled.seed_sharded(tr, tt, x0)
    ref = robot._kernel_solver(SPEED)[0](tr, tt, x0)
    gf, rf = np.asarray(got.found), np.asarray(ref.found)
    np.testing.assert_array_equal(gf, rf)
    np.testing.assert_array_equal(np.asarray(got.x)[rf],
                                  np.asarray(ref.x)[rf])
    np.testing.assert_array_equal(np.asarray(got.cost)[rf],
                                  np.asarray(ref.cost)[rf])
    np.testing.assert_array_equal(np.asarray(got.x)[~gf],
                                  np.asarray(x0)[~gf])


def test_cascade_overflow_rescue_on_device(robot):
    """Public ik_batch budget contract on a curated hard batch through the
    compiled cascade: rescue restores the single-shot found mask."""
    # Screen-hard poses: fail the 8-restart screen, solvable at 24.
    tr, tt, x0 = make_problem(robot, 2 * OVF_B, seed=11)
    k_full = robot._kernel_solver(OVF)[0]
    scr = np.asarray(robot._kernel_solver(OVF_SCREEN)[0](tr, tt, x0).found)
    full = np.asarray(k_full(tr, tt, x0).found)
    hard = np.flatnonzero(~scr & full)
    easy = np.flatnonzero(scr)
    if hard.size < 1:
        pytest.skip("no screen-hard poses in this sample")
    # 600 hard replicas exceed the 2-phase schedule's 128-pose replay
    # capacity (OVF_B / 8).
    assert robot._route(OVF) == "cascade"
    idx = np.concatenate([np.resize(hard, 600), easy[:OVF_B - 600]])
    trh = jnp.asarray(np.asarray(tr)[idx])
    tth = jnp.asarray(np.asarray(tt)[idx])
    x0h = jnp.asarray(np.asarray(x0)[idx])
    res = robot.ik_batch(OVF, trh, tth, x0h, validate_seeds=False)
    ref_h = k_full(trh, tth, x0h)
    assert int(res.overflow_count) > 0
    np.testing.assert_array_equal(np.asarray(res.found),
                                  np.asarray(ref_h.found))
