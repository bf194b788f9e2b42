#!/usr/bin/env python3
"""Smoke run of the main path on an NVIDIA GPU, checked against references.

Run from the repository root on a machine with a card:

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the multi-card entries

All phases go through the public API on the bundled Panda
(``panda_link0`` -> ``panda_hand_tcp``) in float32 with x64 off, as users
run it, at full width:

  ik-speed    Robot.ik_batch, max_restarts=64, seed_batch=8, max_iters=32,
              tol_f=1e-6, B = 131072 random reachable poses, random seeds;
  ik-quality  Robot.ik_batch, Quality mode, 256 restarts, seed_batch=64,
              max_iters=48, B = 4096;
  diff-ik     Robot.diff_ik_batch, B = 131072;
  fk          Robot.fk_batch and Robot.jacobian_batch, B = 131072;
  scalar      Robot.ik, Robot.diff_ik, Robot.fk;
  tests       the ``gpu``-marked tests (tests/test_gpu.py), in this process.

Checks: each IK phase against the plain XLA solver (solver/ik.
build_batch_solver) on the same card and inputs — found sets differ on at
most 0.1% of poses, repeat solves are bitwise identical, and every found
pose's cost recomputed in float64 by the array-path oracle
(ops/kinematics.py, ops/objective.py) is at most 1.01 * tol_f; diff-IK on a
4096-lane subset against the same solver in float64 on the host (alpha,
velocity bounds, and tracking J_W(q) v = alpha V_WE); FK and
Jacobians against ops/kinematics in float64 on the host.  The float64
references run on the CPU backend after every GPU phase.

Precision: every float32 contraction runs at HIGHEST precision
(utils/precision.with_f32_matmuls); TF32 is never used.

Any failure raises and exits non-zero; no phase's exception is caught.  A
missing GPU is an error.  The last line of standard output is one JSON
object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SPEED_B = 131072
QUALITY_B = 4096
DIFFIK_B = 131072
DIFFIK_CHECK = 4096
SHARD_B = 32768           # poses per card for the sharded cascade
FOUND_DIFF_MAX = 1e-3     # share of poses whose found-ness may differ
COST_SLACK = 1.01         # float64 cost <= COST_SLACK * tol_f


T0 = time.perf_counter()


def log(**kw):
    """One JSON line per phase, with the card's peak memory so far."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    kw["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    kw["elapsed_s"] = time.perf_counter() - T0
    print(json.dumps(kw, default=float), flush=True)


def timed(fn, reps=3):
    """(first result, last result, first-call s, median steady s)."""
    import jax

    t0 = time.perf_counter()
    first = jax.block_until_ready(fn())
    t_first = time.perf_counter() - t0
    last, ts = first, []
    for _ in range(reps):
        t0 = time.perf_counter()
        last = jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return first, last, t_first, float(np.median(ts)) if ts else t_first


def host(res):
    return {k: np.asarray(v) for k, v in res._asdict().items()
            if v is not None}


def assert_bitwise(a, b, what):
    for k in ("found", "x", "cost"):
        if not np.array_equal(a[k], b[k]):
            raise AssertionError(f"{what}: repeat solve differs in {k}")


def problem(robot, b, rng):
    import jax
    import jax.numpy as jnp

    lo, hi = robot.joint_limits()
    tr, tt = robot.fk_batch(rng.uniform(lo, hi, size=(b, 7)))
    x0 = jnp.asarray(rng.uniform(lo, hi, size=(b, 7)), jnp.float32)
    return jax.block_until_ready((tr, tt, x0))


def ik_phase(name, robot, cfg, b, rng, oracle):
    """Public ik_batch vs the plain XLA solver on the same card."""
    import jax.numpy as jnp

    from optik_tpu.solver import ik as ik_mod

    tr, tt, x0 = problem(robot, b, rng)
    first, last, t_first, t_steady = timed(
        lambda: robot.ik_batch(cfg, tr, tt, x0, validate_seeds=False))
    got, got2 = host(first), host(last)
    assert_bitwise(got, got2, name)

    xla = ik_mod.build_batch_solver(robot.spec, cfg, jnp.float32)
    ref1, ref2, x_first, x_steady = timed(lambda: xla(tr, tt, x0), reps=1)
    ref = host(ref1)
    assert_bitwise(ref, host(ref2), name + " (xla)")

    n_diff = int(np.sum(got["found"] != ref["found"]))
    log(phase=name, path=robot._route(cfg), batch=b,
        compile_s=t_first - t_steady, solves_per_s=b / t_steady,
        found=int(got["found"].sum()), found_xla=int(ref["found"].sum()),
        found_differs=n_diff,
        lane_iters_per_solve=float(got["lane_iters"]) / b,
        xla_compile_s=x_first - x_steady, xla_solves_per_s=b / x_steady)
    if n_diff > FOUND_DIFF_MAX * b:
        raise AssertionError(f"{name}: found sets differ on {n_diff}/{b}")
    for res in (got, ref):
        f = res["found"]
        oracle.append((name, np.asarray(tr)[f], np.asarray(tt)[f],
                       res["x"][f], cfg.tol_f))


def card_phases(robot, rng, oracle):
    import jax
    import jax.numpy as jnp

    from optik_tpu import SolverConfig

    speed = SolverConfig(max_restarts=64, seed_batch=8, max_iters=32,
                         tol_f=1e-6)
    ik_phase("ik-speed", robot, speed, SPEED_B, rng, oracle)
    quality = SolverConfig.create("quality", max_restarts=256,
                                  seed_batch=64, max_iters=48)
    ik_phase("ik-quality", robot, quality, QUALITY_B, rng, oracle)

    lo, hi = robot.joint_limits()
    x0 = rng.uniform(lo, hi, size=(DIFFIK_B, 7))
    v_we = rng.standard_normal((DIFFIK_B, 6))
    v_max = rng.uniform(0.3, 1.5, size=(DIFFIK_B, 7))
    args = [jnp.asarray(a, jnp.float32) for a in (x0, v_we, v_max)]
    first, last, t_first, t_steady = timed(
        lambda: robot.diff_ik_batch(*args))
    alpha, v, ok = map(np.asarray, first)
    for a, b_ in zip((alpha, v, ok), map(np.asarray, last)):
        if not np.array_equal(a, b_):
            raise AssertionError("diff-ik: repeat step differs")
    log(phase="diff-ik", batch=DIFFIK_B, compile_s=t_first - t_steady,
        steps_per_s=DIFFIK_B / t_steady, ok=int(ok.sum()))
    oracle.append(("diff-ik", x0, v_we, v_max, alpha, v, ok))

    q = rng.uniform(lo, hi, size=(SPEED_B, 7))
    qd = jnp.asarray(q, jnp.float32)
    (r, t), _, t_first, t_steady = timed(lambda: robot.fk_batch(qd))
    jac, _, j_first, j_steady = timed(lambda: robot.jacobian_batch(qd))
    log(phase="fk", batch=SPEED_B, compile_s=t_first - t_steady,
        fk_per_s=SPEED_B / t_steady, jacobian_compile_s=j_first - j_steady,
        jacobians_per_s=SPEED_B / j_steady)
    oracle.append(("fk", np.asarray(qd, np.float64), np.asarray(r),
                   np.asarray(t), np.asarray(jac)))

    t0 = time.perf_counter()
    q1 = robot.random_configuration(rng)
    target = robot.fk(q1)
    sol = robot.ik(speed, target, robot.random_configuration(rng))
    if sol is None:
        raise AssertionError("scalar ik found no solution")
    step = robot.diff_ik(q1, np.array([0.1, 0.0, 0.0, 0.0, 0.0, 0.2]),
                         np.ones(7))
    if step is None or not 0.0 <= step[0] <= 1.0:
        raise AssertionError(f"scalar diff_ik returned {step}")
    log(phase="scalar", seconds=time.perf_counter() - t0, ik_cost=sol[1],
        diff_ik_alpha=step[0])
    oracle.append(("scalar", q1, target, np.asarray(sol[0]),
                   speed.tol_f))


def run_tests():
    import pytest

    os.environ["OPTIK_TEST_DEVICE"] = "gpu"
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "--durations=0",
                      os.path.join(ROOT, "tests", "test_gpu.py")])
    if rc != 0:
        raise AssertionError(f"gpu tests failed (pytest exit {rc})")
    log(phase="tests", pytest_exit=rc)


def host_references(spec, oracle):
    """float64 references on the CPU backend, after every GPU phase."""
    import jax
    import jax.numpy as jnp

    from optik_tpu import Robot
    from optik_tpu.ops import kinematics as K
    from optik_tpu.ops import objective as O

    jax.config.update("jax_enable_x64", True)
    f64 = jnp.float64
    with jax.default_device(jax.devices("cpu")[0]):
        params = K.ChainParams.from_spec(spec, dtype=f64)
        cost = jax.jit(jax.vmap(
            lambda q, r, t: O.objective(params, q, r, t)))
        fk = jax.jit(jax.vmap(lambda q: K.fk_ee(params, q)))
        jacf = jax.jit(jax.vmap(lambda q: K.joint_jacobian(params, q)))
        for entry in oracle:
            name = entry[0]
            if name in ("ik-speed", "ik-quality"):
                _, tr, tt, x, tol_f = entry
                c = np.asarray(cost(jnp.asarray(x, f64),
                                    jnp.asarray(tr, f64),
                                    jnp.asarray(tt, f64)))
                worst = float(c.max()) if c.size else 0.0
                log(phase=name + "/f64-oracle", poses=int(c.size),
                    worst_cost=worst)
                if worst > COST_SLACK * tol_f:
                    raise AssertionError(
                        f"{name}: float64 cost {worst} > {COST_SLACK}*tol_f")
            elif name == "diff-ik":
                _, x0, v_we, v_max, alpha, v, ok = entry
                n = DIFFIK_CHECK
                r64 = Robot(spec, dtype=f64)
                a64, v64, ok64 = map(np.asarray, r64.diff_ik_batch(
                    x0[:n], v_we[:n], v_max[:n]))
                both = ok[:n] & ok64
                da = float(np.abs(alpha[:n] - a64)[both].max())
                over = float((np.abs(v[:n]) / v_max[:n])[ok[:n]].max())
                n_diff = int(np.sum(ok[:n] != ok64))
                # Tracking: the card's v moves the EE along alpha * V_WE,
                # J_W(q) v = alpha V_WE with the world-frame Jacobian in
                # float64, to 2e-5 relative to |V_WE|.
                q64 = jnp.asarray(x0[:n], f64)
                rot = np.asarray(fk(q64)[0])
                jl = np.asarray(jacf(q64))
                jw = np.concatenate([rot @ jl[:, :3], rot @ jl[:, 3:]], 1)
                resid = np.abs(np.einsum("nij,nj->ni", jw, v[:n])
                               - alpha[:n, None] * v_we[:n])
                scale = 1 + np.abs(v_we[:n]).max(axis=1)
                track = float((resid.max(axis=1) / scale)[ok[:n]].max())
                log(phase="diff-ik/f64-reference", lanes=n,
                    max_abs_dalpha=da, max_v_over_vmax=over,
                    max_tracking_err=track, ok_differs=n_diff)
                if (da > 1e-4 or over > 1 + 1e-5 or track > 2e-5
                        or n_diff > 1e-3 * n):
                    raise AssertionError("diff-ik: f64 reference mismatch")
            elif name == "fk":
                _, q, r, t, jac = entry
                r64, t64 = map(np.asarray, fk(jnp.asarray(q, f64)))
                j64 = np.asarray(jacf(jnp.asarray(q, f64)))
                er = float(np.abs(r - r64).max())
                et = float(np.abs(t - t64).max())
                ej = float(np.abs(jac - j64).max())
                log(phase="fk/f64-oracle", max_rot_err=er, max_trans_err=et,
                    max_jacobian_err=ej)
                # FK: 1e-5 per entry.  Jacobian entries are lever arms up to
                # ~1 m built from seven float32 frames: 1e-4.
                if er > 1e-5 or et > 1e-5 or ej > 1e-4:
                    raise AssertionError("fk: float64 oracle mismatch")
            elif name == "scalar":
                _, q1, target, sol, tol_f = entry
                c = float(cost(jnp.asarray(sol[None], f64),
                               jnp.asarray(target[None, :3, :3], f64),
                               jnp.asarray(target[None, :3, 3], f64))[0])
                log(phase="scalar/f64-oracle", ik_cost=c)
                if c > COST_SLACK * tol_f:
                    raise AssertionError(f"scalar ik: float64 cost {c}")


def four_cards(robot, rng):
    """The multi-card entries on a 4-card mesh vs their references."""
    import jax
    import jax.numpy as jnp

    from optik_tpu import SolverConfig
    from optik_tpu.ops.pallas import lm_kernel
    from optik_tpu.parallel import mesh as mesh_mod
    from optik_tpu.solver import cascade
    from optik_tpu.solver import ik as ik_mod

    cfg = SolverConfig(max_restarts=64, seed_batch=8, max_iters=32,
                       tol_f=1e-6)
    devs = jax.devices()[:4]
    data4 = mesh_mod.make_mesh(devs, data=4, seed=1)
    shard = SHARD_B
    p_casc = problem(robot, 4 * shard, rng)
    p_seed = problem(robot, SPEED_B, rng)
    p_xla = problem(robot, SPEED_B, rng)

    casc = mesh_mod.build_sharded_cascade(robot, cfg, data4)
    local, _unit = cascade.build_default_solver(robot.spec, cfg)
    seed = mesh_mod.build_seed_sharded_solver(
        robot, cfg, mesh_mod.make_mesh(devs, data=2, seed=2))
    single = lm_kernel.build_kernel_solver(robot.spec, cfg)
    xla = ik_mod.build_batch_solver(robot.spec, cfg, jnp.float32)

    def sharded_xla():
        return mesh_mod.ik_sharded(robot, cfg, *p_xla, data4)

    calls = {
        "sharded-cascade": lambda: casc(*p_casc),
        "local-cascade": lambda: [
            local(*(a[k * shard:(k + 1) * shard] for a in p_casc))
            for k in range(4)],
        "seed-sharded": lambda: seed(*p_seed),
        "single-kernel": lambda: single(*p_seed),
        "ik-sharded": sharded_xla,
        "xla": lambda: xla(*p_xla),
    }
    # Each program compiles for 10-60 s; compiling them in threads
    # overlaps the compiles (the first call of each also runs it once).
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(calls)) as ex:
        futs = {k: ex.submit(lambda f=f: jax.block_until_ready(f()))
                for k, f in calls.items()}
        first = {k: f.result() for k, f in futs.items()}
    log(phase="four-card-compile", programs=len(calls),
        seconds=time.perf_counter() - t0)

    got = host(first["sharded-cascade"])
    for k, res in enumerate(first["local-cascade"]):
        sl = slice(k * shard, (k + 1) * shard)
        ref = host(res)
        for f in ("found", "x", "cost"):
            if not np.array_equal(got[f][sl], ref[f]):
                raise AssertionError(f"sharded cascade shard {k}: {f}")
    _, _, _, t = timed(calls["sharded-cascade"], reps=2)
    log(phase="sharded-cascade", batch=4 * shard, cards=4,
        solves_per_s=4 * shard / t, found=int(got["found"].sum()),
        bitwise_vs_local="equal")

    gf = np.asarray(first["seed-sharded"].found)
    if not np.array_equal(gf, np.asarray(first["single-kernel"].found)):
        raise AssertionError("seed-sharded: found mask differs")
    _, _, _, t = timed(calls["seed-sharded"], reps=2)
    log(phase="seed-sharded", batch=SPEED_B, cards=4, mesh="data=2,seed=2",
        solves_per_s=SPEED_B / t, found=int(gf.sum()),
        found_vs_single_device="equal")

    got, ref = host(first["ik-sharded"]), host(first["xla"])
    for f in ("found", "x", "cost"):
        if not np.array_equal(got[f], ref[f]):
            raise AssertionError(f"ik_sharded: {f} differs from unsharded")
    _, _, _, t = timed(sharded_xla, reps=2)
    log(phase="ik-sharded", batch=SPEED_B, cards=4, mesh="data=4,seed=1",
        solves_per_s=SPEED_B / t, found=int(got["found"].sum()),
        bitwise_vs_unsharded="equal")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card entries on four cards")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU, JAX found {devs}")
    need = 4 if args.four_cards else 1
    if len(devs) < need:
        raise SystemExit(f"chip_smoke: needs {need} GPUs, found {devs}")

    sys.path.insert(0, ROOT)
    import optik_tpu

    if not os.path.abspath(optik_tpu.__file__).startswith(ROOT + os.sep):
        raise SystemExit("chip_smoke: optik_tpu is not beside this script")
    import jax.numpy as jnp

    from optik_tpu import Robot
    from optik_tpu.models import asset_path
    from optik_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    print(smi, flush=True)
    print(devs, flush=True)

    robot = Robot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                 "panda_hand_tcp", dtype=jnp.float32)
    rng = np.random.default_rng(args.seed)
    if args.four_cards:
        four_cards(robot, rng)
    else:
        oracle = []
        card_phases(robot, rng, oracle)
        run_tests()
        host_references(robot.spec, oracle)

    # ``count`` is the number of cards the run used, not the number visible.
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": need}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
