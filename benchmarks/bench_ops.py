#!/usr/bin/env python3
"""Op-level micro-benchmarks, mirroring the reference's criterion set
(kylc/optik crates/optik/benches/bench.rs: gradient, objective, fk,
joint_jacobian, diff_ik, ik) — batched, on JAX's default device.

Prints one JSON line per op with throughput in ops/s and the device it ran
on.  Every timing ends in ``block_until_ready``.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import json
import time

import jax
import jax.numpy as jnp
import numpy as np


def timeit(fn, *args, n=20):
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def main():
    from optik_tpu import Robot, SolverConfig
    from optik_tpu.models import asset_path
    from optik_tpu.ops import soa
    from optik_tpu.utils.cache import enable_compile_cache
    from optik_tpu.utils.precision import with_f32_matmuls

    enable_compile_cache()

    robot = Robot.from_urdf_file(asset_path("ur3e.urdf"), "ur_base_link",
                                 "ur_ee_link", dtype=jnp.float32)
    a = robot.num_positions()
    L = 65536
    rng = np.random.default_rng(0)
    lo, hi = robot.joint_limits()
    q = jnp.asarray(rng.uniform(lo, hi, size=(L, a)), jnp.float32)
    qt = rng.uniform(lo, hi, size=(L, a))
    tr, tt = robot.fk_batch(qt)  # device-resident f32

    consts = soa.chain_constants(robot.spec)

    def unpack(q):
        return [q[:, j] for j in range(a)]

    @with_f32_matmuls
    @jax.jit
    def fk(q):
        _, r, t = soa.fk_joints(consts, unpack(q))
        return sum(t)

    @with_f32_matmuls
    @jax.jit
    def objective(q, tr, tt):
        tm = [[tr[:, i, j] for j in range(3)] for i in range(3)]
        tv = [tt[:, i] for i in range(3)]
        _, r_ee, t_ee = soa.fk_joints(consts, unpack(q))
        xr = soa.mat_mul(soa.mat_t(tm), r_ee)
        xt = soa.mat_tvec(tm, soa.vec_sub(t_ee, tv))
        e = soa.se3_log(xr, xt)
        return soa.vec_dot(e, e)

    @with_f32_matmuls
    @jax.jit
    def gradient(q, tr, tt):
        tm = [[tr[:, i, j] for j in range(3)] for i in range(3)]
        tv = [tt[:, i] for i in range(3)]
        e, jt = soa.residual_and_jtask(consts, unpack(q), tm, tv)
        return [2.0 * sum(e[i] * jt[i][p] for i in range(6)) for p in range(a)]

    results = {}
    results["fk"] = timeit(fk, q)
    results["objective"] = timeit(objective, q, tr, tt)
    results["gradient"] = timeit(gradient, q, tr, tt)

    # joint_jacobian through the public batched API
    jb = lambda q: robot.jacobian_batch(q)
    results["joint_jacobian"] = timeit(jb, q)

    # diff_ik batched
    B = 4096
    x0 = np.asarray(rng.uniform(lo, hi, size=(B, a)))
    v_we = rng.standard_normal((B, 6))
    v_max = np.ones((B, a))
    dik = lambda: robot.diff_ik_batch(x0, v_we, v_max, rescue=False)
    results["diff_ik"] = timeit(dik, n=3) / 1  # per call

    # ik batched (speed mode, default tolerance) through the public API
    cfg = SolverConfig(max_restarts=8, max_iters=48)
    Bik = 1024
    ikt = lambda: robot.ik_batch(cfg, tr[:Bik], tt[:Bik], q[:Bik],
                                 validate_seeds=False,
                                 rescue_overflow=False)
    results["ik"] = timeit(ikt, n=3)

    lanes = {"fk": L, "objective": L, "gradient": L, "joint_jacobian": L,
             "diff_ik": B, "ik": Bik}
    for name, dt in results.items():
        print(json.dumps({
            "metric": f"{name}_ops_per_s",
            "value": round(lanes[name] / dt, 1),
            "unit": "ops/s",
            "batch": lanes[name],
            "ms_per_batch": round(dt * 1e3, 3),
            "device": str(jax.devices()[0]),
        }))


if __name__ == "__main__":
    main()
