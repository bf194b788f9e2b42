#!/usr/bin/env python3
"""Scaling-efficiency harness: solves/s vs device count on a (data, seed) mesh.

On several GPUs this measures the scaling efficiency (target >= 0.8,
BASELINE.md).  On a CPU host with fake devices
(XLA_FLAGS=--xla_force_host_platform_device_count=N, and ``--interpret`` so
the Pallas kernels run in the interpreter) it validates the mechanics only:
fake-device "scaling" shares one socket, so its efficiency numbers mean
nothing.

    python benchmarks/bench_scaling.py [--interpret]

Prints one JSON line per device count, naming the device it ran on.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import argparse
import json
import time

import jax
import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--interpret", action="store_true",
                    help="run the Pallas kernels in the interpreter "
                    "(CPU fake devices)")
    interp = ap.parse_args().interpret

    import jax.numpy as jnp

    from optik_tpu import Robot, SolverConfig
    from optik_tpu.models import asset_path
    from optik_tpu.parallel import mesh as pmesh
    from optik_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    d0 = jax.devices()[0]
    dev = {"platform": d0.platform, "device_kind": d0.device_kind}

    robot = Robot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                 "panda_hand_tcp", dtype=jnp.float32)
    n_total = len(jax.devices())
    cfg = SolverConfig(max_restarts=64, seed_batch=8, max_iters=48)
    rng = np.random.default_rng(0)
    lo, hi = robot.joint_limits()

    base_rate = None
    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_total]
    for n in counts:
        mesh = pmesh.make_mesh(jax.devices()[:n], data=n, seed=1)
        B = 1024 * n  # weak scaling: constant work per device
        qt = rng.uniform(lo, hi, size=(B, 7))
        tr, tt = robot.fk_batch(qt)
        tr = np.asarray(tr, np.float32)
        tt = np.asarray(tt, np.float32)
        x0 = rng.uniform(lo, hi, size=(B, 7)).astype(np.float32)

        res = pmesh.ik_sharded(robot, cfg, tr, tt, x0, mesh)
        jax.block_until_ready(res)
        t0 = time.perf_counter()
        iters = 3
        for _ in range(iters):
            res = pmesh.ik_sharded(robot, cfg, tr, tt, x0, mesh)
            jax.block_until_ready(res.found)
        dt = (time.perf_counter() - t0) / iters
        rate = B / dt
        if base_rate is None:
            base_rate = rate
        print(json.dumps({
            "metric": "scaling_solves_per_s",
            "devices": n,
            "value": round(rate, 1),
            "unit": "solves/s",
            "efficiency": round(rate / (base_rate * n), 3),
            "success_rate": round(float(np.asarray(res.found).mean()), 4),
            "batch": B, **dev,
        }), flush=True)

    # Same weak-scaling series on the production throughput path: the
    # tuned 3-phase cascade shard_mapped per pose shard (zero collectives;
    # parallel/mesh.build_sharded_cascade default schedule).  Interpret-mode
    # on CPU/fake devices validates mechanics only.  The "devices": 0 row is
    # the UNSHARDED default solver on the same single-device batch — the
    # shard-count-1 sharded row against it measures shard_map overhead.
    from optik_tpu.solver import cascade as cascade_mod

    def timeit(solve, tr, tt, x0, iters=3):
        jax.block_until_ready(solve(tr, tt, x0))
        t0 = time.perf_counter()
        for _ in range(iters):
            res = jax.block_until_ready(solve(tr, tt, x0))
        return (time.perf_counter() - t0) / iters, res

    def emit(tag, n, B, rate, res, eff):
        print(json.dumps({
            "metric": tag, "devices": n, "value": round(rate, 1),
            "unit": "solves/s", "efficiency": eff,
            "success_rate": round(float(np.asarray(res.found).mean()), 4),
            "batch": B, "interpret": interp, **dev,
        }), flush=True)

    per = 4096 if not interp else 32
    base_rate = None
    for n in counts:
        mesh = pmesh.make_mesh(jax.devices()[:n], data=n, seed=1)
        B = per * n
        qt = rng.uniform(lo, hi, size=(B, 7))
        tr, tt = robot.fk_batch(qt)
        tr = np.asarray(tr, np.float32)
        tt = np.asarray(tt, np.float32)
        x0 = rng.uniform(lo, hi, size=(B, 7)).astype(np.float32)
        if n == 1:
            # Unsharded reference on the identical batch (overhead bound).
            ref, _u = cascade_mod.build_default_solver(
                robot.spec, cfg, dtype=robot.dtype, interpret=interp)
            dt, res = timeit(ref, jnp.asarray(tr), jnp.asarray(tt),
                             jnp.asarray(x0))
            emit("scaling_cascade_solves_per_s", 0, B, B / dt, res, None)
        solve = pmesh.build_sharded_cascade(robot, cfg, mesh,
                                            interpret=interp)
        dt, res = timeit(solve, tr, tt, x0)
        rate = B / dt
        if base_rate is None:
            base_rate = rate
        emit("scaling_cascade_solves_per_s", n, B, rate, res,
             round(rate / (base_rate * n), 3))


if __name__ == "__main__":
    main()
