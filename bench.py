#!/usr/bin/env python3
"""North-star benchmark: Panda 7-DoF IK solves/s on one GPU.

Methodology mirrors the reference's published benchmark loop
(kylc/optik examples/example.py:19-47): random seed configuration, random
*reachable* target (FK of a random configuration), solve at the default
TRAC-IK-equivalent tolerance (tol_f = 1e-6 on the squared log-pose error,
matching the reference default, config.rs:56-59).  The 10k-solve Python
loop becomes pose batches through the public ``Robot.ik_batch`` (on the GPU:
the cascade over the Triton kernel, see robot.py).  Each timed solve ends in
``block_until_ready``; compilation is excluded.

Prints ONE json line:
  {"metric": "panda_ik_solves_per_s", "value": ..., "unit": "solves/s", ...}
with the success rate, batch times, lane-iterations per solve, the model
FLOP/s and its share of the card's float32 peak, and the device it ran on
(platform, device_kind, device count, power limit).  Fails without a GPU.

    python bench.py [--batch 131072] [--reps 10]
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=131072)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: no GPU, JAX found {jax.devices()}")

    from optik_tpu import Robot, SolverConfig
    from optik_tpu.models import asset_path
    from optik_tpu.utils import roofline
    from optik_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.split("\n")[0]

    robot = Robot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                 "panda_hand_tcp", dtype=jnp.float32)
    n = robot.num_positions()
    # Speed mode, 8 lockstep lanes with continuous reseeding through a
    # 64-restart budget, 32 LM iterations per attempt; tol_f matches the
    # reference default.
    cfg = SolverConfig(max_restarts=64, seed_batch=8, max_iters=32,
                       tol_f=1e-6)
    b = args.batch
    rng = np.random.default_rng(42)
    lo, hi = robot.joint_limits()

    def make_batch():
        tr, tt = robot.fk_batch(rng.uniform(lo, hi, size=(b, n)))
        x0 = jnp.asarray(rng.uniform(lo, hi, size=(b, n)), jnp.float32)
        return jax.block_until_ready((tr, tt, x0))

    def solve(batch):
        return jax.block_until_ready(robot.ik_batch(
            cfg, *batch, validate_seeds=False, rescue_overflow=False))

    batches = [make_batch() for _ in range(args.reps)]
    t0 = time.perf_counter()
    solve(batches[0])
    compile_s = time.perf_counter() - t0

    times, found, work = [], 0, []
    for batch in batches:
        t0 = time.perf_counter()
        res = solve(batch)
        times.append(time.perf_counter() - t0)
        found += int(np.asarray(res.found).sum())
        work.append(float(res.lane_iters))
    med = float(np.median(times))

    cost = roofline.lane_iter_cost(robot.spec, cfg)
    util = roofline.utilization(float(np.median(work)), med, cost["flops"],
                                dev.device_kind)
    solver = next((k[0] for k in robot._solvers if isinstance(k, tuple)),
                  "xla")
    out = {
        "metric": "panda_ik_solves_per_s",
        "value": b / med,
        "unit": "solves/s",
        "success_rate": found / (b * len(batches)),
        "batch": b,
        "batch_ms_median": 1e3 * med,
        "batch_ms": [1e3 * t for t in times],
        "compile_s": compile_s,
        "lane_iters_per_solve": float(np.median(work)) / b,
        "flops_per_lane_iter": cost["flops"],
        "transcendentals_per_lane_iter": cost["transcendentals"],
        "seeds": cfg.seed_batch,
        "restarts": cfg.total_restarts,
        "max_iters": cfg.max_iters,
        "solver": "ik_batch/" + solver,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "devices": len(jax.devices()),
        "power_limit": power.strip(),
    }
    out.update(util)
    print(json.dumps(out))


if __name__ == "__main__":
    sys.exit(main())
