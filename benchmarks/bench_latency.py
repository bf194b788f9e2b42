#!/usr/bin/env python3
"""Single-solve IK latency on device: the BASELINE "p50 solve latency" row.

The reference's latency contract is tens of µs per solve on a CPU core with
a 0.1 s ceiling (kylc/optik README.md:24-28, config.rs:56); the native C++
host path is the host-CPU latency path (tests/test_native.py).  This
measures the device path's scalar latency — ``robot.ik()`` routed through
the single-shot kernel with the pose padded to one block (robot.py) — which
launch and transfer costs, not solver math, are expected to dominate.
Methodology mirrors the reference's example loop (one solve per timed
call, examples/example.py:36-47).  Every timing ends in
``block_until_ready``.

Prints JSON lines:
  * scalar robot.ik() p50/p90 over N random reachable poses (full Python
    API surface, host-side parse + fetch included);
  * small-batch ik_batch latency for B in {1, 64, 256} (device path
    only), i.e. the real-time-control shape;
  * a B=8 split into synced, chained and in-program time per solve.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import json
import time

import jax
import numpy as np


def main():
    import jax.numpy as jnp

    from optik_tpu import Robot, SolverConfig
    from optik_tpu.models import asset_path
    from optik_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    robot = Robot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                 "panda_hand_tcp", dtype=jnp.float32)
    d0 = jax.devices()[0]
    dev = f"{d0.platform}:{d0.device_kind} x{len(jax.devices())}"
    cfg = SolverConfig(max_restarts=64, seed_batch=8, max_iters=32)
    rng = np.random.default_rng(7)
    lo, hi = robot.joint_limits()
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 50

    # --- scalar robot.ik(): the reference example loop, one pose a time ---
    targets = [np.asarray(robot.fk(rng.uniform(lo, hi))) for _ in range(n)]
    seeds = [rng.uniform(lo, hi) for _ in range(n)]
    robot.ik(cfg, targets[0], seeds[0])  # compile
    lats, ok = [], 0
    for tgt, x0 in zip(targets, seeds):
        t0 = time.perf_counter()
        out = robot.ik(cfg, tgt, x0)
        lats.append(time.perf_counter() - t0)
        ok += out is not None
    print(json.dumps({
        "metric": "scalar_ik_p50_us",
        "value": round(1e6 * float(np.median(lats)), 1), "unit": "us",
        "p90_us": round(1e6 * float(np.percentile(lats, 90)), 1),
        "success_rate": round(ok / n, 4), "solves": n, "device": dev,
    }), flush=True)

    # --- small-batch ik_batch: the real-time control shape ----------------
    for B in (1, 64, 256):
        qt = rng.uniform(lo, hi, size=(B, 7))
        tr, tt = robot.fk_batch(qt)
        x0 = jnp.asarray(rng.uniform(lo, hi, size=(B, 7)), jnp.float32)
        jax.block_until_ready((tr, tt, x0))

        def solve():
            return jax.block_until_ready(
                robot.ik_batch(cfg, tr, tt, x0, validate_seeds=False))

        solve()  # compile
        bl = []
        for _ in range(20):
            t0 = time.perf_counter()
            res = solve()
            bl.append(time.perf_counter() - t0)
        found = int(np.asarray(res.found).sum())
        p50 = float(np.median(bl))
        print(json.dumps({
            "metric": "ik_batch_latency_us", "batch": B,
            "value": round(1e6 * p50, 1), "unit": "us",
            "per_solve_us": round(1e6 * p50 / B, 2),
            "p90_us": round(1e6 * float(np.percentile(bl, 90)), 1),
            "success_rate": round(found / B, 4), "device": dev,
        }), flush=True)

    # --- dispatch/device split at B=8 ---------------------------------------
    # Three measurements of the same tiny solve separate the stack:
    #   synced     = block_until_ready per solve  -> + host round trip
    #   chained    = 16 solves, one sync          -> + per-dispatch overhead
    #   in-program = 16 solves inside ONE jit     -> device + program only
    B = 8
    qt = rng.uniform(lo, hi, size=(B, 7))
    tr, tt = robot.fk_batch(qt)
    x0 = jnp.asarray(rng.uniform(lo, hi, size=(B, 7)), jnp.float32)
    jax.block_until_ready((tr, tt, x0))
    cfg8 = SolverConfig(max_restarts=8, seed_batch=8, max_iters=32)
    solve8 = lambda x: robot.ik_batch(cfg8, tr, tt, x, validate_seeds=False)
    jax.block_until_ready(solve8(x0))
    lat_sync = []
    for _i in range(20):
        t0 = time.perf_counter()
        jax.block_until_ready(solve8(x0))
        lat_sync.append(time.perf_counter() - t0)

    def chained():
        t0 = time.perf_counter()
        last = None
        for _i in range(16):
            last = solve8(x0)
        jax.block_until_ready(last)
        return (time.perf_counter() - t0) / 16

    chained(); chained()
    per_call = float(np.median([chained() for _i in range(3)]))

    in_prog = None
    kentry = robot._kernel_solver(cfg8, None)
    if kentry is not None:
        kfn, _blk = kentry
        K = 16

        @jax.jit
        def chain_prog(tr_, tt_, x0_):
            acc = jnp.zeros((), jnp.int32)
            xcur = x0_
            for _i in range(K):
                r = kfn(tr_, tt_, xcur)
                acc = acc + jnp.sum(r.found.astype(jnp.int32))
                # data dependency defeats CSE between iterations
                xcur = x0_ + 0.0 * r.cost[:B, None]
            return acc

        jax.block_until_ready(chain_prog(tr, tt, x0))
        t0 = time.perf_counter()
        jax.block_until_ready(chain_prog(tr, tt, x0))
        in_prog = (time.perf_counter() - t0) / K
    print(json.dumps({
        "metric": "ik_b8_latency_split_ms", "batch": B,
        "synced_p50_ms": round(1e3 * float(np.median(lat_sync)), 2),
        "chained_per_call_ms": round(1e3 * per_call, 2),
        "inprogram_per_solve_ms": (None if in_prog is None
                                   else round(1e3 * in_prog, 3)),
        "device": dev,
    }), flush=True)


if __name__ == "__main__":
    main()
