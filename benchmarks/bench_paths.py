#!/usr/bin/env python3
"""Time Robot.ik_batch through each solver path on one card.

For the two IK configurations of chip_smoke.py (Speed: 64 restarts, 8 seed
lanes, 32 iterations, B = 131072; Quality: 256 restarts, 64 seed lanes, 48
iterations, B = 4096) this builds each solver that ``Robot.ik_batch`` can
route to and times it on the same inputs — the plain XLA loop ("xla",
solver/ik.build_batch_solver), the single-shot Triton kernel ("kernel",
lm_kernel.build_kernel_solver) and, for Speed, the cascade over the kernel
("cascade", cascade.build_default_solver) — and reports per path:
solves/s, found count, lane-iterations per solve, compile seconds and peak
device memory.  Kernel paths run at every ``--lanes`` (lanes per block)
given; the single-shot kernel also at every ``--unroll`` value.  Both
batches are block multiples, so no padding is timed.  Compilation is
excluded from the timings and every timing ends in ``block_until_ready``.

    python benchmarks/bench_paths.py [--modes speed,quality]
        [--lanes 64,128,256] [--unroll 1] [--reps 5]

Prints one JSON line per measurement (and writes them to
chiprun_out/bench_paths.jsonl); fails without a GPU.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

CONFIGS = {
    "speed": (dict(max_restarts=64, seed_batch=8, max_iters=32,
                   tol_f=1e-6), 131072),
    "quality": (dict(max_restarts=256, seed_batch=64, max_iters=48),
                4096),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--modes", default="speed,quality")
    ap.add_argument("--lanes", default="64,128,256")
    ap.add_argument("--unroll", default="1")
    ap.add_argument("--paths", default="xla,kernel,cascade")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench_paths: no GPU, JAX found {jax.devices()}")

    from optik_tpu import Robot, SolverConfig
    from optik_tpu.models import asset_path
    from optik_tpu.ops.pallas import lm_kernel
    from optik_tpu.solver import cascade
    from optik_tpu.solver import ik as ik_mod
    from optik_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    out_dir = pathlib.Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    sink = open(out_dir / "bench_paths.jsonl", "a")

    def emit(**kw):
        kw.update(card=card, platform=dev.platform, device_kind=dev.device_kind,
                  devices=len(jax.devices()))
        line = json.dumps(kw)
        print(line, flush=True)
        sink.write(line + "\n")
        sink.flush()

    robot = Robot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                 "panda_hand_tcp", dtype=jnp.float32)
    spec = robot.spec
    lo, hi = robot.joint_limits()
    rng = np.random.default_rng(0)
    for mode in args.modes.split(","):
        kw, b = CONFIGS[mode]
        cfg = SolverConfig.create(mode, **kw)
        tr, tt = robot.fk_batch(rng.uniform(lo, hi, size=(b, 7)))
        x0 = jnp.asarray(rng.uniform(lo, hi, size=(b, 7)), jnp.float32)
        jax.block_until_ready((tr, tt, x0))
        s = lm_kernel.seed_lanes(cfg)
        runs = []
        for path in args.paths.split(","):
            if path == "xla":
                runs.append((path, None, None, ik_mod.build_batch_solver(
                    spec, cfg, jnp.float32)))
                continue
            if path == "cascade" and mode != "speed":
                continue
            for ln in map(int, args.lanes.split(",")):
                p_blk = lm_kernel.block_poses(s, ln)
                if path == "cascade":
                    runs.append((path, ln, None, cascade.build_default_solver(
                        spec, cfg, p_blk=p_blk)[0]))
                    continue
                runs += [(path, ln, u, lm_kernel.build_kernel_solver(
                    spec, cfg, p_blk=p_blk, unroll=u))
                    for u in map(int, args.unroll.split(","))]
        for path, lanes, unroll, fn in runs:
            t0 = time.perf_counter()
            res = jax.block_until_ready(fn(tr, tt, x0))
            first = time.perf_counter() - t0
            ts = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                res = jax.block_until_ready(fn(tr, tt, x0))
                ts.append(time.perf_counter() - t0)
            med = float(np.median(ts))
            stats = dev.memory_stats() or {}
            emit(mode=mode, path=path, lanes_per_block=lanes, unroll=unroll,
                 batch=b, solves_per_s=b / med, batch_ms=1e3 * med,
                 batch_ms_all=[1e3 * t for t in ts],
                 found=int(np.asarray(res.found).sum()),
                 lane_iters_per_solve=float(res.lane_iters) / b,
                 overflow=(None if res.overflow_count is None
                           else int(res.overflow_count)),
                 compile_s=first - med,
                 peak_bytes_in_use=stats.get("peak_bytes_in_use"))
    sink.close()


if __name__ == "__main__":
    sys.exit(main())
