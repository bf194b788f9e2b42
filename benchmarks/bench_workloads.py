#!/usr/bin/env python3
"""The BASELINE.json benchmark configurations, beyond the north-star:

  2. Batched random-restart IK: 1k random Panda poses x 256 seeds,
     Quality-mode nearest-to-seed selection.
  3. UR5 6-DoF with tight joint limits (boundary-active stress).
  4. Differential-IK Cartesian interpolation with velocity limits as
     batched QP steps.
  5. Motion-planning workload: 1M random pose queries in pose-sharded
     chunks (single-host version; the multi-host variant shards the same
     chunks over the "data" mesh axis).

Prints one JSON line per config.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import json
import time

import jax
import numpy as np


def timed(fn):
    """(result, seconds) of one call after a warm-up, to block_until_ready."""
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def timed_sets(fn, sets=3):
    """Median per-call seconds over ``sets`` calls after a warm-up.

    Returns ``(out, median, spread, sets_ms)``; every call ends in
    ``block_until_ready``.  ``spread`` is (max - min) / median."""
    jax.block_until_ready(fn())
    vals = []
    for _ in range(sets):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        vals.append(time.perf_counter() - t0)
    vals.sort()
    med = vals[len(vals) // 2]
    spread = (vals[-1] - vals[0]) / med if med > 0 else 0.0
    return out, med, spread, [round(v * 1e3, 2) for v in vals]


def main():
    import jax.numpy as jnp

    from optik_tpu import Robot, SolverConfig
    from optik_tpu.models import asset_path
    from optik_tpu.models.chain import ChainSpec
    from optik_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    d0 = jax.devices()[0]
    if d0.platform != "gpu":
        raise SystemExit(f"bench_workloads: no GPU, JAX found {jax.devices()}")
    dev = {"platform": d0.platform, "device_kind": d0.device_kind,
           "devices": len(jax.devices())}
    rng = np.random.default_rng(0)

    # --- config 2: 1k poses x 256 seeds, Quality mode --------------------
    # Recorded at the BASELINE shape (B=1024) AND at B=4096.  Both rows
    # carry lane_iters_per_solve: every Quality pose consumes its full
    # budget by definition (lib.rs:398-408), so lane-iterations per solve
    # near (mean attempt length + 1) * 256 means the lockstep loop wastes
    # nothing beyond attempt-length variance within its blocks.
    panda = Robot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                 "panda_hand_tcp", dtype=jnp.float32)
    lo, hi = panda.joint_limits()
    cfg_q = SolverConfig.create("quality", max_restarts=256, seed_batch=64,
                                max_iters=48)
    for B in (1024, 4096):
        qt = rng.uniform(lo, hi, size=(B, 7))
        tr_b, tt_b = panda.fk_batch(qt)  # stays on device
        x0_b = jnp.asarray(rng.uniform(lo, hi, size=(B, 7)), jnp.float32)
        jax.block_until_ready((tr_b, tt_b, x0_b))
        # validate_seeds=False: seeds are in-limits by construction here.
        res, dt, spread, sets_ms = timed_sets(
            lambda: panda.ik_batch(cfg_q, tr_b, tt_b, x0_b,
                                   validate_seeds=False))
        li = (float(res.lane_iters) if res.lane_iters is not None
              else float("nan"))
        row = {
            "metric": "panda_quality_256seed_solves_per_s",
            "value": round(B / dt, 1), "unit": "solves/s",
            "spread": round(spread, 4), "set_ms": sets_ms,
            "success_rate": round(
                float(jnp.mean(res.found.astype(jnp.float32))), 4),
            "lane_iters_per_solve": round(li / B, 1),
            "batch": B, "seeds": 256, **dev}
        if B == 1024:
            # Reused by the cap rows below.
            tr, tt, x0, res_q, dt_q = tr_b, tt_b, x0_b, res, dt
        print(json.dumps(row))
    B, res, dt = 1024, res_q, dt_q

    # Same workload under the quality_max_successes semantic extension
    # (config.py): truncate each pose's exploration after
    # k successful attempts.  Reports the quality give-up alongside the
    # speedup: mean/max seed-distance regression vs full reference
    # semantics over the found poses.
    d_full = jnp.linalg.norm(res.x - x0, axis=-1)
    for k in (8, 2):
        cfg_k = cfg_q.replace(quality_max_successes=k)
        res_k, dt_k = timed(
            lambda: panda.ik_batch(cfg_k, tr, tt, x0, validate_seeds=False))
        f = np.asarray(res.found) & np.asarray(res_k.found)
        d_k = jnp.linalg.norm(res_k.x - x0, axis=-1)
        dreg = np.asarray(d_k - d_full)[f]
        print(json.dumps({
            "metric": "panda_quality_256seed_cap_solves_per_s",
            "cap": k, "value": round(B / dt_k, 1), "unit": "solves/s",
            "speedup_vs_full": round(dt / dt_k, 3),
            "success_rate": round(
                float(jnp.mean(res_k.found.astype(jnp.float32))), 4),
            "seed_dist_regression_mean": round(float(dreg.mean()), 4),
            "seed_dist_regression_max": round(float(dreg.max()), 4),
            "batch": B, "seeds": 256, **dev}))

    # --- config 3: UR5 tight limits --------------------------------------
    ur5 = Robot.from_urdf_file(asset_path("ur5.urdf"), "base_link", "ee_link")
    spec = ur5.spec
    tight = ChainSpec(
        joint_names=spec.joint_names, origin_r=spec.origin_r,
        origin_t=spec.origin_t, axis=spec.axis, prismatic=spec.prismatic,
        lower=np.full(6, -np.pi / 2), upper=np.full(6, np.pi / 2),
        tip_r=spec.tip_r, tip_t=spec.tip_t)
    ur5t = Robot(tight, dtype=jnp.float32)
    B = 4096
    qt = rng.uniform(-np.pi / 2, np.pi / 2, size=(B, 6))
    tr5, tt5 = ur5t.fk_batch(qt)  # stays on device
    x05 = jnp.asarray(
        rng.uniform(-np.pi / 2, np.pi / 2, size=(B, 6)), jnp.float32)
    jax.block_until_ready((tr5, tt5, x05))
    cfg5 = SolverConfig(max_restarts=64, seed_batch=8, max_iters=48)
    res, dt, spread, sets_ms = timed_sets(
        lambda: ur5t.ik_batch(cfg5, tr5, tt5, x05, validate_seeds=False,
                              rescue_overflow=False))
    print(json.dumps({
        "metric": "ur5_tight_limits_solves_per_s",
        "value": round(B / dt, 1), "unit": "solves/s",
        "spread": round(spread, 4), "set_ms": sets_ms,
        "success_rate": round(float(jnp.mean(res.found.astype(jnp.float32))), 4),
        "batch": B, **dev}))

    # --- config 4: diff-IK batched QP steps ------------------------------
    B = 4096
    # Device-resident inputs, uploaded once outside the timed region.
    x0d = jnp.asarray(rng.uniform(lo, hi, size=(B, 7)), jnp.float32)
    v_we = jnp.asarray(np.tile(np.array([0, 0, 0.1, 0, 0, 0.0]), (B, 1)),
                       jnp.float32)
    v_max = jnp.asarray(np.full((B, 7), 0.75), jnp.float32)
    jax.block_until_ready((x0d, v_we, v_max))
    # rescue=False inside the timed region (the rescue fetches the ok
    # mask to the host); one rescued call afterwards records the
    # Clarabel-parity ok rate the public default delivers.
    res, dt, spread, sets_ms = timed_sets(
        lambda: panda.diff_ik_batch(x0d, v_we, v_max, rescue=False))
    res_rescued = panda.diff_ik_batch(x0d, v_we, v_max)
    print(json.dumps({
        "metric": "diff_ik_steps_per_s",
        "value": round(B / dt, 1), "unit": "steps/s",
        "spread": round(spread, 4), "set_ms": sets_ms,
        "ok_rate": round(float(jnp.mean(res[2].astype(jnp.float32))), 4),
        "ok_rate_rescued": round(
            float(jnp.mean(res_rescued[2].astype(jnp.float32))), 4),
        "batch": B, **dev}))

    # --- config 5: 1M-pose motion-planning workload ----------------------
    cfg = SolverConfig(max_restarts=64, seed_batch=8, max_iters=32)
    # Chunk size (OPTIK_MP_CHUNK) and count (OPTIK_MP_CHUNKS) of the sweep.
    import os as _os
    chunk = int(_os.environ.get("OPTIK_MP_CHUNK", 65536))
    # Default: 4 chunks = 262k poses; OPTIK_MP_CHUNKS=15 runs the full
    # ~1M-pose sweep (983,040 poses at the default chunk).
    n_chunks = int(_os.environ.get("OPTIK_MP_CHUNKS",
                                   max(4, 131072 // chunk)))
    # validate_seeds=False: chunk seeds are uniform-in-limits by
    # construction (robot.ik_batch docstring).
    solve = lambda a, b, c: panda.ik_batch(cfg, a, b, c,
                                           validate_seeds=False,
                                           rescue_overflow=False)
    # Warm up compile.
    qt = rng.uniform(lo, hi, size=(chunk, 7))
    trc, ttc = panda.fk_batch(qt)
    x0c = rng.uniform(lo, hi, size=(chunk, 7)).astype(np.float32)
    out = solve(trc, ttc, jnp.asarray(x0c))
    jax.block_until_ready(out)

    # Pre-generate chunks, then time the solve chain to block_until_ready.
    chunks = []
    for _ in range(n_chunks):
        qt = rng.uniform(lo, hi, size=(chunk, 7))
        trc, ttc = panda.fk_batch(qt)
        x0c = jnp.asarray(rng.uniform(lo, hi, size=(chunk, 7)), jnp.float32)
        chunks.append((trc, ttc, x0c))
    jax.block_until_ready(chunks)

    def sweep():
        t0 = time.perf_counter()
        count = jnp.zeros((), jnp.int32)
        for trc, ttc, x0c in chunks:
            out = solve(trc, ttc, x0c)
            c = out.found_count if out.found_count is not None \
                else jnp.sum(out.found.astype(jnp.int32))
            count = count + c
        jax.block_until_ready(count)
        return int(count), time.perf_counter() - t0

    # Cold sweep: every chunk's first execution; the steady sweeps re-solve
    # the same poses and give the headline.
    found, dt_cold = sweep()
    sweeps = sorted(sweep()[1] for _ in range(3))
    found, _ = sweep()
    dt = sweeps[1]
    spread = (sweeps[-1] - sweeps[0]) / dt if dt > 0 else 0.0
    n = chunk * n_chunks
    print(json.dumps({
        "metric": "motion_planning_solves_per_s",
        "value": round(n / dt, 1), "unit": "solves/s",
        "spread": round(spread, 4),
        "set_s": [round(v, 3) for v in sweeps],
        "cold_sweep_solves_per_s": round(n / dt_cold, 1),
        "success_rate": round(found / n, 4),
        "poses": n, **dev}))


if __name__ == "__main__":
    main()
