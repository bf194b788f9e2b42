#!/usr/bin/env python3
"""Success-rate parity: the device batch solver vs the native CPU solver on
an IDENTICAL reachable-pose set.

Is the batch solver's residual failure rate a set of genuinely hard poses
(the reference-style solver fails them too) or a lockstep-LM convergence
loss?  This harness answers it the way the reference measures itself
(examples/example.py:19-47): random reachable Panda targets, random seeds,
default tolerance — solved twice:

  * device path: the public ``Robot.ik_batch`` (bench.py's solver);
  * native path: optik_host.cpp's reference-style single solves (damped GN
    with random restarts) on the CPU, same restart/iteration budget.

Prints one JSON line with both success rates and the failure overlap:
``both_fail`` poses are evidence of genuinely hard poses;
``device_only_fail`` is the device path's true convergence loss vs a
reference-style solver.

    python benchmarks/parity_native.py [N_BATCHES]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from optik_tpu import Robot, SolverConfig
    from optik_tpu.models import asset_path
    from optik_tpu.native.host import HostChain
    from optik_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    n_batches = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    B = 16384
    N = n_batches * B

    robot = Robot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                 "panda_hand_tcp", dtype=jnp.float32)
    cfg = SolverConfig(max_restarts=64, seed_batch=8, max_iters=32,
                       tol_f=1e-6)

    rng = np.random.default_rng(42)  # bench.py methodology, same seed
    lo, hi = robot.joint_limits()
    q_tgt = rng.uniform(lo, hi, size=(N, 7))
    x0 = rng.uniform(lo, hi, size=(N, 7))

    # --- device path: the public ik_batch, batch by batch ----------------
    dev_found = np.zeros(N, dtype=bool)
    t0 = time.perf_counter()
    for i in range(n_batches):
        sl = slice(i * B, (i + 1) * B)
        tr, tt = robot.fk_batch(q_tgt[sl])
        res = robot.ik_batch(cfg, tr, tt, jnp.asarray(x0[sl], jnp.float32))
        dev_found[sl] = np.asarray(res.found)
    t_dev = time.perf_counter() - t0
    path = robot._route(cfg)
    d0 = jax.devices()[0]

    # --- native path: reference-style single solves on CPU --------------
    chain = HostChain.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                     "panda_hand_tcp")
    native_found = np.zeros(N, dtype=bool)
    t0 = time.perf_counter()
    for i in range(N):
        tgt = chain.fk(q_tgt[i])
        r = chain.ik(tgt, x0[i], tol_f=cfg.tol_f, max_iters=cfg.max_iters,
                     max_restarts=cfg.total_restarts)
        native_found[i] = r is not None
    t_native = time.perf_counter() - t0

    both_fail = int(np.sum(~dev_found & ~native_found))
    dev_only = int(np.sum(~dev_found & native_found))
    native_only = int(np.sum(dev_found & ~native_found))

    print(json.dumps({
        "metric": "panda_success_parity",
        "n_poses": N,
        "device_success_rate": round(float(dev_found.mean()), 5),
        "native_success_rate": round(float(native_found.mean()), 5),
        "both_fail": both_fail,
        "device_only_fail": dev_only,
        "native_only_fail": native_only,
        "device_solver": "ik_batch/" + path,
        "device": f"{d0.platform}:{d0.device_kind}",
        "device_wall_s": round(t_dev, 1),
        "native_wall_s": round(t_native, 1),
        "budget": {"max_restarts": cfg.total_restarts,
                   "seed_batch": cfg.seed_batch,
                   "max_iters": cfg.max_iters, "tol_f": cfg.tol_f},
    }))


if __name__ == "__main__":
    sys.exit(main())
