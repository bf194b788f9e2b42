#!/usr/bin/env python3
"""Success-rate parity vs an INDEPENDENT solver implementation.

The reference's published anchor is TRAC-IK (README.md:22-36); neither
tracikpy nor the reference wheel is installable here (no network), and the
repo's own C++ twin shares this repo's math.  The strongest independent
anchor available in-env is **scipy.optimize SLSQP**: an independent
implementation (Kraft's original SLSQP, the same algorithm family NLopt's
SLSQP wraps and the reference consumes, lib.rs:302-356) consuming our
golden-fixture-validated objective/gradient.  The math is externally
anchored by the byte-ported Pinocchio fixtures (tests/data, SURVEY §4);
this study independently anchors the SOLVER: random-restart SLSQP success
vs the batched projected-LM engine on identical poses, identical restart
seeds, identical tolerance.

Methodology mirrors the reference example loop (examples/example.py:19-47):
random reachable target (FK of uniform q), uniform random x0, tol_f=1e-6,
up to 64 restarts (restart 0 = x0, i>0 = the engine's own fold_in stream so
both solvers see THE SAME seed sequence), Speed semantics (stop at first
success).

Prints one JSON line.  Runs on CPU (success parity is about the algorithm,
not the chip).
"""

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np


def main():
    import jax

    # jax may already be imported with another platform registered;
    # config.update overrides post-import (this study is CPU-only).
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from optik_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp
    from scipy.optimize import minimize

    from optik_tpu import Robot, SolverConfig
    from optik_tpu.models import asset_path
    from optik_tpu.ops import objective as O
    from optik_tpu.solver import ik as ik_mod

    robot = Robot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                 "panda_hand_tcp", dtype=jnp.float64)
    params = robot.params
    lo, hi = robot.joint_limits()
    n = robot.num_positions()
    N = int(os.environ.get("OPTIK_PARITY_N", 2000))
    R = 64
    TOL = 1e-6

    rng = np.random.default_rng(42)
    q_tgt = rng.uniform(lo, hi, size=(N, n))
    x0s = rng.uniform(lo, hi, size=(N, n))

    # The engine's own restart seed table (fold_in stream, rng_seed 42) so
    # scipy explores the identical seed sequence.
    cfg = SolverConfig(max_restarts=R, seed_batch=8, max_iters=32,
                       tol_f=TOL)
    key = jax.random.PRNGKey(cfg.rng_seed)
    table = np.asarray(jax.vmap(
        lambda i: jax.random.uniform(
            jax.random.fold_in(key, i), (n,), dtype=jnp.float64,
            minval=jnp.asarray(lo), maxval=jnp.asarray(hi)))(
        jnp.arange(R)))

    @jax.jit
    def fk_rt(q):
        from optik_tpu.ops import kinematics as K

        return K.fk_ee(params, q, None, None)

    @jax.jit
    def f_and_g(q, tr, tt):
        r, j = O.residual_and_jacobian(params, q, tr, tt)
        f = jnp.dot(r, r)
        g = 2.0 * r @ j
        return f, g

    bounds = list(zip(lo, hi))

    t0 = time.time()
    scipy_found = 0
    scipy_restarts = []
    nit_total = 0
    for i in range(N):
        tr, tt = fk_rt(jnp.asarray(q_tgt[i]))
        tr = np.asarray(tr)
        tt = np.asarray(tt)

        def fun(q, tr=tr, tt=tt):
            f, g = f_and_g(jnp.asarray(q), jnp.asarray(tr), jnp.asarray(tt))
            return float(f), np.asarray(g)

        ok = False
        for r_i in range(R):
            x = x0s[i] if r_i == 0 else table[r_i]
            res = minimize(fun, x, jac=True, method="SLSQP", bounds=bounds,
                           options={"maxiter": 100, "ftol": 1e-12})
            nit_total += res.nit
            if res.fun <= TOL:
                ok = True
                scipy_restarts.append(r_i + 1)
                break
        scipy_found += ok
    scipy_s = time.time() - t0

    # Engine on the identical poses/seeds (XLA SoA path on CPU).
    solve = ik_mod.build_batch_solver(robot.spec, cfg, jnp.float64)
    tr_b, tt_b = robot.fk_batch(q_tgt)
    t0 = time.time()
    res_e = solve(jnp.asarray(tr_b), jnp.asarray(tt_b), jnp.asarray(x0s))
    eng_found = int(np.asarray(res_e.found).sum())
    eng_s = time.time() - t0

    both = N
    out = {
        "metric": "success_parity_vs_scipy_slsqp",
        "poses": N,
        "tol_f": TOL,
        "restarts": R,
        "scipy_slsqp_success": round(scipy_found / both, 5),
        "engine_success": round(eng_found / both, 5),
        "scipy_mean_restarts_to_success": round(
            float(np.mean(scipy_restarts)), 2) if scipy_restarts else None,
        "scipy_wall_s": round(scipy_s, 1),
        "scipy_solves_per_s": round(N / scipy_s, 1),
        "engine_wall_s_cpu_xla": round(eng_s, 1),
        "note": "independent SLSQP implementation (scipy, Kraft lineage = "
                "the reference's NLopt algorithm) on identical poses, "
                "seeds, and tolerance; objective/gradient math is the "
                "Pinocchio-golden-fixture-validated engine code",
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
