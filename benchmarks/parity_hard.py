#!/usr/bin/env python3
"""Discriminating hard-pose success parity: engine vs scipy SLSQP vs the
native C++ twin, on pose sets and budgets where success SEPARATES.

The round-4 anchor study (parity_scipy.py) tied 100.0% vs 100.0% on easy-
budget uniform poses — a tie at saturation discriminates nothing.  This
study measures the tail the reference's published
comparison is actually about (README.md:22-36):

  pose sets
    * panda_uniform  — uniform-in-limits targets (the baseline set);
    * panda_normal   — normal-distributed target configurations
                       (mid + 0.75 * halfwidth * N(0,1), clipped): mass
                       near the joint-limit boundary, where SLSQP's active
                       -set handling and the projected-LM box handling
                       genuinely differ;
    * ur5_tight      — UR5 with +-pi/2 limits (boundary-active stress,
                       BASELINE config 3's robot).

  budgets (identical restart seeds from the engine's fold_in stream)
    * weak    8 restarts;  engine 8 LM iters, scipy maxiter 30
    * strong 64 restarts;  engine 32 LM iters, scipy maxiter 100

  Iteration counts are NOT comparable across algorithm families (an SLSQP
  iteration is a QP subproblem; an LM iteration is one fused
  residual+Jacobian evaluation), so scipy gets a generous per-restart
  iteration budget and the comparison scarcity is the shared restart
  stream — biased AGAINST the engine on the weak budget, which is the
  point: a discriminating stress, not a fairness claim.

Per cell: success rates + failure-overlap buckets (both_fail = genuinely
hard pose; engine_only_fail = real convergence loss vs SLSQP).  The native
C++ twin (optik_host.cpp damped-GN, its own restart stream) runs as a
third, reference-architecture column.

CPU-only (success parity is about the algorithm, not the chip); f64.
Env: OPTIK_PARITY_N (default 10000), OPTIK_PARITY_SETS, OPTIK_PARITY_BUDGETS.
"""

import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np


def pose_sets(rng, n):
    """name -> (robot_key, q_tgt (N,A), x0 (N,A))."""
    import jax.numpy as jnp

    from optik_tpu import Robot
    from optik_tpu.models import asset_path
    from optik_tpu.models.chain import ChainSpec

    panda = Robot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                 "panda_hand_tcp", dtype=jnp.float64)
    lo, hi = panda.joint_limits()
    mid, half = (lo + hi) / 2, (hi - lo) / 2

    ur5 = Robot.from_urdf_file(asset_path("ur5.urdf"), "base_link",
                               "ee_link", dtype=jnp.float64)
    spec = ur5.spec
    tight = ChainSpec(
        joint_names=spec.joint_names, origin_r=spec.origin_r,
        origin_t=spec.origin_t, axis=spec.axis, prismatic=spec.prismatic,
        lower=np.full(6, -np.pi / 2), upper=np.full(6, np.pi / 2),
        tip_r=spec.tip_r, tip_t=spec.tip_t)
    ur5t = Robot(tight, dtype=jnp.float64)

    out = {}
    out["panda_uniform"] = (panda, rng.uniform(lo, hi, size=(n, 7)),
                            rng.uniform(lo, hi, size=(n, 7)))
    qn = np.clip(mid + 0.75 * half * rng.standard_normal((n, 7)), lo, hi)
    out["panda_normal"] = (panda, qn, rng.uniform(lo, hi, size=(n, 7)))
    lo5, hi5 = ur5t.joint_limits()
    out["ur5_tight"] = (ur5t, rng.uniform(lo5, hi5, size=(n, 6)),
                        rng.uniform(lo5, hi5, size=(n, 6)))
    return out


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from optik_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp
    from scipy.optimize import minimize

    from optik_tpu import SolverConfig
    from optik_tpu.models import asset_path
    from optik_tpu.native.host import HostChain
    from optik_tpu.ops import objective as O
    from optik_tpu.solver import ik as ik_mod

    n_poses = int(os.environ.get("OPTIK_PARITY_N", 10000))
    set_filter = os.environ.get("OPTIK_PARITY_SETS", "").split(",")
    budget_filter = os.environ.get("OPTIK_PARITY_BUDGETS", "").split(",")
    budgets = {
        "weak": dict(restarts=8, engine_iters=8, scipy_maxiter=30),
        "strong": dict(restarts=64, engine_iters=32, scipy_maxiter=100),
    }

    rng = np.random.default_rng(42)
    sets = pose_sets(rng, n_poses)

    def tightened_ur5_xml():
        """UR5 URDF with every revolute limit clamped to +-pi/2, so the
        native twin solves the same tight-limits problem."""
        import xml.etree.ElementTree as ET

        tree = ET.parse(asset_path("ur5.urdf"))
        for joint in tree.getroot().iter("joint"):
            if joint.get("type") != "revolute":
                continue
            lim = joint.find("limit")
            if lim is not None:
                lim.set("lower", str(-np.pi / 2))
                lim.set("upper", str(np.pi / 2))
        return ET.tostring(tree.getroot(), encoding="unicode")

    natives = {
        "panda_uniform": ("panda.urdf", "panda_link0", "panda_hand_tcp"),
        "panda_normal": ("panda.urdf", "panda_link0", "panda_hand_tcp"),
        "ur5_tight": (None, "base_link", "ee_link"),
    }

    for set_name, (robot, q_tgt, x0s) in sets.items():
        if set_filter != [""] and set_name not in set_filter:
            continue
        params = robot.params
        lo, hi = robot.joint_limits()
        a = robot.num_positions()
        tr_b, tt_b = robot.fk_batch(q_tgt)
        tr_np, tt_np = np.asarray(tr_b), np.asarray(tt_b)

        # Native twin on the same poses (reference-style GN restarts; its
        # own deterministic restart stream).
        urdf, base, ee = natives[set_name]
        if urdf is None:
            chain = HostChain.from_urdf_str(tightened_ur5_xml(), base, ee)
        else:
            chain = HostChain.from_urdf_file(asset_path(urdf), base, ee)

        @jax.jit
        def f_and_g(q, tr, tt):
            r, j = O.residual_and_jacobian(params, q, tr, tt)
            return jnp.dot(r, r), 2.0 * r @ j

        bounds = list(zip(lo, hi))

        for bname, bud in budgets.items():
            if budget_filter != [""] and bname not in budget_filter:
                continue
            r_total = bud["restarts"]
            cfg = SolverConfig(max_restarts=r_total, seed_batch=8,
                               max_iters=bud["engine_iters"], tol_f=1e-6)
            key = jax.random.PRNGKey(cfg.rng_seed)
            table = np.asarray(jax.vmap(
                lambda i: jax.random.uniform(
                    jax.random.fold_in(key, i), (a,), dtype=jnp.float64,
                    minval=jnp.asarray(lo), maxval=jnp.asarray(hi)))(
                jnp.arange(r_total)))

            # Engine (XLA SoA, f64).
            solve = ik_mod.build_batch_solver(robot.spec, cfg, jnp.float64)
            t0 = time.time()
            res_e = solve(jnp.asarray(tr_np), jnp.asarray(tt_np),
                          jnp.asarray(x0s))
            eng_found = np.asarray(res_e.found)
            t_eng = time.time() - t0

            # Iteration-sensitivity control: same restarts, full 32-iter
            # attempts — separates "LM needs more iterations per attempt"
            # from "LM can't reach this basin at all".
            eng32_rate = None
            if bud["engine_iters"] < 32:
                cfg32 = cfg.replace(max_iters=32)
                s32 = ik_mod.build_batch_solver(robot.spec, cfg32,
                                                jnp.float64)
                r32 = s32(jnp.asarray(tr_np), jnp.asarray(tt_np),
                          jnp.asarray(x0s))
                eng32_rate = round(float(np.asarray(r32.found).mean()), 5)

            # Native twin, same restart/iteration budget.
            t0 = time.time()
            nat_found = np.zeros(n_poses, dtype=bool)
            for i in range(n_poses):
                tgt = np.eye(4)
                tgt[:3, :3] = tr_np[i]
                tgt[:3, 3] = tt_np[i]
                r = chain.ik(tgt, x0s[i], tol_f=cfg.tol_f,
                             max_iters=cfg.max_iters,
                             max_restarts=r_total)
                nat_found[i] = r is not None
            t_nat = time.time() - t0

            # scipy SLSQP, identical seeds, Speed semantics.
            t0 = time.time()
            sci_found = np.zeros(n_poses, dtype=bool)
            for i in range(n_poses):
                tr, tt = tr_np[i], tt_np[i]

                def fun(q, tr=tr, tt=tt):
                    f, g = f_and_g(jnp.asarray(q), jnp.asarray(tr),
                                   jnp.asarray(tt))
                    return float(f), np.asarray(g)

                for r_i in range(r_total):
                    x = x0s[i] if r_i == 0 else table[r_i]
                    res = minimize(fun, x, jac=True, method="SLSQP",
                                   bounds=bounds,
                                   options={"maxiter": bud["scipy_maxiter"],
                                            "ftol": 1e-12})
                    if res.fun <= cfg.tol_f:
                        sci_found[i] = True
                        break
            t_sci = time.time() - t0

            print(json.dumps({
                "metric": "hard_pose_parity",
                "set": set_name, "budget": bname,
                "poses": n_poses,
                "restarts": r_total,
                "engine_iters": bud["engine_iters"],
                "scipy_maxiter": bud["scipy_maxiter"],
                "engine_success": round(float(eng_found.mean()), 5),
                "engine_success_iters32": eng32_rate,
                "native_success": round(float(nat_found.mean()), 5),
                "scipy_success": round(float(sci_found.mean()), 5),
                "both_fail_engine_scipy": int(
                    np.sum(~eng_found & ~sci_found)),
                "engine_only_fail_vs_scipy": int(
                    np.sum(~eng_found & sci_found)),
                "scipy_only_fail_vs_engine": int(
                    np.sum(eng_found & ~sci_found)),
                "all_three_fail": int(
                    np.sum(~eng_found & ~sci_found & ~nat_found)),
                "engine_wall_s": round(t_eng, 1),
                "native_wall_s": round(t_nat, 1),
                "scipy_wall_s": round(t_sci, 1),
            }), flush=True)


if __name__ == "__main__":
    main()
