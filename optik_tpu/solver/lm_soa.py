"""Lockstep projected-LM solver on the SoA compute path (the fast path).

Semantics are identical to solver/lm.py (same stopping criteria, same
Nielsen damping, same success classification — see that module for the
reference mapping); the differences are representational and structural:

  * all small-matrix math is unrolled into per-component element-wise ops on
    lane-shaped arrays (see ops/soa.py);
  * exactly ONE fused residual+Jacobian evaluation per loop iteration — and
    none outside the loop.  The first iteration of every attempt (including
    the very first, and every reseed) is an "adopt" step: the lane evaluates
    its seed point, takes its cost, and only checks the stopval criterion.
    Subsequent iterations propose a damped-GN step from the carried (e, J),
    and the trial evaluation doubles as the next step's Jacobian;
  * continuous reseeding: the deterministic replacement for the reference's
    work-stealing restart stream (lib.rs:298-301).  With a seed table
    (R, A) and S lanes per pose, lane l strides restart indices l, l+S,
    l+2S, ...; a lane whose attempt ends without success adopts its next
    seed on the following iteration instead of idling until the batch
    drains;
  * Speed mode freezes a whole pose at its earliest success (the
    deterministic analog of the reference's cross-thread abort flag);
    Quality mode explores the full restart budget, tracking a per-lane best
    success by distance to the caller's seed (lib.rs:398-408).

The loop core (:func:`lm_loop`) operates purely on *component lists* of
lane-shaped arrays, so the exact same code runs under jit on sliced HBM
arrays (this module's :func:`solve_soa`) and inside the Pallas kernel on
one block of lanes held in registers (ops/pallas/lm_kernel.py).  Lane axes
can be any shape — (L,), (B, S), (P, S) — every op is element-wise over
them; the seed-group axis for Speed-mode pose freezing is the last one.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops import soa
from .lm import LMOptions, LMResult

class LoopOut(NamedTuple):
    """lm_loop result: component lists over the lane shape."""

    xs: tuple            # A components: final (or best) iterate
    f: jnp.ndarray       # final (or best) cost
    success: jnp.ndarray
    iters: jnp.ndarray   # () global iterations executed
    restart_index: Optional[jnp.ndarray]  # None without reseeding
    # Per-lane attempt-iteration count at the lane's FIRST success (0 when
    # the lane never succeeded) — the iterations-to-converge observability
    # signal surfaced through IKResult.iters.
    succ_iters: Optional[jnp.ndarray] = None


def lm_loop(consts, lower, upper, opts: LMOptions,
            xs0, tgtm, tgtt, eem=None, eev=None, weight6=None, *,
            seed_lookup=None,       # callable: idx array -> A components
            lane_index=None,        # int array broadcastable to lane shape
            total_restarts: int = 0,
            s_lanes: int = 1,       # lanes per pose (stride)
            success_stops_group: bool = False,
            explore_full_budget: bool = False,
            qx0=None,               # A components: caller's seed (quality)
            group_success_cap: Optional[int] = None,
            unroll: int = 1) -> LoopOut:
    """The lockstep LM loop on component lists (see module docstring).

    ``group_success_cap`` (Quality mode only, config.quality_max_successes):
    freeze a pose once its lanes have collectively completed that many
    successful attempts — the best-so-far tracking still selects the
    min-seed-distance among them.  A pose with any success stays found, so
    the found mask is identical to the uncapped schedule; only the
    *selection pool* shrinks (documented semantic extension).

    ``unroll``: apply the loop body ``unroll`` times per ``while``
    iteration.  The schedule semantics are identical for any value —
    stopped lanes hold their state through selects and all per-lane
    budget checks live inside the body — but the loop condition (a
    cross-lane all-reduce + scalar branch) is paid ``unroll``x less
    often.  Costs: up to ``unroll - 1`` no-op trailing iterations per
    block (still counted in ``iters``: genuinely executed work), and
    results may
    differ from ``unroll=1`` by float rounding (the compiler contracts
    the unrolled body differently), like any recompilation would.
    Determinism holds per compiled program, which is what the contract
    promises.  Bound: the reported ``iters`` can exceed
    ``(max_iters + 1) * rounds`` by at most ``unroll - 1`` trailing
    applications (genuinely executed no-op work; default unroll=1 makes
    this exact).
    """
    a = len(xs0)
    lane_shape = jnp.broadcast_shapes(*[jnp.shape(x) for x in xs0])
    dtype = xs0[0].dtype

    reseed = seed_lookup is not None and total_restarts > s_lanes
    track_best = reseed and explore_full_budget
    rounds = -(-total_restarts // s_lanes) if reseed else 1
    # +1 per round: each attempt's first iteration only evaluates its seed.
    max_total_iters = (opts.max_iters + 1) * rounds

    def rj(xs):
        e, jt = soa.residual_and_jtask(consts, xs, tgtm, tgtt, eem, eev,
                                       weight6)
        f = jnp.broadcast_to(soa.vec_dot(e, e), lane_shape)
        return e, jt, f

    xs0 = [jnp.broadcast_to(x, lane_shape) for x in xs0]
    zeros = jnp.zeros(lane_shape, dtype)
    e0 = [zeros] * 6
    jt0 = (zeros,) * (6 * a)
    f0 = jnp.full(lane_shape, jnp.inf, dtype)

    zero_i = jnp.zeros(lane_shape, jnp.int32)
    one_i = jnp.ones(lane_shape, jnp.int32)

    if reseed:
        idx0 = jnp.broadcast_to(jnp.asarray(lane_index, jnp.int32),
                                lane_shape)
    else:
        idx0 = zero_i

    if track_best:
        best0 = (tuple([zeros] * a),                       # best x
                 jnp.full(lane_shape, jnp.inf, dtype),     # best seed dist
                 jnp.full(lane_shape, jnp.inf, dtype),     # best cost
                 zero_i)                                   # best restart idx
    else:
        best0 = ()

    # Boolean lane masks are carried as int32, so the seed-group and
    # loop-exit reductions are integer max/min (the Triton lowering has no
    # boolean any/all reductions).
    init = (tuple(xs0), tuple(e0), jt0, f0,
            jnp.full(lane_shape, opts.lam_init, dtype),
            jnp.full(lane_shape, 2.0, dtype),
            zero_i,                            # stopped
            zero_i,                            # success
            jnp.zeros((), jnp.int32),          # global iteration
            idx0,                              # current restart index
            zero_i,                            # per-attempt iteration
            one_i,                             # pending: adopt x this iter
            best0,
            zero_i,                            # iters at first success
            zero_i)                            # completed successful attempts

    def cond(c):
        return (c[8] < max_total_iters) & (jnp.min(c[6]) == 0)

    def body(c):
        (xs_t, e_t, jt_flat, f, lam, nu, stopped_i, success_i, it,
         cur_idx, it_lane, pending_i, best, succ_it, succ_cnt) = c
        stopped = stopped_i > 0
        success = success_i > 0
        pending = pending_i > 0
        xs = list(xs_t)
        e = list(e_t)
        jt = [[jt_flat[i * a + p] for p in range(a)] for i in range(6)]

        # Damped GN step from the carried (e, J) at the current iterate:
        # delta = -J^T (J J^T + lam I)^{-1} e   (6x6 SPD solve).
        jjt = [[None] * 6 for _ in range(6)]
        for i in range(6):
            for k in range(i + 1):
                v = sum(jt[i][p] * jt[k][p] for p in range(a))
                jjt[i][k] = v
                jjt[k][i] = v
            jjt[i][i] = jjt[i][i] + lam
        z = soa.cholesky_solve(jjt, e)
        delta = [-sum(jt[i][p] * z[i] for i in range(6)) for p in range(a)]

        x_new = [jnp.clip(xs[p] + delta[p], lower[p], upper[p])
                 for p in range(a)]

        # Pending lanes adopt a point instead of stepping: the initial seed
        # on the very first iteration (every lane starts pending), or the
        # next stride seed after a scheduled reseed (cur_idx was advanced
        # when the attempt ended).
        if reseed:
            fresh_seed = seed_lookup(cur_idx)
            is_first = it == 0
            adopt_x = [jnp.where(is_first, xs[p], fresh_seed[p])
                       for p in range(a)]
        else:
            adopt_x = xs
        x_new = [jnp.where(pending, adopt_x[p], x_new[p]) for p in range(a)]
        step = [x_new[p] - xs[p] for p in range(a)]

        # ONE fused evaluation: trial cost + the next step's Jacobian.
        e_new, jt_new, f_new = rj(x_new)

        finite = jnp.isfinite(f_new)
        accept = ((f_new < f) | pending) & finite

        # Nielsen gain ratio on the projected step (see lm.py);
        # meaningless for adopt steps, which reset the damping instead.
        w = [sum(jt[i][p] * step[p] for p in range(a)) for i in range(6)]
        pred = -(2.0 * soa.vec_dot(e, w) + soa.vec_dot(w, w))
        rho = (f - f_new) / jnp.maximum(pred, 1e-30)
        good = accept & (pred > 0) & ~pending
        shrink = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)

        keep = stopped | ~accept  # lanes that keep their current state
        x_next = [jnp.where(keep, xs[p], x_new[p]) for p in range(a)]
        e_next = [jnp.where(keep, e[i], e_new[i]) for i in range(6)]
        jt_next = tuple(
            jnp.where(keep, jt[i][p], jt_new[i][p])
            for i in range(6) for p in range(a))
        f_next = jnp.where(keep, f, f_new)

        lam_next = jnp.clip(jnp.where(good, lam * shrink, lam * nu),
                            opts.lam_min, opts.lam_max)
        nu_next = jnp.where(good, 2.0, jnp.minimum(nu * 2.0, 64.0))
        fresh = pending & ~stopped
        lam_next = jnp.where(fresh, opts.lam_init, lam_next)
        nu_next = jnp.where(fresh, 2.0, nu_next)
        lam_next = jnp.where(stopped, lam, lam_next)
        nu_next = jnp.where(stopped, nu, nu_next)

        # --- stopping criteria -------------------------------------------
        newly_f = (f_next <= opts.tol_f) if opts.f_is_success else \
            jnp.zeros_like(accept)
        df = jnp.abs(f - f_next)
        newly_df = accept & (df < opts.tol_df) & ~pending
        if opts.tol_dx >= 0.0:
            adx = step[0] * 0.0
            for p in range(a):
                adx = jnp.maximum(adx, jnp.abs(step[p]))
            newly_dx = accept & (adx < opts.tol_dx) & ~pending
        else:
            newly_dx = jnp.zeros_like(accept)
        newly_stuck = lam_next >= opts.lam_max

        run = ~stopped
        succ_now = newly_f
        if opts.df_is_success:
            succ_now = succ_now | newly_df
        if opts.dx_is_success:
            succ_now = succ_now | newly_dx
        first_succ = run & succ_now & ~success
        success = success | (run & succ_now)
        it_next = jnp.where(pending & run, 1, it_lane + 1)
        succ_it = jnp.where(first_succ, it_next, succ_it)
        attempt_over = (newly_f | newly_df | newly_dx | newly_stuck
                        | (it_next > opts.max_iters))
        # A non-finite adopted point is a dead attempt too.
        attempt_over = attempt_over | (pending & ~finite)

        if track_best:
            # Record this attempt's solution if it's the best success so
            # far (min distance to the caller's seed), then keep exploring.
            bx, bd, bf, bi = best
            d2 = sum((x_next[p] - qx0[p]) ** 2 for p in range(a))
            d = jnp.sqrt(d2)
            better = run & succ_now & (d < bd)
            best = (tuple(jnp.where(better, x_next[p], bx[p])
                          for p in range(a)),
                    jnp.where(better, d, bd),
                    jnp.where(better, f_next, bf),
                    jnp.where(better, cur_idx, bi))

        if reseed:
            next_idx = cur_idx + s_lanes
            can_retry = next_idx < total_restarts
            if track_best:
                # Quality: every finished attempt (success or not) moves on
                # to the next seed while budget remains.
                over = run & attempt_over
                pending_next = over & can_retry
                stopped = stopped | (over & ~can_retry)
            else:
                failed_over = run & attempt_over & ~succ_now
                pending_next = failed_over & can_retry
                stopped = stopped | (run & ((attempt_over & succ_now)
                                            | (failed_over & ~can_retry)))
            cur_idx_next = jnp.where(pending_next, next_idx, cur_idx)
            it_next = jnp.where(pending_next, jnp.zeros_like(it_next),
                                it_next)
        else:
            pending_next = jnp.zeros_like(pending)
            cur_idx_next = cur_idx
            stopped = stopped | (run & attempt_over)

        if success_stops_group and len(lane_shape) >= 2:
            # Speed mode: once any restart of a pose succeeds, the pose's
            # remaining lanes freeze — the deterministic analog of the
            # reference's cross-thread early-exit flag (lib.rs:269,382-384).
            # Winner = earliest success by iteration, ties broken by lowest
            # restart index (lane-local property -> batch-layout-invariant).
            pose_done = jnp.max(success.astype(jnp.int32), axis=-1,
                                keepdims=True) > 0
            stopped = stopped | jnp.broadcast_to(pose_done, lane_shape)
            pending_next = pending_next & ~pose_done

        if group_success_cap is not None:
            # Quality truncation-after-k: count completed successful
            # attempts per lane, reduce over the pose's lane group, and
            # freeze the pose at >= cap (config.quality_max_successes).
            succ_cnt = succ_cnt + (run & succ_now).astype(jnp.int32)
            if len(lane_shape) >= 2:
                pose_cnt = jnp.sum(succ_cnt, axis=-1, keepdims=True)
            else:
                pose_cnt = succ_cnt
            capped = jnp.broadcast_to(pose_cnt >= group_success_cap,
                                      lane_shape)
            stopped = stopped | capped
            pending_next = pending_next & ~capped

        return (tuple(x_next), tuple(e_next), jt_next, f_next,
                lam_next, nu_next, stopped.astype(jnp.int32),
                success.astype(jnp.int32), it + 1,
                cur_idx_next, it_next, pending_next.astype(jnp.int32), best,
                succ_it, succ_cnt)

    if unroll > 1:
        body1 = body

        def body(c):
            for _ in range(unroll):
                c = body1(c)
            return c

    out = jax.lax.while_loop(cond, body, init)
    if track_best:
        bx, bd, bf, bi = out[12]
        return LoopOut(xs=bx, f=bf, success=jnp.isfinite(bd), iters=out[8],
                       restart_index=bi, succ_iters=out[13])
    return LoopOut(xs=out[0], f=out[3], success=out[7] > 0, iters=out[8],
                   restart_index=out[9] if reseed else None,
                   succ_iters=out[13])


def solve_soa(consts, lower, upper, opts: LMOptions,
              x0: jnp.ndarray,          # (..., A)
              tgt_r: jnp.ndarray,       # (..., 3, 3) broadcastable to lanes
              tgt_t: jnp.ndarray,       # (..., 3)
              ee_r: Optional[jnp.ndarray] = None,
              ee_t: Optional[jnp.ndarray] = None,
              wl=None, wa=None,
              seed_table: Optional[jnp.ndarray] = None,  # (R, A)
              lane_index: Optional[jnp.ndarray] = None,  # broadcastable ints
              total_restarts: int = 0,
              success_stops_group: bool = False,
              explore_full_budget: bool = False,
              quality_x0: Optional[jnp.ndarray] = None,
              group_success_cap: Optional[int] = None) -> LMResult:
    """Array-in/array-out wrapper around :func:`lm_loop`.

    Lane axes = x0.shape[:-1]; the seed-group axis (for Speed-mode pose
    freezing) is the last lane axis.
    """
    a = x0.shape[-1]
    lane_shape = x0.shape[:-1]
    s_lanes = lane_shape[-1] if lane_shape else 1

    xs0 = [x0[..., j] for j in range(a)]
    tgtm = [[tgt_r[..., i, j] for j in range(3)] for i in range(3)]
    tgtt = [tgt_t[..., i] for i in range(3)]
    eem = eev = None
    if ee_r is not None:
        eem = [[ee_r[..., i, j] for j in range(3)] for i in range(3)]
        eev = [ee_t[..., i] for i in range(3)]
    weight6 = soa.weight6_from_config(tgtm, wl, wa)

    seed_lookup = None
    if seed_table is not None and total_restarts > s_lanes:
        tables = [jnp.asarray(seed_table[:, p], x0.dtype) for p in range(a)]
        seed_lookup = lambda idx: [jnp.take(t, idx) for t in tables]
    qx0 = None
    if quality_x0 is not None:
        qx0 = [quality_x0[..., p] for p in range(a)]

    out = lm_loop(consts, lower, upper, opts, xs0, tgtm, tgtt, eem, eev,
                  weight6, seed_lookup=seed_lookup, lane_index=lane_index,
                  total_restarts=total_restarts, s_lanes=s_lanes,
                  success_stops_group=success_stops_group,
                  explore_full_budget=explore_full_budget, qx0=qx0,
                  group_success_cap=group_success_cap)

    return LMResult(x=jnp.stack(list(out.xs), axis=-1), f=out.f,
                    success=out.success, iters=out.iters,
                    restart_index=out.restart_index,
                    succ_iters=out.succ_iters)
