"""Restart scheduling and solution selection for the batched IK solver.

Replaces the reference's work-stealing parallel-restart orchestration
(kylc/optik lib.rs:241-415) with deterministic batch axes:

  * the restart stream (lib.rs:298-301) is a lane axis of S seeds advancing
    in lockstep through the LM solver; "work stealing" disappears because no
    lane ever idles;
  * restart 0 starts from the caller's seed ``x0``, restarts i > 0 draw a
    uniform configuration from the joint limits using
    ``fold_in(key(rng_seed), i)`` — mirroring the reference's fixed ChaCha8
    seed 42 with one RNG stream per restart index (lib.rs:360-370), and like
    it, *independent of the pose being solved*;
  * Speed mode's race-y cross-thread early exit (lib.rs:269, 382-384)
    becomes the deterministic "lowest restart index among successes", which
    is batch-size-invariant and reproducible on any topology;
  * Quality mode's min-seed-distance reduction (lib.rs:398-408) is an argmin
    over lanes.

Both selections are pure reductions, so sharding them over a device mesh
turns into XLA collectives for free (see optik_tpu/parallel).
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import SolutionMode, SolverConfig
from ..utils.precision import with_f32_matmuls
from ..ops import kinematics as K
from . import lm


class IKResult(NamedTuple):
    """Per-query result; ``found`` gates validity of ``x``/``cost``."""

    found: jnp.ndarray  # (...,) bool
    x: jnp.ndarray      # (..., A)
    cost: jnp.ndarray   # (...,)
    # Winning lane's LM iterations-to-converge (0 when not found / not
    # tracked) — observability only, never part of the solve contract.
    iters: Optional[jnp.ndarray] = None
    # Total LM lane-iterations this solve executed (scalar; sums every lane
    # of every block/phase) — the exact work unit for roofline/utilization
    # accounting (utils/roofline.py).  None when not tracked.
    lane_iters: Optional[jnp.ndarray] = None
    # Scalar count of found poses, computed INSIDE the solve program when
    # available (cascade path).  Callers chaining many batches fetch/reduce
    # this instead of dispatching a separate sum per batch.  None
    # when the solve didn't compute it (or padding invalidated it).
    found_count: Optional[jnp.ndarray] = None
    # Per-pose winner-selection key for cross-device merging (seed-sharded
    # path, parallel/mesh.build_seed_sharded_solver): Speed mode = the
    # winning restart index (int32; INT32_MAX when not found), Quality mode
    # = the winning seed distance (dtype; +inf when not found).  None when
    # the solver didn't compute it.
    sel_key: Optional[jnp.ndarray] = None
    # Count of poses whose post-screen failures overflowed the cascade's
    # final-phase capacity and therefore did NOT receive the full restart
    # budget (scalar int32; see solver/cascade.py).  0 on the single-shot
    # paths (no capacity to overflow); None when not tracked.
    overflow_count: Optional[jnp.ndarray] = None


def options_from_config(cfg: SolverConfig) -> lm.LMOptions:
    """Map the reference-compatible config onto LM options (see lm.py)."""
    return lm.LMOptions(
        max_iters=cfg.max_iters,
        tol_f=cfg.tol_f,
        tol_df=cfg.effective_tol_df,
        tol_dx=cfg.tol_dx,
        f_is_success=cfg.tol_f >= 0.0,
        df_is_success=cfg.tol_df >= 0.0,
        dx_is_success=cfg.tol_dx >= 0.0,
    )


def sample_bounds(params: K.ChainParams):
    """Finite sampling box for random restarts.

    Unbounded joints (the reference maps degenerate URDF limits to +-inf,
    kinematics.rs:299-303) are sampled in [-pi, pi] — the natural period for
    a revolute joint; the reference would abort on an infinite range.
    """
    pi = jnp.asarray(math.pi, dtype=params.lower.dtype)
    lo = jnp.where(jnp.isfinite(params.lower), params.lower, -pi)
    hi = jnp.where(jnp.isfinite(params.upper), params.upper, pi)
    return lo, hi


def restart_seeds(params: K.ChainParams, x0: jnp.ndarray, key: jnp.ndarray,
                  num_restarts: int) -> jnp.ndarray:
    """(S, A) seed matrix: lane 0 = x0, lanes i>0 ~ U(limits) via fold_in(i)."""
    lo, hi = sample_bounds(params)
    a = params.num_positions

    def draw(i):
        k = jax.random.fold_in(key, i)
        return jax.random.uniform(k, (a,), dtype=x0.dtype, minval=lo,
                                  maxval=hi)

    idx = jnp.arange(1, num_restarts)
    rand = jax.vmap(draw)(idx) if num_restarts > 1 else \
        jnp.zeros((0, a), x0.dtype)
    return jnp.concatenate([x0[None, :], rand], axis=0)


def _select(mode: SolutionMode, xs, fs, success, x0, restart_idx=None,
            succ_iters=None):
    """Pick the winning lane: (S, A), (S,), (S,), (A,) -> IKResult scalars.

    ``restart_idx`` (continuous-reseed path) carries the restart index each
    lane's final attempt used; Speed mode minimizes it so "first success"
    stays invariant to the lane layout.  ``succ_iters`` (optional) is the
    per-lane iterations-to-converge surfaced as IKResult.iters.
    """
    s = xs.shape[0]
    if mode == SolutionMode.SPEED:
        # Deterministic "first success": lowest restart index (replaces the
        # reference's find_any, lib.rs:409-412).
        order = restart_idx if restart_idx is not None else jnp.arange(s)
        big = jnp.iinfo(jnp.int32).max
        idx = jnp.argmin(jnp.where(success, order, big))
    else:
        # Quality: minimum Euclidean distance to the caller's seed among
        # successes (lib.rs:398-408).
        dist = jnp.linalg.norm(xs - x0[None, :], axis=-1)
        dist = jnp.where(success, dist, jnp.inf)
        idx = jnp.argmin(dist)
    return IKResult(found=jnp.any(success), x=xs[idx], cost=fs[idx],
                    iters=None if succ_iters is None else succ_iters[idx])


def build_batch_solver(spec, cfg: SolverConfig, dtype, mesh=None):
    """Compile a batched IK solver for one robot+config (the fast path).

    The chain spec is baked into the trace as static floats (SoA path, see
    ops/soa.py), so there is exactly one compilation per (robot, config,
    batch shape).  Returns ``fn(tgt_r (B,3,3), tgt_t (B,3), x0 (B,A)
    [, ee_r, ee_t]) -> IKResult``.

    With ``mesh``, lane arrays are constrained to
    ``NamedSharding(mesh, P("data", "seed"))`` — poses over "data", restart
    seeds over "seed" — and the per-pose argmin selection lowers to a
    seed-axis reduce collective.
    """
    import numpy as np

    from ..ops import soa
    from . import lm_soa

    consts = soa.chain_constants(spec)
    a = spec.num_positions
    lower = [float(v) for v in spec.lower]
    upper = [float(v) for v in spec.upper]
    lo_s = np.where(np.isfinite(spec.lower), spec.lower, -np.pi)
    hi_s = np.where(np.isfinite(spec.upper), spec.upper, np.pi)
    opts = options_from_config(cfg)
    # Lane count: at most seed_batch lanes advance in lockstep; the rest of
    # the restart budget is consumed by continuous reseeding (lane l strides
    # restart indices l, l+S, l+2S, ...).
    r_total = cfg.total_restarts
    s = min(cfg.seed_batch, r_total)
    use_reseed = r_total > s

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        lane_sharding = NamedSharding(mesh, P("data", "seed"))
        pose_sharding = NamedSharding(mesh, P("data"))

    def constrain(x, sharding):
        if mesh is None:
            return x
        return jax.lax.with_sharding_constraint(x, sharding)

    @with_f32_matmuls
    @jax.jit
    def solve_batch(tgt_r, tgt_t, x0, ee_r=None, ee_t=None,
                    restart_offset=None):
        b = tgt_r.shape[0]
        lo = jnp.asarray(lo_s, x0.dtype)
        hi = jnp.asarray(hi_s, x0.dtype)
        key = jax.random.PRNGKey(cfg.rng_seed)
        # Traced shift of the restart stream for unlimited-restart rounds
        # (see robot.ik_batch; one compile covers every round).
        off = 0 if restart_offset is None else restart_offset

        # Restart seed table: row i is the deterministic per-restart stream
        # (pose-independent, lib.rs:360-370); row 0 is unused (the caller's
        # x0 takes restart index 0).
        def draw(i):
            k = jax.random.fold_in(key, i + off)
            return jax.random.uniform(k, (a,), dtype=x0.dtype, minval=lo,
                                      maxval=hi)

        table = jax.vmap(draw)(jnp.arange(r_total)) if r_total > 1 else \
            jnp.zeros((1, a), x0.dtype)

        seeds = jnp.concatenate(
            [x0[:, None, :],
             jnp.broadcast_to(table[1:s], (b, s - 1, a))], axis=1)
        seeds = constrain(seeds, lane_sharding if mesh is not None else None)

        res = lm_soa.solve_soa(
            consts, lower, upper, opts, seeds,
            tgt_r[:, None], tgt_t[:, None],
            ee_r=ee_r, ee_t=ee_t,
            wl=cfg.linear_weight, wa=cfg.angular_weight,
            seed_table=table if use_reseed else None,
            lane_index=jnp.arange(s) if use_reseed else None,
            total_restarts=r_total,
            success_stops_group=(cfg.solution_mode == SolutionMode.SPEED),
            explore_full_budget=(cfg.solution_mode == SolutionMode.QUALITY),
            quality_x0=x0[:, None],
            group_success_cap=(
                cfg.quality_max_successes or None
                if cfg.solution_mode == SolutionMode.QUALITY else None))

        xs = constrain(res.x, lane_sharding if mesh is not None else None)
        if res.restart_index is not None:
            out = jax.vmap(lambda xsi, fsi, si, x0i, ri, iti: _select(
                cfg.solution_mode, xsi, fsi, si, x0i, ri, iti))(
                xs, res.f, res.success, x0, res.restart_index,
                res.succ_iters)
        else:
            out = jax.vmap(lambda xsi, fsi, si, x0i, iti: _select(
                cfg.solution_mode, xsi, fsi, si, x0i, None, iti))(
                xs, res.f, res.success, x0, res.succ_iters)
        # Work accounting: one lockstep loop over all b*s lanes ran
        # res.iters global iterations.
        out = out._replace(lane_iters=res.iters * (b * s))
        if mesh is not None:
            out = out._replace(
                found=constrain(out.found, pose_sharding),
                x=constrain(out.x, pose_sharding),
                cost=constrain(out.cost, pose_sharding),
                iters=None if out.iters is None else
                constrain(out.iters, pose_sharding))
        return out

    return solve_batch


@with_f32_matmuls
@partial(jax.jit, static_argnums=(1,))
def ik_one(params: K.ChainParams, cfg: SolverConfig,
           tgt_r: jnp.ndarray, tgt_t: jnp.ndarray, x0: jnp.ndarray,
           ee_r: Optional[jnp.ndarray] = None,
           ee_t: Optional[jnp.ndarray] = None) -> IKResult:
    """Solve one pose with cfg.total_restarts lockstep restarts."""
    key = jax.random.PRNGKey(cfg.rng_seed)
    seeds = restart_seeds(params, x0, key, cfg.total_restarts)
    res = lm.solve(params, seeds, tgt_r, tgt_t, options_from_config(cfg),
                   ee_r=ee_r, ee_t=ee_t,
                   wl=cfg.linear_weight, wa=cfg.angular_weight)
    return _select(cfg.solution_mode, res.x, res.f, res.success, x0)


@with_f32_matmuls
@partial(jax.jit, static_argnums=(1,))
def ik_batch(params: K.ChainParams, cfg: SolverConfig,
             tgt_r: jnp.ndarray,    # (B, 3, 3)
             tgt_t: jnp.ndarray,    # (B, 3)
             x0: jnp.ndarray,       # (B, A)
             ee_r: Optional[jnp.ndarray] = None,
             ee_t: Optional[jnp.ndarray] = None) -> IKResult:
    """Solve B poses x S restarts as one flat lane batch of B*S.

    The flat layout (no nested vmap-of-while) keeps every lane in the same
    lockstep loop — the batch-device replacement for "thread pool x restart
    stream".  Selection happens per pose after reshaping back to (B, S).
    """
    b = tgt_r.shape[0]
    s = cfg.total_restarts
    a = params.num_positions

    key = jax.random.PRNGKey(cfg.rng_seed)
    # Restart seeds are pose-independent, like the reference's per-restart
    # RNG streams (lib.rs:360-362) — broadcast over B.
    seeds0 = jax.vmap(
        lambda x: restart_seeds(params, x, key, s))(x0)     # (B, S, A)

    lanes = seeds0.reshape(b * s, a)
    tgt_r_l = jnp.repeat(tgt_r, s, axis=0)
    tgt_t_l = jnp.repeat(tgt_t, s, axis=0)

    res = lm.solve(params, lanes, tgt_r_l, tgt_t_l, options_from_config(cfg),
                   ee_r=ee_r, ee_t=ee_t,
                   wl=cfg.linear_weight, wa=cfg.angular_weight)

    xs = res.x.reshape(b, s, a)
    fs = res.f.reshape(b, s)
    succ = res.success.reshape(b, s)
    return jax.vmap(lambda xsi, fsi, si, x0i:
                    _select(cfg.solution_mode, xsi, fsi, si, x0i))(
        xs, fs, succ, x0)
