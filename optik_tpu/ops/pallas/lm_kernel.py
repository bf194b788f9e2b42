"""Pallas kernel, lowered through Triton: the whole projected-LM solve for
one block of lanes.

Under XLA, the solver's ``while_loop`` carry (~60-75 lane-shaped arrays)
round-trips through device memory on every iteration, and the whole batch
iterates until its hardest pose is done.  This kernel runs the entire loop
for one block of lanes inside one ``pallas_call``: the LM state stays in
registers, device memory is touched twice (read seeds and targets, write
results), and each block exits as soon as its own poses are done.

Layout: a block holds ``(P, S)`` lanes — P poses, S seed lanes per pose,
both powers of two (the Triton lowering requires power-of-two shapes) — and
the grid strides pose blocks.  Refs are padded to powers of two: the A
joint components (A_PAD = 8 for 5-8 joints), the 12 target components to
16, the restart table's rows.

The shared loop core (solver/lm_soa.lm_loop) runs unchanged inside the
kernel on (P, S) component arrays, reducing over the seed axis for
Speed-mode pose freezing.  A reseeding lane reads its next restart seed
with one gather per joint component from the restart table (a few KB, so
it stays in cache).

Semantics match solver/lm_soa.solve_soa exactly (same loop core); pinned by
tests/test_pallas.py in interpreter mode and tests/test_gpu.py on the card.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ...config import SolutionMode, SolverConfig
from ...ops import soa
from ...solver import ik as ik_mod
from ...solver.lm_soa import lm_loop

# Lanes per block (P * S), one lane per thread (num_warps = lanes / 32).
# Measured on the H100 (PERF.md): of 64/128/256 lanes, 64 is the fastest
# block for the Speed cascade and for Quality.  A 32-lane cascade ran 5%
# faster in one call, less than the spread of its timed calls, so 64
# stays; 32 lanes is the fastest single-shot Speed block.  Smaller blocks
# exit sooner, larger ones run more lane-iterations per solve.
DEFAULT_LANES = 64
# Loop-body applications per while-loop condition check (identical schedule
# semantics for any value; see solver/lm_soa.lm_loop unroll).  Measured on
# the H100: unroll 2 is no faster and compiles ~5x slower.
DEFAULT_UNROLL = 1


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def seed_lanes(cfg: SolverConfig) -> int:
    """Seed lanes per pose (S) the solver runs for ``cfg``."""
    return min(cfg.seed_batch, cfg.total_restarts)


def block_poses(s: int, lanes: int | None = None) -> int:
    """Poses per block (P) for S seed lanes: ``lanes // S``, at least 1."""
    return max(1, (lanes or DEFAULT_LANES) // s)


def fold_ee_offset(consts, ee_offset):
    """Compose a constant EE offset into the chain's synthetic tip joint.

    ``ee_offset`` is a 4x4 matrix or an ``(R (3,3), t (3,))`` pair.  The
    reference applies the offset as ``ee = last_joint * ee_offset``
    (kinematics.rs:163); with the tip transform T and offset E this is
    ``T' = T @ E`` — a trace-time constant fold, so the kernel pays nothing.
    """
    org_r, org_t, axes, pris, tip_r, tip_t, has_tip = consts
    if isinstance(ee_offset, tuple):
        er, et = np.asarray(ee_offset[0], np.float64), \
            np.asarray(ee_offset[1], np.float64)
    else:
        m = np.asarray(ee_offset, np.float64)
        er, et = m[:3, :3], m[:3, 3]
    tr = np.asarray(tip_r, np.float64)
    tt = np.asarray(tip_t, np.float64)
    new_r = tr @ er
    new_t = tt + tr @ et
    new_tip_r = [[float(new_r[i, k]) for k in range(3)] for i in range(3)]
    new_tip_t = [float(new_t[i]) for i in range(3)]
    has = not (np.allclose(new_r, np.eye(3)) and np.allclose(new_t, 0.0))
    return org_r, org_t, axes, pris, new_tip_r, new_tip_t, has


def build_kernel_solver(spec, cfg: SolverConfig, dtype=jnp.float32,
                        p_blk: int | None = None, interpret: bool = False,
                        ee_offset=None, unroll: int | None = None):
    """Compile a Pallas-backed batched IK solver for one robot+config.

    Returns ``fn(tgt_r (B,3,3), tgt_t (B,3), x0 (B,A), restart_offset=None,
    lane0_stream=None) -> IKResult``.  The seed-lane count S is
    cfg.seed_batch capped by the budget and must be a power of two; the
    remaining budget runs through continuous reseeding, identical to the
    XLA path.  ``p_blk`` is the number of poses per block (a power of two,
    default :func:`block_poses`), and B must be a multiple of it.  Each
    block runs one lane per thread (at most 8 warps).

    ``ee_offset``, when given as a 4x4 (or (R (3,3), t (3,)) pair), is
    constant for the solver build and folds into the chain's synthetic tip
    joint — zero runtime cost, same contract as threading it through FK
    (reference: crates/optik/src/kinematics.rs:163, lib.rs:241-247).
    Per-axis linear/angular weighting from the config is applied exactly as
    on the XLA path (conjugated with each lane's target rotation; reference
    contract crates/optik/src/objective.rs:7-38,102-104).
    """
    consts = soa.chain_constants(spec)
    if ee_offset is not None:
        consts = fold_ee_offset(consts, ee_offset)
    a = spec.num_positions
    a_pad = _pow2(a)
    lower = [float(v) for v in spec.lower]
    upper = [float(v) for v in spec.upper]
    lo_s = np.where(np.isfinite(spec.lower), spec.lower, -np.pi)
    hi_s = np.where(np.isfinite(spec.upper), spec.upper, np.pi)
    opts = ik_mod.options_from_config(cfg)

    r_total = cfg.total_restarts
    s = seed_lanes(cfg)
    if s & (s - 1):
        raise ValueError(f"seed lanes {s} must be a power of two")
    p = p_blk or block_poses(s)
    if p & (p - 1):
        raise ValueError(f"poses per block {p} must be a power of two")
    num_warps = min(8, max(1, p * s // 32))
    if unroll is None:
        unroll = DEFAULT_UNROLL
    use_reseed = r_total > s
    r_pad = _pow2(max(r_total, s))
    mode = cfg.solution_mode
    quality = mode == SolutionMode.QUALITY

    def kernel(seed0_ref,  # (P, A_PAD) lane-0 seed of each pose
               x0_ref,     # (P, A_PAD) caller seed (Quality distance ref)
               tgt_ref,    # (P, 16) target pose components
               tab_ref,    # (R_PAD, A_PAD) restart seed table
               x_ref,      # out (A_PAD, P, S)
               f_ref,      # out (P, S)
               succ_ref,   # out (P, S) int32
               idx_ref,    # out (P, S) int32 restart index
               sit_ref,    # out (P, S) int32 iters at first success
               bit_ref):   # out (P,) int32 block loop iterations
        lane = jax.lax.broadcasted_iota(jnp.int32, (1, s), 1)
        xs0 = []
        for q in range(a):
            x0c = seed0_ref[:, q][:, None]
            if s > 1:
                # Lane 0 starts from the pose's own seed, lanes 1..S-1 from
                # restarts 1..S-1 of the shared stream.
                x0c = jnp.where(lane == 0, x0c, tab_ref[:s, q][None, :])
            xs0.append(x0c)
        tgtm = [[tgt_ref[:, 3 * i + j][:, None] for j in range(3)]
                for i in range(3)]
        tgtt = [tgt_ref[:, 9 + i][:, None] for i in range(3)]

        seed_lookup = None
        if use_reseed:
            def seed_lookup(cur_idx):
                return [tab_ref[cur_idx, q] for q in range(a)]

        qx0 = None
        if quality:
            qx0 = [x0_ref[:, q][:, None] for q in range(a)]

        # Per-axis weighting, conjugated with each lane's target rotation —
        # identical construction to the XLA path (solver/lm_soa.solve_soa);
        # None when both weights are identity.
        weight6 = soa.weight6_from_config(tgtm, cfg.linear_weight,
                                          cfg.angular_weight)

        res = lm_loop(
            consts, lower, upper, opts, xs0, tgtm, tgtt, weight6=weight6,
            seed_lookup=seed_lookup, lane_index=lane,
            total_restarts=r_total, s_lanes=s,
            success_stops_group=not quality,
            explore_full_budget=quality, qx0=qx0,
            group_success_cap=(cfg.quality_max_successes or None
                               if quality else None),
            unroll=unroll)

        shape = (p, s)
        for q in range(a):
            x_ref[q] = jnp.broadcast_to(res.xs[q], shape)
        f_ref[...] = jnp.broadcast_to(res.f, shape)
        succ_ref[...] = jnp.broadcast_to(res.success.astype(jnp.int32), shape)
        idx = res.restart_index if res.restart_index is not None else lane
        idx_ref[...] = jnp.broadcast_to(idx, shape)
        sit_ref[...] = jnp.broadcast_to(res.succ_iters, shape)
        bit_ref[...] = jnp.full((p,), res.iters, jnp.int32)

    def pose_spec(width):
        return pl.BlockSpec((p, width), lambda i: (i, 0))

    lane_spec = pl.BlockSpec((p, s), lambda i: (i, 0))

    @jax.jit
    def solve(tgt_r, tgt_t, x0, restart_offset=None, lane0_stream=None):
        b = tgt_r.shape[0]
        if b % p:
            raise ValueError(
                f"batch {b} not a multiple of the block's {p} poses")

        lo = jnp.asarray(lo_s, dtype)
        hi = jnp.asarray(hi_s, dtype)
        key = jax.random.PRNGKey(cfg.rng_seed)

        # ``restart_offset`` (traced scalar) shifts the fold_in indices of
        # the random-restart draws — the unlimited-restart rounds
        # (robot.ik_batch, max_restarts=0) continue the deterministic
        # restart stream across rounds without a recompile.
        off = 0 if restart_offset is None else restart_offset

        def draw(i):
            k = jax.random.fold_in(key, i + off)
            return jax.random.uniform(k, (a,), dtype=dtype, minval=lo,
                                      maxval=hi)

        table = jax.vmap(draw)(jnp.arange(r_pad))           # (R_PAD, A)
        x0 = jnp.asarray(x0, dtype)
        # ``lane0_stream`` (traced bool scalar): replace the caller-x0 seed
        # lane with the restart stream's OWN index-``off`` draw — the
        # seed-sharded entry (parallel/mesh.build_seed_sharded_solver) sets
        # this on every device but the first so the union of per-device
        # attempt sets is exactly the global fold_in stream (device 0 keeps
        # x0 at restart index 0, like the reference's restart 0,
        # lib.rs:366-370).  Quality-mode seed distances still measure
        # against the true x0.
        seed0 = x0
        if lane0_stream is not None:
            seed0 = jnp.where(lane0_stream, table[0][None, :], x0)

        def pad_a(m):
            return jnp.pad(m, ((0, 0), (0, a_pad - a)))

        tgt = jnp.concatenate(
            [jnp.asarray(tgt_r, dtype).reshape(b, 9),
             jnp.asarray(tgt_t, dtype), jnp.zeros((b, 4), dtype)], axis=1)

        i32 = jnp.int32
        xs, fs, succ, ridx, sit, bit = pl.pallas_call(
            kernel,
            grid=(b // p,),
            in_specs=[pose_spec(a_pad), pose_spec(a_pad), pose_spec(16),
                      pl.BlockSpec((r_pad, a_pad), lambda i: (0, 0))],
            out_specs=(pl.BlockSpec((a_pad, p, s), lambda i: (0, i, 0)),
                       lane_spec, lane_spec, lane_spec, lane_spec,
                       pl.BlockSpec((p,), lambda i: (i,))),
            out_shape=(jax.ShapeDtypeStruct((a_pad, b, s), dtype),
                       jax.ShapeDtypeStruct((b, s), dtype),
                       jax.ShapeDtypeStruct((b, s), i32),
                       jax.ShapeDtypeStruct((b, s), i32),
                       jax.ShapeDtypeStruct((b, s), i32),
                       jax.ShapeDtypeStruct((b,), i32)),
            interpret=interpret,
            backend="triton",
            compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                    num_stages=1),
            name="optik_lm_solve",
        )(pad_a(seed0), pad_a(x0), tgt, pad_a(table))

        xs = xs[:a].transpose(1, 2, 0)                       # (B, S, A)
        succ_b = succ > 0

        # Winner selection per pose — the same argmin semantics as
        # ik._select, as a one-hot select-and-sum.
        if mode == SolutionMode.SPEED:
            # Deterministic "first success": lowest restart index.
            big = jnp.iinfo(jnp.int32).max
            sel_key = jnp.where(succ_b, ridx, big)
            idx = jnp.argmin(sel_key, axis=1)                    # (B,)
            win_key = jnp.min(sel_key, axis=1)                   # (B,) i32
        else:
            # Quality: min seed distance among successes.
            dist = jnp.linalg.norm(xs - x0[:, None, :], axis=-1)
            keyed = jnp.where(succ_b, dist, jnp.inf)
            idx = jnp.argmin(keyed, axis=1)
            win_key = jnp.min(keyed, axis=1)                     # (B,) dtype
        onehot = idx[:, None] == jax.lax.broadcasted_iota(
            jnp.int32, (b, s), 1)                                # (B, S)
        x_win = jnp.sum(jnp.where(onehot[:, :, None], xs, 0.0), axis=1)
        cost = jnp.sum(jnp.where(onehot, fs, 0.0), axis=1)
        iters = jnp.sum(jnp.where(onehot, sit, 0), axis=1)
        out = ik_mod.IKResult(found=jnp.any(succ_b, axis=1), x=x_win,
                              cost=cost, iters=iters, sel_key=win_key)
        # Work accounting: every lane of a block runs its block's full loop
        # count, so total lane-iterations = sum over blocks x (P * S).
        lane_iters = jnp.sum(bit[::p]) * (p * s)
        return out._replace(
            lane_iters=lane_iters,
            found_count=jnp.sum(out.found.astype(jnp.int32)))

    return solve
