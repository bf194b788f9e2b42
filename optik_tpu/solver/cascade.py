"""Two-phase Speed-mode batch scheduler ("cascade") for the kernel path.

Why: the Pallas solver (ops/pallas/lm_kernel.py) runs a whole block of poses
in one lockstep loop, and Speed-mode pose freezing stops a pose's lanes at its
earliest success — but the *block* keeps iterating until every pose in it
has stopped.  A single non-converging pose therefore holds its block for
the entire restart budget ((max_iters + 1) x rounds iterations) while clean
blocks exit after a few dozen.  At realistic failure rates (~0.1% of random
Panda poses with a 64-restart budget) most blocks contain at least one such
straggler, so the mean block time approaches the worst case.

The cascade bounds that waste:

  phase 1  screen *all* poses with only the first restart rounds
           (default: 2 rounds of ``seed_batch`` lanes — a small, uniform
           budget);
  compact  gather the failed poses (a deterministic stable argsort) into a
           fixed-size tail batch of ``ceil(B / tail_div)`` poses;
  phase 2  replay the *full* restart schedule on the tail only;
  merge    scatter phase-2 results back over the phase-1 failures.

Semantics vs. the single-shot schedule (kernel with the full budget):

  * the found mask is identical: phase 1 computes a prefix of the
    single-shot lockstep schedule, and phase 2 *is* the single-shot
    schedule for every pose phase 1 failed;
  * the winning restart for a pose solved in phase 1 can differ from
    single-shot in one corner — a lane that reseeds past the phase-1 budget
    early could, in single-shot, reach success a few iterations before a
    phase-1-visible success.  Both winners satisfy the same tolerances and
    the selection stays deterministic at any batch size;
  * if more than ``B / tail_div`` poses fail phase 1, the overflow keeps its
    phase-1 failure instead of getting the full budget (the tail batch is
    static); the count is reported as ``IKResult.overflow_count`` and
    Robot.ik_batch rescues it.

The reference has no analog (its work-stealing restarts never idle,
lib.rs:298-301); this is scheduling for a lockstep machine.

Why there is no Quality-mode cascade: Quality semantics select the minimum
seed-distance over ALL successful restarts (lib.rs:398-408 — the reference
never sets its early-exit flag in Quality mode either), so every pose must
consume its full restart budget and per-pose work is *uniform by
construction* — there are no stragglers for a screen/replay split to
bound.  The single-shot kernel with continuous reseeding (a finished
attempt immediately adopts its next seed, solver/lm_soa.py) is already the
zero-idle Quality schedule; it is benchmarked as BASELINE config 2
(benchmarks/bench_workloads.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import SolutionMode, SolverConfig
from . import ik as ik_mod
from ..ops.pallas import lm_kernel


# Module-level jits: these MUST NOT be defined per solve() call — a fresh
# function object means a retrace and recompile on every batch.

@functools.partial(jax.jit, static_argnums=5)
def _compact(found, cost, tgt_r, tgt_t, x0, b2):
    """Gather the first b2 poses: failures first, hardest failures first.

    Ordering failures by descending screen cost clusters the poses that
    will burn the next phase's full budget into the same kernel blocks, so
    every other block's lockstep loop exits early — pose results are
    order-independent (each pose's lanes are self-contained), so absent
    compaction overflow this changes lane-iterations only, never the found
    mask or solutions.  When failures exceed b2 (overflow), the
    hardest-first order selects a different surviving subset than a
    stable-original-order compaction would, so the found mask can differ
    from the old schedule's — the overflow itself is surfaced on
    ``IKResult.overflow_count`` and rescued at the Robot layer
    (robot.ik_batch rescue_overflow).
    Found poses keep stable original order at the tail, so any capacity
    filler is the easy poses (their blocks exit immediately).  NaN costs
    sort with the hardest (a NaN-cost failure must keep its full-budget
    guarantee).
    """
    key = jnp.where(found, jnp.inf,
                    jnp.where(jnp.isnan(cost), -jnp.inf, -cost))
    order = jnp.argsort(key, stable=True)
    idx = order[:b2]
    return idx, tgt_r[idx], tgt_t[idx], x0[idx]


@jax.jit
def _merge(res1, idx, res2):
    """Overlay phase-2 results onto the parent where they add found-ness.

    Rows the parent should KEEP are redirected to the out-of-bounds index
    ``b`` and DROPPED by the scatter (``mode="drop"``), so the merge is
    pure scatters with no per-field parent-row gathers and no sink-row
    concatenate/slice pair.  A pose takes res2 exactly when it failed res1
    and res2 found it.
    """
    b = res1.found.shape[0]
    take2 = ~res1.found[idx] & res2.found
    idx_eff = jnp.where(take2, idx, b)  # b = out of bounds -> dropped

    def put(dst, src):
        return dst.at[idx_eff].set(src, mode="drop")

    found = put(res1.found, res2.found)
    x = put(res1.x, res2.x)
    cost = put(res1.cost, res2.cost)
    iters = None
    if res1.iters is not None and res2.iters is not None:
        iters = put(res1.iters, res2.iters)
    lane_iters = None
    if res1.lane_iters is not None and res2.lane_iters is not None:
        lane_iters = res1.lane_iters + res2.lane_iters
    return ik_mod.IKResult(found=found, x=x, cost=cost, iters=iters,
                           lane_iters=lane_iters)


def build_multiphase_solver(spec, cfg: SolverConfig, *, screens,
                            final_p_blk: int | None = None,
                            dtype=jnp.float32, interpret: bool = False,
                            ee_offset=None, presort: bool = False):
    """Compile an N-phase cascade; fn(tgt_r, tgt_t, x0) -> IKResult.

    ``screens`` is a list of dicts, one per screening pass, each with keys

      ``seeds``    seed lanes per pose (a power of two),
      ``rounds``   restart rounds in this screen (budget = rounds * seeds),
      ``iters``    max LM iterations per attempt (default cfg.max_iters),
      ``p_blk``    poses per kernel block (default lm_kernel.block_poses),
      ``keep_div`` the *next* phase solves ceil(B_i / keep_div) poses.

    ``final_p_blk`` is the final phase's poses per block (same default).

    Phase i screens its batch, a stable failures-first argsort compacts the
    failed poses into the next (smaller) batch, and the last phase replays
    the **full** ``cfg`` restart schedule.  Results merge back up the chain.

    The found mask is a superset of the single-shot schedule's: every pose
    that fails all screens gets the complete single-shot schedule (unless
    its tail overflows ``keep_div`` — size tails generously), and every
    screen success satisfies the same tolerances under a prefix of the same
    fold_in seed table.  Selection stays deterministic at any batch size.
    """
    if cfg.solution_mode != SolutionMode.SPEED:
        raise ValueError("cascade scheduling is Speed-mode only")

    solvers = []   # (solve_fn, keep_div)
    units = []     # poses per block of each phase
    for sc in screens:
        s = min(sc["seeds"], cfg.total_restarts)
        r = sc.get("rounds", 1) * s
        if cfg.total_restarts <= r:
            raise ValueError("screen budget exceeds the total; drop it")
        c = cfg.replace(max_restarts=r, seed_batch=s)
        if sc.get("iters"):
            c = c.replace(max_iters=sc["iters"])
        units.append(sc.get("p_blk") or lm_kernel.block_poses(s))
        solvers.append((lm_kernel.build_kernel_solver(
            spec, c, dtype, p_blk=units[-1], interpret=interpret,
            ee_offset=ee_offset), sc.get("keep_div", 8)))

    final_p_blk = final_p_blk or lm_kernel.block_poses(
        lm_kernel.seed_lanes(cfg))
    final = lm_kernel.build_kernel_solver(spec, cfg, dtype,
                                          p_blk=final_p_blk,
                                          interpret=interpret,
                                          ee_offset=ee_offset)

    pose_cost = None
    if presort:
        # ``presort`` orders the incoming batch by the caller-seed residual
        # cost (one cheap fused evaluation per pose) so phase-1 blocks
        # hold difficulty-homogeneous poses: easy blocks' lockstep loops
        # exit well before the screen budget instead of being held by one
        # straggler.  Results are permuted back, and per-pose outputs are
        # bitwise identical to the unsorted schedule (a pose's lanes never
        # interact with its block neighbors).
        from ..ops import soa

        c_ps = soa.chain_constants(spec)
        if ee_offset is not None:
            c_ps = lm_kernel.fold_ee_offset(c_ps, ee_offset)
        a_n = spec.num_positions

        def pose_cost(tr, tt, xs):
            qs = [xs[:, j] for j in range(a_n)]
            tgtm = [[tr[:, i, j] for j in range(3)] for i in range(3)]
            tgtt = [tt[:, i] for i in range(3)]
            w6 = soa.weight6_from_config(tgtm, cfg.linear_weight,
                                         cfg.angular_weight)
            e, _ = soa.residual_and_jtask(c_ps, qs, tgtm, tgtt,
                                          weight6=w6)
            return soa.vec_dot(e, e)

    # Granule of the batch each phase *receives*: screens after the first
    # get compacted batches, which must be multiples of their own block.
    units = units[1:] + [final_p_blk]

    # One jit over the whole cascade: phases, compaction and merges become
    # a single device program instead of ~7 chained dispatches.  All shapes
    # are static per B, so this compiles once per batch size.
    @jax.jit
    def solve(tgt_r, tgt_t, x0):
        inv = None
        if pose_cost is not None:
            order = jnp.argsort(pose_cost(tgt_r, tgt_t, x0))
            inv = jnp.argsort(order)
            tgt_r, tgt_t, x0 = tgt_r[order], tgt_t[order], x0[order]
        stack = []  # (res_i, idx_into_parent) per screen
        tr, tt, xs = tgt_r, tgt_t, x0
        # Poses whose failures exceed a compaction's capacity keep their
        # screen failure instead of the full budget; count them device-side
        # so the caller can observe (and rescue) the contract break without
        # any extra dispatch (IKResult.overflow_count).
        overflow = jnp.zeros((), jnp.int32)
        for (fn, keep_div), unit in zip(solvers, units):
            res = fn(tr, tt, xs)
            b = tr.shape[0]
            nxt = min(b, -(-max(b // keep_div, 1) // unit) * unit)
            n_fail = jnp.sum((~res.found).astype(jnp.int32))
            overflow = overflow + jnp.maximum(0, n_fail - nxt)
            idx, tr, tt, xs = _compact(res.found, res.cost, tr, tt, xs, nxt)
            stack.append((res, idx))
        out = final(tr, tt, xs)
        for res, idx in reversed(stack):
            out = _merge(res, idx, out)
        if inv is not None:
            out = out._replace(
                found=out.found[inv], x=out.x[inv], cost=out.cost[inv],
                iters=None if out.iters is None else out.iters[inv])
        # Device-side found count: chained callers fetch this instead of
        # dispatching a separate per-batch sum (see IKResult.found_count).
        return out._replace(
            found_count=jnp.sum(out.found.astype(jnp.int32)),
            overflow_count=overflow)

    return solve


def build_default_solver(spec, cfg: SolverConfig, dtype=jnp.float32,
                         interpret: bool = False, ee_offset=None,
                         p_blk: int | None = None):
    """The production schedule; fn(tgt_r, tgt_t, x0) -> IKResult.

    Returns ``(solve, block_unit)``: B must be a multiple of block_unit,
    the kernel's poses per block (``p_blk``, default
    lm_kernel.block_poses), which every phase shares.

    Three phases when the restart budget allows:

      screen  every pose, 1 round of S lanes at 5/16 max_iters (10 of
              the default 32);
      mid     failed quarter, 2 rounds at 5/8 max_iters;
      final   failed 1/32, the full restart schedule.

    The found mask matches the single-shot schedule's (every pose
    failing all screens replays the complete budget) as long as no
    compaction overflows; an overflow is counted on
    ``IKResult.overflow_count`` and rescued by Robot.ik_batch.  Falls back
    to the 2-phase schedule when the budget is too small to split three
    ways (needs > 3 rounds of S lanes).
    """
    s = lm_kernel.seed_lanes(cfg)
    p = p_blk or lm_kernel.block_poses(s)
    screen_iters = max(1, (5 * cfg.max_iters) // 16)
    mid_iters = max(1, (5 * cfg.max_iters) // 8)
    if cfg.total_restarts > 3 * s:
        solve = build_multiphase_solver(
            spec, cfg,
            screens=[{"seeds": s, "rounds": 1, "iters": screen_iters,
                      "p_blk": p, "keep_div": 4},
                     {"seeds": s, "rounds": 2, "iters": mid_iters,
                      "p_blk": p, "keep_div": 8}],
            final_p_blk=p, dtype=dtype, interpret=interpret,
            ee_offset=ee_offset)
    else:
        solve = build_cascade_solver(
            spec, cfg, dtype=dtype, p_blk=p, phase1_rounds=1, tail_div=8,
            interpret=interpret, ee_offset=ee_offset)
    return solve, p


def build_cascade_solver(spec, cfg: SolverConfig, dtype=jnp.float32,
                         p_blk: int | None = None, phase1_rounds: int = 2,
                         tail_div: int = 8, p_blk2: int | None = None,
                         phase1_seeds: int | None = None,
                         phase1_iters: int | None = None,
                         interpret: bool = False, ee_offset=None):
    """Two-phase cascade (one screen + full replay); see
    :func:`build_multiphase_solver` for semantics and the N-phase form.

    ``phase1_seeds``/``phase1_iters`` let the screen run a smaller budget
    than the replay.  ``p_blk``/``p_blk2`` are the poses per block of the
    screen and the replay; B must be a multiple of ``p_blk``.
    """
    screen = {"seeds": phase1_seeds or cfg.seed_batch,
              "rounds": phase1_rounds, "iters": phase1_iters,
              "p_blk": p_blk, "keep_div": tail_div}
    return build_multiphase_solver(spec, cfg, screens=[screen],
                                   final_p_blk=p_blk2 or p_blk,
                                   dtype=dtype, interpret=interpret,
                                   ee_offset=ee_offset)
