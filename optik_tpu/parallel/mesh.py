"""Device-mesh sharding for batched IK.

The reference's parallelism is a single-host rayon pool (lib.rs:38-47); the
scaling axes here are the device-mesh analogs mapped out in SURVEY.md §2:

  * ``data``  — pose queries (the reference's stream of independent solves);
  * ``seed``  — restart seeds (the reference's work-stealing restart axis).

Sharding strategy: lanes are laid out (B, S, A) and annotated with
``NamedSharding(mesh, P("data", "seed"))``; everything in the LM loop is
per-lane elementwise, so XLA partitions it with zero communication, and the
Speed/Quality winner selection (an argmin over S per pose) compiles to an
argmin-reduce collective across the ``seed`` axis, which XLA hands to NCCL
over NVLink.  Pose shards never talk to each other, so the ``data`` axis
may also span hosts.  The mesh is logical: ``make_mesh`` reshapes the
device list, since every card of a host reaches every other at the same
rate.

Single-host multi-device works out of the box; multi-host requires the
caller to have run ``jax.distributed.initialize`` first (standard JAX
runtime).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SolverConfig
from ..ops import kinematics as K
from ..solver import ik as ik_mod, lm
from ..utils.precision import with_f32_matmuls


def make_mesh(devices: Optional[Sequence] = None,
              data: Optional[int] = None,
              seed: int = 1) -> Mesh:
    """Build a (data, seed) mesh over the given (default: all) devices.

    ``data * seed`` must equal the device count; ``data`` defaults to
    ``len(devices) // seed``.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data is None:
        data = n // seed
    if data * seed != n:
        raise ValueError(f"mesh shape {data}x{seed} != {n} devices")
    arr = np.array(devices).reshape(data, seed)
    return Mesh(arr, ("data", "seed"))


_solver_cache = {}


def ik_sharded(robot, cfg: SolverConfig, tgt_r, tgt_t, x0,
               mesh: Mesh) -> ik_mod.IKResult:
    """Solve B poses x S seeds sharded over a (data, seed) mesh.

    ``robot`` is an optik_tpu.Robot.  B must be divisible by
    mesh.shape['data'] and S (cfg.total_restarts) by mesh.shape['seed'].
    Lanes run on the SoA fast path; the winner selection lowers to a
    seed-axis argmin-reduce collective.

    WHEN TO USE WHICH MULTI-DEVICE ENTRY: this is the fully-general
    XLA-path entry — it shards the lanes of ONE lockstep solve across the
    mesh, so any (data, seed) factorization works.  For kernel solves use
    :func:`build_seed_sharded_solver` (seed axis > 1: each device runs the
    full kernel on its restart-stream slice, one argmin-reduce merges
    winners) or :func:`build_sharded_cascade` (pure data parallelism with
    the production cascade schedule, zero solve-time collectives).
    """
    if tgt_r.shape[0] % mesh.shape["data"]:
        raise ValueError("pose batch not divisible by mesh 'data' axis")
    if cfg.total_restarts % mesh.shape["seed"]:
        raise ValueError("restart count not divisible by mesh 'seed' axis")

    # Keyed on the spec's *content*, not id() — ids are recycled after GC
    # and a stale entry would serve the wrong chain constants.
    key = (robot.spec.content_key(), robot.dtype, cfg, mesh)
    fn = _solver_cache.get(key)
    if fn is None:
        fn = ik_mod.build_batch_solver(robot.spec, cfg, robot.dtype,
                                       mesh=mesh)
        _solver_cache[key] = fn

    multiproc = any(d.process_index != jax.process_index()
                    for d in mesh.devices.flat)

    def to_global(x):
        """Host data -> device array; on a multi-process mesh, assemble a
        global jax.Array from the (process-replicated) host copy so each
        process only materializes its addressable pose shards."""
        x = np.asarray(x, robot.dtype)
        if not multiproc:
            return jnp.asarray(x)
        sharding = NamedSharding(mesh, P("data"))
        return jax.make_array_from_callback(x.shape, sharding,
                                            lambda idx: x[idx])

    return fn(to_global(tgt_r), to_global(tgt_t), to_global(x0))


def _shard_map(fn, mesh, in_specs, out_specs):
    """shard_map with replication checking off (kernel outputs carry no
    varying-mesh-axes annotation)."""
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def build_seed_sharded_solver(robot, cfg: SolverConfig, mesh: Mesh, *,
                              interpret: bool = False,
                              p_blk: int | None = None):
    """Kernel IK sharded over BOTH mesh axes — SURVEY §2's "seeds along
    devices" architecture on the Pallas kernel.

    Device (i, d) runs the complete kernel (ops/pallas/lm_kernel.py) on
    pose shard i with restart-stream slice
    ``[d*R/n, (d+1)*R/n)`` of the deterministic fold_in stream (R =
    cfg.total_restarts, n = mesh.shape['seed']), threaded through the
    kernel's traced ``restart_offset``; devices d > 0 swap the caller-x0
    lane for the stream's own index-offset draw (``lane0_stream``) so the
    union of per-device attempt sets is EXACTLY the single-device restart
    stream.  One argmin-reduce collective over the ``seed`` axis then
    merges winners — the mesh replacement for the reference's
    work-stealing restart scaling across cores (lib.rs:298-301):

      * Speed: global winner = lowest restart index among all devices'
        registered successes (per-device keys are disjoint by construction,
        so the pmin + masked-psum merge is exact);
      * Quality: global winner = min seed-distance to the caller's x0 over
        every successful attempt in the budget; since Quality lanes explore
        their full budget (no pose freezing), the merged result is BITWISE
        identical to the single-device full-budget kernel (float-equal
        distance ties break toward the lowest seed-shard, measure-zero).

    The found mask is bitwise identical to the single-device full-budget
    solve in BOTH modes (attempt outcomes are pure functions of their seed,
    so found-ness is schedule-invariant); the Speed-mode winner can differ
    from the single-shot kernel's in the same corner the cascade documents
    (per-device pose freezing truncates different attempt streams), but every
    winner satisfies the same tolerances and selection is deterministic for
    a fixed mesh shape.  ``iters`` reports the winning device's
    iterations-to-converge (observability only).

    Not-found poses return ``x = x0`` and ``cost = +inf`` (the IKResult
    contract gates ``x``/``cost`` on ``found``).

    ``cfg.quality_max_successes`` is rejected (its truncation is
    per-device and would change the selection pool across mesh shapes).
    ``interpret`` runs the kernel in the Pallas interpreter (CPU tests).

    Returns ``solve(tgt_r (B,3,3), tgt_t (B,3), x0 (B,A)) -> IKResult``
    with B divisible by ``data_axis * p_blk`` (``p_blk`` = poses per
    kernel block, default lm_kernel.block_poses).
    """
    from ..ops.pallas import lm_kernel

    n_seed = int(mesh.shape["seed"])
    n_data = int(mesh.shape["data"])
    r_total = cfg.total_restarts
    if r_total % n_seed:
        raise ValueError(
            f"total_restarts {r_total} not divisible by mesh 'seed' axis "
            f"{n_seed}")
    if (cfg.solution_mode == ik_mod.SolutionMode.QUALITY
            and cfg.quality_max_successes):
        raise ValueError(
            "quality_max_successes truncates per device and is unsupported "
            "with seed sharding; use the unsharded kernel or cap=0")
    r_sub = r_total // n_seed
    sub = cfg.replace(max_restarts=r_sub)
    p_blk = p_blk or lm_kernel.block_poses(lm_kernel.seed_lanes(sub))
    ksolve = lm_kernel.build_kernel_solver(robot.spec, sub, robot.dtype,
                                           p_blk=p_blk, interpret=interpret)
    unit = n_data * p_blk
    speed = cfg.solution_mode == ik_mod.SolutionMode.SPEED
    big = jnp.iinfo(jnp.int32).max

    def shard_fn(tr, tt, x0):
        d = jax.lax.axis_index("seed")
        off = (d * r_sub).astype(jnp.int32)
        res = ksolve(tr, tt, x0, restart_offset=off, lane0_stream=d > 0)
        if speed:
            # Global restart index of this device's winner; disjoint offset
            # ranges make keys unique across devices, so exactly one device
            # claims each found pose.
            key = jnp.where(res.found, res.sel_key + off, big)
            kmin = jax.lax.pmin(key, "seed")
            mine = res.found & (key == kmin)
            found = kmin < big
        else:
            dist = res.sel_key
            dmin = jax.lax.pmin(dist, "seed")
            cand = res.found & (dist == dmin)
            # Tie-break exact float-equal distances toward the lowest
            # seed-shard (deterministic; measure-zero event).
            aidx = jnp.where(cand, d, n_seed).astype(jnp.int32)
            amin = jax.lax.pmin(aidx, "seed")
            mine = cand & (aidx == amin)
            found = jnp.isfinite(dmin)
        x = jax.lax.psum(jnp.where(mine[:, None], res.x, 0), "seed")
        cost = jax.lax.psum(jnp.where(mine, res.cost, 0), "seed")
        iters = None
        if res.iters is not None:
            iters = jax.lax.psum(jnp.where(mine, res.iters, 0), "seed")
        x = jnp.where(found[:, None], x, x0)
        cost = jnp.where(found, cost, jnp.asarray(jnp.inf, cost.dtype))
        li = res.lane_iters
        if li is not None:
            li = jax.lax.psum(li, ("data", "seed"))
        fc = jax.lax.psum(jnp.sum(found.astype(jnp.int32)), "data")
        return ik_mod.IKResult(found=found, x=x, cost=cost, iters=iters,
                               lane_iters=li, found_count=fc)

    pose = P("data")
    out_specs = ik_mod.IKResult(found=pose, x=pose, cost=pose, iters=pose,
                                lane_iters=P(), found_count=P())
    sharded = jax.jit(_shard_map(shard_fn, mesh,
                                 (pose, pose, pose), out_specs))

    def solve(tgt_r, tgt_t, x0):
        b = tgt_r.shape[0]
        if b % unit:
            raise ValueError(
                f"batch {b} must be a multiple of data_axis * p_blk "
                f"= {n_data} * {p_blk}")
        return sharded(jnp.asarray(tgt_r, robot.dtype),
                       jnp.asarray(tgt_t, robot.dtype),
                       jnp.asarray(x0, robot.dtype))

    return solve


def build_sharded_cascade(robot, cfg: SolverConfig, mesh: Mesh, *,
                          interpret: bool = False, p_blk: int | None = None,
                          **cascade_kw):
    """Cascade scheduler sharded over the mesh's ``data`` axis.

    The pose-parallel cascade on several devices (on four H100s it has not
    yet run faster than one card's cascade; see PERF.md): every device runs
    the full screen/compact/replay schedule (solver/cascade.py) on ITS OWN
    pose shard — compaction is a local stable argsort, so no pose ever
    crosses a device boundary and the solve needs zero collectives (the only
    cross-device op is the psum of the ``lane_iters`` work counter).  This is
    the deliberate inversion of the reference's global work-stealing queue
    (lib.rs:298-301): locality beats load balance here because per-shard
    work is concentrated by the cascade itself, and shard imbalance is
    bounded by the tail phase (~1/8 of a shard's block time).

    Per-pose results are bitwise identical to running the unsharded cascade
    on each shard, so determinism is mesh-shape-invariant at fixed shard
    size.  Returns ``fn(tgt_r (B,3,3), tgt_t (B,3), x0 (B,A)) -> IKResult``
    with B divisible by ``data_axis * p_blk`` (``p_blk`` = poses per kernel
    block, default lm_kernel.block_poses).

    With no ``cascade_kw`` each shard runs the 3-phase production schedule
    (solver/cascade.build_default_solver — the same schedule the
    single-device ``Robot.ik_batch`` path uses); explicit extra kwargs
    (tail_div etc.) select the 2-phase ``build_cascade_solver`` with those
    knobs (tests use tiny blocks).  ``interpret`` runs the kernels in the
    Pallas interpreter (CPU tests).
    """
    from ..ops.pallas import lm_kernel
    from ..solver import cascade

    if cascade_kw:
        s = min(cascade_kw.get("phase1_seeds") or cfg.seed_batch,
                cfg.total_restarts)
        unit = p_blk or lm_kernel.block_poses(s)
        local = cascade.build_cascade_solver(
            robot.spec, cfg, dtype=robot.dtype, interpret=interpret,
            p_blk=unit, **cascade_kw)
    else:
        local, unit = cascade.build_default_solver(
            robot.spec, cfg, dtype=robot.dtype, interpret=interpret,
            p_blk=p_blk)

    def shard_fn(tr, tt, x0):
        res = local(tr, tt, x0)
        li = res.lane_iters
        if li is not None:
            li = jax.lax.psum(li, "data")
        fc = res.found_count
        if fc is not None:
            fc = jax.lax.psum(fc, "data")
        ov = res.overflow_count
        if ov is not None:
            ov = jax.lax.psum(ov, "data")
        return res._replace(lane_iters=li, found_count=fc,
                            overflow_count=ov)

    pose = P("data")
    out_specs = ik_mod.IKResult(found=pose, x=pose, cost=pose, iters=pose,
                                lane_iters=P(), found_count=P(),
                                overflow_count=P())
    # jit the shard_mapped computation: called eagerly, shard_map re-lowers
    # the whole per-shard cascade (3 Pallas kernels + compact/merge) on
    # every invocation.
    sharded = jax.jit(_shard_map(shard_fn, mesh, (pose, pose, pose),
                                 out_specs))

    data_n = int(mesh.shape["data"])

    def solve(tgt_r, tgt_t, x0):
        b = tgt_r.shape[0]
        if b % (data_n * unit):
            raise ValueError(
                f"batch {b} must be a multiple of data_axis * block_unit "
                f"= {data_n} * {unit} (the schedule runs {unit}-pose "
                f"kernel blocks per shard; pass p_blk to shrink the block, "
                f"or pad the batch)")
        return sharded(jnp.asarray(tgt_r, robot.dtype),
                       jnp.asarray(tgt_t, robot.dtype),
                       jnp.asarray(x0, robot.dtype))

    return solve
