"""Robot facade: the user-facing API, signature-compatible with the
reference's Python binding plus first-class batched entry points.

Reference surface mirrored (kylc/optik crates/optik-py/src/lib.rs:17-163 and
optik.pyi):

  * ``Robot.from_urdf_file(path, base_link, ee_link)`` (and ``_str``)
  * ``num_positions()``, ``joint_limits()``, ``set_parallelism(n)``
  * ``random_configuration()``
  * ``fk(x, ee_offset=None) -> 4x4``          (row-major, like optik-py)
  * ``joint_jacobian(x, ee_offset=None) -> 6xN`` (EE/local frame)
  * ``ik(config, target, x0, ee_offset=None) -> (list, cost) | None``
  * ``diff_ik(x0, V_WE, v_max, ee_offset=None) -> (alpha, list) | None``

Batched extensions: ``fk_batch``, ``jacobian_batch``, ``ik_batch``,
``diff_ik_batch`` operate on leading batch axes and return device arrays —
these are the throughput paths the benchmarks use; the scalar methods above
are convenience wrappers (one compile each, then O(100us) dispatch).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple, Union


import jax
import jax.numpy as jnp
import numpy as np

from .config import SolutionMode, SolverConfig
from .models.chain import ChainSpec
from .ops import kinematics as K
from .solver import ik as ik_mod
from .utils.precision import with_f32_matmuls

# Public-surface array annotations (reference parity: optik.pyi:9-49 types
# every signature; here the accepted inputs are anything array-convertible
# and returns are device arrays for batched entry points, numpy/lists for
# the scalar reference-compatible ones).
ArrayLike = Union[np.ndarray, jax.Array, "list", "tuple"]

# The batched path each solution mode takes on the GPU (Robot._route): the
# faster of the XLA loop, the kernel and the cascade over the kernel,
# measured end to end on the card (PERF.md).
_GPU_ROUTE = {SolutionMode.SPEED: "cascade", SolutionMode.QUALITY: "kernel"}

# Speed-mode batches of at least this many kernel blocks route through the
# cascade scheduler: its final phase replays 1/32 of the batch, so smaller
# batches would only pad (module-level so tests can exercise the cascade
# path at small batch sizes; see Robot.ik_batch).
_CASCADE_MIN_BLOCKS = 32


def _default_dtype():
    return jnp.float64 if jax.config.read("jax_enable_x64") else jnp.float32


def _parse_pose(pose, dtype) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """4x4 row-major (nested lists / ndarray) -> (R, t); validates rigidity.

    Mirrors optik-py's ``parse_pose`` (optik-py/src/lib.rs:8-15): a
    non-rigid-transform input raises "invalid target transform specified".
    """
    m = np.asarray(pose, dtype=np.float64)
    if m.shape != (4, 4):
        raise ValueError("invalid target transform specified")
    r = m[:3, :3]
    if (not np.allclose(r @ r.T, np.eye(3), atol=1e-6)
            or not np.isclose(np.linalg.det(r), 1.0, atol=1e-6)
            or not np.allclose(m[3], [0.0, 0.0, 0.0, 1.0], atol=1e-6)):
        raise ValueError("invalid target transform specified")
    return jnp.asarray(r, dtype=dtype), jnp.asarray(m[:3, 3], dtype=dtype)


def _ee_key(ee_offset) -> Optional[bytes]:
    """Solver-cache key of a constant ``(R, t)`` EE offset."""
    if ee_offset is None:
        return None
    return (np.asarray(ee_offset[0], np.float64).tobytes()
            + np.asarray(ee_offset[1], np.float64).tobytes())


def _pose_to_mat(r, t) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = np.asarray(r, dtype=np.float64)
    m[:3, 3] = np.asarray(t, dtype=np.float64)
    return m


class Robot:
    """A serial-chain robot bound to device-resident chain constants."""

    def __init__(self, spec: ChainSpec, dtype=None):
        self.spec = spec
        self.dtype = dtype or _default_dtype()
        self.params = K.ChainParams.from_spec(spec, dtype=self.dtype)
        self._rng = np.random.default_rng()
        # Compiled SoA solvers, keyed by config (+ ee-offset bytes on the
        # kernel path, where the offset is folded in at build time).
        self._solvers = {}

    def _solver(self, config: SolverConfig):
        fn = self._solvers.get(config)
        if fn is None:
            fn = ik_mod.build_batch_solver(self.spec, config, self.dtype)
            self._solvers[config] = fn
        return fn

    def _route(self, config: SolverConfig) -> str:
        """Which batched solver ``ik_batch`` runs: "xla", "kernel" or
        "cascade".

        The kernel and the cascade over it run on the GPU, by the faster
        path per solution mode measured on the card (``_GPU_ROUTE``, see
        PERF.md).  The CPU runs the XLA path, except under the
        ``_interpret`` test hook, which routes the same way as the GPU with
        interpreter-mode kernels.
        """
        if not (getattr(self, "_interpret", False)
                or jax.devices()[0].platform == "gpu"):
            return "xla"
        return _GPU_ROUTE[config.solution_mode]

    def _kernel_solver(self, config: SolverConfig, ee_offset=None):
        """(solver, block_unit) on the Pallas kernel path, or None.

        None when the seed-lane count is not a power of two (the Triton
        lowering's shape rule): such configs run on the XLA path.  A
        constant ``ee_offset`` (given as an ``(R, t)`` pair of ndarrays)
        folds into the chain tip at build time and becomes part of the
        solver cache key.
        """
        from .ops.pallas import lm_kernel

        s = lm_kernel.seed_lanes(config)
        if s & (s - 1):
            return None
        key = ("kernel", config, _ee_key(ee_offset))
        entry = self._solvers.get(key)
        if entry is None:
            fn = lm_kernel.build_kernel_solver(
                self.spec, config, dtype=self.dtype, ee_offset=ee_offset,
                interpret=getattr(self, "_interpret", False))
            entry = (fn, lm_kernel.block_poses(s))
            self._solvers[key] = entry
        return entry

    def _cascade_solver(self, config: SolverConfig, ee_offset=None):
        """(solver, block_unit) on the cascade path, or None.

        Speed-mode batches route through the screen/replay scheduler
        (solver/cascade.py), which keeps one straggling pose from holding
        its block for the full restart budget.  Only applies when the
        restart budget exceeds two rounds of the lane count (otherwise
        there is no replay schedule to split) and the seed-lane count is a
        power of two.
        """
        from .ops.pallas import lm_kernel

        if config.solution_mode != SolutionMode.SPEED:
            return None  # Quality work is uniform; cascade has no referent
        s = lm_kernel.seed_lanes(config)
        if s < 2 or s & (s - 1) or config.total_restarts <= 2 * s:
            return None
        key = ("cascade", config, _ee_key(ee_offset))
        entry = self._solvers.get(key)
        if entry is None:
            from .solver import cascade

            entry = cascade.build_default_solver(
                self.spec, config, dtype=self.dtype, ee_offset=ee_offset,
                interpret=getattr(self, "_interpret", False))
            self._solvers[key] = entry
        return entry

    # --- constructors -----------------------------------------------------

    @staticmethod
    def from_urdf_file(path: "str | os.PathLike[str]",
                       base_link: str, ee_link: str,
                       dtype=None) -> "Robot":
        return Robot(ChainSpec.from_urdf_file(path, base_link, ee_link),
                     dtype=dtype)

    @staticmethod
    def from_urdf_str(urdf: str, base_link: str, ee_link: str,
                      dtype=None) -> "Robot":
        return Robot(ChainSpec.from_urdf_str(urdf, base_link, ee_link),
                     dtype=dtype)

    # --- introspection ----------------------------------------------------

    def num_positions(self) -> int:
        return self.spec.num_positions

    def joint_limits(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.spec.joint_limits()

    def set_parallelism(self, n: int) -> None:
        """Reference-API compatibility no-op (with a one-time note).

        The reference resizes its rayon pool (lib.rs:66-72); here occupancy
        is set by batch shapes (``SolverConfig.max_restarts`` /
        ``seed_batch`` and the pose batch size), so there is no pool to
        resize.  In particular, the reference's documented determinism
        recipe ``set_parallelism(1)`` (README.md:96) is unnecessary:
        results here are deterministic unconditionally, at any batch size
        or mesh shape.  A one-time info-level log says so, so reference
        porters get a signal instead of a silent no-op.
        """
        if not getattr(self, "_parallelism_noted", False):
            import logging

            logging.getLogger(__name__).info(
                "optik_tpu: set_parallelism(%d) is a no-op — determinism "
                "is unconditional here and occupancy is set by batch "
                "shapes (seed_batch / pose batch size), not a thread "
                "pool.", n)
            self._parallelism_noted = True

    def random_configuration(self, rng: Optional[np.random.Generator] = None
                             ) -> np.ndarray:
        """Uniform sample within the joint limits (lib.rs:86-91).

        Unbounded joints sample in [-pi, pi] (see solver/ik.py).
        """
        rng = rng or self._rng
        lo, hi = self.joint_limits()
        lo = np.where(np.isfinite(lo), lo, -np.pi)
        hi = np.where(np.isfinite(hi), hi, np.pi)
        return rng.uniform(lo, hi)

    # --- kinematics -------------------------------------------------------

    def _ee_offset(self, ee_offset):
        if ee_offset is None:
            return None, None
        return _parse_pose(ee_offset, self.dtype)

    def fk(self, x: ArrayLike,
           ee_offset: Optional[ArrayLike] = None) -> np.ndarray:
        """EE pose as a 4x4 row-major matrix (optik-py/src/lib.rs:103-115)."""
        x = self._check_q(x, "x")
        ee_r, ee_t = self._ee_offset(ee_offset)
        r, t = _fk_jit(self.params, jnp.asarray(x, self.dtype), ee_r, ee_t)
        return _pose_to_mat(r, t)

    @property
    def _consts(self):
        # Static SoA chain constants (cached; see ops/soa.py).
        c = getattr(self, "_consts_cache", None)
        if c is None:
            from .ops import soa

            c = soa.chain_constants(self.spec)
            self._consts_cache = c
        return c

    def _fk_batch_fn(self):
        # jitted once per robot (a fresh closure per call would recompile
        # on every invocation).
        fn = getattr(self, "_fk_batch_cache", None)
        if fn is not None:
            return fn
        from .ops import soa

        consts = self._consts
        a = self.num_positions()

        @with_f32_matmuls
        @jax.jit
        def fn(x, ee_r, ee_t):
            comps = [x[..., j] for j in range(a)]
            eem = eev = None
            if ee_r is not None:
                eem = [[ee_r[i, j] for j in range(3)] for i in range(3)]
                eev = [ee_t[i] for i in range(3)]
            _, r_ee, t_ee = soa.fk_with_ee(consts, comps, eem, eev)
            r = jnp.stack([jnp.stack(
                [jnp.broadcast_to(r_ee[i][j], x.shape[:-1])
                 for j in range(3)], axis=-1) for i in range(3)], axis=-2)
            t = jnp.stack([jnp.broadcast_to(t_ee[i], x.shape[:-1])
                           for i in range(3)], axis=-1)
            return r, t

        self._fk_batch_cache = fn
        return fn

    def fk_batch(self, x: ArrayLike,
                 ee_offset: Optional[ArrayLike] = None
                 ) -> Tuple[jax.Array, jax.Array]:
        """Batched EE poses: (..., A) -> ((..., 3, 3), (..., 3)) on device.

        Computes on the SoA fast path (batch-in-lanes layout) and packs the
        results into conventional (..., 3, 3)/(..., 3) arrays at the end.
        """
        x = jnp.asarray(x, self.dtype)
        ee_r, ee_t = self._ee_offset(ee_offset)
        return self._fk_batch_fn()(x, ee_r, ee_t)

    def joint_jacobian(self, x: ArrayLike,
                       ee_offset: Optional[ArrayLike] = None
                       ) -> np.ndarray:
        """Local-frame geometric Jacobian (6, N) (optik-py/src/lib.rs:91-101)."""
        x = self._check_q(x, "x")
        ee_r, ee_t = self._ee_offset(ee_offset)
        return np.asarray(
            _jac_jit(self.params, jnp.asarray(x, self.dtype), ee_r, ee_t))

    def _jac_batch_fn(self):
        fn = getattr(self, "_jac_batch_cache", None)
        if fn is not None:
            return fn
        from .ops import soa

        consts = self._consts
        a = self.num_positions()

        @with_f32_matmuls
        @jax.jit
        def fn(x, ee_r, ee_t):
            comps = [x[..., j] for j in range(a)]
            eem = eev = None
            if ee_r is not None:
                eem = [[ee_r[i, j] for j in range(3)] for i in range(3)]
                eev = [ee_t[i] for i in range(3)]
            frames, r_ee, t_ee = soa.fk_with_ee(consts, comps, eem, eev)
            cols = soa.jacobian_cols(consts, frames, r_ee, t_ee)
            lane = x.shape[:-1]
            return jnp.stack([jnp.stack(
                [jnp.broadcast_to(cols[j][i], lane) for j in range(a)],
                axis=-1) for i in range(6)], axis=-2)

        self._jac_batch_cache = fn
        return fn

    def jacobian_batch(self, x: ArrayLike,
                       ee_offset: Optional[ArrayLike] = None) -> jax.Array:
        """Batched local-frame Jacobians: (..., A) -> (..., 6, A)."""
        x = jnp.asarray(x, self.dtype)
        ee_r, ee_t = self._ee_offset(ee_offset)
        return self._jac_batch_fn()(x, ee_r, ee_t)

    # --- inverse kinematics -----------------------------------------------

    def _check_q(self, x, name) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        if x.shape != (self.num_positions(),):
            raise ValueError(f"len({name}) != num_positions")
        return x

    def _check_seed_in_limits(self, x0: np.ndarray) -> None:
        # Mirrors the reference's seed validation panic (lib.rs:251-254).
        lo, hi = self.joint_limits()
        if np.any(x0 < lo) or np.any(x0 > hi):
            raise ValueError("seed joint position outside of joint limits")

    def ik(self, config: SolverConfig, target: ArrayLike, x0: ArrayLike,
           ee_offset: Optional[ArrayLike] = None
           ) -> Optional[Tuple[List[float], float]]:
        """Single-pose IK; returns (solution, cost) or None (lib.rs:241-415).

        Routes through :meth:`ik_batch` at B=1: on the GPU that is the
        single-shot kernel (one pose padded to one block; Speed-mode pose
        freezing exits the block as soon as the pose converges), elsewhere
        the XLA SoA solver.
        """
        x0 = self._check_q(x0, "x0")
        self._check_seed_in_limits(x0)
        tgt_r, tgt_t = _parse_pose(target, self.dtype)
        res = self.ik_batch(config, tgt_r[None], tgt_t[None],
                            np.asarray(x0)[None], ee_offset=ee_offset,
                            validate_seeds=False)
        if not bool(res.found[0]):
            return None
        return (list(np.asarray(res.x[0], dtype=np.float64)),
                float(res.cost[0]))

    def _ik_batch_unlimited(self, config: SolverConfig, tgt_r, tgt_t, x0,
                            ee_offset, validate_seeds) -> ik_mod.IKResult:
        """Honest unlimited-restart semantics for ``max_restarts=0``.

        The reference restarts until the wall clock expires
        (lib.rs:273-277); the deterministic analog runs rounds of
        DEFAULT_RESTARTS seeds, each round re-solving ONLY the unconverged
        poses with the next slice of the fold_in restart stream
        (restart indices r*R .. r*R + R - 1), until every pose converges
        or ``config.unlimited_rounds_cap`` rounds have run.  Per-pose
        results are batch-size- and round-boundary-invariant: a pose's
        outcome depends only on its own restart stream.

        Observability semantics: ``iters`` for a pose rescued in round
        r > 0 reports the RESCUING round's iterations-to-converge, not a
        cumulative count across rounds; ``lane_iters`` accumulates every
        round's work, with the power-of-two pad rows' contribution (they
        duplicate ``bad[-1]``) scaled out as ``n_real / bucket`` — an
        estimate, since pad rows share tile blocks with real rows.

        The round loop is host-ORCHESTRATED but device-RESIDENT: per round
        the host fetches only the sub-batch's found mask (a few KB) and
        uploads the gather/scatter index vectors; targets, solutions and
        costs stay on the device.
        Merges use the cascade's sink-row scatter trick so every round's
        executables are shape-bounded by the power-of-two bucket.
        """
        from .config import DEFAULT_RESTARTS

        base = config.replace(max_restarts=DEFAULT_RESTARTS)
        res = self.ik_batch(base, tgt_r, tgt_t, x0, ee_offset=ee_offset,
                            validate_seeds=validate_seeds)
        found = np.asarray(res.found).copy()
        cap = max(1, config.unlimited_rounds_cap)
        if found.all() or cap == 1:
            return res

        b = found.shape[0]
        tgt_r_d = jnp.asarray(tgt_r, self.dtype)
        tgt_t_d = jnp.asarray(tgt_t, self.dtype)
        x0_d = jnp.asarray(x0, self.dtype)
        x, cost = res.x, res.cost
        iters = res.iters
        lane_iters = res.lane_iters

        def put(dst, src, idxe):
            # Drop-mode scatter (see cascade._merge): rows to keep are
            # redirected to the out-of-bounds index b and dropped.
            return dst.at[idxe].set(src, mode="drop")

        for r in range(1, cap):
            bad = np.flatnonzero(~found)
            if bad.size == 0:
                break
            # Pad the hard-pose set to a power-of-two bucket (by repeating
            # its last index) so rounds reuse a bounded set of compiled
            # batch shapes; duplicate rows are dropped at the merge.
            n_real = bad.size
            bucket = 1 << (n_real - 1).bit_length()
            if bucket > n_real:
                bad = np.concatenate(
                    [bad, np.full(bucket - n_real, bad[-1])])
            bad_d = jnp.asarray(bad)
            sub = self.ik_batch(base, tgt_r_d[bad_d], tgt_t_d[bad_d],
                                x0_d[bad_d], ee_offset=ee_offset,
                                validate_seeds=False,
                                _restart_offset=r * DEFAULT_RESTARTS)
            # The ONLY device->host fetch of the round: the bucket's found
            # mask (duplicates masked out host-side).
            ok = np.array(sub.found)
            ok[n_real:] = False
            idxe = jnp.asarray(np.where(ok, bad, b))  # b = sink row
            x = put(x, sub.x, idxe)
            cost = put(cost, sub.cost, idxe)
            if iters is not None and sub.iters is not None:
                iters = put(iters, sub.iters, idxe)
            found[bad[:n_real][ok[:n_real]]] = True
            if lane_iters is not None and sub.lane_iters is not None:
                # Discount the duplicate pad rows' share of the round's
                # work so the schedule-efficiency metric counts real poses
                # (see docstring; exact per-row attribution isn't
                # available from the block-level counter).
                share = (sub.lane_iters * (n_real / float(bucket)))
                lane_iters = lane_iters + share.astype(lane_iters.dtype)
        return ik_mod.IKResult(
            found=jnp.asarray(found), x=x, cost=cost, iters=iters,
            lane_iters=lane_iters)

    def _rescue_overflow(self, config: SolverConfig, res, tgt_r, tgt_t,
                         x0j, ee_offset) -> ik_mod.IKResult:
        """Re-solve every unconverged pose with the full single-shot budget.

        Called (from :meth:`ik_batch`) only when the cascade reported a
        capacity overflow, i.e. some poses kept a screen failure instead of
        receiving their complete restart schedule.  Re-solving ALL
        unconverged poses (not just the overflow — the device program
        doesn't track which ones were denied) through the single-shot
        kernel (``_restart_offset=0`` routes around the cascade) replays
        exactly the full-budget schedule for each, so the merged found
        mask equals the single-shot solver's.  Poses that genuinely fail
        the full budget re-fail deterministically — wasted work, but
        rescues only trigger when the screen failures exceed the replay
        capacity, which random reachable workloads stay well below.
        """
        found = np.asarray(res.found).copy()
        bad = np.flatnonzero(~found)
        if bad.size == 0:
            return res
        n_real = bad.size
        bucket = 1 << (n_real - 1).bit_length()
        if bucket > n_real:
            bad = np.concatenate([bad, np.full(bucket - n_real, bad[-1])])
        tgt_r_np, tgt_t_np = np.asarray(tgt_r), np.asarray(tgt_t)
        x0_np = np.asarray(x0j)
        sub = self.ik_batch(config, tgt_r_np[bad], tgt_t_np[bad],
                            x0_np[bad], ee_offset=ee_offset,
                            validate_seeds=False, _restart_offset=0)
        ok = np.asarray(sub.found)[:n_real]
        bad = bad[:n_real]
        idx = bad[ok]
        x = np.asarray(res.x).copy()
        cost = np.asarray(res.cost).copy()
        iters = None if res.iters is None else np.asarray(res.iters).copy()
        x[idx] = np.asarray(sub.x)[:n_real][ok]
        cost[idx] = np.asarray(sub.cost)[:n_real][ok]
        if iters is not None and sub.iters is not None:
            iters[idx] = np.asarray(sub.iters)[:n_real][ok]
        found[idx] = True
        lane_iters = res.lane_iters
        if lane_iters is not None and sub.lane_iters is not None:
            share = sub.lane_iters * (n_real / float(bucket))
            lane_iters = lane_iters + share.astype(lane_iters.dtype)
        return ik_mod.IKResult(
            found=jnp.asarray(found), x=jnp.asarray(x, self.dtype),
            cost=jnp.asarray(cost, self.dtype),
            iters=None if iters is None else jnp.asarray(iters),
            lane_iters=lane_iters,
            found_count=jnp.asarray(int(found.sum()), jnp.int32),
            overflow_count=res.overflow_count)

    def ik_batch(self, config: SolverConfig, tgt_r: ArrayLike,
                 tgt_t: ArrayLike, x0: ArrayLike,
                 ee_offset: Optional[ArrayLike] = None,
                 validate_seeds: bool = True,
                 rescue_overflow: bool = True,
                 _restart_offset: Optional[int] = None
                 ) -> ik_mod.IKResult:
        """Batched IK over B poses: (B,3,3), (B,3), (B,A) -> IKResult arrays.

        Seeds outside the joint limits raise, as in the scalar path
        (lib.rs:251-254).  ``validate_seeds=False`` skips that check: with
        device-resident ``x0`` the check costs a blocking one-boolean device
        fetch per call, which serializes chained pipelines (each fetch is a
        host round trip that drains the device queue).  Skipping is safe whenever the seeds are produced in-limits by
        construction (e.g. a previous solve's clipped output, or
        ``random_configuration``); an out-of-limits seed then merely wastes
        its lane (the first LM step projects back into the box) instead of
        raising.

        ``rescue_overflow`` (cascade path only): the cascade's replay
        phases have static capacities; a batch whose screen-failure rate
        exceeds them (e.g. a curated all-hard batch) would silently leave
        the overflow poses with less than their full restart budget.  The
        solve counts those device-side (``IKResult.overflow_count``); with
        ``rescue_overflow=True`` (default) this method fetches that scalar
        (one blocking device round trip per call) and, when non-zero,
        re-solves every unconverged pose with the full single-shot budget
        — restoring the per-pose budget contract the reference guarantees
        (lib.rs:273-277) at any failure rate.  Pipelined callers pass
        ``False`` (like ``validate_seeds=False``) and check
        ``overflow_count`` themselves; random reachable workloads stay
        well below the capacity, so rescues are rare.  After a rescue,
        ``overflow_count`` still reports the pre-rescue count (capacity
        pressure observability); the found mask matches the single-shot
        schedule.

        ``config.max_restarts == 0`` engages unlimited-restart rounds
        (see :meth:`_ik_batch_unlimited`).
        """
        if config.max_restarts == 0 and _restart_offset is None:
            return self._ik_batch_unlimited(config, tgt_r, tgt_t, x0,
                                            ee_offset, validate_seeds)
        lo, hi = self.joint_limits()
        if not validate_seeds:
            x0j = jnp.asarray(x0, self.dtype)
        elif isinstance(x0, jax.Array):
            # Device-resident seeds: validate on device and fetch ONE
            # boolean instead of copying the whole (B, A) array to the
            # host.
            x0j = jnp.asarray(x0, self.dtype)
            bad = jnp.any((x0j < jnp.asarray(lo, self.dtype))
                          | (x0j > jnp.asarray(hi, self.dtype)))
            if bool(bad):
                raise ValueError(
                    "seed joint position outside of joint limits")
        else:
            x0 = np.asarray(x0, dtype=np.float64)
            if np.any(x0 < lo) or np.any(x0 > hi):
                raise ValueError(
                    "seed joint position outside of joint limits")
            x0j = jnp.asarray(x0, self.dtype)
        ee_r, ee_t = self._ee_offset(ee_offset)

        tgt_r = jnp.asarray(tgt_r, self.dtype)
        tgt_t = jnp.asarray(tgt_t, self.dtype)

        # On the GPU, route through the Pallas kernel; poses pad up to the
        # kernel block size and the padding is dropped from the result.
        # Per-axis weights and a constant ee_offset both stay on the kernel
        # path (the offset folds into the chain tip at solver-build time).
        # Large Speed-mode batches take the cascade schedule on top of the
        # kernel; small batches stay single-shot.
        route = self._route(config)
        ee_pair = None if ee_offset is None else (ee_r, ee_t)
        b = tgt_r.shape[0]
        kentry = None
        # Unlimited-restart continuation rounds use the single-shot kernel:
        # the cascade's screen phases don't thread the stream offset, and
        # round > 0 batches are the compacted hard poses anyway.
        if route == "cascade" and _restart_offset is None:
            kentry = self._cascade_solver(config, ee_pair)
            if kentry is not None and b < _CASCADE_MIN_BLOCKS * kentry[1]:
                kentry = None
        if kentry is None and route != "xla":
            kentry = self._kernel_solver(config, ee_pair)
        if kentry is not None:
            kfn, blk = kentry
            b_pad = -(-b // blk) * blk
            if b_pad != b:
                pad = b_pad - b
                tgt_r_p = jnp.concatenate(
                    [tgt_r, jnp.broadcast_to(tgt_r[-1:],
                                             (pad, 3, 3))], axis=0)
                tgt_t_p = jnp.concatenate(
                    [tgt_t, jnp.broadcast_to(tgt_t[-1:], (pad, 3))],
                    axis=0)
                x0_p = jnp.concatenate(
                    [x0j, jnp.broadcast_to(x0j[-1:],
                                           (pad, x0j.shape[1]))], axis=0)
            else:
                tgt_r_p, tgt_t_p, x0_p = tgt_r, tgt_t, x0j
            if _restart_offset is None:
                res = kfn(tgt_r_p, tgt_t_p, x0_p)
            else:
                res = kfn(tgt_r_p, tgt_t_p, x0_p,
                          restart_offset=_restart_offset)
            if b_pad != b:
                # Per-pose fields slice off the padding; the scalar
                # lane_iters work counter keeps the padded total, and
                # found_count would include padded poses, so drop it.
                res = res._replace(
                    found=res.found[:b], x=res.x[:b], cost=res.cost[:b],
                    iters=None if res.iters is None else res.iters[:b],
                    found_count=None)
            # The winner-selection key is internal plumbing for the
            # seed-sharded merge (parallel/mesh.py), not public API.
            res = res._replace(sel_key=None)
            if (rescue_overflow and _restart_offset is None
                    and res.overflow_count is not None
                    and int(res.overflow_count) > 0):
                res = self._rescue_overflow(config, res, tgt_r, tgt_t,
                                            x0j, ee_offset)
            return res

        fn = self._solver(config)
        if _restart_offset is None:
            return fn(tgt_r, tgt_t, x0j, ee_r, ee_t)
        return fn(tgt_r, tgt_t, x0j, ee_r, ee_t,
                  restart_offset=_restart_offset)

    # --- differential IK --------------------------------------------------

    def _diffik_solver(self):
        """Cached batched diff-IK step (exact gauge path when available)."""
        cached = getattr(self, "_diffik_cache", None)
        if cached is None:
            from .solver import diffik

            cached = (diffik.build_batch_solver(self.spec, self.dtype),)
            self._diffik_cache = cached
        return cached[0]

    def diff_ik(self, x0: ArrayLike, V_WE: ArrayLike, v_max: ArrayLike,
                ee_offset: Optional[ArrayLike] = None
                ) -> Optional[Tuple[float, List[float]]]:
        """Velocity-limited diff-IK step (lib.rs:101-239).

        Maximizes the scaling alpha in [0, 1] such that J_W(q) v = alpha*V_WE
        with |v_i| <= v_max_i; returns (alpha, v) or None on solver failure.
        Routes through the batched solver at B=1 (the gauge computation is
        element-wise over lanes, so scalar and batch results are identical).
        """
        x0 = self._check_q(x0, "x0")
        v_we = np.asarray(V_WE, dtype=np.float64)
        if v_we.shape != (6,):
            raise ValueError("len(V_WE) != 6")
        v_max = np.asarray(v_max, dtype=np.float64)
        if v_max.shape != (self.num_positions(),):
            raise ValueError("len(v_max) != num_positions")
        alpha, v, ok = self.diff_ik_batch(x0[None], v_we[None], v_max[None],
                                          ee_offset=ee_offset)
        if not bool(ok[0]):
            return None
        return (float(alpha[0]),
                list(np.asarray(v[0], dtype=np.float64)))

    def _diffik_rescue(self, alpha, v, ok_np, bad, x0, v_we, v_max,
                       ee_r, ee_t):
        """Re-solve ok=False lanes with the iterative ADMM path and merge.

        The exact gauge enumeration reports ok=False on ~0.02-0.05% of
        random instances — degenerate geometry (rank-deficient J with V in
        its range) its facet cuts cannot certify.  The reference's
        Clarabel interior-point solves most of these (lib.rs:216-228); the
        ADMM formulation (solver/diffik.diff_ik_admm_batch) is the
        same-capability iterative fallback, so re-solving just the failed
        lanes recovers Clarabel-parity ok rates at negligible cost.  Lanes
        the ADMM also rejects stay ok=False (honest gate).  The failed set
        pads to a power-of-two bucket to bound compile shapes.
        """
        from .solver import diffik

        n_real = bad.size
        bucket = 1 << (n_real - 1).bit_length()
        if bucket > n_real:
            bad = np.concatenate([bad, np.full(bucket - n_real, bad[-1])])
        x0_np, vwe_np = np.asarray(x0), np.asarray(v_we)
        vm_np = np.asarray(v_max)
        sa, sv, sk = diffik.diff_ik_admm_batch(
            self.params, jnp.asarray(x0_np[bad], self.dtype),
            jnp.asarray(vwe_np[bad], self.dtype),
            jnp.asarray(vm_np[bad], self.dtype), ee_r, ee_t)
        bad = bad[:n_real]
        sub_ok = np.asarray(sk)[:n_real]
        idx = bad[sub_ok]
        a_np = np.asarray(alpha).copy()
        v_np = np.asarray(v).copy()
        a_np[idx] = np.asarray(sa)[:n_real][sub_ok]
        v_np[idx] = np.asarray(sv)[:n_real][sub_ok]
        ok_np = ok_np.copy()
        ok_np[idx] = True
        return (jnp.asarray(a_np, self.dtype),
                jnp.asarray(v_np, self.dtype), jnp.asarray(ok_np))

    def diff_ik_batch(self, x0: ArrayLike, V_WE: ArrayLike,
                      v_max: ArrayLike,
                      ee_offset: Optional[ArrayLike] = None,
                      rescue: bool = True
                      ) -> Tuple[jax.Array, jax.Array, jax.Array]:
        """Batched diff-IK: (B,A), (B,6), (B,A) -> (alpha (B,), v (B,A), ok (B,)).

        ``rescue`` (default True): re-solve any ok=False lanes of the
        exact gauge path with the iterative ADMM solver and merge (see
        :meth:`_diffik_rescue`) — Clarabel-parity behavior on degenerate
        geometry.  The check fetches the ok mask (one blocking device
        round trip per call); pipelined throughput callers pass ``False``
        (the bench does) and handle ok lanes themselves.
        """
        from .solver import diffik

        ee_r, ee_t = self._ee_offset(ee_offset)
        x0 = jnp.asarray(x0, self.dtype)
        v_we = jnp.asarray(V_WE, self.dtype)
        v_max = jnp.asarray(v_max, self.dtype)
        fn = self._diffik_solver()
        if fn is not None:
            alpha, v, ok = fn(x0, v_we, v_max, ee_r, ee_t)
            if rescue:
                ok_np = np.asarray(ok)
                bad = np.flatnonzero(~ok_np)
                if bad.size:
                    alpha, v, ok = self._diffik_rescue(
                        alpha, v, ok_np, bad, x0, v_we, v_max, ee_r, ee_t)
            return alpha, v, ok
        return diffik.diff_ik_admm_batch(self.params, x0, v_we, v_max,
                                         ee_r, ee_t)


@with_f32_matmuls
@jax.jit
def _fk_jit(params, x, ee_r, ee_t):
    return K.fk_ee(params, x, ee_r, ee_t)


@with_f32_matmuls
@jax.jit
def _jac_jit(params, x, ee_r, ee_t):
    return K.joint_jacobian(params, x, ee_r, ee_t)
