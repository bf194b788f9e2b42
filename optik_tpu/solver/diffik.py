"""Differential IK: velocity-limited Cartesian tracking, solved exactly.

Parity target: kylc/optik ``Robot::diff_ik`` (lib.rs:101-239), which solves

    max_{v, alpha} alpha
      s.t.  0 <= alpha <= 1                (move as far as possible ...)
            -v_max <= v <= v_max           (... within joint velocity limits)
            J_W(q) v = alpha * V_WE        (... along the commanded direction)

as a Clarabel conic LP.  The primary path here is the **exact zonotope
gauge solver** (solver/gauge.py): the LP's optimum is the exit point of the
ray {alpha * V} through the zonotope J_W([-v_max, v_max]), computed in
closed form by enumerating C(n, 5) facet-normal cuts — a fixed, unrolled,
SoA-element-wise computation with no iterations at all.  FK, the world
Jacobian, and the solve trace into ONE jitted program on the SoA layout
(ops/soa.py), the same representation the IK hot path uses; the ADMM
formulation (solver/qp.py) remains as the
fallback for joint counts outside the exact path's range and as an
independent test oracle.

The local-frame Jacobian is rotated into the world frame exactly as
lib.rs:184-189 does (for the SoA path this folds to computing the
world-frame geometric columns directly: R_WE @ (R_WE^T lin_w) = lin_w).

Returns (alpha, v, ok).  v is feasible BY CONSTRUCTION: boundary-facet
coordinates are clipped to the unit box and scaled by alpha / t <= 1, so
the reference's bound contracts (alpha in [0,1] +- 1e-6, |v_i| <= v_max +
1e-6, test_ik.rs:200-205) hold exactly.  ``ok`` mirrors Clarabel's Solved
status via the Cartesian tracking residual |J_W v - alpha V| — the honest
gate that catches every degenerate-geometry corner the closed form can
round through (rank-deficient J, V outside the reachable cone).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops import kinematics as K
from ..ops import soa
from . import gauge, qp
from ..utils.precision import with_f32_matmuls

# Success gate: the behavioral contract asserts J_W v == alpha V at 1e-5
# (reference example + tests).  The residual is judged relative to the
# command magnitude (an absolute gate would spuriously fail large-|V|
# commands in f32).
_TRACK_TOL = 1e-5

# ADMM fallback constants (see the round-3 module history in git for the
# full derivation; -100 breaks f32 dual scaling, hence reward -1).
_STAT_TOL = 1e-3
_REG = 1e-9
_ALPHA_REWARD = -1.0


def _jacobian_cols_world(consts, frames, t_ee):
    """World-frame geometric Jacobian columns (6-lists: linear, angular).

    Reference contract: J_W = blockdiag(R_WE) @ J_local (lib.rs:184-189);
    since J_local = blockdiag(R_WE^T) @ J_world (kinematics.rs:179-180)
    this is just the world-frame geometric Jacobian, computed directly.
    """
    axes, pris = consts[2], consts[3]
    cols = []
    for j, (rj, pj) in enumerate(frames):
        dir_w = soa.mat_vec(rj, axes[j])
        if pris[j]:
            cols.append(list(dir_w) + [0.0, 0.0, 0.0])
        else:
            lin_w = soa.vec_cross(dir_w, soa.vec_sub(t_ee, pj))
            cols.append(list(lin_w) + list(dir_w))
    return cols


def build_batch_solver(spec, dtype):
    """Compile the batched diff-IK step for one robot.

    Returns ``fn(x0 (B,A), v_we (B,6), v_max (B,A), ee_r, ee_t) ->
    (alpha (B,), v (B,A), ok (B,))``.  Routes the exact gauge solver for
    5 <= n <= 10 joints (the C(n,5) facet cuts run as an array axis;
    memory scales as C(n,5) x B — see gauge.MAX_EXACT_N), the ADMM path
    otherwise.
    """
    n = spec.num_positions
    if not (gauge.MIN_EXACT_N <= n <= gauge.MAX_EXACT_N):
        return None  # caller falls back to the ADMM path

    consts = soa.chain_constants(spec)

    @with_f32_matmuls
    @jax.jit
    def solve(x0, v_we, v_max, ee_r=None, ee_t=None):
        qs = [x0[:, j] for j in range(n)]
        eem = eev = None
        if ee_r is not None:
            eem = [[ee_r[i, j] for j in range(3)] for i in range(3)]
            eev = [ee_t[i] for i in range(3)]
        frames, _r_ee, t_ee = soa.fk_with_ee(consts, qs, eem, eev)
        cols = _jacobian_cols_world(consts, frames, t_ee)

        v = [v_we[:, k] for k in range(6)]
        vm = [v_max[:, j] for j in range(n)]
        gens = [[vm[j] * cols[j][k] for k in range(6)] for j in range(n)]

        t, u = gauge.gauge_solve(gens, v)

        finite = jnp.isfinite(t)
        t_f = jnp.where(finite, t, 1.0)
        alpha = jnp.where(finite, jnp.minimum(t_f, 1.0), 0.0)
        # Scale the boundary point back to alpha: star-shaped + symmetric
        # box => (alpha/t) * u stays in the box and tracks alpha * V.
        scale = jnp.where(finite, alpha / jnp.maximum(t_f, gauge._TINY), 0.0)
        vel = [vm[j] * u[j] * scale for j in range(n)]

        # V ~ 0: any alpha works with v = 0; the reference LP returns its
        # maximum, alpha = 1 (Clarabel: the equality rows vanish).
        vmag = soa.ssum([jnp.abs(c) for c in v])
        null_v = vmag < 1e-30
        alpha = jnp.where(null_v, 1.0, alpha)
        vel = [jnp.where(null_v, 0.0, vj) for vj in vel]

        # Honest success gate: Cartesian tracking of the *returned* v.
        track = [soa.ssum([vel[j] * cols[j][k] for j in range(n)])
                 - alpha * v[k] for k in range(6)]
        tmax = jnp.abs(track[0])
        for k in range(1, 6):
            tmax = jnp.maximum(tmax, jnp.abs(track[k]))
        vinf = jnp.abs(v[0])
        for k in range(1, 6):
            vinf = jnp.maximum(vinf, jnp.abs(v[k]))
        # No reliable facet cut with a nonzero command => the enumeration
        # cannot certify the geometry (rank-deficient J with V in its
        # range — see gauge.py d_floor); report failure, like Clarabel's
        # non-Solved statuses do (lib.rs:230-238).
        ok = (tmax < _TRACK_TOL * (1.0 + vinf)) & jnp.isfinite(alpha) \
            & (finite | null_v)
        for vj in vel:
            ok = ok & jnp.isfinite(vj)

        return alpha, jnp.stack(vel, axis=-1), ok

    return solve


# --- ADMM fallback path (round-3 formulation; also the test oracle) --------


def _build_qp(params: K.ChainParams, x0, v_we, v_max, ee_r, ee_t):
    n = params.num_positions
    dtype = x0.dtype

    ee_rot, ee_pos, j_local = K.fk_and_jacobian(params, x0, ee_r, ee_t)
    # Rotate the local (EE-frame) Jacobian into the world frame: both the
    # linear and angular row blocks are premultiplied by R_WE (lib.rs:184-189).
    j_w = jnp.concatenate([ee_rot @ j_local[:3], ee_rot @ j_local[3:]], axis=0)

    p = _REG * jnp.eye(n + 1, dtype=dtype)
    qv = jnp.concatenate([jnp.zeros(n, dtype),
                          jnp.asarray([_ALPHA_REWARD], dtype)])

    # Rows: [J_W | -V] (equality), [I | 0] (velocity box), [0 | 1] (alpha box)
    a_eq = jnp.concatenate([j_w, -v_we[:, None]], axis=1)          # (6, n+1)
    a_v = jnp.concatenate([jnp.eye(n, dtype=dtype),
                           jnp.zeros((n, 1), dtype)], axis=1)       # (n, n+1)
    a_alpha = jnp.concatenate([jnp.zeros((1, n), dtype),
                               jnp.ones((1, 1), dtype)], axis=1)    # (1, n+1)
    a = jnp.concatenate([a_eq, a_v, a_alpha], axis=0)

    zero6 = jnp.zeros(6, dtype)
    l = jnp.concatenate([zero6, -v_max, jnp.zeros(1, dtype)])
    u = jnp.concatenate([zero6, v_max, jnp.ones(1, dtype)])
    return p, qv, a, l, u


def _finalize(a, v_max, sol, n):
    """Project onto the box, then judge success on one problem (vmap-able)."""
    v = jnp.clip(sol.x[:n], -v_max, v_max)
    alpha = jnp.clip(sol.x[n], 0.0, 1.0)
    xc = jnp.concatenate([v, alpha[None]])
    track = jnp.max(jnp.abs(a[:6] @ xc))
    ok = ((track < _TRACK_TOL) & (sol.dual_res < _STAT_TOL)
          & jnp.all(jnp.isfinite(xc)))
    return alpha, v, ok


@with_f32_matmuls
@jax.jit
def _diff_ik_admm_one(params, x0, v_we, v_max, ee_r, ee_t):
    p, qv, a, l, u = _build_qp(params, x0, v_we, v_max, ee_r, ee_t)
    sol = qp.solve(p, qv, a, l, u)
    return _finalize(a, v_max, sol, params.num_positions)


@with_f32_matmuls
@jax.jit
def diff_ik_admm_batch(params, x0, v_we, v_max, ee_r=None, ee_t=None):
    """Batched ADMM diff-IK (fallback path / oracle): (B,A),(B,6),(B,A)."""
    def build(x0i, vi, vmi):
        return _build_qp(params, x0i, vi, vmi, ee_r, ee_t)

    p, qv, a, l, u = jax.vmap(build)(x0, v_we, v_max)
    sol = qp.solve(p, qv, a, l, u)
    return jax.vmap(_finalize, in_axes=(0, 0, 0, None))(
        a, v_max, sol, params.num_positions)


def diff_ik_one(params: K.ChainParams, x0, v_we, v_max,
                ee_r: Optional[jnp.ndarray] = None,
                ee_t: Optional[jnp.ndarray] = None
                ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Single diff-IK step on the ADMM path: returns (alpha, v (A,), ok).

    Kept as the routing-independent oracle; the Robot facade routes
    scalar calls through the batched gauge solver at B=1 instead (bitwise
    identical to the batch path lane — the gauge computation is
    element-wise over lanes).
    """
    return _diff_ik_admm_one(params, x0, v_we, v_max, ee_r, ee_t)
