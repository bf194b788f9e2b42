"""Exact zonotope-gauge solver for the differential-IK LP (SoA, batched).

The reference solves diff-IK as a Clarabel conic LP per call
(kylc/optik crates/optik/src/lib.rs:101-239):

    max_{v, alpha} alpha
      s.t.  J_W(q) v = alpha * V,   |v_i| <= vmax_i,   0 <= alpha <= 1.

The batched 800-iteration ADMM (solver/qp.py) solves it iteratively on
tiny (n+7)-dim array-of-structures matrices; this module replaces the
*algorithm* instead, exploiting the LP's geometry:

The image of the velocity box under J_W is a **zonotope**
Z = { sum_i u_i * g_i : |u_i| <= 1 } with generators g_i = vmax_i * J_i.
The optimal alpha is min(1, t*) where t* = max { t : t V in Z } is the exit
parameter of the ray {t V} through Z — the reciprocal gauge of V.  For any
direction w with w.V != 0, convexity gives the *cut*

    t_w = h_Z(w) / |w.V|  >=  t*,      h_Z(w) = sum_i |w.g_i|,

with equality when w supports the exit facet.  Every facet of a
full-dimensional zonotope in R^6 is spanned by 5 generators, so enumerating
the C(n, 5) five-subsets' normals and taking the minimum cut yields t*
exactly (generic position) and a feasible upper bound always — the method
can never overshoot the LP optimum.  The boundary point recovers in closed
form: out-of-facet coordinates sit at their bounds (u_i = sign(w.g_i)), the
5 in-facet coordinates solve a tiny consistent least-squares system, and
scaling by alpha / t* maps the facet point to the solution (the box is
symmetric and star-shaped, so the scaled point stays feasible).

Layout: the subset axis is an ARRAY dimension — all per-facet math runs on
(C, lanes)-shaped arrays written once, not C unrolled copies (an
unrolled form repeats the Gram-Schmidt dependency chains C times, and its
XLA compile time grew out of hand beyond ~21 subsets on an earlier
accelerator; not measured on the GPU).  Small vector components (the 6 spatial
dims, the 5 subset positions) stay Python lists in the SoA style of
ops/soa.py; everything is element-wise over (C, lanes) or (lanes,), with
one tiny one-hot contraction selecting the winning facet.  Zero
iterations, zero data-dependent control flow, exact answers.

Degenerate cases (rank-deficient J, V orthogonal to the reachable space,
ties) can make the minimum cut conservative (t < t*) but never infeasible;
the caller's tracking-residual gate stays the honest success contract.
"""

from __future__ import annotations

import itertools
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import soa

# Largest joint count served by the exact facet enumeration.  The facet
# axis costs C(n, 5) x batch memory per live array (n=7 -> 21 rows, n=10
# -> 252), so very-redundant arms fall back to the iterative ADMM path
# (solver/diffik.py handles the routing); callers with 8-10 joints and
# huge batches should chunk the batch.
MAX_EXACT_N = 10
MIN_EXACT_N = 5

_TINY = 1e-30


def gauge_solve(gens: Sequence[soa.Vec], v: soa.Vec
                ) -> Tuple[jnp.ndarray, List[jnp.ndarray]]:
    """Exit parameter and boundary coordinates of the ray {t v} through
    the zonotope spanned by ``gens``.

    ``gens`` is a length-n list of 6-component generator vectors (lane
    arrays); ``v`` a 6-component direction.  Returns ``(t, u)``: ``t``
    (lane-shaped; +inf when every cut degenerates) such that ``t * v`` is
    on the zonotope boundary, and unit-box coordinates ``u`` (length n)
    with ``sum_i u_i gens[i] ~= t * v`` and ``|u_i| <= 1`` (up to
    roundoff) at any finite ``t``.
    """
    n = len(gens)
    if n < MIN_EXACT_N:
        raise ValueError(f"gauge_solve needs >= {MIN_EXACT_N} generators")
    subsets = list(itertools.combinations(range(n), 5))
    n_sub = len(subsets)
    idx = np.asarray(subsets)                       # (C, 5) static

    lane = jnp.broadcast_shapes(*[jnp.shape(c) for c in v])
    dtype = v[0].dtype if hasattr(v[0], "dtype") else jnp.float32
    gens = [[jnp.broadcast_to(jnp.asarray(gk, dtype), lane) for gk in gi]
            for gi in gens]

    # Subset-position stacks: sub[m][k] is (C, *lane) — row c holds
    # generator idx[c, m]'s k-th component.
    sub = [[jnp.stack([gens[idx[c, m]][k] for c in range(n_sub)], axis=0)
            for k in range(6)] for m in range(5)]

    # --- facet normal per subset row: Gram-Schmidt + complement projector.
    # A degenerate subset yields *some* unit direction, which still
    # produces a valid (upper-bound) cut; see module docstring.
    qvecs = []
    for m in range(5):
        c_vec = list(sub[m])
        for qv in qvecs:
            d = soa.vec_dot(qv, c_vec)
            c_vec = [c_vec[k] - d * qv[k] for k in range(6)]
        inv = jax.lax.rsqrt(jnp.maximum(soa.vec_dot(c_vec, c_vec), _TINY))
        qvecs.append([c_vec[k] * inv for k in range(6)])

    # ||(I - QQ^T) e_k||^2 = 1 - sum_m Q[k,m]^2 (orthonormal columns);
    # take the best-conditioned complement column as the normal.
    nk = [1.0 - sum(qv[k] * qv[k] for qv in qvecs) for k in range(6)]
    best = nk[0]
    coef = [qv[0] for qv in qvecs]
    ek: List = [1.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    for k in range(1, 6):
        better = nk[k] > best
        best = jnp.where(better, nk[k], best)
        coef = [jnp.where(better, qv[k], cm) for qv, cm in zip(qvecs, coef)]
        ek = [jnp.where(better, 1.0 if j == k else 0.0, ek[j])
              for j in range(6)]
    w = [ek[j] - sum(cm * qv[j] for cm, qv in zip(coef, qvecs))
         for j in range(6)]
    inv = jax.lax.rsqrt(jnp.maximum(best, _TINY))
    w = [w[j] * inv for j in range(6)]               # (C, *lane) x 6

    # --- cuts ------------------------------------------------------------
    # Cut-validity floor: |w.v| must clear the f32 noise floor of the dot
    # products, RELATIVE to |v|.  At rank-deficient J (exactly singular
    # configurations), every spanning subset's normal is orthogonal to
    # range(J); if v lies in the range, both w.v and h are pure roundoff
    # and their ratio is garbage — those cuts must be excluded, leaving
    # t = +inf, which the caller reports as ok=False (the facet
    # enumeration cannot certify flat zonotopes; measure-zero configs).
    # A *genuine* near-parallel facet whose cut this floor excludes has
    # t = h/|d| >= h / floor — huge, so exclusion never tightens alpha
    # below min(1, t*); any overshoot is caught by the caller's tracking
    # gate.
    vinf = jnp.abs(v[0])
    for k in range(1, 6):
        vinf = jnp.maximum(vinf, jnp.abs(v[k]))
    d_floor = 1e-5 * vinf                            # (*lane,)

    d = soa.vec_dot(w, v)                            # broadcasts to (C, *)
    s = jnp.where(d < 0, -1.0, 1.0)
    dabs = jnp.abs(d)
    h = soa.ssum([jnp.abs(soa.vec_dot(w, gens[i])) for i in range(n)])
    t_c = jnp.where(dabs > d_floor, h / jnp.maximum(dabs, _TINY), jnp.inf)

    best_t = jnp.min(t_c, axis=0)                    # (*lane,)
    cidx = jnp.argmin(t_c, axis=0)                   # (*lane,) int
    onehot = (jax.lax.broadcasted_iota(jnp.int32, t_c.shape, 0)
              == cidx[None]).astype(dtype)           # (C, *lane)
    best_w = [jnp.sum(onehot * (s * w[j]), axis=0) for j in range(6)]

    # --- boundary-point recovery on the winning facet --------------------
    # Membership mask mu_i = 1 when column i spans the winning facet
    # (static (C, n) table contracted with the winner one-hot).
    memb = np.zeros((n_sub, n), np.float64)
    for c, s_c in enumerate(subsets):
        memb[c, list(s_c)] = 1.0
    mu = [jnp.sum(onehot * jnp.asarray(memb[:, i], dtype)[
        (...,) + (None,) * len(lane)], axis=0) for i in range(n)]

    a_dots = [soa.vec_dot(best_w, gens[i]) for i in range(n)]
    u_out = [jnp.where(a >= 0, 1.0, -1.0) for a in a_dots]

    # Finite stand-in for t on degenerate (all-cuts-invalid) lanes so the
    # recovery math stays NaN-free; the caller masks those lanes out.
    t_f = jnp.where(jnp.isfinite(best_t), best_t, 0.0)

    # Residual target: r = t v - sum_{i not in facet} u_out_i g_i.
    r = [t_f * v[k]
         - soa.ssum([(1.0 - mu[i]) * u_out[i] * gens[i][k]
                     for i in range(n)]) for k in range(6)]

    # Masked normal equations over all n coordinates: facet rows solve the
    # least-squares system, non-facet rows are pinned to u_out (identity).
    gram = [[soa.vec_dot(gens[i], gens[j]) for j in range(n)]
            for i in range(n)]
    tr = soa.ssum([mu[i] * gram[i][i] for i in range(n)]) + _TINY
    reg = 1e-7 * tr
    kkt = [[mu[i] * mu[j] * gram[i][j] for j in range(n)] for i in range(n)]
    for i in range(n):
        kkt[i][i] = kkt[i][i] + jnp.where(mu[i] > 0, 0.0, 1.0)
    rhs = [mu[i] * soa.vec_dot(gens[i], r) + (1.0 - mu[i]) * u_out[i]
           for i in range(n)]
    kkt_reg = [[kkt[i][j] + (reg if i == j else 0.0) for j in range(n)]
               for i in range(n)]
    u = soa.cholesky_solve(kkt_reg, rhs)
    # Two iterative-refinement steps against the UNregularized system kill
    # both the Tikhonov bias (~reg / sigma_min^2 relative, measured at
    # ~1e-4 on short-link arms) and f32 factorization roundoff.
    for _ in range(2):
        resid = [rhs[i] - soa.ssum([kkt[i][j] * u[j] for j in range(n)])
                 for i in range(n)]
        du = soa.cholesky_solve(kkt_reg, resid)
        u = [u[i] + du[i] for i in range(n)]
    return best_t, [jnp.clip(ui, -1.0, 1.0) for ui in u]
