"""Structure-of-arrays (SoA) compute path: all math as scalar components.

Why this exists: the natural (L, 3, 3)/(L, 6, 6) array-of-structures layout
puts tiny 3/6-sized dimensions in the minor positions of every array, so
the compiler sees small matrix products and strided component access
instead of independent lanes.  Here every small matrix and vector is a
Python list whose entries are (L,)-shaped arrays (or plain Python floats for
static chain constants, which XLA constant-folds), so the *lane* dimension is
the only array axis: XLA sees nothing but element-wise ops on (L,) vectors
and fuses the whole pipeline.

These functions are pure Python over anything that supports jnp arithmetic,
so the *same code* also runs inside the Pallas kernel body on one block of
lanes (ops/pallas/lm_kernel.py).

All formulas mirror optik_tpu.math.so3/se3 (which carry the reference
citations); equivalence with the array path is pinned by tests/test_soa.py.
"""

from __future__ import annotations

from typing import List

import jax.numpy as jnp

from ..math.so3 import EPSILON

# A small matrix is a list of rows; a vector is a list of components.
# Components are (L,) arrays or python floats (static constants).
Mat = List[List]
Vec = List

# --- generic small linear algebra (unrolled at trace time) -----------------
#
# Static-sparsity-aware scalar ops: chain constants (joint origins, axes)
# are plain Python floats, and for real robots most are exact 0/1 (Panda's
# axes are all axis-aligned, origin rotations are signed permutations).
# The XLA path would fold x*0 and x+0 in its algebraic simplifier, but the
# Pallas kernel lowers the jaxpr to Triton directly — no XLA optimization
# pass ever sees it — so skipping dead terms at trace time keeps them out
# of the kernel (about a quarter of the LM body's ops are static-zero
# products on the Panda).  `0.0` results stay Python floats so the
# sparsity propagates through the FK composition chain.
#
# NOTE: the static folds are not IEEE-faithful for non-finite traced
# operands (x * 0 -> 0.0 even when x would be NaN/Inf at runtime).  All
# current callers fold only static chain constants against finite joint
# values; do not rely on NaN/Inf propagation through statically-zero terms.


def smul(a, b):
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return a * b
    if isinstance(a, (int, float)):
        a, b = b, a
    if isinstance(b, (int, float)):
        if b == 0.0:
            return 0.0
        if b == 1.0:
            return a
        if b == -1.0:
            return -a
    return a * b


def sadd(a, b):
    if isinstance(a, (int, float)) and a == 0.0:
        return b
    if isinstance(b, (int, float)) and b == 0.0:
        return a
    return a + b


def ssub(a, b):
    if isinstance(b, (int, float)) and b == 0.0:
        return a
    if isinstance(a, (int, float)) and a == 0.0:
        return -b
    return a - b


def ssum(terms):
    acc = 0.0
    for t in terms:
        acc = sadd(acc, t)
    return acc


def mat_mul(a: Mat, b: Mat) -> Mat:
    n, k, m = len(a), len(b), len(b[0])
    return [[ssum([smul(a[i][p], b[p][j]) for p in range(k)])
             for j in range(m)] for i in range(n)]


def mat_vec(a: Mat, v: Vec) -> Vec:
    return [ssum([smul(a[i][j], v[j]) for j in range(len(v))])
            for i in range(len(a))]


def mat_tvec(a: Mat, v: Vec) -> Vec:
    """a^T v."""
    return [ssum([smul(a[j][i], v[j]) for j in range(len(a))])
            for i in range(len(a[0]))]


def mat_t(a: Mat) -> Mat:
    return [[a[j][i] for j in range(len(a))] for i in range(len(a[0]))]


def vec_add(u: Vec, v: Vec) -> Vec:
    return [sadd(ui, vi) for ui, vi in zip(u, v)]


def vec_sub(u: Vec, v: Vec) -> Vec:
    return [ssub(ui, vi) for ui, vi in zip(u, v)]


def vec_scale(u: Vec, s) -> Vec:
    return [smul(ui, s) for ui in u]


def vec_dot(u: Vec, v: Vec):
    return ssum([smul(ui, vi) for ui, vi in zip(u, v)])


def vec_cross(u: Vec, v: Vec) -> Vec:
    return [ssub(smul(u[1], v[2]), smul(u[2], v[1])),
            ssub(smul(u[2], v[0]), smul(u[0], v[2])),
            ssub(smul(u[0], v[1]), smul(u[1], v[0]))]


def cholesky_solve(a: Mat, b: Vec) -> Vec:
    """Unrolled SPD solve on components (same scheme as math/linalg.py)."""
    import jax

    n = len(b)
    l = [[None] * n for _ in range(n)]
    for j in range(n):
        s = a[j][j]
        for k in range(j):
            s = s - l[j][k] * l[j][k]
        # rsqrt: one reciprocal-root op instead of sqrt-then-divide.
        inv_d = jax.lax.rsqrt(jnp.maximum(s, 1e-30))
        l[j][j] = inv_d
        for i in range(j + 1, n):
            s = a[i][j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            l[i][j] = s * inv_d
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s * l[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s * l[i][i]
    return x


# --- SO(3) -----------------------------------------------------------------


def rodrigues(axis: Vec, angle) -> Mat:
    """R = I + sin(q) K + (1-cos(q)) K^2 for a (static) unit axis.

    Built with static-sparsity ops: for the axis-aligned joints real
    robots overwhelmingly use, six of the nine entries are static and the
    matrix reduces to the classic 2-D rotation block at trace time.
    """
    s, c = jnp.sin(angle), jnp.cos(angle)
    c1 = 1.0 - c
    kx, ky, kz = axis

    def diag(kk):  # 1 + c1 * (kk - 1) with kk = sum of squared others
        if kk == 1.0:
            return c  # axis-aligned: 1 - c1
        return sadd(1.0, smul(c1, -kk))

    def off(sk, ka, kb):  # sk * s + c1 * (ka * kb)
        return sadd(smul(sk, s), smul(ka * kb, c1))

    return [
        [diag(ky * ky + kz * kz), off(-kz, kx, ky), off(ky, kx, kz)],
        [off(kz, kx, ky), diag(kx * kx + kz * kz), off(-kx, ky, kz)],
        [off(-ky, kx, kz), off(kx, ky, kz), diag(kx * kx + ky * ky)],
    ]


def mat_to_quat(r: Mat) -> Vec:
    """Branchless Shepperd (see math/so3.py): returns (x, y, z, w)."""
    r00, r01, r02 = r[0]
    r10, r11, r12 = r[1]
    r20, r21, r22 = r[2]
    tw = 1.0 + r00 + r11 + r22
    tx = 1.0 + r00 - r11 - r22
    ty = 1.0 - r00 + r11 - r22
    tz = 1.0 - r00 - r11 + r22

    def ss(x):
        return jnp.sqrt(jnp.maximum(x, 1e-30))

    sw, sx, sy, sz = ss(tw), ss(tx), ss(ty), ss(tz)
    qw = [(r21 - r12) / sw, (r02 - r20) / sw, (r10 - r01) / sw, sw]
    qx = [sx, (r01 + r10) / sx, (r02 + r20) / sx, (r21 - r12) / sx]
    qy = [(r01 + r10) / sy, sy, (r12 + r21) / sy, (r02 - r20) / sy]
    qz = [(r02 + r20) / sz, (r12 + r21) / sz, sz, (r10 - r01) / sz]

    m_w = (tw >= tx) & (tw >= ty) & (tw >= tz)
    m_x = (~m_w) & (tx >= ty) & (tx >= tz)
    m_y = (~m_w) & (~m_x) & (ty >= tz)
    q = [jnp.where(m_w, qw[i], jnp.where(m_x, qx[i],
                                         jnp.where(m_y, qy[i], qz[i])))
         for i in range(4)]
    norm = jnp.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3])
    return [qi / norm for qi in q]


def quat_log(q: Vec) -> Vec:
    """Rotation-vector log of a unit quaternion (x, y, z, w)."""
    x, y, z, w = q
    sign = jnp.where(w < 0.0, -1.0, 1.0)
    x, y, z, w = x * sign, y * sign, z * sign, w * sign
    v2 = x * x + y * y + z * z
    small = v2 <= EPSILON
    v2s = jnp.where(small, 1.0, v2)
    vn = jnp.sqrt(v2s)
    exact = jnp.arctan2(vn, w) / vn
    w3 = w * w * w
    taylor = 1.0 / w - v2 / (3.0 * w3) + (v2 * v2) / (5.0 * w3 * w * w)
    t = 2.0 * jnp.where(small, taylor, exact)
    return [x * t, y * t, z * t]


def mat_log(r: Mat) -> Vec:
    return quat_log(mat_to_quat(r))


def add_hat_terms(diag, w: Vec, c_hat, c_hat2) -> Mat:
    """diag*I + c_hat*[w]_x + c_hat2*[w]_x^2, expanded."""
    wx, wy, wz = w
    w11, w22, w33 = wx * wx, wy * wy, wz * wz
    w12, w13, w23 = wx * wy, wx * wz, wy * wz
    return [
        [diag + c_hat2 * (-w22 - w33),
         -c_hat * wz + c_hat2 * w12,
         c_hat * wy + c_hat2 * w13],
        [c_hat * wz + c_hat2 * w12,
         diag + c_hat2 * (-w11 - w33),
         -c_hat * wx + c_hat2 * w23],
        [-c_hat * wy + c_hat2 * w13,
         c_hat * wx + c_hat2 * w23,
         diag + c_hat2 * (-w11 - w22)],
    ]


def rot_log_terms(r: Mat):
    """Rotation log + exact trig of the angle: (w, trig) from R directly.

    ``w = log(R)`` as a rotation vector and ``trig = (theta, theta2,
    sin theta, cos theta)``, costing ONE sqrt and one atan2 for the whole
    bundle.  Two identities make this cheap:

      * Shepperd's four quaternion candidates are each *proportional* to
        the quaternion (candidate c is ``4c * (x, y, z, w)``), so the
        max-trace branch select works on the unnormalized candidates and
        the normalization (5 sqrt + 16 div in ``mat_to_quat``) is never
        needed — ``atan2(|v|, w)`` and ``theta/|v|`` are scale-free;
      * sin/cos of the *full* angle come from the double-angle identities
        ``sin t = 2 v w / |q|^2``, ``cos t = (w^2 - v^2) / |q|^2`` instead
        of calling sin/cos — exact, not approximations.

    Downstream (se3_log_trig / se3_right_jacobian_blocks_trig /
    so3_right_jacobian_trig) all reuse this trig, where the naive chain
    recomputed sqrt+sin+cos three times (the round-2 profile counted 42
    transcendentals per lane-iteration; this chain now costs ~17).
    Formula provenance: math/so3.py (Shepperd, quaternion log — reference
    math.rs:40-63 with the same double-cover handling and Taylor switch).
    """
    r00, r01, r02 = r[0]
    r10, r11, r12 = r[1]
    r20, r21, r22 = r[2]
    tw = 1.0 + r00 + r11 + r22
    tx = 1.0 + r00 - r11 - r22
    ty = 1.0 - r00 + r11 - r22
    tz = 1.0 - r00 - r11 + r22
    a01 = r01 + r10
    a02 = r02 + r20
    a12 = r12 + r21
    s21 = r21 - r12
    s02 = r02 - r20
    s10 = r10 - r01
    # Per-component Shepperd candidates, ordered (w-, x-, y-, z-branch).
    cand_x = (s21, tx, a01, a02)
    cand_y = (s02, a01, ty, a12)
    cand_z = (s10, a02, a12, tz)
    cand_w = (tw, s21, s02, s10)
    m_w = (tw >= tx) & (tw >= ty) & (tw >= tz)
    m_x = (~m_w) & (tx >= ty) & (tx >= tz)
    m_y = (~m_w) & (~m_x) & (ty >= tz)

    def pick(c):
        return jnp.where(m_w, c[0],
                         jnp.where(m_x, c[1], jnp.where(m_y, c[2], c[3])))

    x, y, z, w = pick(cand_x), pick(cand_y), pick(cand_z), pick(cand_w)
    sign = jnp.where(w < 0.0, -1.0, 1.0)  # double cover: w >= 0
    x, y, z, w = x * sign, y * sign, z * sign, w * sign

    v2 = x * x + y * y + z * z
    n2 = v2 + w * w
    vn = jnp.sqrt(v2)
    half = jnp.arctan2(vn, w)      # theta/2, scale-free, in [0, pi/2]
    theta = 2.0 * half
    small = v2 <= EPSILON * n2     # == normalized v2 <= EPSILON
    # t = theta / vn (scale cancels); Taylor in v2/w^2 near the zero
    # rotation where vn underflows the division.
    inv_w = 1.0 / jnp.where(small, jnp.maximum(w, 1e-30), w)
    u = v2 * inv_w * inv_w
    taylor = inv_w * (1.0 - u / 3.0 + (u * u) / 5.0)
    tt = 2.0 * jnp.where(small, taylor, half / jnp.where(small, 1.0, vn))
    w_log = [x * tt, y * tt, z * tt]
    inv_n2 = 1.0 / n2
    sin_t = 2.0 * vn * w * inv_n2
    cos_t = (w * w - v2) * inv_n2
    return w_log, (theta, theta * theta, sin_t, cos_t)


def _trig_from_w(w: Vec):
    """(theta, theta2, sin, cos) for a rotation vector (legacy entry)."""
    theta2 = vec_dot(w, w)
    theta = jnp.sqrt(theta2)
    return theta, theta2, jnp.sin(theta), jnp.cos(theta)


def _hat_coeffs_trig(trig):
    """a = sin(t)/t, b = (1-cos t)/t^2, branchless, from shared trig."""
    theta, theta2, s, c = trig
    small = theta2 <= EPSILON
    inv_t2 = 1.0 / jnp.where(small, 1.0, theta2)
    t4 = theta2 * theta2
    a = jnp.where(small, 1.0 - theta2 / 6.0 + t4 / 120.0,
                  s * theta * inv_t2)  # sin(t)/t without a fresh rsqrt
    b = jnp.where(small, 0.5 - theta2 / 24.0 + t4 / 720.0,
                  (1.0 - c) * inv_t2)
    return a, b, small, inv_t2


def so3_right_jacobian_trig(w: Vec, trig) -> Mat:
    a, b, small, inv_t2 = _hat_coeffs_trig(trig)
    theta2 = trig[1]
    t4 = theta2 * theta2
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0 + t4 / 5040.0,
                  (1.0 - a) * inv_t2)
    e = (b - 2.0 * c) / (2.0 * a)
    return add_hat_terms(1.0, w, 0.5, e)


def so3_right_jacobian_from_w(w: Vec) -> Mat:
    return so3_right_jacobian_trig(w, _trig_from_w(w))


# --- SE(3) -----------------------------------------------------------------


def se3_log_trig(w: Vec, t: Vec, trig) -> Vec:
    """[v; w] with v = V^{-1} t, given w = log(R) and its trig.

    The Taylor switch is at theta2 <= EPSILON (theta ~ 1e-3), wider than
    math/se3.py's: in f32 the exact branch's 1 - cos(theta) rounds to 0
    below theta ~ 3e-4 (division blow-up), while the 3-term Taylor tail at
    theta = 1e-3 is ~1e-13 relative — strictly more accurate there.
    """
    theta, theta2, s, c = trig
    small = theta2 <= EPSILON
    inv_t2 = 1.0 / jnp.where(small, 1.0, theta2)
    coef_exact = (1.0 - 0.5 * theta * s
                  / jnp.maximum(1.0 - c, 1e-30)) * inv_t2
    t4 = theta2 * theta2
    coef_taylor = 1.0 / 12.0 + theta2 / 720.0 + t4 / 30240.0
    coef = jnp.where(small, coef_taylor, coef_exact)
    v_inv = add_hat_terms(1.0, w, -0.5, coef)
    v = mat_vec(v_inv, t)
    return v + list(w)


def se3_log_from_w(w: Vec, t: Vec) -> Vec:
    return se3_log_trig(w, t, _trig_from_w(w))


def se3_log(r: Mat, t: Vec) -> Vec:
    w, trig = rot_log_terms(r)
    return se3_log_trig(w, t, trig)


def se3_right_jacobian_blocks_trig(w: Vec, t: Vec, trig):
    """(J_r(w), Q(t, w)) blocks of the 6x6 right Jacobian, shared trig."""
    theta, theta2, s, c = trig
    small = theta2 <= EPSILON
    inv_t2 = 1.0 / jnp.where(small, 1.0, theta2)

    s_t = s * theta * inv_t2  # sin(theta)/theta
    inv_1mc = 1.0 / jnp.maximum(2.0 * (1.0 - c), 1e-30)
    a_exact = inv_t2 - s_t * inv_1mc
    b_exact = -2.0 * inv_t2 * inv_t2 + (1.0 + s_t) * inv_1mc * inv_t2
    a = jnp.where(small, 1.0 / 12.0 + theta2 / 720.0, a_exact)
    b = jnp.where(small, 1.0 / 360.0, b_exact)

    d = vec_dot(w, t)
    cvec = vec_sub(vec_scale(w, b * d), vec_scale(t, theta2 * b + 2.0 * a))

    # C = 0.5 [t]_x + cvec w^T + a w t^T + d a I
    da = d * a
    tx, ty, tz = t
    wx, wy, wz = w
    C = [
        [cvec[0] * wx + a * wx * tx + da,
         -0.5 * tz + cvec[0] * wy + a * wx * ty,
         0.5 * ty + cvec[0] * wz + a * wx * tz],
        [0.5 * tz + cvec[1] * wx + a * wy * tx,
         cvec[1] * wy + a * wy * ty + da,
         -0.5 * tx + cvec[1] * wz + a * wy * tz],
        [-0.5 * ty + cvec[2] * wx + a * wz * tx,
         0.5 * tx + cvec[2] * wy + a * wz * ty,
         cvec[2] * wz + a * wz * tz + da],
    ]
    jr = so3_right_jacobian_trig(w, trig)
    q = mat_mul(C, jr)
    return jr, q


def se3_right_jacobian_blocks(w: Vec, t: Vec):
    """Legacy entry computing the angle trig from ``w`` itself."""
    return se3_right_jacobian_blocks_trig(w, t, _trig_from_w(w))


# --- chain kinematics ------------------------------------------------------


def chain_constants(spec):
    """Static per-joint constants as plain Python floats.

    XLA folds them into the trace, so joint origins cost nothing at runtime.
    Returns (origins_r, origins_t, axes, prismatic, tip_r, tip_t, has_tip).
    """
    import numpy as np

    a = spec.origin_r.shape[0]
    org_r = [[[float(spec.origin_r[j, i, k]) for k in range(3)]
              for i in range(3)] for j in range(a)]
    org_t = [[float(spec.origin_t[j, i]) for i in range(3)] for j in range(a)]
    axes = [[float(spec.axis[j, i]) for i in range(3)] for j in range(a)]
    pris = [bool(spec.prismatic[j] > 0.5) for j in range(a)]
    tip_r = [[float(spec.tip_r[i, k]) for k in range(3)] for i in range(3)]
    tip_t = [float(spec.tip_t[i]) for i in range(3)]
    has_tip = not (np.allclose(spec.tip_r, np.eye(3))
                   and np.allclose(spec.tip_t, 0.0))
    return org_r, org_t, axes, pris, tip_r, tip_t, has_tip


def fk_joints(consts, q: Vec):
    """FK over the chain; q is a list of A (L,) arrays.

    Returns (frames, r_ee, t_ee): frames[j] = (R_j, p_j) world joint frames
    (tip applied to the EE only) — same contract as ops/kinematics.fk_joints.
    """
    org_r, org_t, axes, pris, tip_r, tip_t, has_tip = consts
    a = len(q)

    r, t = None, None  # None = identity prefix
    frames = []
    for j in range(a):
        if pris[j]:
            lr = org_r[j]
            lt = vec_add(org_t[j], mat_vec(org_r[j], vec_scale(axes[j], q[j])))
        else:
            lr = mat_mul(org_r[j], rodrigues(axes[j], q[j]))
            lt = org_t[j]
        if r is None:
            r, t = lr, list(lt)
        else:
            t = vec_add(mat_vec(r, lt), t)
            r = mat_mul(r, lr)
        frames.append((r, t))

    r_ee, t_ee = r, t
    if has_tip:
        t_ee = vec_add(mat_vec(r_ee, tip_t), t_ee)
        r_ee = mat_mul(r_ee, tip_r)
    return frames, r_ee, t_ee


def fk_with_ee(consts, q: Vec, ee_r: Mat = None, ee_t: Vec = None):
    """FK + optional EE offset: (frames, r_ee, t_ee)."""
    frames, r_ee, t_ee = fk_joints(consts, q)
    if ee_r is not None:
        t_ee = vec_add(mat_vec(r_ee, ee_t), t_ee)
        r_ee = mat_mul(r_ee, ee_r)
    return frames, r_ee, t_ee


def jacobian_cols(consts, frames, r_ee: Mat, t_ee: Vec):
    """Geometric Jacobian columns (EE/local frame), one 6-list per joint."""
    axes = consts[2]
    pris = consts[3]
    cols = []
    for j in range(len(frames)):
        rj, pj = frames[j]
        dir_w = mat_vec(rj, axes[j])
        if pris[j]:
            lin_l = mat_tvec(r_ee, dir_w)
            cols.append(lin_l + [0.0, 0.0, 0.0])
        else:
            lin_w = vec_cross(dir_w, vec_sub(t_ee, pj))
            lin_l = mat_tvec(r_ee, lin_w)
            ang_l = mat_tvec(r_ee, dir_w)
            cols.append(lin_l + ang_l)
    return cols


def residual_and_jtask(consts, q: Vec, tgt_r: Mat, tgt_t: Vec,
                       ee_r: Mat = None, ee_t: Vec = None,
                       weight6: Mat = None):
    """Fused hot path: (residual [6], J_task [6][A]).

    Everything one LM iteration needs from one FK pass: the weighted pose
    error r = M log6(T_tgt^-1 T(q)) and its Jacobian M Jlog6 Jgeo — the
    component-form equivalent of ops/objective.residual_and_jacobian.
    """
    frames, r_ee, t_ee = fk_with_ee(consts, q, ee_r, ee_t)

    # X = T_tgt^-1 * T_ee
    xr = mat_mul(mat_t(tgt_r), r_ee)
    xt = mat_tvec(tgt_r, vec_sub(t_ee, tgt_t))

    # One rotation-log + angle-trig bundle shared by the SE(3) log and both
    # right-Jacobian blocks (see rot_log_terms — the naive chain recomputed
    # sqrt/sin/cos three times over).
    w_log, trig = rot_log_terms(xr)
    e = se3_log_trig(w_log, xt, trig)

    a = len(q)
    cols = jacobian_cols(consts, frames, r_ee, t_ee)

    jr, qq = se3_right_jacobian_blocks_trig(w_log, xt, trig)
    # J_task = [[jr, qq], [0, jr]] @ Jgeo  -> 6 x A
    jt = [[None] * a for _ in range(6)]
    for j in range(a):
        col = cols[j]
        for i in range(3):
            jt[i][j] = sadd(
                ssum([smul(jr[i][k], col[k]) for k in range(3)]),
                ssum([smul(qq[i][k], col[3 + k]) for k in range(3)]))
            jt[3 + i][j] = ssum([smul(jr[i][k], col[3 + k])
                                 for k in range(3)])

    if weight6 is not None:
        e = mat_vec(weight6, e)
        jt = mat_mul(weight6, jt)
    return e, jt


def weight6_from_config(tgt_r: Mat, wl, wa):
    """6x6 weighting M = blockdiag(R^T diag(wl) R, R^T diag(wa) R) or None.

    ``tgt_r`` components may be (L,) arrays; weights are static floats.
    """
    from .objective import weights_are_identity

    lin_id = weights_are_identity(wl)
    ang_id = weights_are_identity(wa)
    if lin_id and ang_id:
        return None

    def conj(w):
        return [[sum(tgt_r[k][i] * float(w[k]) * tgt_r[k][j]
                     for k in range(3)) for j in range(3)] for i in range(3)]

    def ident():
        return [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]

    m_l = ident() if lin_id else conj(wl)
    m_a = ident() if ang_id else conj(wa)
    out = [[0.0] * 6 for _ in range(6)]
    for i in range(3):
        for j in range(3):
            out[i][j] = m_l[i][j]
            out[3 + i][3 + j] = m_a[i][j]
    return out
