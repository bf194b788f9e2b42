"""SO(3) Lie-group math, batched and branchless.

Provides the rotation-group primitives the IK objective and its analytic
gradient are built on: the hat operators, the logarithmic map (from either a
quaternion or a rotation matrix), the right Jacobian of the log map, and the
Rodrigues exponential used by revolute joints.

Design notes (batch-first):
  * Every function accepts arbitrary leading batch dimensions and is pure, so
    it composes with ``jax.vmap`` / ``jax.jit`` with no shape polymorphism.
  * All singularity handling is *branchless*: both the exact trigonometric
    expression and its Taylor expansion are evaluated on "safe" inputs and
    combined with ``jnp.where``.  This keeps the functions differentiable
    (``jax.grad`` is used as a test oracle) and vectorizes across lanes where
    a data-dependent branch would serialize.
  * The Taylor switch threshold matches the reference implementation
    (``EPSILON = 1e-6`` applied to a *squared* angle; see
    ``crates/optik/src/math.rs:7`` in kylc/optik), so golden-value tests agree
    to < 1e-12.
  * Quaternions are stored ``(x, y, z, w)`` (vector part first), matching the
    JSON golden fixtures.

Behavioral parity targets (kylc/optik, crates/optik/src/math.rs):
  * ``hat``            -> math.rs:13-15
  * ``hat2``           -> math.rs:18-31
  * ``quat_log``       -> math.rs:40-63 (double-cover handling + Taylor)
  * ``right_jacobian`` -> math.rs:72-94 (with the theta=0 NaN fixed: the
    reference divides (1-a)/theta^2 without a Taylor guard; we use the series
    of that coefficient instead, which agrees to O(theta^6) and is finite at
    the identity rotation).
"""

from __future__ import annotations

import jax.numpy as jnp

# Threshold on *squared* rotation-vector / quaternion-vector norms below which
# Taylor expansions replace unstable trigonometric expressions.  Matches the
# reference (math.rs:7).
EPSILON = 1e-6


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """Hat operator [w]_x: (..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    rows = [
        jnp.stack([zero, -wz, wy], axis=-1),
        jnp.stack([wz, zero, -wx], axis=-1),
        jnp.stack([-wy, wx, zero], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def hat2(w: jnp.ndarray) -> jnp.ndarray:
    """Squared hat operator [w]_x^2 computed directly (symmetric).

    (..., 3) -> (..., 3, 3).  Cheaper and better-conditioned than squaring
    ``hat(w)``.
    """
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    w11, w22, w33 = wx * wx, wy * wy, wz * wz
    w12, w13, w23 = wx * wy, wx * wz, wy * wz
    rows = [
        jnp.stack([-w22 - w33, w12, w13], axis=-1),
        jnp.stack([w12, -w11 - w33, w23], axis=-1),
        jnp.stack([w13, w23, -w11 - w22], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def quat_log(q: jnp.ndarray) -> jnp.ndarray:
    """Logarithmic map of SO(3) from a unit quaternion.

    ``q``: (..., 4) ordered (x, y, z, w).  Returns the rotation vector
    theta * axis with shape (..., 3).

    Handles the double cover (q and -q are the same rotation) by flipping to
    the representative with non-negative scalar part, and switches to a Taylor
    expansion of atan2(|v|, w)/|v| below the squared-norm threshold.
    """
    v = q[..., :3]
    w = q[..., 3]
    # Double cover: force w >= 0.
    sign = jnp.where(w < 0.0, -1.0, 1.0)
    v = v * sign[..., None]
    w = w * sign

    v2 = jnp.sum(v * v, axis=-1)
    small = v2 <= EPSILON
    v2_safe = jnp.where(small, 1.0, v2)
    v_norm = jnp.sqrt(v2_safe)
    exact = jnp.arctan2(v_norm, w) / v_norm
    # Taylor series of arctan(|v|/w)/|v| in powers of |v|^2.
    w3 = w * w * w
    taylor = 1.0 / w - v2 / (3.0 * w3) + (v2 * v2) / (5.0 * w3 * w * w)
    theta_over_norm = jnp.where(small, taylor, exact)
    return 2.0 * v * theta_over_norm[..., None]


def mat_to_quat(r: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> unit quaternion (x, y, z, w), branchless.

    Shepperd's method evaluated on all four candidate pivots with the winner
    selected by ``where`` masks, so it is stable for every rotation (including
    angles near pi where the trace-only formula loses precision) and safe
    under vmap/jit.
    """
    r00, r01, r02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    r10, r11, r12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    r20, r21, r22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]

    # 4*w^2, 4*x^2, 4*y^2, 4*z^2 (before normalization).
    tw = 1.0 + r00 + r11 + r22
    tx = 1.0 + r00 - r11 - r22
    ty = 1.0 - r00 + r11 - r22
    tz = 1.0 - r00 - r11 + r22

    # Candidate quaternions, each valid when its pivot is the largest.
    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, 1e-30))

    sw = safe_sqrt(tw)  # 2w
    sx = safe_sqrt(tx)  # 2x
    sy = safe_sqrt(ty)  # 2y
    sz = safe_sqrt(tz)  # 2z

    # Pivot w:
    qw = jnp.stack([(r21 - r12) / sw, (r02 - r20) / sw, (r10 - r01) / sw, sw],
                   axis=-1)
    # Pivot x:
    qx = jnp.stack([sx, (r01 + r10) / sx, (r02 + r20) / sx, (r21 - r12) / sx],
                   axis=-1)
    # Pivot y:
    qy = jnp.stack([(r01 + r10) / sy, sy, (r12 + r21) / sy, (r02 - r20) / sy],
                   axis=-1)
    # Pivot z:
    qz = jnp.stack([(r02 + r20) / sz, (r12 + r21) / sz, sz, (r10 - r01) / sz],
                   axis=-1)

    t = jnp.stack([tw, tx, ty, tz], axis=-1)
    best = jnp.argmax(t, axis=-1)
    q = jnp.where((best == 0)[..., None], qw,
                  jnp.where((best == 1)[..., None], qx,
                            jnp.where((best == 2)[..., None], qy, qz)))
    q = 0.5 * q
    # Normalize (defends against slightly non-orthonormal inputs).
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_to_mat(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion (x, y, z, w) -> rotation matrix (..., 3, 3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rows = [
        jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1),
        jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1),
        jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def mat_log(r: jnp.ndarray) -> jnp.ndarray:
    """Logarithmic map of SO(3) from a rotation matrix: (...,3,3) -> (...,3)."""
    return quat_log(mat_to_quat(r))


def _sin_cos_coeffs(theta2: jnp.ndarray):
    """Shared coefficients a = sin(t)/t and b = (1-cos(t))/t^2, branchless.

    ``theta2`` is the squared angle.  Below EPSILON the Taylor expansions from
    the reference (math.rs:78-89) are used.
    """
    small = theta2 <= EPSILON
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(theta2_safe)
    s = jnp.sin(theta)
    c = jnp.cos(theta)
    theta4 = theta2 * theta2
    a = jnp.where(small, 1.0 - theta2 / 6.0 + theta4 / 120.0, s / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0 + theta4 / 720.0,
                  (1.0 - c) / theta2_safe)
    return a, b, small, theta2_safe


def right_jacobian(w: jnp.ndarray) -> jnp.ndarray:
    """Right Jacobian of the SO(3) log map, J_r = d log(R) / dR.

    ``w``: rotation vector (..., 3).  Returns (..., 3, 3).

        J_r = I + 1/2 [w]_x + e(theta) [w]_x^2
        e   = (b - 2c) / (2a),  a = sin(t)/t, b = (1-cos(t))/t^2,
                                c = (1 - a)/t^2

    Unlike the reference (math.rs:90, which evaluates (1-a)/t^2 unguarded and
    returns NaN at exactly theta = 0), ``c`` uses its own Taylor series below
    the threshold: c = 1/6 - t^2/120 + t^4/5040.  The two agree to O(1e-18)
    over the switch region.
    """
    theta2 = jnp.sum(w * w, axis=-1)
    a, b, small, theta2_safe = _sin_cos_coeffs(theta2)
    theta4 = theta2 * theta2
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0 + theta4 / 5040.0,
                  (1.0 - a) / theta2_safe)
    e = (b - 2.0 * c) / (2.0 * a)

    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), w.shape[:-1] + (3, 3))
    return eye + 0.5 * hat(w) + e[..., None, None] * hat2(w)


def rodrigues(axis: jnp.ndarray, angle: jnp.ndarray) -> jnp.ndarray:
    """Axis-angle exponential map (unit axis): (...,3), (...) -> (...,3,3).

        R = I + sin(q) [k]_x + (1 - cos(q)) [k]_x^2

    The axis is a *static unit vector* per joint, so no small-angle handling
    is needed (sin/cos are exact for every q).
    """
    s = jnp.sin(angle)[..., None, None]
    c1 = (1.0 - jnp.cos(angle))[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=axis.dtype),
                           axis.shape[:-1] + (3, 3))
    return eye + s * hat(axis) + c1 * hat2(axis)
