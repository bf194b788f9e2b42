"""SE(3) Lie-group math, batched and branchless.

The core of the IK objective: the SE(3) logarithmic map (giving the 6-vector
pose error) and its right Jacobian (giving the analytic gradient's chain-rule
factor).  A rigid transform is represented as a pair ``(r, t)`` where ``r`` is
a rotation matrix of shape (..., 3, 3) and ``t`` a translation of shape
(..., 3).  Twist vectors are ordered ``[linear; angular]`` to match the
reference (kylc/optik crates/optik/src/math.rs:123).

Behavioral parity targets (kylc/optik, crates/optik/src/math.rs):
  * ``log``              -> math.rs:107-124
  * ``right_jacobian_q`` -> math.rs:135-170 (the Q block, Pinocchio-style)
  * ``right_jacobian``   -> math.rs:191-203 ([[J, Q], [0, J]])

All singularity handling is branchless (see so3.py for the rationale); the
(1 - p)/theta^2 coefficient of V^{-1}, which the reference evaluates unguarded
(NaN at theta = 0), is replaced below the threshold by its Taylor series
1/12 + t^2/720 + t^4/30240, finite at the identity.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import so3
from .so3 import EPSILON


def log(r: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """SE(3) log map: rotation (...,3,3) + translation (...,3) -> twist (...,6).

    Returns ``[v; w]`` where ``w = log(R)`` and ``v = V(w)^{-1} t`` with

        V^{-1} = I - 1/2 [w]_x + (1 - p)/theta^2 [w]_x^2,
        p      = 1/2 theta sin(theta) / (1 - cos(theta)).
    """
    w = so3.mat_log(r)
    theta2 = jnp.sum(w * w, axis=-1)
    small = theta2 <= EPSILON * EPSILON  # reference guards on theta > EPSILON
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(theta2_safe)
    s = jnp.sin(theta)
    c = jnp.cos(theta)

    # coef = (1 - p) / theta^2 with p = (theta sin)/(2 (1 - cos)).
    coef_exact = (1.0 - 0.5 * theta * s / (1.0 - c)) / theta2_safe
    theta4 = theta2 * theta2
    coef_taylor = 1.0 / 12.0 + theta2 / 720.0 + theta4 / 30240.0
    coef = jnp.where(small, coef_taylor, coef_exact)

    v_inv = (
        jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), w.shape[:-1] + (3, 3))
        - 0.5 * so3.hat(w)
        + coef[..., None, None] * so3.hat2(w)
    )
    v = jnp.einsum("...ij,...j->...i", v_inv, t)
    return jnp.concatenate([v, w], axis=-1)


def right_jacobian_q(v: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Upper-right 3x3 block Q(v, w) of the SE(3) log right Jacobian.

    ``v``: translation (...,3); ``w``: rotation vector log(R) (...,3).
    Mirrors the Pinocchio-derived closed form used by the reference
    (math.rs:135-170):

        a = 1/t^2 - sin(t)/(2 t (1-cos t)),
        b = -2/t^4 + (1 + sin(t)/t) / (2 t^2 (1-cos t)),
        (Taylor below threshold: a = 1/12 + t^2/720, b = 1/360)
        d = <w, v>
        cvec = b d w - (t^2 b + 2 a) v
        C = 1/2 [v]_x + cvec w^T + a w v^T + d a I
        Q = C * J_r(w)
    """
    theta2 = jnp.sum(w * w, axis=-1)
    small = theta2 <= EPSILON
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(theta2_safe)
    theta4_safe = theta2_safe * theta2_safe
    s = jnp.sin(theta)
    c = jnp.cos(theta)

    s_t = s / theta
    inv_1mc = 1.0 / (2.0 * (1.0 - c))
    a_exact = 1.0 / theta2_safe - s_t * inv_1mc
    b_exact = -2.0 / theta4_safe + (1.0 + s_t) * inv_1mc / theta2_safe

    a_taylor = 1.0 / 12.0 + theta2 / 720.0
    b_taylor = jnp.full_like(theta2, 1.0 / 360.0)

    a = jnp.where(small, a_taylor, a_exact)
    b = jnp.where(small, b_taylor, b_exact)

    d = jnp.sum(w * v, axis=-1)
    cvec = (b * d)[..., None] * w - (theta2 * b + 2.0 * a)[..., None] * v

    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), w.shape[:-1] + (3, 3))
    C = (
        0.5 * so3.hat(v)
        + cvec[..., :, None] * w[..., None, :]
        + a[..., None, None] * v[..., None, :] * w[..., :, None]
        + (d * a)[..., None, None] * eye
    )
    E = so3.right_jacobian(w)
    return jnp.einsum("...ij,...jk->...ik", C, E)


def right_jacobian(r: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Right Jacobian of the SE(3) log map: (...,3,3), (...,3) -> (...,6,6).

        [[ J_r(w)  Q(t, w) ]
         [   0     J_r(w)  ]]
    """
    w = so3.mat_log(r)
    j = so3.right_jacobian(w)
    q = right_jacobian_q(t, w)
    zero = jnp.zeros_like(j)
    top = jnp.concatenate([j, q], axis=-1)
    bot = jnp.concatenate([zero, j], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


# --- Small transform helpers (used across FK / objective / solver) ---------


def compose(ra, ta, rb, tb):
    """(Ra, ta) * (Rb, tb) -> (Ra Rb, Ra tb + ta), batched."""
    r = jnp.einsum("...ij,...jk->...ik", ra, rb)
    t = jnp.einsum("...ij,...j->...i", ra, tb) + ta
    return r, t


def inv_compose(ra, ta, rb, tb):
    """(Ra, ta)^{-1} * (Rb, tb), batched (the target-frame error transform)."""
    r = jnp.einsum("...ji,...jk->...ik", ra, rb)
    t = jnp.einsum("...ji,...j->...i", ra, tb - ta)
    return r, t
