"""Batched forward kinematics and geometric Jacobian.

Batched rework of the reference's runtime kinematics
(kylc/optik crates/optik/src/kinematics.rs:116-196):

  * the joint scan (kinematics.rs:142-158) becomes a ``lax.scan`` over the
    static per-joint arrays of a :class:`ChainParams`, with the revolute /
    prismatic choice made branchlessly through the prismatic mask — a
    revolute joint contributes ``(Rodrigues(axis, q), 0)``, a prismatic one
    ``(I, axis * q)``, and both cases are the single expression
    ``(Rodrigues(axis, q * (1-m)), axis * (q * m))``;
  * every function takes arbitrary leading batch dimensions on ``q`` via
    ``jax.vmap`` at the call site — there is no runtime allocation, no
    in-place variant (the reference's ``forward_kinematics_mut``
    re-allocation trick is meaningless under XLA);
  * the Jacobian (kinematics.rs:166-196) is evaluated for all joints at once
    with einsums instead of a per-column loop, in the EE (body) frame like
    the reference, and implements the prismatic column the reference left as
    a ``todo!()`` panic (kinematics.rs:185): linear = R_wj @ axis, angular = 0.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..math import se3, so3


class ChainParams(NamedTuple):
    """Device-resident chain constants (see models/chain.py for semantics)."""

    origin_r: jnp.ndarray   # (A, 3, 3)
    origin_t: jnp.ndarray   # (A, 3)
    axis: jnp.ndarray       # (A, 3)
    prismatic: jnp.ndarray  # (A,)
    lower: jnp.ndarray      # (A,)
    upper: jnp.ndarray      # (A,)
    tip_r: jnp.ndarray      # (3, 3)
    tip_t: jnp.ndarray      # (3,)

    @staticmethod
    def from_spec(spec, dtype=jnp.float32) -> "ChainParams":
        cast = lambda a: jnp.asarray(np.asarray(a), dtype=dtype)
        return ChainParams(
            origin_r=cast(spec.origin_r),
            origin_t=cast(spec.origin_t),
            axis=cast(spec.axis),
            prismatic=cast(spec.prismatic),
            lower=cast(spec.lower),
            upper=cast(spec.upper),
            tip_r=cast(spec.tip_r),
            tip_t=cast(spec.tip_t),
        )

    @property
    def num_positions(self) -> int:
        return self.axis.shape[0]


def fk_joints(params: ChainParams, q: jnp.ndarray):
    """World transforms of every joint frame for a single configuration.

    ``q``: (A,).  Returns ``(rs, ts)`` with shapes (A, 3, 3) and (A, 3) —
    the running products T_i = prod_{j<=i} origin_j * local_j(q_j), i.e. the
    reference's ``ForwardKinematics::joint_tfms`` (kinematics.rs:142-158).
    """
    dtype = q.dtype

    def step(carry, inp):
        r_prev, t_prev = carry
        o_r, o_t, axis, pris, qj = inp
        angle = qj * (1.0 - pris)
        slide = qj * pris
        r_local = so3.rodrigues(axis, angle)
        t_local = axis * slide
        # origin * local, then accumulate: T = T_prev * origin * local.
        r_ol = o_r @ r_local
        t_ol = o_r @ t_local + o_t
        r = r_prev @ r_ol
        t = r_prev @ t_ol + t_prev
        return (r, t), (r, t)

    init = (jnp.eye(3, dtype=dtype), jnp.zeros(3, dtype=dtype))
    xs = (params.origin_r, params.origin_t, params.axis, params.prismatic, q)
    _, (rs, ts) = jax.lax.scan(step, init, xs)
    return rs, ts


def fk_ee(params: ChainParams, q: jnp.ndarray, ee_r=None, ee_t=None):
    """End-effector pose: last joint frame * tip * ee_offset.

    Returns ``(r, t)``.  ``ee_r``/``ee_t`` (the caller's optional EE offset,
    kinematics.rs:163) default to identity.
    """
    rs, ts = fk_joints(params, q)
    r, t = se3.compose(rs[-1], ts[-1], params.tip_r, params.tip_t)
    if ee_r is not None:
        r, t = se3.compose(r, t, ee_r, ee_t)
    return r, t


def joint_jacobian_from_fk(params: ChainParams, rs, ts, ee_r, ee_t):
    """Geometric Jacobian in the EE (local/body) frame, (6, A).

    Row layout ``[linear; angular]`` matching the reference
    (kinematics.rs:166-196).  For joint i with world frame (R_i, p_i):

      revolute:  angular_w = R_i axis,  linear_w = angular_w x (p_ee - p_i)
      prismatic: angular_w = 0,         linear_w = R_i axis

    then both are rotated into the EE frame by R_ee^T.
    """
    dir_w = jnp.einsum("aij,aj->ai", rs, params.axis)          # (A, 3)
    m = params.prismatic[:, None]
    ang_w = dir_w * (1.0 - m)
    lin_rev = jnp.cross(dir_w, ee_t[None, :] - ts)
    lin_w = jnp.where(m > 0.5, dir_w, lin_rev)
    # R_ee^T v for each row v  ==  v @ R_ee.
    ang_l = ang_w @ ee_r
    lin_l = lin_w @ ee_r
    return jnp.concatenate([lin_l.T, ang_l.T], axis=0)          # (6, A)


def fk_and_jacobian(params: ChainParams, q: jnp.ndarray, ee_r=None, ee_t=None):
    """Fused FK + local-frame Jacobian sharing intermediates.

    Mirrors the reference's shared-FK optimization (lib.rs:313-336): one
    joint scan feeds both the EE pose and the Jacobian.
    Returns ``(ee_r, ee_t, J)`` with J of shape (6, A).
    """
    rs, ts = fk_joints(params, q)
    r, t = se3.compose(rs[-1], ts[-1], params.tip_r, params.tip_t)
    if ee_r is not None:
        r, t = se3.compose(r, t, ee_r, ee_t)
    jac = joint_jacobian_from_fk(params, rs, ts, r, t)
    return r, t, jac


def joint_jacobian(params: ChainParams, q: jnp.ndarray, ee_r=None, ee_t=None):
    """Convenience: Jacobian only, (6, A)."""
    return fk_and_jacobian(params, q, ee_r, ee_t)[2]
