"""Batched dense QP solver: fixed-iteration ADMM (OSQP-style) with polish.

Replaces the reference's Clarabel interior-point dependency
(kylc/optik lib.rs:216-228) with a batched solver: every problem instance
is a lane, iterations are lockstep matvecs with *no* data-dependent control
flow, and the one factorization per instance is a small batched Cholesky.
Interior-point methods branch on line searches and converge in few-but-heavy
iterations; ADMM does many-but-trivial iterations — exactly the trade a
batch device wants for the tiny QPs of differential IK.

Problem form (OSQP convention):

    minimize    1/2 x^T P x + q^T x
    subject to  l <= A x <= u          (equality rows have l == u)

Algorithm (Stellato et al., "OSQP: An Operator Splitting Solver for
Quadratic Programs", fixed step-rho variant):

    x+ <- solve (P + sigma I + A^T R A) x = sigma x - q + A^T (R z - y)
    z~ <- A x+
    z+ <- clip(alpha z~ + (1-alpha) z + y / rho, l, u)
    y+ <- y + R (alpha z~ + (1-alpha) z - z+)

with per-row rho (R = diag(rho), rho boosted 1e3x on equality rows) and
over-relaxation alpha = 1.6.  A final *polish* solves the KKT system of the
active constraint set exactly (one batched LU), recovering interior-point
accuracy (~1e-10 residuals) from an approximate ADMM active set; lanes where
polish worsens feasibility keep the ADMM iterate.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class QPSolution(NamedTuple):
    x: jnp.ndarray          # (..., n) primal solution
    y: jnp.ndarray          # (..., m) dual solution
    primal_res: jnp.ndarray  # (...,) max |clip-violation of A x|
    dual_res: jnp.ndarray    # (...,) max |P x + q + A^T y|


def _solve_single(P, q, A, l, u, *, sigma, rho_base, rho_eq_scale, alpha,
                  iters, polish_reg, rho_interval=100):
    n = q.shape[0]
    m = l.shape[0]
    dtype = q.dtype

    is_eq = (u - l) <= 1e-12
    rho0 = jnp.where(is_eq, rho_base * rho_eq_scale, rho_base)

    eye_n = jnp.eye(n, dtype=dtype)

    def run_block(x, z, y, rho):
        """rho_interval lockstep iterations at a fixed rho (one factorization)."""
        K = P + sigma * eye_n + (A.T * rho) @ A
        chol = jax.lax.linalg.cholesky(K)

        def chol_solve(b):
            t = jax.lax.linalg.triangular_solve(chol, b[:, None],
                                                left_side=True, lower=True)
            s = jax.lax.linalg.triangular_solve(chol, t, left_side=True,
                                                lower=True, transpose_a=True)
            return s[:, 0]

        def body(_, carry):
            x, z, y = carry
            rhs = sigma * x - q + A.T @ (rho * z - y)
            x_new = chol_solve(rhs)
            z_tilde = A @ x_new
            z_relaxed = alpha * z_tilde + (1.0 - alpha) * z
            z_new = jnp.clip(z_relaxed + y / rho, l, u)
            y_new = y + rho * (z_relaxed - z_new)
            return x_new, z_new, y_new

        return jax.lax.fori_loop(0, rho_interval, body, (x, z, y))

    # Adaptive step size (OSQP sec. 5.2): every rho_interval iterations,
    # rescale rho by sqrt(relative primal residual / relative dual residual)
    # when they are imbalanced by >5x, and refactor.  Fixed-rho ADMM stalls
    # on poorly conditioned constraint blocks (small Jacobian singular
    # values); the rebalance restores linear convergence while keeping the
    # lockstep, data-independent iteration structure (the rho update is a
    # masked multiply, identical across lanes in trip count).
    def round_body(_, carry):
        x, z, y, rho_scale = carry
        x, z, y = run_block(x, z, y, rho0 * rho_scale)
        ax = A @ x
        tiny = jnp.asarray(1e-12, dtype)
        pr = jnp.max(jnp.abs(ax - z))
        pr_rel = pr / jnp.maximum(jnp.maximum(jnp.max(jnp.abs(ax)),
                                              jnp.max(jnp.abs(z))), tiny)
        dvec = P @ x + q + A.T @ y
        dr = jnp.max(jnp.abs(dvec))
        dr_rel = dr / jnp.maximum(
            jnp.maximum(jnp.max(jnp.abs(P @ x)),
                        jnp.maximum(jnp.max(jnp.abs(A.T @ y)),
                                    jnp.max(jnp.abs(q)))), tiny)
        scale = jnp.sqrt(pr_rel / jnp.maximum(dr_rel, tiny))
        scale = jnp.clip(scale, 1e-3, 1e3)
        apply = (scale > 5.0) | (scale < 0.2)
        rho_scale = jnp.where(apply, rho_scale * scale, rho_scale)
        return x, z, y, rho_scale

    x0 = jnp.zeros(n, dtype)
    z0 = jnp.clip(jnp.zeros(m, dtype), l, u)
    y0 = jnp.zeros(m, dtype)
    rounds = max(1, iters // rho_interval)
    x, z, y, _ = jax.lax.fori_loop(
        0, rounds, round_body, (x0, z0, y0, jnp.ones((), dtype)))

    def residuals(xv, yv):
        ax = A @ xv
        pr = jnp.max(jnp.maximum(ax - u, 0.0) + jnp.maximum(l - ax, 0.0))
        dr = jnp.max(jnp.abs(P @ xv + q + A.T @ yv))
        return pr, dr

    # --- polish: exact KKT solve on the detected active set ---------------
    # Iterated: the first pass detects actives tightly from the ADMM point;
    # a second pass re-detects from the (usually near-exact) polished point
    # with a looser tolerance, catching actives the ADMM iterate had not
    # quite pinned — this is what rescues lanes that stall a hair above the
    # success gate on flat (LP-like) objectives.  Each candidate is kept
    # only if it improves the summed residuals.
    def polish(xc, yc, tol):
        ax = A @ xc
        act_low = (~is_eq) & (ax - l <= tol * (1.0 + jnp.abs(l))) & (yc < 0)
        act_up = (~is_eq) & (u - ax <= tol * (1.0 + jnp.abs(u))) & (yc > 0)
        active = is_eq | act_low | act_up
        mask = active.astype(dtype)
        b_act = jnp.where(act_up, u, l)  # equality rows: l == u

        # Masked KKT: [P x + A^T M lam = -q ; M A x - (I - M) lam = M b].
        kkt = jnp.block([
            [P + polish_reg * jnp.eye(n, dtype=dtype), A.T * mask],
            [mask[:, None] * A,
             -jnp.diag(1.0 - mask) - polish_reg * jnp.eye(m, dtype=dtype)],
        ])
        rhs = jnp.concatenate([-q, mask * b_act])
        sol = jnp.linalg.solve(kkt, rhs)
        return sol[:n], sol[n:]

    x_out, y_out = x, y
    pr, dr = residuals(x, y)
    for tol in (1e-7, 1e-5, 1e-3):
        x_p, y_p = polish(x_out, y_out, tol)
        pr_pol, dr_pol = residuals(x_p, y_p)
        finite = jnp.all(jnp.isfinite(x_p))
        better = finite & (pr_pol + dr_pol < pr + dr)
        x_out = jnp.where(better, x_p, x_out)
        y_out = jnp.where(better, y_p, y_out)
        pr = jnp.where(better, pr_pol, pr)
        dr = jnp.where(better, dr_pol, dr)
    return QPSolution(x=x_out, y=y_out, primal_res=pr, dual_res=dr)


def solve(P, q, A, l, u, *, sigma=1e-6, rho=1.0, rho_eq_scale=1e3,
          alpha=1.6, iters=800, polish_reg=1e-11) -> QPSolution:
    """Solve a (batch of) dense QPs.

    Accepts arbitrary leading batch dimensions on every operand (they must
    agree); scalars-per-problem come back with the same leading dims.
    """
    fn = lambda P_, q_, A_, l_, u_: _solve_single(
        P_, q_, A_, l_, u_, sigma=sigma, rho_base=rho,
        rho_eq_scale=rho_eq_scale, alpha=alpha, iters=iters,
        polish_reg=polish_reg)
    batch_dims = q.ndim - 1
    for _ in range(batch_dims):
        fn = jax.vmap(fn)
    return fn(P, q, A, l, u)
