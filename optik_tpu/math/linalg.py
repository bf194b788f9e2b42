"""Unrolled small-matrix linear algebra for batched lanes.

XLA's generic ``lax.linalg.cholesky`` / ``triangular_solve`` lower to
loop-based kernels that serialize for tiny matrices.  The LM step only ever
solves a 6x6 SPD system per lane, so the factorization and both
substitutions are fully unrolled here into scalar jnp ops on (...,) slices
— pure element-wise work that vectorizes across lanes, with no
data-dependent control flow.
"""

from __future__ import annotations

import jax.numpy as jnp


def cholesky_solve(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve ``a x = b`` for SPD ``a``: (..., n, n), (..., n) -> (..., n).

    Fully unrolled Cholesky (n is static and small, e.g. 6).  No pivoting;
    the caller guarantees SPD (LM adds a positive damping term).
    """
    n = a.shape[-1]
    # Factor: a = L L^T, L lower-triangular, computed column by column.
    l = [[None] * n for _ in range(n)]
    for j in range(n):
        s = a[..., j, j]
        for k in range(j):
            s = s - l[j][k] * l[j][k]
        # Guard against round-off making the pivot non-positive; damping in
        # the caller keeps true pivots well away from zero.
        inv_d = jnp.sqrt(jnp.maximum(s, 1e-30)) ** -1.0
        l[j][j] = inv_d  # store the *inverse* diagonal to trade divs for muls
        for i in range(j + 1, n):
            s = a[..., i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            l[i][j] = s * inv_d

    # Forward substitution: L y = b.
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s * l[i][i]

    # Back substitution: L^T x = y.
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s * l[i][i]

    return jnp.stack(x, axis=-1)
