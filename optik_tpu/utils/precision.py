"""Matmul precision control.

On the GPU, XLA may run a float32 contraction in TF32, which keeps about
three decimal digits.  The IK pipeline chains 7+ small rotation products per
FK and feeds the result into a 1e-6 tolerance check, so TF32 contraction
noise (~1e-3) would destroy convergence.  The contractions here are tiny
3x3/6x6 ops far from the tensor-core regime, so full float32 precision costs
little — every public jitted entry point traces under this context, and
tests/test_precision.py checks the lowered programs.
"""

from __future__ import annotations

import functools

import jax


def with_f32_matmuls(fn):
    """Decorator: trace ``fn`` (and its ``lower``) at HIGHEST precision."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    def lower(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn.lower(*args, **kwargs)

    wrapped.lower = lower
    return wrapped
