"""Matmul-precision control for geometry kernels.

On the GPU, float32 matmuls/einsums default to TF32 tensor-core products
(about 10 mantissa bits, roughly 3 decimal digits). That is the right
trade for descriptor matching and image convolutions, but wrong for the
geometry stack: normal equations, SE(3) chains, Schur complements and
covariance inverses amplify a 3-digit product into meter-level trajectory
error.

``@full_precision`` pins jnp.dot/einsum/conv inside the decorated function
to ``Precision.HIGHEST`` (true float32 products; ``"float32"`` in
``jax.default_matmul_precision``). Applied to every geometry solver; the
feature/matching path deliberately stays on the fast reduced-precision
path.
"""

from __future__ import annotations

import functools

import jax


def full_precision(fn):
    """Decorator: run ``fn`` under float32 matmul precision."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)

    return wrapped
