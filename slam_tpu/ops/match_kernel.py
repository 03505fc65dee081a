"""Fused cross-check nearest-neighbour search for the GPU (Pallas, Triton
route).

The plain matcher (ops/matching.mutual_match) writes the (Ka, Kb) distance
matrix to device memory and reads it back for the row and the column
argmin. This kernel never stores it: each program owns ``BLOCK_Q`` query
rows, streams the candidate set through in ``BLOCK_C`` tiles, computes the
bf16 similarity tile on the tensor cores with float32 accumulation, adds
the validity and guided-window penalties, and keeps a running row minimum.
Two launches (A->B and B->A, the window mirrored) give exactly the
``crossCheck`` pair of argmins; only (K,) vectors reach device memory.

Distances follow ops/matching.py bit for bit in formula
(``where(valid, 2 - 2 a.b, BIG) + window``); only the summation order of
the 128-term dot product differs, so exact near-ties may resolve
differently.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

BLOCK_Q = 64
BLOCK_C = 128
BIG = 1e9  # matching.BIG


def _row_nn_kernel(q_ref, c_ref, vq_ref, vc_ref, xq_ref, yq_ref, xc_ref,
                   yc_ref, dist_ref, idx_ref, *, n_tiles, window):
    q = q_ref[...]
    vq = vq_ref[...] != 0
    xq = xq_ref[...]
    yq = yq_ref[...]

    def body(t, carry):
        best, arg = carry
        sl = pl.ds(t * BLOCK_C, BLOCK_C)
        sim = pl.dot(q, c_ref[sl, :], trans_b=True)       # (BQ, BC) f32
        ok = vq[:, None] & (vc_ref[sl] != 0)[None, :]
        d = jnp.where(ok, 2.0 - 2.0 * sim, BIG)
        if window is not None:
            lo, hi, dy_max = window
            dx = xc_ref[sl][None, :] - xq[:, None]
            dy = jnp.abs(yc_ref[sl][None, :] - yq[:, None])
            d = d + jnp.where((dx < lo) | (dx > hi) | (dy > dy_max), BIG, 0.0)
        tmin = jnp.min(d, axis=1)
        targ = jnp.argmin(d, axis=1).astype(jnp.int32) + t * BLOCK_C
        take = tmin < best
        return jnp.where(take, tmin, best), jnp.where(take, targ, arg)

    init = (jnp.full((BLOCK_Q,), jnp.inf, jnp.float32),
            jnp.zeros((BLOCK_Q,), jnp.int32))
    best, arg = jax.lax.fori_loop(0, n_tiles, body, init)
    dist_ref[...] = best
    idx_ref[...] = arg


def row_nearest(q, c, valid_q, valid_c, xy_q, xy_c, window=None,
                interpret: bool = False):
    """Row-wise argmin of the masked, windowed distance matrix without
    materializing it. Returns (dist (Kq,), idx (Kq,) int32)."""
    Kq, D = q.shape
    Kc = c.shape[0]
    if Kq % BLOCK_Q or Kc % BLOCK_C:
        raise ValueError(f"({Kq}, {Kc}) not multiples of "
                         f"({BLOCK_Q}, {BLOCK_C})")
    kernel = functools.partial(_row_nn_kernel, n_tiles=Kc // BLOCK_C,
                               window=window)
    rows = lambda i: (i,)
    whole = lambda i: (0,)
    return pl.pallas_call(
        kernel,
        grid=(Kq // BLOCK_Q,),
        in_specs=[
            pl.BlockSpec((BLOCK_Q, D), lambda i: (i, 0)),
            pl.BlockSpec((Kc, D), lambda i: (0, 0)),
            pl.BlockSpec((BLOCK_Q,), rows),
            pl.BlockSpec((Kc,), whole),
            pl.BlockSpec((BLOCK_Q,), rows),
            pl.BlockSpec((BLOCK_Q,), rows),
            pl.BlockSpec((Kc,), whole),
            pl.BlockSpec((Kc,), whole),
        ],
        out_specs=[pl.BlockSpec((BLOCK_Q,), rows),
                   pl.BlockSpec((BLOCK_Q,), rows)],
        out_shape=[jax.ShapeDtypeStruct((Kq,), jnp.float32),
                   jax.ShapeDtypeStruct((Kq,), jnp.int32)],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="row_nearest",
    )(q.astype(jnp.bfloat16), c.astype(jnp.bfloat16),
      valid_q.astype(jnp.int32), valid_c.astype(jnp.int32),
      xy_q[:, 0], xy_q[:, 1], xy_c[:, 0], xy_c[:, 1])


def mutual_nearest(desc_a, desc_b, valid_a, valid_b, xy_a=None, xy_b=None,
                   window=None, interpret: bool = False):
    """Both argmin directions of ops/matching.mutual_match's distance
    matrix: (row_dist (Ka,), row_idx (Ka,), col_idx (Kb,))."""
    if window is None:
        xy_a = jnp.zeros((desc_a.shape[0], 2), jnp.float32)
        xy_b = jnp.zeros((desc_b.shape[0], 2), jnp.float32)
        win_ab = win_ba = None
    else:
        lo, hi, dy_max = (float(v) for v in window)
        win_ab = (lo, hi, dy_max)
        # B->A sees dx' = x_a - x_b = -dx: the admissible band mirrors
        win_ba = (-hi, -lo, dy_max)
    xy_a = xy_a.astype(jnp.float32)
    xy_b = xy_b.astype(jnp.float32)
    rdist, ridx = row_nearest(desc_a, desc_b, valid_a, valid_b, xy_a, xy_b,
                              win_ab, interpret)
    _, cidx = row_nearest(desc_b, desc_a, valid_b, valid_a, xy_b, xy_a,
                          win_ba, interpret)
    return rdist, ridx, cidx


def _pow2_at_least(n: int, floor: int) -> bool:
    return n >= floor and n & (n - 1) == 0


def eligible(desc_a, desc_b) -> bool:
    """True where the kernel serves ``mutual_match``: on the GPU, with
    both feature budgets and the descriptor width powers of two no
    smaller than a tile (the Triton route takes power-of-two blocks
    only)."""
    tile = max(BLOCK_Q, BLOCK_C)
    return (jax.default_backend() == "gpu"
            and _pow2_at_least(desc_a.shape[0], tile)
            and _pow2_at_least(desc_b.shape[0], tile)
            and _pow2_at_least(desc_a.shape[-1], 16))
