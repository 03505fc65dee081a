"""Batched descriptor matching as matrix products.

Replaces ``cv2.BFMatcher(crossCheck=True).match`` (reference:
final_project/algorithms/matching.py:21-34, used at database.py:54-55 and
loop_closure.py:422) and the rectified-stereo inlier gate
(``extract_inliers_outliers``, matching.py:48-69).

Design: descriptors are L2-normalized float vectors, so the full pairwise
distance matrix is ``2 - 2 A @ B^T`` — one (K x D) @ (D x K) matmul in
bfloat16 with float32 accumulation per image pair, followed by row/col
argmin and the
mutual cross-check as elementwise masking. Everything is static-shape with
validity masks; invalid (padding) rows never win a match.

Match representation (SoA, replaces cv2.DMatch objects): for each *query*
row ``i``, ``target_idx[i]`` is the matched train row (or -1) and
``dist[i]`` the descriptor distance. This maps 1:1 onto the reference's
(queryIdx, trainIdx, distance) triple.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import match_kernel

BIG = jnp.float32(1e9)

# Stereo gate thresholds (reference matching.py:62-63): |dy| < 2 px and
# x_left > x_right + 2 (positive disparity margin).
STEREO_DY = 2.0
STEREO_MIN_DISP = 2.0


def distance_matrix(
    desc_a: jnp.ndarray,
    desc_b: jnp.ndarray,
    valid_a: jnp.ndarray,
    valid_b: jnp.ndarray,
) -> jnp.ndarray:
    """Squared-L2 distance matrix (Ka, Kb) with invalid entries set BIG.

    Descriptors are unit-norm, so d^2 = 2 - 2 a.b; computed via one bf16
    matmul with f32 accumulation.
    """
    sim = jax.lax.dot_general(
        desc_a.astype(jnp.bfloat16),
        desc_b.astype(jnp.bfloat16),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    d2 = 2.0 - 2.0 * sim
    mask = valid_a[:, None] & valid_b[None, :]
    return jnp.where(mask, d2, BIG)


def window_penalty(
    xy_a: jnp.ndarray,
    xy_b: jnp.ndarray,
    window: tuple[float, float, float] | None,
):
    """(Ka, Kb) additive penalty implementing a guided search window.

    ``window = (dx_min, dx_max, dy_max)``: candidate j is admissible for
    query i iff dx = x_b[j] - x_a[i] lies in [dx_min, dx_max] and
    |y_b[j] - y_a[i]| <= dy_max. Guided matching is standard VO practice
    the reference lacks (it brute-forces the full descriptor sets,
    matching.py:21-34); a window removes most descriptor ambiguity:
    stereo candidates live in the epipolar/disparity band, temporal
    candidates in the ego-motion window.
    """
    if window is None:
        return 0.0
    dx_min, dx_max, dy_max = window
    dx = xy_b[None, :, 0] - xy_a[:, None, 0]
    dy = jnp.abs(xy_b[None, :, 1] - xy_a[:, None, 1])
    bad = (dx < dx_min) | (dx > dx_max) | (dy > dy_max)
    return jnp.where(bad, BIG, 0.0)


def dense_mutual_nearest(desc_a, desc_b, valid_a, valid_b, xy_a=None,
                         xy_b=None, window=None):
    """Both argmin directions of the (Ka, Kb) masked, windowed distance
    matrix, materialized: (row_dist (Ka,), row_idx (Ka,), col_idx (Kb,)).
    The reference for ops/match_kernel.mutual_nearest."""
    d = distance_matrix(desc_a, desc_b, valid_a, valid_b)
    if window is not None:
        d = d + window_penalty(xy_a, xy_b, window)
    return (jnp.min(d, axis=1), jnp.argmin(d, axis=1).astype(jnp.int32),
            jnp.argmin(d, axis=0).astype(jnp.int32))


def mutual_match(
    desc_a: jnp.ndarray,
    desc_b: jnp.ndarray,
    valid_a: jnp.ndarray,
    valid_b: jnp.ndarray,
    max_dist: float = 1e8,
    xy_a: jnp.ndarray | None = None,
    xy_b: jnp.ndarray | None = None,
    window: tuple[float, float, float] | None = None,
):
    """Cross-checked nearest-neighbor matching A -> B.

    Equivalent to ``BFMatcher(crossCheck=True)``: a pair (i, j) is a match
    iff j = argmin_j d(i, j) AND i = argmin_i d(i, j). Optionally guided by
    a spatial search ``window`` (see :func:`window_penalty`).

    On the GPU with tile-aligned feature budgets this dispatches to the
    fused kernel (ops/match_kernel.py), which never stores the (K, K)
    distance matrix. The jnp path below is the CPU/odd-shape path and the
    numerical reference.

    Returns dict:
      target_idx: (Ka,) int32, matched row in B or -1.
      dist:       (Ka,) float32 distance (BIG where unmatched).
      matched:    (Ka,) bool.
    """
    nearest = (match_kernel.mutual_nearest
               if match_kernel.eligible(desc_a, desc_b)
               else dense_mutual_nearest)
    dist, best_b, best_a = nearest(desc_a, desc_b, valid_a, valid_b,
                                   xy_a, xy_b, window)
    mutual = best_a[best_b] == jnp.arange(desc_a.shape[0])
    matched = mutual & valid_a & (dist < max_dist)
    target_idx = jnp.where(matched, best_b, -1)
    return {
        "target_idx": target_idx.astype(jnp.int32),
        "dist": jnp.where(matched, dist, BIG),
        "matched": matched,
    }


def ratio_match(
    desc_a, desc_b, valid_a, valid_b, ratio: float = 0.8, max_dist: float = 1e8
):
    """Lowe ratio-test matching (reference ex1.py:118-122 lineage).

    A match survives if best < ratio^2 * second_best (squared distances).
    """
    d = distance_matrix(desc_a, desc_b, valid_a, valid_b)
    neg = -d
    top2, idx2 = jax.lax.top_k(neg, 2)  # top2[:,0] = -best
    best = -top2[:, 0]
    second = -top2[:, 1]
    passed = (best < ratio * ratio * second) & valid_a & (best < max_dist)
    target_idx = jnp.where(passed, idx2[:, 0], -1)
    return {
        "target_idx": target_idx.astype(jnp.int32),
        "dist": jnp.where(passed, best, BIG),
        "matched": passed,
    }


def stereo_gate(
    xy_left: jnp.ndarray,
    xy_right: jnp.ndarray,
    match: dict,
    dy_thresh: float = STEREO_DY,
    min_disp: float = STEREO_MIN_DISP,
):
    """Rectified-stereo consistency gate on L->R matches.

    Keeps matches with |y_l - y_r| < dy_thresh and x_l > x_r + min_disp
    (reference extract_inliers_outliers, matching.py:62-63).

    Returns the match dict with ``matched`` tightened and a ``links`` array
    (Ka, 3) = (x_left, x_right, (y_l + y_r)/2) in the reference's Link
    layout (tracking_database.py:243).
    """
    tgt = jnp.clip(match["target_idx"], 0, xy_right.shape[0] - 1)
    xr = xy_right[tgt]
    xl = xy_left
    ok = (
        match["matched"]
        & (jnp.abs(xl[:, 1] - xr[:, 1]) < dy_thresh)
        & (xl[:, 0] > xr[:, 0] + min_disp)
    )
    y = 0.5 * (xl[:, 1] + xr[:, 1])
    links = jnp.stack([xl[:, 0], xr[:, 0], y], axis=-1)
    return {
        "target_idx": jnp.where(ok, match["target_idx"], -1),
        "dist": jnp.where(ok, match["dist"], BIG),
        "matched": ok,
        "links": links,
    }


def match_stereo_pair(left: dict, right: dict,
                      window: tuple[float, float, float] | None = None,
                      max_dist: float = 1e8):
    """Full stereo-frame association: mutual NN + rectified gate.

    ``left``/``right`` are feature dicts from ``features.detect_and_describe``
    (xy, desc, valid). ``window`` optionally restricts candidates to the
    disparity band (guided matching); ``max_dist`` is the descriptor
    distance cutoff. Returns the gated match dict (incl. links).
    """
    m = mutual_match(left["desc"], right["desc"], left["valid"],
                     right["valid"], max_dist=max_dist,
                     xy_a=left["xy"], xy_b=right["xy"], window=window)
    return stereo_gate(left["xy"], right["xy"], m)


# Batched over frames: feature pytrees with leading batch dim.
def match_stereo_pair_batched(left, right, window=None, max_dist=1e8):
    return jax.vmap(
        lambda l, r: match_stereo_pair(l, r, window, max_dist)
    )(left, right)


def mutual_match_batched(desc_a, desc_b, valid_a, valid_b,
                         xy_a=None, xy_b=None, window=None, max_dist=1e8):
    if window is None:
        return jax.vmap(
            lambda da, db, va, vb: mutual_match(da, db, va, vb,
                                                max_dist=max_dist)
        )(desc_a, desc_b, valid_a, valid_b)
    return jax.vmap(
        lambda da, db, va, vb, xa, xb: mutual_match(
            da, db, va, vb, max_dist=max_dist, xy_a=xa, xy_b=xb,
            window=window
        )
    )(desc_a, desc_b, valid_a, valid_b, xy_a, xy_b)
