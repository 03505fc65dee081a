"""Batched linear least-squares stereo triangulation.

Replaces the reference's per-point SVD loop
(final_project/algorithms/triangulation.py:5-24, triangulate_links :41-50)
with a single vmapped 4x4 solve over all points — thousands of
triangulations become one batched kernel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .precision import full_precision


def _dlt_system(P: jnp.ndarray, Q: jnp.ndarray, xl: jnp.ndarray, xr: jnp.ndarray,
                yl: jnp.ndarray, yr: jnp.ndarray) -> jnp.ndarray:
    """Build the 4x4 DLT matrix for one correspondence.

    Rows: xl*P3-P1, yl*P3-P2, xr*Q3-Q1, yr*Q3-Q2 (the classic linear
    triangulation system, same construction as reference
    triangulation.py:12-19).
    """
    A = jnp.stack(
        [
            xl * P[2] - P[0],
            yl * P[2] - P[1],
            xr * Q[2] - Q[0],
            yr * Q[2] - Q[1],
        ],
        axis=0,
    )
    return A


@full_precision
def triangulate(
    P: jnp.ndarray,
    Q: jnp.ndarray,
    pts_left: jnp.ndarray,
    pts_right: jnp.ndarray,
) -> jnp.ndarray:
    """Triangulate N correspondences.

    Args:
      P, Q: 3x4 left/right projection matrices.
      pts_left:  (N, 2) pixel coordinates in the left image.
      pts_right: (N, 2) pixel coordinates in the right image.

    Returns:
      (N, 3) world points. Degenerate homogeneous solutions (w ~ 0) return
      the unscaled vector, matching the reference guard
      (triangulation.py:22-23).
    """
    def one(pl, pr):
        A = _dlt_system(P, Q, pl[0], pr[0], pl[1], pr[1])
        # Row-normalize for conditioning (pixel-scale rows otherwise dwarf
        # the homogeneous column in float32).
        A = A / (jnp.linalg.norm(A, axis=-1, keepdims=True) + 1e-12)
        # Smallest right singular vector of A == eigenvector of A^T A with
        # the smallest eigenvalue. eigh on 4x4 is cheap and batches well.
        _, V = jnp.linalg.eigh(A.T @ A)
        X = V[:, 0]
        w = X[3]
        safe_w = jnp.where(jnp.abs(w) < 1e-10, 1.0, w)
        return jnp.where(jnp.abs(w) < 1e-10, X[:3], X[:3] / safe_w)

    return jax.vmap(one)(pts_left, pts_right)


def triangulate_links(
    P: jnp.ndarray, Q: jnp.ndarray, links: jnp.ndarray
) -> jnp.ndarray:
    """Triangulate stereo links (N, 3) = (xl, xr, y) -> (N, 3) points.

    The reference shares y between left and right (rectified assumption,
    tracking_database.py:243), so both rows use the same y.
    """
    xl, xr, y = links[..., 0], links[..., 1], links[..., 2]
    pts_left = jnp.stack([xl, y], axis=-1)
    pts_right = jnp.stack([xr, y], axis=-1)
    return triangulate(P, Q, pts_left, pts_right)


def triangulate_rectified(calib: jnp.ndarray, links: jnp.ndarray) -> jnp.ndarray:
    """Closed-form disparity backprojection for rectified stereo.

    For an ideally rectified pair the DLT solution coincides with the
    disparity formula; this path avoids the eigendecomposition entirely
    (pure VPU arithmetic) and is the default in the frontend hot loop.
    ``links`` is (..., 3) = (xl, xr, y) in the *camera* frame of the left
    camera (i.e. extrinsics identity).
    """
    from . import stereo

    return stereo.backproject(calib, links)
