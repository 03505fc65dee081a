"""Batched RANSAC-PnP pose estimation.

Replaces the reference's sequential RANSAC loop
(final_project/algorithms/ransac.py:70-204): where the reference draws one
4-point sample per Python iteration and calls C++ ``cv2.solvePnP`` each time
(adaptive iteration count, ransac.py:59-67), here a fixed budget of
hypotheses is solved *simultaneously* by the vmapped EPnP kernel and scored
with one batched reprojection test. The fixed budget (default 512) exceeds
the reference's worst-case adaptive count for its success probability of
1-1e-10 at ~45% outliers (~240 iterations), so the statistical guarantee is
preserved while every step is static-shaped and jit-compiled.

The agreement test mirrors reference ``transformation_agreement``
(ransac.py:28-56): a candidate pose accepts a correspondence if the
reprojection into BOTH rectified stereo views is within ``threshold`` pixels
in x and y.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import epnp, se3, stereo
from .precision import full_precision

DEFAULT_THRESHOLD = 2.0  # px, reference ransac.py:44-54
DEFAULT_HYPOTHESES = 512
# Minimal set is 3: hypotheses come from 3D-3D alignment of stereo
# triangulations (both frames carry metric depth), not 4-point EPnP — a
# smaller minimal set needs fewer hypotheses for the same confidence
# (0.55^3 vs 0.55^4 inlier-set probability at the reference's assumed
# worst-case outlier rate).
MIN_SET = 3


def stereo_agreement(
    T_w2c: jnp.ndarray,
    pw: jnp.ndarray,
    meas: jnp.ndarray,
    valid: jnp.ndarray,
    calib: jnp.ndarray,
    threshold: float = DEFAULT_THRESHOLD,
) -> jnp.ndarray:
    """Inlier mask (N,) for pose T against stereo measurements (uL, uR, v).

    Checks |d_uL|, |d_uR|, |d_v| < threshold and positive depth, combining
    the reference's left+right x/y checks (ransac.py:44-54).
    """
    pc = se3.transform_points(T_w2c, pw)
    pred = stereo.project(calib, pc)
    err = jnp.abs(pred - meas)
    ok = (err < threshold).all(axis=-1) & (pc[..., 2] > 0.0)
    return ok & valid


def _sample_hypotheses(key, valid, num_hypotheses):
    """(H, 4) index sets, sampled without replacement from valid entries.

    Gumbel-top-k trick: per hypothesis add iid Gumbel noise to the validity
    logits and take the top-4 — uniform without-replacement sampling with a
    fully static shape.
    """
    n = valid.shape[0]
    logits = jnp.where(valid, 0.0, -jnp.inf)
    g = jax.random.gumbel(key, (num_hypotheses, n))
    _, idx = jax.lax.top_k(logits[None, :] + g, MIN_SET)
    return idx


@partial(jax.jit, static_argnames=("num_hypotheses", "refine_iters"))
@full_precision
def ransac_pnp(
    key: jax.Array,
    pw: jnp.ndarray,
    meas: jnp.ndarray,
    valid: jnp.ndarray,
    calib: jnp.ndarray,
    num_hypotheses: int = DEFAULT_HYPOTHESES,
    threshold: float = DEFAULT_THRESHOLD,
    refine_iters: int = 5,
):
    """Robust pose from N (padded, masked) 3D<->stereo correspondences.

    Args:
      key:   PRNG key (explicit — the reference uses unseeded np.random,
             ransac.py:95; we make stochasticity reproducible).
      pw:    (N, 3) world points (triangulated from the previous frame).
      meas:  (N, 3) stereo observations (uL, uR, v) in the current frame.
      valid: (N,) bool mask of real (non-padding) correspondences.
      calib: [fx, fy, cx, cy, baseline].

    Returns dict with:
      T_w2c:   (4, 4) refined pose (world -> current left camera).
      inliers: (N,) bool inlier mask (subset of ``valid``).
      num_inliers: scalar int.
      ok:      bool — enough valid points and a finite solution.
    """
    num_valid = jnp.sum(valid)
    ok_input = num_valid >= MIN_SET

    idx = _sample_hypotheses(key, valid, num_hypotheses)  # (H, 3)
    # Hypotheses: rigid 3D-3D alignment between world points and the
    # current frame's stereo backprojection (metric depth on both sides).
    # Minimal 3-point sets use the SVD-free triad construction instead of
    # a batched iterative 3x3 SVD (epnp.rigid_align_3pt docstring).
    pc_cur = stereo.backproject(calib, meas)  # (N, 3) current-camera frame
    Ts, oks = epnp.rigid_align_3pt_batched(pw[idx], pc_cur[idx])  # (H,4,4)

    inl = jax.vmap(
        lambda T: stereo_agreement(T, pw, meas, valid, calib, threshold)
    )(Ts)  # (H, N)
    scores = jnp.where(oks, jnp.sum(inl, axis=-1), -1)

    best = jnp.argmax(scores)
    T_best = Ts[best]
    inliers = inl[best]

    # Refine on all inliers (GN on stereo reprojection), then re-gate once —
    # mirrors the reference's final all-inlier re-solve (ransac.py:190-193).
    w = inliers.astype(pw.dtype)
    T_ref = epnp.refine_pose_gn(T_best, pw, meas, w, calib, iters=refine_iters)
    inliers2 = stereo_agreement(T_ref, pw, meas, valid, calib, threshold)
    # Second refinement pass on the re-gated set.
    T_ref2 = epnp.refine_pose_gn(
        T_ref, pw, meas, inliers2.astype(pw.dtype), calib, iters=refine_iters
    )
    inliers3 = stereo_agreement(T_ref2, pw, meas, valid, calib, threshold)

    improved = jnp.sum(inliers3) >= jnp.sum(inliers)
    T_out = jnp.where(improved, T_ref2, T_best)
    inl_out = jnp.where(improved, inliers3, inliers)

    ok = ok_input & jnp.isfinite(T_out).all() & (jnp.sum(inl_out) >= MIN_SET)
    T_out = jnp.where(ok, T_out, jnp.eye(4, dtype=pw.dtype))
    return {
        "T_w2c": T_out,
        "inliers": inl_out & ok,
        "num_inliers": jnp.sum(inl_out & ok),
        "ok": ok,
    }


# Batched over consecutive-frame pairs: keys (B,2), pw (B,N,3), meas (B,N,3),
# valid (B,N) -> pytree of batched results. The workhorse of the batched
# frontend (one RANSAC per frame pair, all pairs at once).
ransac_pnp_batched = jax.vmap(
    ransac_pnp, in_axes=(0, 0, 0, 0, None), out_axes=0
)
