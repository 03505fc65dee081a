"""Batched EPnP perspective-n-point solver in pure JAX.

Replaces ``cv2.solvePnP(flags=SOLVEPNP_EPNP)`` (reference:
final_project/algorithms/ransac.py:98,162,190, backend/GTSam/bundle.py:68,
backend/GTSam/gtsam_utils.py:133). Where the reference calls a C++ solver
once per RANSAC hypothesis in a Python loop, this implementation is fully
vmappable: thousands of 4-point hypotheses become one batched kernel
(two small eigendecompositions per hypothesis: 3x3 and 12x12).

Algorithm: Lepetit et al., "EPnP: An Accurate O(n) Solution to the PnP
Problem" — control-point barycentric formulation, single-beta (N=1) case,
followed by Umeyama/Procrustes alignment. For accuracy the caller should
follow up with :func:`refine_pose_gn` on all inliers (the reference likewise
re-solves on the full inlier set, ransac.py:190-193).

Convention: returns extrinsics ``T_w2c`` (world -> camera), the same object
``cv2.solvePnP`` returns as (rvec, tvec).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import se3, stereo
from .precision import full_precision


def _control_points(pw: jnp.ndarray) -> jnp.ndarray:
    """World control points (4, 3): centroid + scaled principal axes."""
    c0 = jnp.mean(pw, axis=0)
    A = pw - c0
    n = pw.shape[0]
    cov = (A.T @ A) / n
    lam, V = jnp.linalg.eigh(cov + 1e-12 * jnp.eye(3, dtype=pw.dtype))
    # scale axes by sqrt of variance; guard tiny eigenvalues (planar/degenerate)
    s = jnp.sqrt(jnp.maximum(lam, 1e-8))
    cs = c0 + (V * s[None, :]).T  # rows: c0 + s_k * v_k
    return jnp.concatenate([c0[None, :], cs], axis=0)


def _barycentric(pw: jnp.ndarray, ctrl: jnp.ndarray) -> jnp.ndarray:
    """Barycentric coordinates (N, 4) of pw w.r.t. 4 control points."""
    B = (ctrl[1:] - ctrl[0]).T  # 3x3, columns = basis vectors
    Binv = jnp.linalg.inv(B + 1e-12 * jnp.eye(3, dtype=pw.dtype))
    a123 = (pw - ctrl[0]) @ Binv.T  # (N, 3)
    a0 = 1.0 - jnp.sum(a123, axis=-1, keepdims=True)
    return jnp.concatenate([a0, a123], axis=-1)


@full_precision
def solve_pnp_epnp(
    pw: jnp.ndarray, pix: jnp.ndarray, calib: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Solve PnP from N>=4 world<->pixel correspondences.

    Args:
      pw:   (N, 3) world points.
      pix:  (N, 2) pixel observations in the left camera.
      calib: flat [fx, fy, cx, cy, b] vector (b unused here).

    Returns:
      (T_w2c 4x4, ok flag). ``ok`` is False for degenerate geometry; the
      returned T is still finite (identity-ish fallback) so downstream
      masked pipelines never see NaNs.
    """
    fx, fy, cx, cy = calib[0], calib[1], calib[2], calib[3]
    n = pw.shape[0]

    ctrl_w = _control_points(pw)  # (4, 3)
    alphas = _barycentric(pw, ctrl_w)  # (N, 4)

    u, v = pix[..., 0], pix[..., 1]
    # M rows: for point i, two rows over 12 unknowns (4 ctrl pts x 3 coords):
    #   sum_j a_ij * (fx * cx_j            + (cx - u_i) * cz_j) = 0
    #   sum_j a_ij * (        fy * cy_j    + (cy - v_i) * cz_j) = 0
    zeros = jnp.zeros_like(alphas)
    row_u = jnp.stack(
        [alphas * fx, zeros, alphas * (cx - u)[:, None]], axis=-1
    ).reshape(n, 12)
    row_v = jnp.stack(
        [zeros, alphas * fy, alphas * (cy - v)[:, None]], axis=-1
    ).reshape(n, 12)
    M = jnp.concatenate([row_u, row_v], axis=0)  # (2N, 12)

    MtM = M.T @ M
    _, V = jnp.linalg.eigh(MtM)
    vker = V[:, 0]  # smallest-eigenvalue eigenvector
    ctrl_c = vker.reshape(4, 3)  # camera control points up to scale/sign

    # Scale: match pairwise control-point distances (6 pairs).
    ii, jj = jnp.triu_indices(4, k=1)
    dw = jnp.linalg.norm(ctrl_w[ii] - ctrl_w[jj], axis=-1)
    dc = jnp.linalg.norm(ctrl_c[ii] - ctrl_c[jj], axis=-1)
    denom = jnp.sum(dc * dc)
    beta = jnp.sum(dc * dw) / jnp.where(denom < 1e-12, 1.0, denom)
    ctrl_c = ctrl_c * beta

    # Camera-frame points; fix sign so mean depth is positive.
    pc = alphas @ ctrl_c  # (N, 3)
    sign = jnp.where(jnp.mean(pc[:, 2]) < 0.0, -1.0, 1.0)
    pc = pc * sign

    # Procrustes: R, t with pc ~= R @ pw + t.
    wbar = jnp.mean(pw, axis=0)
    cbar = jnp.mean(pc, axis=0)
    H = (pw - wbar).T @ (pc - cbar)  # 3x3
    U, S, Vt = jnp.linalg.svd(H)
    d = jnp.linalg.det(Vt.T @ U.T)
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0], dtype=pw.dtype)).at[2, 2].set(d)
    R = Vt.T @ D @ U.T
    t = cbar - R @ wbar

    ok = jnp.isfinite(R).all() & jnp.isfinite(t).all() & (denom > 1e-12)
    eye = jnp.eye(3, dtype=pw.dtype)
    R = jnp.where(ok, R, eye)
    t = jnp.where(ok, t, jnp.zeros_like(t))
    return se3.make_T(R, t), ok


# vmapped variant over a batch of hypotheses: (H, N, 3), (H, N, 2) -> (H,4,4)
solve_pnp_epnp_batched = jax.vmap(solve_pnp_epnp, in_axes=(0, 0, None))

# NOTE: the single-beta EPnP above needs n >= 6 for a generically
# one-dimensional nullspace. For *minimal* RANSAC hypotheses this framework
# uses 3-point 3D-3D alignment instead (:func:`rigid_align`) — both frames
# of a stereo pair have metric 3D, so hypothesis generation does not need
# PnP at all, and the smaller minimal set (3 vs 4) needs fewer hypotheses
# for the same confidence. EPnP remains the n>=6 re-solve / external API.


@full_precision
def rigid_align(
    pa: jnp.ndarray, pb: jnp.ndarray, w: jnp.ndarray | None = None
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Weighted closed-form rigid alignment: find T with pb ~= T * pa.

    Kabsch/Umeyama without scale. Used for minimal-set hypothesis generation
    in RANSAC (3 stereo-triangulated point pairs) and for loop-closure
    relative-pose seeds.

    Args:
      pa: (N, 3) source points, pb: (N, 3) target points, w: (N,) weights.

    Returns:
      (T 4x4, ok flag).
    """
    if w is None:
        w = jnp.ones(pa.shape[0], dtype=pa.dtype)
    wsum = jnp.sum(w) + 1e-12
    abar = jnp.sum(pa * w[:, None], axis=0) / wsum
    bbar = jnp.sum(pb * w[:, None], axis=0) / wsum
    A = (pa - abar) * w[:, None]
    B = pb - bbar
    H = A.T @ B  # 3x3 cross-covariance
    U, S, Vt = jnp.linalg.svd(H)
    d = jnp.linalg.det(Vt.T @ U.T)
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0], dtype=pa.dtype)).at[2, 2].set(d)
    R = Vt.T @ D @ U.T
    t = bbar - R @ abar
    # degenerate if points are (near-)collinear: two tiny singular values
    ok = jnp.isfinite(R).all() & (S[1] > 1e-6 * (S[0] + 1e-12))
    R = jnp.where(ok, R, jnp.eye(3, dtype=pa.dtype))
    t = jnp.where(ok, t, jnp.zeros_like(t))
    return se3.make_T(R, t), ok


rigid_align_batched = jax.vmap(rigid_align, in_axes=(0, 0, None))


def rigid_align_3pt(pa: jnp.ndarray, pb: jnp.ndarray):
    """SVD-free rigid alignment for a MINIMAL 3-point set.

    Builds an orthonormal triad from each triple and composes
    R = B A^T — exact for consistent correspondences (the minimal-set
    case RANSAC hypothesis generation feeds it). jnp.linalg.svd on
    batches of 3x3s is an iterative solver per matrix, whose cost scales
    with the hypothesis count; the triad form is pure
    elementwise/cross-product arithmetic.

    Degenerate (collinear) triples return ok=False, like
    :func:`rigid_align`'s singular-value test.
    """

    def triad(p):
        u = p[1] - p[0]
        v = p[2] - p[0]
        c = jnp.cross(u, v)
        n_u = jnp.linalg.norm(u)
        n_c = jnp.linalg.norm(c)
        ok = (n_u > 1e-9) & (n_c > 1e-9 * jnp.maximum(n_u, 1e-9))
        e1 = u / jnp.maximum(n_u, 1e-12)
        e3 = c / jnp.maximum(n_c, 1e-12)
        e2 = jnp.cross(e3, e1)
        return jnp.stack([e1, e2, e3], axis=-1), ok  # columns

    A, ok_a = triad(pa)
    B, ok_b = triad(pb)
    R = B @ A.T
    abar = jnp.mean(pa, axis=0)
    bbar = jnp.mean(pb, axis=0)
    t = bbar - R @ abar
    ok = ok_a & ok_b & jnp.isfinite(R).all()
    R = jnp.where(ok, R, jnp.eye(3, dtype=pa.dtype))
    t = jnp.where(ok, t, jnp.zeros_like(t))
    return se3.make_T(R, t), ok


rigid_align_3pt_batched = jax.vmap(rigid_align_3pt)


@full_precision
def refine_pose_gn(
    T_w2c: jnp.ndarray,
    pw: jnp.ndarray,
    meas: jnp.ndarray,
    weights: jnp.ndarray,
    calib: jnp.ndarray,
    iters: int = 5,
) -> jnp.ndarray:
    """Gauss-Newton pose refinement on stereo reprojection residuals.

    Minimizes sum_i w_i * ||project(T, pw_i) - meas_i||^2 over T in SE(3),
    where meas is the stereo triplet (uL, uR, v). This replaces the
    reference's final all-inlier ``cv2.solvePnP`` re-solve
    (ransac.py:190-193) with a strictly more accurate local optimization.

    All shapes static; masked points get weight 0. Runs a fixed number of
    iterations (lax.fori_loop) — XLA-friendly, no data-dependent trips.
    """

    fx, fy, b = calib[0], calib[1], calib[4]

    def res_jac(T):
        """Residuals + analytic Jacobian w.r.t. the right perturbation
        T*exp([w, v]) (same derivation as ops/ba._jacobians)."""
        Xc = se3.transform_points(T, pw[None])[0]  # (N, 3)
        pred = stereo.project(calib, Xc)
        r = (pred - meas) * weights[:, None]
        x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
        iz = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        iz2 = iz * iz
        zero = jnp.zeros_like(x)
        Jproj = jnp.stack(
            [
                jnp.stack([fx * iz, zero, -fx * x * iz2], -1),
                jnp.stack([fx * iz, zero, -fx * (x - b) * iz2], -1),
                jnp.stack([zero, fy * iz, -fy * y * iz2], -1),
            ],
            axis=-2,
        )  # (N, 3, 3)
        R = T[:3, :3]
        JR = se3.mm33(Jproj, R)
        J_rot = -se3.mm33(JR, se3.hat(pw))
        J = jnp.concatenate([J_rot, JR], axis=-1)  # (N, 3, 6)
        return r, J * weights[:, None, None]

    # Carry (T, r, J, cost) across iterations: the accept test's cost at
    # T_new doubles as the next iteration's residual evaluation, so each
    # step runs res_jac once (the naive step + separate accept-residuals
    # evaluated the projection twice).
    # A rejected step leaves the carry unchanged, which reproduces the
    # previous behavior exactly (the same xi would be retried and rejected
    # again — i.e. the iteration has converged).
    def step(_, carry):
        T, r, J, cost = carry
        Jf = J.reshape(-1, 6)
        rf = r.reshape(-1)
        H = Jf.T @ Jf + 1e-6 * jnp.eye(6, dtype=T.dtype)
        g = Jf.T @ rf
        xi = -jnp.linalg.solve(H, g)
        T_new = se3.retract(T, xi)
        r_new, J_new = res_jac(T_new)
        cost_new = jnp.sum(r_new * r_new)
        better = (cost_new < cost) & jnp.isfinite(T_new).all()
        return (
            jnp.where(better, T_new, T),
            jnp.where(better, r_new, r),
            jnp.where(better, J_new, J),
            jnp.where(better, cost_new, cost),
        )

    r0, J0 = res_jac(T_w2c)
    cost0 = jnp.sum(r0 * r0)
    T_out, _, _, _ = jax.lax.fori_loop(
        0, iters, step, (T_w2c, r0, J0, cost0)
    )
    return T_out
