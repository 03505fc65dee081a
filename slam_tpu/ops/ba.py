"""Batched sparse bundle adjustment: Levenberg-Marquardt with Schur
complement, in pure JAX.

Replaces GTSAM's ``NonlinearFactorGraph`` + ``GenericStereoFactor3D`` +
``LevenbergMarquardtOptimizer`` + ``Marginals`` (reference:
final_project/backend/GTSam/bundle.py:82-211, pose_graph.py:7-24). Where the
reference optimizes ~430 keyframe windows one-by-one through a C++ LM, this
solver is written to be ``vmap``-ed over the *whole batch of windows at
once* and ``pjit``-sharded across devices.

Problem representation (static shapes; one "BA problem" = one window):
  poses    (P, 4, 4) extrinsics T_win2cam (window frame = first camera).
  points   (L, 3)    landmarks in the window frame.
  cam_idx  (M,) int32   observation -> pose row.
  lm_idx   (M,) int32   observation -> landmark row.
  meas     (M, 3)       stereo measurements (uL, uR, v).
  w        (M,)         observation weights (0 = padding; also used for
                        per-factor sigmas and depth pruning).
Each (pose, landmark) pair appears at most once (a track is seen once per
frame), which makes the Schur cross blocks a single scatter.

The gauge is fixed by freezing pose 0 (equivalent to the reference's tight
prior on the first window pose, bundle.py:100-103).

Covariance: :func:`last_pose_covariance` returns the 6x6 marginal of the
last pose in the window frame from the un-damped Gauss-Newton Schur matrix
— the same object the reference extracts via joint marginal information of
(first, last) conditioned on first (pose_graph.py:7-24).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import se3, stereo
from .precision import full_precision


# ---------------------------------------------------------------------------
# residuals and analytic Jacobians
# ---------------------------------------------------------------------------

# 3-wide contractions as explicit elementwise mult-adds: see se3.mv3 /
# se3.mm33 for why (a 3-wide dot_general becomes a padded micro-matmul).
_mv3 = se3.mv3
_mm33 = se3.mm33


def _outer3(Ja, Jb):
    """(..., 3, a), (..., 3, b) -> (..., a, b): sum_i Ja[i]^T Jb[i] over
    the 3 residual rows (einsum "mia,mib->mab"), as elementwise mult-adds."""
    return (Ja[..., 0, :, None] * Jb[..., 0, None, :]
            + Ja[..., 1, :, None] * Jb[..., 1, None, :]
            + Ja[..., 2, :, None] * Jb[..., 2, None, :])


def _jtr3(J, r):
    """(..., 3, a), (..., 3) -> (..., a): J^T r over the 3 residual rows
    (einsum "mij,mi->mj"), as elementwise mult-adds."""
    return (J[..., 0, :] * r[..., 0, None]
            + J[..., 1, :] * r[..., 1, None]
            + J[..., 2, :] * r[..., 2, None])


def _gather_obs(poses, points, cam_idx, lm_idx, onehots=None):
    """Per-observation (T (M,4,4), X (M,3)) lookup.

    With ``onehots`` the random-access gathers become one-hot matmuls —
    EXACT (one-hot entries are 0/1; one nonzero term per output row)."""
    if onehots is None:
        return poses[cam_idx], points[lm_idx]
    oc, ol = onehots
    P = poses.shape[0]
    T = (oc @ poses.reshape(P, 16)).reshape(-1, 4, 4)
    X = ol @ points
    return T, X


def _residuals_tx(T, X, meas, w, calib):
    """Weighted stereo reprojection residuals (M, 3) from pre-gathered
    per-observation poses/landmarks."""
    Xc = _mv3(T[:, :3, :3], X) + T[:, :3, 3]
    pred = stereo.project(calib, Xc)
    return (pred - meas) * w[:, None], Xc


def _residuals(poses, points, cam_idx, lm_idx, meas, w, calib,
               onehots=None):
    """Weighted stereo reprojection residuals (M, 3)."""
    T, X = _gather_obs(poses, points, cam_idx, lm_idx, onehots)
    return _residuals_tx(T, X, meas, w, calib)


def _jacobians_tx(T, X, w, calib, Xc):
    """Analytic per-observation Jacobians (from pre-gathered T, X).

    J_pose (M, 3, 6) w.r.t. the right-perturbation T*exp([w, v]) of the
    observing pose; J_lm (M, 3, 3) w.r.t. the landmark. Derivation:
      d(T exp(d) X)/dd = R @ [-hat(X) | I]   (d = [rot, trans])
      d(T (X+dX))/dX   = R
    with the stereo projection Jacobian chained on top.
    """
    fx, fy, _, _, b = (calib[i] for i in range(5))
    x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
    iz = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    iz2 = iz * iz
    zero = jnp.zeros_like(x)
    # d(uL,uR,v)/dXc : (M, 3, 3)
    Jproj = jnp.stack(
        [
            jnp.stack([fx * iz, zero, -fx * x * iz2], -1),
            jnp.stack([fx * iz, zero, -fx * (x - b) * iz2], -1),
            jnp.stack([zero, fy * iz, -fy * y * iz2], -1),
        ],
        axis=-2,
    )
    R = T[:, :3, :3]                        # (M, 3, 3)
    JR = _mm33(Jproj, R)                               # (M, 3, 3)
    J_lm = JR * w[:, None, None]
    J_rot = -_mm33(JR, se3.hat(X))                     # (M, 3, 3)
    J_pose = jnp.concatenate([J_rot, JR], axis=-1) * w[:, None, None]  # (M,3,6)
    return J_pose, J_lm


def _jacobians(poses, points, cam_idx, lm_idx, w, calib, Xc,
               onehots=None):
    T, X = _gather_obs(poses, points, cam_idx, lm_idx, onehots)
    return _jacobians_tx(T, X, w, calib, Xc)


# ---------------------------------------------------------------------------
# one damped normal-equations solve (Schur complement)
# ---------------------------------------------------------------------------

def _build_blocks_scatter(J_pose, J_lm, r, cam_idx, lm_idx, P, L):
    """Gradient/Hessian blocks via XLA scatter-add (.at[].add)."""
    dtype = J_pose.dtype
    g_p = jnp.zeros((P, 6), dtype).at[cam_idx].add(_jtr3(J_pose, r))
    g_l = jnp.zeros((L, 3), dtype).at[lm_idx].add(_jtr3(J_lm, r))
    Hpp = jnp.zeros((P, 6, 6), dtype).at[cam_idx].add(
        _outer3(J_pose, J_pose)
    )
    Hll = jnp.zeros((L, 3, 3), dtype).at[lm_idx].add(_outer3(J_lm, J_lm))
    # cross blocks: each (pose, landmark) pair has exactly one observation,
    # scattered into a dense (L, P, 6, 3) tensor — the Schur engine.
    Wc = jnp.zeros((L, P, 6, 3), dtype).at[lm_idx, cam_idx].add(
        _outer3(J_pose, J_lm)
    )
    return g_p, g_l, Hpp, Hll, Wc


def _build_blocks_onehot(J_pose, J_lm, r, oc, ol, P, L):
    """Gradient/Hessian blocks as ONE-HOT MATMUL contractions.

    The scatter-add reductions of _build_blocks_scatter written as matmuls
    against the (M, P) / (M, L) index one-hots: Hpp = oc^T @ (Jp (x) Jp),
    Hll = ol^T @ (Jl (x) Jl), and the cross block via an (M, P, 18) masked
    outer product contracted with ol^T (a (L, M) @ (M, P*18) matmul). The
    one-hots are built once per solve (indices are static across LM
    iterations).
    """
    g_p = oc.T @ _jtr3(J_pose, r)                                  # (P, 6)
    g_l = ol.T @ _jtr3(J_lm, r)                                    # (L, 3)
    opp = _outer3(J_pose, J_pose).reshape(-1, 36)
    Hpp = (oc.T @ opp).reshape(P, 6, 6)
    oll = _outer3(J_lm, J_lm).reshape(-1, 9)
    Hll = (ol.T @ oll).reshape(L, 3, 3)
    opl = _outer3(J_pose, J_lm).reshape(-1, 18)                    # (M, 18)
    z = oc[:, :, None] * opl[:, None, :]                            # (M, P, 18)
    Wc = (ol.T @ z.reshape(-1, P * 18)).reshape(L, P, 6, 3)
    return g_p, g_l, Hpp, Hll, Wc


def _bf16mm(a, b, passes: int = 1):
    """Reduced-precision matmul with float32 accumulation, bypassing the
    surrounding @full_precision float32 setting.

    passes=1: bf16 inputs, single pass (~4e-3 relative).
    passes=3: each f32 input split into a bf16 hi/lo pair and three bf16
      products summed in f32 (``BF16_BF16_F32_X3``: about 16 mantissa
      bits, between TF32 and f32). The algorithm is named explicitly:
      ``Precision.HIGH`` means TF32 (about 10 mantissa bits) on the GPU,
      not bf16x3."""
    if passes == 1:
        return jax.lax.dot(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                           precision=jax.lax.Precision.DEFAULT,
                           preferred_element_type=jnp.float32)
    return jax.lax.dot(a, b,
                       precision=jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
                       preferred_element_type=jnp.float32)


def _build_blocks_onehot_bf16(J_pose, J_lm, r, oc, ol, P, L,
                              passes: int = 1):
    """One-hot block build with the HESSIAN contractions at reduced matmul
    precision.

    Inexact-Newton split: the gradient (g_p, g_l) keeps full f32 matmul
    precision — it sets the optimum the iteration converges to — while
    Hpp/Hll/Wc take ``passes``-pass bf16 matmuls, which only perturbs the
    step DIRECTION (the f32 cost accept/reject in the LM driver guards
    every step).

    passes matters when the reduced pose system is ill-conditioned:
    cond(S) beyond ~1/eps_mm makes the step's weak-direction components
    garbage — the cost barely moves (those directions are flat) but the
    chained trajectory drifts. Measured on the 80-frame CLI loop scene:
    1-pass bf16 inflated keyframe ATE 0.139 -> 0.243 m while the median
    window cost changed <1% (low-parallax windows); 3-pass restored ATE
    parity at ~half the HIGHEST-precision block cost.
    """
    g_p = oc.T @ _jtr3(J_pose, r)                                  # (P, 6)
    g_l = ol.T @ _jtr3(J_lm, r)                                    # (L, 3)
    opp = _outer3(J_pose, J_pose).reshape(-1, 36)
    Hpp = _bf16mm(oc.T, opp, passes).reshape(P, 6, 6)
    oll = _outer3(J_lm, J_lm).reshape(-1, 9)
    Hll = _bf16mm(ol.T, oll, passes).reshape(L, 3, 3)
    if passes == 1:
        opl = _outer3(J_pose, J_lm).reshape(-1, 18).astype(jnp.bfloat16)
        z = oc.astype(jnp.bfloat16)[:, :, None] * opl[:, None, :]
        Wc = _bf16mm(ol.T.astype(jnp.bfloat16),
                     z.reshape(-1, P * 18), 1).reshape(L, P, 6, 3)
    else:
        opl = _outer3(J_pose, J_lm).reshape(-1, 18)
        z = oc[:, :, None] * opl[:, None, :]                # (M, P, 18)
        Wc = _bf16mm(ol.T, z.reshape(-1, P * 18),
                     passes).reshape(L, P, 6, 3)
    return g_p, g_l, Hpp, Hll, Wc


def _inv3x3(A):
    """Closed-form batched 3x3 inverse (adjugate/det) — avoids the general
    LU path for the (L,) landmark blocks."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    adj = jnp.stack([
        jnp.stack([co00, co01, co02], -1),
        jnp.stack([co10, co11, co12], -1),
        jnp.stack([co20, co21, co22], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def _schur_solve(J_pose, J_lm, r, cam_idx, lm_idx, P, L, lam,
                 onehots=None, mm_passes=0):
    """Solve the damped normal equations by landmark marginalization.

    Returns (delta_poses (P, 6), delta_points (L, 3)). Pose 0 is frozen.
    With ``onehots`` = (oc (M, P), ol (M, L)) the blocks are built by
    matmul contraction instead of scatter-add (see _build_blocks_onehot);
    ``mm_passes`` in (1, 3) additionally runs the Hessian contractions
    and the Schur reduction matmul at reduced precision (f32
    gradient — inexact Newton; see _build_blocks_onehot_bf16)."""
    dtype = J_pose.dtype
    if onehots is not None and mm_passes:
        g_p, g_l, Hpp, Hll, Wc = _build_blocks_onehot_bf16(
            J_pose, J_lm, r, onehots[0], onehots[1], P, L,
            passes=mm_passes)
    elif onehots is not None:
        g_p, g_l, Hpp, Hll, Wc = _build_blocks_onehot(
            J_pose, J_lm, r, onehots[0], onehots[1], P, L)
    else:
        g_p, g_l, Hpp, Hll, Wc = _build_blocks_scatter(
            J_pose, J_lm, r, cam_idx, lm_idx, P, L)

    # damp
    eyeP = jnp.eye(6, dtype=dtype)
    eyeL = jnp.eye(3, dtype=dtype)
    Hpp_d = Hpp + lam * eyeP[None]
    Hll_d = Hll + lam * eyeL[None] + 1e-8 * eyeL[None]
    Hll_inv = _inv3x3(Hll_d)  # (L, 3, 3) closed-form batched inverses

    # reduced (Schur) system on poses — flat matmuls over (L*3)
    WHinv = (Wc[..., 0, None] * Hll_inv[:, None, None, 0, :]
             + Wc[..., 1, None] * Hll_inv[:, None, None, 1, :]
             + Wc[..., 2, None] * Hll_inv[:, None, None, 2, :])  # (L, P, 6, 3)
    A = jnp.transpose(WHinv, (1, 2, 0, 3)).reshape(P * 6, L * 3)
    Bm = jnp.transpose(Wc, (1, 2, 0, 3)).reshape(P * 6, L * 3)
    if mm_passes:
        U = _bf16mm(A, Bm.T, mm_passes).reshape(P, 6, P, 6)
    else:
        U = (A @ Bm.T).reshape(P, 6, P, 6)
    # block-diagonal Hpp add as a broadcast multiply against eye(P),
    # scatter-free (it replaces an .at[diag, :, diag, :].add scatter)
    S = Hpp_d[:, :, None, :] * jnp.eye(P, dtype=dtype)[:, None, :, None] - U
    ghat = g_p - (A @ g_l.reshape(L * 3)).reshape(P, 6)

    # freeze pose 0 (gauge): identity row/col, zero gradient
    S = S.reshape(P * 6, P * 6)
    mask = jnp.concatenate([jnp.zeros(6, dtype), jnp.ones((P - 1) * 6, dtype)])
    S = S * mask[:, None] * mask[None, :] + jnp.diag(1.0 - mask)
    ghat = ghat.reshape(P * 6) * mask

    # S is symmetric positive definite (damped GN + identity gauge rows):
    # Cholesky (LM's accept/reject absorbs any f32 breakdown — a NaN step
    # is simply rejected)
    chol = jax.scipy.linalg.cho_factor(S, lower=True)
    dp = -jax.scipy.linalg.cho_solve(chol, ghat).reshape(P, 6)

    # back-substitute landmarks: dl = -Hll^-1 (g_l + W^T dp)
    Wt_dp = (Bm.T @ dp.reshape(P * 6)).reshape(L, 3)
    dl = -_mv3(Hll_inv, g_l + Wt_dp)
    return dp, dl


# ---------------------------------------------------------------------------
# LM driver
# ---------------------------------------------------------------------------

def _cost(poses, points, cam_idx, lm_idx, meas, w, calib, onehots=None):
    r, _ = _residuals(poses, points, cam_idx, lm_idx, meas, w, calib,
                      onehots=onehots)
    return 0.5 * jnp.sum(r * r)


def _huber_weights(r: jnp.ndarray, delta: float) -> jnp.ndarray:
    """IRLS sqrt-weights for the Huber loss: 1 inside |r| <= delta,
    sqrt(delta/|r|) outside. Applied per observation (3-vector norm)."""
    nrm = jnp.linalg.norm(r, axis=-1)
    s = jnp.sqrt(delta / jnp.maximum(nrm, delta))
    return s


# Schur-block engine by backend, each the winner of an A/B on that
# backend. CPU: scatter-add is smaller and faster than the one-hot
# matmuls. GPU: scatter-add (atomic adds) is also the fastest and the
# closest to a float64 solve at P24/L512/M4096 (PERF.md, "Kernel decisions
# on the H100").
DEFAULT_ENGINE = {"cpu": "scatter", "gpu": "scatter"}


def default_engine(backend: str | None = None) -> str:
    """The Schur-block engine ``optimize_bundle`` uses when none is given
    (``backend`` defaults to JAX's default backend)."""
    backend = backend or jax.default_backend()
    if backend not in DEFAULT_ENGINE:
        raise ValueError(f"no default BA engine for backend {backend!r}")
    return DEFAULT_ENGINE[backend]


@partial(jax.jit, static_argnames=("iters", "huber_delta", "engine"))
@full_precision
def optimize_bundle(
    poses: jnp.ndarray,
    points: jnp.ndarray,
    cam_idx: jnp.ndarray,
    lm_idx: jnp.ndarray,
    meas: jnp.ndarray,
    w: jnp.ndarray,
    calib: jnp.ndarray,
    iters: int = 20,
    lam0: float = 1e-4,
    huber_delta: float = 0.0,
    engine: str | None = None,
):
    """Levenberg-Marquardt on one window. Static iteration count with
    accept/reject damping (classic LM schedule: accept -> lam/3, reject ->
    lam*4 and keep state) — replaces gtsam LM (reference bundle.py:199-211).

    ``huber_delta > 0`` enables an IRLS Huber robust loss (per-observation
    reweighting each iteration) — a robustness upgrade over the reference's
    pure Gaussian factors, useful when track outliers survive the RANSAC
    gates.

    ``engine``: "onehot" builds the Schur blocks by float32 matmul
    contraction against index one-hots; "onehot_b3" runs the Hessian
    contractions as bf16x3 products (``BF16_BF16_F32_X3``, ~16 mantissa
    bits) with an f32 gradient; "onehot_bf16" uses single-pass bf16 blocks
    (inflates ATE on ill-conditioned windows — opt-in); "scatter" is the
    XLA scatter-add path (lower memory). Default (None) resolves by
    backend at trace time (:func:`default_engine`). The one-hot engines
    also serve the per-observation pose/landmark lookups as exact one-hot
    matmuls instead of gathers.

    Returns (poses, points, final_cost, lam).
    """
    P, L = poses.shape[0], points.shape[0]
    M = cam_idx.shape[0]
    if engine is None:
        engine = default_engine()
    onehots = None
    if engine in ("onehot", "onehot_b3", "onehot_bf16"):
        dt = poses.dtype
        onehots = (
            (cam_idx[:, None] == jnp.arange(P, dtype=cam_idx.dtype)).astype(dt),
            (lm_idx[:, None] == jnp.arange(L, dtype=lm_idx.dtype)).astype(dt),
        )
    mm_passes = {"onehot_bf16": 1, "onehot_b3": 3}.get(engine, 0)

    def step(carry, _):
        poses, points, lam, cost = carry
        T, X = _gather_obs(poses, points, cam_idx, lm_idx, onehots)
        r, Xc = _residuals_tx(T, X, meas, w, calib)
        if huber_delta > 0.0:
            hw = _huber_weights(r, huber_delta)
            r = r * hw[:, None]
            w_eff = w * hw
        else:
            w_eff = w
        J_pose, J_lm = _jacobians_tx(T, X, w_eff, calib, Xc)
        dp, dl = _schur_solve(J_pose, J_lm, r, cam_idx, lm_idx, P, L, lam,
                              onehots=onehots, mm_passes=mm_passes)
        new_poses = jax.vmap(se3.retract)(poses, dp)
        new_points = points + dl
        new_cost = _cost(new_poses, new_points, cam_idx, lm_idx, meas, w,
                         calib, onehots=onehots)
        ok = jnp.isfinite(new_cost) & (new_cost < cost)
        poses = jnp.where(ok, new_poses, poses)
        points = jnp.where(ok, new_points, points)
        lam = jnp.where(ok, jnp.maximum(lam / 3.0, 1e-9), jnp.minimum(lam * 4.0, 1e6))
        cost = jnp.where(ok, new_cost, cost)
        return (poses, points, lam, cost), cost

    cost0 = _cost(poses, points, cam_idx, lm_idx, meas, w, calib,
                  onehots=onehots)
    (poses, points, lam, cost), _ = jax.lax.scan(
        step, (poses, points, jnp.asarray(lam0, poses.dtype), cost0), None,
        length=iters,
    )
    return poses, points, cost, lam


def prune_depth_weights(
    poses, points, cam_idx, lm_idx, w,
    min_depth: float = 0.1, max_depth: float = 1000.0,
):
    """Zero the weights of observations whose landmark falls behind or too
    far from ANY observing camera — the reference's iterative negative/far
    depth pruning (bundle.py:174-196: z < 0 or z > 1000) expressed as
    masking rather than graph surgery."""
    T = poses[cam_idx]
    X = points[lm_idx]
    z = jnp.einsum("mj,mj->m", T[:, 2, :3], X) + T[:, 2, 3]
    bad_obs = (z < min_depth) | (z > max_depth)
    # a bad depth anywhere kills the whole landmark (reference removes the
    # landmark and all its factors)
    L = points.shape[0]
    bad_lm = jnp.zeros((L,), bool).at[lm_idx].max(bad_obs)
    return jnp.where(bad_lm[lm_idx], 0.0, w)


@partial(jax.jit, static_argnames=("iters", "prune_rounds", "huber_delta",
                                   "engine"))
@full_precision
def optimize_bundle_pruned(
    poses, points, cam_idx, lm_idx, meas, w, calib,
    iters: int = 20, prune_rounds: int = 2,
    min_depth: float = 0.1, max_depth: float = 1000.0,
    huber_delta: float = 0.0, engine: str | None = None,
):
    """LM with interleaved depth pruning (reference optimize_graph loop,
    bundle.py:199-211: optimize, drop z<0/z>1000 landmarks, re-optimize)."""
    for _ in range(prune_rounds):
        w = prune_depth_weights(poses, points, cam_idx, lm_idx, w,
                                min_depth, max_depth)
        poses, points, cost, _ = optimize_bundle(
            poses, points, cam_idx, lm_idx, meas, w, calib, iters=iters,
            huber_delta=huber_delta, engine=engine,
        )
    w = prune_depth_weights(poses, points, cam_idx, lm_idx, w,
                            min_depth, max_depth)
    cost = _cost(poses, points, cam_idx, lm_idx, meas, w, calib)
    return poses, points, w, cost


# ---------------------------------------------------------------------------
# covariance extraction
# ---------------------------------------------------------------------------

@jax.jit
@full_precision
def pose_covariances(poses, points, cam_idx, lm_idx, meas, w, calib):
    """Marginal 6x6 covariance of every pose (window frame, pose 0 fixed).

    Computed as the corresponding diagonal blocks of the inverse un-damped
    Gauss-Newton Schur complement — the replacement for
    ``gtsam.Marginals`` + ``jointMarginalInformation`` conditioning
    (reference pose_graph.py:7-24, loop_closure.py:258-291).

    Returns (P, 6, 6); row 0 is ~0 (the fixed gauge).
    """
    P, L = poses.shape[0], points.shape[0]
    r, Xc = _residuals(poses, points, cam_idx, lm_idx, meas, w, calib)
    J_pose, J_lm = _jacobians(poses, points, cam_idx, lm_idx, w, calib, Xc)
    dtype = J_pose.dtype

    oc = (cam_idx[:, None] == jnp.arange(P, dtype=cam_idx.dtype)).astype(dtype)
    ol = (lm_idx[:, None] == jnp.arange(L, dtype=lm_idx.dtype)).astype(dtype)
    _, _, Hpp, Hll, Wc = _build_blocks_onehot(J_pose, J_lm, r, oc, ol, P, L)
    eyeL = jnp.eye(3, dtype=dtype)
    Hll_inv = _inv3x3(Hll + 1e-6 * eyeL[None])
    WHinv = (Wc[..., 0, None] * Hll_inv[:, None, None, 0, :]
             + Wc[..., 1, None] * Hll_inv[:, None, None, 1, :]
             + Wc[..., 2, None] * Hll_inv[:, None, None, 2, :])
    A = jnp.transpose(WHinv, (1, 2, 0, 3)).reshape(P * 6, L * 3)
    Bm = jnp.transpose(Wc, (1, 2, 0, 3)).reshape(P * 6, L * 3)
    U = (A @ Bm.T).reshape(P, 6, P, 6)
    S = -U
    diag = jnp.arange(P)
    S = S.at[diag, :, diag, :].add(Hpp)
    S = S.reshape(P * 6, P * 6)
    mask = jnp.concatenate([jnp.zeros(6, dtype), jnp.ones((P - 1) * 6, dtype)])
    S = S * mask[:, None] * mask[None, :] + jnp.diag(1.0 - mask)
    # small regularization for padded poses with no observations
    S = S + 1e-8 * jnp.eye(P * 6, dtype=dtype)
    cov = jnp.linalg.inv(S).reshape(P, 6, P, 6)
    out = cov[diag, :, diag, :]
    # f32 inverses are not exactly symmetric; enforce it
    out = 0.5 * (out + jnp.swapaxes(out, -1, -2))
    # zero the fixed-gauge pose-0 block entirely
    return out * mask.reshape(P, 6)[:, :, None]


# batched over windows (the sharded axis in parallel/sharded_ba.py)
optimize_bundles_batched = jax.vmap(
    optimize_bundle_pruned,
    in_axes=(0, 0, 0, 0, 0, 0, None),
)
pose_covariances_batched = jax.vmap(
    pose_covariances, in_axes=(0, 0, 0, 0, 0, 0, None)
)
