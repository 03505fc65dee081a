"""Tensor-parallel (sharded-Schur) bundle adjustment for mega-bundles.

SURVEY.md §2.4's one optional row: window-axis DP (sharded_ba.py) covers
the reference's ~430 independent windows, but a single WINDOW too large
for one device — a city-block mega-bundle with tens of thousands of
landmarks / hundreds of thousands of observations — needs the solver
itself sharded. There is no reference analogue (gtsam LM is
single-process, final_project/backend/GTSam/bundle.py:199-211); this is
its scaling path.

Decomposition (the Schur complement is a sum over landmarks):

    S  = Hpp_d - sum_l  Wc_l Hll_inv_l Wc_l^T
    g^ = g_p   - sum_l  Wc_l Hll_inv_l g_l

Landmarks (and with them ALL their observations — each observation
touches exactly one landmark) are sharded over the ``tp`` mesh axis.
Per LM iteration every device builds its local landmark blocks
(Hll, Wc — never leaving the device) and its PARTIAL pose-space terms
(Hpp, g_p, U = A @ Bm^T); one ``psum`` of the (6P, 6P) reduced system +
(6P,) gradient — the only cross-device traffic, O(P^2) independent of
L/M — makes S replicated, every device solves the same tiny Cholesky,
and back-substitution of the landmark updates is again local. The LM
accept/reject runs on the psum'd cost, so all devices stay in lockstep
deterministically.

Engine notes match ops/ba.py: one-hot matmul contractions for the
block builds, scatter-free; the engine ops/ba.default_engine names picks
the Hessian-block precision (bf16x3 blocks + f32 gradient for
"onehot_b3", inexact Newton; float32 otherwise).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import ba, se3
from ..ops.precision import full_precision


def partition_megabundle(points, cam_idx, lm_idx, meas, w, n_dev,
                         pad_to: int = 128):
    """Host-side observation partitioning for the TP solver.

    Shards landmarks contiguously over ``n_dev`` and routes every
    observation to its landmark's device, localizing ``lm_idx``. Returns
    (points_sh (n_dev, L_loc, 3), cam_sh (n_dev, M_loc), lm_sh,
    meas_sh (n_dev, M_loc, 3), w_sh (n_dev, M_loc)) with padded lanes
    carrying w=0.
    """
    points = np.asarray(points, np.float32)
    cam_idx = np.asarray(cam_idx)
    lm_idx = np.asarray(lm_idx)
    meas = np.asarray(meas, np.float32)
    w = np.asarray(w, np.float32)
    L = points.shape[0]
    L_loc = (L + n_dev - 1) // n_dev
    pts_sh = np.zeros((n_dev, L_loc, 3), np.float32)
    pts_sh.reshape(-1, 3)[:L] = points
    shard_of = lm_idx // L_loc
    counts = np.bincount(shard_of, minlength=n_dev)
    M_loc = int(-(-counts.max() // pad_to) * pad_to)
    cam_sh = np.zeros((n_dev, M_loc), np.int32)
    lm_sh = np.zeros((n_dev, M_loc), np.int32)
    meas_sh = np.zeros((n_dev, M_loc, 3), np.float32)
    w_sh = np.zeros((n_dev, M_loc), np.float32)
    for d in range(n_dev):
        sel = shard_of == d
        n = int(sel.sum())
        cam_sh[d, :n] = cam_idx[sel]
        lm_sh[d, :n] = lm_idx[sel] - d * L_loc
        meas_sh[d, :n] = meas[sel]
        w_sh[d, :n] = w[sel]
    return pts_sh, cam_sh, lm_sh, meas_sh, w_sh


def _local_blocks(poses, X_loc, cam_idx, lm_idx, meas, w, calib,
                  oc, ol, mm_passes):
    """Per-device residuals + blocks over the local observation shard."""
    P_ = poses.shape[0]
    L_loc = X_loc.shape[0]
    T = (oc @ poses.reshape(P_, 16)).reshape(-1, 4, 4)
    X = ol @ X_loc
    r, Xc = ba._residuals_tx(T, X, meas, w, calib)
    J_pose, J_lm = ba._jacobians_tx(T, X, w, calib, Xc)
    if mm_passes:
        return r, ba._build_blocks_onehot_bf16(J_pose, J_lm, r, oc, ol,
                                               P_, L_loc, passes=mm_passes)
    return r, ba._build_blocks_onehot(J_pose, J_lm, r, oc, ol, P_, L_loc)


def _reduced_system(blocks, lam, P_, L_loc, axis, mm_passes):
    """Local Schur partials -> psum'd replicated (S, ghat) + local
    landmark solve state (Hll_inv, Bm)."""
    g_p, g_l, Hpp, Hll, Wc = blocks
    dtype = jnp.float32
    eyeL = jnp.eye(3, dtype=dtype)
    Hll_inv = ba._inv3x3(Hll + lam * eyeL[None] + 1e-8 * eyeL[None])
    WHinv = (Wc[..., 0, None] * Hll_inv[:, None, None, 0, :]
             + Wc[..., 1, None] * Hll_inv[:, None, None, 1, :]
             + Wc[..., 2, None] * Hll_inv[:, None, None, 2, :])
    A = jnp.transpose(WHinv, (1, 2, 0, 3)).reshape(P_ * 6, L_loc * 3)
    Bm = jnp.transpose(Wc, (1, 2, 0, 3)).reshape(P_ * 6, L_loc * 3)
    if mm_passes:
        U_part = ba._bf16mm(A, Bm.T, mm_passes)
    else:
        U_part = A @ Bm.T
    ghat_part = g_p.reshape(P_ * 6) - A @ g_l.reshape(L_loc * 3)
    # the ONLY collectives: (6P, 6P) + (6P,) + pose-diagonal partials
    S_minus = jax.lax.psum(U_part, axis)
    ghat = jax.lax.psum(ghat_part, axis)
    Hpp_full = jax.lax.psum(Hpp, axis)
    eyeP = jnp.eye(6, dtype=dtype)
    Hpp_d = Hpp_full + lam * eyeP[None]
    S = -S_minus
    diag = jnp.arange(P_)
    S = S.reshape(P_, 6, P_, 6).at[diag, :, diag, :].add(Hpp_d)
    S = S.reshape(P_ * 6, P_ * 6)
    mask = jnp.concatenate([jnp.zeros(6, dtype),
                            jnp.ones((P_ - 1) * 6, dtype)])
    S = S * mask[:, None] * mask[None, :] + jnp.diag(1.0 - mask)
    ghat = ghat * mask
    return S, ghat, Hll_inv, Bm, g_l


def optimize_megabundle(
    mesh: Mesh,
    poses0,
    points_sh,
    cam_sh,
    lm_sh,
    meas_sh,
    w_sh,
    calib,
    iters: int = 20,
    lam0: float = 1e-4,
    axis: str = "tp",
    engine: str | None = None,
):
    """LM on ONE bundle whose landmarks/observations are sharded over
    ``axis``. Inputs are the outputs of :func:`partition_megabundle`
    (leading device axis). Returns (poses (P,4,4) replicated,
    points (n_dev*L_loc, 3), cost, cost0).
    """
    from jax import shard_map

    if engine is None:
        engine = ba.default_engine()
    mm_passes = {"onehot_bf16": 1, "onehot_b3": 3}.get(engine, 0)
    n_dev, L_loc = points_sh.shape[0], points_sh.shape[1]
    if axis not in mesh.shape:
        raise ValueError(
            f"mesh has no axis {axis!r} (available: {list(mesh.shape)})")
    if mesh.shape[axis] != n_dev:
        # shard_map with a mismatched axis would silently treat the
        # pre-sharded device dim as data (shard 0 only) and return a
        # wrong-shaped X — fail loud instead.
        raise ValueError(
            f"mesh axis {axis!r} has {mesh.shape[axis]} devices but the "
            f"problem was partitioned for {n_dev} "
            f"(partition_megabundle(n_dev=...) must match the mesh)")
    P_ = np.asarray(poses0).shape[0]
    calib_j = jnp.asarray(calib, jnp.float32)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(axis), P(axis), P(axis), P(axis), P(axis)),
             out_specs=(P(), P(axis), P(), P()))
    @full_precision
    def run(poses0, X_sh, cam, lm, ms, ww):
        X0 = X_sh[0]          # (L_loc, 3) local landmark block
        cam, lm, ms, ww = cam[0], lm[0], ms[0], ww[0]
        oc = (cam[:, None] == jnp.arange(P_, dtype=cam.dtype)).astype(
            jnp.float32)
        ol = (lm[:, None] == jnp.arange(L_loc, dtype=lm.dtype)).astype(
            jnp.float32)
        # padded lanes (w=0) also hit landmark row 0 via the one-hot;
        # their Jacobians are zeroed by w so the blocks stay exact

        def cost_of(poses, X_loc):
            T = (oc @ poses.reshape(P_, 16)).reshape(-1, 4, 4)
            r, _ = ba._residuals_tx(T, ol @ X_loc, ms, ww, calib_j)
            return 0.5 * jax.lax.psum(jnp.sum(r * r), axis)

        def step(carry, _):
            poses, X_loc, lam, cost = carry
            r, blocks = _local_blocks(poses, X_loc, cam, lm, ms, ww,
                                      calib_j, oc, ol, mm_passes)
            S, ghat, Hll_inv, Bm, g_l = _reduced_system(
                blocks, lam, P_, L_loc, axis, mm_passes)
            chol = jax.scipy.linalg.cho_factor(S, lower=True)
            dp = -jax.scipy.linalg.cho_solve(chol, ghat).reshape(P_, 6)
            Wt_dp = (Bm.T @ dp.reshape(P_ * 6)).reshape(L_loc, 3)
            dl = -se3.mv3(Hll_inv, g_l + Wt_dp)
            new_poses = jax.vmap(se3.retract)(poses, dp)
            new_X = X_loc + dl
            new_cost = cost_of(new_poses, new_X)
            ok = jnp.isfinite(new_cost) & (new_cost < cost)
            poses = jnp.where(ok, new_poses, poses)
            X_loc = jnp.where(ok, new_X, X_loc)
            lam = jnp.where(ok, jnp.maximum(lam / 3.0, 1e-9),
                            jnp.minimum(lam * 4.0, 1e6))
            cost = jnp.where(ok, new_cost, cost)
            return (poses, X_loc, lam, cost), None

        cost0 = cost_of(poses0, X0)
        (poses, X_loc, lam, cost), _ = jax.lax.scan(
            step, (poses0, X0, jnp.asarray(lam0, jnp.float32), cost0),
            None, length=iters,
        )
        return poses, X_loc[None], cost[None], cost0[None]

    jitted = jax.jit(run)
    poses, X_out, cost, cost0 = jitted(
        jnp.asarray(poses0, jnp.float32), jnp.asarray(points_sh),
        jnp.asarray(cam_sh), jnp.asarray(lm_sh), jnp.asarray(meas_sh),
        jnp.asarray(w_sh),
    )
    return (poses, X_out.reshape(n_dev * L_loc, 3), float(cost[0]),
            float(cost0[0]))


def megabundle_pose_covariances(
    mesh: Mesh,
    poses,
    points_sh,
    cam_sh,
    lm_sh,
    meas_sh,
    w_sh,
    calib,
    axis: str = "tp",
):
    """(P, 6, 6) marginal pose covariances of a converged mega-bundle.

    Mirrors ops/ba.pose_covariances (inverse un-damped Gauss-Newton Schur
    complement, pose 0 gauge-fixed) with the landmark sum sharded over
    ``axis``: every device builds its local Schur partials, ONE psum makes
    the reduced (6P, 6P) system replicated, and each device inverts the
    same small matrix. Feeds rel_cov for TP-routed overflow windows
    (models/bundle.py) so the pose graph gets the same noise-model
    contract as the dense window path."""
    from jax import shard_map

    mm_passes = 1 if ba.default_engine() in ("onehot_bf16",) else (
        3 if ba.default_engine() == "onehot_b3" else 0)
    n_dev, L_loc = points_sh.shape[0], points_sh.shape[1]
    if axis not in mesh.shape or mesh.shape[axis] != n_dev:
        raise ValueError(
            f"mesh axis {axis!r} incompatible with partitioning "
            f"({dict(mesh.shape)} vs n_dev={n_dev})")
    P_ = np.asarray(poses).shape[0]
    calib_j = jnp.asarray(calib, jnp.float32)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(axis), P(axis), P(axis), P(axis), P(axis)),
             out_specs=P())
    @full_precision
    def run(poses, X_sh, cam, lm, ms, ww):
        X0 = X_sh[0]
        cam, lm, ms, ww = cam[0], lm[0], ms[0], ww[0]
        oc = (cam[:, None] == jnp.arange(P_, dtype=cam.dtype)).astype(
            jnp.float32)
        ol = (lm[:, None] == jnp.arange(L_loc, dtype=lm.dtype)).astype(
            jnp.float32)
        _, blocks = _local_blocks(poses, X0, cam, lm, ms, ww, calib_j,
                                  oc, ol, mm_passes)
        S, _, _, _, _ = _reduced_system(blocks, 0.0, P_, L_loc, axis,
                                        mm_passes)
        S = S + 1e-8 * jnp.eye(P_ * 6, dtype=S.dtype)
        cov = jnp.linalg.inv(S).reshape(P_, 6, P_, 6)
        diag = jnp.arange(P_)
        out = cov[diag, :, diag, :]
        out = 0.5 * (out + jnp.swapaxes(out, -1, -2))
        mask = jnp.concatenate(
            [jnp.zeros((1, 6), S.dtype), jnp.ones((P_ - 1, 6), S.dtype)])
        return out * mask[:, :, None]

    return np.asarray(jax.jit(run)(
        jnp.asarray(poses, jnp.float32), jnp.asarray(points_sh),
        jnp.asarray(cam_sh), jnp.asarray(lm_sh), jnp.asarray(meas_sh),
        jnp.asarray(w_sh)))
