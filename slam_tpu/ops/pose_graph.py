"""Pose-graph optimization: batched Gauss-Newton/LM on SE(3) nodes with
Between factors.

Replaces ``gtsam.BetweenFactorPose3`` + ``PriorFactorPose3`` + LM +
``Marginals`` for the keyframe pose graph (reference:
final_project/backend/GTSam/pose_graph.py:27-124, re-optimized after every
loop closure at loop_closure.py:33-71).

State: node extrinsics X_i (T_w2c of keyframe i), node 0 frozen (gauge).
Edge (i, j) carries measurement Z = X_j X_i^-1 (the bundle's relative
extrinsic) and a 6x6 sqrt-information whitening matrix. The residual is

    r_ij = log(Z^-1 X_j X_i^-1)   in R^6 (right-perturbation coords),

which is exactly the parameterization in which ops/ba.py reports the
relative covariance, so whitening with cov^-1/2 is consistent end-to-end.

The normal equations are assembled as dense (6N, 6N) — a few hundred
keyframes is a ~2700^2 matrix, trivially Cholesky-factorable on device,
and *every* loop-closure re-optimization reuses the same compiled kernel
(static shapes: edges are padded, nodes fixed).

Marginal / joint covariances for Mahalanobis gating come from the inverse
of the same Gauss-Newton Hessian (:func:`marginals`), replacing
``gtsam.Marginals`` + ``jointMarginalInformation``
(pose_graph.py:7-24, loop_closure.py:258-291).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import se3
from .precision import full_precision


def edge_residual(Xi, Xj, Z_inv, sqrt_info):
    """Whitened between-residual for one edge."""
    r = se3.se3_log(Z_inv @ (Xj @ se3.inverse(Xi)))
    return sqrt_info @ r


def _edge_res_jac(Xi, Xj, Z_inv, sqrt_info):
    """Residual and Jacobians w.r.t. right perturbations of (Xi, Xj)."""

    def f(d):
        return edge_residual(
            se3.retract(Xi, d[:6]), se3.retract(Xj, d[6:]), Z_inv, sqrt_info
        )

    d0 = jnp.zeros(12, Xi.dtype)
    r = f(d0)
    J = jax.jacfwd(f)(d0)  # (6, 12)
    return r, J[:, :6], J[:, 6:]


def _node_mask(N, dtype, n_valid):
    """(6N,) gauge+padding mask: 0 for node 0 (gauge) and for padded
    (invalid) nodes, 1 elsewhere. Padded nodes become identity rows of the
    normal equations, so node-count bucketing (models/pose_graph.py) reuses
    one compiled kernel across nearby keyframe counts."""
    if n_valid is None:
        node_mask = jnp.ones(N, dtype).at[0].set(0.0)
    else:
        node_mask = n_valid.astype(dtype).at[0].set(0.0)
    return jnp.repeat(node_mask, 6)


@partial(jax.jit, static_argnames=("iters",))
@full_precision
def optimize(
    nodes: jnp.ndarray,      # (N, 4, 4) initial extrinsics
    e_i: jnp.ndarray,        # (E,) int32 source node
    e_j: jnp.ndarray,        # (E,) int32 target node
    Z: jnp.ndarray,          # (E, 4, 4) measured relative extrinsic
    sqrt_info: jnp.ndarray,  # (E, 6, 6) whitening
    e_valid: jnp.ndarray,    # (E,) bool (padding mask)
    iters: int = 15,
    lam0: float = 1e-6,
    n_valid: jnp.ndarray | None = None,  # (N,) bool node padding mask
):
    """LM over the pose graph; node 0 frozen. Returns (nodes, cost)."""
    N = nodes.shape[0]
    Z_inv = jax.vmap(se3.inverse)(Z)
    wE = e_valid.astype(nodes.dtype)

    def residuals(nodes):
        r = jax.vmap(edge_residual)(nodes[e_i], nodes[e_j], Z_inv, sqrt_info)
        return r * wE[:, None]

    def cost_of(nodes):
        r = residuals(nodes)
        return 0.5 * jnp.sum(r * r)

    def build_and_solve(nodes, lam):
        r, Ji, Jj = jax.vmap(_edge_res_jac)(
            nodes[e_i], nodes[e_j], Z_inv, sqrt_info
        )
        r = r * wE[:, None]
        Ji = Ji * wE[:, None, None]
        Jj = Jj * wE[:, None, None]
        dtype = nodes.dtype
        H = jnp.zeros((N, 6, N, 6), dtype)
        g = jnp.zeros((N, 6), dtype)
        H = H.at[e_i, :, e_i, :].add(jnp.einsum("eai,eaj->eij", Ji, Ji))
        H = H.at[e_j, :, e_j, :].add(jnp.einsum("eai,eaj->eij", Jj, Jj))
        H = H.at[e_i, :, e_j, :].add(jnp.einsum("eai,eaj->eij", Ji, Jj))
        H = H.at[e_j, :, e_i, :].add(jnp.einsum("eai,eaj->eij", Jj, Ji))
        g = g.at[e_i].add(jnp.einsum("eai,ea->ei", Ji, r))
        g = g.at[e_j].add(jnp.einsum("eai,ea->ei", Jj, r))
        H = H.reshape(6 * N, 6 * N)
        g = g.reshape(6 * N)
        # gauge: freeze node 0 (and any padded nodes)
        mask = _node_mask(N, dtype, n_valid)
        H = H * mask[:, None] * mask[None, :] + jnp.diag(1.0 - mask)
        g = g * mask
        # Jacobi preconditioning: the raw diagonal spans ~1 (gauge) to
        # ~1e7 (whitened odometry blocks), which makes the f32 dense solve
        # produce garbage steps at a few hundred nodes (observed at N=651:
        # every LM step rejected, loop closures silently ignored). Scaling
        # to unit diagonal bounds the condition number by the graph
        # structure alone, and makes lam a *relative* (Marquardt) damping.
        dscale = jax.lax.rsqrt(jnp.maximum(jnp.diag(H), 1e-12))
        Hs = H * dscale[:, None] * dscale[None, :]
        Hs = Hs + lam * jnp.eye(6 * N, dtype=dtype)
        d = -(dscale * jnp.linalg.solve(Hs, dscale * g)).reshape(N, 6)
        return jax.vmap(se3.retract)(nodes, d)

    def step(carry, _):
        nodes, lam, cost = carry
        new_nodes = build_and_solve(nodes, lam)
        new_cost = cost_of(new_nodes)
        # relative accept margin: near convergence the f32 cost itself has
        # a noise floor (residuals are logs of products of large
        # extrinsics, whitened by ~1e4), and a plain new_cost < cost reads
        # that noise as improvement — the optimizer then random-walks
        # around the optimum instead of parking.
        # Real descent steps cut cost by orders of magnitude; sub-0.1%
        # 'improvements' at this precision are indistinguishable from
        # noise and are rejected.
        ok = jnp.isfinite(new_cost) & (new_cost < cost * (1.0 - 1e-3))
        nodes = jnp.where(ok, new_nodes, nodes)
        lam = jnp.where(ok, jnp.maximum(lam / 3.0, 1e-9),
                        jnp.minimum(lam * 5.0, 1e4))
        cost = jnp.where(ok, new_cost, cost)
        return (nodes, lam, cost), cost

    c0 = cost_of(nodes)
    (nodes, lam, cost), _ = jax.lax.scan(
        step, (nodes, jnp.asarray(lam0, nodes.dtype), c0), None, length=iters
    )
    return nodes, cost


def _covariance_full(nodes, e_i, e_j, Z, sqrt_info, e_valid, n_valid=None):
    """Trace-time body shared by :func:`gn_hessian_inverse` (returns the
    full covariance) and :func:`gate_matrix` (consumes it on device)."""
    N = nodes.shape[0]
    Z_inv = jax.vmap(se3.inverse)(Z)
    wE = e_valid.astype(nodes.dtype)
    r, Ji, Jj = jax.vmap(_edge_res_jac)(nodes[e_i], nodes[e_j], Z_inv, sqrt_info)
    Ji = Ji * wE[:, None, None]
    Jj = Jj * wE[:, None, None]
    dtype = nodes.dtype
    H = jnp.zeros((N, 6, N, 6), dtype)
    H = H.at[e_i, :, e_i, :].add(jnp.einsum("eai,eaj->eij", Ji, Ji))
    H = H.at[e_j, :, e_j, :].add(jnp.einsum("eai,eaj->eij", Jj, Jj))
    H = H.at[e_i, :, e_j, :].add(jnp.einsum("eai,eaj->eij", Ji, Jj))
    H = H.at[e_j, :, e_i, :].add(jnp.einsum("eai,eaj->eij", Jj, Ji))
    H = H.reshape(6 * N, 6 * N)
    mask = _node_mask(N, dtype, n_valid)
    H = H * mask[:, None] * mask[None, :] + jnp.diag(1.0 - mask)
    # Jacobi-preconditioned inverse: C = S (S H S)^-1 S with S=diag(H)^-1/2.
    # Without the scaling the f32 inverse of the (6N, 6N) matrix is garbage
    # beyond a few hundred nodes (diagonal spans 7 orders of magnitude);
    # at N=651 it produced non-PSD covariances (Mahalanobis d^2 < 0 pairs
    # read as distance 0 and sailed through the loop gate) and NaN logdets.
    dscale = jax.lax.rsqrt(jnp.maximum(jnp.diag(H), 1e-12))
    Hs = H * dscale[:, None] * dscale[None, :]
    Hs = Hs + 1e-6 * jnp.eye(6 * N, dtype=dtype)
    Cs = jnp.linalg.inv(Hs)
    C = Cs * dscale[:, None] * dscale[None, :]
    C = 0.5 * (C + C.T)
    # zero the gauge block (its diagonal placeholder would read as cov 1.0)
    C = C * mask[:, None] * mask[None, :]
    return C.reshape(N, 6, N, 6)


@jax.jit
@full_precision
def gn_hessian_inverse(nodes, e_i, e_j, Z, sqrt_info, e_valid, n_valid=None):
    """Full (6N, 6N) covariance = inverse Gauss-Newton Hessian at ``nodes``
    with node 0 gauge-fixed. One dense inverse serves *all* marginal /
    joint covariance queries of loop closure — replacing the reference's
    per-pair Dijkstra + covariance-chain machinery with a single
    linear-algebra object (SURVEY.md §7 build plan item 8)."""
    return _covariance_full(nodes, e_i, e_j, Z, sqrt_info, e_valid, n_valid)


@jax.jit
@full_precision
def gate_matrix(nodes, e_i, e_j, Z, sqrt_info, e_valid, pair_i, pair_j,
                n_valid=None):
    """Fused posterior refresh + Mahalanobis sweep: inverts the pose-graph
    Hessian and prices every (pair_i, pair_j) candidate pair WITHOUT the
    covariance ever leaving the device. Returns (P,) distances.

    The unfused path (covariance_full -> host -> mahalanobis_batched)
    moves the (6N, 6N) covariance across the host link twice per posterior
    refresh — ~120 MB at N=651 — for a result that is only ~N^2 floats.
    """
    C = _covariance_full(nodes, e_i, e_j, Z, sqrt_info, e_valid, n_valid)
    return mahalanobis_batched(C, nodes, pair_i, pair_j)


@jax.jit
@full_precision
def marginal_logdets(nodes, e_i, e_j, Z, sqrt_info, e_valid, n_valid=None):
    """Per-node (log det loc_cov, log det rot_cov) of the posterior, fully
    on device: returns (N,) + (N,) natural-log determinants of the 3x3
    location / rotation diagonal covariance blocks.

    The uncertainty plots (reference analysis.py:1125-1263) only consume
    these 2N scalars; materializing covariance_full on the host for them
    read the whole (6N)^2 matrix back over the host link (~85 MB per
    call at N=653 — half the analysis stage in this environment).
    """
    C = _covariance_full(nodes, e_i, e_j, Z, sqrt_info, e_valid, n_valid)
    N = C.shape[0]
    idx = jnp.arange(N)
    blocks = C[idx, :, idx, :]                      # (N, 6, 6)
    eye3 = 1e-18 * jnp.eye(3, dtype=C.dtype)

    def logdet3(M):
        M = M + eye3
        det = (
            M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0])
        )
        return jnp.log(jnp.maximum(jnp.abs(det), jnp.finfo(M.dtype).tiny))

    return logdet3(blocks[:, 3:, 3:]), logdet3(blocks[:, :3, :3])


def relative_covariance(C, i, j):
    """Covariance of the relative perturbation (delta_j - delta_i), 6x6.

    This is the uncertainty of the relative pose i -> j expressed in the
    nodes' right-perturbation coordinates — the quantity the reference
    approximates by summing consecutive covariances along the Dijkstra
    shortest path (loop_closure.py:109-135); here it is exact, straight
    from the joint posterior.
    """
    Sii = C[i, :, i, :]
    Sij = C[i, :, j, :]
    Sjj = C[j, :, j, :]
    rel = Sii + Sjj - Sij - Sij.T
    return 0.5 * (rel + rel.T)


def adjoint(T):
    """SE(3) adjoint for twist order [w, v]: (4,4) -> (6,6)."""
    R = T[:3, :3]
    t = T[:3, 3]
    Z = jnp.zeros((3, 3), T.dtype)
    top = jnp.concatenate([R, Z], axis=1)
    bot = jnp.concatenate([se3.hat(t) @ R, R], axis=1)
    return jnp.concatenate([top, bot], axis=0)


def mahalanobis_distance(C, nodes, i, j):
    """Loop-closure gating distance between keyframes i and j.

    Null hypothesis of a loop: the two keyframes are at the same pose, so
    the innovation is the full relative displacement D = log(Xj Xi^-1),
    weighted by the posterior uncertainty of that displacement. To first
    order D ~ D_hat (+) Adj(Xi) (delta_j - delta_i), so

        d^2 = D^T [Adj(Xi) Cov(dj - di) Adj(Xi)^T]^-1 D.

    Replaces the reference's Dijkstra-path covariance + BetweenFactor-error
    distance (loop_closure.py:138-196) with one batched quadratic form.
    """
    Xi, Xj = nodes[i], nodes[j]
    D = se3.se3_log(Xj @ se3.inverse(Xi))
    Sd = relative_covariance(C, i, j)
    A = adjoint(Xi)
    cov_D = A @ Sd @ A.T + 1e-9 * jnp.eye(6, dtype=C.dtype)
    d2 = D @ jnp.linalg.solve(cov_D, D)
    # fail CLOSED: a non-finite or negative quadratic form means the
    # posterior covariance block is numerically broken (non-PSD) — treat
    # the pair as infinitely far rather than distance 0, otherwise garbage
    # pairs pass the loop gate (observed at N=651 before preconditioning).
    bad = ~jnp.isfinite(d2) | (d2 < 0.0)
    return jnp.where(bad, jnp.inf, jnp.sqrt(jnp.maximum(d2, 0.0)))


# batched over many (i, j) pairs — the loop-closure gating sweep
relative_covariance_batched = jax.vmap(relative_covariance, in_axes=(None, 0, 0))
mahalanobis_batched = jax.vmap(
    mahalanobis_distance, in_axes=(None, None, 0, 0)
)
