"""Sparse (selected-inverse) pose-graph covariance and LM.

The keyframe pose graph's Gauss-Newton Hessian is a block-tridiagonal
odometry chain plus a handful of loop-closure edges:

    H = T + U U^T,   T block-tridiag (6x6 blocks), U (6N, 6K) low rank.

The dense path (ops/pose_graph.py) inverts the full (6N, 6N) matrix —
O(N^3) flops and O(N^2) memory, fine at the reference's ~650 keyframes but
the abstraction that stops scaling at a few thousand. This module provides
the scalable equivalent of ``gtsam.Marginals`` (reference
final_project/backend/GTSam/pose_graph.py:7-24, loop_closure.py:246-291):

  * block-Cholesky factorization of T by a forward ``lax.scan``
    (D_k = A_k - B_k D_{k-1}^{-1} B_k^T),
  * Takahashi selected inverse for the diagonal blocks
    (C_kk = D_k^{-1} + G_k C_{k+1,k+1} G_k^T, G_k = -D_k^{-1} B_{k+1}^T),
  * arbitrary cross blocks from the semiseparable structure
    C_ij = (G_i G_{i+1} ... G_{j-1}) C_jj, with the interval product
    evaluated per query pair from a log-depth segment-product table
    (binary decomposition of [i, j), ~log2(N) 6x6 matmuls per pair).
    Interval products are bounded (~sqrt(C_ii/C_jj)); the naive global
    prefix factorization Minv_i @ M_j overflows f32 by N~2500,
  * Jacobi preconditioning: every Jacobian's node-columns are scaled by
    s_k = diag(H)_k^(-1/2) so all chain blocks are O(1)-conditioned —
    the whitened odometry blocks span ~1..1e7 (sqrt_info ~5e3) and the
    unscaled recurrences lose f32 past a few hundred nodes (same failure
    the dense path fixed in round 2; see tests/test_pose_graph_scale.py),
  * loop-closure edges folded in exactly by Woodbury:
    C = T^-1 - W W^T with W = T^-1 U chol(I + U^T T^-1 U)^-T.

Everything is O(N) work + O(P) per gated pair; no (6N)^2 object ever
exists. Validated block-for-block against the dense inverse in
tests/test_pg_sparse.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import se3
from .pose_graph import _edge_res_jac, adjoint, edge_residual
from .precision import full_precision

_GATE_CHUNK = 8192  # pairs priced per lax.map step (bounds gather memory)


def _mm(a, b):
    return jnp.einsum("...ij,...jk->...ik", a, b)


# ---------------------------------------------------------------------------
# block-tridiagonal kernel primitives
# ---------------------------------------------------------------------------

def _factorize(A, Bsub):
    """Forward block-Cholesky of the tridiagonal T.

    A (N,6,6) diagonal blocks, Bsub (N,6,6) with Bsub[k] = T[k,k-1]
    (Bsub[0] must be zero). Returns Dinv (N,6,6)."""
    eye = jnp.eye(6, dtype=A.dtype)

    def step(Dinv_prev, xs):
        Ak, Bk = xs
        Dk = Ak - Bk @ Dinv_prev @ Bk.T
        Dk = 0.5 * (Dk + Dk.T)
        Dinvk = jnp.linalg.inv(Dk)
        return Dinvk, Dinvk

    _, Dinv = jax.lax.scan(step, eye, (A, Bsub))
    return Dinv


def _takahashi(Dinv, Bsub):
    """Backward selected-inverse recurrence.

    Returns (Cd, G): Cd[k] = (T^-1)_{kk}; G[k] = -Dinv[k] @ Bsub[k+1]^T
    (the block that maps C_{k+1,j} -> C_{k,j} for j > k; G[N-1] = 0)."""
    Bnext = jnp.concatenate(
        [Bsub[1:], jnp.zeros((1, 6, 6), Bsub.dtype)], axis=0
    )
    G = -jnp.einsum("kij,klj->kil", Dinv, Bnext)  # -Dinv[k] @ Bnext[k]^T

    def step(Cnext, xs):
        Dinvk, Gk = xs
        Ck = Dinvk + Gk @ Cnext @ Gk.T
        return Ck, Ck

    _, Cd = jax.lax.scan(
        step, jnp.zeros((6, 6), Dinv.dtype), (Dinv, G), reverse=True
    )
    return Cd, G


def _thomas_solve(Bsub, Dinv, G, rhs):
    """Solve T x = rhs for block-tridiagonal T; rhs (N,6,R)."""
    eye = jnp.eye(6, dtype=Dinv.dtype)
    Dinv_prev = jnp.concatenate([eye[None], Dinv[:-1]], axis=0)
    L = _mm(Bsub, Dinv_prev)  # L[k] = B_k D_{k-1}^-1 (L[0] = 0)

    def fwd(y_prev, xs):
        Lk, rk = xs
        yk = rk - Lk @ y_prev
        return yk, yk

    _, y = jax.lax.scan(fwd, jnp.zeros_like(rhs[0]), (L, rhs))

    def bwd(x_next, xs):
        Dinvk, Gk, yk = xs
        xk = Dinvk @ yk + Gk @ x_next
        return xk, xk

    _, x = jax.lax.scan(
        bwd, jnp.zeros_like(rhs[0]), (Dinv, G, y), reverse=True
    )
    return x


def _segment_table(G, prod_valid):
    """Log-depth segment-product table over the cross-block maps G.

    tab[l][k] = Gp_k @ Gp_{k+1} @ ... @ Gp_{k+2^l-1} (I-padded past the
    end), with Gp[k] = G[k] where ``prod_valid[k]`` else I (the gauge
    link G[0] and the padded tail are excluded; no query pair spans
    them). O(N log N) build, each interval product then needs only the
    ~log2(N) table entries of its binary decomposition — numerically far
    safer than global prefix products, whose inverses grow without bound
    along the chain and overflow f32 by N~2500."""
    N = G.shape[0]
    eye = jnp.eye(6, dtype=G.dtype)
    Gp = jnp.where(prod_valid[:, None, None], G, eye)
    levels = max(1, (N - 1).bit_length())
    tab = [Gp]
    for l in range(1, levels):
        h = 1 << (l - 1)
        prev = tab[-1]
        shifted = jnp.concatenate(
            [prev[h:], jnp.tile(eye[None], (min(h, N), 1, 1))[: N]], axis=0
        )[:N]
        tab.append(_mm(prev, shifted))
    return jnp.stack(tab)  # (levels, N, 6, 6)


def _interval_product(tab, a, b):
    """Product Gp_a @ ... @ Gp_{b-1} from the segment table (a <= b;
    returns I when a == b). In-order binary decomposition of [a, b):
    largest power-of-two segment first, so the multiplication order
    matches the chain order."""
    levels = tab.shape[0]
    ln = b - a
    acc = jnp.eye(6, dtype=tab.dtype)
    pos = a
    for l in range(levels - 1, -1, -1):
        bit = (ln >> l) & 1
        seg = tab[l, pos]
        acc = jnp.where(bit, acc @ seg, acc)
        pos = pos + (bit << l)
    return acc


# ---------------------------------------------------------------------------
# graph -> blocks
# ---------------------------------------------------------------------------

def _chain_jacobians(nodes, Z_chain, si_chain, m):
    """Whitened residuals/Jacobians of the N-1 consecutive edges (k, k+1),
    with each node's Jacobian masked by that node's gauge/padding mask."""
    N = nodes.shape[0]
    Zc_inv = jax.vmap(se3.inverse)(Z_chain)
    r, Ji, Jj = jax.vmap(_edge_res_jac)(
        nodes[:-1], nodes[1:], Zc_inv, si_chain
    )
    # edge k exists iff node k+1 is valid (m counts node 0 as invalid, but
    # edge 0 exists — use validity of the TARGET node only for existence)
    e_valid = m[1:]  # (N-1,)
    r = r * e_valid[:, None]
    Ji = Ji * (e_valid * m[:-1])[:, None, None]
    Jj = Jj * e_valid[:, None, None]
    return r, Ji, Jj


def _loop_jacobians(nodes, loop_i, loop_j, Z_loop, si_loop, loop_valid, m):
    Zl_inv = jax.vmap(se3.inverse)(Z_loop)
    r, Ji, Jj = jax.vmap(_edge_res_jac)(
        nodes[loop_i], nodes[loop_j], Zl_inv, si_loop
    )
    v = loop_valid.astype(nodes.dtype)
    r = r * v[:, None]
    Ji = Ji * (v * m[loop_i])[:, None, None]
    Jj = Jj * (v * m[loop_j])[:, None, None]
    return r, Ji, Jj


def _assemble_chain(Ji, Jj, m, dtype, N, lam_diag=None):
    """Diagonal/subdiagonal blocks of T from the chain Jacobians.

    A[k] = Ji_k^T Ji_k + Jj_{k-1}^T Jj_{k-1} + (1 - m_k) I [+ lam_diag_k]
    Bsub[k] = Jj_{k-1}^T Ji_{k-1}."""
    z = jnp.zeros((1, 6, 6), dtype)
    AtA_i = jnp.concatenate([jnp.einsum("eai,eaj->eij", Ji, Ji), z])
    AtA_j = jnp.concatenate([z, jnp.einsum("eai,eaj->eij", Jj, Jj)])
    A = AtA_i + AtA_j
    A = A + (1.0 - m)[:, None, None] * jnp.eye(6, dtype=dtype)
    if lam_diag is not None:
        idx = jnp.arange(6)
        A = A.at[:, idx, idx].add(lam_diag)
    Bsub = jnp.concatenate([z, jnp.einsum("eai,eaj->eij", Jj, Ji)])
    return A, Bsub


def _loop_U(Ji_l, Jj_l, loop_i, loop_j, N):
    """U (N, 6, 6K) with U_e's two nonzero 6x6 blocks at nodes i_e, j_e
    (so that sum_e U_e U_e^T reproduces every loop edge's J^T J exactly,
    including its diagonal contributions)."""
    K = Ji_l.shape[0]
    dtype = Ji_l.dtype
    U = jnp.zeros((N, 6, K, 6), dtype)
    eidx = jnp.arange(K)
    U = U.at[loop_i, :, eidx, :].add(jnp.swapaxes(Ji_l, 1, 2))
    U = U.at[loop_j, :, eidx, :].add(jnp.swapaxes(Jj_l, 1, 2))
    return U.reshape(N, 6, K * 6)


def _woodbury_W(Bsub, Dinv, G, U):
    """W with T^-1-correction  C = T^-1 - W W^T  for H = T + U U^T."""
    N, _, KK = U.shape
    Y = _thomas_solve(Bsub, Dinv, G, U)                 # (N, 6, 6K)
    S = jnp.eye(KK, dtype=U.dtype) + jnp.einsum("kiu,kiv->uv", U, Y)
    L = jnp.linalg.cholesky(0.5 * (S + S.T))
    Wt = jax.scipy.linalg.solve_triangular(
        L, Y.reshape(N * 6, KK).T, lower=True
    )
    return Wt.T.reshape(N, 6, KK)


def _node_masks(N, n_count, dtype):
    idx = jnp.arange(N)
    m = ((idx > 0) & (idx < n_count)).astype(dtype)       # gauge + padding
    # G[k] participates in cross products only for 1 <= k <= n_count - 2
    prod_valid = (idx >= 1) & (idx <= n_count - 2)
    return m, prod_valid


def _build_state(nodes, Z_chain, si_chain, loop_i, loop_j, Z_loop, si_loop,
                 loop_valid, n_count):
    """Selected-inverse state: everything gate/logdet queries need.

    All recurrences run on the Jacobi-preconditioned Hessian
    Hhat = S H S (S = diag(diag(H))^(-1/2), applied by scaling every
    Jacobian's node-columns); covariances are unscaled on the way out
    (C = S Chat S)."""
    N = nodes.shape[0]
    dtype = nodes.dtype
    m, prod_valid = _node_masks(N, n_count, dtype)
    _, Ji, Jj = _chain_jacobians(nodes, Z_chain, si_chain, m)
    _, Ji_l, Jj_l = _loop_jacobians(
        nodes, loop_i, loop_j, Z_loop, si_loop, loop_valid, m
    )
    # Jacobi scales from the UNSCALED Hessian diagonal (chain + loops);
    # gauge/padding rows carry the (1 - m) identity, so s = 1 there
    A0, _ = _assemble_chain(Ji, Jj, m, dtype, N)
    idx = jnp.arange(6)
    diag = A0[:, idx, idx]
    diag = diag.at[loop_i].add(jnp.einsum("eai,eai->ei", Ji_l, Ji_l))
    diag = diag.at[loop_j].add(jnp.einsum("eai,eai->ei", Jj_l, Jj_l))
    s = 1.0 / jnp.sqrt(jnp.maximum(diag, 1e-12))
    Ji = Ji * s[:-1][:, None, :]
    Jj = Jj * s[1:][:, None, :]
    Ji_l = Ji_l * s[loop_i][:, None, :]
    Jj_l = Jj_l * s[loop_j][:, None, :]
    A, Bsub = _assemble_chain(Ji, Jj, m, dtype, N)
    Dinv = _factorize(A, Bsub)
    Cd, G = _takahashi(Dinv, Bsub)
    tab = _segment_table(G, prod_valid)
    U = _loop_U(Ji_l, Jj_l, loop_i, loop_j, N)
    W = _woodbury_W(Bsub, Dinv, G, U)
    Chat = Cd - jnp.einsum("kiu,kju->kij", W, W)
    Cdiag = (s[:, :, None] * Chat * s[:, None, :]) * m[:, None, None]
    return Cdiag, Cd, tab, W, m, s


def _cross_block(state, a, b):
    """C[a, b] (unscaled) from the selected inverse; a <= b assumed."""
    Cdiag, Cd, tab, W, m, s = state
    P_ab = _interval_product(tab, a, b)
    Chat_ab = (P_ab @ Cd[b] - W[a] @ W[b].T) * (m[a] * m[b])
    return s[a][:, None] * Chat_ab * s[b][None, :]


def _pair_rel_cov(state, a, b):
    """Cov(delta_b - delta_a) from the selected inverse; a < b assumed."""
    Cdiag = state[0]
    C_ab = _cross_block(state, a, b)
    rel = Cdiag[a] + Cdiag[b] - C_ab - C_ab.T
    return 0.5 * (rel + rel.T)


def _pair_distance(state, nodes, i, j):
    """Same gating math as ops/pose_graph.mahalanobis_distance, sourced
    from the selected inverse instead of the dense covariance."""
    a = jnp.minimum(i, j)
    b = jnp.maximum(i, j)
    Sd = _pair_rel_cov(state, a, b)
    Xi, Xj = nodes[i], nodes[j]
    D = se3.se3_log(Xj @ se3.inverse(Xi))
    Ad = adjoint(Xi)
    cov_D = Ad @ Sd @ Ad.T + 1e-9 * jnp.eye(6, dtype=nodes.dtype)
    d2 = D @ jnp.linalg.solve(cov_D, D)
    bad = ~jnp.isfinite(d2) | (d2 < 0.0)
    return jnp.where(bad, jnp.inf, jnp.sqrt(jnp.maximum(d2, 0.0)))


# ---------------------------------------------------------------------------
# jitted implementations (signatures mirror ops/pose_graph)
# ---------------------------------------------------------------------------

@jax.jit
@full_precision
def _gate_matrix_impl(nodes, Z_chain, si_chain, loop_i, loop_j, Z_loop,
                      si_loop, loop_valid, n_count, pair_i, pair_j):
    """Mahalanobis gate distances for (pair_i, pair_j) candidate pairs.

    O(N) state build + O(P) pair pricing; the pair sweep is chunked with
    ``lax.map`` so the peak per-pair gather footprint stays bounded
    (pair count must be a multiple of the chunk — the model wrapper pads)."""
    state = _build_state(nodes, Z_chain, si_chain, loop_i, loop_j, Z_loop,
                         si_loop, loop_valid, n_count)
    P = pair_i.shape[0]
    chunk = min(_GATE_CHUNK, P)
    f = jax.vmap(partial(_pair_distance, state, nodes))
    pi = pair_i.reshape(-1, chunk)
    pj = pair_j.reshape(-1, chunk)
    d = jax.lax.map(lambda ab: f(ab[0], ab[1]), (pi, pj))
    return d.reshape(P)


@jax.jit
@full_precision
def _marginal_logdets_impl(nodes, Z_chain, si_chain, loop_i, loop_j,
                           Z_loop, si_loop, loop_valid, n_count):
    """Per-node (log det loc_cov, log det rot_cov) — the sparse analogue of
    ops/pose_graph.marginal_logdets (uncertainty plots,
    reference analysis.py:1125-1263)."""
    Cdiag, *_ = _build_state(nodes, Z_chain, si_chain, loop_i, loop_j,
                             Z_loop, si_loop, loop_valid, n_count)

    def logdet3(Mb):
        Mb = Mb + 1e-18 * jnp.eye(3, dtype=Mb.dtype)
        det = (
            Mb[..., 0, 0] * (Mb[..., 1, 1] * Mb[..., 2, 2]
                             - Mb[..., 1, 2] * Mb[..., 2, 1])
            - Mb[..., 0, 1] * (Mb[..., 1, 0] * Mb[..., 2, 2]
                               - Mb[..., 1, 2] * Mb[..., 2, 0])
            + Mb[..., 0, 2] * (Mb[..., 1, 0] * Mb[..., 2, 1]
                               - Mb[..., 1, 1] * Mb[..., 2, 0])
        )
        return jnp.log(jnp.maximum(jnp.abs(det), jnp.finfo(Mb.dtype).tiny))

    return logdet3(Cdiag[:, 3:, 3:]), logdet3(Cdiag[:, :3, :3])


@jax.jit
@full_precision
def _selected_blocks_impl(nodes, Z_chain, si_chain, loop_i, loop_j, Z_loop,
                          si_loop, loop_valid, n_count, qi, qj):
    """Diagnostic/parity access: (Cdiag (N,6,6), C[qi,qj] (Q,6,6))."""
    state = _build_state(nodes, Z_chain, si_chain, loop_i, loop_j, Z_loop,
                         si_loop, loop_valid, n_count)
    Cdiag = state[0]

    def block(i, j):
        a = jnp.minimum(i, j)
        b = jnp.maximum(i, j)
        C_ab = _cross_block(state, a, b)
        same = i == j
        C_ab = jnp.where(same, Cdiag[a], jnp.where(i < j, C_ab, C_ab.T))
        return C_ab

    return Cdiag, jax.vmap(block)(qi, qj)


@partial(jax.jit, static_argnames=("iters",))
@full_precision
def _optimize_impl(nodes, Z_chain, si_chain, loop_i, loop_j, Z_loop,
                   si_loop, loop_valid, n_count, iters: int = 15,
                   lam0: float = 1e-6):
    """LM on the pose graph via the sparse solver: each step solves
    (T + lam*diag(H) + U U^T) d = -g with block-Thomas + Woodbury —
    O(N) per iteration instead of the dense (6N)^3. Marquardt (relative)
    damping matches the dense path's Jacobi-scaled lam*I exactly.
    Returns (nodes, cost)."""
    N = nodes.shape[0]
    dtype = nodes.dtype
    m, _ = _node_masks(N, n_count, dtype)
    Zc_inv = jax.vmap(se3.inverse)(Z_chain)
    Zl_inv = jax.vmap(se3.inverse)(Z_loop)
    e_valid_c = m[1:]
    v_l = loop_valid.astype(dtype)

    def residuals(nodes):
        r_c = jax.vmap(edge_residual)(
            nodes[:-1], nodes[1:], Zc_inv, si_chain
        ) * e_valid_c[:, None]
        r_l = jax.vmap(edge_residual)(
            nodes[loop_i], nodes[loop_j], Zl_inv, si_loop
        ) * v_l[:, None]
        return r_c, r_l

    def cost_of(nodes):
        r_c, r_l = residuals(nodes)
        return 0.5 * (jnp.sum(r_c * r_c) + jnp.sum(r_l * r_l))

    def build_and_solve(nodes, lam):
        r_c, Ji, Jj = _chain_jacobians(nodes, Z_chain, si_chain, m)
        r_l, Ji_l, Jj_l = _loop_jacobians(
            nodes, loop_i, loop_j, Z_loop, si_loop, loop_valid, m
        )
        U = _loop_U(Ji_l, Jj_l, loop_i, loop_j, N)
        # gradient g_k = sum of J^T r over incident edges
        g = jnp.zeros((N, 6), dtype)
        g = g.at[:-1].add(jnp.einsum("eai,ea->ei", Ji, r_c))
        g = g.at[1:].add(jnp.einsum("eai,ea->ei", Jj, r_c))
        g = g.at[loop_i].add(jnp.einsum("eai,ea->ei", Ji_l, r_l))
        g = g.at[loop_j].add(jnp.einsum("eai,ea->ei", Jj_l, r_l))
        # Marquardt damping on diag(H) = diag(T) + rowsq(U)
        A, Bsub = _assemble_chain(Ji, Jj, m, dtype, N)
        idx = jnp.arange(6)
        diag_H = A[:, idx, idx] + jnp.sum(U * U, axis=-1)
        A = A.at[:, idx, idx].add(lam * diag_H)
        Dinv = _factorize(A, Bsub)
        _, G = _takahashi(Dinv, Bsub)
        # Woodbury solve: (T' + U U^T)^-1 g
        rhs = jnp.concatenate([g[:, :, None], U], axis=-1)
        sol = _thomas_solve(Bsub, Dinv, G, rhs)
        x_g, Y = sol[:, :, 0], sol[:, :, 1:]
        KK = U.shape[-1]
        S = jnp.eye(KK, dtype=dtype) + jnp.einsum("kiu,kiv->uv", U, Y)
        UTxg = jnp.einsum("kiu,ki->u", U, x_g)
        corr = Y @ jnp.linalg.solve(0.5 * (S + S.T), UTxg)
        d = -(x_g - corr)
        return jax.vmap(se3.retract)(nodes, d)

    def step(carry, _):
        nodes, lam, cost = carry
        new_nodes = build_and_solve(nodes, lam)
        new_cost = cost_of(new_nodes)
        # relative accept margin — same rationale as ops/pose_graph.py
        # step(): sub-0.1% 'improvements' are f32 cost noise near the
        # optimum; accepting them random-walks the nodes
        ok = jnp.isfinite(new_cost) & (new_cost < cost * (1.0 - 1e-3))
        nodes = jnp.where(ok, new_nodes, nodes)
        lam = jnp.where(ok, jnp.maximum(lam / 3.0, 1e-9),
                        jnp.minimum(lam * 5.0, 1e4))
        cost = jnp.where(ok, new_cost, cost)
        return (nodes, lam, cost), cost

    c0 = cost_of(nodes)
    (nodes, lam, cost), _ = jax.lax.scan(
        step, (nodes, jnp.asarray(lam0, dtype), c0), None, length=iters
    )
    return nodes, cost


# ---------------------------------------------------------------------------
# public entry points: float64 on the host CPU backend
# ---------------------------------------------------------------------------
#
# The sparse path exists for graphs the dense (6N)^2 inverse cannot reach
# (N >~ 1000 keyframes). At that scale float32 is no longer a precision
# question but a representational one: the ABSOLUTE covariance of a node
# ~2500 steps from the gauge is ~1e8x its RELATIVE covariance to a nearby
# node, so forming rel = C_aa + C_bb - C_ab - C_ba cancels ~8 decimal
# digits — more than f32 carries. (The dense path has the identical limit;
# it was simply never asked to go past ~650 nodes.)
#
# These recurrences are SEQUENTIAL 6x6 block chains — latency-bound work
# (~10 MFLOP at N=2560) that no accelerator helps with. So the public
# wrappers pin the computation to the host CPU backend at float64 and hand
# back float32. The batched heavy stages (frontend, BA, dense pose graph
# at reference scale) stay on the accelerator.

def _run_on_host64(fn, *args, **kwargs):
    import numpy as np

    def to64(x):
        a = np.asarray(x)
        if a.dtype == np.float32:
            return a.astype(np.float64)
        return a

    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(), jax.default_device(cpu):
        out = fn(*[jnp.asarray(to64(a)) for a in args], **kwargs)
    return jax.tree.map(lambda x: np.asarray(x, np.float32), out)


def gate_matrix_sparse(nodes, Z_chain, si_chain, loop_i, loop_j, Z_loop,
                       si_loop, loop_valid, n_count, pair_i, pair_j):
    """Mahalanobis gate distances (see _gate_matrix_impl); host f64."""
    return _run_on_host64(
        _gate_matrix_impl, nodes, Z_chain, si_chain, loop_i, loop_j,
        Z_loop, si_loop, loop_valid, n_count, pair_i, pair_j,
    )


def marginal_logdets_sparse(nodes, Z_chain, si_chain, loop_i, loop_j,
                            Z_loop, si_loop, loop_valid, n_count):
    """Per-node marginal logdets (see _marginal_logdets_impl); host f64."""
    return _run_on_host64(
        _marginal_logdets_impl, nodes, Z_chain, si_chain, loop_i, loop_j,
        Z_loop, si_loop, loop_valid, n_count,
    )


def selected_blocks(nodes, Z_chain, si_chain, loop_i, loop_j, Z_loop,
                    si_loop, loop_valid, n_count, qi, qj):
    """Selected covariance blocks (see _selected_blocks_impl); host f64."""
    return _run_on_host64(
        _selected_blocks_impl, nodes, Z_chain, si_chain, loop_i, loop_j,
        Z_loop, si_loop, loop_valid, n_count, qi, qj,
    )


def optimize_sparse(nodes, Z_chain, si_chain, loop_i, loop_j, Z_loop,
                    si_loop, loop_valid, n_count, iters: int = 15):
    """Sparse LM (see _optimize_impl); host f64."""
    return _run_on_host64(
        _optimize_impl, nodes, Z_chain, si_chain, loop_i, loop_j,
        Z_loop, si_loop, loop_valid, n_count, iters=iters,
    )
