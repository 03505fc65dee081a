"""Pose-graph solver tests: synthetic noisy chains with a loop edge."""

import jax
import jax.numpy as jnp
import numpy as np

from slam_tpu.models.pose_graph import PoseGraph, sqrt_info_from_cov
from slam_tpu.ops import pose_graph as pg_ops
from slam_tpu.ops import se3


def make_chain(key, N=12, drift=0.02):
    """GT poses around a loop; noisy odometry edges."""
    ang = np.linspace(0, 2 * np.pi, N)
    centers = np.stack(
        [30 * (1 - np.cos(ang)), np.zeros(N), 30 * np.sin(ang)], axis=-1
    )
    R = np.asarray(se3.so3_exp(jnp.stack(
        [jnp.zeros(N), jnp.asarray(ang), jnp.zeros(N)], -1)))
    T_gt = np.zeros((N, 4, 4), np.float32)
    for i in range(N):
        T_gt[i, :3, :3] = R[i].T
        T_gt[i, :3, 3] = -R[i].T @ centers[i]
        T_gt[i, 3, 3] = 1.0
    # noisy odometry
    rng = np.random.default_rng(0)
    Z = np.zeros((N - 1, 4, 4), np.float32)
    for i in range(N - 1):
        true_rel = T_gt[i + 1] @ np.linalg.inv(T_gt[i])
        xi = drift * rng.standard_normal(6).astype(np.float32)
        xi[:3] *= 0.2  # smaller rotation noise
        Z[i] = np.asarray(se3.retract(jnp.asarray(true_rel), jnp.asarray(xi)))
    return T_gt, Z


def chained(Z, N):
    T = np.zeros((N, 4, 4), np.float32)
    T[0] = np.eye(4)
    for i in range(N - 1):
        T[i + 1] = Z[i] @ T[i]
    return T


def test_pose_graph_noop_when_consistent():
    """With exact odometry edges the chain is already optimal."""
    T_gt, _ = make_chain(jax.random.PRNGKey(0), N=8, drift=0.0)
    Z = np.stack([T_gt[i + 1] @ np.linalg.inv(T_gt[i]) for i in range(7)])
    pg = PoseGraph()
    pg.nodes = T_gt.copy()
    pg.keyframes = list(range(0, 80, 10))
    pg.e_i = np.arange(7, dtype=np.int32)
    pg.e_j = np.arange(1, 8, dtype=np.int32)
    pg.Z = Z.astype(np.float32)
    pg.sqrt_info = np.tile(np.eye(6, dtype=np.float32) * 10.0, (7, 1, 1))
    pg.is_loop = np.zeros(7, bool)
    cost = pg.optimize()
    assert cost < 1e-6
    np.testing.assert_allclose(pg.nodes, T_gt, atol=1e-4)


def test_loop_closure_corrects_drift():
    N = 12
    T_gt, Z = make_chain(jax.random.PRNGKey(1), N=N, drift=0.03)
    T0 = chained(Z, N)
    pg = PoseGraph()
    pg.nodes = T0.copy()
    pg.keyframes = list(range(N))
    pg.e_i = np.arange(N - 1, dtype=np.int32)
    pg.e_j = np.arange(1, N, dtype=np.int32)
    pg.Z = Z
    pg.sqrt_info = np.tile(np.eye(6, dtype=np.float32) * 30.0, (N - 1, 1, 1))
    pg.is_loop = np.zeros(N - 1, bool)

    def err(nodes):
        d = []
        for i in range(N):
            d.append(np.linalg.norm(
                np.asarray(se3.se3_log(jnp.asarray(
                    nodes[i] @ np.linalg.inv(T_gt[i])
                )))))
        return float(np.mean(d))

    e_before = err(pg.nodes)
    # strong loop edge: last node observes node 0's relative pose exactly
    true_rel = T_gt[N - 1] @ np.linalg.inv(T_gt[0])
    pg.add_edge(0, N - 1, true_rel, np.eye(6) * 1e-6, loop=True)
    pg.optimize(iters=25)
    e_after = err(pg.nodes)
    assert e_after < 0.6 * e_before, (e_before, e_after)
    # the closed endpoint must match the loop measurement tightly
    end_rel = pg.nodes[N - 1] @ np.linalg.inv(pg.nodes[0])
    d = np.asarray(se3.se3_log(jnp.asarray(end_rel @ np.linalg.inv(true_rel))))
    assert np.linalg.norm(d) < 0.05


def test_covariance_grows_along_chain():
    N = 8
    T_gt, Z = make_chain(jax.random.PRNGKey(2), N=N, drift=0.0)
    Zc = np.stack([T_gt[i + 1] @ np.linalg.inv(T_gt[i]) for i in range(N - 1)])
    pg = PoseGraph()
    pg.nodes = T_gt.copy()
    pg.keyframes = list(range(N))
    pg.e_i = np.arange(N - 1, dtype=np.int32)
    pg.e_j = np.arange(1, N, dtype=np.int32)
    pg.Z = Zc.astype(np.float32)
    pg.sqrt_info = np.tile(np.eye(6, dtype=np.float32) * 10.0, (N - 1, 1, 1))
    pg.is_loop = np.zeros(N - 1, bool)
    C = pg.covariance_full()
    tr = [np.trace(C[i, :, i, :]) for i in range(N)]
    assert tr[0] < 1e-6  # gauge-fixed
    assert all(tr[i + 1] > tr[i] - 1e-9 for i in range(1, N - 1))
    # relative covariance of adjacent nodes: PSD, rotation block ~ edge
    # noise (1/100 I; translation picks up lever-arm terms)
    rel = pg.relative_covariance(3, 4, C)
    eig = np.linalg.eigvalsh(rel)
    assert (eig > -1e-8).all()
    np.testing.assert_allclose(np.diag(rel)[:3], 0.01, rtol=0.3)


def test_relative_covariance_smaller_than_marginal():
    """Far apart nodes: relative cov must not exceed sum of marginals."""
    N = 8
    T_gt, Z = make_chain(jax.random.PRNGKey(3), N=N, drift=0.0)
    Zc = np.stack([T_gt[i + 1] @ np.linalg.inv(T_gt[i]) for i in range(N - 1)])
    pg = PoseGraph()
    pg.nodes = T_gt.copy()
    pg.keyframes = list(range(N))
    pg.e_i = np.arange(N - 1, dtype=np.int32)
    pg.e_j = np.arange(1, N, dtype=np.int32)
    pg.Z = Zc.astype(np.float32)
    pg.sqrt_info = np.tile(np.eye(6, dtype=np.float32) * 10.0, (N - 1, 1, 1))
    pg.is_loop = np.zeros(N - 1, bool)
    C = pg.covariance_full()
    # uncertainty accumulates: farther pairs have larger relative cov
    rel_near = pg.relative_covariance(3, 4, C)
    rel_far = pg.relative_covariance(2, 6, C)
    assert np.trace(rel_far) > np.trace(rel_near)
    # rotation block scales ~ number of edges
    assert np.trace(rel_far[:3, :3]) > 3.0 * np.trace(rel_near[:3, :3])


def test_mahalanobis_gate_prefers_loop():
    """On a closed circle the endpoint returns to the start: its gating
    distance to node 0 must be far smaller than a mid-circle node's,
    despite having MORE accumulated covariance — exactly the loop-closure
    selection property (reference loop_closure.py:164-196)."""
    import jax.numpy as jnp
    from slam_tpu.ops import pose_graph as pg_ops

    N = 13
    T_gt, Z = make_chain(jax.random.PRNGKey(5), N=N, drift=0.0)
    Zc = np.stack([T_gt[i + 1] @ np.linalg.inv(T_gt[i]) for i in range(N - 1)])
    pg = PoseGraph()
    pg.nodes = T_gt.copy()
    pg.keyframes = list(range(N))
    pg.e_i = np.arange(N - 1, dtype=np.int32)
    pg.e_j = np.arange(1, N, dtype=np.int32)
    pg.Z = Zc.astype(np.float32)
    pg.sqrt_info = np.tile(np.eye(6, dtype=np.float32) * 10.0, (N - 1, 1, 1))
    pg.is_loop = np.zeros(N - 1, bool)
    C = jnp.asarray(pg.covariance_full())
    nodes = jnp.asarray(pg.nodes)
    d_loop = float(pg_ops.mahalanobis_distance(C, nodes, 0, N - 1))
    d_mid = float(pg_ops.mahalanobis_distance(C, nodes, 0, N // 2))
    assert d_loop < 0.2 * d_mid, (d_loop, d_mid)


def test_node_padding_equivalence():
    """Node-count bucketing (models/pose_graph._NODE_PAD): the padded ops
    calls must reproduce the unpadded solution — padded nodes are identity
    rows of the normal equations, fully decoupled from the valid block."""
    N = 12
    T_gt, Z = make_chain(jax.random.PRNGKey(7), N=N, drift=0.03)
    T0 = chained(Z, N)
    e_i = np.arange(N - 1, dtype=np.int32)
    e_j = np.arange(1, N, dtype=np.int32)
    si = np.tile(np.eye(6, dtype=np.float32) * 30.0, (N - 1, 1, 1))
    valid = np.ones(N - 1, bool)

    # unpadded ops call (n_valid=None)
    nodes_u, cost_u = pg_ops.optimize(
        jnp.asarray(T0), jnp.asarray(e_i), jnp.asarray(e_j),
        jnp.asarray(Z), jnp.asarray(si), jnp.asarray(valid), iters=10,
    )
    # padded: 12 nodes in a 32-node buffer
    pad = 32 - N
    T0p = np.concatenate([T0, np.tile(np.eye(4, dtype=np.float32), (pad, 1, 1))])
    n_valid = np.concatenate([np.ones(N, bool), np.zeros(pad, bool)])
    nodes_p, cost_p = pg_ops.optimize(
        jnp.asarray(T0p), jnp.asarray(e_i), jnp.asarray(e_j),
        jnp.asarray(Z), jnp.asarray(si), jnp.asarray(valid), iters=10,
        n_valid=jnp.asarray(n_valid),
    )
    np.testing.assert_allclose(
        np.asarray(nodes_p)[:N], np.asarray(nodes_u), atol=5e-4
    )
    # padded nodes stay exactly at identity
    np.testing.assert_array_equal(
        np.asarray(nodes_p)[N:], np.tile(np.eye(4, dtype=np.float32), (pad, 1, 1))
    )
    assert abs(float(cost_p) - float(cost_u)) < 1e-3 * max(1.0, float(cost_u))

    # gate distances: padded vs unpadded covariance agree. Evaluate both
    # at the SAME linearization point (nodes_u padded with identity) so the
    # comparison isolates padding semantics, not f32 solver-path noise —
    # two independent optimize() runs converge to points ~5e-4 apart, which
    # amplifies to ~1% on the Mahalanobis quadratic forms.
    ii, jj = np.tril_indices(N, k=-1)
    d_u = np.asarray(pg_ops.gate_matrix(
        nodes_u, jnp.asarray(e_i), jnp.asarray(e_j),
        jnp.asarray(Z), jnp.asarray(si), jnp.asarray(valid),
        jnp.asarray(jj.astype(np.int32)), jnp.asarray(ii.astype(np.int32)),
    ))
    # pair padding: extra (0, 0) lanes must not disturb real lanes
    P = len(ii)
    pi = np.zeros(P + 17, np.int32)
    pj = np.zeros(P + 17, np.int32)
    pi[:P] = jj
    pj[:P] = ii
    nodes_up = jnp.concatenate(
        [nodes_u, jnp.tile(jnp.eye(4, dtype=jnp.float32), (pad, 1, 1))]
    )
    d_p = np.asarray(pg_ops.gate_matrix(
        nodes_up, jnp.asarray(e_i), jnp.asarray(e_j),
        jnp.asarray(Z), jnp.asarray(si), jnp.asarray(valid),
        jnp.asarray(pi), jnp.asarray(pj),
        n_valid=jnp.asarray(n_valid),
    ))
    # rtol: the padded (6*32)^2 f32 inverse takes a different LU blocking
    # path than the unpadded (6*12)^2 one, so ~1% rounding divergence on
    # the quadratic forms is expected (the gate thresholds at 220).
    np.testing.assert_allclose(d_p[:P], d_u, rtol=2e-2, atol=1e-4)


def test_save_load_roundtrip(tmp_path):
    N = 6
    T_gt, Z = make_chain(jax.random.PRNGKey(4), N=N, drift=0.01)
    pg = PoseGraph()
    pg.nodes = chained(Z, N)
    pg.keyframes = list(range(N))
    pg.e_i = np.arange(N - 1, dtype=np.int32)
    pg.e_j = np.arange(1, N, dtype=np.int32)
    pg.Z = Z
    pg.sqrt_info = np.tile(np.eye(6, dtype=np.float32), (N - 1, 1, 1))
    pg.is_loop = np.zeros(N - 1, bool)
    pg.add_edge(0, 5, np.eye(4), np.eye(6) * 0.01)
    p = tmp_path / "pg.npz"
    pg.save(p)
    pg2 = PoseGraph.load(p)
    np.testing.assert_array_equal(pg2.nodes, pg.nodes)
    assert pg2.num_edges == pg.num_edges
    assert bool(pg2.is_loop[-1])


def test_sqrt_info_from_cov():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((6, 6))
    cov = A @ A.T + 0.1 * np.eye(6)
    S = sqrt_info_from_cov(cov)
    np.testing.assert_allclose(S @ cov @ S.T, np.eye(6), atol=1e-6)


def test_marginal_logdets_match_host_slogdet():
    """On-device logdet reduction (analysis uncertainty path) must match
    slogdet of covariance_full's diagonal blocks."""
    N = 10
    T_gt, Z = make_chain(jax.random.PRNGKey(9), N=N, drift=0.02)
    Zc = np.stack([T_gt[i + 1] @ np.linalg.inv(T_gt[i]) for i in range(N - 1)])
    pg = PoseGraph()
    pg.nodes = T_gt.copy()
    pg.keyframes = list(range(N))
    pg.e_i = np.arange(N - 1, dtype=np.int32)
    pg.e_j = np.arange(1, N, dtype=np.int32)
    pg.Z = Zc.astype(np.float32)
    pg.sqrt_info = np.tile(np.eye(6, dtype=np.float32) * 8.0, (N - 1, 1, 1))
    pg.is_loop = np.zeros(N - 1, bool)
    loc, rot = pg.marginal_logdets()
    C = pg.covariance_full()
    loc_ref = np.array([np.linalg.slogdet(
        C[i, 3:, i, 3:] + 1e-18 * np.eye(3))[1] for i in range(1, N)])
    rot_ref = np.array([np.linalg.slogdet(
        C[i, :3, i, :3] + 1e-18 * np.eye(3))[1] for i in range(1, N)])
    np.testing.assert_allclose(loc[1:], loc_ref, atol=2e-3)
    np.testing.assert_allclose(rot[1:], rot_ref, atol=2e-3)


def test_reference_scale_magnitudes_no_random_walk():
    """Pre-LC optimize must not degrade an already-consistent chain at
    reference-scale MAGNITUDES (at ~150 m translations
    whitened by ~1e4 sqrt-information, the f32 LM cost noise floor used to
    be read as improvement and nodes random-walked ~0.5 m; scale run r4:
    bundles ATE 0.564 -> pose graph 0.766 m)."""
    N = 400
    ang = np.linspace(0, 2 * np.pi, N)
    centers = np.stack([150 * (1 - np.cos(ang)), 0.05 * np.sin(3 * ang),
                        150 * np.sin(ang)], axis=-1)
    R = np.asarray(se3.so3_exp(jnp.stack(
        [jnp.zeros(N), jnp.asarray(ang), jnp.zeros(N)], -1)))
    T = np.zeros((N, 4, 4), np.float64)
    for i in range(N):
        T[i, :3, :3] = R[i].T
        T[i, :3, 3] = -R[i].T @ centers[i]
        T[i, 3, 3] = 1.0
    # f32 storage, exactly like the pipeline's bundle artifacts
    T32 = T.astype(np.float32)
    Z = np.stack([(T[i + 1] @ np.linalg.inv(T[i])).astype(np.float32)
                  for i in range(N - 1)])
    pg = PoseGraph()
    pg.nodes = T32.copy()
    pg.keyframes = list(range(N))
    pg.e_i = np.arange(N - 1, dtype=np.int32)
    pg.e_j = np.arange(1, N, dtype=np.int32)
    pg.Z = Z
    # bundle-marginal-scale whitening (sqrt_info norm ~1e4, scale run r4)
    pg.sqrt_info = np.tile(np.eye(6, dtype=np.float32) * 1e4, (N - 1, 1, 1))
    pg.is_loop = np.zeros(N - 1, bool)
    cost = pg.optimize()
    assert cost < 1e-4, cost
    # every node stays within f32-cast distance of where it started
    move = np.linalg.norm(pg.nodes[:, :3, 3] - T32[:, :3, 3], axis=-1)
    assert move.max() < 5e-3, move.max()
