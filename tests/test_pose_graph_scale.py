"""Regression tests for pose-graph numerics at reference scale.

Round-2 scale run (3360 frames -> 651 keyframes) exposed an f32
conditioning failure in the dense pose-graph path: the Hessian diagonal
spans ~1.0 (gauge row) to ~1e7 (whitened odometry blocks, sqrt_info ~5e3),
so the unpreconditioned (6N, 6N) solve/inverse produced garbage — every LM
step was rejected (an accepted loop closure left the trajectory
bit-identical) and the Mahalanobis gate emitted non-PSD quadratic forms
that read as distance 0 and passed the gate. Fixed by Jacobi
preconditioning in ops/pose_graph.py; these tests pin the fix.

Reference behaviors being protected: loop-closure pose-graph update +
re-optimization (final_project/backend/loop/loop_closure.py:33-71) and
candidate gating by path-covariance Mahalanobis distance (:138-196).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_tpu.models.pose_graph import PoseGraph
from slam_tpu.ops import pose_graph as pg_ops
from slam_tpu.ops import se3


def make_stiff_loop_graph(N, misfit_m=0.5, seed=0):
    """Odometry chain with reference-scale-stiff information (whitened
    blocks ~5e3, like real bundle marginals) plus one loop edge whose
    measurement disagrees with the drifted chain by ``misfit_m`` meters."""
    rng = np.random.default_rng(seed)
    # straight-ish corridor with gentle curvature, ~2 m steps.
    # Pure host numpy f64 on purpose: building the chain with on-device
    # se3.retract made the graph BACKEND-DEPENDENT — on an accelerator
    # whose default matmul precision is reduced, the rotations
    # de-orthonormalize ~1e-3/step, and after 2560 compounding steps the
    # stiff whitened Hessian is garbage (the selected inverse overflows
    # to NaN while the same test passes on CPU).
    nodes = np.zeros((N, 4, 4), np.float64)
    nodes[0] = np.eye(4)
    Z = np.zeros((N - 1, 4, 4), np.float64)
    yaws = 0.002 * rng.standard_normal(N - 1)
    for i in range(N - 1):
        c, s = np.cos(yaws[i]), np.sin(yaws[i])
        d = np.array([[c, 0.0, s, 0.0],
                      [0.0, 1.0, 0.0, 0.0],
                      [-s, 0.0, c, 2.0],
                      [0.0, 0.0, 0.0, 1.0]])
        Z[i] = d
        nodes[i + 1] = d @ nodes[i]
    nodes = nodes.astype(np.float32)
    Z = Z.astype(np.float32)
    pg = PoseGraph()
    pg.nodes = nodes
    pg.keyframes = list(range(N))
    pg.e_i = np.arange(N - 1, dtype=np.int32)
    pg.e_j = np.arange(1, N, dtype=np.int32)
    pg.Z = Z
    # stiff whitening like the scale run's bundle marginals
    si = np.eye(6, dtype=np.float32)
    si[:3, :3] *= 5e3   # rotation rows
    si[3:, 3:] *= 1.5e2  # translation rows
    pg.sqrt_info = np.tile(si, (N - 1, 1, 1))
    pg.is_loop = np.zeros(N - 1, bool)
    # loop edge: j observes i displaced by misfit_m (disagrees with chain)
    i, j = 2, N - 2
    true_rel = (nodes[j].astype(np.float64)
                @ np.linalg.inv(nodes[i].astype(np.float64)))
    # right-translation by misfit_m in x (exp of a pure-v twist), host f64
    T_mis = np.eye(4)
    T_mis[0, 3] = misfit_m
    bad_rel = (true_rel @ T_mis).astype(np.float32)
    pg.add_edge(i, j, bad_rel, np.eye(6) * 1e-4, loop=True)
    return pg, (i, j)


def f64_gate_reference(pg, pair_i, pair_j):
    """Ground-truth gate distances: same op traced at float64 (CPU)."""
    e_i, e_j, Z, si, valid = pg._padded_edges()
    with jax.enable_x64():
        d = pg_ops.gate_matrix(
            jnp.asarray(pg.nodes, jnp.float64), jnp.asarray(e_i),
            jnp.asarray(e_j), jnp.asarray(Z, jnp.float64),
            jnp.asarray(si, jnp.float64), jnp.asarray(valid),
            jnp.asarray(pair_i), jnp.asarray(pair_j),
        )
        return np.asarray(d)


def test_stiff_loop_edge_moves_poses():
    """The r2-scale failure mode: with stiff whitening, an inconsistent
    loop edge must actually pull the trajectory (pre-fix: 0.0 movement)."""
    N = 64
    pg, (i, j) = make_stiff_loop_graph(N)
    before = pg.nodes.copy()
    cost = pg.optimize(iters=25)
    shift = np.abs(pg.nodes[:, :3, 3] - before[:, :3, 3]).max()
    assert shift > 0.05, f"loop edge ignored (max shift {shift})"
    # the optimized chain must satisfy the loop edge much better
    li = np.nonzero(pg.is_loop)[0][0]
    r = np.asarray(se3.se3_log(jnp.asarray(
        np.linalg.inv(pg.Z[li]) @ pg.nodes[j] @ np.linalg.inv(pg.nodes[i])
    )))
    assert np.linalg.norm(r[3:]) < 0.15  # residual translation << 0.5 m
    assert np.isfinite(cost)


def test_gate_f32_matches_f64():
    """Preconditioned f32 gate distances track the f64 reference."""
    N = 64
    # pure odometry chain: drop the loop edge for a clean chain posterior
    pg2, _ = make_stiff_loop_graph(N, misfit_m=0.0)
    pg2.e_i = pg2.e_i[:-1]
    pg2.e_j = pg2.e_j[:-1]
    pg2.Z = pg2.Z[:-1]
    pg2.sqrt_info = pg2.sqrt_info[:-1]
    pg2.is_loop = pg2.is_loop[:-1]
    ii, jj = np.tril_indices(N, k=-5)
    sel = slice(0, ii.size, max(1, ii.size // 256))  # subsample pairs
    pi, pj = jj[sel].astype(np.int32), ii[sel].astype(np.int32)
    d32 = pg2.gate_distances(pi, pj)
    d64 = f64_gate_reference(pg2, pi, pj)
    assert np.all(np.isfinite(d32)), "f32 gate emitted non-finite distances"
    m = np.isfinite(d64) & (d64 < 1e5)
    rel = np.abs(d32[m] - d64[m]) / np.maximum(d64[m], 1.0)
    assert np.percentile(rel, 95) < 0.1, (
        f"f32 gate off by {np.percentile(rel, 95):.3f} (p95 rel err)")


def test_mahalanobis_fails_closed_on_non_psd():
    """A numerically broken (non-PSD) covariance must read as inf, not 0."""
    N = 4
    nodes = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    nodes[3, 2, 3] = 10.0  # far displaced node
    C = np.zeros((N, 6, N, 6), np.float32)
    # malicious: strongly negative-definite relative block
    C[1, :, 1, :] = -np.eye(6) * 10.0
    C[3, :, 3, :] = -np.eye(6) * 10.0
    d = np.asarray(pg_ops.mahalanobis_distance(
        jnp.asarray(C), jnp.asarray(nodes), 1, 3))
    assert np.isinf(d) or d > 1e3, f"non-PSD pair passed the gate (d={d})"


@pytest.mark.slow
def test_gate_and_optimize_at_reference_scale():
    """Full N=651 (reference seq-00 keyframe count) health check."""
    N = 651
    pg, (i, j) = make_stiff_loop_graph(N)
    before = pg.nodes.copy()
    pg.optimize(iters=15)
    shift = np.abs(pg.nodes[:, :3, 3] - before[:, :3, 3]).max()
    assert shift > 0.05, "loop edge ignored at N=651"
    # gate: sweep a band of pairs, compare against f64
    pi = np.arange(0, N - 40, 7, dtype=np.int32)
    pj = (pi + 37).astype(np.int32)
    d32 = pg.gate_distances(pi, pj)
    d64 = f64_gate_reference(pg, pi, pj)
    assert np.all(np.isfinite(d32))
    m = np.isfinite(d64) & (d64 < 1e5)
    rel = np.abs(d32[m] - d64[m]) / np.maximum(d64[m], 1.0)
    assert np.percentile(rel, 95) < 0.15
