"""Keyframe pose graph (stateful wrapper over ops/pose_graph.py).

Reference surface: ``PoseGraph`` (final_project/backend/GTSam/
pose_graph.py:27-124) — add_bundle (:39-96), optimize (:98-103),
save/load (:105-117) — plus the loop-closure edge insertion + full
re-optimization (loop_closure.py:33-71).

Differences by design:
  * edges live in padded numpy arrays; optimization always runs the same
    compiled kernel (static edge capacity, validity mask);
  * noise models are stored as 6x6 sqrt-information matrices computed from
    the bundle marginal covariances (reference builds a gtsam Gaussian
    noise model the same way, pose_graph.py:53-69);
  * serialization is npz (replaces whole-object pickle, :105-117).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from ..ops import pg_sparse
from ..ops import pose_graph as pg_ops

_EDGE_PAD = 64   # edge capacity grows in blocks to limit recompilation
_NODE_PAD = 64   # node capacity too: the dense (6N)^2 solve and the gate
_PAIR_PAD = 8192  # sweep recompile per exact keyframe count otherwise
#                   (observed at scale: 651 -> 653 keyframes re-paid an
#                   87 s pose-graph compile + 113 s gate compile)
_LOOP_PAD = 8    # loop-edge capacity bucket for the sparse path

# Above this node count optimize/gate/logdets route to the sparse
# selected-inverse path (ops/pg_sparse.py): the dense (6N)^2 inverse is
# O(N^3) flops + O(N^2) memory, ~1.8 GB of covariance at N=2500. The
# dense path stays the default at reference scale (~653 keyframes), where
# its one big batched solve beats the sparse path's sequential scans.
SPARSE_NODE_THRESHOLD = 1024


def sqrt_info_from_cov(cov: np.ndarray, eps: float = 1e-10) -> np.ndarray:
    """Inverse matrix square root of a 6x6 covariance (whitening)."""
    cov = 0.5 * (cov + cov.T) + eps * np.eye(6)
    vals, vecs = np.linalg.eigh(cov)
    vals = np.maximum(vals, eps)
    return (vecs * (1.0 / np.sqrt(vals))) @ vecs.T


@dataclass
class PoseGraph:
    nodes: np.ndarray = field(
        default_factory=lambda: np.eye(4, dtype=np.float32)[None]
    )  # (N, 4, 4) extrinsics per keyframe
    keyframes: list[int] = field(default_factory=lambda: [0])
    e_i: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    e_j: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    Z: np.ndarray = field(default_factory=lambda: np.zeros((0, 4, 4), np.float32))
    sqrt_info: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 6, 6), np.float32)
    )
    is_loop: np.ndarray = field(default_factory=lambda: np.zeros(0, bool))

    # ------------------------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def num_edges(self) -> int:
        return len(self.e_i)

    # ------------------------------------------------------------------
    @staticmethod
    def from_bundles(bundle_result) -> "PoseGraph":
        """Assemble the odometry chain from a BundleResult (reference
        add_bundle loop, project.py:69-79)."""
        pg = PoseGraph()
        pg.nodes = bundle_result.T_w2c_keyframes.astype(np.float32).copy()
        pg.keyframes = list(bundle_result.keyframes)
        B = bundle_result.rel_T.shape[0]
        pg.e_i = np.arange(B, dtype=np.int32)
        pg.e_j = np.arange(1, B + 1, dtype=np.int32)
        pg.Z = bundle_result.rel_T.astype(np.float32).copy()
        pg.sqrt_info = np.stack(
            [sqrt_info_from_cov(c) for c in bundle_result.rel_cov]
        ).astype(np.float32)
        pg.is_loop = np.zeros(B, bool)
        return pg

    def add_edge(
        self, i: int, j: int, Z: np.ndarray, cov: np.ndarray, loop: bool = True
    ) -> None:
        """Insert a Between edge (loop-closure path, reference
        update_pose_graph loop_closure.py:33-71)."""
        self.e_i = np.append(self.e_i, np.int32(i))
        self.e_j = np.append(self.e_j, np.int32(j))
        self.Z = np.concatenate([self.Z, Z[None].astype(np.float32)])
        self.sqrt_info = np.concatenate(
            [self.sqrt_info, sqrt_info_from_cov(cov)[None].astype(np.float32)]
        )
        self.is_loop = np.append(self.is_loop, loop)

    # ------------------------------------------------------------------
    def _padded_edges(self):
        E = self.num_edges
        cap = ((E + _EDGE_PAD - 1) // _EDGE_PAD) * _EDGE_PAD
        pad = cap - E
        e_i = np.concatenate([self.e_i, np.zeros(pad, np.int32)])
        e_j = np.concatenate([self.e_j, np.zeros(pad, np.int32)])
        Z = np.concatenate([self.Z, np.tile(np.eye(4, dtype=np.float32), (pad, 1, 1))])
        si = np.concatenate([self.sqrt_info, np.zeros((pad, 6, 6), np.float32)])
        valid = np.concatenate([np.ones(E, bool), np.zeros(pad, bool)])
        return e_i, e_j, Z, si, valid

    def _padded_nodes(self):
        """Nodes padded to the _NODE_PAD bucket (identity fill + validity
        mask) so the compiled dense solves are reused across nearby
        keyframe counts."""
        N = self.num_nodes
        cap = ((N + _NODE_PAD - 1) // _NODE_PAD) * _NODE_PAD
        pad = cap - N
        nodes = np.concatenate(
            [self.nodes, np.tile(np.eye(4, dtype=np.float32), (pad, 1, 1))]
        )
        n_valid = np.concatenate([np.ones(N, bool), np.zeros(pad, bool)])
        return nodes, n_valid

    def _use_sparse(self) -> bool:
        return self.num_nodes > SPARSE_NODE_THRESHOLD

    def _chain_layout(self) -> bool:
        """True iff the non-loop edges are exactly the consecutive
        odometry chain (k, k+1) in node order — the from_bundles layout."""
        chain = ~self.is_loop
        return bool(
            np.array_equal(self.e_i[chain], np.arange(self.num_nodes - 1))
            and np.array_equal(self.e_j[chain], np.arange(1, self.num_nodes))
        )

    def _sparse_arrays(self):
        """Split edges into the consecutive odometry chain and the loop
        set, padded to the node/loop buckets (sparse-path inputs).

        The chain edges must be exactly (k, k+1) in node order — which
        ``from_bundles`` guarantees and ``add_edge`` (loop=True) preserves."""
        chain = ~self.is_loop
        if not self._chain_layout():
            raise ValueError("sparse path requires a consecutive odometry "
                             "chain (from_bundles layout)")
        nodes_p, n_valid = self._padded_nodes()
        Np = nodes_p.shape[0]
        Z_chain = np.tile(np.eye(4, dtype=np.float32), (Np - 1, 1, 1))
        si_chain = np.zeros((Np - 1, 6, 6), np.float32)
        Z_chain[: self.num_nodes - 1] = self.Z[chain]
        si_chain[: self.num_nodes - 1] = self.sqrt_info[chain]
        K = int(self.is_loop.sum())
        cap = max(_LOOP_PAD, ((K + _LOOP_PAD - 1) // _LOOP_PAD) * _LOOP_PAD)
        li = np.zeros(cap, np.int32)
        lj = np.zeros(cap, np.int32)
        Zl = np.tile(np.eye(4, dtype=np.float32), (cap, 1, 1))
        sil = np.zeros((cap, 6, 6), np.float32)
        lv = np.zeros(cap, bool)
        li[:K] = self.e_i[self.is_loop]
        lj[:K] = self.e_j[self.is_loop]
        Zl[:K] = self.Z[self.is_loop]
        sil[:K] = self.sqrt_info[self.is_loop]
        lv[:K] = True
        n_count = np.int32(self.num_nodes)
        return (jnp.asarray(nodes_p), jnp.asarray(Z_chain),
                jnp.asarray(si_chain), jnp.asarray(li), jnp.asarray(lj),
                jnp.asarray(Zl), jnp.asarray(sil), jnp.asarray(lv),
                jnp.asarray(n_count))

    def optimize(self, iters: int = 15) -> float:
        """LM re-optimization of all nodes (reference pose_graph.py:98-103).
        Returns final cost. Routes to the O(N) sparse solver above
        SPARSE_NODE_THRESHOLD keyframes.

        Odometry-only graphs take the ANALYTIC path: with node 0 anchored
        and no loop edges, the chained measurements X_{k+1} = Z_k X_k are
        the exact zero-residual MAP solution for any edge weighting, so it
        is computed in f64 on host instead of descending on device. The LM
        descent is not merely wasteful there — at reference scale its f32
        residuals (log of products of ~150 m extrinsics, whitened by ~1e4
        sqrt-information) carry an O(0.05) noise floor per entry, and from
        an already-optimal init the accept test reads that noise as
        improvement: nodes random-walked ~0.5 m off the optimum while the
        reported cost stayed 'small' (bundles ATE
        0.564 -> pose graph 0.766 m; the f32 'optimum' re-evaluated in f64
        had cost 1619 vs 0.004 at init)."""
        if not self.is_loop.any() and self._chain_layout():
            nodes = self.nodes.astype(np.float64)
            Z = self.Z.astype(np.float64)
            out = np.empty_like(nodes)
            out[0] = nodes[0]
            for k in range(self.num_nodes - 1):
                out[k + 1] = Z[k] @ out[k]
            self.nodes = out.astype(np.float32)
            return 0.0
        if self._use_sparse():
            args = self._sparse_arrays()
            nodes, cost = pg_sparse.optimize_sparse(*args, iters=iters)
            self.nodes = np.asarray(nodes)[: self.num_nodes]
            return float(cost)
        e_i, e_j, Z, si, valid = self._padded_edges()
        nodes_p, n_valid = self._padded_nodes()
        nodes, cost = pg_ops.optimize(
            jnp.asarray(nodes_p), jnp.asarray(e_i), jnp.asarray(e_j),
            jnp.asarray(Z), jnp.asarray(si), jnp.asarray(valid), iters=iters,
            n_valid=jnp.asarray(n_valid),
        )
        self.nodes = np.asarray(nodes)[: self.num_nodes]
        return float(cost)

    # ------------------------------------------------------------------
    def covariance_full(self) -> np.ndarray:
        """(N, 6, N, 6) posterior covariance (see ops gn_hessian_inverse)."""
        e_i, e_j, Z, si, valid = self._padded_edges()
        nodes_p, n_valid = self._padded_nodes()
        N = self.num_nodes
        C = np.asarray(
            pg_ops.gn_hessian_inverse(
                jnp.asarray(nodes_p), jnp.asarray(e_i), jnp.asarray(e_j),
                jnp.asarray(Z), jnp.asarray(si), jnp.asarray(valid),
                n_valid=jnp.asarray(n_valid),
            )
        )
        return C[:N, :, :N, :]

    def marginal_logdets(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-node natural-log determinants of the 3x3 location / rotation
        marginal covariance blocks, computed and reduced ON DEVICE — only
        2N scalars cross the host link (covariance_full would read the
        whole (6N)^2 matrix back; the uncertainty plots need just these).
        Returns (loc_logdet (N,), rot_logdet (N,))."""
        N = self.num_nodes
        if self._use_sparse():
            loc, rot = pg_sparse.marginal_logdets_sparse(
                *self._sparse_arrays()
            )
            return np.asarray(loc)[:N], np.asarray(rot)[:N]
        e_i, e_j, Z, si, valid = self._padded_edges()
        nodes_p, n_valid = self._padded_nodes()
        loc, rot = pg_ops.marginal_logdets(
            jnp.asarray(nodes_p), jnp.asarray(e_i), jnp.asarray(e_j),
            jnp.asarray(Z), jnp.asarray(si), jnp.asarray(valid),
            n_valid=jnp.asarray(n_valid),
        )
        return np.asarray(loc)[:N], np.asarray(rot)[:N]

    def gate_distances(self, pair_i: np.ndarray, pair_j: np.ndarray) -> np.ndarray:
        """Mahalanobis gating distances for candidate pairs, computed in one
        fused device call (posterior inverse + batched quadratic forms); only
        the (P,) distances cross the host link, never the (6N, 6N) covariance.
        Pairs are padded to the _PAIR_PAD bucket (the sweep count N(N-1)/2
        would otherwise bake the exact keyframe count into the compile)."""
        P = len(pair_i)
        cap = max(_PAIR_PAD, ((P + _PAIR_PAD - 1) // _PAIR_PAD) * _PAIR_PAD)
        pi = np.zeros(cap, np.int32)
        pj = np.zeros(cap, np.int32)
        pi[:P] = pair_i
        pj[:P] = pair_j
        if self._use_sparse():
            d = np.asarray(
                pg_sparse.gate_matrix_sparse(
                    *self._sparse_arrays(), jnp.asarray(pi), jnp.asarray(pj)
                )
            )
            return d[:P]
        e_i, e_j, Z, si, valid = self._padded_edges()
        nodes_p, n_valid = self._padded_nodes()
        d = np.asarray(
            pg_ops.gate_matrix(
                jnp.asarray(nodes_p), jnp.asarray(e_i), jnp.asarray(e_j),
                jnp.asarray(Z), jnp.asarray(si), jnp.asarray(valid),
                jnp.asarray(pi), jnp.asarray(pj),
                n_valid=jnp.asarray(n_valid),
            )
        )
        return d[:P]

    def marginal(self, i: int, C: np.ndarray | None = None) -> np.ndarray:
        C = self.covariance_full() if C is None else C
        return C[i, :, i, :]

    def relative_covariance(
        self, i: int, j: int, C: np.ndarray | None = None
    ) -> np.ndarray:
        C = self.covariance_full() if C is None else C
        return np.asarray(
            pg_ops.relative_covariance(jnp.asarray(C), i, j)
        )

    # ------------------------------------------------------------------
    def save(self, path: str | Path) -> None:
        np.savez_compressed(
            str(path),
            nodes=self.nodes, keyframes=np.asarray(self.keyframes),
            e_i=self.e_i, e_j=self.e_j, Z=self.Z,
            sqrt_info=self.sqrt_info, is_loop=self.is_loop,
        )

    @staticmethod
    def load(path: str | Path) -> "PoseGraph":
        z = np.load(str(path))
        pg = PoseGraph()
        pg.nodes = z["nodes"]
        pg.keyframes = [int(k) for k in z["keyframes"]]
        pg.e_i, pg.e_j = z["e_i"], z["e_j"]
        pg.Z, pg.sqrt_info = z["Z"], z["sqrt_info"]
        pg.is_loop = z["is_loop"]
        return pg
