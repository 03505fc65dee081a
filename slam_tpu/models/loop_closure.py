"""Loop-closure detection and pose-graph correction.

Reference surface: final_project/backend/loop/loop_closure.py —
``find_loops`` (:294-352), candidate gating ``get_good_candidates``
(:199-228) / ``check_candidate`` (:164-196), geometric verification
``check_candidate_match`` (:405-436) + ``consensus_matches`` (:572-599),
mini-bundle relative pose+cov (:439-569), pose-graph update (:33-71) —
plus the det-weighted Dijkstra covariance-path machinery in loop/graph.py.

Batched re-design:
  * The O(N^2) per-pair Dijkstra scan over the covariance graph collapses
    into ONE batched Mahalanobis sweep: the exact joint posterior
    covariance (one dense inverse of the pose-graph Hessian,
    ops/pose_graph.py:gn_hessian_inverse) prices every candidate pair in a
    single vmapped quadratic-form kernel. The covariance is only
    recomputed after an accepted closure (the only event that changes it —
    the reference does the same refresh at loop_closure.py:392-400).
  * Candidate verification (descriptor matching + RANSAC) reuses the
    batched frontend kernels and runs all of a keyframe's candidates as
    one vmapped call, instead of sequential BFMatcher/solvePnP calls.
  * The accepted pair is refined by a 2-pose mini-bundle using the SAME
    Schur-LM solver as the main windows (P=2), yielding the relative pose
    and its covariance for the new graph edge.
  * Familiar-path handling (:311-349) stays host-side (sequential,
    cheap): after an accepted closure, candidates of subsequent keyframes
    are deferred while the vehicle re-traverses the familiar segment; on
    leaving it, the deferred keyframes are re-verified from the back and
    exactly one more closure is committed (reference :334-347).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..config import LoopConfig, SlamConfig
from ..ops import ba, matching, pose_graph as pg_ops, ransac, se3, stereo
from .pose_graph import PoseGraph
from .trackstore import TrackStore


@dataclass
class Closure:
    kf_i: int          # earlier keyframe index (graph node)
    kf_j: int          # later keyframe index
    frame_i: int       # global frame ids
    frame_j: int
    num_inliers: int
    inlier_frac: float
    rel_T: np.ndarray  # frame_i cam -> frame_j cam extrinsic
    rel_cov: np.ndarray
    mahalanobis: float


# ---------------------------------------------------------------------------
# geometric verification (batched over candidates)
# ---------------------------------------------------------------------------

from functools import partial as _partial


@_partial(jax.jit, static_argnames=("num_hypotheses",))
def _verify_candidates_multi(
    key,
    desc_q, valid_q, links_q, lvalid_q,           # (Q, ...) query keyframes
    desc_cands, valid_cands, links_cands, lvalid_cands,  # (Q, C, ...)
    calib, num_hypotheses: int, threshold: float,
):
    """Verify C candidates for each of Q query keyframes in ONE call
    (nested vmap). Between posterior refreshes the candidate sets of
    successive keyframes are known in advance, so the sequential scan can
    verify speculatively in blocks — Q x fewer device round-trips."""
    Q = desc_q.shape[0]
    keys = jax.random.split(key, Q)
    return jax.vmap(
        lambda k_, dq, vq, lq, lvq, dc, vc, lc_, lvc: _verify_candidates(
            k_, dq, vq, lq, lvq, dc, vc, lc_, lvc,
            calib, num_hypotheses, threshold,
        )
    )(keys, desc_q, valid_q, links_q, lvalid_q,
      desc_cands, valid_cands, links_cands, lvalid_cands)


@_partial(jax.jit, static_argnames=("num_hypotheses",))
def _verify_candidates(
    key,
    desc_j, valid_j, links_j, lvalid_j,          # the query keyframe
    desc_cands, valid_cands, links_cands, lvalid_cands,  # (C, ...) candidates
    calib, num_hypotheses: int, threshold: float,
):
    """Match + RANSAC the query keyframe against C candidates at once.

    Returns per-candidate (num_inliers, frac, T_cand2query, match arrays).
    The pose convention follows the frontend: world = candidate (earlier)
    camera frame, measurements from the query (later) frame, so T maps
    earlier-cam -> later-cam.
    """
    C = desc_cands.shape[0]

    def one(key, d_c, v_c, l_c, lv_c):
        m = matching.mutual_match(d_c, desc_j, v_c, valid_j)
        j = jnp.clip(m["target_idx"], 0, links_j.shape[0] - 1)
        corr_valid = m["matched"] & lv_c & lvalid_j[j]
        pw = stereo.backproject(calib, l_c)
        meas = links_j[j]
        rr = ransac.ransac_pnp(
            key, pw, meas, corr_valid, calib,
            num_hypotheses=num_hypotheses, threshold=threshold,
        )
        n_corr = jnp.sum(corr_valid)
        return {
            "num_inliers": rr["num_inliers"],
            "frac": rr["num_inliers"] / jnp.maximum(n_corr, 1),
            "T": rr["T_w2c"],
            "ok": rr["ok"],
            "match_tgt": m["target_idx"],
            "inliers": rr["inliers"],
        }

    keys = jax.random.split(key, C)
    return jax.vmap(one)(keys, desc_cands, valid_cands, links_cands, lvalid_cands)


# ---------------------------------------------------------------------------
# mini-bundle refinement (reference create_bundle / get_relative_pose_and_cov)
# ---------------------------------------------------------------------------

def _refine_pair(
    links_i, links_j, inlier_mask, match_tgt, T_init, calib,
    max_landmarks: int = 512,
):
    """2-pose bundle on the inlier correspondences; returns rel_T, cov."""
    K = links_i.shape[0]
    idx = np.nonzero(np.asarray(inlier_mask))[0][:max_landmarks]
    L = max_landmarks
    li = np.zeros(2 * L, np.int32)
    ci = np.zeros(2 * L, np.int32)
    meas = np.zeros((2 * L, 3), np.float32)
    w = np.zeros(2 * L, np.float32)
    n = len(idx)
    tgt = np.asarray(match_tgt)
    li[:n] = np.arange(n)
    li[L : L + n] = np.arange(n)
    ci[L : L + n] = 1
    meas[:n] = np.asarray(links_i)[idx]
    meas[L : L + n] = np.asarray(links_j)[tgt[idx]]
    w[:n] = 1.0
    w[L : L + n] = 1.0
    points0 = np.zeros((L, 3), np.float32)
    # Landmark init on host NumPy (cheap, n <= 512 points); the arrays
    # handed to the device below are all padded to max_landmarks with
    # zero-weight rows, so the jitted bundle compiles once for every
    # closure regardless of its inlier count.
    points0[:n] = stereo.backproject_np(calib, meas[:n])
    poses0 = np.stack([np.eye(4, dtype=np.float32), np.asarray(T_init)])

    poses, points, w2, cost = ba.optimize_bundle_pruned(
        jnp.asarray(poses0), jnp.asarray(points0), jnp.asarray(ci),
        jnp.asarray(li), jnp.asarray(meas), jnp.asarray(w),
        jnp.asarray(calib), iters=15,
    )
    covs = ba.pose_covariances(
        poses, points, jnp.asarray(ci), jnp.asarray(li), jnp.asarray(meas),
        w2, jnp.asarray(calib),
    )
    return np.asarray(poses[1]), np.asarray(covs[1])


# ---------------------------------------------------------------------------
# main driver
# ---------------------------------------------------------------------------

def find_loops(
    pg: PoseGraph,
    db: TrackStore,
    desc: np.ndarray,        # (F, K, D) frontend descriptors
    desc_valid: np.ndarray,  # (F, K)
    calib,
    cfg: SlamConfig = SlamConfig(),
    reoptimize_every: bool = True,
    timings: dict | None = None,
) -> list[Closure]:
    """Scan keyframes in order, gate by batched Mahalanobis distance,
    verify by batched matching+RANSAC, refine by mini-bundle, insert the
    edge and re-optimize. Mutates ``pg``; returns accepted closures.

    Mirrors reference find_loops (loop_closure.py:294-352) including the
    acceptance thresholds (LoopConfig <- loop_closure.py:15-20) and the
    familiar-path suppression state machine (:311-349).
    """
    lc: LoopConfig = cfg.loop
    calib = jnp.asarray(calib, jnp.float32)
    kfs = pg.keyframes
    N = pg.num_nodes
    key = jax.random.PRNGKey(cfg.seed + 1)

    import time as _time

    tm = timings if timings is not None else {}
    for k_ in ("gate_s", "verify_s", "refine_s", "reopt_s",
               "gate_refreshes", "verify_calls"):
        tm.setdefault(k_, 0.0)

    def _timed(bucket, fn):
        t0 = _time.perf_counter()
        out = fn()
        dt = _time.perf_counter() - t0
        tm[bucket] += dt
        tm.setdefault(bucket + "_calls", []).append(round(dt, 2))
        return out

    def all_pairs_gate():
        """(N, N) Mahalanobis matrix in ONE fused device call (posterior
        inverse + batched sweep; recomputed only after an accepted closure
        changes the posterior). Only the distances cross the host link."""
        ii, jj = np.tril_indices(N, k=-1)  # j < i pairs
        d = pg.gate_distances(jj, ii)
        D = np.full((N, N), np.inf, np.float32)
        D[ii, jj] = d
        return D

    D = _timed("gate_s", all_pairs_gate)
    tm["gate_refreshes"] += 1
    closures: list[Closure] = []
    spec: dict[int, tuple] = {}     # speculative verification results
    SPEC_Q = 4                      # keyframes verified per device call

    def gated(n_):
        d_ = D[n_, : n_ - lc.keyframe_gap + 1]
        if d_.size == 0:
            return d_, np.zeros(0, np.int64)
        order = np.argsort(d_)
        return d_, order[d_[order] < lc.mahalanobis_thresh][: lc.max_candidates]

    def speculate(start_n, key):
        """Verify candidates of up to SPEC_Q gated keyframes >= start_n in
        one batched call; fill ``spec``."""
        speculate_list(range(start_n, N), key)

    def speculate_list(ns, key):
        """Verify candidates of the first SPEC_Q gated keyframes of ``ns``
        (any order — the backward familiar-segment walk passes descending
        indices) in one batched device call; fill ``spec``."""
        batch = []
        for m in ns:
            if len(batch) >= SPEC_Q:
                break
            if m in spec:
                continue
            _, g = gated(m)
            if len(g):
                gp = np.concatenate(
                    [g, np.repeat(g[:1], lc.max_candidates - len(g))]
                )
                batch.append((m, len(g), gp))
        if not batch:
            return
        tm["verify_calls"] += 1
        while len(batch) < SPEC_Q:  # pad to static Q (results discarded)
            batch.append(batch[-1])
        ns = [b[0] for b in batch]
        f_q = np.asarray([kfs[b[0]] for b in batch])
        f_c = np.asarray([[kfs[int(g)] for g in b[2]] for b in batch])
        def _run_verify():
            vr = _verify_candidates_multi(
                key,
                jnp.asarray(desc[f_q]), jnp.asarray(desc_valid[f_q]),
                jnp.asarray(db.links[f_q]), jnp.asarray(db.link_valid[f_q]),
                jnp.asarray(desc[f_c]), jnp.asarray(desc_valid[f_c]),
                jnp.asarray(db.links[f_c]), jnp.asarray(db.link_valid[f_c]),
                calib, cfg.ransac.num_hypotheses, cfg.ransac.threshold_px,
            )
            return jax.tree.map(np.asarray, vr)

        vr = _timed("verify_s", _run_verify)
        for qi, (m_, n_good_, gp_) in enumerate(batch):
            if m_ not in spec:
                spec[m_] = (
                    jax.tree.map(lambda x: x[qi], vr), n_good_, gp_,
                    f_c[qi],
                )

    def verify_one(n):
        """Verify keyframe n's gated candidates (speculative batched
        matching + RANSAC). Returns the winning candidate tuple or None."""
        nonlocal key
        d, good = gated(n)
        if len(good) == 0:
            return None
        if n not in spec:
            key, sub = jax.random.split(key)
            speculate(n, sub)
        vr, n_good, good_p, f_cands = spec.pop(n)
        n_inl = np.asarray(vr["num_inliers"])
        ok = np.asarray(vr["ok"]) & (n_inl > lc.min_inliers)
        ok[n_good:] = False  # padding lanes never accepted
        if not ok.any():
            return None
        # first passing candidate in gate order (reference consensus_matches
        # takes the first with enough inliers, :588-592)
        ci_local = int(np.nonzero(ok)[0][0])
        g = int(good_p[ci_local])
        return (
            g, int(f_cands[ci_local]), int(n_inl[ci_local]),
            float(np.asarray(vr["frac"])[ci_local]),
            np.asarray(vr["inliers"][ci_local]),
            np.asarray(vr["match_tgt"][ci_local]),
            np.asarray(vr["T"][ci_local]), float(d[g]),
        )

    def commit(n, hit):
        """Mini-bundle refinement + edge insertion + posterior refresh."""
        nonlocal D
        g, fi, n_inl, frac, inliers, match_tgt, T0, maha = hit
        fj = kfs[n]
        rel_T, rel_cov = _timed("refine_s", lambda: _refine_pair(
            db.links[fi], db.links[fj], inliers, match_tgt, T0, calib,
            max_landmarks=cfg.bundle.max_landmarks,
        ))
        closures.append(
            Closure(
                kf_i=g, kf_j=n, frame_i=fi, frame_j=fj,
                num_inliers=n_inl, inlier_frac=frac,
                rel_T=rel_T, rel_cov=rel_cov, mahalanobis=maha,
            )
        )
        pg.add_edge(g, n, rel_T, rel_cov, loop=True)
        spec.clear()  # the posterior changed; discard speculation
        if reoptimize_every:
            _timed("reopt_s", pg.optimize)
            D = _timed("gate_s", all_pairs_gate)
            tm["gate_refreshes"] += 1

    def commit_from_back(deferred):
        """Leaving a familiar segment: re-verify the deferred keyframes in
        reverse order and commit the FIRST that passes (the reference
        commits exactly one closure per familiar segment, from the back —
        loop_closure.py:334-347).

        Speculation runs BACKWARD here, in blocks of SPEC_Q: the forward
        speculate() would cover keyframes the walk has already passed, so
        every step would miss the cache and pay a full device call with
        one useful lane (observed: ~100 extra verify calls at reference
        scale)."""
        nonlocal key
        rev = list(reversed(deferred))
        for s in range(0, len(rev), SPEC_Q):
            blk = rev[s : s + SPEC_Q]
            if any(n_ not in spec for n_ in blk):
                key, sub = jax.random.split(key)
                speculate_list(blk, sub)
            for n_ in blk:
                hit = verify_one(n_)
                if hit is not None:
                    commit(n_, hit)
                    return

    # ---- scan (reference find_loops state machine, :311-349) -------------
    # While traversing a familiar segment (consecutive keyframes that keep
    # gating onto old keyframes after an accepted closure), further
    # closures are deferred; on leaving the segment exactly one deferred
    # closure (from the back) is committed. One deviation from the
    # reference, documented: the reference only resets its familiar flag
    # when the deferred list is non-empty (:337-349), which lets the flag
    # leak across isolated closures; here the flag resets whenever a
    # keyframe has no gated candidates (the intended semantics).
    familiar = False
    deferred: list[int] = []
    for n in range(lc.keyframe_gap, N):
        d, good = gated(n)
        if len(good) == 0:
            if deferred:
                commit_from_back(deferred)
            familiar = False
            deferred = []
            continue
        if familiar:
            deferred.append(n)
            continue
        hit = verify_one(n)
        if hit is not None:
            commit(n, hit)
            familiar = True
    if deferred:  # sequence ended inside a familiar segment
        commit_from_back(deferred)

    return closures


def save_closures(closures: list, path) -> None:
    """Closure list as one npz (the reference pickles the whole loop-closed
    pose graph, project.py:84-91; here closures are their own artifact so
    the driver can reload them without re-verifying)."""
    np.savez_compressed(
        str(path),
        kf_i=np.asarray([c.kf_i for c in closures], np.int32),
        kf_j=np.asarray([c.kf_j for c in closures], np.int32),
        frame_i=np.asarray([c.frame_i for c in closures], np.int32),
        frame_j=np.asarray([c.frame_j for c in closures], np.int32),
        num_inliers=np.asarray([c.num_inliers for c in closures], np.int32),
        inlier_frac=np.asarray([c.inlier_frac for c in closures], np.float32),
        rel_T=np.stack([c.rel_T for c in closures]) if closures
        else np.zeros((0, 4, 4), np.float32),
        rel_cov=np.stack([c.rel_cov for c in closures]) if closures
        else np.zeros((0, 6, 6), np.float32),
        mahalanobis=np.asarray([c.mahalanobis for c in closures],
                               np.float32),
    )


def load_closures(path) -> list:
    with np.load(str(path)) as z:
        return [
            Closure(
                kf_i=int(z["kf_i"][i]), kf_j=int(z["kf_j"][i]),
                frame_i=int(z["frame_i"][i]), frame_j=int(z["frame_j"][i]),
                num_inliers=int(z["num_inliers"][i]),
                inlier_frac=float(z["inlier_frac"][i]),
                rel_T=z["rel_T"][i], rel_cov=z["rel_cov"][i],
                mahalanobis=float(z["mahalanobis"][i]),
            )
            for i in range(len(z["kf_i"]))
        ]
