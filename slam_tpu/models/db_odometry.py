"""Recompute the PnP trajectory from a track store alone.

Reference surface: final_project/backend/GTSam/gtsam_utils.py —
``calc_rel_T`` (:107-139, per-consecutive-frame solvePnP on common
tracks), ``calculate_relative_transformation`` (:92-104),
``calculate_global_transformation`` (:142-152) and
``calculate_all_pnp_rel_transformation`` (:154-160) — used by the analysis
suite to rebuild the PnP trajectory from a deserialized DB
(analysis.py:442-448).

Batched re-design: correspondences between consecutive frames come from the
track-id arrays with one argsort-based join per frame (vectorized numpy),
then ALL frame pairs are solved simultaneously by the batched Gauss-Newton
pose refiner (the correspondences are already RANSAC-curated tracks, so no
re-RANSAC is needed — matching the reference's direct solvePnP choice).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import epnp, se3, stereo
from .trackstore import NO_ID, TrackStore


def consecutive_correspondences(db: TrackStore, max_corr: int = 512):
    """For every frame pair (f, f+1): padded arrays of common-track links.

    Returns (prev_links (F-1, C, 3), cur_links (F-1, C, 3), valid (F-1, C)).
    """
    F, K = db.track_ids.shape
    C = max_corr
    prev_links = np.zeros((F - 1, C, 3), np.float32)
    cur_links = np.zeros((F - 1, C, 3), np.float32)
    valid = np.zeros((F - 1, C), bool)
    for f in range(F - 1):
        ta = db.track_ids[f]
        tb = db.track_ids[f + 1]
        ia = np.nonzero(ta != NO_ID)[0]
        ib = np.nonzero(tb != NO_ID)[0]
        common, ca, cb = np.intersect1d(ta[ia], tb[ib],
                                        return_indices=True)
        n = min(len(common), C)
        if n == 0:
            continue
        prev_links[f, :n] = db.links[f, ia[ca[:n]]]
        cur_links[f, :n] = db.links[f + 1, ib[cb[:n]]]
        valid[f, :n] = True
    return prev_links, cur_links, valid


def pnp_trajectory_from_db(
    db: TrackStore, calib, max_corr: int = 512, gn_iters: int = 10
) -> np.ndarray:
    """Global per-frame extrinsics (F, 4, 4) rebuilt from the DB.

    Per pair: triangulate the previous frame's links, Gauss-Newton the
    relative pose on the stereo reprojection of the current frame's links
    (batched over ALL pairs at once), then chain with an associative scan
    (reference chains in a Python loop, gtsam_utils.py:142-152).
    """
    calib_j = jnp.asarray(calib, jnp.float32)
    prev_links, cur_links, valid = consecutive_correspondences(db, max_corr)

    @jax.jit
    def solve_all(prev_links, cur_links, valid):
        def one(pl, cl, v):
            pw = stereo.backproject(calib_j, pl)
            pc = stereo.backproject(calib_j, cl)
            w = v.astype(jnp.float32)
            # closed-form seed + GN polish (same stack as the frontend)
            T0, ok = epnp.rigid_align(pw, pc, w)
            T = epnp.refine_pose_gn(T0, pw, cl, w, calib_j, iters=gn_iters)
            good = ok & (jnp.sum(v) >= 3) & jnp.isfinite(T).all()
            return jnp.where(good, T, jnp.eye(4, dtype=T.dtype))

        T_rel = jax.vmap(one)(prev_links, cur_links, valid)
        with jax.default_matmul_precision("float32"):
            chain = jax.lax.associative_scan(lambda a, b: b @ a, T_rel)
        return T_rel, chain

    _, chain = solve_all(
        jnp.asarray(prev_links), jnp.asarray(cur_links), jnp.asarray(valid)
    )
    F = db.num_frames
    out = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    out[1:] = np.asarray(chain)
    return out
