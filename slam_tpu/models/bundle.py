"""Keyframe selection and windowed bundle adjustment over the track store.

Reference surface: final_project/backend/GTSam/bundle.py —
``extract_keyframes`` (:227-287), ``create_single_bundle`` (:82-171),
``optimize_graph`` (:199-211), ``get_all_bundles`` (:309-338). The batched
re-design replaces the sequential per-window GTSAM loop with:

  1. host-side keyframe selection + window construction into ONE padded
     SoA batch (static shapes: max_poses / max_landmarks / max_obs);
  2. a single vmapped (and mesh-shardable, see parallel/sharded_ba.py)
     LM+Schur solve over all windows at once (ops/ba.py);
  3. batched covariance extraction for the pose graph.

Note on the reference quirk (SURVEY.md §7.3): the reference's keyframe
distance criterion reads ground-truth extrinsics (bundle.py:303-306). Here
the default is the frontend's *estimated* trajectory; pass ``T_dist`` to
reproduce the GT-driven behavior.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..config import BundleConfig, KeyframeConfig, SlamConfig
from ..ops import ba
from ..utils import metrics
from .trackstore import NO_ID, TrackStore


# ---------------------------------------------------------------------------
# keyframe selection (host; cheap O(F) scan)
# ---------------------------------------------------------------------------

def select_keyframes(
    db: TrackStore,
    T_w2c: np.ndarray,
    cfg: KeyframeConfig = KeyframeConfig(),
    T_dist: np.ndarray | None = None,
    start: int = 0,
) -> list[int]:
    """Greedy keyframe cut, reference criteria (bundle.py:233-239):
    advance from the current keyframe until distance > max_dist_m, or
    track survival < min_track_survival, or accumulated rotation >
    max_angle_deg, or gap == max_gap; never cut before min_gap.

    ``start`` begins the scan at a given frame (used by the stage-overlap
    scheduler to resume from the last finalized keyframe; the greedy cut
    is prefix-stable, so resuming reproduces the full-sequence cuts)."""
    F = db.num_frames
    Td = T_w2c if T_dist is None else T_dist
    centers = metrics.camera_centers(Td)
    kfs = [start]
    k = start
    while k < F - 1:
        k_tracks = db.track_ids[k]
        k_set = k_tracks[k_tracks != NO_ID]
        n0 = max(len(k_set), 1)
        cut = None
        for f in range(k + 1, F):
            gap = f - k
            if gap < cfg.min_gap:
                continue
            dist = float(np.linalg.norm(centers[f] - centers[k]))
            ang = float(
                metrics.rotation_error_deg(Td[f : f + 1], Td[k : k + 1])[0]
            )
            f_tracks = db.track_ids[f]
            surv = len(np.intersect1d(k_set, f_tracks[f_tracks != NO_ID])) / n0
            if (
                gap >= cfg.max_gap
                or dist > cfg.max_dist_m
                or surv < cfg.min_track_survival
                or ang > cfg.max_angle_deg
            ):
                cut = f
                break
        if cut is None:
            cut = F - 1
        if cut <= k:
            cut = min(k + cfg.min_gap, F - 1)
        kfs.append(cut)
        k = cut
        if cut >= F - 1:
            break
    return kfs


# ---------------------------------------------------------------------------
# window construction (host -> padded SoA batch)
# ---------------------------------------------------------------------------

@dataclass
class BundleBatch:
    """B windows padded to static shapes, ready for the vmapped solver."""

    poses0: np.ndarray      # (B, P, 4, 4) initial T_win2cam
    points0: np.ndarray     # (B, L, 3)
    cam_idx: np.ndarray     # (B, M)
    lm_idx: np.ndarray      # (B, M)
    meas: np.ndarray        # (B, M, 3)
    w: np.ndarray           # (B, M)
    n_poses: np.ndarray     # (B,) real pose count per window
    frames: np.ndarray      # (B, P) global frame id per pose row (-1 pad)
    track_of_lm: np.ndarray  # (B, L) global track id per landmark row (-1 pad)
    keyframes: list[int]
    obs_dropped: int = 0    # observations cut by max_obs capacity (all windows)
    obs_total: int = 0      # observations offered before the capacity cut
    # windows that overflowed max_obs/max_landmarks, with their FULL
    # (uncut) observation sets — the TP mega-bundle re-solve inputs
    # (run_bundles routes them when a mesh is present). Transient: not
    # serialized; each entry is a dict(bi, tracks, trs, frs, slots).
    overflow: list = field(default_factory=list)

    @property
    def num_windows(self) -> int:
        return self.poses0.shape[0]


def build_windows(
    db: TrackStore,
    T_w2c: np.ndarray,
    keyframes: list[int],
    cfg: BundleConfig = BundleConfig(),
    sigma_growth: float = 1.0,
) -> BundleBatch:
    """Construct all keyframe windows as one padded batch.

    Mirrors create_single_bundle (reference bundle.py:82-171):
      * window frame = first keyframe's camera; initial in-window poses are
        the frontend's chained relative transforms (the reference re-runs
        PnP inside the window, bundle.py:35-79 — we reuse the frontend
        estimates, same quantity);
      * landmarks initialized by stereo backprojection at their best
        (max-disparity) observation in the window (reference uses the last
        frame, bundle.py:146-157);
      * per-observation weight 1/(sigma * growth^dist). The reference grows
        sigma 1.5x per frame away from the triangulation frame
        (bundle.py:160-161); empirically that *downweights exactly the
        long-baseline observations that constrain the window pose* and
        degrades accuracy, so the default here is uniform weights
        (growth=1.0). Pass sigma_growth=1.5 to reproduce the reference.
    """
    B = len(keyframes) - 1
    P, L, M = cfg.max_poses, cfg.max_landmarks, cfg.max_obs
    poses0 = np.tile(np.eye(4, dtype=np.float32), (B, P, 1, 1))
    points0 = np.zeros((B, L, 3), np.float32)
    cam_idx = np.zeros((B, M), np.int32)
    lm_idx = np.zeros((B, M), np.int32)
    meas = np.zeros((B, M, 3), np.float32)
    w = np.zeros((B, M), np.float32)
    n_poses = np.zeros(B, np.int32)
    frames_arr = np.full((B, P), -1, np.int32)
    track_of_lm = np.full((B, L), -1, np.int32)

    # One frame-sorted view of the CSR arrays (they are (track, frame)
    # sorted), so each window's entries come from two searchsorted cuts
    # instead of a boolean scan over ALL links per window — the scan was
    # O(windows x total_links) and dominated the bundles stage at
    # reference scale (652 windows x 2.9M links). The stable sort keeps
    # entries track-sorted within each frame, and the per-window
    # (track, frame) re-sort below reproduces the original entry order
    # exactly.
    order_f = np.argsort(db.fr_sorted, kind="stable")
    fr_f = db.fr_sorted[order_f]
    tr_f = db.tr_sorted[order_f]
    slot_f = db.slot_sorted[order_f]

    def _rows_of(values, table):
        """Vectorized index-of: rows of ``values`` in (possibly unsorted)
        ``table``; every value must be present."""
        sidx = np.argsort(table, kind="stable")
        return sidx[np.searchsorted(table, values, sorter=sidx)].astype(
            np.int64)

    total_obs_dropped = 0
    total_obs_offered = 0
    overflow_specs: list[dict] = []
    for bi in range(B):
        k0, k1 = keyframes[bi], keyframes[bi + 1]
        if k1 - k0 > P - 1:
            # never truncate silently: a window cut at k0+P-1 would make
            # rel_T/rel_cov describe the wrong frame and corrupt every
            # downstream pose-graph edge
            raise ValueError(
                f"keyframe gap {k1 - k0} (window {bi}: {k0}->{k1}) exceeds "
                f"BundleConfig.max_poses-1 = {P - 1}; raise max_poses or "
                f"lower KeyframeConfig.max_gap"
            )
        n = k1 - k0 + 1
        n_poses[bi] = n
        frames_arr[bi, :n] = np.arange(k0, k1 + 1)
        # initial poses in window frame
        poses0[bi, :n] = T_w2c[k0 : k1 + 1] @ np.linalg.inv(T_w2c[k0])[None]

        # tracks with >= 2 obs inside the window
        a = np.searchsorted(fr_f, k0, side="left")
        b = np.searchsorted(fr_f, k1, side="right")
        sub = np.lexsort((fr_f[a:b], tr_f[a:b]))  # back to (track, frame)
        trs = tr_f[a:b][sub]
        frs = fr_f[a:b][sub]
        slots = slot_f[a:b][sub]
        uniq, counts = np.unique(trs, return_counts=True)
        good = uniq[counts >= 2]
        n_full_obs = int(counts[counts >= 2].sum())
        if len(good) > L or n_full_obs > M:
            # record the window's FULL problem before any capacity cut:
            # run_bundles re-solves it landmark-sharded over the mesh
            # (parallel/tp_megabundle.py) when one is available — the
            # no-drop path the reference gets for free from dynamic
            # factor graphs (bundle.py:129-169)
            keep_full = np.isin(trs, good)
            overflow_specs.append({
                "bi": bi, "tracks": good.copy(),
                "trs": trs[keep_full].copy(), "frs": frs[keep_full].copy(),
                "slots": slots[keep_full].copy(),
            })
        if len(good) > L:
            # keep the longest tracks (stability)
            c = counts[counts >= 2]
            good = good[np.argsort(-c)[:L]]
        track_of_lm[bi, : len(good)] = good

        keep = np.isin(trs, good)
        trs, frs, slots = trs[keep], frs[keep], slots[keep]
        total_obs_offered += len(trs)
        if len(trs) > M:
            # capacity overflow: keep the observations of the longest
            # in-window tracks (they constrain the window pose best), never
            # an arbitrary array prefix; count and report the drop. The
            # reference keeps every factor (bundle.py:129-169) — this is the
            # static-shape price, paid for the least informative obs first.
            rows_lm = _rows_of(trs, good)
            cnt = np.zeros(len(good), np.int64)
            np.add.at(cnt, rows_lm, 1)
            order = np.lexsort((frs, trs, -cnt[rows_lm]))
            keep_rows = np.sort(order[:M])
            total_obs_dropped += len(trs) - M
            trs, frs, slots = trs[keep_rows], frs[keep_rows], slots[keep_rows]
            # a track cut below 2 obs no longer constrains anything
            u2, c2 = np.unique(trs, return_counts=True)
            bad = u2[c2 < 2]
            if len(bad):
                k2 = ~np.isin(trs, bad)
                total_obs_dropped += int((~k2).sum())
                trs, frs, slots = trs[k2], frs[k2], slots[k2]
        mrows = len(trs)
        li = _rows_of(trs, good).astype(np.int32)
        ci = (frs - k0).astype(np.int32)
        links = db.links[frs, slots]  # (m, 3)
        cam_idx[bi, :mrows] = ci
        lm_idx[bi, :mrows] = li
        meas[bi, :mrows] = links

        # landmark init: backproject at the max-disparity observation
        # (group argmax; among equal disparities the FIRST row wins, so
        # sort each group by descending row as the final key — lexsort is
        # stable and takes the last entry per group)
        disp = links[:, 0] - links[:, 1]
        init_frame = np.full(len(good), -1, np.int64)
        best_disp = np.full(len(good), -1.0)
        best_row = np.zeros(len(good), np.int64)
        if mrows:
            g_order = np.lexsort(
                (-np.arange(mrows, dtype=np.int64), disp, li))
            li_s = g_order[np.r_[li[g_order][1:] != li[g_order][:-1], True]]
            # li_s: one row per landmark group = max-disp, first-row tie
            keep_pos = disp[li_s] > -1.0  # matches the loop's > sentinel
            rows_sel = li_s[keep_pos]
            best_disp[li[rows_sel]] = disp[rows_sel]
            best_row[li[rows_sel]] = rows_sel
            init_frame[li[rows_sel]] = ci[rows_sel]
        # weights: 1/growth^|frame - init_frame|
        dist_from_init = np.abs(ci - init_frame[li])
        w[bi, :mrows] = (1.0 / cfg.meas_sigma_px) * (
            sigma_growth ** (-dist_from_init.astype(np.float32))
        )
        # store rows used to init landmarks (resolved after calib known)
        points0[bi, : len(good), 0] = best_row  # temp: row index
        points0[bi, : len(good), 1] = -12345.0  # marker

    if total_obs_dropped:
        import warnings

        warnings.warn(
            f"build_windows: dropped {total_obs_dropped} observations over "
            f"{B} windows (max_obs={M} capacity); kept the longest-track "
            f"observations. Raise BundleConfig.max_obs to keep them all.",
            stacklevel=2,
        )
    return BundleBatch(
        poses0=poses0,
        points0=points0,
        cam_idx=cam_idx,
        lm_idx=lm_idx,
        meas=meas,
        w=w,
        n_poses=n_poses,
        frames=frames_arr,
        track_of_lm=track_of_lm,
        keyframes=list(keyframes),
        obs_dropped=int(total_obs_dropped),
        obs_total=int(total_obs_offered),
        overflow=overflow_specs,
    )


def init_landmarks(batch: BundleBatch, calib) -> None:
    """Resolve landmark initializations (stereo backprojection at the
    chosen observation, mapped into the window frame).

    Pure host NumPy on purpose: the math is (B, L) tiny-vector algebra
    (~300k points), and dispatching it as unjitted jnp ops cost one
    device round-trip *per primitive*, which at reference scale costs
    minutes against milliseconds here. Formulas
    mirror ops/stereo.backproject (z = fx*b/disparity) and the SE(3)
    inverse X_win = R^T (pc - t).
    """
    B, L = batch.points0.shape[:2]
    rows = batch.points0[..., 0].astype(np.int64)  # (B, L) obs row per lm
    valid = batch.points0[..., 1] == -12345.0
    links = np.take_along_axis(batch.meas, rows[..., None], axis=1)  # (B,L,3)
    cams = np.take_along_axis(batch.cam_idx, rows.astype(np.int32), axis=1)
    from ..ops.stereo import backproject_np

    pc = backproject_np(calib, links)
    # transform camera-frame point to window frame: X = T_cam^-1 * pc
    T = batch.poses0[np.arange(B)[:, None], cams]  # (B, L, 4, 4)
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Xw = np.einsum("blji,blj->bli", R, pc - t)  # R^T (pc - t)
    batch.points0[:] = np.where(valid[..., None],
                                Xw.astype(np.float32), 0.0)


# ---------------------------------------------------------------------------
# batched optimization driver
# ---------------------------------------------------------------------------

@dataclass
class BundleResult:
    poses: np.ndarray        # (B, P, 4, 4) optimized T_win2cam
    points: np.ndarray       # (B, L, 3)
    w: np.ndarray            # (B, M) post-pruning weights
    cost: np.ndarray         # (B,) final half-SSE
    cost0: np.ndarray        # (B,) initial half-SSE (pre-optimization)
    num_obs: np.ndarray      # (B,) active observations after pruning
    rel_T: np.ndarray        # (B, 4, 4) kf_i -> kf_{i+1} extrinsic
    rel_cov: np.ndarray      # (B, 6, 6) covariance of rel_T (window frame)
    T_w2c_keyframes: np.ndarray  # (B+1, 4, 4) chained global keyframe poses
    keyframes: list[int]
    n_poses: np.ndarray
    frames: np.ndarray
    track_of_lm: np.ndarray
    # factor data, kept for the analysis/debug probes (reference keeps the
    # whole gtsam graph per bundle; analysis.py:214-283 projection errors,
    # ex5.py:498-593 worst-factor visualization)
    meas: np.ndarray | None = None      # (B, M, 3) stereo measurements
    cam_idx: np.ndarray | None = None   # (B, M)
    lm_idx: np.ndarray | None = None    # (B, M)
    points0: np.ndarray | None = None   # (B, L, 3) initial landmarks
    obs_dropped: int = 0  # capacity-cut observations (build_windows)
    obs_total: int = 0    # observations offered before the capacity cut


def optimize_windows(
    batch: BundleBatch,
    calib,
    cfg: BundleConfig = BundleConfig(),
    device_batch: int = 64,
    mesh=None,
) -> BundleResult:
    """Optimize all windows with the vmapped LM solver, then extract the
    per-window relative pose + covariance and the chained global keyframe
    trajectory (reference get_all_bundles + pose-graph inputs).

    With ``mesh`` the window axis is sharded across the devices
    (parallel/sharded_ba.py); otherwise windows run in ``device_batch``
    groups on the default device.
    """
    calib = jnp.asarray(calib, jnp.float32)
    B = batch.num_windows

    if mesh is not None:
        from ..parallel import sharded_ba

        poses, points, w, cost, cost0, rel_T, rel_cov = (
            sharded_ba.optimize_windows_sharded(
                batch, calib, mesh, iters=cfg.lm_iters,
                min_depth=cfg.min_depth, max_depth=cfg.max_depth,
                huber_delta=cfg.huber_delta_px,
            )
        )
        return _assemble_bundle_result(
            batch, poses, points, w, cost, cost0, rel_T, rel_cov
        )
    out_poses, out_points, out_w, out_cost, out_cov = [], [], [], [], []
    out_cost0 = []
    cost0_fn = jax.vmap(
        lambda p0, x0, ci, li, ms, ww: ba._cost(p0, x0, ci, li, ms, ww, calib)
    )

    solver = jax.vmap(
        lambda p0, x0, ci, li, ms, ww: ba.optimize_bundle_pruned(
            p0, x0, ci, li, ms, ww, calib,
            iters=cfg.lm_iters,
            min_depth=cfg.min_depth, max_depth=cfg.max_depth,
            huber_delta=cfg.huber_delta_px,
        )
    )
    cov_fn = jax.vmap(
        lambda p, x, ci, li, ms, ww: ba.pose_covariances(
            p, x, ci, li, ms, ww, calib
        )
    )

    def submit(s):
        """Upload one window slice and dispatch solve/cov/cost0 (all
        async); start the host copies so results stream back while later
        slices compute. Materialization happens one slice behind."""
        e = min(s + device_batch, B)
        # pad the tail slice to device_batch (zero-weight dummy windows):
        # a smaller final slice would recompile solver/cov/cost for its
        # own shape — one extra multi-minute cold compile per run
        pad = device_batch - (e - s) if B > device_batch else 0

        def sl(a):
            x = a[s:e]
            if pad:
                x = np.concatenate(
                    [x, np.repeat(x[-1:], pad, axis=0)], axis=0
                )
            return jnp.asarray(x)

        p0 = sl(batch.poses0)
        x0 = sl(batch.points0)
        ci = sl(batch.cam_idx)
        li = sl(batch.lm_idx)
        ms = sl(batch.meas)
        ww = sl(batch.w)
        if pad:
            ww = ww.at[e - s :].set(0.0)  # dummy windows carry no residuals
        poses, points, w2, cost = solver(p0, x0, ci, li, ms, ww)
        covs = cov_fn(poses, points, ci, li, ms, w2)
        cost0 = cost0_fn(p0, x0, ci, li, ms, ww)
        devs = (cost0, poses, points, w2, cost, covs)
        for d in devs:
            d.copy_to_host_async()
        return e - s, devs

    def materialize(pend):
        n, (cost0, poses, points, w2, cost, covs) = pend
        out_cost0.append(np.asarray(cost0)[:n])
        out_poses.append(np.asarray(poses)[:n])
        out_points.append(np.asarray(points)[:n])
        out_w.append(np.asarray(w2)[:n])
        out_cost.append(np.asarray(cost)[:n])
        out_cov.append(np.asarray(covs)[:n])

    pend = None
    for s in range(0, B, device_batch):
        cur = submit(s)
        if pend is not None:
            materialize(pend)
        pend = cur
    materialize(pend)

    poses = np.concatenate(out_poses)
    points = np.concatenate(out_points)
    w = np.concatenate(out_w)
    cost = np.concatenate(out_cost)
    cost0 = np.concatenate(out_cost0)
    covs = np.concatenate(out_cov)

    last = batch.n_poses - 1  # (B,)
    rel_T = poses[np.arange(B), last]            # (B, 4, 4)
    rel_cov = covs[np.arange(B), last]           # (B, 6, 6)
    return _assemble_bundle_result(
        batch, poses, points, w, cost, cost0, rel_T, rel_cov
    )


def _assemble_bundle_result(batch, poses, points, w, cost, cost0, rel_T,
                            rel_cov) -> BundleResult:
    B = batch.num_windows
    # chain keyframe poses: T_w2c[kf_{i+1}] = rel_T[i] @ T_w2c[kf_i]
    T_kf = np.zeros((B + 1, 4, 4), np.float32)
    T_kf[0] = np.eye(4)
    for i in range(B):
        T_kf[i + 1] = rel_T[i] @ T_kf[i]

    return BundleResult(
        poses=poses, points=points, w=w, cost=cost, cost0=cost0,
        num_obs=(w > 0).sum(axis=1),
        rel_T=rel_T, rel_cov=rel_cov, T_w2c_keyframes=T_kf,
        keyframes=batch.keyframes, n_poses=batch.n_poses,
        frames=batch.frames, track_of_lm=batch.track_of_lm,
        meas=batch.meas, cam_idx=batch.cam_idx, lm_idx=batch.lm_idx,
        points0=batch.points0.copy(),
        obs_dropped=batch.obs_dropped, obs_total=batch.obs_total,
    )


def save_bundles(res: BundleResult, path) -> None:
    """Serialize a BundleResult to npz (replaces the reference's pickled
    bundle list, gtsam_utils.py:265-271 / project.py stage cache)."""
    np.savez_compressed(
        str(path),
        poses=res.poses, points=res.points, w=res.w,
        cost=res.cost, cost0=res.cost0, num_obs=res.num_obs,
        rel_T=res.rel_T, rel_cov=res.rel_cov,
        T_w2c_keyframes=res.T_w2c_keyframes,
        keyframes=np.asarray(res.keyframes),
        n_poses=res.n_poses, frames=res.frames,
        track_of_lm=res.track_of_lm,
        obs_dropped=np.int64(res.obs_dropped),
        obs_total=np.int64(res.obs_total),
        **{k: getattr(res, k) for k in ("meas", "cam_idx", "lm_idx", "points0")
           if getattr(res, k) is not None},
    )


def load_bundles(path) -> BundleResult:
    z = np.load(str(path))
    opt = {k: z[k] for k in ("meas", "cam_idx", "lm_idx", "points0")
           if k in z.files}
    return BundleResult(
        poses=z["poses"], points=z["points"], w=z["w"],
        cost=z["cost"], cost0=z["cost0"], num_obs=z["num_obs"],
        rel_T=z["rel_T"], rel_cov=z["rel_cov"],
        T_w2c_keyframes=z["T_w2c_keyframes"],
        keyframes=[int(k) for k in z["keyframes"]],
        n_poses=z["n_poses"], frames=z["frames"],
        track_of_lm=z["track_of_lm"],
        obs_dropped=int(z["obs_dropped"]) if "obs_dropped" in z.files else 0,
        obs_total=int(z["obs_total"]) if "obs_total" in z.files else 0,
        **opt,
    )


def reoptimize_overflow_tp(
    res: BundleResult,
    batch: BundleBatch,
    db: TrackStore,
    calib,
    cfg: BundleConfig,
    mesh,
) -> BundleResult:
    """Re-solve capacity-overflowed windows with the landmark-sharded TP
    mega-bundle (parallel/tp_megabundle.py) at FULL observation count.

    The dense batched path cuts a window to (max_landmarks, max_obs) to
    keep static shapes; the reference keeps every factor
    (bundle.py:129-169). When a mesh is present, each overflowed window is
    re-solved exactly — landmarks and their observations sharded over the
    devices, one (6P,6P) psum per LM iteration — and its rel_T / rel_cov /
    window poses replace the truncated solve's. ``res.points`` keeps the
    truncated solve's landmarks (static capacity; analysis probes only).
    """
    from jax.sharding import Mesh

    from ..parallel import tp_megabundle as tp

    n_dev = int(np.prod(list(mesh.shape.values())))
    tp_mesh = Mesh(np.asarray(mesh.devices).reshape(-1), ("tp",))
    from ..ops.stereo import backproject_np

    # result arrays may be zero-copy views of device buffers (read-only)
    for name in ("poses", "rel_T", "rel_cov", "cost", "num_obs"):
        arr = np.asarray(getattr(res, name))
        if not arr.flags.writeable:
            setattr(res, name, arr.copy())

    def _rows_of(values, table):
        sidx = np.argsort(table, kind="stable")
        return sidx[np.searchsorted(table, values, sorter=sidx)].astype(
            np.int64)

    for spec in batch.overflow:
        bi = spec["bi"]
        n = int(batch.n_poses[bi])
        k0 = batch.keyframes[bi]
        poses0 = batch.poses0[bi, :n]
        tracks = spec["tracks"]
        li = _rows_of(spec["trs"], tracks).astype(np.int32)
        ci = (spec["frs"] - k0).astype(np.int32)
        links = db.links[spec["frs"], spec["slots"]].astype(np.float32)
        w = np.full(len(li), 1.0 / cfg.meas_sigma_px, np.float32)

        # landmark init: stereo backprojection at the max-disparity
        # observation, mapped to window frame (same as init_landmarks)
        Lf = len(tracks)
        disp = links[:, 0] - links[:, 1]
        order = np.lexsort((-np.arange(len(li)), disp, li))
        last_per = order[np.r_[li[order][1:] != li[order][:-1], True]]
        pts0 = np.zeros((Lf, 3), np.float32)
        pc = backproject_np(calib, links[last_per])
        T = poses0[ci[last_per]]
        Xw = np.einsum("lji,lj->li", T[:, :3, :3], pc - T[:, :3, 3])
        pts0[li[last_per]] = Xw.astype(np.float32)

        parts = tp.partition_megabundle(pts0, ci, li, links, w, n_dev)
        poses, _, cost, _ = tp.optimize_megabundle(
            tp_mesh, poses0, *parts, calib, iters=cfg.lm_iters)
        covs = tp.megabundle_pose_covariances(
            tp_mesh, poses, *parts, calib)
        poses = np.asarray(poses)
        res.poses[bi, :n] = poses
        res.rel_T[bi] = poses[n - 1]
        res.rel_cov[bi] = covs[n - 1]
        res.cost[bi] = cost
        res.num_obs[bi] = len(li)

    # re-chain the global keyframe trajectory through the updated edges
    B = res.rel_T.shape[0]
    T_kf = np.zeros((B + 1, 4, 4), np.float32)
    T_kf[0] = np.eye(4)
    for i in range(B):
        T_kf[i + 1] = res.rel_T[i] @ T_kf[i]
    res.T_w2c_keyframes = T_kf
    return res


def run_bundles(
    db: TrackStore,
    T_w2c: np.ndarray,
    calib,
    cfg: SlamConfig = SlamConfig(),
    mesh=None,
) -> BundleResult:
    """Full backend stage 2 (reference project.py:41-62): keyframes ->
    windows -> batched LM (window axis mesh-sharded when ``mesh`` given).
    Windows too large for the static (max_landmarks, max_obs) capacity are
    re-solved at full size on the TP mega-bundle path when a mesh is
    present (cfg.bundle.tp_overflow)."""
    kfs = select_keyframes(db, T_w2c, cfg.keyframes)
    batch = build_windows(db, T_w2c, kfs, cfg.bundle)
    init_landmarks(batch, calib)
    res = optimize_windows(batch, calib, cfg.bundle, mesh=mesh)
    if batch.overflow and mesh is not None and cfg.bundle.tp_overflow:
        res = reoptimize_overflow_tp(res, batch, db, calib, cfg.bundle,
                                     mesh)
    return res


def frame_poses_from_bundles(res: BundleResult, num_frames: int) -> np.ndarray:
    """Global per-frame extrinsics from the optimized windows (in-window
    poses chained through keyframe anchors) — the reference's
    'bundle-adjusted trajectory' (analysis.py:931-958)."""
    T = np.tile(np.eye(4, dtype=np.float32), (num_frames, 1, 1))
    B = res.poses.shape[0]
    for bi in range(B):
        T_anchor = res.T_w2c_keyframes[bi]
        n = int(res.n_poses[bi])
        for pi in range(n):
            f = int(res.frames[bi, pi])
            T[f] = res.poses[bi, pi] @ T_anchor
    return T
