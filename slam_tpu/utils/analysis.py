"""Analysis / evaluation suite: plots + printed statistics.

Reference surface: final_project/analysis.py (1364 LoC, 25 named plots,
registry :27-67, driver run_analysis :1277-1362). This module emits an
artifact-for-artifact counterpart of every entry of the reference
registry (same file names), regenerated from the pipeline's SoA results:

  num_matches            (ref :135-152)   inliers_percent     (ref :155-165)
  connectivity           (ref :109-132)   histogram           (ref :168-183)
  trajectory             (ref :451-487)   mean_factor_error   (ref :186-211)
  median_projection_error              (ref :258-283)
  median_projection_vs_distance_{PnP,bundle}  (ref :340-439)
  abs_{PnP,poseGraph,poseGraph_LC}_{locations,angle}  (ref :508-670)
  rel_error_{norm,angle}_PnP_bundle    (ref :683-796)
  rel_error_{norm,angle}_bundle        (ref :683-796, bundle-only pair)
  rel_sub_section_error_{norm,angle}_{PnP,bundle}  (ref :801-920, :961-1075)
  uncertainty_{location,rotation}      (ref :1125-1263)

plus slam_tpu extras (loops.png, disparity_hist.png) and the reference's
debug probes: worst-factor visualization (VAN_ex/code/ex5.py:498-593) and
loop-match visualization (VAN_ex/code/ex7.py:767-827).

All numeric results are also returned as one dict (and written to
analysis.json) — the regression surface against BASELINE.md.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from . import metrics

# the reference's plot registry, analysis.py:27-36 — every name below is
# emitted (abs_poseGraph_LC_* only when closures exist)
ARTIFACTS = [
    "num_matches", "inliers_percent", "connectivity", "histogram",
    "trajectory", "mean_factor_error", "median_projection_error",
    "median_projection_vs_distance_PnP",
    "median_projection_vs_distance_bundle",
    "abs_PnP_locations", "abs_PnP_angle",
    "abs_poseGraph_locations", "abs_poseGraph_angle",
    "abs_poseGraph_LC_locations", "abs_poseGraph_LC_angle",
    "rel_error_norm_PnP_bundle", "rel_error_angle_PnP_bundle",
    "rel_error_norm_bundle", "rel_error_angle_bundle",
    "rel_sub_section_error_norm_PnP", "rel_sub_section_error_angle_PnP",
    "rel_sub_section_error_norm_bundle", "rel_sub_section_error_angle_bundle",
    "uncertainty_location", "uncertainty_rotation",
]


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _savefig(plt, out_dir: Path, name: str):
    plt.tight_layout()
    plt.savefig(Path(out_dir) / name, dpi=110)
    plt.close()


# Agg rasterization on this class of host costs ~0.5 ms per polyline point
# (measured; linear in point count), so full 3360-frame curves dominate the
# analysis stage's wall-clock. An 8-inch/110-dpi axes has ~880 pixel
# columns: downsampling to the per-column min/max envelope is visually
# lossless (every spike survives) and caps the draw cost. Numeric outputs
# (analysis.json) are computed from the full arrays, never the decimated
# ones.
_ENVELOPE_COLS = 700


def _envelope(x, y, cols: int = _ENVELOPE_COLS):
    """Min-max per-column downsample of a curve for plotting.

    Returns (x, y) unchanged when already small; otherwise 2*cols points
    carrying each column's min and max."""
    x = np.asarray(x)
    y = np.asarray(y)
    n = y.shape[0]
    if n <= 2 * cols:
        return x, y
    edges = np.linspace(0, n, cols + 1).astype(int)
    # Per-column argmin/argmax so each extreme is emitted at its TRUE x
    # (not the column's first/last x): stable lexsort by (column, value)
    # makes group c occupy sorted positions [edges[c], edges[c+1]), so the
    # group's first/last entries are its argmin/argmax.
    col = np.repeat(np.arange(cols), np.diff(edges))
    order = np.lexsort((y, col))
    imin = order[edges[:-1]]
    imax = order[edges[1:] - 1]
    # NaNs sort last under lexsort; a column that is all-NaN would yield
    # imin==imax pointing at a NaN, which plots as a gap — correct.
    first = np.minimum(imin, imax)
    second = np.maximum(imin, imax)
    xs = np.empty(2 * cols, x.dtype)
    ys = np.empty(2 * cols, y.dtype)
    xs[0::2] = x[first]
    xs[1::2] = x[second]
    ys[0::2] = y[first]
    ys[1::2] = y[second]
    return xs, ys


def _plot_dec(plt, x, y, *args, **kwargs):
    """plt.plot of a per-frame curve, envelope-decimated for draw speed."""
    xd, yd = _envelope(x, y)
    plt.plot(xd, yd, *args, **kwargs)


def _stride(points: np.ndarray, max_pts: int = 1500) -> np.ndarray:
    """Uniform-stride subsample of a trajectory polyline (keeps endpoints)."""
    n = points.shape[0]
    if n <= max_pts:
        return points
    step = int(np.ceil(n / max_pts))
    out = points[::step]
    if (n - 1) % step:
        out = np.concatenate([out, points[-1:]], axis=0)
    return out


# ---------------------------------------------------------------------------
# host-side stereo camera math (analysis never needs the accelerator; eager
# per-op device dispatch would be the scale bottleneck)
# ---------------------------------------------------------------------------

def _np_project(calib, pc):
    """(N, 3) camera-frame points -> (N, 3) stereo (uL, uR, v)."""
    fx, fy, cx, cy, b = [float(v) for v in np.asarray(calib)]
    z = np.where(np.abs(pc[..., 2]) > 1e-9, pc[..., 2], 1e-9)
    uL = fx * pc[..., 0] / z + cx
    uR = fx * (pc[..., 0] - b) / z + cx
    v = fy * pc[..., 1] / z + cy
    return np.stack([uL, uR, v], axis=-1)


def _np_backproject(calib, links):
    """(N, 3) stereo (uL, uR, v) -> (N, 3) camera-frame points."""
    fx, fy, cx, cy, b = [float(v) for v in np.asarray(calib)]
    disp = np.maximum(links[..., 0] - links[..., 1], 1e-6)
    z = fx * b / disp
    x = (links[..., 0] - cx) * z / fx
    y = (links[..., 2] - cy) * z / fy
    return np.stack([x, y, z], axis=-1)


def _transform(T, X):
    """Apply (4,4) or (N,4,4) extrinsics to (N,3) points."""
    return np.einsum("...ij,...j->...i", T[..., :3, :3], X) + T[..., :3, 3]


def _rot_angle_deg(D):
    """Rotation angle of (N,4,4) or (4,4) transform errors, degrees."""
    tr = np.trace(np.asarray(D)[..., :3, :3], axis1=-2, axis2=-1)
    return np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))


# ---------------------------------------------------------------------------
# tracking statistics (ref :70-183)
# ---------------------------------------------------------------------------

def plot_track_stats(out_dir, db):
    plt = _plt()
    lengths = db.track_lengths()
    plt.figure(figsize=(6, 4))
    plt.hist(lengths, bins=np.arange(2, max(lengths.max() + 2, 3)), log=True)
    plt.xlabel("track length [frames]")
    plt.ylabel("count (log)")
    plt.title("Track length histogram")
    _savefig(plt, out_dir, "histogram.png")

    conn = db.connectivity()
    plt.figure(figsize=(8, 3.2))
    _plot_dec(plt, np.arange(len(conn)), conn)
    plt.xlabel("frame")
    plt.ylabel("tracks shared with next frame")
    plt.title("Connectivity")
    _savefig(plt, out_dir, "connectivity.png")

    links = db.link_valid.sum(axis=1)
    plt.figure(figsize=(8, 3.2))
    _plot_dec(plt, np.arange(len(links)), links)
    plt.xlabel("frame")
    plt.ylabel("stereo links")
    plt.title("Matches per frame")
    _savefig(plt, out_dir, "num_matches.png")

    plt.figure(figsize=(8, 3.2))
    _plot_dec(plt, np.arange(len(db.inliers_percent)), db.inliers_percent)
    plt.xlabel("frame")
    plt.ylabel("inliers [%]")
    plt.title("RANSAC inlier percentage")
    _savefig(plt, out_dir, "inliers_percent.png")


# ---------------------------------------------------------------------------
# trajectories + absolute errors (ref :451-670)
# ---------------------------------------------------------------------------

def plot_trajectories(out_dir, T_gt, stages: dict[str, np.ndarray]):
    """x-z overlay of every stage vs ground truth (ref :451-487)."""
    plt = _plt()
    plt.figure(figsize=(7, 6))
    c_gt = _stride(metrics.camera_centers(T_gt))
    plt.plot(c_gt[:, 0], c_gt[:, 2], "k-", lw=2, label="ground truth")
    for name, T in stages.items():
        c = _stride(metrics.camera_centers(T))
        plt.plot(c[:, 0], c[:, 2], lw=1, label=name)
    plt.xlabel("x [m]")
    plt.ylabel("z [m]")
    plt.axis("equal")
    plt.legend()
    plt.title("Trajectory overlay")
    _savefig(plt, out_dir, "trajectory.png")


def plot_abs_errors(out_dir, name, T_est, T_gt, x=None):
    """Per-axis + L2 absolute location error AND rotation-angle error as
    the reference's separate artifact pair abs_<stage>_locations /
    abs_<stage>_angle (ref :508-670)."""
    plt = _plt()
    err = metrics.abs_location_error(T_est, T_gt)
    x = np.arange(err.shape[0]) if x is None else x
    plt.figure(figsize=(8, 4))
    for i, lbl in enumerate(["x", "y", "z", "L2"]):
        _plot_dec(plt, x, err[:, i], label=lbl)
    plt.xlabel("frame")
    plt.ylabel("abs error [m]")
    plt.legend()
    plt.title(f"Absolute location error — {name}")
    _savefig(plt, out_dir, f"abs_{name}_locations.png")

    deg = metrics.rotation_error_deg(T_est, T_gt)
    plt.figure(figsize=(8, 4))
    _plot_dec(plt, x, deg)
    plt.xlabel("frame")
    plt.ylabel("rotation error [deg]")
    plt.title(f"Absolute rotation error — {name}")
    _savefig(plt, out_dir, f"abs_{name}_angle.png")
    return {"mean_l2": float(err[:, 3].mean()),
            "max_l2": float(err[:, 3].max()),
            "mean_deg": float(deg.mean())}


# ---------------------------------------------------------------------------
# relative consecutive-keyframe errors (ref :683-796)
# ---------------------------------------------------------------------------

def plot_rel_error_pairs(out_dir, bundles, T_frontend, T_gt):
    """Relative-pose error between consecutive keyframes for the PnP
    (frontend) and bundle estimates, as the reference's four artifacts:
    rel_error_{norm,angle}_PnP_bundle (both curves) and
    rel_error_{norm,angle}_bundle (bundle only). Ref :683-796."""
    plt = _plt()
    kfs = np.asarray(bundles.keyframes)
    i0, i1 = kfs[:-1], kfs[1:]
    gt_rel = T_gt[i1] @ np.linalg.inv(T_gt[i0])
    pnp_rel = T_frontend[i1] @ np.linalg.inv(T_frontend[i0])
    D_pnp = pnp_rel @ np.linalg.inv(gt_rel)
    D_b = bundles.rel_T @ np.linalg.inv(gt_rel)
    pnp_norm = np.linalg.norm(D_pnp[:, :3, 3], axis=-1)
    b_norm = np.linalg.norm(D_b[:, :3, 3], axis=-1)
    pnp_deg = _rot_angle_deg(D_pnp)
    b_deg = _rot_angle_deg(D_b)
    x = i1

    plt.figure(figsize=(8, 4))
    plt.plot(x, pnp_norm, label="PnP norm error [m]")
    plt.plot(x, b_norm, label="bundle norm error [m]")
    plt.ylabel("error [m]")
    plt.xlabel("keyframe")
    plt.legend()
    plt.grid(True, axis="y", linestyle="--", alpha=0.7)
    plt.title("Relative location error of consecutive keyframes, PnP vs bundle")
    _savefig(plt, out_dir, "rel_error_norm_PnP_bundle.png")

    plt.figure(figsize=(8, 4))
    plt.plot(x, pnp_deg, label="PnP angle error [deg]")
    plt.plot(x, b_deg, label="bundle angle error [deg]")
    plt.ylabel("error [deg]")
    plt.xlabel("keyframe")
    plt.legend()
    plt.grid(True, axis="y", linestyle="--", alpha=0.7)
    plt.title("Relative angle error of consecutive keyframes, PnP vs bundle")
    _savefig(plt, out_dir, "rel_error_angle_PnP_bundle.png")

    plt.figure(figsize=(8, 4))
    plt.plot(x, b_norm, color="red", label="bundle norm error [m]")
    plt.ylabel("error [m]")
    plt.xlabel("keyframe")
    plt.legend()
    plt.grid(True, axis="y", linestyle="--", alpha=0.7)
    plt.title("Relative location error of consecutive keyframes, bundle")
    _savefig(plt, out_dir, "rel_error_norm_bundle.png")

    plt.figure(figsize=(8, 4))
    plt.plot(x, b_deg, color="orange", label="bundle angle error [deg]")
    plt.ylabel("error [deg]")
    plt.xlabel("keyframe")
    plt.legend()
    plt.grid(True, axis="y", linestyle="--", alpha=0.7)
    plt.title("Relative angle error of consecutive keyframes, bundle")
    _savefig(plt, out_dir, "rel_error_angle_bundle.png")

    return {
        "pnp": {"mean_trans_m": float(pnp_norm.mean()),
                "mean_rot_deg": float(pnp_deg.mean())},
        "bundle": {"mean_trans_m": float(b_norm.mean()),
                   "mean_rot_deg": float(b_deg.mean())},
    }


# ---------------------------------------------------------------------------
# KITTI-style sub-section errors (ref :801-920, :961-1075)
# ---------------------------------------------------------------------------

def plot_rel_subsection(out_dir, name, T_est, T_gt, lengths=(100, 400, 800)):
    """Per-start-frame relative error curves over fixed sub-section
    lengths, one norm and one angle artifact per stage (ref :801-920 PnP,
    :961-1075 bundle: a curve per length + overall-mean line)."""
    summary = metrics.relative_subsequence_error(T_est, T_gt, lengths)
    # adapt to short sequences: the reference's 100/400/800-frame sections
    # (analysis.py:801,961) assume seq-00 length; a shorter run still
    # emits the artifact, over the lengths that fit (summary above keeps
    # the reference lengths for numeric comparability)
    F = T_est.shape[0]
    fit = tuple(L for L in lengths if L < F) or (max(2, F // 2),)
    curves = metrics.relative_subsequence_curves(T_est, T_gt, fit)
    if not curves:
        return summary
    plt = _plt()
    Ls = sorted(curves.keys())

    plt.figure(figsize=(8, 4))
    for L in Ls:
        _plot_dec(plt, curves[L]["x"], curves[L]["trans_m_per_m"],
                  label=f"{name} norm err, length {L}")
    mean_all = float(np.mean([curves[L]["trans_m_per_m"].mean() for L in Ls]))
    plt.axhline(mean_all, color="black", linestyle="-.",
                label="mean location error")
    plt.ylabel("norm error [m/m]")
    plt.xlabel("start frame")
    plt.legend()
    plt.grid(True, axis="y", linestyle="--", alpha=0.7)
    plt.title(f"Relative location error vs sub-section length — {name}")
    _savefig(plt, out_dir, f"rel_sub_section_error_norm_{name}.png")

    plt.figure(figsize=(8, 4))
    for L in Ls:
        _plot_dec(plt, curves[L]["x"], curves[L]["rot_deg_per_m"],
                  label=f"{name} angle err, length {L}")
    mean_all = float(np.mean([curves[L]["rot_deg_per_m"].mean() for L in Ls]))
    plt.axhline(mean_all, color="black", linestyle="-.",
                label="mean angle error")
    plt.ylabel("angle error [deg/m]")
    plt.xlabel("start frame")
    plt.legend()
    plt.grid(True, axis="y", linestyle="--", alpha=0.7)
    plt.title(f"Relative angle error vs sub-section length — {name}")
    _savefig(plt, out_dir, f"rel_sub_section_error_angle_{name}.png")
    return summary


# ---------------------------------------------------------------------------
# uncertainty (ref :1125-1263)
# ---------------------------------------------------------------------------

def plot_uncertainty(out_dir, pg_pre, pg_post=None):
    """Log10-determinant of the location / rotation marginal covariance per
    keyframe, with and without loop closures, as the reference's two
    artifacts uncertainty_location / uncertainty_rotation (:1125-1263)."""
    plt = _plt()

    def logdets(pg):
        # on-device reduction: only 2N scalars cross the host link (the
        # full covariance readback was half the analysis stage at scale)
        loc, rot = pg.marginal_logdets()
        return loc[1:] / np.log(10.0), rot[1:] / np.log(10.0)

    loc_pre, rot_pre = logdets(pg_pre)
    has_post = pg_post is not None and pg_post.num_edges > pg_pre.num_edges
    if has_post:
        loc_post, rot_post = logdets(pg_post)
    x = np.asarray(pg_pre.keyframes[1:])

    plt.figure(figsize=(8, 4))
    plt.plot(x, loc_pre, color="blue",
             label="log location uncertainty without loop closures")
    if has_post:
        plt.plot(x, loc_post, color="red",
                 label="log location uncertainty with loop closures")
    plt.ylabel("log10 det of location covariance")
    plt.xlabel("frame")
    plt.legend()
    plt.title("Location uncertainty, pose graph with/without loop closures")
    _savefig(plt, out_dir, "uncertainty_location.png")

    plt.figure(figsize=(8, 4))
    plt.plot(x, rot_pre, color="blue",
             label="log rotation uncertainty without loop closures")
    if has_post:
        plt.plot(x, rot_post, color="red",
                 label="log rotation uncertainty with loop closures")
    plt.ylabel("log10 det of rotation covariance")
    plt.xlabel("frame")
    plt.legend()
    plt.title("Rotation uncertainty, pose graph with/without loop closures")
    _savefig(plt, out_dir, "uncertainty_rotation.png")
    return {"final_loc_logdet": float(loc_pre[-1]) if len(loc_pre) else 0.0,
            "final_loc_logdet_lc": float(loc_post[-1]) if has_post else None}


# ---------------------------------------------------------------------------
# loop-closure overlay (slam_tpu extra)
# ---------------------------------------------------------------------------

def plot_loops(out_dir, pg, T_gt_kf):
    plt = _plt()
    c = metrics.camera_centers(pg.nodes)
    plt.figure(figsize=(7, 6))
    g = metrics.camera_centers(T_gt_kf)
    plt.plot(g[:, 0], g[:, 2], "k-", lw=1, label="gt")
    plt.plot(c[:, 0], c[:, 2], "b-", lw=1, label="pose graph")
    for i, j, is_loop in zip(pg.e_i, pg.e_j, pg.is_loop):
        if is_loop:
            plt.plot([c[i, 0], c[j, 0]], [c[i, 2], c[j, 2]], "r-", lw=2)
    plt.legend()
    plt.axis("equal")
    plt.title("Loop closures")
    _savefig(plt, out_dir, "loops.png")


# ---------------------------------------------------------------------------
# factor / projection errors (ref :186-283)
# ---------------------------------------------------------------------------

def plot_factor_errors(out_dir, bundles):
    """Mean stereo-factor error per window, before vs after optimization
    (reference analysis.py:186-211)."""
    plt = _plt()
    n = np.maximum(bundles.num_obs, 1)
    mean_final = np.sqrt(2.0 * bundles.cost / (3.0 * n))
    mean_init = np.sqrt(2.0 * bundles.cost0 / (3.0 * n))
    plt.figure(figsize=(8, 4))
    plt.plot(mean_init, label="initial")
    plt.plot(mean_final, label="optimized")
    plt.xlabel("keyframe window")
    plt.ylabel("mean factor error [px]")
    plt.legend()
    plt.title("Bundle factor error per window")
    _savefig(plt, out_dir, "mean_factor_error.png")
    return {"mean_final_px": float(mean_final.mean()),
            "mean_init_px": float(mean_init.mean())}


def plot_median_projection_error(out_dir, bundles, calib):
    """Median left-camera projection error of each window's first-keyframe
    factors, initial vs optimized landmarks (reference analysis.py:258-283:
    per bundle, project every first-keyframe factor's landmark through the
    first-kf stereo camera and take the median |measured - projected|)."""
    if bundles.meas is None:
        return {}
    plt = _plt()
    B = bundles.poses.shape[0]
    sel = (bundles.cam_idx == 0) & (bundles.w > 0)
    bi, ri = np.nonzero(sel)
    lm = bundles.lm_idx[bi, ri]
    meas = bundles.meas[bi, ri]  # (n, 3) uL, uR, v
    # final: optimized landmark through optimized first pose; initial:
    # initial landmark through the identity initial pose (window frame)
    proj_f = _np_project(calib, _transform(bundles.poses[bi, 0],
                                           bundles.points[bi, lm]))
    proj_i = _np_project(calib, bundles.points0[bi, lm])
    errf = np.linalg.norm(meas[:, [0, 2]] - proj_f[:, [0, 2]], axis=-1)
    erri = np.linalg.norm(meas[:, [0, 2]] - proj_i[:, [0, 2]], axis=-1)
    order = np.argsort(bi, kind="stable")
    bounds = np.searchsorted(bi[order], np.arange(B + 1))
    med_i, med_f, x = [], [], []
    kfs = np.asarray(bundles.keyframes)
    for b in range(B):
        a, e = bounds[b], bounds[b + 1]
        if e > a:
            med_i.append(float(np.median(erri[order[a:e]])))
            med_f.append(float(np.median(errf[order[a:e]])))
            x.append(int(kfs[b]))
    plt.figure(figsize=(8, 4))
    plt.plot(x, med_i, label="initial error")
    plt.plot(x, med_f, label="final error")
    plt.xlabel("keyframe")
    plt.ylabel("median projection error [px]")
    plt.legend()
    plt.grid(True)
    plt.title("Median projection error vs first keyframe")
    _savefig(plt, out_dir, "median_projection_error.png")
    return {"median_init_px": float(np.median(med_i)) if med_i else 0.0,
            "median_final_px": float(np.median(med_f)) if med_f else 0.0}


def plot_disparity_histogram(out_dir, db):
    """Histogram of stereo disparities of all valid links (the ex2-lineage
    y-deviation/disparity sanity plot, VAN_ex/code/ex2.py)."""
    plt = _plt()
    links = db.links[db.link_valid]
    disp = links[:, 0] - links[:, 1]
    plt.figure(figsize=(6, 4))
    plt.hist(disp, bins=60, log=True)
    plt.xlabel("disparity [px]")
    plt.ylabel("count (log)")
    plt.title("Stereo disparity histogram")
    _savefig(plt, out_dir, "disparity_hist.png")


def plot_reproj_vs_track_length(out_dir, name, db, T_frames, calib,
                                max_tracks: int = 500, seed: int = 0):
    """Median reprojection error as a function of distance from the
    triangulation frame over a stratified track sample (reference
    analysis.py:340-439, emitted per stage as
    median_projection_vs_distance_{PnP,bundle}).

    Pure host numpy: each sampled track is triangulated (stereo
    backprojection) at its max-disparity frame, lifted to world with the
    supplied per-frame poses, and reprojected into every frame it spans.
    """
    plt = _plt()
    rng = np.random.default_rng(seed)
    lengths = db.track_lengths()
    ids = np.nonzero(lengths >= 3)[0]
    if len(ids) == 0:
        return {}
    sample = rng.choice(ids, size=min(max_tracks, len(ids)), replace=False)

    by_dist: dict[int, list] = {}
    inv_T = np.linalg.inv(T_frames)
    for t in sample:
        frs, slots = db.track_slots(int(t))
        links = db.links[frs, slots]
        disp = links[:, 0] - links[:, 1]
        k = int(np.argmax(disp))
        pc = _np_backproject(calib, links[k])
        pw = inv_T[frs[k]] @ np.append(pc, 1.0)
        pred = _np_project(calib, _transform(T_frames[frs], pw[:3][None]
                                             .repeat(len(frs), 0)))
        errs = np.linalg.norm(pred - links, axis=-1)
        for i, f in enumerate(frs):
            by_dist.setdefault(abs(int(f) - int(frs[k])), []).append(errs[i])

    dists = sorted(by_dist)
    med = [float(np.median(by_dist[d])) for d in dists]
    plt.figure(figsize=(7, 4))
    plt.plot(dists, med, "o-")
    plt.xlabel("frames from triangulation frame")
    plt.ylabel("median reprojection error [px]")
    plt.title(f"Projection error vs distance — {name}")
    _savefig(plt, out_dir, f"median_projection_vs_distance_{name}.png")
    return {str(d): m for d, m in zip(dists, med)}


# ---------------------------------------------------------------------------
# debug probes (reference ex5.py:498-593 worst factor, ex7.py:767-827 loop
# match visualization, utils.visualize_track :91-120)
# ---------------------------------------------------------------------------

def plot_worst_factor(out_dir, bundles, calib, images_left=None, db=None):
    """Visualize the single worst stereo factor after optimization:
    measured vs projected track across its window (reference worst-factor
    probe, VAN_ex/code/ex5.py:498-593). With ``images_left`` the
    measurement is shown on the image patch."""
    if bundles.meas is None:
        return {}
    plt = _plt()
    active = bundles.w > 0
    bi, ri = np.nonzero(active)
    lm = bundles.lm_idx[bi, ri]
    ci = bundles.cam_idx[bi, ri]
    proj = _np_project(calib, _transform(bundles.poses[bi, ci],
                                         bundles.points[bi, lm]))
    meas = bundles.meas[bi, ri]
    err = np.linalg.norm((proj - meas) * bundles.w[bi, ri][:, None], axis=-1)
    worst = int(np.argmax(err))
    wb, wl = int(bi[worst]), int(lm[worst])
    rows = np.nonzero(active[wb] & (bundles.lm_idx[wb] == wl))[0]
    cams = bundles.cam_idx[wb, rows]
    m = bundles.meas[wb, rows]
    p = _np_project(calib, _transform(bundles.poses[wb, cams],
                                      bundles.points[wb, wl][None]
                                      .repeat(len(rows), 0)))
    frames = bundles.frames[wb, cams]

    fig, ax = plt.subplots(1, 2, figsize=(10, 4))
    ax[0].plot(m[:, 0], m[:, 2], "go-", label="measured (uL, v)")
    ax[0].plot(p[:, 0], p[:, 2], "rx--", label="projected")
    ax[0].invert_yaxis()
    ax[0].set_xlabel("u [px]")
    ax[0].set_ylabel("v [px]")
    ax[0].legend()
    ax[0].set_title(
        f"worst factor: window {wb}, landmark {wl}, err {err[worst]:.1f}px")
    ax[1].plot(frames, np.linalg.norm(p[:, [0, 2]] - m[:, [0, 2]], axis=-1),
               "o-")
    ax[1].set_xlabel("frame")
    ax[1].set_ylabel("left-cam error [px]")
    ax[1].set_title("per-frame projection error of the worst factor")
    if images_left is not None and len(frames):
        f0 = int(frames[np.argmax(
            np.linalg.norm(p[:, [0, 2]] - m[:, [0, 2]], axis=-1))])
        u, v = m[np.argmax(np.linalg.norm(p[:, [0, 2]] - m[:, [0, 2]],
                                          axis=-1))][[0, 2]]
        H, W = images_left.shape[1:3]
        y0 = int(np.clip(v - 40, 0, H - 80))
        x0 = int(np.clip(u - 40, 0, W - 80))
        axin = ax[0].inset_axes([0.65, 0.05, 0.33, 0.45])
        axin.imshow(images_left[f0, y0:y0 + 80, x0:x0 + 80], cmap="gray")
        axin.scatter([u - x0], [v - y0], c="r", s=14)
        axin.axis("off")
    fig.tight_layout()
    fig.savefig(Path(out_dir) / "worst_factor.png", dpi=110)
    plt.close(fig)
    return {"worst_factor_err_px": float(err[worst]),
            "window": wb, "landmark": wl}


def plot_loop_match(out_dir, result, closure, images_left, max_lines=60):
    """Side-by-side loop-pair visualization with matched-feature lines
    (reference loop-match probe, VAN_ex/code/ex7.py:767-827). Matches are
    recomputed from the stored frontend descriptors of the two keyframes."""
    import jax.numpy as jnp

    from ..ops import matching

    plt = _plt()
    fe = result.frontend
    fi, fj = int(closure.frame_i), int(closure.frame_j)
    m = matching.mutual_match(
        jnp.asarray(fe.desc[fi], jnp.float32),
        jnp.asarray(fe.desc[fj], jnp.float32),
        jnp.asarray(fe.valid[fi]), jnp.asarray(fe.valid[fj]),
    )
    matched = np.asarray(m["matched"])
    tgt = np.asarray(m["target_idx"])
    src = np.nonzero(matched)[0][:max_lines]
    H, W = images_left.shape[1:3]
    canvas = np.concatenate([images_left[fi], images_left[fj]], axis=0)
    plt.figure(figsize=(10, 7))
    plt.imshow(canvas, cmap="gray")
    for s in src:
        x0, y0 = fe.xy[fi, s]
        x1, y1 = fe.xy[fj, tgt[s]]
        plt.plot([x0, x1], [y0, y1 + H], "-", lw=0.5, color="lime")
    plt.scatter(fe.xy[fi, src, 0], fe.xy[fi, src, 1], s=4, c="r")
    plt.scatter(fe.xy[fj, tgt[src], 0], fe.xy[fj, tgt[src], 1] + H, s=4,
                c="r")
    plt.axis("off")
    plt.title(f"loop match {fi} <-> {fj}: {closure.num_inliers} inliers "
              f"({closure.inlier_frac:.2f})")
    _savefig(plt, out_dir, f"loop_match_{fi}_{fj}.png")


def visualize_track(out_dir, db, images_left, track_id: int,
                    crop: int = 10, max_frames: int = 12):
    """Patch strip of one feature track across its frames (reference
    utils.visualize_track :91-120)."""
    plt = _plt()
    frs, slots = db.track_slots(track_id)
    frs = frs[:max_frames]
    slots = slots[:max_frames]
    n = len(frs)
    fig, axes = plt.subplots(1, n, figsize=(1.2 * n, 1.8))
    if n == 1:
        axes = [axes]
    H, W = images_left.shape[1:3]
    for ax, f, s in zip(axes, frs, slots):
        x, y = db.xy[f, s]
        x0 = int(np.clip(x - crop, 0, W - 2 * crop))
        y0 = int(np.clip(y - crop, 0, H - 2 * crop))
        ax.imshow(images_left[f, y0 : y0 + 2 * crop, x0 : x0 + 2 * crop],
                  cmap="gray")
        ax.scatter([x - x0], [y - y0], c="r", s=12)
        ax.set_title(str(int(f)), fontsize=7)
        ax.axis("off")
    fig.suptitle(f"track {track_id}")
    fig.tight_layout()
    fig.savefig(Path(out_dir) / f"track_{track_id}.png", dpi=110)
    plt.close(fig)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def run_analysis(result, T_gt: np.ndarray, out_dir: str | Path,
                 images_left: np.ndarray | None = None) -> dict:
    """Produce the full artifact set + summary dict (reference
    run_analysis, analysis.py:1277-1362; artifact registry :27-36).
    With ``images_left`` the image-based debug probes are also emitted."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    db = result.db
    kfs = result.pose_graph.keyframes
    T_gt_kf = T_gt[kfs]
    T_pnp = result.T_frontend
    T_bund = result.T_bundled_frames

    report: dict = {"db_stats": db.stats()}

    plot_track_stats(out_dir, db)
    stages = {"frontend (PnP)": T_pnp, "bundle-adjusted": T_bund,
              "pose graph": result.pose_graph_pre_lc.nodes}
    if result.closures:
        stages["pose graph + LC"] = result.pose_graph.nodes
    plot_trajectories(out_dir, T_gt, stages)

    report["abs_error"] = {
        "PnP": plot_abs_errors(out_dir, "PnP", T_pnp, T_gt),
        "bundle": plot_abs_errors(out_dir, "bundle", T_bund, T_gt),
        "poseGraph": plot_abs_errors(
            out_dir, "poseGraph", result.pose_graph_pre_lc.nodes, T_gt_kf,
            x=np.asarray(kfs)),
    }
    if result.closures:
        report["abs_error"]["poseGraph_LC"] = plot_abs_errors(
            out_dir, "poseGraph_LC", result.pose_graph.nodes, T_gt_kf,
            x=np.asarray(kfs))

    report["rel_consecutive"] = plot_rel_error_pairs(
        out_dir, result.bundles, T_pnp, T_gt)
    report["rel_subseq"] = {
        "PnP": plot_rel_subsection(out_dir, "PnP", T_pnp, T_gt),
        "bundle": plot_rel_subsection(out_dir, "bundle", T_bund, T_gt),
    }
    report["uncertainty"] = plot_uncertainty(
        out_dir, result.pose_graph_pre_lc,
        result.pose_graph if result.closures else None)
    plot_loops(out_dir, result.pose_graph, T_gt_kf)
    plot_disparity_histogram(out_dir, db)
    report["factor_errors"] = plot_factor_errors(out_dir, result.bundles)
    if getattr(result, "calib", None) is not None:
        calib = result.calib
        report["median_projection"] = plot_median_projection_error(
            out_dir, result.bundles, calib)
        report["reproj_vs_dist"] = {
            "PnP": plot_reproj_vs_track_length(
                out_dir, "PnP", db, T_pnp, calib, max_tracks=200),
            "bundle": plot_reproj_vs_track_length(
                out_dir, "bundle", db, T_bund, calib, max_tracks=200),
        }
        report["worst_factor"] = plot_worst_factor(
            out_dir, result.bundles, calib, images_left=images_left, db=db)
        if images_left is not None:
            for c in result.closures:
                plot_loop_match(out_dir, result, c, images_left)

    report["ate_rmse"] = {
        "frontend": metrics.ate_rmse(T_pnp, T_gt),
        "bundled": metrics.ate_rmse(T_bund, T_gt),
        "pose_graph": metrics.ate_rmse(result.pose_graph_pre_lc.nodes,
                                       T_gt_kf),
    }
    if result.closures:
        report["ate_rmse"]["pose_graph_lc"] = metrics.ate_rmse(
            result.pose_graph.nodes, T_gt_kf
        )
    report["num_closures"] = len(result.closures)

    (out_dir / "analysis.json").write_text(
        json.dumps(report, indent=2, default=float)
    )
    return report
