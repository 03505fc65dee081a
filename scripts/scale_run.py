"""Reference-scale end-to-end run.

The reference processes KITTI seq 00: ~3360 stereo frames, ~430 keyframe
windows, 4 loop closures at widely separated revisit events
(final_project/project.py:109-119, arguments.py:13). The KITTI dataset is
not shipped in this image, so this driver generates a 3360-frame
full-resolution (376x1241) synthetic sequence with a seq-00-like
multi-revisit topology (utils/synthetic.clover_trajectory) and runs every
pipeline stage on the default JAX device, recording
per-stage wall-clock and accuracy.

Every stage caches its artifact under --out, so the run is resumable:
    python scripts/scale_run.py --out runs/scale
Re-running skips completed stages; --force <stage> recomputes from there.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

STAGES = ["render", "frontend", "trackstore", "bundles", "posegraph",
          "loop", "analysis"]


def log(msg: str) -> None:
    print(f"[scale {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3360)
    ap.add_argument("--out", type=Path, default=Path("runs/scale"))
    ap.add_argument("--force", choices=STAGES, default=None,
                    help="recompute from this stage onward")
    ap.add_argument("--radii", type=float, nargs="+",
                    default=[100.0, 130.0, 160.0, 145.0])
    ap.add_argument("--landmarks", type=int, default=100_000)
    ap.add_argument("--corridor", type=float, default=30.0,
                    help="landmark corridor half-width [m]")
    ap.add_argument("--hw", type=int, nargs=2, default=[376, 1241])
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (shakedown runs)")
    ap.add_argument("--detector", choices=["harris", "akaze", "orb", "sift"],
                    default="harris")
    ap.add_argument("--texture", choices=["blobs", "fractal"],
                    default="blobs",
                    help="scene texture: 'fractal' = natural-image-"
                         "statistics albedo + exposure drift + sensor "
                         "noise (utils/synthetic.py)")
    ap.add_argument("--octaves", type=int, default=None,
                    help="pyramid/scale-space octaves (FeatureConfig."
                         "num_levels; reference AKAZE uses 4)")
    ap.add_argument("--render-from", type=Path, default=None,
                    help="reuse another run's rendered images/gt/calib "
                         "(hardlinked into --out) instead of re-rendering")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    out: Path = args.out
    out.mkdir(parents=True, exist_ok=True)
    timings_path = out / "timings.json"
    timings: dict = (
        json.loads(timings_path.read_text()) if timings_path.exists() else {}
    )

    force_from = STAGES.index(args.force) if args.force else len(STAGES)

    def fresh(stage: str, *artifacts: Path) -> bool:
        """True if the stage must run (an artifact missing or forced)."""
        if STAGES.index(stage) >= force_from:
            return True
        return not all(a.exists() for a in artifacts)

    def record(stage: str, t0: float) -> None:
        timings[stage] = time.perf_counter() - t0
        timings_path.write_text(json.dumps(timings, indent=2))
        log(f"{stage}: {timings[stage]:.1f}s")

    import jax

    from slam_tpu.config import SlamConfig
    from slam_tpu.models import bundle as bundle_mod
    from slam_tpu.models import frontend as frontend_mod
    from slam_tpu.models import loop_closure as lc_mod
    from slam_tpu.models.pose_graph import PoseGraph
    from slam_tpu.models.trackstore import TrackStore
    from slam_tpu.utils import synthetic

    cfg = SlamConfig()
    if args.detector != "harris" or args.octaves is not None:
        from dataclasses import replace

        fc = replace(cfg.features, detector=args.detector,
                     num_levels=args.octaves
                     if args.octaves is not None else cfg.features.num_levels)
        cfg = replace(cfg, features=fc)
        log(f"feature config: detector={fc.detector} "
            f"num_levels={fc.num_levels}")
    cfg.save(out / "config.json")
    from slam_tpu.config import enable_compile_cache

    enable_compile_cache(cfg.runtime)

    # ---- stage 1: scene + render -----------------------------------------
    fL, fR = out / "images_L.npy", out / "images_R.npy"
    f_gt, f_calib = out / "gt_T_w2c.npy", out / "calib.npy"
    if args.render_from is not None and not fL.exists():
        import os

        for name in ("images_L.npy", "images_R.npy", "gt_T_w2c.npy",
                     "calib.npy"):
            src = args.render_from / name
            if not src.exists():
                raise SystemExit(f"--render-from: missing {src}")
            os.link(src, out / name)
        log(f"render reused from {args.render_from}")
    if fresh("render", fL, fR, f_gt, f_calib):
        t0 = time.perf_counter()
        log(f"building clover scene: {args.frames} frames, "
            f"{args.landmarks} landmarks, radii {args.radii}")
        scene = synthetic.make_scene(
            jax.random.PRNGKey(0), num_frames=args.frames,
            num_landmarks=args.landmarks, trajectory="clover",
            hw=tuple(args.hw), clover_radii=tuple(args.radii),
            corridor_halfwidth=args.corridor, texture=args.texture,
        )
        scene = synthetic.host_scene(scene)
        np.save(f_gt, np.asarray(scene.T_w2c))
        np.save(f_calib, np.asarray(scene.calib))
        H, W = scene.hw
        L = np.lib.format.open_memmap(
            fL, mode="w+", dtype=np.uint8, shape=(args.frames, H, W))
        R = np.lib.format.open_memmap(
            fR, mode="w+", dtype=np.uint8, shape=(args.frames, H, W))
        for f in range(args.frames):
            lf, rf = synthetic.render_frame_np(scene, f)
            L[f] = np.clip(lf * 255, 0, 255).astype(np.uint8)
            R[f] = np.clip(rf * 255, 0, 255).astype(np.uint8)
            if f % 200 == 0:
                log(f"render {f}/{args.frames}")
        L.flush()
        R.flush()
        record("render", t0)
    images_L = np.load(fL, mmap_mode="r")
    images_R = np.load(fR, mmap_mode="r")
    T_gt = np.load(f_gt)
    calib = np.load(f_calib)
    log(f"images ready: {images_L.shape} uint8 x2")

    # ---- stage 2: frontend (checkpointed; resume-safe) -------------------
    ckpt = out / "frontend_ckpt.npz"
    if STAGES.index("frontend") >= force_from:
        # --force means recompute, not resume: wipe the old checkpoints,
        # else run_frontend(resume=True) would just reload them.
        for p in out.glob("frontend_ckpt*"):
            p.unlink()
    if fresh("frontend", ckpt):
        t0 = time.perf_counter()
        fe = frontend_mod.run_frontend(
            images_L, images_R, calib, cfg,
            checkpoint_path=str(ckpt), checkpoint_every=1120, resume=True,
        )
        record("frontend", t0)
    else:
        fe = frontend_mod.run_frontend(
            images_L, images_R, calib, cfg,
            checkpoint_path=str(ckpt), resume=True,
        )
    log(f"frontend: {fe.T_w2c.shape[0]} frames, "
        f"{fe.num_pose_failures} pose failures, "
        f"median inliers {np.median(fe.num_inliers[1:]):.0f}")

    # ---- stage 3: track store --------------------------------------------
    f_db = out / "trackstore.npz"
    if fresh("trackstore", f_db):
        t0 = time.perf_counter()
        db = TrackStore.from_frontend(fe)
        db.save(f_db)
        record("trackstore", t0)
    else:
        db = TrackStore.load(f_db)
    log(f"trackstore: {db.num_tracks} tracks, stats {db.stats()}")

    # ---- stage 4: bundles -------------------------------------------------
    f_bundles = out / "bundles.npz"
    if fresh("bundles", f_bundles):
        t0 = time.perf_counter()
        bundles = bundle_mod.run_bundles(db, fe.T_w2c, calib, cfg)
        bundle_mod.save_bundles(bundles, f_bundles)
        record("bundles", t0)
    else:
        bundles = bundle_mod.load_bundles(f_bundles)
    log(f"bundles: {bundles.poses.shape[0]} windows, "
        f"{len(bundles.keyframes)} keyframes, "
        f"median final cost {np.median(bundles.cost):.1f}")

    # ---- stage 5: pose graph ---------------------------------------------
    f_pg = out / "pose_graph.npz"
    if fresh("posegraph", f_pg):
        t0 = time.perf_counter()
        pg = PoseGraph.from_bundles(bundles)
        pg.optimize()
        pg.save(f_pg)
        record("posegraph", t0)
    pg_pre = PoseGraph.load(f_pg)

    # ---- stage 6: loop closure -------------------------------------------
    f_pg_lc = out / "pose_graph_lc.npz"
    f_closures = out / "closures.json"
    if fresh("loop", f_pg_lc, f_closures):
        t0 = time.perf_counter()
        pg = PoseGraph.load(f_pg)
        loop_tm: dict = {}
        closures = lc_mod.find_loops(pg, db, fe.desc, fe.valid, calib, cfg,
                                     timings=loop_tm)
        log(f"loop stage breakdown: {json.dumps(loop_tm)}")
        pg.save(f_pg_lc)
        f_closures.write_text(json.dumps([
            {"kf_i": c.kf_i, "kf_j": c.kf_j, "frame_i": c.frame_i,
             "frame_j": c.frame_j, "num_inliers": c.num_inliers,
             "inlier_frac": c.inlier_frac, "mahalanobis": c.mahalanobis}
            for c in closures
        ], indent=2, default=float))
        record("loop", t0)
    pg_lc = PoseGraph.load(f_pg_lc)
    closures_meta = json.loads(f_closures.read_text())
    log(f"loop closure: {len(closures_meta)} closures "
        f"{[(c['frame_i'], c['frame_j'], c['num_inliers']) for c in closures_meta]}")

    # ---- stage 7: evaluation + analysis ----------------------------------
    from slam_tpu import pipeline as pipeline_mod
    from slam_tpu.utils import analysis

    class _C:  # minimal Closure stand-ins for PipelineResult/analysis
        def __init__(self, d):
            self.__dict__.update(d)

    result = pipeline_mod.PipelineResult(
        frontend=fe, db=db, bundles=bundles,
        pose_graph=pg_lc, pose_graph_pre_lc=pg_pre,
        closures=[_C(c) for c in closures_meta],
        timings={k: v for k, v in timings.items() if k != "render"},
        calib=np.asarray(calib, np.float32),
    )
    t0 = time.perf_counter()
    report = pipeline_mod.evaluate(result, T_gt)
    report["analysis"] = analysis.run_analysis(result, T_gt, out / "graphs",
                                               images_left=images_L)
    record("analysis", t0)
    report["timings_s"] = timings
    report["num_keyframes"] = len(bundles.keyframes)
    report["num_windows"] = int(bundles.poses.shape[0])
    report["frames"] = int(args.frames)

    # ---- fixed-RANSAC-budget accounting -----------------------------------
    # The reference sizes RANSAC iterations adaptively from the running
    # inlier rate: n(w) = log(1-p) / log(1 - w^4), p = 1 - 1e-10
    # (final_project/algorithms/ransac.py:59-67). Our frontend uses a fixed
    # 512-hypothesis batch; this records what the adaptive formula would
    # have demanded at each frame's MEASURED inlier rate, and whether the
    # frames in the demand tail (> 512) show elevated pose error.
    budget = int(cfg.ransac.num_hypotheses)
    wobs = np.asarray(fe.inlier_frac[1:], np.float64)
    wfl = np.clip(wobs, 0.05, 0.999999)  # ref floors the rate at 0.05
    p4 = np.clip(wfl ** 4, 1e-300, 1.0 - 1e-12)
    demand = np.ceil(np.log(1e-10) / np.log1p(-p4))
    # per-frame consecutive relative translation error of the frontend
    rel_est = np.einsum("fij,fjk->fik", fe.T_w2c[1:],
                        np.linalg.inv(fe.T_w2c[:-1]))
    rel_gt = np.einsum("fij,fjk->fik", T_gt[1:], np.linalg.inv(T_gt[:-1]))
    rel_err = np.linalg.norm(rel_est[:, :3, 3] - rel_gt[:, :3, 3], axis=-1)
    tail = demand > budget
    report["ransac_budget"] = {
        "fixed_hypotheses": budget,
        "adaptive_demand_p50": float(np.percentile(demand, 50)),
        "adaptive_demand_p99": float(np.percentile(demand, 99)),
        "adaptive_demand_max": float(demand.max()),
        "frac_frames_covered_by_budget": float((demand <= budget).mean()),
        "tail_frames_over_budget": int(tail.sum()),
        "rel_trans_err_m_median_all": float(np.median(rel_err)),
        "rel_trans_err_m_median_tail": (
            float(np.median(rel_err[tail])) if tail.any() else None),
        "inlier_frac_p01": float(np.percentile(wobs, 1)),
        "inlier_frac_median": float(np.median(wobs)),
    }
    log(f"ransac budget accounting: {json.dumps(report['ransac_budget'])}")
    # timestamp + per-pass history: the preserved report.json names WHICH
    # pass it is, and report_history.jsonl keeps every completed pass, so a
    # later pass can never silently shadow (or contradict) the quoted
    # record run
    report["timestamp_utc"] = time.strftime(
        "%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    with (out / "report_history.jsonl").open("a") as fh:
        fh.write(json.dumps({
            "ts": report["timestamp_utc"],
            "timings_s": timings,
            "forced_from": args.force,
            "ate": {k: report[k]["ate_rmse_m"] for k in
                    ("frontend", "bundles_kf", "pose_graph_kf",
                     "pose_graph_lc_kf") if k in report},
            "num_closures": report.get("num_closures"),
        }, default=float) + "\n")
    pipeline_mod.save_report(out / "report.json", report)
    log("report written: " + json.dumps(
        {k: report[k] for k in ("num_closures", "num_keyframes",
                                "num_pose_failures")}))
    for stage in ("frontend", "bundles_kf", "pose_graph_kf",
                  "pose_graph_lc_kf"):
        if stage in report:
            log(f"  {stage}: ate_rmse={report[stage]['ate_rmse_m']:.3f}m")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
