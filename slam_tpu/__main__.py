"""Command-line driver.

Replaces the reference's ``python final_project/project.py`` __main__
(project.py:97-107, which hard-codes per-machine paths in arguments.py)
with a real CLI:

  # KITTI sequence from disk
  python -m slam_tpu --kitti-root /data/dataset --seq 00 --out runs/00

  # synthetic smoke run (no dataset needed)
  python -m slam_tpu --synthetic loop --frames 100 --out runs/demo

  # multi-sequence batch
  python -m slam_tpu --kitti-root /data/dataset --seq 00 02 05 08 --out runs/all
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser("slam_tpu")
    p.add_argument("--kitti-root", type=Path, default=None,
                   help="KITTI odometry dataset root (contains sequences/)")
    p.add_argument("--seq", nargs="+", default=["00"],
                   help="sequence id(s), e.g. 00 02 05 08")
    p.add_argument("--limit", type=int, default=None,
                   help="max frames per sequence")
    p.add_argument("--synthetic", choices=["straight", "loop"], default=None,
                   help="run on a synthetic scene instead of KITTI")
    p.add_argument("--frames", type=int, default=100,
                   help="synthetic sequence length")
    p.add_argument("--out", type=Path, required=True, help="output directory")
    p.add_argument("--config", type=Path, default=None,
                   help="SlamConfig JSON (see slam_tpu/config.py)")
    p.add_argument("--no-loop-closure", action="store_true")
    p.add_argument("--no-analysis", action="store_true")
    p.add_argument("--no-prefetch", action="store_true",
                   help="load KITTI images eagerly into memory instead of "
                        "streaming them through the native C++ prefetcher")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend (JAX uses the GPU by "
                        "default where one is present)")
    args = p.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from .config import SlamConfig
    from . import pipeline
    from .utils import analysis, synthetic

    cfg = SlamConfig.load(args.config) if args.config else SlamConfig()
    args.out.mkdir(parents=True, exist_ok=True)
    cfg.save(args.out / "config.json")

    sequences = {}
    if args.synthetic:
        import jax

        scene = synthetic.make_scene(
            jax.random.PRNGKey(cfg.seed), num_frames=args.frames,
            num_landmarks=8000, trajectory=args.synthetic,
        )
        L, R = synthetic.render_sequence(scene)
        to_u8 = lambda x: np.clip(x * 255, 0, 255).astype(np.uint8)
        sequences["synthetic"] = (to_u8(L), to_u8(R), np.asarray(scene.calib),
                                  np.asarray(scene.T_w2c))
    else:
        if args.kitti_root is None:
            p.error("--kitti-root or --synthetic is required")
        from .utils import kitti

        prefetch = not args.no_prefetch
        for s in args.seq:
            paths = kitti.KittiPaths(root=args.kitti_root, sequence=s)
            if not paths.exists():
                print(f"[slam_tpu] sequence {s} not found under "
                      f"{args.kitti_root}, skipping")
                continue
            calib = kitti.calib_vector(paths)
            gt = (kitti.read_ground_truth(paths)
                  if paths.poses_file.is_file() else None)
            if prefetch:
                # disk-streaming mode: the frontend consumes the PNGs
                # through the native prefetcher (decode threads overlap
                # device compute); images never fully materialize on host
                lp = sorted(paths.left_dir.glob("*.png"))[: args.limit]
                rp = sorted(paths.right_dir.glob("*.png"))[: args.limit]
                if not lp or len(lp) != len(rp):
                    # an empty image_0 or a left/right count mismatch would
                    # otherwise surface as an IndexError (or NULL paths
                    # handed to the native decoder)
                    print(f"[slam_tpu] skipping {s}: {len(lp)} left / "
                          f"{len(rp)} right PNGs")
                    continue
                if gt is not None:
                    gt = gt[: len(lp)]
                sequences[s] = (lp, rp, calib, gt)
            else:
                L, R, _, gt = kitti.load_sequence(paths, limit=args.limit)
                sequences[s] = (L, R, calib, gt)

    if not sequences:
        print("[slam_tpu] nothing to run")
        return 1

    # KITTI resolutions differ across sequences; pad to one shared bucket
    # so the whole batch reuses the same compiled kernels
    image_hw = None
    if not args.synthetic:
        from .utils import kitti as kitti_mod

        def seq_hw(v):
            L = v[0]
            if isinstance(L, list):  # path mode: decode one header
                return kitti_mod._imread_gray(L[0]).shape
            return L.shape[1:]

        image_hw = kitti_mod.bucket_for(
            [seq_hw(v) for v in sequences.values()]
        )
        print(f"[slam_tpu] image bucket {image_hw} across "
              f"{len(sequences)} sequence(s)")
        sequences = {
            k: ((L, R, c, g) if isinstance(L, list)
                else (kitti_mod.pad_to_bucket(L, image_hw),
                      kitti_mod.pad_to_bucket(R, image_hw), c, g))
            for k, (L, R, c, g) in sequences.items()
        }

    reports = {}
    for name, (L, R, calib, gt) in sequences.items():
        out_dir = args.out / name
        out_dir.mkdir(parents=True, exist_ok=True)
        res = pipeline.run_pipeline(
            L, R, calib, cfg, cache_dir=out_dir / "cache",
            run_loop_closure=not args.no_loop_closure, verbose=True,
            image_hw=image_hw,
        )
        if gt is not None:
            rep = pipeline.evaluate(res, np.asarray(gt))
            if not args.no_analysis:
                rep["analysis"] = analysis.run_analysis(
                    res, np.asarray(gt), out_dir / "graphs",
                    # path mode: lazy decode so the image-based probes
                    # (loop overlays, worst-factor insets) still render
                    images_left=(
                        kitti_mod.LazyImageSequence(L, image_hw)
                        if isinstance(L, list) else L
                    ),
                )
        else:
            rep = {"timings_s": res.timings, "db_stats": res.db.stats(),
                   "num_closures": len(res.closures)}
        reports[name] = rep
        pipeline.save_report(out_dir / "report.json", rep)
        print(f"[slam_tpu] {name}: "
              + json.dumps({k: v for k, v in rep.items()
                            if k in ("num_closures",)}))

    pipeline.save_report(args.out / "reports.json", reports)
    print(f"[slam_tpu] done; reports in {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
