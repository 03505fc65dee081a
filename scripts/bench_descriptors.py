"""Descriptor-path benchmark: harris 1-octave vs harris 2-octave vs AKAZE.

A second descriptor octave helps
loop-closure viewpoint changes but was never made the measured default.
This driver runs the full pipeline on the SAME rendered loop scene for
each detector configuration and reports:

  * frontend fps (chunked steady-state, this machine's device)
  * loop closures found + median verification inliers
  * ATE at every backend stage

Usage:  python scripts/bench_descriptors.py [--frames 200] [--out /tmp/descbench]
The summary table is printed and written to <out>/summary.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--out", type=Path, default=Path("/tmp/descbench"))
    ap.add_argument("--hw", type=int, nargs=2, default=[376, 1241])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--variants", nargs="+", default=None,
                    help="run only these variants (default: all)")
    ap.add_argument("--texture", choices=["blobs", "fractal"],
                    default="blobs",
                    help="'fractal' = natural-image-statistics scene "
                         "(de-confounds the detector ranking)")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax

    from slam_tpu import pipeline as pipeline_mod
    from slam_tpu.config import FeatureConfig, MatchConfig, SlamConfig
    from slam_tpu.utils import synthetic

    args.out.mkdir(parents=True, exist_ok=True)
    # one loop scene with a revisit, shared by every variant
    scene = synthetic.make_scene(
        jax.random.PRNGKey(0), num_frames=args.frames,
        num_landmarks=max(8000, args.frames * 40), trajectory="clover",
        hw=tuple(args.hw),
        clover_radii=(args.frames / (4 * np.pi) * 0.9,
                      args.frames / (4 * np.pi) * 1.1),
        corridor_halfwidth=15.0,
        texture=args.texture,
    )
    scene = synthetic.host_scene(scene)
    L, R = synthetic.render_sequence(scene)
    u8 = lambda x: np.clip(x * 255, 0, 255).astype(np.uint8)
    L, R = u8(L), u8(R)
    T_gt = np.asarray(scene.T_w2c)
    calib = np.asarray(scene.calib)

    variants = {
        "harris1": SlamConfig(),
        "harris2": SlamConfig(features=FeatureConfig(num_levels=2)),
        "akaze": SlamConfig(
            features=FeatureConfig(detector="akaze", num_levels=2)),
        # reference AKAZE octave count (matching.py:19-24)
        "akaze4": SlamConfig(
            features=FeatureConfig(detector="akaze", num_levels=4)),
        # DoG scale-space extrema (ops/sift.py) — the reference's ACTIVE
        # detector family (matching.py:27-35,72)
        "sift": SlamConfig(
            features=FeatureConfig(detector="sift", num_levels=3)),
        # NORM_HAMMING mode (reference matching.py:21): binarized
        # descriptors matched by exact matmul popcount (ops/binary.py)
        "hamming": SlamConfig(matching=MatchConfig(norm="hamming")),
        # ORB family (ops/orb.py): FAST-9 + steered BRIEF bits, matched
        # as NORM_HAMMING (its native metric)
        "orb": SlamConfig(
            features=FeatureConfig(detector="orb"),
            matching=MatchConfig(norm="hamming", max_hamming=40.0)),
    }
    if args.variants:
        unknown = set(args.variants) - set(variants)
        if unknown:
            raise SystemExit(f"unknown variants: {sorted(unknown)}")
        variants = {k: variants[k] for k in args.variants}
    summary = {}
    for name, cfg in variants.items():
        t0 = time.perf_counter()
        res = pipeline_mod.run_pipeline(L, R, calib, cfg,
                                        run_loop_closure=True, verbose=False)
        wall = time.perf_counter() - t0
        rep = pipeline_mod.evaluate(res, T_gt)
        inl = [c.num_inliers for c in res.closures]
        summary[name] = {
            "wall_s": round(wall, 1),
            "frontend_s": round(res.timings.get("frontend", 0.0), 1),
            "frontend_fps": round(args.frames / max(
                res.timings.get("frontend", 1e-9), 1e-9), 1),
            "num_closures": len(res.closures),
            "closure_inliers_median": float(np.median(inl)) if inl else 0.0,
            "ate": {k: round(v["ate_rmse_m"], 4) for k, v in rep.items()
                    if isinstance(v, dict) and "ate_rmse_m" in v},
            "median_frame_inliers": float(np.median(res.frontend.num_inliers[1:])),
            "pose_failures": rep["num_pose_failures"],
        }
        print(f"[descbench] {name}: "
              + json.dumps(summary[name]), flush=True)
        cfg.save(args.out / f"config_{name}.json")

    # matcher-kernel microbench: float L2 vs Hamming signs through the
    # same fused mutual-nearest kernel (identical matmul shape -> expect
    # identical rate; this documents that Hamming costs nothing extra)
    import jax.numpy as jnp

    from slam_tpu.ops import binary, matching

    K, D, B = 2048, 128, 32
    key = jax.random.PRNGKey(0)
    df = jax.random.uniform(key, (B, K, D), jnp.float32)
    df = df / jnp.linalg.norm(df, axis=-1, keepdims=True)
    sb = binary.binarize_descriptors(df)
    v = jnp.ones((B, K), bool)
    run_f = jax.jit(lambda a, b: matching.mutual_match_batched(
        a, b, v, v, max_dist=0.6))
    run_h = jax.jit(lambda a, b: binary.hamming_mutual_match_batched(
        a, b, v, v, max_hamming=40.0))
    for tag, fn, a, b in (("l2", run_f, df[:, :], jnp.roll(df, 1, 0)),
                          ("hamming", run_h, sb, jnp.roll(sb, 1, 0))):
        jax.block_until_ready(fn(a, b))  # compile
        t0 = time.perf_counter()
        reps = 10
        for _ in range(reps):
            out = fn(a, b)
        jax.block_until_ready(out)
        ms = (time.perf_counter() - t0) / (reps * B) * 1e3
        summary[f"matcher_{tag}_ms_per_pair"] = round(ms, 4)
        print(f"[descbench] matcher {tag}: {ms:.4f} ms/pair (K={K}, D={D})")

    (args.out / "summary.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
