"""Frontend stage ablation: where does the per-frame time go?

Times each stage of models/frontend.process_chunk in isolation at the
benchmark shapes (8-frame chunk, 376x1241, K=2048, 512 RANSAC
hypotheses), steady-state on the default device. This is the optimization
map for the headline frontend fps (bench.py): the stage with the largest
share is the next kernel/layout candidate.

Usage:  python scripts/profile_frontend.py [--chunk 8] [--iters 20]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def timeit(fn, iters, *args):
    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp

    from slam_tpu.config import SlamConfig
    from slam_tpu.models import frontend as fe_mod
    from slam_tpu.ops import features, matching, ransac
    from slam_tpu.utils import synthetic
    from slam_tpu.utils.synthetic import KITTI_CALIB

    cfg = SlamConfig()
    F = args.chunk
    K = cfg.features.max_kp
    scene = synthetic.make_scene(
        jax.random.PRNGKey(0), num_frames=F, num_landmarks=12000,
        hw=(376, 1241), step_m=1.0,
    )
    L, R = synthetic.render_sequence(scene)
    u8 = lambda x: np.clip(np.asarray(x) * 255, 0, 255).astype(np.uint8)
    Lj, Rj = jnp.asarray(u8(L)), jnp.asarray(u8(R))
    calib = jnp.asarray(KITTI_CALIB)
    key = jax.random.PRNGKey(0)

    imgs = jnp.concatenate([Lj, Rj], axis=0).astype(jnp.float32) / 255.0

    detect = jax.jit(
        lambda im: features.detect_and_describe_batch(im, max_kp=K))
    t_detect = timeit(detect, args.iters, imgs)

    feats = detect(imgs)
    fl = jax.tree.map(lambda x: x[:F], feats)
    fr = jax.tree.map(lambda x: x[F:], feats)
    mc = cfg.matching
    swin = (-mc.max_disparity, -mc.stereo_min_disp, mc.stereo_match_dy)

    stereo_m = jax.jit(lambda a, b: matching.match_stereo_pair_batched(
        a, b, window=swin, max_dist=mc.max_desc_dist))
    t_stereo = timeit(stereo_m, args.iters, fl, fr)

    sm = stereo_m(fl, fr)
    desc, valid, xy = fl["desc"], fl["valid"], fl["xy"]
    prev = jax.tree.map(lambda x: jnp.roll(x, 1, axis=0), (desc, valid, xy))
    twin = (-mc.temporal_dx, mc.temporal_dx, mc.temporal_dy)
    temporal = jax.jit(lambda pd, d, pv, v, pxy, cxy: matching.mutual_match_batched(
        pd, d, pv, v, xy_a=pxy, xy_b=cxy, window=twin,
        max_dist=mc.max_desc_dist))
    t_temporal = timeit(temporal, args.iters, prev[0], desc, prev[1], valid,
                        prev[2], xy)

    tmatch = temporal(prev[0], desc, prev[1], valid, prev[2], xy)
    links, lv = sm["links"], sm["matched"]
    plinks = jnp.roll(links, 1, axis=0)
    plv = jnp.roll(lv, 1, axis=0)

    def corr_ransac(k_, plinks, plv, links, lv, tmatch):
        pw, meas, cv = jax.vmap(
            fe_mod._pair_correspondences, in_axes=(0, 0, 0, 0, 0, None)
        )(plinks, plv, links, lv, tmatch, calib)
        keys = jax.random.split(k_, F)
        return jax.vmap(
            lambda kk, pw_, m_, v_: ransac.ransac_pnp(
                kk, pw_, m_, v_, calib,
                num_hypotheses=cfg.ransac.num_hypotheses,
                threshold=cfg.ransac.threshold_px,
                refine_iters=cfg.ransac.refine_iters,
            )
        )(keys, pw, meas, cv)["T_w2c"]

    ransac_j = jax.jit(corr_ransac)
    t_ransac = timeit(ransac_j, args.iters, key, plinks, plv, links, lv,
                      tmatch)

    full = jax.jit(lambda l_, r_, k_: fe_mod.process_chunk(
        l_, r_, None, calib, k_, cfg)[0]["T_rel"], static_argnums=())
    t_full = timeit(full, args.iters, Lj, Rj, key)

    per_frame = {
        "detect_describe_2F_ms": 1e3 * t_detect / F,
        "stereo_match_ms": 1e3 * t_stereo / F,
        "temporal_match_ms": 1e3 * t_temporal / F,
        "corr_plus_ransac_ms": 1e3 * t_ransac / F,
        "full_chunk_ms": 1e3 * t_full / F,
    }
    per_frame["sum_stages_ms"] = sum(
        v for k, v in per_frame.items() if k != "full_chunk_ms")
    print(json.dumps({k: round(v, 3) for k, v in per_frame.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
