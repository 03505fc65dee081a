"""Smoke run of the SLAM main path on an NVIDIA GPU.

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # four cards: the mesh paths only

Phases, each an importable function that raises on failure:

  preflight       prints the card's name and power limit (nvidia-smi) and
                  requires JAX's first device to be a GPU;
  compile_phase   compiles the production shapes (the 32-frame frontend
                  chunk at 376x1241, the vmapped BA batch at
                  P24/L512/M4096, the pose-graph solve and gate, the
                  loop-closure verify step) and prints memory_analysis();
  kernel_parity   runs each hand-written kernel as compiled for the card
                  against its jnp reference at production width;
  main_path       ``pipeline.run_pipeline`` with the default SlamConfig on
                  a rendered KITTI-resolution loop scene: cold run, then a
                  warm run that must compile nothing; checks loop closure,
                  post-closure ATE <= 1% of path length and finite poses;
  four_cards      (--four-cards) ``run_pipeline(mesh=make_mesh(4))`` with
                  and without ``overlap=True``, ``dryrun_multichip(4)``
                  and the one-device run of the same scene, compared.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``,
printed only when every phase passed. Anything else exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import jax
import jax.numpy as jnp
import numpy as np

from slam_tpu import pipeline
from slam_tpu.config import SlamConfig, enable_compile_cache
from slam_tpu.utils import metrics, synthetic

# The loop scene: ~1.5 m and ~1.9 deg per frame (KITTI-like motion), one
# full circle so the last keyframes revisit the first.
FRAMES = 192
LANDMARKS = 24000
STEP_M = 1.5
ATE_BOUND = 0.01      # post-closure ATE as a fraction of path length


def preflight() -> dict:
    """Print the card and return JAX's device description; raise unless
    JAX's first device is a GPU (there is no CPU fallback)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip())  # name, power limit: as nvidia-smi gives them
    dev = jax.devices()[0]
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    print(f"jax {jax.__version__} devices: {info}")
    if dev.platform != "gpu":
        raise RuntimeError(f"JAX's first device is not a GPU: {info}")
    return info


def _memory_line(name: str, compiled) -> str:
    ma = compiled.memory_analysis()
    mb = lambda b: f"{b / 2**20:.1f} MiB"
    return (f"[compile] {name}: args {mb(ma.argument_size_in_bytes)}, "
            f"out {mb(ma.output_size_in_bytes)}, "
            f"temp {mb(ma.temp_size_in_bytes)}, "
            f"code {mb(ma.generated_code_size_in_bytes)}")


def compile_phase(cfg: SlamConfig = SlamConfig(),
                  hw: tuple[int, int] = synthetic.KITTI_HW,
                  ba_batch: int = 64) -> dict:
    """Compile the main path's device programs at production shapes and
    print each one's memory_analysis(). Measures nothing."""
    from slam_tpu.models import frontend, loop_closure
    from slam_tpu.models import pose_graph as pg_model
    from slam_tpu.ops import ba
    from slam_tpu.ops import pose_graph as pg_ops

    sds = jax.ShapeDtypeStruct
    f32, i32 = jnp.float32, jnp.int32
    out = {}

    def run(name, lowered):
        t0 = time.perf_counter()
        compiled = lowered.compile()
        out[name] = compiled.memory_analysis()
        print(_memory_line(name, compiled)
              + f" ({time.perf_counter() - t0:.1f} s)", flush=True)

    F = cfg.runtime.chunk_frames
    K = cfg.features.max_kp
    img = sds((F, *hw), jnp.uint8)
    calib = sds((5,), f32)
    key = jax.random.PRNGKey(0)
    carry = jax.eval_shape(
        lambda l, r: frontend.process_chunk(l, r, None, synthetic.KITTI_CALIB,
                                            key, cfg)[1], img, img)
    run("frontend.process_chunk (first chunk)",
        frontend.process_chunk.lower(img, img, None, calib, key, cfg))
    run("frontend.process_chunk (carried)",
        frontend.process_chunk.lower(img, img, carry, calib, key, cfg))

    bc = cfg.bundle
    P, L, M = bc.max_poses, bc.max_landmarks, bc.max_obs
    B = ba_batch
    solver = jax.jit(jax.vmap(
        lambda p0, x0, ci, li, ms, ww, c: ba.optimize_bundle_pruned(
            p0, x0, ci, li, ms, ww, c, iters=bc.lm_iters),
        in_axes=(0, 0, 0, 0, 0, 0, None)))
    run(f"ba.optimize_bundle_pruned x{B} ({ba.default_engine()})",
        solver.lower(sds((B, P, 4, 4), f32), sds((B, L, 3), f32),
                     sds((B, M), i32), sds((B, M), i32),
                     sds((B, M, 3), f32), sds((B, M), f32), calib))

    N, E = pg_model._NODE_PAD, pg_model._EDGE_PAD
    graph = (sds((N, 4, 4), f32), sds((E,), i32), sds((E,), i32),
             sds((E, 4, 4), f32), sds((E, 6, 6), f32), sds((E,), bool))
    n_valid = sds((N,), bool)
    run("pose_graph.optimize",
        pg_ops.optimize.lower(*graph, n_valid=n_valid))
    pairs = sds((pg_model._PAIR_PAD,), i32)
    run("pose_graph.gate_matrix",
        pg_ops.gate_matrix.lower(*graph, pairs, pairs, n_valid=n_valid))

    Q, C = 4, cfg.loop.max_candidates
    run("loop_closure.verify",
        loop_closure._verify_candidates_multi.lower(
            key, sds((Q, K, 128), jnp.float16), sds((Q, K), bool),
            sds((Q, K, 3), f32), sds((Q, K), bool),
            sds((Q, C, K, 128), jnp.float16), sds((Q, C, K), bool),
            sds((Q, C, K, 3), f32), sds((Q, C, K), bool),
            calib, cfg.ransac.num_hypotheses, cfg.ransac.threshold_px))
    stats = jax.devices()[0].memory_stats() or {}
    print(f"[compile] peak_bytes_in_use after compiling (XLA's autotuning "
          f"allocates on the device): {stats.get('peak_bytes_in_use')}",
          flush=True)
    return out


def _unit(key, shape):
    x = jax.random.normal(key, shape)
    return x / jnp.linalg.norm(x, axis=-1, keepdims=True)


def kernel_parity(K: int = 2048, D: int = 128, pairs: int = 8,
                  interpret: bool = False) -> dict:
    """The fused matcher (ops/match_kernel.py) against the dense jnp
    matcher on the same device, at the frontend's feature budget: plain
    and with the stereo window. Both use bf16 operands with f32
    accumulation; only the order of the 128-term sums differs, so row
    targets must agree on >= 99.9% of rows and distances to 1e-4."""
    from slam_tpu.ops import match_kernel, matching

    ks = jax.random.split(jax.random.PRNGKey(7), 5)
    a = _unit(ks[0], (pairs, K, D))
    perm = jax.random.permutation(ks[1], K)
    b = a[:, perm] + 0.3 * jax.random.normal(ks[2], (pairs, K, D))
    b = b / jnp.linalg.norm(b, axis=-1, keepdims=True)
    va = jax.random.bernoulli(ks[3], 0.95, (pairs, K))
    vb = jax.random.bernoulli(ks[4], 0.95, (pairs, K))
    xy_a = jax.random.uniform(ks[0], (pairs, K, 2)) * jnp.array([1241., 376.])
    xy_b = xy_a[:, perm] + jnp.array([-30.0, 0.5])
    mc = SlamConfig().matching
    stereo_win = (-mc.max_disparity, -mc.stereo_min_disp, mc.stereo_match_dy)

    results = {}
    for name, win in (("plain", None), ("stereo window", stereo_win)):
        kern = jax.jit(jax.vmap(lambda *x: match_kernel.mutual_nearest(
            *x, window=win, interpret=interpret)))
        ref = jax.jit(jax.vmap(lambda *x: matching.dense_mutual_nearest(
            *x, window=win)))
        kd, kr, kc = kern(a, b, va, vb, xy_a, xy_b)
        rd, rr, rc = ref(a, b, va, vb, xy_a, xy_b)
        row = float(jnp.mean(kr == rr))
        col = float(jnp.mean(kc == rc))
        err = float(jnp.max(jnp.abs(jnp.where(kr == rr, kd - rd, 0.0))))
        print(f"[parity] match_kernel.mutual_nearest ({name}) K={K} D={D} "
              f"x{pairs}: row agree {row:.5f}, col agree {col:.5f}, "
              f"max |dist diff| {err:.2e} (bf16 operands, f32 accumulation;"
              f" bound: agree >= 0.999, diff <= 1e-4)", flush=True)
        if row < 0.999 or col < 0.999 or err > 1e-4:
            raise AssertionError(f"matcher kernel parity failed ({name})")
        results[name] = {"row_agree": row, "col_agree": col, "max_diff": err}
    return results


def loop_scene(frames: int = FRAMES, hw=synthetic.KITTI_HW,
               landmarks: int = LANDMARKS, seed: int = 0):
    """A closed circular drive rendered at ``hw``: (L, R) uint8 stacks,
    calib, ground-truth T_w2c and the path length in meters."""
    radius = frames * STEP_M / (2.0 * np.pi)
    scene = synthetic.make_scene(
        jax.random.PRNGKey(seed), num_frames=frames,
        num_landmarks=landmarks, trajectory="loop", hw=hw,
        loop_radius=radius)
    L, R = synthetic.render_sequence(scene)
    to_u8 = lambda x: np.clip(x * 255.0, 0, 255).astype(np.uint8)
    T_gt = np.asarray(scene.T_w2c)
    centers = metrics.camera_centers(T_gt)
    length = float(np.sum(np.linalg.norm(np.diff(centers, axis=0), axis=-1)))
    return to_u8(L), to_u8(R), np.asarray(scene.calib), T_gt, length


class CompileCounter:
    """Counts XLA backend compilations while active."""

    def __init__(self):
        self.count = 0
        self.active = False
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, name, duration, **kwargs):
        if self.active and name == "/jax/core/compile/backend_compile_duration":
            self.count += 1


def check_run(res, T_gt: np.ndarray, length: float,
              bound: float = ATE_BOUND) -> dict:
    """Per-stage ATE, closures and finiteness of one pipeline run; raises
    when the run misses the smoke contract."""
    rep = pipeline.evaluate(res, T_gt)
    ate = {k: rep[k]["ate_rmse_m"] for k in
           ("frontend", "bundles_kf", "pose_graph_kf", "pose_graph_lc_kf")
           if k in rep}
    out = {"ate_m": ate, "closures": rep["num_closures"],
           "path_m": length,
           "closure_pairs": [(c.frame_i, c.frame_j, c.num_inliers)
                             for c in res.closures]}
    for name, T in (("frontend", res.T_frontend),
                    ("pose graph", res.pose_graph.nodes),
                    ("pose graph before closure",
                     res.pose_graph_pre_lc.nodes)):
        if not np.isfinite(T).all():
            raise AssertionError(f"non-finite {name} poses")
    if rep["num_closures"] < 1:
        raise AssertionError(f"no loop closure found: {out}")
    if ate["pose_graph_lc_kf"] > bound * length:
        raise AssertionError(
            f"post-closure ATE {ate['pose_graph_lc_kf']:.3f} m exceeds "
            f"{bound:.0%} of the {length:.1f} m path: {out}")
    return out


def main_path(cfg: SlamConfig = SlamConfig(), frames: int = FRAMES,
              hw=synthetic.KITTI_HW, landmarks: int = LANDMARKS) -> dict:
    """Cold and warm ``run_pipeline`` on the loop scene; the warm run must
    compile nothing. Returns the checked results."""
    t0 = time.perf_counter()
    L, R, calib, T_gt, length = loop_scene(frames, hw, landmarks)
    print(f"[main] scene: {frames} frames at {hw[0]}x{hw[1]}, "
          f"{length:.1f} m loop, rendered in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    counter = CompileCounter()
    t0 = time.perf_counter()
    cold = pipeline.run_pipeline(L, R, calib, cfg, verbose=False)
    cold_s = time.perf_counter() - t0
    counter.active = True
    t0 = time.perf_counter()
    warm = pipeline.run_pipeline(L, R, calib, cfg, verbose=False)
    warm_s = time.perf_counter() - t0
    counter.active = False
    dev = jax.devices()[0]
    stats = dev.memory_stats() or {}
    out = check_run(warm, T_gt, length)
    out.update(cold_s=cold_s, warm_s=warm_s,
               warm_frames_per_s=frames / warm_s,
               warm_compiles=counter.count,
               peak_bytes_in_use=stats.get("peak_bytes_in_use"),
               timings_cold_s=cold.timings, timings_warm_s=warm.timings)
    print(f"[main] cold run {cold_s:.2f} s, warm run {warm_s:.2f} s "
          f"({frames / warm_s:.2f} frames/s end to end), "
          f"compiles in warm run: {counter.count}", flush=True)
    print(f"[main] stage timings cold: {_fmt(cold.timings)}")
    print(f"[main] stage timings warm: {_fmt(warm.timings)}")
    print(f"[main] ATE per stage (m): {_fmt(out['ate_m'])}; path "
          f"{length:.1f} m, bound {ATE_BOUND * length:.2f} m")
    print(f"[main] closures: {out['closure_pairs']}")
    print(f"[main] peak_bytes_in_use: {out['peak_bytes_in_use']}",
          flush=True)
    if counter.count:
        raise AssertionError(f"warm run compiled {counter.count} programs")
    return out


def _fmt(d: dict) -> str:
    return ", ".join(f"{k} {v:.3f}" for k, v in d.items()
                     if isinstance(v, float))


def four_cards(n: int = 4, cfg: SlamConfig = SlamConfig(),
               frames: int = FRAMES, hw=synthetic.KITTI_HW,
               landmarks: int = LANDMARKS, tol: float = ATE_BOUND) -> dict:
    """The mesh paths on ``n`` devices against the one-device run of the
    same scene. Keyframe trajectories after closure must agree with the
    one-device run to ``tol`` x path length (max camera-center gap), and
    every device of the mesh must have held arrays."""
    import __graft_entry__
    from slam_tpu.parallel.mesh import make_mesh

    if len(jax.devices()) < n:
        raise RuntimeError(f"{n} devices needed, {len(jax.devices())} found")
    L, R, calib, T_gt, length = loop_scene(frames, hw, landmarks)
    mesh = make_mesh(n)
    runs = {}
    for name, kw in (("one device", {}), ("mesh", {"mesh": mesh}),
                     ("mesh+overlap", {"mesh": mesh, "overlap": True})):
        t0 = time.perf_counter()
        res = pipeline.run_pipeline(L, R, calib, cfg, verbose=False, **kw)
        dt = time.perf_counter() - t0
        runs[name] = (res, check_run(res, T_gt, length))
        print(f"[{n} cards] {name}: {dt:.2f} s (cold), ATE "
              f"{_fmt(runs[name][1]['ate_m'])}, closures "
              f"{runs[name][1]['closure_pairs']}", flush=True)
    ref = runs["one device"][0]
    ref_kf = {k: i for i, k in enumerate(ref.pose_graph.keyframes)}
    cmp = {}
    for name in ("mesh", "mesh+overlap"):
        res = runs[name][0]
        # the frame-sharded frontend chains chunks in another order, so
        # keyframe selection may differ: compare the keyframes both chose
        both = [(i, ref_kf[k]) for i, k in enumerate(res.pose_graph.keyframes)
                if k in ref_kf]
        mine, theirs = (list(t) for t in zip(*both))
        gap = float(np.max(np.linalg.norm(
            metrics.camera_centers(res.pose_graph.nodes[mine])
            - metrics.camera_centers(ref.pose_graph.nodes[theirs]),
            axis=-1)))
        fe_gap = float(np.max(np.linalg.norm(
            metrics.camera_centers(res.T_frontend)
            - metrics.camera_centers(ref.T_frontend), axis=-1)))
        cmp[name] = {"kf_gap_m": gap, "frontend_gap_m": fe_gap,
                     "common_keyframes": len(both),
                     "keyframes": len(res.pose_graph.keyframes),
                     "closures": runs[name][1]["closures"]}
        print(f"[{n} cards] {name} vs one device: max gap over "
              f"{len(both)}/{len(ref_kf)} shared keyframes {gap:.4f} m, "
              f"max frontend gap {fe_gap:.4f} m (bound "
              f"{tol * length:.2f} m)", flush=True)
        if max(gap, fe_gap) > tol * length:
            raise AssertionError(f"{name} trajectory departs: {cmp[name]}")
    # nothing may land everything on device 0 (a backend that reports no
    # memory statistics, like the CPU, is not checked)
    used = [(d.id, (d.memory_stats() or {}).get("peak_bytes_in_use"))
            for d in mesh.devices.flatten()]
    print(f"[{n} cards] peak_bytes_in_use per device: {used}", flush=True)
    if any(b is not None and b <= 0 for _, b in used):
        raise AssertionError(f"a mesh device held no arrays: {used}")
    __graft_entry__.dryrun_multichip(n)
    cmp["peak_bytes_per_device"] = used
    return cmp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh paths")
    args = ap.parse_args(argv)
    enable_compile_cache(SlamConfig().runtime)
    info = preflight()
    if args.four_cards:
        four_cards()
    else:
        compile_phase()
        kernel_parity()
        main_path()
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
