"""Benchmark: frontend visual-odometry throughput on KITTI-shaped stereo.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "frames/sec", "vs_baseline": N,
   "extra": {...}}

The measured quantity is the per-frame hot path of the reference
(SURVEY.md §3.2: detect + describe both stereo images, stereo match,
temporal match, triangulate, RANSAC-PnP pose) at KITTI seq-00 resolution
(376 x 1241), steady-state, on the GPU. The run fails when JAX's first
device is not a GPU whose peaks are in ``PEAKS``; every printed result
names the platform, device kind and device count.

``vs_baseline`` divides by the CPU reference cost, measured live with the
same C++ kernels the reference binds: cv2 SIFT detect/compute, three
crossCheck BFMatcher passes, per-point SVD triangulation of every stereo
link, and an adaptive-iteration EPnP-RANSAC loop *including the
per-iteration two-view reprojection agreement test and the final
all-inlier re-solve* (final_project/backend/database/database.py:30-89 +
algorithms/ransac.py:28-113). Images are fed to the CPU path exactly as
produced (uint8), no re-scaling.

``extra`` carries secondary metrics: batched-BA windows/sec at production
window shapes (P=24, L=512, M=4096 — models/bundle.py defaults) and
end-to-end pipeline fps on the same rendered scene.
"""

from __future__ import annotations

import json
import math
import time
import typing  # noqa: F401 — NoReturn annotation on _fail

import numpy as np

H, W = 376, 1241
BENCH_FRAMES = 96  # 11 timed chunks: 5 was too few to amortize dispatch jitter
CHUNK = 8
BASELINE_FRAMES = 16  # timed frames (frame 0 is processed as warmup)
BA_WINDOWS = 128  # windows per BA dispatch; production batches all of a
#                   sequence's windows (653 at reference scale)

# Published peaks by ``jax.devices()[0].device_kind`` (NVIDIA H100 SXM5
# data sheet: dense rates without sparsity, at the full 700 W power limit).
# MFU here = XLA-counted FLOPs / wall-clock / the bf16 peak — an
# *accounting* number: most frontend math is f32 elementwise work, so its
# real ceiling is far lower. A device missing from the table is an error.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "f32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def device_info() -> dict:
    """Platform, device kind and device count of JAX's default backend."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def device_peaks(kind: str | None = None) -> dict:
    """The ``PEAKS`` entry of ``kind`` (default: JAX's first device)."""
    if kind is None:
        kind = device_info()["kind"]
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"known: {sorted(PEAKS)}")
    return PEAKS[kind]


def _xla_flops(compiled) -> float:
    """FLOPs of a compiled executable from XLA's own cost analysis."""
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return float(ca.get("flops", 0.0))


def make_images(num_frames: int) -> tuple[np.ndarray, np.ndarray]:
    """Synthetic KITTI-resolution stereo sequence (rendered blob scene)."""
    import jax

    from slam_tpu.utils import synthetic

    scene = synthetic.make_scene(
        jax.random.PRNGKey(0), num_frames=num_frames, num_landmarks=12000,
        hw=(H, W), step_m=1.0,
    )
    L, R = synthetic.render_sequence(scene)
    # uint8, as KITTI ships them — quarters the host->device transfer
    to_u8 = lambda x: np.clip(np.asarray(x) * 255.0, 0, 255).astype(np.uint8)
    return to_u8(L), to_u8(R)


def bench_frontend(L: np.ndarray, R: np.ndarray) -> tuple[float, float]:
    """Steady-state frames/sec of the chunked frontend, and its MFU
    (XLA-counted FLOPs per chunk / wall-clock / device bf16 peak)."""
    import jax
    import jax.numpy as jnp

    from slam_tpu.config import SlamConfig
    from slam_tpu.models import frontend
    from slam_tpu.utils.synthetic import KITTI_CALIB

    cfg = SlamConfig()
    calib = jnp.asarray(KITTI_CALIB)
    key = jax.random.PRNGKey(0)

    Lj = jnp.asarray(L)
    Rj = jnp.asarray(R)

    # warmup: compile both carry variants
    out, carry = frontend.process_chunk(Lj[:CHUNK], Rj[:CHUNK], None, calib,
                                        key, cfg)
    out2, carry = frontend.process_chunk(Lj[CHUNK:2 * CHUNK],
                                         Rj[CHUNK:2 * CHUNK], carry, calib,
                                         key, cfg)
    jax.block_until_ready(out2["T_rel"])
    flops_per_chunk = _xla_flops(
        frontend.process_chunk.lower(
            Lj[:CHUNK], Rj[:CHUNK], carry, calib, key, cfg
        ).compile()
    )

    n_chunks = (L.shape[0] - CHUNK) // CHUNK
    t0 = time.perf_counter()
    c = carry
    last = None
    for i in range(1, 1 + n_chunks):
        s = i * CHUNK
        o, c = frontend.process_chunk(Lj[s : s + CHUNK], Rj[s : s + CHUNK],
                                      c, calib, key, cfg)
        last = o
    jax.block_until_ready(last["T_rel"])
    dt = time.perf_counter() - t0
    mfu = flops_per_chunk * n_chunks / dt / device_peaks()["bf16_flops"]
    return n_chunks * CHUNK / dt, mfu


def _as_u8(img: np.ndarray) -> np.ndarray:
    """uint8 view of an image regardless of incoming dtype (no double
    scaling: make_images already returns uint8)."""
    if img.dtype == np.uint8:
        return img
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def bench_cpu_reference(L: np.ndarray, R: np.ndarray) -> float:
    """Frames/sec of the reference's per-frame hot path on CPU via the same
    native libraries the reference binds (OpenCV). Returns 0.0 if cv2 is
    unavailable.

    Faithful to final_project: SIFT(2500) detect+describe both views
    (matching.py:27-35), crossCheck BFMatch stereo + rectified gate
    (matching.py:48-69), fwd+bwd temporal matching with mutual filter
    (database.py:54-77), per-link SVD triangulation (triangulation.py:5-24),
    then RANSAC with the adaptive iteration count (ransac.py:59-67), the
    per-iteration reprojection agreement test in BOTH current views
    (ransac.py:28-56) and a final all-inlier EPnP re-solve
    (ransac.py:190-193).
    """
    try:
        import cv2
    except Exception:
        return 0.0

    sift = cv2.SIFT_create(nfeatures=2500)
    bf = cv2.BFMatcher(cv2.NORM_L2, crossCheck=True)
    fx = fy = 718.856
    cx, cy, base = 607.1928, 185.2157, 0.5372
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    Pm = K @ np.eye(3, 4)
    Qm = K @ np.hstack([np.eye(3), [[-base], [0.0], [0.0]]])

    imgs = [(_as_u8(L[i]), _as_u8(R[i])) for i in range(BASELINE_FRAMES + 1)]

    def agreement_count(rvec, tvec, pts3, obs_l, obs_r, thresh=2.0):
        """Reference transformation_agreement (ransac.py:28-56): project the
        previous-frame 3D points into the current left AND right views and
        require both |dx| and |dy| under the pixel gate."""
        Rm, _ = cv2.Rodrigues(rvec)
        Xc = pts3 @ Rm.T + tvec.ravel()
        ok_z = Xc[:, 2] > 1e-6
        z = np.where(ok_z, Xc[:, 2], 1.0)
        ul = fx * Xc[:, 0] / z + cx
        vl = fy * Xc[:, 1] / z + cy
        ur = fx * (Xc[:, 0] - base) / z + cx
        good = (
            ok_z
            & (np.abs(ul - obs_l[:, 0]) < thresh)
            & (np.abs(vl - obs_l[:, 1]) < thresh)
            & (np.abs(ur - obs_r[:, 0]) < thresh)
            & (np.abs(vl - obs_r[:, 1]) < thresh)
        )
        return good

    prev = None
    inlier_frac = 0.55  # ref ex3.py:16-19 assumed outlier rate for frame 0
    t0 = time.perf_counter()
    for il, ir in imgs:
        kl, dl = sift.detectAndCompute(il, None)
        kr, dr = sift.detectAndCompute(ir, None)
        if dl is None or dr is None or len(kl) < 8 or len(kr) < 8:
            prev = None
            continue
        ms = bf.match(dl, dr)  # stereo match
        # rectified gate (matching.py:62-63)
        links = {}
        for m in ms:
            pl, pr = kl[m.queryIdx].pt, kr[m.trainIdx].pt
            if abs(pl[1] - pr[1]) < 2 and pl[0] > pr[0] + 2:
                links[m.queryIdx] = (pl, pr)
        if prev is not None:
            pkl, pdl, plinks = prev
            fwd = bf.match(pdl, dl)   # forward
            bwd = bf.match(dl, pdl)   # backward
            bwd_map = {m.queryIdx: m.trainIdx for m in bwd}
            mutual = [m for m in fwd if bwd_map.get(m.trainIdx) == m.queryIdx]
            # triangulate ALL previous links (per-point SVD, ref style)
            pts3_by_q = {}
            for qi, (pl, pr) in plinks.items():
                A = np.stack([
                    pl[0] * Pm[2] - Pm[0], pl[1] * Pm[2] - Pm[1],
                    pr[0] * Qm[2] - Qm[0], pr[1] * Qm[2] - Qm[1],
                ])
                _, _, Vt = np.linalg.svd(A)
                X = Vt[-1]
                pts3_by_q[qi] = X[:3] / X[3] if abs(X[3]) > 1e-9 else X[:3]
            # correspondences: prev-link 3D <-> current stereo pixels
            pts3, obs_l, obs_r = [], [], []
            for m in mutual:
                if m.queryIdx in pts3_by_q and m.trainIdx in links:
                    cl, cr = links[m.trainIdx]
                    pts3.append(pts3_by_q[m.queryIdx])
                    obs_l.append(cl)
                    obs_r.append(cr)
            pts3 = np.asarray(pts3)
            obs_l = np.asarray(obs_l, np.float64)
            obs_r = np.asarray(obs_r, np.float64)
            if len(pts3) >= 4:
                # adaptive iteration count (ransac.py:59-67), updated from
                # the running best inlier fraction
                rng = np.random.default_rng(0)
                best_n, best_rt = -1, None
                it, n_done = 0, 0
                def n_iters(w):
                    p4 = max(min(w, 0.999999) ** 4, 1e-12)
                    return int(math.ceil(math.log(1e-10) / math.log(1 - p4)))
                target = n_iters(inlier_frac)
                while n_done < min(target, 4000):
                    idx = rng.choice(len(pts3), 4, replace=False)
                    ok, rvec, tvec = cv2.solvePnP(
                        pts3[idx], obs_l[idx], K, None,
                        flags=cv2.SOLVEPNP_EPNP)
                    n_done += 1
                    if not ok:
                        continue
                    good = agreement_count(rvec, tvec, pts3, obs_l, obs_r)
                    n = int(good.sum())
                    if n > best_n:
                        best_n, best_rt = n, good
                        target = n_iters(max(n / len(pts3), 0.05))
                # final all-inlier re-solve (ransac.py:190-193)
                if best_rt is not None and best_rt.sum() >= 4:
                    cv2.solvePnP(pts3[best_rt], obs_l[best_rt], K, None,
                                 flags=cv2.SOLVEPNP_EPNP)
                    inlier_frac = max(best_n / len(pts3), 0.05)
        prev = (kl, dl, links)
    dt = time.perf_counter() - t0
    return BASELINE_FRAMES / dt if dt > 0 else 0.0


def bench_ba_windows() -> tuple[float, float]:
    """Batched-BA windows/sec at production shapes (P=24, L=512, M=4096),
    and its MFU (XLA-counted FLOPs / wall-clock / device bf16 peak)."""
    import jax
    import jax.numpy as jnp

    from slam_tpu.ops import ba
    from slam_tpu.utils.synthetic import KITTI_CALIB, ba_windows

    calib = KITTI_CALIB
    batch = ba_windows(jax.random.PRNGKey(3), BA_WINDOWS)

    solver = jax.jit(jax.vmap(
        lambda p0, x0, ci, li, ms, ww: ba.optimize_bundle_pruned(
            p0, x0, ci, li, ms, ww, calib, iters=20)
    ))
    compiled = solver.lower(*batch).compile()
    flops = _xla_flops(compiled)
    out = solver(*batch)  # warmup (compile cache is already hot)
    jax.block_until_ready(out[0])
    t0 = time.perf_counter()
    out = solver(*batch)
    jax.block_until_ready(out[0])
    dt = time.perf_counter() - t0
    return BA_WINDOWS / dt, flops / dt / device_peaks()["bf16_flops"]


def bench_e2e(L: np.ndarray, R: np.ndarray) -> float:
    """End-to-end pipeline fps on the rendered scene: frontend + track
    store + BA + pose graph + LOOP CLOSURE (gate + verification + LC pose
    graph), including all host stages — every per-sequence compute stage
    of the reference driver (project.py:27-94) except the matplotlib
    analysis/plot emission. Measured warm (second run, XLA compile cache
    populated): at 96 frames a cold run is >90% compilation, which
    amortizes to nothing over a real sequence."""
    from slam_tpu.pipeline import run_pipeline
    from slam_tpu.utils.synthetic import KITTI_CALIB

    calib = np.asarray(KITTI_CALIB)
    run_pipeline(L, R, calib, run_loop_closure=True, verbose=False)
    t0 = time.perf_counter()
    run_pipeline(L, R, calib, run_loop_closure=True, verbose=False)
    dt = time.perf_counter() - t0
    return L.shape[0] / dt


def _fail(stage: str, exc: BaseException) -> "typing.NoReturn":
    """Emit ONE diagnostic JSON line naming the failing bench stage.

    A compile failure anywhere in the bench would otherwise surface as a
    bare rc=1 with the error buried in a traceback. The metric name is
    neutral ("bench_failed") so tooling keyed on the frontend metric never
    attributes a BA/e2e failure to the frontend."""
    import traceback

    print(json.dumps({
        "metric": "bench_failed",
        "value": None,
        "unit": "frames/sec",
        "vs_baseline": None,
        "error": {
            "stage": stage,
            "type": type(exc).__name__,
            "msg": str(exc)[:2000],
            "lowering_failure": type(exc).__name__ in (
                "XlaRuntimeError", "InternalError",
                "UnimplementedError", "NotImplementedError",
            ) or "lowering" in str(exc).lower(),
        },
        "device": device_info(),
    }))
    traceback.print_exc()
    raise SystemExit(1)


def main() -> None:
    from slam_tpu.config import SlamConfig, enable_compile_cache

    # persistent XLA cache: steady-state numbers are unaffected (they are
    # measured after warmup); a warm cache only shortens set-up
    enable_compile_cache(SlamConfig().runtime)
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX's first device "
                         f"is {info}")
    device_peaks(info["kind"])  # unknown card: fail before any work
    L, R = make_images(BENCH_FRAMES)
    try:
        fps, mfu_fe = bench_frontend(L, R)
    except Exception as e:  # noqa: BLE001 — diagnostic funnel, re-raises
        _fail("frontend", e)
    # two independent baseline passes: the mean is the denominator, the
    # spread documents its stability
    try:
        ref_a = bench_cpu_reference(L, R)
        ref_b = bench_cpu_reference(L, R)
    except Exception as e:  # noqa: BLE001
        _fail("cpu_reference", e)
    ref_fps = 0.5 * (ref_a + ref_b) if (ref_a and ref_b) else (ref_a or ref_b)
    try:
        ba_wps, mfu_ba = bench_ba_windows()
    except Exception as e:  # noqa: BLE001
        _fail("ba", e)
    try:
        e2e_fps = bench_e2e(L, R)
    except Exception as e:  # noqa: BLE001
        _fail("e2e", e)
    vs = fps / ref_fps if ref_fps > 0 else float("nan")
    print(json.dumps({
        "metric": "frontend_fps_kitti_stereo_376x1241",
        "value": round(fps, 2),
        "unit": "frames/sec",
        "vs_baseline": round(vs, 2),
        "extra": {
            "cpu_reference_fps": round(ref_fps, 3),
            "cpu_reference_fps_runs": [round(ref_a, 3), round(ref_b, 3)],
            "ba_windows_per_sec_P24_L512_M4096": round(ba_wps, 2),
            "e2e_fps_incl_loop_closure": round(e2e_fps, 2),
            "mfu_frontend": round(mfu_fe, 4),
            "mfu_ba": round(mfu_ba, 4),
        },
        "device": info,
    }))


if __name__ == "__main__":
    main()
