"""TP mega-bundle at its claimed regime: tens of thousands of landmarks.

optimize_megabundle's docstring claims
the "city-block mega-bundle" regime but had only been exercised at
L=520 (tests) and L=67 (dryrun). This builds ONE bundle with L>=16k
landmarks / M>=128k observations, shards it over an 8-device mesh, and
measures wall-clock + convergence. The per-device memory argument is
the point: each device holds M/8 observations' blocks and L/8 landmark
Hessians; only the (6P,6P) psum crosses devices.

Default: every device of JAX's default backend (one GPU is the
degenerate mesh; still the production program). ``--cpu-mesh`` runs on a
virtual 8-device CPU mesh to exercise the actual landmark sharding + psum
(it forces the CPU platform through the config API like
tests/conftest.py).

Usage: bench_tp_megabundle.py [P L M ITERS] [--cpu-mesh] [--out=...]
"""

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

if "--cpu-mesh" in sys.argv:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

P_, L, M, ITERS = 24, 16384, 131072, 15
pos = [a for a in sys.argv[1:] if not a.startswith("--")]
if pos:
    P_, L, M, ITERS = map(int, pos[:4])
OUT = Path("runs/tp_megabundle.json")
for a in sys.argv[1:]:
    if a.startswith("--out="):
        OUT = Path(a.split("=", 1)[1])


def main() -> int:
    import jax
    import jax.numpy as jnp

    from slam_tpu.ops import se3, stereo
    from slam_tpu.parallel import tp_megabundle as tpm

    n_dev = len(jax.devices())
    mesh = jax.make_mesh((n_dev,), ("tp",))
    print(f"[tp-mega] backend={jax.default_backend()} n_dev={n_dev} "
          f"P={P_} L={L} M={M} iters={ITERS}", flush=True)

    rng = np.random.default_rng(0)
    calib = np.asarray([718.856, 718.856, 607.1928, 185.2157, 0.5371657],
                       np.float32)
    # forward-moving camera chain, landmarks in a deep frustum
    gt_poses = np.zeros((P_, 4, 4), np.float32)
    gt_poses[0] = np.eye(4)
    for i in range(1, P_):
        d = np.eye(4, dtype=np.float32)
        d[:3, 3] = [0.05 * rng.standard_normal(), 0.0, 1.5]
        gt_poses[i] = d @ gt_poses[i - 1]
    pts = rng.uniform([-25, -6, 4], [25, 6, 90], (L, 3)).astype(np.float32)
    cam_idx = rng.integers(0, P_, M).astype(np.int32)
    lm_idx = rng.integers(0, L, M).astype(np.int32)
    w = np.ones(M, np.float32)
    T = jnp.asarray(gt_poses)[cam_idx]
    X = jnp.asarray(pts)[lm_idx]
    Xc = se3.mv3(T[:, :3, :3], X) + T[:, :3, 3]
    meas = np.array(stereo.project(jnp.asarray(calib), Xc))
    behind = np.asarray(Xc)[:, 2] < 0.5
    w[behind] = 0.0
    meas += rng.normal(0, 0.3, meas.shape).astype(np.float32)

    # perturbed init: the solver has real work to do
    poses0 = np.asarray(jax.vmap(se3.retract)(
        jnp.asarray(gt_poses),
        jnp.asarray(rng.normal(0, 0.01, (P_, 6)), jnp.float32)))
    pts0 = pts + rng.normal(0, 0.5, pts.shape).astype(np.float32)

    t0 = time.perf_counter()
    shards = tpm.partition_megabundle(pts0, cam_idx, lm_idx, meas, w, n_dev)
    t_part = time.perf_counter() - t0
    L_loc, M_loc = shards[0].shape[1], shards[1].shape[1]

    t0 = time.perf_counter()
    poses, X_out, cost, cost0 = tpm.optimize_megabundle(
        mesh, poses0, *shards, calib, iters=ITERS)
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    tpm.optimize_megabundle(mesh, poses0, *shards, calib, iters=ITERS)
    t_warm = time.perf_counter() - t0

    pose_err0 = float(np.linalg.norm(
        poses0[:, :3, 3] - gt_poses[:, :3, 3], axis=1).mean())
    pose_err = float(np.linalg.norm(
        np.asarray(poses)[:, :3, 3] - gt_poses[:, :3, 3], axis=1).mean())
    report = {
        "backend": jax.default_backend(), "n_dev": n_dev,
        "P": P_, "L": L, "M": M, "iters": ITERS,
        "L_loc": int(L_loc), "M_loc": int(M_loc),
        "partition_s": round(t_part, 2),
        "optimize_cold_s": round(t_cold, 2),
        "optimize_warm_s": round(t_warm, 2),
        "cost0": cost0, "cost": cost,
        "pose_err0_m": round(pose_err0, 4), "pose_err_m": round(pose_err, 4),
    }
    print("[tp-mega] " + json.dumps(report), flush=True)
    assert cost < 0.5 * cost0, (cost, cost0)
    # the 0.3 px measurement noise bounds the recoverable pose error;
    # ~0.5x of a 1 cm perturbation is the observed noise-limited floor
    assert pose_err < 0.75 * pose_err0, (pose_err, pose_err0)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(report, indent=2))
    print(f"[tp-mega] written: {OUT}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
