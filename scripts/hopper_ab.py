"""On-card A/B of the implementation choices the GPU port had to make.

    python scripts/hopper_ab.py [--quick]

1. Matcher: the fused kernel (ops/match_kernel.py) against the dense XLA
   matcher, alone (32 stereo + 32 temporal pairs, K=2048, D=128) and inside
   the production ``frontend.process_chunk`` (32 frames, 376x1241, default
   SlamConfig). Both variants are compiled ahead of time in one process and
   timed in turns (dense, kernel, kernel, dense).
2. BA engine: scatter, onehot (f32 HIGHEST) and onehot_b3
   (BF16_BF16_F32_X3) at P24/L512/M4096 in 64-window batches: windows/s,
   and the pose gap of each engine to a float64 CPU solve of the same
   windows, beside the gap of a float32 CPU solve.

Prints one line per measurement with the card's name and power limit, and
writes everything to chiprun_out/hopper_ab.json. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from slam_tpu.config import SlamConfig  # noqa: E402
from slam_tpu.models import frontend  # noqa: E402
from slam_tpu.ops import ba, match_kernel, matching  # noqa: E402
from slam_tpu.utils import synthetic  # noqa: E402

OUT = {}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def timeit(fn, args, reps):
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


def turns(variants: dict, args_of, reps: int, rounds: int = 2) -> dict:
    """Time each variant in turns a, b, b, a (per round); ms per call."""
    names = list(variants)
    order = (names + names[::-1]) * rounds
    ms = {n: [] for n in names}
    for n in order:
        ms[n].append(timeit(variants[n], args_of(n), reps))
    return {n: {"ms": float(np.median(v)), "runs": v} for n, v in ms.items()}


def report(tag, res, unit="ms"):
    line = ", ".join(f"{k} {v['ms']:.3f} {unit}" for k, v in res.items())
    print(f"[{tag}] {line}  ({CARD})", flush=True)
    OUT[tag] = res


def matcher_ab(quick: bool, cfg: SlamConfig = SlamConfig(),
               hw=synthetic.KITTI_HW):
    K, D, F = cfg.features.max_kp, 128, cfg.runtime.chunk_frames
    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    a = jax.random.normal(ks[0], (2 * F, K, D))
    a = a / jnp.linalg.norm(a, axis=-1, keepdims=True)
    b = a + 0.3 * jax.random.normal(ks[1], a.shape)
    b = b / jnp.linalg.norm(b, axis=-1, keepdims=True)
    v = jnp.ones((2 * F, K), bool)
    xy = jax.random.uniform(ks[2], (2 * F, K, 2)) * jnp.array(hw[::-1], float)
    mc = cfg.matching
    win = (-mc.max_disparity, -mc.stereo_min_disp, mc.stereo_match_dy)
    fns = {
        "dense": jax.jit(jax.vmap(lambda *x: matching.dense_mutual_nearest(
            *x, window=win))),
        "kernel": jax.jit(jax.vmap(lambda *x: match_kernel.mutual_nearest(
            *x, window=win))),
    }
    args = (a, b, v, v, xy, xy + jnp.array([-30.0, 0.0]))
    report(f"matcher alone, {2 * F} windowed pairs K={K}",
           turns(fns, lambda n: args, reps=5 if quick else 20))

    # inside the production frontend chunk
    scene = synthetic.make_scene(
        jax.random.PRNGKey(0), num_frames=2 * F, num_landmarks=12000,
        hw=hw, step_m=1.0)
    L, R = synthetic.render_sequence(scene)
    u8 = lambda x: jnp.asarray(np.clip(x * 255, 0, 255).astype(np.uint8))
    L, R = u8(L), u8(R)
    calib = scene.calib
    key = jax.random.PRNGKey(0)
    raw = frontend.process_chunk.__wrapped__
    _, carry = frontend.process_chunk(L[:F], R[:F], None, calib, key, cfg)
    compiled = {}
    for name, use in (("dense", False), ("kernel", True)):
        # tracing caches are keyed on the function, not on the patched
        # routing: clear them so each variant is traced afresh
        jax.clear_caches()
        with mock.patch.object(match_kernel, "eligible",
                               lambda *_, use=use: use):
            t0 = time.perf_counter()
            lowered = jax.jit(raw, static_argnames=("cfg",)).lower(
                L[F:], R[F:], carry, calib, key, cfg)
            calls = lowered.as_text().count("row_nearest")
            compiled[name] = lowered.compile()
            print(f"[process_chunk {name}] compiled in "
                  f"{time.perf_counter() - t0:.1f} s; kernel call sites "
                  f"{calls}", flush=True)
    outs = {n: c(L[F:], R[F:], carry, calib, key)[0]
            for n, c in compiled.items()}
    agree = float(jnp.mean(outs["dense"]["match_prev"]
                           == outs["kernel"]["match_prev"]))
    tag = f"process_chunk {F} frames {hw[0]}x{hw[1]}"
    report(tag, turns(compiled, lambda n: (L[F:], R[F:], carry, calib, key),
                      reps=3 if quick else 10))
    OUT[tag]["match_prev_agree"] = agree
    print(f"[process_chunk] temporal match agreement dense vs kernel: "
          f"{agree:.5f}", flush=True)


def _pose_gap(P, Q):
    """Max translation (m) and rotation (deg) gap between pose stacks, in
    float64 on the host."""
    P = np.asarray(P, np.float64).reshape(-1, 4, 4)
    Q = np.asarray(Q, np.float64).reshape(-1, 4, 4)
    D = np.linalg.inv(P) @ Q
    R = D[:, :3, :3]
    # atan2 of the skew and the trace parts: accurate at tiny angles,
    # where arccos of the trace alone is dominated by rounding
    skew = np.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0],
                     R[:, 1, 0] - R[:, 0, 1]], axis=-1)
    ang = np.arctan2(np.linalg.norm(skew, axis=-1) / 2,
                     (np.trace(R, axis1=1, axis2=2) - 1) / 2)
    return (float(np.linalg.norm(D[:, :3, 3], axis=-1).max()),
            float(np.degrees(ang).max()))


def ba_ab(quick: bool, n_ref: int, B: int = 64, P: int = 24, L: int = 512,
          M: int = 4096):
    calib = synthetic.KITTI_CALIB
    batch = synthetic.ba_windows(jax.random.PRNGKey(3), B, P, L, M)
    engines = ("scatter", "onehot", "onehot_b3")

    def solver(engine):
        return jax.jit(jax.vmap(
            lambda p0, x0, ci, li, ms, ww: ba.optimize_bundle_pruned(
                p0, x0, ci, li, ms, ww, calib, iters=20, engine=engine)))

    fns, prec = {}, {}
    for e in engines:
        t0 = time.perf_counter()
        lowered = solver(e).lower(*batch)
        text = lowered.as_text()
        prec[e] = {"HIGHEST": text.count("HIGHEST"),
                   "bf16x3": text.count("num_primitive_operations = 3"),
                   "tf32": text.count("tf32")}
        fns[e] = lowered.compile()
        print(f"[ba {e}] compiled in {time.perf_counter() - t0:.1f} s; "
              f"dot precision markers in StableHLO: {prec[e]}", flush=True)
    poses = {e: np.asarray(f(*batch)[0]) for e, f in fns.items()}

    # float64 reference solve of the first n_ref windows on the host CPU,
    # and the same solve in float32 there: its gap to float64 is the
    # float32 floor each GPU engine is held to
    cpu = jax.devices("cpu")[0]

    def host_solve(dtype):
        with jax.default_device(cpu):
            host = [jnp.asarray(np.asarray(x)[:n_ref]) for x in batch]
            host = [x.astype(dtype) if x.dtype == jnp.float32 else x
                    for x in host]
            out = jax.jit(jax.vmap(
                lambda p0, x0, ci, li, ms, ww: ba.optimize_bundle_pruned(
                    p0, x0, ci, li, ms, ww, jnp.asarray(calib, dtype),
                    iters=20, engine="scatter")))(*host)
            return np.asarray(out[0])

    t0 = time.perf_counter()
    with jax.enable_x64():
        ref_poses = host_solve(jnp.float64)
    cpu32 = _pose_gap(host_solve(jnp.float32), ref_poses)
    print(f"[ba f64 reference] {n_ref} windows on the host CPU in "
          f"{time.perf_counter() - t0:.1f} s; host f32 scatter gap to f64: "
          f"{cpu32[0]:.2e} m, {cpu32[1]:.2e} deg", flush=True)

    res = turns(fns, lambda e: batch, reps=3 if quick else 5)
    for e in engines:
        t_gap, r_gap = _pose_gap(poses[e][:n_ref], ref_poses)
        res[e].update(windows_per_s=B / res[e]["ms"] * 1e3,
                      gap_to_f64_m=t_gap, gap_to_f64_deg=r_gap,
                      precision_markers=prec[e])
        print(f"[ba {e}] {res[e]['ms']:.2f} ms per {B} windows = "
              f"{res[e]['windows_per_s']:.1f} windows/s; pose gap to f64: "
              f"{t_gap:.2e} m, {r_gap:.2e} deg  ({CARD})", flush=True)
    res["host_f32_gap_to_f64"] = {"m": cpu32[0], "deg": cpu32[1]}
    OUT[f"ba engines P{P}/L{L}/M{M} x{B}"] = res


def main():
    global CARD
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--n-ref", type=int, default=8)
    ap.add_argument("--only", default="matcher,ba")
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("hopper_ab.py measures the GPU")
    CARD = card()
    OUT["card"] = CARD
    OUT["device_kind"] = jax.devices()[0].device_kind
    print(f"card: {CARD}; {jax.devices()[0].device_kind}", flush=True)
    only = args.only.split(",")
    if "matcher" in only:
        matcher_ab(args.quick)
    if "ba" in only:
        ba_ab(args.quick, args.n_ref)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "hopper_ab.json").write_text(json.dumps(OUT, indent=1,
                                                   default=str))


CARD = ""

if __name__ == "__main__":
    main()
