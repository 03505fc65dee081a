"""Sparse selected-inverse pose-graph path against the dense one.

``ops/pg_sparse.py`` exists to save the pose graph above
SPARSE_NODE_THRESHOLD (=1024) keyframes, but production runs at 653 and
the sparse tests run on CPU. This script builds a 2560-keyframe graph with
reference-scale-stiff whitening (tests/test_pose_graph_scale.py
generator), runs optimize / gate sweep / marginal logdets through the
PoseGraph routing (which picks the sparse path at this N), and times the
dense path on the same graph for comparison (its (6N)^2 covariance is
0.94 GB at this N — it still fits the device, which is what makes the
comparison measurable).

Match: gtsam.Marginals scalability (reference pose_graph.py:7-24).

Usage: python scripts/bench_pg_sparse_chip.py [--n 2560] [--out runs/pg_sparse_chip.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))


def timed(fn, warm: int = 1):
    """(cold_s, warm_s, result): first call pays compile, then best-of-warm."""
    t0 = time.perf_counter()
    out = fn()
    cold = time.perf_counter() - t0
    best = np.inf
    for _ in range(warm):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return cold, best, out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2560)
    ap.add_argument("--out", type=Path,
                    default=Path("runs/pg_sparse_chip.json"))
    args = ap.parse_args()

    import jax

    from slam_tpu.models import pose_graph as pg_model
    from test_pose_graph_scale import make_stiff_loop_graph

    backend = jax.default_backend()
    print(f"[pg-chip] backend: {backend}, N={args.n}", flush=True)
    N = args.n
    rng = np.random.default_rng(1)
    # candidate gate pairs: the production sweep prices every revisit
    # candidate; 8192 pairs matches the _PAIR_PAD bucket
    pi = rng.integers(1, N, 8192).astype(np.int32)
    pj = rng.integers(1, N, 8192).astype(np.int32)

    report = {"backend": backend, "n_nodes": N}
    for path in ("sparse", "dense"):
        pg, _ = make_stiff_loop_graph(N)
        if path == "sparse":
            assert pg._use_sparse(), "N below SPARSE_NODE_THRESHOLD"
        else:
            # force the dense route on the same graph
            pg_model.SPARSE_NODE_THRESHOLD, saved = 10 ** 9, \
                pg_model.SPARSE_NODE_THRESHOLD
        try:
            c_opt, w_opt, cost = timed(lambda: pg.optimize(iters=15))
            c_gate, w_gate, d = timed(lambda: pg.gate_distances(pi, pj))
            c_ld, w_ld, (ld_loc, ld_rot) = timed(
                lambda: pg.marginal_logdets())
        except Exception as e:  # noqa: BLE001 — infeasibility IS a result
            # the dense (6N)^2 path may fail to compile or to fit at
            # large N — that infeasibility is the sparse path's reason to
            # exist; record it instead of crashing the bench
            msg = "\n".join(str(e).splitlines()[:3])
            report[path] = {"infeasible": True, "error": msg}
            print(f"[pg-chip] {path}: INFEASIBLE: {msg}", flush=True)
            continue
        finally:
            if path == "dense":
                pg_model.SPARSE_NODE_THRESHOLD = saved
        report[path] = {
            "optimize_cold_s": round(c_opt, 2),
            "optimize_warm_s": round(w_opt, 3),
            "final_cost": float(cost),
            "gate_cold_s": round(c_gate, 2),
            "gate_warm_s": round(w_gate, 3),
            "gate_finite_frac": float(np.isfinite(d).mean()),
            "gate_d_median": float(np.median(d[np.isfinite(d)])),
            "logdets_cold_s": round(c_ld, 2),
            "logdets_warm_s": round(w_ld, 3),
            "logdet_loc_median": float(np.median(ld_loc[1:])),
        }
        print(f"[pg-chip] {path}: " + json.dumps(report[path]), flush=True)
        if path == "sparse":
            sparse_d, sparse_ld = d.copy(), ld_loc.copy()
        elif "sparse" in report and not report["sparse"].get("infeasible"):
            m = np.isfinite(d) & np.isfinite(sparse_d)
            report["agreement"] = {
                "gate_median_abs_diff": float(
                    np.median(np.abs(d[m] - sparse_d[m]))),
                "logdet_loc_max_abs_diff": float(
                    np.max(np.abs(ld_loc[1:] - sparse_ld[1:]))),
            }
            print("[pg-chip] agreement: "
                  + json.dumps(report["agreement"]), flush=True)

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=2))
    print(f"[pg-chip] written: {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
