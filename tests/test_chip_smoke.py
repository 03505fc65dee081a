"""chip_smoke.py: its phases at tiny size on the CPU, its refusal to run
anywhere but on a GPU, and (``gpu`` marker) the whole script on a card.

The phases are the same functions the script runs at production shapes
on the GPU; here they run at a few hundred keypoints on 160x320 images.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from slam_tpu.config import (
    BundleConfig, FeatureConfig, KeyframeConfig, LoopConfig, RansacConfig,
    RuntimeConfig, SlamConfig,
)

REPO = Path(__file__).resolve().parent.parent

TINY = SlamConfig(
    features=FeatureConfig(max_kp=512, border=8),
    ransac=RansacConfig(num_hypotheses=192),
    runtime=RuntimeConfig(chunk_frames=10),
    keyframes=KeyframeConfig(min_gap=2, max_gap=6, max_dist_m=6.0,
                             max_angle_deg=25.0),
    bundle=BundleConfig(max_poses=8, max_landmarks=256, max_obs=1024,
                        lm_iters=10),
    loop=LoopConfig(mahalanobis_thresh=300.0, min_inliers=40,
                    keyframe_gap=5, max_candidates=8),
)


def _script_env():
    """The environment of a fresh process: no CPU pin from the tests."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "host_platform_device_count" not in f)
    return env


def _last_line(text):
    lines = text.strip().splitlines()
    return lines[-1] if lines else ""


def test_compile_phase_reports_memory_of_every_program(capsys):
    out = chip_smoke.compile_phase(TINY, hw=(64, 128), ba_batch=2)
    assert set(out) == {
        "frontend.process_chunk (first chunk)",
        "frontend.process_chunk (carried)",
        "ba.optimize_bundle_pruned x2 (scatter)",
        "pose_graph.optimize", "pose_graph.gate_matrix",
        "loop_closure.verify"}
    printed = capsys.readouterr().out
    assert printed.count(", temp ") == 6 and "peak_bytes_in_use" in printed


def test_preflight_refuses_a_machine_without_gpu():
    # no nvidia-smi, or JAX's first device is the CPU (the tests pin it)
    with pytest.raises((OSError, RuntimeError, subprocess.SubprocessError)):
        chip_smoke.preflight()


def test_script_exits_nonzero_without_gpu():
    env = _script_env()
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = _script_env()
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_main_path_closes_the_loop_and_compiles_nothing_warm():
    out = chip_smoke.main_path(TINY, frames=100, hw=(160, 320),
                               landmarks=6000)
    assert out["closures"] >= 1
    assert out["warm_compiles"] == 0
    assert out["ate_m"]["pose_graph_lc_kf"] <= 0.01 * out["path_m"]


def test_check_run_rejects_a_run_without_closure(monkeypatch):
    class Graph:
        nodes = np.tile(np.eye(4), (3, 1, 1))
        keyframes = [0, 1, 2]

    class Result:
        closures = []
        pose_graph = pose_graph_pre_lc = Graph()
        T_frontend = np.tile(np.eye(4), (3, 1, 1))

    report = {"num_closures": 0, "frontend": {"ate_rmse_m": 0.0},
              "pose_graph_lc_kf": {"ate_rmse_m": 0.0}}
    monkeypatch.setattr(chip_smoke.pipeline, "evaluate",
                        lambda res, T_gt: report)
    T_gt = np.tile(np.eye(4), (3, 1, 1))
    with pytest.raises(AssertionError, match="no loop closure"):
        chip_smoke.check_run(Result(), T_gt, 10.0)
    # a closure, but the closed trajectory misses the ATE bound
    report.update(num_closures=1, pose_graph_lc_kf={"ate_rmse_m": 0.5})
    with pytest.raises(AssertionError, match="post-closure ATE"):
        chip_smoke.check_run(Result(), T_gt, 10.0)


@pytest.mark.gpu
def test_chip_smoke_on_the_gpu():
    """The whole script on a card: rc 0 and the contract's last line."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True,
                                     timeout=60).returncode != 0:
        pytest.skip("no NVIDIA GPU on this machine")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=_script_env(), capture_output=True, text=True,
                          timeout=1200)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    last = json.loads(_last_line(proc.stdout))
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
    assert last["device"]["count"] == 1
