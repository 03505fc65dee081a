"""Config serialization, profiling utilities, misc metrics."""

import json
import time

import numpy as np

from slam_tpu.config import (
    BundleConfig, FeatureConfig, LoopConfig, SlamConfig,
)
from slam_tpu.utils import metrics
from slam_tpu.utils.profiling import StageTimer, log


def test_enable_compile_cache_sets_stable_key_flags(tmp_path, monkeypatch):
    """The persistent compile cache is only useful if its keys are stable
    across processes: Pallas kernels embed trace-site tracebacks in the
    custom-call payload (out of reach of strip-debuginfo), so full
    tracebacks MUST be off. Without JAX_COMPILATION_CACHE_DIR the cache
    lives at the configured fixed path (relative paths from the checkout
    root)."""
    import jax

    from slam_tpu.config import CHECKOUT_ROOT, RuntimeConfig, enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    saved = jax.config.jax_compilation_cache_dir
    try:
        enable_compile_cache(RuntimeConfig(compile_cache_dir=str(tmp_path / "xla")))
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "xla")
        assert (tmp_path / "xla").is_dir()
        assert jax.config.jax_include_full_tracebacks_in_locations is False
        assert RuntimeConfig().compile_cache_dir == ".jax_cache"
        assert (CHECKOUT_ROOT / "slam_tpu" / "config.py").is_file()
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)


def test_enable_compile_cache_defers_to_environment(tmp_path, monkeypatch):
    """Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it and the code
    sets no other directory."""
    import jax

    from slam_tpu.config import RuntimeConfig, enable_compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    saved = jax.config.jax_compilation_cache_dir
    try:
        enable_compile_cache(RuntimeConfig(compile_cache_dir=str(tmp_path / "cfg")))
        assert jax.config.jax_compilation_cache_dir == saved
        assert not (tmp_path / "cfg").exists()
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)


def test_config_json_roundtrip(tmp_path):
    cfg = SlamConfig(
        features=FeatureConfig(max_kp=1024, detector="akaze"),
        bundle=BundleConfig(max_poses=16),
        loop=LoopConfig(min_inliers=77),
        seed=42,
    )
    p = tmp_path / "cfg.json"
    cfg.save(p)
    loaded = SlamConfig.load(p)
    assert loaded == cfg
    assert loaded.features.detector == "akaze"
    assert loaded.loop.min_inliers == 77


def test_config_defaults_match_reference_thresholds():
    """The reference's published thresholds must be the defaults
    (BASELINE.md rows)."""
    cfg = SlamConfig()
    assert cfg.loop.mahalanobis_thresh == 220.0   # loop_closure.py:15
    assert cfg.loop.min_inliers == 120            # loop_closure.py:17
    assert cfg.loop.max_candidates == 15          # loop_closure.py:18
    assert cfg.loop.keyframe_gap == 10            # loop_closure.py:19
    assert cfg.keyframes.min_gap == 5             # bundle.py:233
    assert cfg.keyframes.max_gap == 21
    assert cfg.keyframes.max_dist_m == 8.0
    assert cfg.matching.stereo_dy == 2.0          # matching.py:62
    assert cfg.bundle.max_depth == 1000.0         # bundle.py:184
    assert cfg.features.akaze_threshold == 8e-4   # matching.py:20


def test_stage_timer_nesting():
    t = StageTimer()
    with t.span("outer"):
        time.sleep(0.01)
        with t.span("inner"):
            time.sleep(0.01)
    rep = t.report()
    assert "outer" in rep and "outer.inner" in rep
    assert rep["outer"] >= rep["outer.inner"] > 0.005


def test_stage_timer_save(tmp_path):
    t = StageTimer()
    with t.span("a"):
        pass
    t.save(tmp_path / "t.json")
    assert "a" in json.loads((tmp_path / "t.json").read_text())


def test_log_does_not_crash():
    log("event", frames=10, fps=1.5)


def test_dist_traveled():
    T = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    # camera centers at z = 0, 1, 3, 6  (T_w2c: t = -R c = -c)
    for i, z in enumerate([0.0, 1.0, 3.0, 6.0]):
        T[i, 2, 3] = -z
    d = metrics.dist_traveled(T)
    np.testing.assert_allclose(d, [0.0, 1.0, 3.0, 6.0], atol=1e-6)


def _random_trajectory(rng, F):
    """Smooth random SE(3) trajectory as (F, 4, 4) w2c extrinsics."""
    T = np.tile(np.eye(4, dtype=np.float64), (F, 1, 1))
    ang = 0.0
    pos = np.zeros(3)
    for i in range(1, F):
        ang += rng.normal(0.0, 0.02)
        c, s = np.cos(ang), np.sin(ang)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        pos = pos + R @ np.array([0.0, 0.0, 0.8 + rng.normal(0, 0.05)])
        T[i, :3, :3] = R.T
        T[i, :3, 3] = -R.T @ pos
    return T


def test_relative_subsequence_error_matches_loop_reference():
    """The vectorized sub-section errors must equal the direct per-start
    loop definition (reference analysis.py:801-920 semantics)."""
    rng = np.random.default_rng(0)
    T_gt = _random_trajectory(rng, 60)
    T_est = T_gt.copy()
    T_est[:, :3, 3] += rng.normal(0.0, 0.01, size=(60, 3))
    lengths = (7, 20)

    got = metrics.relative_subsequence_error(T_est, T_gt, lengths)
    C_gt = metrics.camera_centers(T_gt)
    for L in lengths:
        t_errs, r_errs = [], []
        for f in range(60 - L):
            rel_est = T_est[f + L] @ np.linalg.inv(T_est[f])
            rel_gt = T_gt[f + L] @ np.linalg.inv(T_gt[f])
            seg = np.linalg.norm(np.diff(C_gt[f:f + L + 1], axis=0), axis=-1)
            dist = float(np.sum(seg))
            if dist < 1e-6:
                continue
            err = rel_est @ np.linalg.inv(rel_gt)
            t_errs.append(np.linalg.norm(err[:3, 3]) / dist)
            tr = np.clip((np.trace(err[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
            r_errs.append(np.degrees(np.arccos(tr)) / dist)
        np.testing.assert_allclose(
            got[L]["trans_m_per_m_mean"], np.mean(t_errs), rtol=1e-9)
        np.testing.assert_allclose(
            got[L]["trans_m_per_m_median"], np.median(t_errs), rtol=1e-9)
        np.testing.assert_allclose(
            got[L]["rot_deg_per_m_mean"], np.mean(r_errs), rtol=1e-7)
        np.testing.assert_allclose(
            got[L]["rot_deg_per_m_median"], np.median(r_errs), rtol=1e-7)

    # curves agree with the summary's per-start values
    curves = metrics.relative_subsequence_curves(T_est, T_gt, lengths)
    for L in lengths:
        assert curves[L]["trans_m_per_m"].shape == (60 - L,)


def test_relative_subsequence_error_zero_motion_skipped():
    """Stationary starts (dist < 1e-6) are excluded, not divided by eps."""
    F = 10
    T = np.tile(np.eye(4, dtype=np.float64), (F, 1, 1))  # no motion at all
    out = metrics.relative_subsequence_error(T, T, (3,))
    assert out == {}


def test_envelope_decimation_preserves_extremes():
    from slam_tpu.utils.analysis import _envelope, _stride

    rng = np.random.default_rng(1)
    y = rng.normal(size=5000)
    y[1234] = 40.0   # spike up
    y[4321] = -40.0  # spike down
    x = np.arange(5000)
    xd, yd = _envelope(x, y, cols=700)
    assert len(yd) == 1400
    assert yd.max() == 40.0 and yd.min() == -40.0
    assert np.all(np.diff(xd) >= 0)  # x stays sorted for plotting
    # extremes are emitted at their TRUE x positions
    assert xd[np.argmax(yd)] == 1234
    assert xd[np.argmin(yd)] == 4321

    # small inputs pass through untouched
    xs, ys = _envelope(x[:100], y[:100], cols=700)
    np.testing.assert_array_equal(ys, y[:100])
    assert len(ys) == 100

    # stride keeps endpoints
    pts = np.stack([x, y], axis=-1)
    sub = _stride(pts, max_pts=500)
    assert len(sub) <= 502
    np.testing.assert_array_equal(sub[0], pts[0])
    np.testing.assert_array_equal(sub[-1], pts[-1])
