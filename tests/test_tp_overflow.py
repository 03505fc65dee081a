"""TP mega-bundle overflow routing through the production pipeline.

Windows that overflow the static
(max_landmarks, max_obs) capacity must route to the landmark-sharded TP
solver when a mesh is present (models/bundle.py reoptimize_overflow_tp),
re-solved at FULL observation count — the no-drop behavior the reference
gets from dynamic factor graphs (bundle.py:129-169).
"""

import jax
import numpy as np
import pytest

from slam_tpu.config import (
    BundleConfig, FeatureConfig, KeyframeConfig, RansacConfig, RuntimeConfig,
    SlamConfig,
)
from slam_tpu import pipeline
from slam_tpu.parallel import mesh as mesh_lib
from slam_tpu.utils import metrics, synthetic

# deliberately tiny window capacity: every window overflows and routes
TIGHT = SlamConfig(
    features=FeatureConfig(max_kp=256, border=8),
    ransac=RansacConfig(num_hypotheses=96),
    runtime=RuntimeConfig(chunk_frames=2),
    keyframes=KeyframeConfig(min_gap=2, max_gap=6, max_dist_m=5.0),
    bundle=BundleConfig(max_poses=8, max_landmarks=48, max_obs=96,
                        lm_iters=8),
)


@pytest.mark.slow
def test_overflow_windows_route_to_tp_and_match_capacity_solve():
    scene = synthetic.make_scene(
        jax.random.PRNGKey(23), num_frames=16, num_landmarks=2000,
        hw=(128, 256), step_m=0.8,
    )
    L, R = synthetic.render_sequence(scene)
    gt = np.asarray(scene.T_w2c)
    m = mesh_lib.make_mesh()

    res_tp = pipeline.run_pipeline(
        np.asarray(L), np.asarray(R), scene.calib, TIGHT,
        run_loop_closure=False, verbose=False, mesh=m,
    )
    # the TP path fired: re-solved windows carry their FULL observation
    # count, which exceeds the static max_obs capacity by construction
    assert (res_tp.bundles.num_obs > TIGHT.bundle.max_obs).any(), \
        res_tp.bundles.num_obs
    # and their covariances are real SPD noise models, not placeholders
    routed = np.nonzero(res_tp.bundles.num_obs > TIGHT.bundle.max_obs)[0]
    for bi in routed:
        eig = np.linalg.eigvalsh(res_tp.bundles.rel_cov[bi])
        assert (eig > 0).all(), (bi, eig)

    # truncated-only reference solve (same config, no mesh => no TP)
    res_cut = pipeline.run_pipeline(
        np.asarray(L), np.asarray(R), scene.calib, TIGHT,
        run_loop_closure=False, verbose=False, mesh=None,
    )
    kfs = res_tp.bundles.keyframes
    ate_tp = metrics.ate_rmse(res_tp.bundles.T_w2c_keyframes, gt[kfs])
    ate_cut = metrics.ate_rmse(res_cut.bundles.T_w2c_keyframes, gt[kfs])
    # full-observation windows must be at least as accurate as truncated
    # ones (small slack: different solve path, f32 reduction order)
    assert ate_tp <= ate_cut * 1.1 + 0.02, (ate_tp, ate_cut)
    assert ate_tp < 0.3, ate_tp
