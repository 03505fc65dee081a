"""Nonlinear scale-space (AKAZE-style) detector tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_tpu.ops import akaze, features, matching
from tests.test_features_matching import textured_image


def test_diffusion_preserves_edges_blurs_flats():
    # step edge + smooth gradient: diffusion must smooth the flat region
    # more than it erodes the edge
    img = jnp.zeros((64, 64)).at[:, 32:].set(1.0)
    noise = 0.05 * jax.random.normal(jax.random.PRNGKey(0), (64, 64))
    noisy = img + noise
    k = akaze._contrast_k(noisy)
    out = akaze.diffuse(noisy, k, steps=8)
    # noise variance in flat region drops substantially
    flat_before = float(jnp.var(noisy[:, :20]))
    flat_after = float(jnp.var(out[:, :20]))
    assert flat_after < 0.5 * flat_before
    # edge contrast survives
    edge_jump = float(jnp.mean(out[:, 40:50]) - jnp.mean(out[:, 10:20]))
    assert edge_jump > 0.8


def test_akaze_detects_and_describes():
    img = textured_image(jax.random.PRNGKey(1), h=128, w=256)
    out = akaze.detect_and_describe_akaze(img, max_kp=256, octaves=2)
    assert out["xy"].shape == (256, 2)
    assert out["desc"].shape == (256, 128)
    assert int(jnp.sum(out["valid"])) > 50
    xy = np.asarray(out["xy"])[np.asarray(out["valid"])]
    assert (xy[:, 0] < 256).all() and (xy[:, 1] < 128).all()


def test_akaze_matches_shifted_image():
    img = textured_image(jax.random.PRNGKey(2), h=128, w=256)
    shifted = jnp.roll(img, -6, axis=1)
    a = akaze.detect_and_describe_akaze(img, max_kp=256, octaves=2)
    b = akaze.detect_and_describe_akaze(shifted, max_kp=256, octaves=2)
    m = matching.mutual_match(a["desc"], b["desc"], a["valid"], b["valid"])
    matched = np.asarray(m["matched"])
    assert matched.sum() > 20
    ia = np.nonzero(matched)[0]
    ib = np.asarray(m["target_idx"])[ia]
    dx = np.asarray(b["xy"])[ib, 0] - np.asarray(a["xy"])[ia, 0]
    # majority recover the -6 px shift
    assert np.mean(np.abs(dx + 6) < 2) > 0.7


def test_akaze_batch_matches_single_image_contract():
    """detect_and_describe_akaze_batch (jnp path) is exactly
    vmap(detect_and_describe_akaze)."""
    imgs = jnp.stack([
        textured_image(jax.random.PRNGKey(4), h=128, w=256),
        textured_image(jax.random.PRNGKey(5), h=128, w=256),
    ])
    batch = akaze.detect_and_describe_akaze_batch(
        imgs, max_kp=256, octaves=2
    )
    single = jax.vmap(
        lambda im: akaze.detect_and_describe_akaze(im, max_kp=256, octaves=2)
    )(imgs)
    for key in ("xy", "desc", "valid", "resp", "scale"):
        np.testing.assert_array_equal(np.asarray(batch[key]),
                                      np.asarray(single[key]), err_msg=key)


@pytest.mark.slow
def test_frontend_with_akaze_detector():
    from slam_tpu.config import (
        FeatureConfig, RansacConfig, RuntimeConfig, SlamConfig,
    )
    from slam_tpu.models import frontend
    from slam_tpu.utils import metrics, synthetic

    cfg = SlamConfig(
        features=FeatureConfig(max_kp=384, border=8, detector="akaze"),
        ransac=RansacConfig(num_hypotheses=128),
        runtime=RuntimeConfig(chunk_frames=5),
    )
    scene = synthetic.make_scene(
        jax.random.PRNGKey(9), num_frames=10, num_landmarks=2000,
        hw=(128, 256), step_m=0.8,
    )
    L, R = synthetic.render_sequence(scene)
    res = frontend.run_frontend(L, R, scene.calib, cfg)
    assert (res.num_inliers[1:] > 10).all(), res.num_inliers
    ate = metrics.ate_rmse(res.T_w2c, np.asarray(scene.T_w2c))
    assert ate < 0.5, ate
