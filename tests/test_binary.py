"""NORM_HAMMING matching path (ops/binary.py).

Parity target: ``cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True)`` over
binary descriptors (reference final_project/algorithms/matching.py:19-24,
the headline AKAZE configuration). The design stores each bit as a ±1
bf16 lane so XOR-popcount becomes an exact matmul dot product; these tests pin
that exactness against a packed-bit host popcount and pin the mutual-match
decisions against a brute-force crossCheck matcher.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_tpu.config import (FeatureConfig, MatchConfig, RansacConfig,
                             RuntimeConfig, SlamConfig)
from slam_tpu.ops import binary, matching


def _rand_signs(key, k, d=128):
    return jnp.where(jax.random.bernoulli(key, 0.5, (k, d)), 1.0, -1.0)


def test_mxu_form_is_exact_hamming():
    """(2 - 2 s_a.s_b) is affine in Hamming distance, bit-exactly."""
    ka, kb, d = 96, 64, 128
    sa = _rand_signs(jax.random.PRNGKey(0), ka, d)
    sb = _rand_signs(jax.random.PRNGKey(1), kb, d)
    base = matching.distance_matrix(
        sa, sb, jnp.ones(ka, bool), jnp.ones(kb, bool)
    )
    ham = binary.hamming_from_base(base, d)
    ref = binary.hamming_distance_matrix_ref(np.asarray(sa), np.asarray(sb))
    np.testing.assert_array_equal(np.asarray(ham), ref.astype(np.float32))


def test_gate_roundtrip():
    d = 128
    for h in (0.0, 17.0, 40.0, 128.0):
        # gate sits half a bit above h: strict `dist < gate` then admits
        # integer Hamming distances <= h and rejects h + 1, exactly
        base = binary.base_gate_from_hamming(h, d)
        assert float(binary.hamming_from_base(jnp.float32(base), d)) == h + 0.5
    # BIG sentinel passes through unmapped
    assert float(binary.hamming_from_base(matching.BIG, d)) == float(matching.BIG)


def test_binarize_descriptors():
    key = jax.random.PRNGKey(3)
    desc = jax.random.uniform(key, (32, 128), jnp.float32)
    s = binary.binarize_descriptors(desc)
    assert set(np.unique(np.asarray(s))) <= {-1.0, 1.0}
    # mean-threshold rule: bit set iff above the descriptor's own mean
    ref = np.where(
        np.asarray(desc) > np.asarray(desc).mean(-1, keepdims=True), 1.0, -1.0
    )
    np.testing.assert_array_equal(np.asarray(s), ref)
    # all-equal (zero / padded) descriptor -> all -1 bits
    z = binary.binarize_descriptors(jnp.zeros((4, 128)))
    assert (np.asarray(z) == -1.0).all()
    # f16 storage (DescriptorBank dtype) keeps the signs exact
    np.testing.assert_array_equal(
        np.asarray(s.astype(jnp.float16).astype(jnp.float32)), ref
    )


def _brute_force_crosscheck(sa, sb, valid_a, valid_b, max_h):
    """Host BFMatcher(NORM_HAMMING, crossCheck=True) reference."""
    d = binary.hamming_distance_matrix_ref(sa, sb).astype(np.float64)
    d[~valid_a, :] = np.inf
    d[:, ~valid_b] = np.inf
    best_b = d.argmin(1)
    best_a = d.argmin(0)
    out_idx = np.full(sa.shape[0], -1, np.int32)
    out_dist = np.full(sa.shape[0], float(matching.BIG), np.float32)
    for i in range(sa.shape[0]):
        j = best_b[i]
        if valid_a[i] and np.isfinite(d[i, j]) and best_a[j] == i \
                and d[i, j] <= max_h:
            out_idx[i] = j
            out_dist[i] = d[i, j]
    return out_idx, out_dist


def test_mutual_match_parity_with_popcount_crosscheck():
    ka, kb, d = 128, 128, 128
    key = jax.random.PRNGKey(7)
    sa = _rand_signs(key, ka, d)
    # make half of B near-duplicates of A rows (realistic matches with
    # small bit flips), rest random
    flips = jax.random.bernoulli(jax.random.PRNGKey(8), 0.05, (kb // 2, d))
    sb_near = jnp.where(flips, -sa[: kb // 2], sa[: kb // 2])
    sb = jnp.concatenate([sb_near, _rand_signs(jax.random.PRNGKey(9), kb // 2, d)])
    valid_a = np.ones(ka, bool)
    valid_a[5] = False
    valid_b = np.ones(kb, bool)
    valid_b[70] = False

    out = binary.hamming_mutual_match(
        sa, sb, jnp.asarray(valid_a), jnp.asarray(valid_b), max_hamming=40.0
    )
    ref_idx, ref_dist = _brute_force_crosscheck(
        np.asarray(sa), np.asarray(sb), valid_a, valid_b, 40.0
    )
    # integer distances tie often; both argmins take the first minimum, so
    # decisions must agree exactly
    np.testing.assert_array_equal(np.asarray(out["target_idx"]), ref_idx)
    np.testing.assert_array_equal(np.asarray(out["matched"]), ref_idx >= 0)
    np.testing.assert_array_equal(np.asarray(out["dist"]), ref_dist)


def test_hamming_gate_excludes_far_pairs():
    d = 128
    sa = _rand_signs(jax.random.PRNGKey(11), 64, d)
    # B = A with exactly 10 bit flips per row -> all Hamming distances
    # between matched rows are 10
    flip = np.zeros((64, d), bool)
    flip[:, :10] = True
    sb = jnp.asarray(np.where(flip, -np.asarray(sa), np.asarray(sa)))
    v = jnp.ones(64, bool)
    hit = binary.hamming_mutual_match(sa, sb, v, v, max_hamming=10.0)
    miss = binary.hamming_mutual_match(sa, sb, v, v, max_hamming=9.0)
    assert bool(hit["matched"].all())
    np.testing.assert_array_equal(np.asarray(hit["dist"]), np.full(64, 10.0))
    assert not bool(miss["matched"].any())


def test_frontend_hamming_mode(monkeypatch):
    """End-to-end frontend smoke with norm='hamming': odometry still locks
    on and reported match distances are integer bit counts."""
    from slam_tpu.models import frontend
    from slam_tpu.utils import synthetic

    scene = synthetic.make_scene(
        jax.random.PRNGKey(21), num_frames=6, num_landmarks=2500,
        hw=(160, 320), step_m=0.6,
    )
    L, R = synthetic.render_sequence(scene)
    cfg = SlamConfig(
        features=FeatureConfig(max_kp=512, border=8),
        matching=MatchConfig(norm="hamming", max_hamming=40.0),
        ransac=RansacConfig(num_hypotheses=192),
        runtime=RuntimeConfig(chunk_frames=8),
    )
    res = frontend.run_frontend(L, R, scene.calib, cfg)
    assert (res.num_inliers[1:] > 20).all(), res.num_inliers
    # descriptors in the bank are bit signs
    bank = np.asarray(res.desc[0])
    assert set(np.unique(bank)) <= {-1.0, 1.0}
    # match distances are bit counts within the gate (or BIG sentinels)
    md = res.match_dist[res.match_prev >= 0]
    assert md.size > 0
    assert (md <= 40.0).all()
    np.testing.assert_array_equal(md, np.round(md))
    # trajectory still tracks (looser than the float-descriptor gate: 1-bit
    # quantization keeps ~matching power but is noisier)
    from slam_tpu.utils import metrics

    ate = metrics.ate_rmse(res.T_w2c, np.asarray(scene.T_w2c))
    assert ate < 0.5, f"ATE {ate}"
