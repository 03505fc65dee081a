import jax
import jax.numpy as jnp
import numpy as np

from slam_tpu.ops import features, matching


def textured_image(key, h=120, w=160, n_blobs=80):
    """Random blob texture with strong corners."""
    img = jnp.zeros((h, w))
    k1, k2 = jax.random.split(key)
    ys = jax.random.randint(k1, (n_blobs,), 10, h - 10)
    xs = jax.random.randint(k2, (n_blobs,), 10, w - 10)
    img = img.at[ys, xs].set(1.0)
    img = features.gaussian_blur(img, 1.2, 3)
    return img / (jnp.max(img) + 1e-9)


def test_detect_finds_valid_corners():
    img = textured_image(jax.random.PRNGKey(0))
    det = features.detect(img, max_kp=128)
    assert det["xy"].shape == (128, 2)
    assert int(jnp.sum(det["valid"])) > 30
    xy = np.asarray(det["xy"])[np.asarray(det["valid"])]
    assert (xy[:, 0] >= 0).all() and (xy[:, 0] < 160).all()
    assert (xy[:, 1] >= 0).all() and (xy[:, 1] < 120).all()


def test_detect_respects_border():
    img = textured_image(jax.random.PRNGKey(1))
    det = features.detect(img, max_kp=128, border=20)
    xy = np.asarray(det["xy"])[np.asarray(det["valid"])]
    assert (xy[:, 0] >= 20).all() and (xy[:, 0] < 140).all()
    assert (xy[:, 1] >= 20).all() and (xy[:, 1] < 100).all()


def test_descriptors_unit_norm():
    img = textured_image(jax.random.PRNGKey(2))
    feats = features.detect_and_describe(img, max_kp=128)
    norms = np.linalg.norm(np.asarray(feats["desc"]), axis=-1)
    valid = np.asarray(feats["valid"])
    np.testing.assert_allclose(norms[valid], 1.0, atol=1e-3)
    assert (norms[~valid] < 1e-6).all()


def test_cell_gather_clips_each_cell_like_numpy():
    """The 16-index descriptor cell gather samples each cell center at
    its own rounded, independently clipped position, for EVERY keypoint
    position (borders included, where per-cell clipping fires)."""
    img = textured_image(jax.random.PRNGKey(7), h=120, w=160)
    maps = np.asarray(features.orientation_cell_maps(img))
    kx, ky = jax.random.split(jax.random.PRNGKey(8))
    xs = jax.random.uniform(kx, (256,), minval=0.0, maxval=159.0)
    ys = jax.random.uniform(ky, (256,), minval=0.0, maxval=119.0)
    xy = np.asarray(jnp.stack([xs, ys], axis=-1))
    got = np.asarray(features._gather_cells(jnp.asarray(maps), jnp.asarray(xy)))
    offs = (np.arange(4) - 1.5) * features.CELL
    for k in range(0, 256, 17):
        for iy in range(4):
            for ix in range(4):
                px = int(np.clip(np.round(xy[k, 0] + offs[ix]), 0, 159))
                py = int(np.clip(np.round(xy[k, 1] + offs[iy]), 0, 119))
                np.testing.assert_array_equal(got[k, iy * 4 + ix],
                                              maps[:, py, px])


def test_self_match_is_identity():
    img = textured_image(jax.random.PRNGKey(3))
    feats = features.detect_and_describe(img, max_kp=128)
    m = matching.mutual_match(
        feats["desc"], feats["desc"], feats["valid"], feats["valid"]
    )
    valid = np.asarray(feats["valid"])
    tgt = np.asarray(m["target_idx"])
    # near-duplicate blobs + bf16 distance ties can swap a few rows; the
    # overwhelming majority must self-match with ~zero distance
    frac = (tgt[valid] == np.arange(128)[valid]).mean()
    assert frac > 0.9
    dist = np.asarray(m["dist"])[valid]
    assert (dist[np.asarray(m["matched"])[valid]] < 0.05).all()


def test_mutual_match_small_known():
    # 3 descriptors, identity correspondence with a decoy
    a = jnp.eye(4, 8)
    b = jnp.eye(4, 8)[jnp.array([2, 0, 1, 3])]  # permuted
    va = jnp.ones(4, bool)
    m = matching.mutual_match(a, b, va, va)
    np.testing.assert_array_equal(np.asarray(m["target_idx"]), [1, 2, 0, 3])
    assert np.asarray(m["matched"]).all()


def test_match_shifted_image():
    """Shift = synthetic stereo disparity; matches must recover the shift."""
    img = textured_image(jax.random.PRNGKey(4), h=120, w=200)
    shift = 7
    right = jnp.roll(img, -shift, axis=1)  # right view: features move left
    fl = features.detect_and_describe(img, max_kp=256)
    fr = features.detect_and_describe(right, max_kp=256)
    m = matching.match_stereo_pair(fl, fr)
    matched = np.asarray(m["matched"])
    assert matched.sum() > 20
    links = np.asarray(m["links"])[matched]
    disp = links[:, 0] - links[:, 1]
    # majority of matches should see the true disparity
    frac_good = np.mean(np.abs(disp - shift) < 1.5)
    assert frac_good > 0.8


def test_stereo_gate_rejects_vertical_offset():
    xy_l = jnp.array([[50.0, 30.0], [60.0, 40.0]])
    xy_r = jnp.array([[40.0, 30.5], [55.0, 48.0]])  # second: dy=8 -> reject
    m = {
        "target_idx": jnp.array([0, 1], jnp.int32),
        "dist": jnp.zeros(2),
        "matched": jnp.array([True, True]),
    }
    g = matching.stereo_gate(xy_l, xy_r, m)
    assert bool(g["matched"][0])
    assert not bool(g["matched"][1])


def test_stereo_gate_rejects_negative_disparity():
    xy_l = jnp.array([[50.0, 30.0]])
    xy_r = jnp.array([[55.0, 30.0]])  # x_r > x_l: impossible for rectified
    m = {
        "target_idx": jnp.array([0], jnp.int32),
        "dist": jnp.zeros(1),
        "matched": jnp.array([True]),
    }
    g = matching.stereo_gate(xy_l, xy_r, m)
    assert not bool(g["matched"][0])


def test_ratio_match_rejects_ambiguous():
    a = jnp.array([[1.0, 0.0, 0.0, 0.0]])
    # two near-identical candidates -> ambiguous -> rejected
    b = jnp.array([[0.99, 0.14, 0.0, 0.0], [0.99, -0.14, 0.0, 0.0]])
    a = a / jnp.linalg.norm(a, axis=-1, keepdims=True)
    b = b / jnp.linalg.norm(b, axis=-1, keepdims=True)
    m = matching.ratio_match(a, b, jnp.ones(1, bool), jnp.ones(2, bool), ratio=0.8)
    assert not bool(m["matched"][0])


def test_multiscale_detect_describe():
    img = textured_image(jax.random.PRNGKey(7), h=128, w=256)
    out = features.detect_and_describe_multiscale(img, max_kp=256,
                                                  num_levels=2)
    assert out["xy"].shape == (256, 2)
    assert out["desc"].shape == (256, 128)
    assert set(np.unique(np.asarray(out["scale"]))) <= {1.0, 2.0}
    # coarse-level keypoints map back into level-0 pixel bounds
    xy = np.asarray(out["xy"])[np.asarray(out["valid"])]
    assert (xy[:, 0] < 256).all() and (xy[:, 1] < 128).all()
    # a shifted copy still matches across the multiscale features
    shifted = jnp.roll(img, -5, axis=1)
    f2 = features.detect_and_describe_multiscale(shifted, max_kp=256,
                                                 num_levels=2)
    m = matching.mutual_match(out["desc"], f2["desc"], out["valid"],
                              f2["valid"])
    assert int(np.asarray(m["matched"]).sum()) > 20


def test_batched_detect_describe():
    imgs = jnp.stack(
        [textured_image(jax.random.PRNGKey(i)) for i in range(3)]
    )
    feats = features.detect_and_describe_batched(imgs)
    assert feats["xy"].shape == (3, features.DEFAULT_MAX_KP, 2)
    assert feats["desc"].shape == (3, features.DEFAULT_MAX_KP, 128)


def test_multiscale_batch_matches_vmapped():
    """detect_and_describe_multiscale_batch (jnp path) must reproduce the
    per-image multiscale pipeline exactly — it only restructures the
    per-octave loop to batch each level."""
    rng = np.random.default_rng(1)
    imgs = jnp.asarray(rng.random((2, 128, 256)).astype(np.float32))
    a = features.detect_and_describe_multiscale_batch(
        imgs, max_kp=512, num_levels=2)
    b = jax.vmap(lambda im: features.detect_and_describe_multiscale(
        im, max_kp=512, num_levels=2))(imgs)
    for k in ("xy", "desc", "valid", "resp", "scale"):
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                   atol=1e-6, err_msg=k)
