"""The jnp image and matching paths against independent float64 numpy
references, at KITTI width (376x1241 images, K=2048 x D=128 descriptors).

These are the paths the GPU runs as XLA-compiled code; the references
below share no code with them (plain loops over shifted slices, np.roll,
brute-force distance matrices).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_tpu.ops import akaze, features, matching

HW = (376, 1241)


def _corr_same(img, k):
    """XLA 'SAME' cross-correlation with zero padding (extra pad on the
    high side for even kernel sizes), in float64."""
    kh, kw = k.shape
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    P = np.pad(img, ((ph, kh - 1 - ph), (pw, kw - 1 - pw)))
    H, W = img.shape
    out = np.zeros((H, W), np.float64)
    for i in range(kh):
        for j in range(kw):
            out += k[i, j] * P[i:i + H, j:j + W]
    return out


def _gauss(sigma, radius):
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _blur(img, sigma, radius):
    k = _gauss(sigma, radius)
    return _corr_same(_corr_same(img, k[None, :]), k[:, None])


def _sobel(img):
    kx = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]]) / 8.0
    return _corr_same(img, kx), _corr_same(img, kx.T)


@pytest.fixture(scope="module")
def image():
    """Smooth random texture at KITTI resolution (blurred noise plus a few
    step edges, so corners and every gradient orientation occur)."""
    rng = np.random.default_rng(0)
    img = _blur(rng.random(HW), 2.0, 4)
    img[100:250, 300:700] += 0.3
    img[:, 900:] -= 0.2
    img = (img - img.min()) / (img.max() - img.min())
    return img.astype(np.float32)


def _close(got, ref, rel):
    got = np.asarray(got, np.float64)
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err <= rel * scale, (err, scale)


def test_harris_response_matches_float64(image):
    gx, gy = _sobel(image.astype(np.float64))
    gxx = _blur(gx * gx, 1.5, 2)
    gyy = _blur(gy * gy, 1.5, 2)
    gxy = _blur(gx * gy, 1.5, 2)
    ref = gxx * gyy - gxy * gxy - 0.05 * (gxx + gyy) ** 2
    _close(features.harris_response(jnp.asarray(image)), ref, 1e-4)


def test_nms_matches_numpy_max_filter(image):
    resp = np.asarray(features.harris_response(jnp.asarray(image)))
    r = 2
    P = np.pad(resp, r, constant_values=-np.inf)
    H, W = resp.shape
    m = np.full(resp.shape, -np.inf, np.float32)
    for i in range(2 * r + 1):
        for j in range(2 * r + 1):
            m = np.maximum(m, P[i:i + H, j:j + W])
    ref = np.where(resp >= m, resp, -np.inf)
    np.testing.assert_array_equal(np.asarray(features._nms(jnp.asarray(resp))),
                                  ref)


def test_orientation_cell_maps_match_float64(image):
    gx, gy = _sobel(_blur(image.astype(np.float64), 1.0, 2))
    mag = np.sqrt(gx * gx + gy * gy + 1e-12)
    bin_f = (np.arctan2(gy, gx) + np.pi) / (2 * np.pi) * 8.0
    b0 = np.floor(bin_f).astype(np.int64) % 8
    w1 = bin_f - np.floor(bin_f)
    ref = np.zeros((8, *HW))
    for o in range(8):
        raw = mag * ((b0 == o) * (1.0 - w1) + ((b0 + 1) % 8 == o) * w1)
        ref[o] = _corr_same(raw, np.ones((4, 4)))
    _close(features.orientation_cell_maps(jnp.asarray(image)), ref, 1e-4)


def test_akaze_contrast_matches_numpy_percentile(image):
    L = _blur(image.astype(np.float64), 1.0, 2)
    gx = 0.5 * (np.roll(L, -1, 1) - np.roll(L, 1, 1))
    gy = 0.5 * (np.roll(L, -1, 0) - np.roll(L, 1, 0))
    ref = max(3.0 * np.percentile(np.sqrt(gx * gx + gy * gy), 70.0), 1e-4)
    got = float(akaze._contrast_k(jnp.asarray(image)))
    assert abs(got - ref) <= 1e-4 * ref, (got, ref)


def _diffuse_ref(L, k, steps, tau=0.2):
    for _ in range(steps):
        gx = 0.5 * (np.roll(L, -1, 1) - np.roll(L, 1, 1))
        gy = 0.5 * (np.roll(L, -1, 0) - np.roll(L, 1, 0))
        g = 1.0 / (1.0 + (gx * gx + gy * gy) / (k * k))
        fx, fy = g * gx, g * gy
        L = L + tau * ((fx - np.roll(fx, 1, 1)) + (fy - np.roll(fy, 1, 0)))
    return L


def test_akaze_diffusion_matches_float64(image):
    k = 0.05
    ref = _diffuse_ref(image.astype(np.float64), k, 6)
    got = akaze.diffuse(jnp.asarray(image), k, 6)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, atol=2e-6)


def test_akaze_hessian_response_matches_float64(image):
    L = _diffuse_ref(image.astype(np.float64), 0.05, 6)
    sh = lambda a, dy, dx: np.roll(np.roll(a, dy, 0), dx, 1)  # noqa: E731
    Lxx = sh(L, 0, -1) - 2 * L + sh(L, 0, 1)
    Lyy = sh(L, -1, 0) - 2 * L + sh(L, 1, 0)
    Lxy = 0.25 * (sh(L, -1, -1) - sh(L, -1, 1) - sh(L, 1, -1) + sh(L, 1, 1))
    sigma = 1.6
    ref = sigma ** 4 * (Lxx * Lyy - Lxy * Lxy)
    got = akaze._hessian_response(jnp.asarray(L, jnp.float32), sigma)
    _close(got, ref, 1e-4)


# ---------------------------------------------------------------------------
# crossCheck matching at the frontend's feature budget
# ---------------------------------------------------------------------------

K, D = 2048, 128


def _descriptors(seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((K, D))
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    perm = rng.permutation(K)
    b = a[perm] + 0.25 * rng.standard_normal((K, D)) / np.sqrt(D)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    va = rng.random(K) > 0.05
    vb = rng.random(K) > 0.05
    xy_a = rng.uniform((0, 0), (HW[1], HW[0]), (K, 2))
    xy_b = xy_a[perm] + rng.normal((-40.0, 0.0), (25.0, 1.5), (K, 2))
    return a, b, va, vb, xy_a, xy_b


def _crosscheck_ref(a, b, va, vb, max_dist, xy_a=None, xy_b=None,
                    window=None):
    """BFMatcher(crossCheck=True) by brute force in float64 on the bf16
    rounding of the descriptors (the matcher's operand precision).
    Returns (target (K,), margin (K,)): margin is the gap between the
    best and second-best distance of each row and column, the smaller."""
    bf = lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16), np.float64)  # noqa: E731
    d = 2.0 - 2.0 * bf(a) @ bf(b).T
    d[~va, :] = np.inf
    d[:, ~vb] = np.inf
    if window is not None:
        lo, hi, dy_max = window
        dx = xy_b[None, :, 0] - xy_a[:, None, 0]
        dy = np.abs(xy_b[None, :, 1] - xy_a[:, None, 1])
        d[(dx < lo) | (dx > hi) | (dy > dy_max)] = np.inf
    row = np.argmin(d, axis=1)
    col = np.argmin(d, axis=0)
    best = d[np.arange(K), row]
    mutual = col[row] == np.arange(K)
    matched = mutual & va & np.isfinite(best) & (best < max_dist)
    srt = np.sort(d, axis=1)
    csrt = np.sort(d, axis=0)
    with np.errstate(invalid="ignore"):
        margin = np.minimum(srt[:, 1] - srt[:, 0], csrt[1, row] - csrt[0, row])
    # inf - inf: a row or column with no admissible candidate at all is
    # decided by the masks alone
    return np.where(matched, row, -1), np.nan_to_num(margin, nan=np.inf)


@pytest.mark.parametrize("windowed", [False, True], ids=["plain", "window"])
def test_mutual_match_matches_bruteforce_crosscheck(windowed):
    a, b, va, vb, xy_a, xy_b = _descriptors(1 + windowed)
    window = (-192.0, -2.0, 4.0) if windowed else None
    ref, margin = _crosscheck_ref(a, b, va, vb, 0.6, xy_a, xy_b, window)
    kw = {}
    if windowed:
        kw = dict(xy_a=jnp.asarray(xy_a, jnp.float32),
                  xy_b=jnp.asarray(xy_b, jnp.float32), window=window)
    out = matching.mutual_match(jnp.asarray(a, jnp.float32),
                          jnp.asarray(b, jnp.float32), jnp.asarray(va),
                          jnp.asarray(vb), max_dist=0.6, **kw)
    got = np.asarray(out["target_idx"])
    # the f32-accumulated and f64 sums may order exact near-ties
    # differently: rows whose best and second-best distances are
    # separated by more than the f32 rounding of a 128-term sum agree
    # exactly, and they are nearly all rows
    clear = margin > 1e-4
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got[clear], ref[clear])
    assert (ref >= 0).sum() > 0.5 * K  # the test exercises real matches
    d = np.asarray(out["dist"])[got >= 0]
    assert (d < 0.6).all()
