"""The fused cross-check matcher (ops/match_kernel.py, Pallas on the
Triton route) against the dense matcher, in interpret mode on the CPU;
its routing; and the guided search window of ``mutual_match``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_tpu.ops import match_kernel, matching


def unit_desc(key, n, d=128):
    x = jax.random.normal(key, (n, d))
    return x / jnp.linalg.norm(x, axis=-1, keepdims=True)


def _pair(seed, k=512):
    ks = jax.random.split(jax.random.PRNGKey(seed), 6)
    a = unit_desc(ks[0], k)
    perm = jax.random.permutation(ks[1], k)
    b = a[perm] + 0.05 * jax.random.normal(ks[2], a.shape)
    b = b / jnp.linalg.norm(b, axis=-1, keepdims=True)
    va = jax.random.bernoulli(ks[3], 0.9, (k,))
    vb = jax.random.bernoulli(ks[4], 0.9, (k,))
    xy_a = jax.random.uniform(ks[5], (k, 2)) * jnp.array([1241.0, 376.0])
    xy_b = xy_a[perm] + jnp.array([-30.0, 0.5])
    return a, b, va, vb, xy_a, xy_b


@pytest.mark.parametrize("window", [None, (-192.0, -2.0, 4.0)],
                         ids=["plain", "stereo-window"])
def test_kernel_matches_dense_in_interpret_mode(window):
    a, b, va, vb, xy_a, xy_b = _pair(1 if window is None else 2)
    got = match_kernel.mutual_nearest(a, b, va, vb, xy_a, xy_b,
                                      window=window, interpret=True)
    ref = matching.dense_mutual_nearest(a, b, va, vb, xy_a, xy_b,
                                        window=window)
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(ref[2]))
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                               atol=1e-5)


def test_kernel_rejects_untiled_shapes():
    a = unit_desc(jax.random.PRNGKey(3), 96)
    v = jnp.ones(96, bool)
    xy = jnp.zeros((96, 2))
    with pytest.raises(ValueError, match="not multiples"):
        match_kernel.row_nearest(a, a, v, v, xy, xy, interpret=True)


def test_kernel_eligible_only_on_gpu_at_power_of_two_budgets(monkeypatch):
    d = lambda k, w=128: jnp.zeros((k, w))  # noqa: E731
    assert not match_kernel.eligible(d(2048), d(2048))  # CPU backend
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert match_kernel.eligible(d(2048), d(2048))
    assert match_kernel.eligible(d(1024), d(2048))
    assert not match_kernel.eligible(d(1536), d(2048))   # not a power of 2
    assert not match_kernel.eligible(d(64), d(64))       # below one tile
    assert not match_kernel.eligible(d(2048, 96), d(2048, 96))


def test_mutual_match_routes_to_the_kernel_when_eligible(monkeypatch):
    a, b, va, vb, xy_a, xy_b = _pair(4)
    window = (-192.0, -2.0, 4.0)
    ref = matching.mutual_match(a, b, va, vb, xy_a=xy_a, xy_b=xy_b,
                                window=window)
    calls = []
    fused = match_kernel.mutual_nearest

    def kernel(*args, **kw):
        calls.append(1)
        return fused(*args, **kw, interpret=True)

    monkeypatch.setattr(match_kernel, "eligible", lambda *_: True)
    monkeypatch.setattr(match_kernel, "mutual_nearest", kernel)
    got = matching.mutual_match(a, b, va, vb, xy_a=xy_a, xy_b=xy_b,
                                window=window)
    assert calls
    for k in ("target_idx", "matched"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))


def test_windowed_matching_restricts_candidates():
    """Guided window: candidates outside the spatial box never match."""
    ka = 1024
    a = unit_desc(jax.random.PRNGKey(10), ka)
    b = a  # identical descriptors -> matching decided by the window
    rng = np.random.default_rng(0)
    xy_a = jnp.asarray(rng.uniform(0, 1000, (ka, 2)).astype(np.float32))
    xy_b = xy_a + jnp.asarray([50.0, 0.0])  # uniform +50px x shift
    va = jnp.ones(ka, bool)

    # window admits the true +50px shift
    m_ok = matching.mutual_match(a, b, va, va, xy_a=xy_a, xy_b=xy_b,
                                 window=(0.0, 100.0, 5.0))
    assert np.asarray(m_ok["matched"]).mean() > 0.95
    assert (np.asarray(m_ok["target_idx"])[np.asarray(m_ok["matched"])] ==
            np.arange(ka)[np.asarray(m_ok["matched"])]).all()
    # window that excludes the shift: nothing matches
    m_bad = matching.mutual_match(a, b, va, va, xy_a=xy_a, xy_b=xy_b,
                                  window=(-100.0, 0.0, 5.0),
                                  max_dist=1.0)
    assert np.asarray(m_bad["matched"]).sum() == 0
