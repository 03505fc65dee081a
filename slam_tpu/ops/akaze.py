"""AKAZE-style nonlinear scale-space detection.

The reference's headline detector is ``cv2.AKAZE_create`` (README.md
feature list; final_project/algorithms/matching.py:19-24: threshold 8e-4,
4 octaves). AKAZE builds a *nonlinear* scale space by Perona-Malik
diffusion — edges are preserved while flat regions blur — and detects
scale-normalized Hessian-determinant extrema in it.

This module is that idea expressed as batched dense image math:

  * explicit fast-diffusion steps ``L += tau * div(g(|grad L|) grad L)``
    with the PM-g2 conductivity ``g = 1/(1 + |grad|^2 / k^2)`` — pure
    convolutions + elementwise ops, a handful of iterations per octave;
  * octave downsampling by 2 between diffusion blocks;
  * per-octave response = scale-normalized determinant of the Hessian;
  * the same gridded top-K selection and descriptor as ops/features.py,
    computed on the *diffused* image of the keypoint's octave (so the
    descriptor sees the nonlinear scale space, as AKAZE's MLDB does).

Exact AKAZE/MLDB bit-parity is a non-goal (SURVEY.md §7.3) — the parity
target is pipeline metrics. Select with ``FeatureConfig.detector='akaze'``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import features as feat


def _gradients_centered(L):
    gx = 0.5 * (jnp.roll(L, -1, axis=1) - jnp.roll(L, 1, axis=1))
    gy = 0.5 * (jnp.roll(L, -1, axis=0) - jnp.roll(L, 1, axis=0))
    return gx, gy


def _pm_g2(gx, gy, k):
    return 1.0 / (1.0 + (gx * gx + gy * gy) / (k * k))


def diffuse(L: jnp.ndarray, k: float, steps: int, tau: float = 0.2):
    """Explicit Perona-Malik diffusion steps (stable for tau <= 0.25)."""

    def step(L, _):
        gx, gy = _gradients_centered(L)
        g = _pm_g2(gx, gy, k)
        # divergence of g * grad L via forward/backward differences
        fx = g * gx
        fy = g * gy
        div = (fx - jnp.roll(fx, 1, axis=1)) + (fy - jnp.roll(fy, 1, axis=0))
        return L + tau * div, None

    L, _ = jax.lax.scan(step, L, None, length=steps)
    return L


def _hessian_response(L: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """Scale-normalized det(Hessian) (AKAZE's detector response)."""
    Lx = 0.5 * (jnp.roll(L, -1, axis=1) - jnp.roll(L, 1, axis=1))
    Lxx = jnp.roll(L, -1, axis=1) - 2 * L + jnp.roll(L, 1, axis=1)
    Lyy = jnp.roll(L, -1, axis=0) - 2 * L + jnp.roll(L, 1, axis=0)
    Lxy = 0.25 * (
        jnp.roll(jnp.roll(L, -1, 0), -1, 1)
        - jnp.roll(jnp.roll(L, -1, 0), 1, 1)
        - jnp.roll(jnp.roll(L, 1, 0), -1, 1)
        + jnp.roll(jnp.roll(L, 1, 0), 1, 1)
    )
    return (sigma ** 4) * (Lxx * Lyy - Lxy * Lxy)


def _contrast_k(img: jnp.ndarray) -> jnp.ndarray:
    """PM contrast parameter from the gradient-magnitude distribution.

    AKAZE uses the 70th percentile of the smoothed-gradient histogram; the
    factor 3 puts typical noise gradients well below the conductivity knee
    (g >= 0.9) so flat regions actually diffuse, while strong edges (an
    order of magnitude above the percentile) stay sharp.
    """
    gx, gy = _gradients_centered(feat.gaussian_blur(img, 1.0, 2))
    mag = jnp.sqrt(gx * gx + gy * gy)
    return jnp.maximum(3.0 * jnp.percentile(mag, 70.0), 1e-4)


def _octave_budgets(max_kp: int, octaves: int) -> list[int]:
    """Per-octave keypoint budgets (half per split, 128-lane multiples) —
    the AKAZE analogue of features._multiscale_budgets."""
    budgets = []
    remaining = max_kp
    for o in range(octaves):
        b = remaining // 2 if o < octaves - 1 else remaining
        b = max(128, (b // 128) * 128)
        b = min(b, remaining)
        budgets.append(b)
        remaining -= b
    budgets[0] += remaining
    return budgets


@partial(jax.jit, static_argnames=("max_kp", "octaves", "steps"))
def detect_and_describe_akaze(
    img: jnp.ndarray,
    max_kp: int = feat.DEFAULT_MAX_KP,
    octaves: int = 2,
    steps: int = 6,
    threshold: float = 8e-4,
):
    """Nonlinear scale-space detect+describe (cv2.AKAZE equivalent surface).

    Returns the detect_and_describe dict contract plus ``scale``.
    ``threshold`` matches the reference's AKAZE threshold semantics
    (matching.py:20: response floor 8e-4).
    """
    k = _contrast_k(img)
    budgets = _octave_budgets(max_kp, octaves)

    outs = []
    L = feat.gaussian_blur(img, 1.0, 2)
    for o, kp_budget in enumerate(budgets):
        L = diffuse(L, k, steps)
        sigma = 1.6 * (2.0 ** o)
        resp = _hessian_response(L, sigma)
        det = feat.select_keypoints(
            resp, kp_budget, border=max(4, 12 >> o),
            min_response=threshold * (sigma ** 4) * 1e-3,
        )
        desc = feat.describe(L, det["xy"], det["valid"])
        factor = float(1 << o)
        outs.append({
            "xy": det["xy"] * factor,
            "desc": desc,
            "valid": det["valid"],
            "resp": det["resp"],
            "scale": jnp.full((kp_budget,), factor, jnp.float32),
        })
        if o + 1 < octaves:
            L = feat.gaussian_blur(L, 1.0, 2)[::2, ::2]

    return {
        key: jnp.concatenate([o[key] for o in outs], axis=0)
        for key in ("xy", "desc", "valid", "resp", "scale")
    }


def detect_and_describe_akaze_batch(
    imgs: jnp.ndarray,
    max_kp: int = feat.DEFAULT_MAX_KP,
    octaves: int = 2,
    steps: int = 6,
    threshold: float = 8e-4,
):
    """Batched nonlinear scale-space detect+describe over (F, H, W):
    ``vmap(detect_and_describe_akaze)``."""
    return jax.vmap(
        lambda im: detect_and_describe_akaze(
            im, max_kp=max_kp, octaves=octaves, steps=steps,
            threshold=threshold,
        )
    )(imgs)
