"""DoG scale-space SIFT-style detection.

The reference's ACTIVE detector is ``cv2.SIFT_create(2500)``
(final_project/algorithms/matching.py:27-35,72; keypoint plumbing in
VAN_ex/code/ex4_v2.py:62-99): difference-of-Gaussians extrema over a
Gaussian pyramid with per-keypoint scale. ``ops/features.py`` provides the
SIFT-style *descriptor* on Harris corners; this module completes the
family with the scale-covariant *detector*.

Batched design — everything is dense image math with static shapes:

  * Gaussian pyramid: ``intervals + 3`` separable blurs per octave
    (incremental sigmas, so each blur kernel stays small), octave
    downsampling by 2. All convs are XLA ``conv_general_dilated`` —
    no data-dependent shapes.
  * DoG responses: adjacent-blur differences, ``intervals + 2`` per
    octave.
  * Extrema: a pixel is a candidate iff it is the strict max or min of
    the 3x3x3 neighborhood across (x, y, scale) — two
    ``lax.reduce_window`` passes per DoG level plus elementwise
    comparisons with the neighbor levels. No sorting, no scatter.
  * Gates: contrast ``|D| > contrast`` and the SIFT edge test
    ``tr(H)^2 / det(H) < (r+1)^2 / r`` (r = 10), both as dense maps.
  * Selection: per octave, the interval responses are collapsed to ONE
    response map (max over intervals of the gated |DoG|) and fed to the
    shared gridded top-K (:func:`features.select_keypoints`) — same
    static-shape selection as Harris/AKAZE. The winning interval at each
    selected pixel plus a 1D parabola fit along the scale axis recovers
    the continuous scale (sigma to ~5% — what cv2.SIFT's 3D quadratic
    refinement does along its scale axis).
  * Description: each keypoint is described at its own octave's base
    Gaussian image with the shared 4x4x8 descriptor
    (:func:`features.describe`) — the descriptor support therefore
    scales with the octave factor (scale covariance at octave
    granularity, like ``features.detect_and_describe_multiscale``).

Exact cv2.SIFT bit-parity is a non-goal (SURVEY.md §7.3): the parity
target is pipeline metrics; this detector feeds the same downstream
geometry. Select with ``FeatureConfig(detector="sift")``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import features as feat

# cv2.SIFT defaults: 3 intervals/octave, sigma0 = 1.6, edge ratio 10.
INTERVALS = 3
SIGMA0 = 1.6
EDGE_R = 10.0


def _blur_radius(sigma: float) -> int:
    return max(2, int(3.0 * sigma + 0.5))


def gaussian_pyramid_octave(img: jnp.ndarray, intervals: int = INTERVALS,
                            sigma0: float = SIGMA0) -> list[jnp.ndarray]:
    """The ``intervals + 3`` Gaussian images of one octave.

    Incremental blurring: level i has total sigma ``sigma0 * 2^(i/S)``;
    each step applies only the incremental sigma, keeping every separable
    kernel small (radius <= ~6 px) regardless of the level."""
    k = 2.0 ** (1.0 / intervals)
    levels = [img]
    sig_prev = sigma0
    for _ in range(intervals + 2):
        sig_next = sig_prev * k
        sig_inc = float((sig_next**2 - sig_prev**2) ** 0.5)
        levels.append(feat.gaussian_blur(levels[-1], sig_inc,
                                         _blur_radius(sig_inc)))
        sig_prev = sig_next
    return levels


def _extrema_mask(d_prev, d_cur, d_next):
    """Strict 3x3x3 extremum mask of the middle DoG level (VPU-dense)."""
    win = (3, 3)

    def _mx(x):
        return jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, win, (1, 1),
                                     "SAME")

    def _mn(x):
        return jax.lax.reduce_window(x, jnp.inf, jax.lax.min, win, (1, 1),
                                     "SAME")

    # max over the 3x3 of each level; the center participates in its own
    # level's window. Cross-level comparisons are NON-strict (>=): with 3
    # intervals the adjacent DoG bands are close and a feature sitting
    # between two bands is a near-tie along scale. A tie on both levels
    # yields the same (x, y) as a candidate at two intervals; the
    # per-octave interval merge (max over intervals) collapses such
    # duplicates before selection, so relaxing costs no spurious
    # keypoints, only recovered ones.
    is_max = ((d_cur >= _mx(d_cur))
              & (d_cur >= _mx(d_prev)) & (d_cur >= _mx(d_next)))
    is_min = ((d_cur <= _mn(d_cur))
              & (d_cur <= _mn(d_prev)) & (d_cur <= _mn(d_next)))
    return is_max | is_min


def _edge_ok(d: jnp.ndarray, r: float = EDGE_R) -> jnp.ndarray:
    """SIFT edge rejection on a DoG map: tr^2/det < (r+1)^2/r (Lowe §4.1)."""
    dxx = jnp.roll(d, -1, axis=1) - 2.0 * d + jnp.roll(d, 1, axis=1)
    dyy = jnp.roll(d, -1, axis=0) - 2.0 * d + jnp.roll(d, 1, axis=0)
    dxy = 0.25 * (
        jnp.roll(jnp.roll(d, -1, 0), -1, 1) + jnp.roll(jnp.roll(d, 1, 0), 1, 1)
        - jnp.roll(jnp.roll(d, -1, 0), 1, 1) - jnp.roll(jnp.roll(d, 1, 0), -1, 1)
    )
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    thr = (r + 1.0) ** 2 / r
    return (det > 0) & (tr * tr < thr * det)


@partial(jax.jit, static_argnames=("max_kp", "octaves", "intervals",
                                   "upsample"))
def detect_and_describe_sift(
    img: jnp.ndarray,
    max_kp: int = feat.DEFAULT_MAX_KP,
    octaves: int = 3,
    intervals: int = INTERVALS,
    contrast: float = 0.015,
    upsample: bool = True,
):
    """DoG detection + shared descriptor for one (H, W) [0,1] image.

    ``upsample=True`` makes the first octave the cv2.SIFT '-1' octave: the
    image doubled bilinearly, detecting extrema down to sigma ~0.8 level-0
    px. Without it the finest DoG band is sigma 1.6-2.0 and fine texture
    yields a smooth field with few extrema (measured on the fractal scene
    at 128x256: 123 gated candidates without the -1 octave; 4x with).

    Returns the multiscale dict contract: xy (level-0 px), desc, valid,
    resp, scale (continuous sigma in level-0 pixels: ``SIGMA0 * 2^(o - u +
    (i+di)/S)`` with u = 1 when upsampled)."""
    budgets = feat._multiscale_budgets(max_kp, octaves)

    outs = []
    if upsample:
        H, W = img.shape
        level_img = jax.image.resize(img, (2 * H, 2 * W), "linear")
        # doubled image carries sigma ~1.0 (2 x the camera's ~0.5)
        pre = float((SIGMA0**2 - 1.0**2) ** 0.5)
    else:
        # pre-blur the base to sigma0 (camera images carry sigma ~0.5;
        # Lowe §3.3) — without this, dog[0] = blur(img) - img has
        # outsized magnitude on sharp input and the strict 26-neighbor
        # test suppresses every middle-level extremum above it
        level_img = img
        pre = float((SIGMA0**2 - 0.5**2) ** 0.5)
    level_img = feat.gaussian_blur(level_img, pre, _blur_radius(pre))
    for o, k in enumerate(budgets):
        gauss = gaussian_pyramid_octave(level_img, intervals)
        dogs = [b - a for a, b in zip(gauss[:-1], gauss[1:])]
        # gated scale-normalized response per middle interval
        resp_o = jnp.full(level_img.shape, -jnp.inf)
        best_i = jnp.zeros(level_img.shape, jnp.int32)
        for i in range(1, len(dogs) - 1):
            mask = (_extrema_mask(dogs[i - 1], dogs[i], dogs[i + 1])
                    & (jnp.abs(dogs[i]) > contrast)
                    & _edge_ok(dogs[i]))
            r = jnp.where(mask, jnp.abs(dogs[i]), -jnp.inf)
            best_i = jnp.where(r > resp_o, i, best_i)
            resp_o = jnp.maximum(resp_o, r)
        resp_o = jnp.where(jnp.isfinite(resp_o), resp_o, 0.0)

        border = max(4, 12 >> o)
        det = feat.select_keypoints(resp_o, max_kp=k, cell=16, border=border,
                                    min_response=contrast * 0.5)
        # winning interval + scale-axis parabola at the selected pixels
        xi = jnp.clip(jnp.round(det["xy"][:, 0]).astype(jnp.int32), 0,
                      level_img.shape[1] - 1)
        yi = jnp.clip(jnp.round(det["xy"][:, 1]).astype(jnp.int32), 0,
                      level_img.shape[0] - 1)
        ii = best_i[yi, xi]
        dog_stack = jnp.stack(dogs, axis=0)          # (S+2, H, W)
        d_c = dog_stack[ii, yi, xi]
        d_p = dog_stack[jnp.maximum(ii - 1, 0), yi, xi]
        d_n = dog_stack[jnp.minimum(ii + 1, len(dogs) - 1), yi, xi]
        denom = d_n - 2.0 * d_c + d_p
        di = jnp.where(jnp.abs(denom) > 1e-12, -0.5 * (d_n - d_p) / denom,
                       0.0)
        di = jnp.clip(di, -0.5, 0.5)
        o_eff = o - 1 if upsample else o
        sigma = SIGMA0 * 2.0 ** (
            o_eff + (ii.astype(jnp.float32) + di) / float(intervals))

        # describe on the octave's base Gaussian (scale covariance at
        # octave granularity — the 16 px support spans 16 * 2^o_eff
        # level-0 px)
        desc = feat.describe(gauss[0], det["xy"], det["valid"])
        factor = float(2.0 ** o_eff)
        outs.append({
            "xy": det["xy"] * factor,
            "desc": desc,
            "valid": det["valid"],
            "resp": det["resp"],
            "scale": jnp.where(det["valid"], sigma, 0.0),
        })
        if o + 1 < octaves:
            # gauss[intervals] has sigma = 2*sigma0: decimation alone keeps
            # the ladder exact (sigma0 at half resolution); _downsample2's
            # extra anti-alias blur would inflate it to ~1.05*sigma0
            level_img = gauss[intervals][::2, ::2]
    return {
        key: jnp.concatenate([v[key] for v in outs], axis=0)
        for key in ("xy", "desc", "valid", "resp", "scale")
    }


def detect_and_describe_sift_batch(
    imgs: jnp.ndarray,
    max_kp: int = feat.DEFAULT_MAX_KP,
    octaves: int = 4,
    intervals: int = INTERVALS,
    contrast: float = 0.015,
    upsample: bool = True,
    group: int = 4,
):
    """Batched DoG detection over (F, H, W) images.

    The per-image working set is large — the x2-upsampled octave alone
    holds ~11 full-resolution maps (Gaussians + DoGs + gates), ~200 MB at
    KITTI size — so a flat vmap over a 64-image frontend chunk asks for
    tens of GB of device memory. ``lax.map`` over ``group``-sized
    sub-batches keeps the vmapped parallelism within a group while
    bounding live memory to one group's pyramids."""
    single = lambda im: detect_and_describe_sift(  # noqa: E731
        im, max_kp=max_kp, octaves=octaves, intervals=intervals,
        contrast=contrast, upsample=upsample)
    F = imgs.shape[0]
    g = max(1, min(group, F))
    if F <= g:
        return jax.vmap(single)(imgs)
    Fp = -(-F // g) * g
    if Fp != F:
        pad = jnp.zeros((Fp - F,) + imgs.shape[1:], imgs.dtype)
        imgs = jnp.concatenate([imgs, pad], axis=0)
    out = jax.lax.map(jax.vmap(single),
                      imgs.reshape(Fp // g, g, *imgs.shape[1:]))
    return {k: v.reshape(Fp, *v.shape[2:])[:F] for k, v in out.items()}
