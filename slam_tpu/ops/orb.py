"""ORB-family detector: FAST-9 segment-test corners + oriented BRIEF bits.

Reference surface: the feature factory's third detector family,
``cv2.ORB_create`` (VAN_ex/code/ex1.py:175-194 keypoints/matching intro,
ex4_v2.py:62-99 ORB/AKAZE/SIFT selection); final_project keeps AKAZE/SIFT
active (algorithms/matching.py:19-35) but the ORB path is part of the
reference's capability surface. Batched design, not a cv2 translation:

* FAST-9 is evaluated densely for EVERY pixel at once: the 16 Bresenham
  circle neighbours are ``jnp.roll`` shifts of the image (elementwise
  ops XLA fuses into one pass over the batch), and the ">= 9 contiguous
  brighter/darker" segment test is a log-doubling AND-reduction over
  circular rotations of the 16 comparison masks — no per-pixel loop, no
  early-out control flow (which cannot exist under jit anyway).
* The corner response is the standard score proxy (sum of arc excesses
  |d|-t), so keypoint selection reuses the gridded top-K machinery
  (features.select_keypoints) with NMS and subpixel refinement unchanged.
* Orientation is ORB's intensity centroid (Rublee et al. 2011), computed
  DENSELY as two separable convolutions (ramp x ones kernels) over a
  31x31 square patch — two cheap image passes shared by all keypoints
  instead of per-keypoint patch gathers. (The square window replaces
  cv2's disc: separability is the batched choice; the descriptor is
  bit-parity non-goal per SURVEY.md §7.3.)
* Rotated BRIEF: 128 pair tests on the sigma=2 blurred image, steered by
  the CONTINUOUS keypoint angle (cos/sin rotation of the static pattern —
  no 12-degree lookup table; trig is cheap relative to the
  gather), gathered for all keypoints at once.
* Bits are stored as ±1/sqrt(128) f32 lanes: unit-norm, so the float-L2
  mutual matcher's distance 2 - 2<a,b> = 4*hamming/128 is an affine map
  of the Hamming distance and every crossCheck/argmin decision matches a
  popcount matcher exactly (same trick as ops/binary.py, which also
  recovers the exact bit signs under ``norm="hamming"``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import features as feat

# 16-point Bresenham circle of radius 3, clockwise from 12 o'clock
# ((dy, dx) pairs — the standard FAST ring).
_CIRCLE = np.array([
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
], dtype=np.int32)

_ARC = 9           # FAST-9: required contiguous run length
PATCH_R = 15       # orientation patch radius (31x31 square)
DESC_BITS = 128    # one bit per descriptor dimension (matches DESC_DIM)
# BRIEF pattern radius (cv2 ORB patchSize=31 -> R=15). Measured on the
# full-res synthetic frontend: R=13 gives ~35% more RANSAC-PnP inliers
# than R=9 (wider spatial context disambiguates the dense-texture
# neighbours BRIEF bits otherwise confuse); rotated extent <= 13*sqrt(2)
# ~ 18.4 px can exceed the default 12 px detection border, where samples
# clamp to the image edge like features.describe — graceful, and matched
# keypoints near borders are rare.
_PATTERN_R = 13.0


def _brief_pattern() -> np.ndarray:
    """Static (256, 2) float32 test-point pattern (pairs i / i+128).

    Gaussian-distributed offsets (BRIEF's recommended sampling), fixed
    seed so descriptors are deterministic across processes, clipped to
    ``_PATTERN_R`` so rotated samples stay within ~12.7 px of the
    keypoint (the default detection border is 12; out-of-image samples
    are clamped at the gather like features.describe).
    """
    rs = np.random.RandomState(0xB51EF)
    pts = rs.randn(2 * DESC_BITS, 2) * (_PATTERN_R / 2.0)
    return np.clip(pts, -_PATTERN_R, _PATTERN_R).astype(np.float32)


_PATTERN = _brief_pattern()


def _circle_shifts(img: jnp.ndarray) -> jnp.ndarray:
    """(16, H, W): ring neighbour values for every pixel (wrap at edges —
    masked out by the detection border, which exceeds the ring radius)."""
    return jnp.stack(
        [jnp.roll(img, (-int(dy), -int(dx)), axis=(0, 1)) for dy, dx in _CIRCLE]
    )


def _contiguous_run(mask: jnp.ndarray, n: int = _ARC) -> jnp.ndarray:
    """(16, H, W) bool -> (H, W) bool: any circular run of >= n Trues.

    Log-doubling composition run(a+b)[s] = run(a)[s] & run(b)[s+a]; for
    n = 9 that is three doublings to run-8 plus one single-step extension
    — 4 ANDs instead of 16x9.
    """
    run = mask
    length = 1
    while length * 2 <= n:
        run = run & jnp.roll(run, -length, axis=0)
        length *= 2
    if length < n:
        run = run & jnp.roll(mask, -length, axis=0)
    return jnp.any(run, axis=0)


def fast_response(img: jnp.ndarray, threshold: float = 0.06) -> jnp.ndarray:
    """Dense FAST-9 corner score for every pixel of one (H, W) image.

    Zero on non-corners; on corners the OpenCV-style score proxy
    sum(max(|d| - t, 0)) over the ring, taken on the qualifying polarity.
    """
    d = _circle_shifts(img) - img[None]           # (16, H, W)
    bright = _contiguous_run(d > threshold)
    dark = _contiguous_run(d < -threshold)
    sb = jnp.sum(jnp.maximum(d - threshold, 0.0), axis=0)
    sd = jnp.sum(jnp.maximum(-d - threshold, 0.0), axis=0)
    return jnp.where(bright, sb, 0.0) + jnp.where(dark, sd, 0.0)


def orientation_moment_maps(img: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Dense intensity-centroid first moments (m10, m01) per pixel.

    m10(p) = sum_{|dy|,|dx|<=R} dx * I(p+d) — separable: a column box sum
    followed by a row ramp convolution (and transposed for m01). Two
    image-space passes replace per-keypoint 31x31 patch reads.
    """
    ones = jnp.ones((2 * PATCH_R + 1, 1), img.dtype)
    ramp = jnp.arange(-PATCH_R, PATCH_R + 1, dtype=img.dtype)
    m10 = feat._conv2d_same(feat._conv2d_same(img, ones), ramp[None, :])
    m01 = feat._conv2d_same(feat._conv2d_same(img, ones.T), ramp[:, None])
    return m10, m01


def describe_brief(img_blur: jnp.ndarray, xy: jnp.ndarray, angle: jnp.ndarray,
                   valid: jnp.ndarray) -> jnp.ndarray:
    """Steered-BRIEF descriptors: (K, 128) ±1/sqrt(128) f32.

    Bit i is set iff blurred intensity at rotated pattern point a_i is
    less than at b_i (BRIEF's test), with the pattern rotated by each
    keypoint's own angle. One gather of (K, 256) points total.
    """
    H, W = img_blur.shape
    c = jnp.cos(angle)[:, None]                  # (K, 1)
    s = jnp.sin(angle)[:, None]
    ax = _PATTERN[None, :, 0]                    # (1, 256)
    ay = _PATTERN[None, :, 1]
    px = xy[:, 0:1] + c * ax - s * ay            # (K, 256)
    py = xy[:, 1:2] + s * ax + c * ay
    xi = jnp.clip(jnp.round(px).astype(jnp.int32), 0, W - 1)
    yi = jnp.clip(jnp.round(py).astype(jnp.int32), 0, H - 1)
    vals = img_blur[yi, xi]                      # (K, 256)
    bits = vals[:, :DESC_BITS] < vals[:, DESC_BITS:]
    scale = 1.0 / np.sqrt(DESC_BITS)
    desc = jnp.where(bits, scale, -scale).astype(jnp.float32)
    return jnp.where(valid[:, None], desc, 0.0)


@partial(jax.jit, static_argnames=("max_kp",))
def detect_and_describe_orb(
    img: jnp.ndarray,
    max_kp: int = feat.DEFAULT_MAX_KP,
    threshold: float = 0.06,
):
    """cv2 ORB ``detectAndCompute`` equivalent for one (H, W) image.

    Returns the detect_and_describe dict contract (xy, desc, valid, resp)
    plus ``angle``; desc rows are ±1/sqrt(128) bit signs (see module doc).
    """
    resp = fast_response(img, threshold)
    det = feat.select_keypoints(resp, max_kp, min_response=1e-9)
    m10, m01 = orientation_moment_maps(img)
    xi = jnp.clip(jnp.round(det["xy"][:, 0]).astype(jnp.int32), 0,
                  img.shape[1] - 1)
    yi = jnp.clip(jnp.round(det["xy"][:, 1]).astype(jnp.int32), 0,
                  img.shape[0] - 1)
    angle = jnp.arctan2(m01[yi, xi], m10[yi, xi])
    blur = feat.gaussian_blur(img, 2.0, 4)
    desc = describe_brief(blur, det["xy"], angle, det["valid"])
    return {
        "xy": det["xy"],
        "desc": desc,
        "valid": det["valid"],
        "resp": det["resp"],
        "angle": angle,
    }


def detect_and_describe_orb_batch(
    imgs: jnp.ndarray,
    max_kp: int = feat.DEFAULT_MAX_KP,
    threshold: float = 0.06,
):
    """Batched ORB detect+describe over (F, H, W) images.

    The dense FAST ring test is roll/elementwise math that XLA already
    fuses into one pass, so there is no hand-written kernel here.
    """
    return jax.vmap(
        lambda im: detect_and_describe_orb(im, max_kp=max_kp,
                                           threshold=threshold)
    )(imgs)


def fast_response_ref(img: np.ndarray, threshold: float = 0.06) -> np.ndarray:
    """Brute-force host FAST-9 (explicit per-start-position runs) for
    parity tests ONLY."""
    img = np.asarray(img, np.float64)
    H, W = img.shape
    out = np.zeros((H, W))
    for y in range(3, H - 3):
        for x in range(3, W - 3):
            d = np.array([img[y + dy, x + dx] for dy, dx in _CIRCLE]) - img[y, x]
            for sign in (1.0, -1.0):
                m = sign * d > threshold
                runs = any(
                    all(m[(s + i) % 16] for i in range(_ARC)) for s in range(16)
                )
                if runs:
                    out[y, x] += np.maximum(sign * d - threshold, 0.0).sum()
    return out
