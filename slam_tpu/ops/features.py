"""Batched feature detection + description.

Replaces the OpenCV C++ detectors/descriptors the reference binds to
(``cv2.SIFT_create(2500)`` / ``cv2.AKAZE_create`` — reference
final_project/algorithms/matching.py:19-35) with a batched, static-shape
pipeline of dense image math that XLA fuses:

  * detection:  Harris corner response + 5x5 non-max suppression, then a
    *gridded top-K* selection that returns a fixed number of keypoints
    per image with a validity mask (static shapes — no data-dependent
    keypoint counts).
  * description: a SIFT-style 4x4x8 gradient-orientation-histogram
    descriptor (128-d float) sampled on a 16x16 patch around each keypoint.
    It is computed for ALL keypoints of ALL images in one batched gather
    pass, which makes descriptor matching downstream a pure bf16 matmul.

Exact OpenCV descriptor bit-parity is a non-goal (SURVEY.md §7.3): the
parity target is pipeline metrics (ATE / fps), and these detectors feed the
same downstream geometry.

All entry points are jit/vmap-friendly; images are (H, W) float32 in [0,1].
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# Default budget comparable to the reference's 2500 SIFT features
# (matching.py:31); rounded to a power of two for clean tiling.
DEFAULT_MAX_KP = 2048
# Descriptor support: 16 px side (4x4 cells of 4x4 px). Wider support
# (32 px) was tried and hurts: it degrades viewpoint robustness for
# frame-to-frame matching more than it helps stereo discrimination.
PATCH = 16
DESC_DIM = 128


# ---------------------------------------------------------------------------
# small separable convolutions
# ---------------------------------------------------------------------------

def _conv2d_same(img: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """2D 'same' convolution of (H, W) with a small (kh, kw) kernel."""
    return jax.lax.conv_general_dilated(
        img[None, None, :, :],
        kernel[None, None, :, :],
        window_strides=(1, 1),
        padding="SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )[0, 0]


def _gaussian_kernel1d(sigma: float, radius: int) -> jnp.ndarray:
    x = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    return k / jnp.sum(k)


def gaussian_blur(img: jnp.ndarray, sigma: float, radius: int = 3) -> jnp.ndarray:
    k = _gaussian_kernel1d(sigma, radius)
    img = _conv2d_same(img, k[None, :])
    return _conv2d_same(img, k[:, None])


def _sobel(img: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    kx = jnp.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]]) / 8.0
    gx = _conv2d_same(img, kx)
    gy = _conv2d_same(img, kx.T)
    return gx, gy


# ---------------------------------------------------------------------------
# Harris detection with gridded top-K
# ---------------------------------------------------------------------------

def harris_response(img: jnp.ndarray, k: float = 0.05) -> jnp.ndarray:
    """Harris corner response map (H, W)."""
    gx, gy = _sobel(img)
    gxx = gaussian_blur(gx * gx, 1.5, 2)
    gyy = gaussian_blur(gy * gy, 1.5, 2)
    gxy = gaussian_blur(gx * gy, 1.5, 2)
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    return det - k * tr * tr


def _nms(resp: jnp.ndarray, radius: int = 2) -> jnp.ndarray:
    """Zero out non-maxima within a (2r+1)^2 window."""
    m = jax.lax.reduce_window(
        resp,
        -jnp.inf,
        jax.lax.max,
        (2 * radius + 1, 2 * radius + 1),
        (1, 1),
        "SAME",
    )
    return jnp.where(resp >= m, resp, -jnp.inf)


@partial(jax.jit, static_argnames=("max_kp", "cell", "border"))
def detect(
    img: jnp.ndarray,
    max_kp: int = DEFAULT_MAX_KP,
    cell: int = 16,
    border: int = 12,
    min_response: float = 1e-7,
    resp: jnp.ndarray | None = None,
):
    """Detect up to ``max_kp`` corners on one image.

    A uniform spatial distribution matters more for odometry stability than
    raw response ranking, so selection is *gridded*: the top-3 corners of
    every ``cell`` x ``cell`` tile are extracted with three masked argmax
    passes over the (n_cells, cell^2) view — cheap row reductions — and the
    final ``max_kp`` are chosen from those candidates with per-cell rank as
    the primary key (every cell's best first). The only ``top_k`` runs over
    3*n_cells candidates instead of all H*W pixels.

    Returns dict with xy (max_kp, 2) float32 pixel coords, resp (max_kp,),
    valid (max_kp,) bool.
    """
    if resp is None:
        resp = harris_response(img)
    return select_keypoints(resp, max_kp, cell, border, min_response)


def select_keypoints(
    resp: jnp.ndarray,
    max_kp: int,
    cell: int = 16,
    border: int = 12,
    min_response: float = 1e-7,
):
    """Gridded top-K keypoint selection on any response map (shared by the
    Harris and nonlinear-scale-space detectors), with quadratic subpixel
    refinement.

    Subpixel matters: integer keypoints quantize stereo disparity by
    +-0.5 px, which at KITTI geometry is meter-scale depth error at 25 m —
    enough to break the 2 px reprojection gate between frames. A 1D
    parabola fit per axis on the response map recovers the peak to ~0.1 px
    (what SIFT/AKAZE do on their response pyramids).
    """
    H, W = resp.shape
    resp_raw = resp
    resp = _nms(resp)

    # border + validity mask
    yy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    in_border = (
        (xx >= border) & (xx < W - border) & (yy >= border) & (yy < H - border)
    )
    resp = jnp.where(in_border & (resp > min_response), resp, -jnp.inf)

    Hc = (H + cell - 1) // cell
    Wc = (W + cell - 1) // cell
    rp = jnp.pad(resp, ((0, Hc * cell - H), (0, Wc * cell - W)),
                 constant_values=-jnp.inf)
    tiles = rp.reshape(Hc, cell, Wc, cell).transpose(0, 2, 1, 3).reshape(
        Hc * Wc, cell * cell
    )

    # top-3 per cell via masked argmax passes. The mask-out is a
    # broadcasted where that fuses with the reductions, not a scatter
    # (`.at[rows, argmax].set(-inf)`).
    cand_val, cand_pos = [], []
    t = tiles
    lanes = jnp.arange(t.shape[1], dtype=jnp.int32)[None, :]
    for i in range(3):
        a = jnp.argmax(t, axis=1)
        v = jnp.max(t, axis=1)
        cand_val.append(v)
        cand_pos.append(a)
        if i < 2:
            t = jnp.where(lanes == a[:, None], -jnp.inf, t)

    n_cells = Hc * Wc
    vals = jnp.concatenate(cand_val)            # (3*n_cells,)
    pos = jnp.concatenate(cand_pos)             # within-cell flat index
    cell_id = jnp.tile(jnp.arange(n_cells), 3)
    rank = jnp.repeat(jnp.arange(3), n_cells).astype(jnp.float32)

    # priority: per-cell rank first, then response (bounded logistic keeps
    # the response tie-break inside one rank band)
    score = jnp.where(
        jnp.isfinite(vals),
        -rank + jax.nn.sigmoid(vals * 1e4) * 0.9,
        -jnp.inf,
    )
    k = min(max_kp, score.shape[0])
    top_s, top_i = jax.lax.top_k(score, k)
    if k < max_kp:  # tiny images: pad slots
        pad = max_kp - k
        top_s = jnp.concatenate([top_s, jnp.full((pad,), -jnp.inf)])
        top_i = jnp.concatenate([top_i, jnp.zeros((pad,), top_i.dtype)])

    sel_cell = cell_id[top_i]
    sel_pos = pos[top_i]
    ys = (sel_cell // Wc) * cell + sel_pos // cell
    xs = (sel_cell % Wc) * cell + sel_pos % cell
    valid = jnp.isfinite(top_s)

    # quadratic subpixel refinement on the raw response map
    xc = jnp.clip(xs, 1, W - 2)
    yc = jnp.clip(ys, 1, H - 2)
    r0 = resp_raw[yc, xc]
    rxp = resp_raw[yc, xc + 1]
    rxm = resp_raw[yc, xc - 1]
    ryp = resp_raw[yc + 1, xc]
    rym = resp_raw[yc - 1, xc]

    def _para(p, m, c):
        denom = p - 2.0 * c + m
        off = jnp.where(jnp.abs(denom) > 1e-12, -0.5 * (p - m) / denom, 0.0)
        return jnp.clip(off, -0.5, 0.5)

    dx = _para(rxp, rxm, r0)
    dy = _para(ryp, rym, r0)
    # keep refined coordinates inside the detection border
    xs_f = jnp.clip(xc.astype(jnp.float32) + dx, border, W - 1 - border)
    ys_f = jnp.clip(yc.astype(jnp.float32) + dy, border, H - 1 - border)
    return {
        "xy": jnp.stack([xs_f, ys_f], axis=-1),
        "resp": jnp.where(valid, vals[top_i], 0.0),
        "valid": valid,
    }


# ---------------------------------------------------------------------------
# SIFT-style descriptor (upright, single scale)
# ---------------------------------------------------------------------------

CELL = PATCH // 4  # 4x4 px per descriptor cell


def orientation_cell_maps(img: jnp.ndarray) -> jnp.ndarray:
    """Image-level descriptor precomputation: (8, H, W) maps where channel
    o at pixel p holds the 4x4-box-summed, softly-binned gradient magnitude
    of orientation o around p.

    This moves ALL per-keypoint arithmetic of the SIFT-style descriptor
    into dense image-space convolutions shared across keypoints;
    ``describe`` then just samples 16 cell centers per keypoint.
    """
    blur = gaussian_blur(img, 1.0, 2)
    gx, gy = _sobel(blur)
    mag = jnp.sqrt(gx * gx + gy * gy + 1e-12)
    ang = jnp.arctan2(gy, gx)

    bin_f = (ang + jnp.pi) / (2.0 * jnp.pi) * 8.0
    b0 = jnp.floor(bin_f).astype(jnp.int32) % 8
    w1 = bin_f - jnp.floor(bin_f)
    w0 = 1.0 - w1

    oh0 = jax.nn.one_hot(b0, 8, dtype=img.dtype, axis=0)  # (8, H, W)
    oh1 = jax.nn.one_hot((b0 + 1) % 8, 8, dtype=img.dtype, axis=0)
    maps = oh0 * (mag * w0)[None] + oh1 * (mag * w1)[None]

    # 4x4 box sum per channel (cell size = PATCH/4), separable ones-kernel
    ones_v = jnp.ones((CELL, 1), img.dtype)
    ones_h = jnp.ones((1, CELL), img.dtype)
    maps = jax.vmap(lambda m: _conv2d_same(_conv2d_same(m, ones_v), ones_h))(
        maps
    )
    return maps


def _gather_cells(maps: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """(8, H, W) maps + (K, 2) keypoints -> (K, 16, 8) descriptor cells via
    16 per-cell fancy indices (clipped independently per cell). Works for
    any keypoint position."""
    K = xy.shape[0]
    offs = (jnp.arange(4, dtype=jnp.float32) - 1.5) * CELL  # (-6,-2,2,6)
    oy, ox = jnp.meshgrid(offs, offs, indexing="ij")
    oy = oy.reshape(-1)  # (16,)
    ox = ox.reshape(-1)

    px = jnp.clip(
        jnp.round(xy[:, 0:1] + ox[None, :]).astype(jnp.int32), 0,
        maps.shape[2] - 1,
    )  # (K, 16)
    py = jnp.clip(
        jnp.round(xy[:, 1:2] + oy[None, :]).astype(jnp.int32), 0,
        maps.shape[1] - 1,
    )
    return maps[:, py, px].transpose(1, 2, 0)  # (K, 16, 8)




def describe(img: jnp.ndarray, xy: jnp.ndarray, valid: jnp.ndarray,
             maps: jnp.ndarray | None = None) -> jnp.ndarray:
    """128-d SIFT-like descriptors for all keypoints of one image.

    4x4 spatial cells x 8 orientation bins, sampled from the precomputed
    orientation-cell maps at the 16 cell centers around each keypoint
    (16 cell gathers per keypoint instead of 256 patch-pixel gathers),
    then the standard SIFT normalization: L2 -> clip 0.2 -> L2. Upright
    and single scale — exact OpenCV SIFT parity is a non-goal
    (SURVEY.md §7.3); the descriptor feeds the same downstream geometry.
    """
    if maps is None:
        maps = orientation_cell_maps(img)  # (8, H, W)
    cells = _gather_cells(maps, xy)
    desc = cells.reshape(xy.shape[0], DESC_DIM)

    # SIFT normalization: L2 -> clip 0.2 -> L2
    desc = desc / (jnp.linalg.norm(desc, axis=-1, keepdims=True) + 1e-8)
    desc = jnp.minimum(desc, 0.2)
    desc = desc / (jnp.linalg.norm(desc, axis=-1, keepdims=True) + 1e-8)
    return jnp.where(valid[:, None], desc, 0.0)


@partial(jax.jit, static_argnames=("max_kp",))
def detect_and_describe(img: jnp.ndarray, max_kp: int = DEFAULT_MAX_KP,
                        resp: jnp.ndarray | None = None,
                        maps: jnp.ndarray | None = None):
    """cv2 ``detectAndCompute`` equivalent for one image (jit, static out).

    ``resp`` / ``maps`` optionally supply a precomputed Harris response /
    orientation-cell maps.
    Returns dict: xy (max_kp, 2), desc (max_kp, 128), valid (max_kp,).
    """
    det = detect(img, max_kp=max_kp, resp=resp)
    desc = describe(img, det["xy"], det["valid"], maps=maps)
    return {"xy": det["xy"], "desc": desc, "valid": det["valid"], "resp": det["resp"]}


def detect_and_describe_batch(imgs: jnp.ndarray,
                              max_kp: int = DEFAULT_MAX_KP):
    """Batched single-octave detect+describe over (F, H, W) images."""
    return jax.vmap(
        lambda im: detect_and_describe(im, max_kp=max_kp))(imgs)


def _downsample2(img: jnp.ndarray) -> jnp.ndarray:
    """Anti-aliased 2x downsample (one pyramid octave)."""
    return gaussian_blur(img, 1.0, 2)[::2, ::2]


@partial(jax.jit, static_argnames=("max_kp", "num_levels"))
def detect_and_describe_multiscale(
    img: jnp.ndarray, max_kp: int = DEFAULT_MAX_KP, num_levels: int = 2
):
    """Pyramid detection + description over ``num_levels`` octaves.

    The reference's SIFT/AKAZE operate on a scale space (matching.py:19-35:
    AKAZE 4 octaves); this is the batched analogue: each octave gets a
    share of the keypoint budget (full resolution keeps half at every
    split), keypoints are described at their own octave (so the descriptor
    window scales with the feature), and coordinates are mapped back to
    level-0 pixels. num_levels=1 degenerates to single-scale.

    Returns the same dict contract as :func:`detect_and_describe`, plus
    ``scale`` (the octave factor per keypoint).
    """
    budgets = _multiscale_budgets(max_kp, num_levels)

    outs = []
    level_img = img
    for lvl, k in enumerate(budgets):
        det = detect(level_img, max_kp=k, border=max(4, 12 >> lvl))
        desc = describe(level_img, det["xy"], det["valid"])
        factor = float(1 << lvl)
        outs.append({
            "xy": det["xy"] * factor,
            "desc": desc,
            "valid": det["valid"],
            "resp": det["resp"],
            "scale": jnp.full((k,), factor, jnp.float32),
        })
        if lvl + 1 < num_levels:
            level_img = _downsample2(level_img)

    return {
        key: jnp.concatenate([o[key] for o in outs], axis=0)
        for key in ("xy", "desc", "valid", "resp", "scale")
    }


def _multiscale_budgets(max_kp: int, num_levels: int) -> list[int]:
    """Per-octave keypoint budgets (full resolution keeps half per split,
    lane-friendly multiples of 128)."""
    budgets = []
    remaining = max_kp
    for lvl in range(num_levels):
        k = remaining // 2 if lvl < num_levels - 1 else remaining
        k = max(128, (k // 128) * 128)
        k = min(k, remaining)
        budgets.append(k)
        remaining -= k
    budgets[0] += remaining
    return budgets


def detect_and_describe_multiscale_batch(
    imgs: jnp.ndarray,
    max_kp: int = DEFAULT_MAX_KP,
    num_levels: int = 2,
):
    """Batched pyramid detection over (F, H, W) images; the same contract
    as vmapping :func:`detect_and_describe_multiscale`."""
    budgets = _multiscale_budgets(max_kp, num_levels)

    outs = []
    level_imgs = imgs
    for lvl, k in enumerate(budgets):
        border = max(4, 12 >> lvl)
        factor = float(1 << lvl)

        def one(im, k=k, border=border):
            det = detect(im, max_kp=k, border=border)
            return det, describe(im, det["xy"], det["valid"])

        det, desc = jax.vmap(one)(level_imgs)
        F = imgs.shape[0]
        outs.append({
            "xy": det["xy"] * factor,
            "desc": desc,
            "valid": det["valid"],
            "resp": det["resp"],
            "scale": jnp.full((F, k), factor, jnp.float32),
        })
        if lvl + 1 < num_levels:
            level_imgs = jax.vmap(_downsample2)(level_imgs)

    return {
        key: jnp.concatenate([o[key] for o in outs], axis=1)
        for key in ("xy", "desc", "valid", "resp", "scale")
    }


# Batched over a stack of images: (B, H, W) -> pytree with leading B.
detect_and_describe_batched = jax.vmap(detect_and_describe, in_axes=(0,))
