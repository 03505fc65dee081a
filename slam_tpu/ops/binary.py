"""Binary-descriptor (NORM_HAMMING) matching path.

Reference surface: the headline AKAZE configuration matches binary MLDB
descriptors with ``BFMatcher(cv2.NORM_HAMMING, crossCheck=True)``
(final_project/algorithms/matching.py:19-24). This design does NOT
bit-pack and popcount — it stores each bit as a ±1 bf16 lane so the
XOR-popcount collapses into a matrix product:

    popcount(a XOR b) = (D - <s_a, s_b>) / 2,   s = 2*bit - 1 in {-1,+1}

One bf16 matmul with f32 accumulation therefore computes the EXACT
Hamming distance for all pairs (every value is a small integer: |s.s| <=
D = 128, exactly representable in bf16 inputs / f32 accumulation), and
the float mutual-nearest matcher (ops/matching.mutual_match) applies
unchanged: its L2-form base distance 2 - 2<s_a, s_b> =
(2 - 2D) + 4*hamming is an affine, strictly increasing function of the
Hamming distance, so every argmin / crossCheck decision is bit-identical
to a popcount matcher; only the reported distance is mapped back to bit
counts.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import matching

DESC_BITS = 128  # one bit per float-descriptor dimension


def binarize_descriptors(desc: jnp.ndarray) -> jnp.ndarray:
    """(..., K, D) float descriptors -> (..., K, D) ±1 bit signs.

    LDB-style binarization: bit d is set iff the descriptor's cell energy
    at dimension d exceeds the descriptor's own mean (AKAZE's MLDB
    compares mean cell intensities/gradients; our float descriptor is
    already per-cell pooled gradient energy, ops/features.describe, so
    the mean test is its natural 1-bit quantization). Invalid slots
    binarize like any other — callers mask them via ``valid`` in the
    matcher, and an all-equal (zero) descriptor yields all -1 bits.
    """
    thresh = jnp.mean(desc, axis=-1, keepdims=True)
    return jnp.where(desc > thresh, 1.0, -1.0).astype(desc.dtype)


def base_gate_from_hamming(max_hamming: float, D: int) -> float:
    """Hamming gate -> the matcher's L2-form base-distance gate.

    The matcher applies a strict ``dist < gate`` test while Hamming
    distances are integers; the +0.5-bit offset makes the gate inclusive
    (``h <= max_hamming`` passes, ``h = max_hamming + 1`` does not),
    exactly — all quantities are small integers times 4.
    """
    return (2.0 - 2.0 * D) + 4.0 * (float(max_hamming) + 0.5)


_affine = base_gate_from_hamming  # internal alias


def hamming_from_base(dist: jnp.ndarray, D: int = DESC_BITS) -> jnp.ndarray:
    """Invert base = (2-2D) + 4*h on matched entries (BIG stays BIG)."""
    h = (dist - (2.0 - 2.0 * D)) * 0.25
    return jnp.where(dist >= matching.BIG, dist, h)


def hamming_mutual_match(
    sbits_a: jnp.ndarray,   # (Ka, D) ±1 signs (binarize_descriptors)
    sbits_b: jnp.ndarray,   # (Kb, D)
    valid_a: jnp.ndarray,
    valid_b: jnp.ndarray,
    max_hamming: float = DESC_BITS,
    xy_a: jnp.ndarray | None = None,
    xy_b: jnp.ndarray | None = None,
    window: tuple | None = None,
):
    """``BFMatcher(NORM_HAMMING, crossCheck=True)`` equivalent.

    Same contract as ops/matching.mutual_match but distances are Hamming
    bit counts, through the same matcher (and kernel routing) as the
    float path.
    """
    D = sbits_a.shape[-1]
    out = matching.mutual_match(
        sbits_a, sbits_b, valid_a, valid_b,
        max_dist=_affine(max_hamming, D), xy_a=xy_a, xy_b=xy_b,
        window=window,
    )
    return {
        "target_idx": out["target_idx"],
        "dist": hamming_from_base(out["dist"], D),
        "matched": out["matched"],
    }


def hamming_mutual_match_batched(sbits_a, sbits_b, valid_a, valid_b,
                                 max_hamming: float = DESC_BITS,
                                 xy_a=None, xy_b=None, window=None):
    """vmapped :func:`hamming_mutual_match` over a leading frame axis."""
    n_xy = 2 if (xy_a is not None and window is not None) else 0
    if n_xy:
        return jax.vmap(
            lambda a, b, va, vb, xa, xb: hamming_mutual_match(
                a, b, va, vb, max_hamming=max_hamming,
                xy_a=xa, xy_b=xb, window=window)
        )(sbits_a, sbits_b, valid_a, valid_b, xy_a, xy_b)
    return jax.vmap(
        lambda a, b, va, vb: hamming_mutual_match(
            a, b, va, vb, max_hamming=max_hamming)
    )(sbits_a, sbits_b, valid_a, valid_b)


def hamming_distance_matrix_ref(sbits_a: np.ndarray, sbits_b: np.ndarray
                                ) -> np.ndarray:
    """Host popcount reference (packed-bit XOR) for parity tests ONLY."""
    bits_a = (np.asarray(sbits_a) > 0).astype(np.uint8)
    bits_b = (np.asarray(sbits_b) > 0).astype(np.uint8)
    pa = np.packbits(bits_a, axis=-1)
    pb = np.packbits(bits_b, axis=-1)
    x = np.bitwise_xor(pa[:, None, :], pb[None, :, :])
    return np.unpackbits(x, axis=-1).sum(axis=-1).astype(np.int32)
