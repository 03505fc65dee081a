"""SE(3) / SO(3) utilities in pure JAX.

Replaces the reference's use of ``gtsam.Pose3 / Rot3`` arithmetic
(reference: final_project/backend/GTSam/gtsam_utils.py:25-73,
final_project/backend/GTSam/pose_graph.py:49-51) and ``cv2.Rodrigues``
(reference: final_project/utils.py:16-18) with closed-form, vmappable,
jit-friendly functions on 4x4 homogeneous matrices and 3x3 rotations.

Conventions
-----------
A "pose" ``T`` is a 4x4 homogeneous matrix. Two conventions appear in the
pipeline, always documented at the call site:
  * extrinsics ``T_w2c`` (world -> camera), the KITTI calib convention
    (reference Inputs.py M matrices);
  * poses ``T_c2w`` (camera -> world), the gtsam ``Pose3`` convention.
All functions here are convention-agnostic matrix ops.

All functions work on float32/float64 and are safe under ``jax.vmap`` /
``jax.jit``; small-angle branches use Taylor expansions selected with
``jnp.where`` so gradients are finite everywhere.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8
# Taylor-branch threshold on theta^2 for the sinc-family coefficients.
# Sized for float32: below theta ~ 0.032 rad the 2-term series is exact to
# single precision, while the closed forms ((theta - sin)/theta^3,
# (1 - a/2b)/theta^2) suffer catastrophic cancellation well before that.
_SMALL_THETA2 = 1e-3


# ---------------------------------------------------------------------------
# small-matrix algebra (explicit VPU forms)
# ---------------------------------------------------------------------------

def mv3(A: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Batched (..., 3, 3) @ (..., 3) as explicit elementwise mult-adds.

    A dot_general with a 3-wide contraction becomes a padded micro-matmul
    per block; the mult-add form fuses with the surrounding elementwise
    work instead. Used everywhere the geometry code touches batched 3x3
    blocks (see ops/ba.py).
    """
    return (A[..., :, 0] * v[..., 0, None]
            + A[..., :, 1] * v[..., 1, None]
            + A[..., :, 2] * v[..., 2, None])


def mm33(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Batched (..., 3, 3) @ (..., 3, 3) as explicit VPU mult-adds."""
    return (A[..., :, 0, None] * B[..., 0, None, :]
            + A[..., :, 1, None] * B[..., 1, None, :]
            + A[..., :, 2, None] * B[..., 2, None, :])


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def hat(w: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric matrix of a 3-vector (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`hat`: (..., 3, 3) -> (..., 3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues' formula: rotation vector (..., 3) -> rotation matrix.

    Equivalent of ``cv2.Rodrigues(rvec)`` (reference utils.py:16-18), with a
    second-order Taylor branch near theta=0.
    """
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = mm33(W, W)
    # sin(t)/t and (1-cos(t))/t^2. (1-cos) is computed as 2 sin^2(t/2) —
    # in float32 cos(t) rounds to exactly 1.0 for t < ~3.5e-4, which made
    # the naive form produce b=0 (and inf/NaN downstream in se3_log) for
    # the tiny-rotation edges a bundle-refined pose graph is full of. The
    # Taylor branch threshold is sized for f32: below theta=0.032 the
    # 2-term series is exact to single precision.
    small = theta2 < _SMALL_THETA2
    s_half = jnp.sin(0.5 * theta)
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, 2.0 * s_half * s_half / theta2)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix (..., 3, 3) -> rotation vector (..., 3).

    Equivalent of ``cv2.Rodrigues(R)``. Handles the theta -> 0 and
    theta -> pi regimes (the latter via the diagonal-based axis recovery).
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    sin_t = jnp.sin(theta)

    # Generic branch: vee of the antisymmetric part, scaled.
    w_generic = vee(R - jnp.swapaxes(R, -1, -2)) * (
        0.5 * theta / jnp.where(jnp.abs(sin_t) < _EPS, 1.0, sin_t)
    )[..., None]

    # Small-angle branch: first-order, vee of antisymmetric part.
    w_small = vee(R - jnp.swapaxes(R, -1, -2)) * 0.5

    # Near-pi branch: axis from the largest diagonal of (R + I) / 2.
    Rp = (R + jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape))
    diag = jnp.stack([Rp[..., 0, 0], Rp[..., 1, 1], Rp[..., 2, 2]], axis=-1)
    k = jnp.argmax(diag, axis=-1)
    col = jnp.take_along_axis(Rp, k[..., None, None].repeat(3, axis=-2), axis=-1)[..., 0]
    axis = col / (jnp.linalg.norm(col, axis=-1, keepdims=True) + _EPS)
    w_pi = axis * theta[..., None]

    near_pi = cos_t < -1.0 + 1e-6
    small = theta < 1e-5
    return jnp.where(
        small[..., None], w_small, jnp.where(near_pi[..., None], w_pi, w_generic)
    )


def rotation_angle_deg(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation angle of R in degrees (reference analysis.py:490-505 metric)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    return jnp.degrees(jnp.arccos(cos_t))


def rotation_ypr(R: jnp.ndarray) -> jnp.ndarray:
    """Yaw-pitch-roll (Z-Y-X Euler) of a rotation matrix, (..., 3).

    Matches gtsam ``Rot3.ypr()`` used in the reference Mahalanobis delta
    (loop_closure.py:153-156).
    """
    yaw = jnp.arctan2(R[..., 1, 0], R[..., 0, 0])
    pitch = jnp.arcsin(jnp.clip(-R[..., 2, 0], -1.0, 1.0))
    roll = jnp.arctan2(R[..., 2, 1], R[..., 2, 2])
    return jnp.stack([yaw, pitch, roll], axis=-1)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def make_T(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Assemble a 4x4 homogeneous matrix from (..., 3, 3) and (..., 3)."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (4,)
    )[..., None, :]
    return jnp.concatenate([top, bottom], axis=-2)


def rot(T: jnp.ndarray) -> jnp.ndarray:
    return T[..., :3, :3]


def trans(T: jnp.ndarray) -> jnp.ndarray:
    return T[..., :3, 3]


def inverse(T: jnp.ndarray) -> jnp.ndarray:
    """Closed-form SE(3) inverse (reference gtsam_utils.py:37-43)."""
    R = rot(T)
    t = trans(T)
    Rt = jnp.swapaxes(R, -1, -2)
    return make_T(Rt, -mv3(Rt, t))


def compose(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """A @ B for homogeneous matrices."""
    return A @ B


def between(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """gtsam-style ``A.between(B) = A^-1 B`` (reference pose_graph.py:49-51)."""
    return inverse(A) @ B


def transform_points(T: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply (..., 4, 4) to points (..., N, 3) -> (..., N, 3)."""
    R = rot(T)
    t = trans(T)
    out = (pts[..., :, 0, None] * R[..., None, :, 0]
           + pts[..., :, 1, None] * R[..., None, :, 1]
           + pts[..., :, 2, None] * R[..., None, :, 2])
    return out + t[..., None, :]


def se3_exp(xi: jnp.ndarray) -> jnp.ndarray:
    """Exponential map: twist (..., 6) [w, v] -> 4x4 homogeneous matrix."""
    w = xi[..., :3]
    v = xi[..., 3:]
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = mm33(W, W)
    small = theta2 < _SMALL_THETA2
    s_half = jnp.sin(0.5 * theta)
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, 2.0 * s_half * s_half / theta2)
    c = jnp.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (theta2 * theta)
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    t = mv3(V, v)
    return make_T(R, t)


def se3_log(T: jnp.ndarray) -> jnp.ndarray:
    """Log map: 4x4 -> twist (..., 6) [w, v]. Inverse of :func:`se3_exp`."""
    R = rot(T)
    t = trans(T)
    w = so3_log(R)
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = mm33(W, W)
    small = theta2 < _SMALL_THETA2
    # V^{-1} = I - W/2 + (1/theta^2)(1 - a/(2b)) W^2, where
    # 1 - a/(2b) = 1 - (theta/2) cot(theta/2). The naive a/b form divides
    # by b = (1-cos)/theta^2, which underflows to 0 in f32 for
    # theta < ~3.5e-4 (NaN residuals on tiny-rotation pose-graph edges);
    # the cot form with a float32-sized Taylor branch is stable.
    s_half = jnp.sin(0.5 * theta)
    c_half = jnp.cos(0.5 * theta)
    cot_term = 0.5 * theta * c_half / jnp.where(
        jnp.abs(s_half) < _EPS, 1.0, s_half
    )
    coef = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - cot_term) / theta2,
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), W.shape)
    Vinv = eye - 0.5 * W + coef[..., None, None] * W2
    v = mv3(Vinv, t)
    return jnp.concatenate([w, v], axis=-1)


def retract(T: jnp.ndarray, xi: jnp.ndarray) -> jnp.ndarray:
    """Right-multiplicative retraction ``T * exp(xi)`` (gtsam convention)."""
    return T @ se3_exp(xi)


def local(T0: jnp.ndarray, T1: jnp.ndarray) -> jnp.ndarray:
    """Local coordinates of T1 around T0: ``log(T0^-1 T1)``."""
    return se3_log(between(T0, T1))


def project_to_so3(R: jnp.ndarray) -> jnp.ndarray:
    """Nearest rotation matrix via SVD (numerical cleanup after chains)."""
    U, _, Vt = jnp.linalg.svd(R)
    det = jnp.linalg.det(U @ Vt)
    S = jnp.concatenate(
        [jnp.ones_like(det)[..., None], jnp.ones_like(det)[..., None], det[..., None]],
        axis=-1,
    )
    return (U * S[..., None, :]) @ Vt
