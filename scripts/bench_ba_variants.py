"""Measure candidate BA-engine optimizations in isolation.

Variants, cumulative ablations over one LM iteration x ITERS (same
anti-hoisting carry trick as profile_ba.py):

  base      : current engine (gathers + f32 one-hot blocks + cho_solve)
  mmgather  : poses/points gathers -> one-hot matmuls (exact: one-hots
              are 0/1, f32 accumulate), X/T reused between res and jac
  bf16H     : Hessian blocks (Hpp, Hll, Wc, U) via bf16-input matmuls
              with f32 accumulation; gradient g stays f32 (inexact
              Newton: step quality bounded by H error, final accuracy by
              the f32 gradient + accept/reject)
  solve     : cho_factor/cho_solve replacements for the (B,144,144) SPD
              system: linalg.solve (LU), linalg.inv@g

Usage: python scripts/bench_ba_variants.py [B P L M ITERS]
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from slam_tpu.ops import ba, se3, stereo  # noqa: E402
from slam_tpu.ops.precision import full_precision  # noqa: E402

B, P, L, M, ITERS = 64, 24, 512, 4096, 20
if len(sys.argv) > 1:
    B, P, L, M, ITERS = map(int, sys.argv[1:6])

rng = np.random.default_rng(0)
calib = jnp.asarray([718.856, 718.856, 607.1928, 185.2157, 0.5371657])
poses = jnp.tile(jnp.eye(4)[None], (B, P, 1, 1))
pts = jnp.asarray(rng.uniform([-20, -5, 4], [20, 5, 60], (B, L, 3)),
                  jnp.float32)
cam_idx = jnp.asarray(rng.integers(0, P, (B, M)), jnp.int32)
lm_idx = jnp.asarray(rng.integers(0, L, (B, M)), jnp.int32)
w = jnp.ones((B, M), jnp.float32)
meas = jax.vmap(lambda p, c, l: stereo.project(calib, p[l]))(
    pts, cam_idx, lm_idx)
meas = meas + jnp.asarray(rng.normal(0, 0.3, meas.shape), jnp.float32)

fx, fy, cx, cy, bl = (float(calib[i]) for i in range(5))


def residuals_mm(T, X, meas, w):
    Xc = se3.mv3(T[:, :3, :3], X) + T[:, :3, 3]
    pred = stereo.project(calib, Xc)
    return (pred - meas) * w[:, None], Xc


def jacobians_mm(T, X, w, Xc):
    x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
    iz = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    iz2 = iz * iz
    zero = jnp.zeros_like(x)
    Jproj = jnp.stack(
        [
            jnp.stack([fx * iz, zero, -fx * x * iz2], -1),
            jnp.stack([fx * iz, zero, -fx * (x - bl) * iz2], -1),
            jnp.stack([zero, fy * iz, -fy * y * iz2], -1),
        ],
        axis=-2,
    )
    R = T[:, :3, :3]
    JR = se3.mm33(Jproj, R)
    J_lm = JR * w[:, None, None]
    J_rot = -se3.mm33(JR, se3.hat(X))
    J_pose = jnp.concatenate([J_rot, JR], axis=-1) * w[:, None, None]
    return J_pose, J_lm


def bf16mm(a, b):
    """Matmul with bf16 inputs, f32 accumulation (one pass)."""
    return jax.lax.dot(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                       precision=jax.lax.Precision.DEFAULT,
                       preferred_element_type=jnp.float32)


def build_blocks_bf16(J_pose, J_lm, r, oc, ol, P, L):
    ocb = oc.astype(jnp.bfloat16)
    olb = ol.astype(jnp.bfloat16)
    # gradient stays f32 (sets final accuracy)
    g_p = oc.T @ ba._jtr3(J_pose, r)
    g_l = ol.T @ ba._jtr3(J_lm, r)
    opp = ba._outer3(J_pose, J_pose).reshape(-1, 36)
    Hpp = bf16mm(oc.T, opp).reshape(P, 6, 6)
    oll = ba._outer3(J_lm, J_lm).reshape(-1, 9)
    Hll = bf16mm(ol.T, oll).reshape(L, 3, 3)
    opl = ba._outer3(J_pose, J_lm).reshape(-1, 18).astype(jnp.bfloat16)
    z = ocb[:, :, None] * opl[:, None, :]
    Wc = bf16mm(ol.T.astype(jnp.bfloat16),
                z.reshape(-1, P * 18)).reshape(L, P, 6, 3)
    return g_p, g_l, Hpp, Hll, Wc


def schur_from_blocks(g_p, g_l, Hpp, Hll, Wc, P, L, lam, solver,
                      bf16_u=False):
    dtype = jnp.float32
    eyeP = jnp.eye(6, dtype=dtype)
    eyeL = jnp.eye(3, dtype=dtype)
    Hpp_d = Hpp + lam * eyeP[None]
    Hll_d = Hll + lam * eyeL[None] + 1e-8 * eyeL[None]
    Hll_inv = ba._inv3x3(Hll_d)
    WHinv = (Wc[..., 0, None] * Hll_inv[:, None, None, 0, :]
             + Wc[..., 1, None] * Hll_inv[:, None, None, 1, :]
             + Wc[..., 2, None] * Hll_inv[:, None, None, 2, :])
    A = jnp.transpose(WHinv, (1, 2, 0, 3)).reshape(P * 6, L * 3)
    Bm = jnp.transpose(Wc, (1, 2, 0, 3)).reshape(P * 6, L * 3)
    if bf16_u:
        U = bf16mm(A, Bm.T).reshape(P, 6, P, 6)
    else:
        U = (A @ Bm.T).reshape(P, 6, P, 6)
    S = -U
    diag = jnp.arange(P)
    S = S.at[diag, :, diag, :].add(Hpp_d)
    ghat = g_p - (A @ g_l.reshape(L * 3)).reshape(P, 6)
    S = S.reshape(P * 6, P * 6)
    mask = jnp.concatenate([jnp.zeros(6, dtype), jnp.ones((P - 1) * 6,
                                                          dtype)])
    S = S * mask[:, None] * mask[None, :] + jnp.diag(1.0 - mask)
    ghat = ghat.reshape(P * 6) * mask
    if solver == "chol":
        chol = jax.scipy.linalg.cho_factor(S, lower=True)
        dp = -jax.scipy.linalg.cho_solve(chol, ghat).reshape(P, 6)
    elif solver == "lu":
        dp = -jnp.linalg.solve(S, ghat).reshape(P, 6)
    elif solver == "inv":
        dp = -(jnp.linalg.inv(S) @ ghat).reshape(P, 6)
    Wt_dp = (Bm.T @ dp.reshape(P * 6)).reshape(L, 3)
    dl = -se3.mv3(Hll_inv, g_l + Wt_dp)
    return dp, dl


def run(tag, make_body):
    def inner(poses, pts):
        def one(po, pt, ci, li, me, ww):
            oc = (ci[:, None] == jnp.arange(P, dtype=ci.dtype)).astype(
                jnp.float32)
            ol = (li[:, None] == jnp.arange(L, dtype=li.dtype)).astype(
                jnp.float32)
            body = make_body(po, ci, li, me, ww, oc, ol)
            return jax.lax.scan(body, pt, None, length=ITERS)[0]

        return jax.vmap(one)(poses, pts, cam_idx, lm_idx, meas, w)

    f = jax.jit(full_precision(inner))
    out = f(poses, pts)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(3):
        out = f(poses, pts)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / 3
    print(f"{tag:28s}: {dt * 1e3:8.1f} ms  ({B * ITERS / dt / 20:.0f} "
          f"eq-windows/s @20it)", flush=True)


def body_base(po, ci, li, me, ww, oc, ol):
    def body(pt, _):
        r, Xc = ba._residuals(po, pt, ci, li, me, ww, calib)
        Jp, Jl = ba._jacobians(po, pt, ci, li, ww, calib, Xc)
        dp, dl = ba._schur_solve(Jp, Jl, r, ci, li, P, L, 1e-4,
                                 onehots=(oc, ol))
        return pt + 1e-12 * (jnp.sum(dp) + jnp.sum(dl)), None
    return body


def make_body_mm(solver, bf16_blocks, bf16_u=False):
    def mk(po, ci, li, me, ww, oc, ol):
        def body(pt, _):
            T = (oc @ po.reshape(P, 16)).reshape(M, 4, 4)
            X = ol @ pt
            r, Xc = residuals_mm(T, X, me, ww)
            Jp, Jl = jacobians_mm(T, X, ww, Xc)
            if bf16_blocks:
                blk = build_blocks_bf16(Jp, Jl, r, oc, ol, P, L)
            else:
                blk = ba._build_blocks_onehot(Jp, Jl, r, oc, ol, P, L)
            dp, dl = schur_from_blocks(*blk, P, L, 1e-4, solver,
                                       bf16_u=bf16_u)
            return pt + 1e-12 * (jnp.sum(dp) + jnp.sum(dl)), None
        return body
    return mk


print(f"B={B} P={P} L={L} M={M} iters={ITERS} "
      f"backend={jax.default_backend()}", flush=True)
if not (set(sys.argv) & {"--phases", "--fold"}):
    run("base (current engine)", body_base)
    run("mmgather", make_body_mm("chol", False))
    run("mmgather+bf16H", make_body_mm("chol", True))
    run("mmgather+bf16H+bf16U", make_body_mm("chol", True, True))
    run("mmgather+bf16H+lu", make_body_mm("lu", True))
    run("mmgather+bf16H+inv", make_body_mm("inv", True))


# ---- phase ablation of the shipped engine + batch scaling ----------------

def make_body_phase(phase):
    def mk(po, ci, li, me, ww, oc, ol):
        def body(pt, _):
            T = (oc @ po.reshape(P, 16)).reshape(M, 4, 4)
            X = ol @ pt
            r, Xc = residuals_mm(T, X, me, ww)
            Jp, Jl = jacobians_mm(T, X, ww, Xc)
            # consume FULL sums everywhere: an `x[0]`-only consumer lets
            # XLA slice the producing matmul down to one row (round-5
            # finding: the original assemble phase read 186 ms while the
            # real pre-solve work is ~2x that)
            if phase == "resjac":
                acc = jnp.sum(Jp) + jnp.sum(Jl) + jnp.sum(r)
            elif phase == "grad":
                g_p = oc.T @ ba._jtr3(Jp, r)
                g_l = ol.T @ ba._jtr3(Jl, r)
                acc = jnp.sum(g_p) + jnp.sum(g_l)
            elif phase == "blocks":
                blk = ba._build_blocks_onehot_bf16(Jp, Jl, r, oc, ol, P, L)
                acc = sum(jnp.sum(b) for b in blk)
            elif phase in ("assemble", "solve"):
                g_p, g_l, Hpp, Hll, Wc = ba._build_blocks_onehot_bf16(
                    Jp, Jl, r, oc, ol, P, L)
                lam = 1e-4
                eyeP = jnp.eye(6); eyeL = jnp.eye(3)
                Hpp_d = Hpp + lam * eyeP[None]
                Hll_inv = ba._inv3x3(Hll + lam * eyeL[None] + 1e-8 * eyeL[None])
                WHinv = (Wc[..., 0, None] * Hll_inv[:, None, None, 0, :]
                         + Wc[..., 1, None] * Hll_inv[:, None, None, 1, :]
                         + Wc[..., 2, None] * Hll_inv[:, None, None, 2, :])
                A = jnp.transpose(WHinv, (1, 2, 0, 3)).reshape(P * 6, L * 3)
                Bm = jnp.transpose(Wc, (1, 2, 0, 3)).reshape(P * 6, L * 3)
                U = bf16mm(A, Bm.T).reshape(P, 6, P, 6)
                ghat = g_p - (A @ g_l.reshape(-1)).reshape(P, 6)
                S = (Hpp_d[:, :, None, :]
                     * jnp.eye(P)[:, None, :, None] - U)
                S = S.reshape(P * 6, P * 6)
                mask = jnp.concatenate([jnp.zeros(6), jnp.ones((P - 1) * 6)])
                S = S * mask[:, None] * mask[None, :] + jnp.diag(1.0 - mask)
                ghat = ghat.reshape(P * 6) * mask
                if phase == "solve":
                    chol = jax.scipy.linalg.cho_factor(S, lower=True)
                    dp = -jax.scipy.linalg.cho_solve(chol, ghat)
                    acc = jnp.sum(dp)
                elif phase == "factor":
                    # factorization only — splits the solve delta into
                    # cho_factor vs the two narrow triangular solves
                    Lc = jax.lax.linalg.cholesky(S, symmetrize_input=False)
                    acc = jnp.sum(Lc)
                else:
                    acc = jnp.sum(S) + jnp.sum(ghat)
            elif phase == "full":
                dp, dl = ba._schur_solve(Jp, Jl, r, ci, li, P, L, 1e-4,
                                         onehots=(oc, ol), mm_passes=3)
                acc = jnp.sum(dp) + jnp.sum(dl)
            elif phase == "backsub_es":
                # full, but the landmark backsub contracts Wc directly
                # (einsum over (p,i)) instead of forming Bm.T @ dp — tests
                # whether the (P6, L3) transpose materialization is the
                # backsub's cost
                g_p, g_l, Hpp, Hll, Wc = ba._build_blocks_onehot_bf16(
                    Jp, Jl, r, oc, ol, P, L)
                lam = 1e-4
                eyeP = jnp.eye(6); eyeL = jnp.eye(3)
                Hpp_d = Hpp + lam * eyeP[None]
                Hll_inv = ba._inv3x3(Hll + lam * eyeL[None] + 1e-8 * eyeL[None])
                WHinv = (Wc[..., 0, None] * Hll_inv[:, None, None, 0, :]
                         + Wc[..., 1, None] * Hll_inv[:, None, None, 1, :]
                         + Wc[..., 2, None] * Hll_inv[:, None, None, 2, :])
                A = jnp.transpose(WHinv, (1, 2, 0, 3)).reshape(P * 6, L * 3)
                Bm = jnp.transpose(Wc, (1, 2, 0, 3)).reshape(P * 6, L * 3)
                U = bf16mm(A, Bm.T).reshape(P, 6, P, 6)
                ghat = g_p - (A @ g_l.reshape(-1)).reshape(P, 6)
                S = (Hpp_d[:, :, None, :]
                     * jnp.eye(P)[:, None, :, None] - U).reshape(P * 6, P * 6)
                mask = jnp.concatenate([jnp.zeros(6), jnp.ones((P - 1) * 6)])
                S = S * mask[:, None] * mask[None, :] + jnp.diag(1.0 - mask)
                gh = ghat.reshape(P * 6) * mask
                chol = jax.scipy.linalg.cho_factor(S, lower=True)
                dp = -jax.scipy.linalg.cho_solve(chol, gh).reshape(P, 6)
                Wt_dp = jnp.einsum("lpij,pi->lj", Wc, dp)
                dl = -se3.mv3(Hll_inv, g_l + Wt_dp)
                acc = jnp.sum(dp) + jnp.sum(dl)
            else:  # step: the engine's ENTIRE LM step incl. retract +
                # accept/reject cost pass — full minus this = scan carry
                dp, dl = ba._schur_solve(Jp, Jl, r, ci, li, P, L, 1e-4,
                                         onehots=(oc, ol), mm_passes=3)
                new_po = jax.vmap(se3.retract)(po, dp)
                new_pt = pt + dl
                c = ba._cost(new_po, new_pt, ci, li, me, ww, calib,
                             onehots=(oc, ol))
                ok = jnp.isfinite(c)
                return jnp.where(ok, new_pt, pt) + 1e-12 * c, None
            return pt + 1e-12 * acc, None
        return body
    return mk


if "--phases" in sys.argv:
    import os

    default = "resjac,grad,blocks,assemble,solve,full,step"
    for ph in os.environ.get("PHASES", default).split(","):
        run(f"ship:{ph}", make_body_phase(ph))


# ---- assemble/solve micro-optimizations -----------------------------------

def make_body_fold(solver="chol"):
    """Fold Hll_inv into the ALREADY-TRANSPOSED Bm layout: one transpose
    of Wc instead of two, and no (L,P,6,3) WHinv materialization."""
    def mk(po, ci, li, me, ww, oc, ol):
        def body(pt, _):
            T = (oc @ po.reshape(P, 16)).reshape(M, 4, 4)
            X = ol @ pt
            r, Xc = residuals_mm(T, X, me, ww)
            Jp, Jl = jacobians_mm(T, X, ww, Xc)
            g_p, g_l, Hpp, Hll, Wc = build_blocks_bf16(Jp, Jl, r, oc, ol,
                                                       P, L)
            lam = 1e-4
            eyeP = jnp.eye(6); eyeL = jnp.eye(3)
            Hpp_d = Hpp + lam * eyeP[None]
            Hll_inv = ba._inv3x3(Hll + lam * eyeL[None] + 1e-8 * eyeL[None])
            Bm4 = jnp.transpose(Wc, (1, 2, 0, 3))          # (P,6,L,3)
            A4 = jnp.einsum("pklj,ljn->pkln", Bm4, Hll_inv)
            A = A4.reshape(P * 6, L * 3)
            Bm = Bm4.reshape(P * 6, L * 3)
            U = bf16mm(A, Bm.T).reshape(P, 6, P, 6)
            S = -U
            diag = jnp.arange(P)
            S = S.at[diag, :, diag, :].add(Hpp_d)
            ghat = g_p - (A @ g_l.reshape(L * 3)).reshape(P, 6)
            S = S.reshape(P * 6, P * 6)
            mask = jnp.concatenate([jnp.zeros(6), jnp.ones((P - 1) * 6)])
            S = S * mask[:, None] * mask[None, :] + jnp.diag(1.0 - mask)
            ghat = ghat.reshape(P * 6) * mask
            if solver == "chol":
                chol = jax.scipy.linalg.cho_factor(S, lower=True)
                dp = -jax.scipy.linalg.cho_solve(chol, ghat).reshape(P, 6)
            else:  # raw lax cholesky + triangular solves, no symmetrize
                Lc = jax.lax.linalg.cholesky(S, symmetrize_input=False)
                y = jax.lax.linalg.triangular_solve(
                    Lc, ghat[:, None], left_side=True, lower=True)
                dp = -jax.lax.linalg.triangular_solve(
                    Lc, y, left_side=True, lower=True,
                    transpose_a=True)[:, 0].reshape(P, 6)
            Wt_dp = (Bm.T @ dp.reshape(P * 6)).reshape(L, 3)
            dl = -se3.mv3(Hll_inv, g_l + Wt_dp)
            return pt + 1e-12 * (jnp.sum(dp) + jnp.sum(dl)), None
        return body
    return mk


if "--fold" in sys.argv:
    run("fold:chol", make_body_fold("chol"))
    run("fold:laxchol", make_body_fold("lax"))
