"""Stage-overlap scheduler: pipeline parallelism across mesh stage groups.

SURVEY.md §2.4 PP row — the reference runs its stages strictly
sequentially (stage caching in final_project/project.py:29-91); the
batched plan is "detect/match (frame t+k) overlaps PnP (t) and BA
(window t-w)". This module implements that as a two-stage-group pipeline:

  devices[0:n_fe]   — FRONTEND group: frame-sharded detect / describe /
                      match / RANSAC chunks (parallel/sharded_frontend)
  devices[n_fe:]    — BACKEND group: window-sharded batched bundle
                      adjustment (parallel/sharded_ba)

As each frontend chunk lands on host, track chaining is extended
incrementally, the greedy keyframe cut is resumed from the last finalized
keyframe (prefix-stable, models/bundle.select_keyframes), and every
window whose keyframe span is complete is built and *dispatched
asynchronously* to the backend group. JAX's async dispatch makes the
overlap real: the backend group LM-optimizes windows of chunk <= c while
the frontend group computes chunk c+1 and the host builds windows — no
explicit threads, no blocking until the final gather.

A keyframe cut is "final" once the cut condition actually fired inside
the processed prefix (a cut at the prefix edge may only exist because the
prefix ended, so it is deferred to the next flush). This preserves
bit-identical keyframe/window structure vs the sequential pipeline —
asserted in tests/test_stage_overlap.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from ..config import SlamConfig
from ..models import bundle as bundle_mod
from ..models import frontend as frontend_mod
from ..models.trackstore import NO_ID, TrackStore, chain_tracks
from . import mesh as mesh_lib
from .sharded_ba import ba_training_step
from .sharded_frontend import frontend_training_step


def split_mesh(mesh: Mesh | None, fe_devices: int | None = None,
               axis: str = "dp") -> tuple[Mesh, Mesh]:
    """Split a flat mesh into (frontend, backend) stage groups.

    With one device (or no mesh) both groups share the device — the
    pipeline still overlaps host window-building with device compute via
    async dispatch, it just cannot overlap the two compute stages.
    """
    devs = (list(mesh.devices.flatten()) if mesh is not None
            else jax.devices()[:1])
    if len(devs) == 1:
        m = Mesh(np.asarray(devs), (axis,))
        return m, m
    n_fe = fe_devices if fe_devices is not None else (len(devs) + 1) // 2
    n_fe = max(1, min(n_fe, len(devs) - 1))
    return (Mesh(np.asarray(devs[:n_fe]), (axis,)),
            Mesh(np.asarray(devs[n_fe:]), (axis,)))


@dataclass
class _PendingBA:
    futures: tuple      # device arrays (async)
    real_B: int
    batch: bundle_mod.BundleBatch


def run_pipeline_overlapped(
    images_left: np.ndarray,
    images_right: np.ndarray,
    calib,
    cfg: SlamConfig = SlamConfig(),
    mesh: Mesh | None = None,
    fe_devices: int | None = None,
):
    """Frontend + bundle adjustment with stage-group pipeline overlap.

    Returns (FrontendResult, TrackStore, BundleResult) — the inputs the
    sequential driver needs for the pose-graph / loop-closure stages.
    """
    fe_mesh, ba_mesh = split_mesh(mesh, fe_devices)
    n_fe = int(fe_mesh.devices.size)
    n_ba = int(ba_mesh.devices.size)
    F = images_left.shape[0]
    K = cfg.features.max_kp
    chunk = cfg.runtime.chunk_frames
    step_frames = chunk * n_fe

    step_first = frontend_training_step(fe_mesh, cfg, calib, with_carry=False)
    step_carry = frontend_training_step(fe_mesh, cfg, calib, with_carry=True)
    ba_step = ba_training_step(
        ba_mesh, calib, iters=cfg.bundle.lm_iters,
        min_depth=cfg.bundle.min_depth, max_depth=cfg.bundle.max_depth,
        huber_delta=cfg.bundle.huber_delta_px,
    )
    base_key = jax.random.PRNGKey(cfg.seed)

    # frontend accumulators. Fixed-size arrays filled per chunk: a flush
    # happens per chunk, so list-concatenation prefixes would make host
    # work O(F^2) over the run — preallocation keeps each flush O(chunk)
    # for the chaining and O(prefix) only for the (cheap) CSR lexsort.
    outs: list[dict] = []
    T_all = np.zeros((F, 4, 4), np.float32)
    acc = {
        "xy": np.zeros((F, K, 2), np.float32),
        "links": np.zeros((F, K, 3), np.float32),
        "link_valid": np.zeros((F, K), bool),
        "valid": np.zeros((F, K), bool),
        "match_prev": np.full((F, K), -1, np.int32),
        "inlier_prev": np.zeros((F, K), bool),
        "inlier_frac": np.zeros(F, np.float32),
    }
    T_carry = np.eye(4, dtype=np.float32)
    carry = None
    # incremental track chaining + keyframing state
    track_ids = np.full((F, K), NO_ID, np.int32)
    next_track = 0
    frames_done = 0
    last_final_kf = 0
    kfs_final: list[int] = [0]
    pending: list[_PendingBA] = []

    def prefix_front(n):
        return SimpleNamespace(
            desc=None,
            **{k_: v[:n] for k_, v in acc.items()},
        )

    def flush_windows(final: bool):
        """Finalize new keyframe cuts on the processed prefix and dispatch
        their windows to the backend group."""
        nonlocal last_final_kf
        n = frames_done
        if last_final_kf >= n - 1:
            return
        if not final and n - last_final_kf < cfg.keyframes.min_gap + 1:
            return  # the final flush still emits the trailing stub cut at
            # F-1 (sequential select_keyframes always ends there)
        front = prefix_front(n)
        db = TrackStore._finalize(front, track_ids[:n], next_track)
        T_prefix = T_all[:n]
        cuts = bundle_mod.select_keyframes(
            db, T_prefix, cfg.keyframes, start=last_final_kf
        )[1:]
        if not final and cuts and cuts[-1] >= n - 1:
            # the prefix-edge cut may only exist because the prefix ended
            cuts = cuts[:-1]
        if not cuts:
            return
        span = [last_final_kf] + cuts
        batch = bundle_mod.build_windows(db, T_prefix, span, cfg.bundle)
        bundle_mod.init_landmarks(batch, calib)
        arrs = {}
        for name in ("poses0", "points0", "cam_idx", "lm_idx", "meas", "w"):
            arrs[name], realB = mesh_lib.pad_to_multiple(
                getattr(batch, name), n_ba)
        n_poses, _ = mesh_lib.pad_to_multiple(
            np.maximum(batch.n_poses, 1).astype(np.int32), n_ba)
        futures = ba_step(arrs["poses0"], arrs["points0"], arrs["cam_idx"],
                          arrs["lm_idx"], arrs["meas"], arrs["w"], n_poses)
        pending.append(_PendingBA(futures=futures, real_B=realB, batch=batch))
        kfs_final.extend(cuts)
        last_final_kf = cuts[-1]

    for start in range(0, F, step_frames):
        bl = images_left[start : start + step_frames]
        br = images_right[start : start + step_frames]
        n = bl.shape[0]
        if n < step_frames:
            pad = step_frames - n
            bl = np.concatenate([bl, np.zeros((pad,) + bl.shape[1:],
                                              bl.dtype)])
            br = np.concatenate([br, np.zeros((pad,) + br.shape[1:],
                                              br.dtype)])
        sub = jax.random.fold_in(base_key, start // step_frames)
        if carry is None:
            out, carry = step_first(jnp.asarray(bl), jnp.asarray(br), sub)
        else:
            out, carry = step_carry(jnp.asarray(bl), jnp.asarray(br), carry,
                                    sub)
        desc_dev = out.pop("desc")[:n]  # device-resident (DescriptorBank)
        out = jax.tree.map(lambda x: np.asarray(x[:n]), out)
        out["desc"] = desc_dev
        T = out["T_chain"] @ T_carry[None]
        T_carry = T[-1]
        T_all[start : start + n] = T
        outs.append(out)
        for k_ in acc:
            acc[k_][start : start + n] = out[k_]
        next_track = chain_tracks(track_ids, next_track, acc["match_prev"],
                                  acc["inlier_prev"], start, start + n)
        frames_done = start + n
        # overlap: backend group crunches dispatched windows while the
        # frontend group starts the next chunk
        flush_windows(final=False)

    flush_windows(final=True)

    fe = frontend_mod._assemble_result(
        outs, [T_all[i : i + step_frames]
               for i in range(0, F, step_frames)])
    db = TrackStore._finalize(fe, track_ids, next_track)

    # gather all BA futures (single blocking point) and assemble
    parts = []
    for p in pending:
        parts.append(tuple(np.asarray(x)[: p.real_B] for x in p.futures))
    batches = [p.batch for p in pending]
    merged = bundle_mod.BundleBatch(
        poses0=np.concatenate([b.poses0 for b in batches]),
        points0=np.concatenate([b.points0 for b in batches]),
        cam_idx=np.concatenate([b.cam_idx for b in batches]),
        lm_idx=np.concatenate([b.lm_idx for b in batches]),
        meas=np.concatenate([b.meas for b in batches]),
        w=np.concatenate([b.w for b in batches]),
        n_poses=np.concatenate([b.n_poses for b in batches]),
        frames=np.concatenate([b.frames for b in batches]),
        track_of_lm=np.concatenate([b.track_of_lm for b in batches]),
        keyframes=list(kfs_final),
    )
    fields = [np.concatenate([p[i] for p in parts]) for i in range(7)]
    poses, points, w2, cost, cost0, rel_T, rel_cov = fields
    bundles = bundle_mod._assemble_bundle_result(
        merged, poses, points, w2, cost, cost0, rel_T, rel_cov
    )
    return fe, db, bundles

