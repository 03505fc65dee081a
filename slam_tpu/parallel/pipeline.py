"""Pipelined execution: overlap host IO, host<->device transfer, and device
compute.

The reference's stages run strictly sequentially (SURVEY.md §2.4 PP row:
stage caching in project.py:29-91 is sequential). Here the frontend is a
3-stage software pipeline:

  [native loader threads]  decode stereo chunk c+1     (runtime C++)
  [host->device]           transfer chunk c+1          (async device_put)
  [device]                 detect/match/RANSAC chunk c (jit, dispatched
                            asynchronously — JAX returns futures)

so PNG decode and transfer hide behind device compute. Multi-sequence runs
(BASELINE.json config #5) reuse the same compiled kernels across
sequences — compilation happens once for the whole batch.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SlamConfig
from ..models import frontend as frontend_mod


def run_frontend_pipelined(
    left_paths: list,
    right_paths: list,
    hw: tuple[int, int],
    calib,
    cfg: SlamConfig = SlamConfig(),
    n_io_threads: int = 3,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 500,
    resume: bool = False,
):
    """Frontend over on-disk PNG sequences with the native prefetcher.

    The streaming twin of models/frontend.run_frontend: same chunking, same
    position-based key stream, same incremental checkpoint format (so the
    two are resume-compatible), but images come from C++ decode threads that
    run ahead of device compute, and images smaller than ``hw`` are
    edge-replicate-padded to it (multi-resolution bucket semantics). Falls
    back to eager host decoding when the native runtime is unavailable.
    """
    from .. import runtime
    from ..models.frontend import (
        _convert_legacy_checkpoint, _save_checkpoint, _assemble_result,
        _frontend_fingerprint, _resume_from_checkpoint,
        recompute_descriptors,
    )

    F = len(left_paths)
    chunk = cfg.runtime.chunk_frames
    calib_j = jnp.asarray(calib, jnp.float32)
    # position-based keys, identical to models/frontend.run_frontend
    base_key = jax.random.PRNGKey(cfg.seed)
    native = runtime._load()

    def _decode_one(p) -> np.ndarray:
        if native:
            return runtime.load_png_gray_padded(p, hw)
        from ..utils.kitti import _imread_gray, pad_to_bucket

        img = _imread_gray(Path(p)).astype(np.float32) / 255.0
        return pad_to_bucket(img[None], hw)[0]

    def _decode_block(start, count):
        L = np.zeros((chunk, hw[0], hw[1]), np.float32)
        R = np.zeros((chunk, hw[0], hw[1]), np.float32)
        for i in range(count):
            L[i] = _decode_one(left_paths[start + i])
            R[i] = _decode_one(right_paths[start + i])
        return L, R

    def _recompute_desc(start, n):
        # restore descriptor chunks dropped from a checkpoint, straight
        # from the on-disk PNGs (keyframe gathers only — see
        # DescriptorBank). Resumed entries cover whole checkpoint
        # segments (n >> chunk), so split into chunk-sized blocks:
        # _decode_block's buffers are chunk-sized and every block then
        # reuses the single compiled shape.
        parts = []
        for s in range(start, start + n, chunk):
            m = min(chunk, start + n - s)
            L, _ = _decode_block(s, m)
            parts.append(recompute_descriptors(jnp.asarray(L), cfg)[:m])
        return parts[0] if len(parts) == 1 else jnp.concatenate(parts)

    outs: list = []
    desc_chunks: list = []  # (start, n, device array | host array | None)
    T_w2c_all: list = []
    carry = None
    T_carry = np.eye(4, dtype=np.float32)
    first_start, seg_idx = 0, 0
    legacy_ckpt = False
    fingerprint = _frontend_fingerprint(cfg)
    if resume and checkpoint_path and Path(checkpoint_path).exists():
        (outs, T_w2c_all, carry, T_carry, first_start, seg_idx,
         desc_chunks, legacy_ckpt) = _resume_from_checkpoint(
            checkpoint_path, fingerprint)
    if first_start >= F:  # checkpoint covers the whole sequence: pure load
        return _assemble_result(outs, T_w2c_all, desc_chunks, _recompute_desc)
    if legacy_ckpt:
        _convert_legacy_checkpoint(checkpoint_path, outs, T_w2c_all, carry,
                                   T_carry, first_start, fingerprint)

    if native:
        loader = runtime.StereoPrefetcher(
            [str(p) for p in left_paths[first_start:]],
            [str(p) for p in right_paths[first_start:]],
            hw[0], hw[1], chunk, n_io_threads,
        )
        blocks = iter(loader)
    else:  # pragma: no cover - exercised only without a toolchain
        def _eager():
            for s in range(first_start, F, chunk):
                n = min(chunk, F - s)
                L, R = _decode_block(s, n)
                yield L[:n], R[:n]

        blocks = _eager()

    seg_outs: list = []
    seg_T: list = []
    last_ckpt = first_start
    pending = None  # (out, start, n, carry_after) deferred one chunk

    def pad(x, n):
        if n == chunk:
            return x
        return np.concatenate(
            [x, np.zeros((chunk - n,) + x.shape[1:], x.dtype)]
        )

    def _materialize(out, start, n, carry_after):
        """Host readback of one chunk + chain stitch + checkpoint cadence.
        ``carry_after`` is the device carry as of this chunk's end — the
        checkpoint must snapshot that, not the (one-ahead) live carry."""
        nonlocal T_carry, last_ckpt, seg_idx, seg_outs, seg_T
        out = dict(out)
        # descriptors never cross to the host (DescriptorBank chunk)
        desc_chunks.append((start, n, out.pop("desc")[:n]))
        o = {k: np.asarray(v[:n]) for k, v in out.items()}
        T = o["T_chain"] @ T_carry[None]
        T_carry = T[-1]
        T_w2c_all.append(T)
        outs.append(o)
        seg_outs.append(o)
        seg_T.append(T)
        done = start + n
        if checkpoint_path and done - last_ckpt >= checkpoint_every:
            _save_checkpoint(checkpoint_path, seg_outs, seg_T, carry_after,
                             T_carry, done, seg_idx, fingerprint)
            last_ckpt = done
            seg_idx += 1
            seg_outs, seg_T = [], []

    for ci, (L, R) in enumerate(blocks):
        n = L.shape[0]
        start = first_start + ci * chunk
        Lj = jax.device_put(pad(L, n))
        Rj = jax.device_put(pad(R, n))
        sub = jax.random.fold_in(base_key, start // chunk)
        out, carry = frontend_mod.process_chunk(Lj, Rj, carry, calib_j, sub,
                                                cfg)
        # defer materialization by one chunk: the loader decodes the next
        # block while the device crunches this one
        if pending is not None:
            _materialize(*pending)
        pending = (out, start, n, carry)
    if pending is not None:
        _materialize(*pending)
    if checkpoint_path and seg_outs:
        _save_checkpoint(checkpoint_path, seg_outs, seg_T, carry, T_carry, F,
                         seg_idx, fingerprint)
    return _assemble_result(outs, T_w2c_all, desc_chunks, _recompute_desc)


def run_multi_sequence(
    sequences: dict,
    cfg: SlamConfig = SlamConfig(),
    run_loop_closure: bool = True,
    cache_root: str | Path | None = None,
    verbose: bool = False,
) -> dict:
    """Batched multi-sequence run (BASELINE.json config #5: KITTI
    00/02/05/08). ``sequences`` maps name -> (left (F,H,W), right, calib,
    T_gt or None). All sequences share one set of compiled kernels, so
    compilation amortizes across the batch — unlike the reference, which
    pays its full startup per sequence. KITTI resolutions differ across
    sequences (376x1241 vs 370x1226 ...); images are zero-padded
    bottom/right to one shared bucket (utils.kitti.bucket_for) so every
    sequence hits the same compiled frontend.

    Returns name -> evaluation report (and caches artifacts per sequence).
    """
    from .. import pipeline as pipeline_mod
    from ..utils import kitti as kitti_mod

    bucket = kitti_mod.bucket_for(
        [v[0].shape[1:] for v in sequences.values()]
    )
    reports = {}
    for name, (L, R, calib, T_gt) in sequences.items():
        L = kitti_mod.pad_to_bucket(L, bucket)
        R = kitti_mod.pad_to_bucket(R, bucket)
        cache = Path(cache_root) / name if cache_root else None
        res = pipeline_mod.run_pipeline(
            L, R, calib, cfg, cache_dir=cache,
            run_loop_closure=run_loop_closure, verbose=verbose,
        )
        if T_gt is not None:
            reports[name] = pipeline_mod.evaluate(res, np.asarray(T_gt))
        else:
            reports[name] = {"timings_s": res.timings,
                             "db_stats": res.db.stats(),
                             "num_closures": len(res.closures)}
    return reports
