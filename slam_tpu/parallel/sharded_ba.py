"""Mesh-sharded bundle adjustment and frontend steps.

The multi-chip execution model (SURVEY.md §2.4 parallelism plan):
all ~430 keyframe windows of a sequence are one padded batch, sharded over
the ``window`` mesh axis; each device LM-optimizes its shard of windows
with the identical compiled kernel (ops/ba.py). The only cross-device data
movement is the final gather of relative poses/covariances — pure DP whose
collectives XLA inserts from the sharding annotations.

``ba_training_step`` is the framework's "training step" analogue: one
jitted function that takes the sharded window batch and returns optimized
poses, relative transforms and covariances. ``frontend_step_sharded``
shards the image-batch axis the same way.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import ba
from . import mesh as mesh_lib


def ba_training_step(mesh: Mesh, calib, iters: int = 20, axis: str = "dp",
                     min_depth: float = 0.1, max_depth: float = 1000.0,
                     huber_delta: float = 0.0):
    """Build the jitted, mesh-sharded batched-BA step.

    Returns fn(poses0, points0, cam_idx, lm_idx, meas, w) ->
    (poses, points, w, cost, cost0, rel_T, rel_cov) with all leading
    (window) axes sharded over the mesh. Solver knobs (depth pruning,
    Huber) are threaded identically to the single-device path
    (models/bundle.optimize_windows).
    """
    shard = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())

    def step(poses0, points0, cam_idx, lm_idx, meas, w, n_poses, calib):
        cost0 = jax.vmap(
            lambda p0, x0, ci, li, ms, ww: ba._cost(p0, x0, ci, li, ms, ww,
                                                    calib)
        )(poses0, points0, cam_idx, lm_idx, meas, w)
        poses, points, w2, cost = jax.vmap(
            lambda p0, x0, ci, li, ms, ww: ba.optimize_bundle_pruned(
                p0, x0, ci, li, ms, ww, calib, iters=iters,
                min_depth=min_depth, max_depth=max_depth,
                huber_delta=huber_delta,
            )
        )(poses0, points0, cam_idx, lm_idx, meas, w)
        covs = jax.vmap(
            lambda p, x, ci, li, ms, ww: ba.pose_covariances(
                p, x, ci, li, ms, ww, calib
            )
        )(poses, points, cam_idx, lm_idx, meas, w2)
        last = jnp.maximum(n_poses - 1, 0)
        B = poses.shape[0]
        rel_T = poses[jnp.arange(B), last]
        rel_cov = covs[jnp.arange(B), last]
        return poses, points, w2, cost, cost0, rel_T, rel_cov

    jitted = jax.jit(
        step,
        in_shardings=(shard, shard, shard, shard, shard, shard, shard, repl),
        out_shardings=(shard, shard, shard, shard, shard, shard, shard),
        static_argnums=(),
    )
    calib_j = jnp.asarray(calib, jnp.float32)

    def run(poses0, points0, cam_idx, lm_idx, meas, w, n_poses):
        return jitted(poses0, points0, cam_idx, lm_idx, meas, w, n_poses,
                      calib_j)

    return run


def optimize_windows_sharded(batch, calib, mesh: Mesh, iters: int = 20,
                             min_depth: float = 0.1,
                             max_depth: float = 1000.0,
                             huber_delta: float = 0.0):
    """Shard a BundleBatch over the mesh and run one batched-BA step.

    Host-side companion of models/bundle.optimize_windows for multi-chip
    runs: pads the window axis to a device multiple, places shards, runs,
    gathers.
    """
    n_dev = mesh.devices.size
    arrs = {}
    for name in ("poses0", "points0", "cam_idx", "lm_idx", "meas", "w"):
        arrs[name], B = mesh_lib.pad_to_multiple(getattr(batch, name), n_dev)
    n_poses, _ = mesh_lib.pad_to_multiple(
        np.maximum(batch.n_poses, 1).astype(np.int32), n_dev
    )
    step = ba_training_step(mesh, calib, iters=iters, min_depth=min_depth,
                            max_depth=max_depth, huber_delta=huber_delta)
    poses, points, w2, cost, cost0, rel_T, rel_cov = step(
        arrs["poses0"], arrs["points0"], arrs["cam_idx"], arrs["lm_idx"],
        arrs["meas"], arrs["w"], n_poses,
    )
    out = tuple(np.asarray(x)[:B] for x in (poses, points, w2, cost, cost0,
                                            rel_T, rel_cov))
    return out
