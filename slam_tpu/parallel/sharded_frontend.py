"""Mesh-sharded frontend: data-parallel frames across chips.

The frontend chunk (models/frontend.process_chunk) is almost perfectly
data-parallel over frames; the only cross-frame coupling is the shifted
"previous frame" arrays for temporal matching and the associative pose
scan — both expressed as array ops, so XLA inserts the boundary
ppermute/all-gather collectives automatically from the sharding
annotations. No hand-written communication.

The chunk carry (one frame's features, used to stitch chunk boundaries)
is replicated — it is a few MB and crosses chunks on host anyway.

Per-device cost is the single-chunk cost: n devices process n x the
frames per step at the same step latency (modulo the boundary
collectives, which move one frame's features per device).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SlamConfig
from ..models import frontend as frontend_mod


def frontend_training_step(mesh: Mesh, cfg: SlamConfig, calib,
                           axis: str = "dp", with_carry: bool = False):
    """Build the jitted frame-sharded frontend step.

    Returns fn(left (F,H,W), right (F,H,W), [carry,] key) ->
    (out pytree, carry), with the frame axis sharded across the mesh.
    F must be a multiple of the mesh size times nothing in particular —
    any F that XLA can split evenly (use chunk_frames * n_devices).
    """
    shard = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())
    calib_j = jnp.asarray(calib, jnp.float32)

    if with_carry:
        def step(left, right, carry, key):
            return frontend_mod.process_chunk(left, right, carry, calib_j,
                                              key, cfg)

        return jax.jit(
            step,
            in_shardings=(shard, shard, repl, repl),
            out_shardings=(shard, repl),
        )

    def step0(left, right, key):
        return frontend_mod.process_chunk(left, right, None, calib_j, key,
                                          cfg)

    return jax.jit(
        step0,
        in_shardings=(shard, shard, repl),
        out_shardings=(shard, repl),
    )


def run_frontend_sharded(
    images_left: np.ndarray,
    images_right: np.ndarray,
    calib,
    mesh: Mesh,
    cfg: SlamConfig = SlamConfig(),
) -> frontend_mod.FrontendResult:
    """Whole-sequence frontend over the mesh.

    Same host orchestration as models/frontend.run_frontend, but each
    device step covers ``chunk_frames * n_devices`` frames. Results are
    bitwise-comparable to the single-device path up to RANSAC key
    chunking (verified in tests/test_parallel.py).
    """
    n_dev = int(mesh.devices.size)
    F = images_left.shape[0]
    step_frames = cfg.runtime.chunk_frames * n_dev
    step_first = frontend_training_step(mesh, cfg, calib, with_carry=False)
    step_carry = frontend_training_step(mesh, cfg, calib, with_carry=True)
    base_key = jax.random.PRNGKey(cfg.seed)

    outs = []
    T_w2c_all = []
    T_carry = np.eye(4, dtype=np.float32)
    carry = None
    for start in range(0, F, step_frames):
        bl = images_left[start : start + step_frames]
        br = images_right[start : start + step_frames]
        n = bl.shape[0]
        if n < step_frames:
            pad = step_frames - n
            bl = np.concatenate([bl, np.zeros((pad,) + bl.shape[1:], bl.dtype)])
            br = np.concatenate([br, np.zeros((pad,) + br.shape[1:], br.dtype)])
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
        T_w2c_all.append(T)
        outs.append(out)

    return frontend_mod._assemble_result(outs, T_w2c_all)
