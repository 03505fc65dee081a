"""Mesh construction and sharding helpers.

The reference is single-process/single-threaded (SURVEY.md §2.4: no DP/TP/
PP/SP and no communication backend). This framework's parallel axes are
designed from the problem structure instead:

  * ``frame`` axis — data parallelism over video frames: detection,
    description, stereo matching, temporal matching and RANSAC are
    independent per frame (pair); shards need zero collectives in
    the forward path (results are gathered once per chunk).
  * ``window`` axis — data parallelism over keyframe windows: every bundle
    adjustment window is an independent LM problem (the reference runs
    them sequentially, project.py:45-57).

Both axes map onto one flat device mesh; the same code runs on the GPUs
of one host or on the virtual CPU mesh used in CI (conftest forces
``--xla_force_host_platform_device_count=8``).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    """Flat 1-D mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def shard_leading(mesh: Mesh, axis: str = "dp"):
    """NamedSharding that splits the leading (batch) dim across the mesh."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0):
    """Pad the leading axis to a device-count multiple (returns array, n)."""
    n = x.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return x, n
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, target - n)
    return np.pad(x, pad_width), n
