"""Test configuration: the suite runs on the CPU, with a virtual 8-device
CPU mesh for the sharding paths.

The sharding/pjit code paths are exercised on 8 virtual CPU devices (XLA
host-platform device count). The run keeps its compiled programs in a
private temporary cache (``JAX_COMPILATION_CACHE_DIR``), so XLA:CPU
entries built here never land in the checkout's cache, which a GPU host
may read. Tests that need the GPU carry the ``gpu`` marker and skip
without one; on a GPU host run them with ``pytest -m gpu`` (see README).
Must run before jax is imported anywhere.
"""

import os
import tempfile

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    os.environ["JAX_COMPILATION_CACHE_DIR"] = tempfile.mkdtemp(
        prefix="slam-tests-jax-cache-")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
