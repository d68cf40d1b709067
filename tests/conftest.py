"""Test configuration: run everything on a virtual 8-device CPU mesh.

Sharding correctness is validated on `--xla_force_host_platform_device_count=8`
CPU devices, the standard JAX pattern for testing pjit/shard_map layouts.
Tests marked `gpu` skip here; `chip_smoke.py` runs them on the card
(without this file, which would force the CPU).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

# NO persistent compilation cache here (the suite never calls
# dh3d_tpu.compile_cache): jaxlib 0.9.0's XLA:CPU hoists large embedded
# constants into executable-internal buffers, and a deserialized cache
# entry for such a program expects them as RUNTIME arguments — a cache hit
# on a big-model forward then crashes at execute time with "Execution
# supplied K buffers but compiled program expected N".


@pytest.fixture
def rng():
    return np.random.RandomState(0)
