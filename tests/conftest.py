"""Test configuration: JAX on a virtual 8-device CPU mesh.

The suite runs on the host CPU, with multi-device sharding logic checked
on virtual CPU devices (JAX collectives behave the same over them). The
platform is forced through jax.config as well as JAX_PLATFORMS, before any
backend is initialized. Tests that need a GPU carry the `gpu` marker and
decide inside a fixture whether one exists; chip_smoke.py runs the same
checks on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from ssvio_tpu.utils.cache import enable_compile_cache  # noqa: E402

# the heavyweight jitted programs (chunk scan, multi-octave detection)
# dominate suite wall time on their first compile; the persistent cache
# makes re-runs cheap
enable_compile_cache(min_compile_secs=2.0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: decided when the test runs, never at
    import time (xdist workers must all collect the same tests)."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU; chip_smoke.py runs this check on the card")
    return devs[0]
