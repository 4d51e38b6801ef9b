"""Test configuration: run everything on a virtual 8-device CPU mesh.

The sharding tests need several devices; the CPU backend provides them
with ``xla_force_host_platform_device_count=8``. Tests that need a real
GPU are marked ``gpu`` and take the ``gpu_device`` fixture, which skips
them here: whether a card exists is decided inside the fixture, never at
import, so every pytest worker collects the same tests.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when jax has none."""
    import jax

    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs a GPU (run on the card: JAX_PLATFORMS=cuda,cpu "
                    "python -m pytest -m gpu tests/)")
    return gpus[0]
