"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh so sharding paths are exercised
without a GPU.  Tests marked ``gpu`` need the card and skip elsewhere; run
them on the GPU with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""
import os
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", str(ROOT / ".jax_cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import pytest

DATA = pathlib.Path(__file__).parent / "data"


@pytest.fixture
def gpu():
    """The first device, which must be a GPU; skips the test elsewhere."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; the default device is {dev.platform}")
    return dev


@pytest.fixture(scope="session")
def urls10k() -> bytes:
    return (DATA / "urls.10K").read_bytes()


@pytest.fixture(scope="session")
def urls10k_snappy() -> bytes:
    return (DATA / "urls.10K.snappy").read_bytes()


@pytest.fixture(scope="session")
def baddata3() -> bytes:
    return (DATA / "baddata3.snappy").read_bytes()


@pytest.fixture(scope="session")
def unaligned_bin() -> bytes:
    return (DATA / "unaligned_uint64_test.bin").read_bytes()


@pytest.fixture(scope="session")
def unaligned_snappy() -> bytes:
    return (DATA / "unaligned_uint64_test.snappy").read_bytes()
