import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GPU_RUN = "python -m pytest tests -m gpu"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", f"gpu: needs an NVIDIA GPU; run on the card with `{GPU_RUN}`")
    if config.option.markexpr == "gpu":
        return  # card tests: keep JAX's default (GPU) platform
    # Everything else runs on the CPU, with a virtual 8-device mesh so the
    # sharding tests run anywhere.
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX's backend is a GPU (decided here, at run time)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (run on the card: {GPU_RUN})")
