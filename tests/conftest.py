import os
import sys

import pytest

# Tests run on the CPU with 8 virtual devices (sharding validation
# without hardware) unless JAX_PLATFORMS says otherwise; the tests that
# need a card carry the `gpu` marker and run on it with
#   JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8").strip()
if "jax" in sys.modules:
    import jax
    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Persistent XLA compile cache (tpu_ffv1.cache: JAX_COMPILATION_CACHE_DIR
# or the repository's .jax_cache): the fused pipelines lower for minutes
# each on the CPU, so repeat suite runs hit the cache instead.  Opt out
# with FFV1_TEST_NO_CACHE=1.
if os.environ.get("FFV1_TEST_NO_CACHE", "0") in ("0", "false"):
    from tpu_ffv1.cache import enable_compile_cache
    enable_compile_cache(min_compile_secs=10)


@pytest.fixture
def gpu_device():
    """The first GPU, for tests marked `gpu`; skips where JAX has
    none."""
    import jax
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda,cpu python -m pytest "
                    "-m gpu tests/ on the card")
    return devs[0]
