import os

# Smoke tests and benches see the single real CPU device; ONLY
# launch/dryrun.py forces 512 host devices (and runs in its own process).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with CUDA; skipped without one")
