import os
import sys
from pathlib import Path

# NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see the
# single real CPU device; only the dry-run (and subprocess sharding tests)
# force 512/8 host devices.
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

from repro.models.common import Runtime  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture(scope="session")
def rt32():
    """fp32 runtime with small chunks for reduced-config tests."""
    return Runtime(param_dtype=jnp.float32, compute_dtype=jnp.float32,
                   ce_chunk=16, ssm_chunk=8, attn_q_chunk=8,
                   attn_dense_threshold=4096)
