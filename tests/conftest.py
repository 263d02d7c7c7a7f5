"""Test environment: the CPU backend with 8 virtual devices, so sharding and
collective paths run without a GPU (SURVEY.md section 4, test strategy item
(d)). Must run before any jax import.

Run the suite with `JAX_PLATFORMS=cpu python -m pytest tests/ -q`. The
persistent compilation cache is off here, so tests neither read nor write
`<repo>/.jax_cache`. What runs on the GPU is `python chip_smoke.py` (see
README.md), not these tests.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from weatherforecast_stgcn_maml_tpu.config import ModelConfig  # noqa: E402


@pytest.fixture(scope="session")
def tiny_model_cfg() -> ModelConfig:
    """A scaled-down architecture for fast tests."""
    return ModelConfig(
        hidden_channels=16,
        gcn_layers=2,
        lstm_hidden=8,
        lstm_layers=2,
        window=6,
        horizon=3,
        koppen_dim=4,
        gcn_dropout=0.1,
        lstm_dropout=0.1,
    )


@pytest.fixture(scope="session")
def tiny_region():
    from weatherforecast_stgcn_maml_tpu.data.synthetic import synthetic_region

    return synthetic_region(
        10.0, 11.0, 20.0, 21.0, num_timesteps=64, resolution=0.25, seed=3
    )


@pytest.fixture()
def rng():
    return np.random.default_rng(0)
