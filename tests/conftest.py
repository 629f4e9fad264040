"""Test configuration: run JAX on the CPU with 8 virtual devices.

Sharding tests build meshes over the 8 virtual devices. A test that needs
a GPU carries the ``gpu`` marker and skips here; ``python chip_smoke.py``
runs the main path on the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long end-to-end/pipeline tests (second tier; "
        "run `pytest -m 'not slow'` for the fast tier, see README)",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; skips here (decide inside the test or a "
        "fixture, never at import), and a phase of chip_smoke.py covers it",
    )


@pytest.fixture
def rng():
    return np.random.default_rng(0)
