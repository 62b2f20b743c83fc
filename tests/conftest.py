import numpy as np
import pytest
import jax


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture()
def key():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (CUDA kernels); skipped "
        "without one")
