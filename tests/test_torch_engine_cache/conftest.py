"""Builds the JAX package's native engine before any test module is
collected (tests/torch_engine_cache.py says why).

pytest loads the conftest.py of every test* directory under a directory
it is given (`pytest tests/`) at start-up, in the main process and in each
pytest-xdist worker, before collection; tests/conftest.py, which would be
the usual place, belongs to the JAX package's suite. This directory holds
no tests. The build only makes the library; it decides no test.
"""

from ..torch_engine_cache import prebuild_jax_engine


def pytest_configure(config):
    prebuild_jax_engine()
