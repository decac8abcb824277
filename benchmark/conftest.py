"""pytest settings of the benchmark's own tests (benchmark/tests/):
`python -m pytest benchmark/tests -q` from the repository's root.

The harness's modules are imported as `harness` and `reference` (run.py
puts benchmark/ on the path); the program from the repository's root.
Tests marked `chip` need an NVIDIA card and skip without one; the decision
is taken in the `card` fixture, never at import."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (HERE, os.path.dirname(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA card; skips where CUDA is absent")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available here)")
    return torch.cuda.get_device_name(0)


@pytest.fixture(scope="session")
def tiny_cache(tmp_path_factory):
    """One cache of the small test deployments for the whole session."""
    return str(tmp_path_factory.mktemp("bench_cache"))
