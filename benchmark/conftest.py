"""Settings of the benchmark's own tests (``python -m pytest benchmark``).

Tests that need a CUDA card carry the ``card`` marker and take the ``card``
fixture, which decides when the test runs, not when the module is
imported, and skips on a machine without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")
    import torch

    # Several workers share the host: a few threads each, not all of them.
    torch.set_num_threads(2)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
