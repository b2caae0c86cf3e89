"""Tests of the benchmark harness (CPU; card tests skip without one).

Run from the repository's root: python -m pytest portbench/tests -q
"""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where "
        "torch.cuda.is_available() is false")


@pytest.fixture(autouse=True)
def _keep_program_config():
    """A run sets the program's global configuration (its precision and
    device); each test leaves it as it found it."""
    from hypre_tpu_torch import get_config, set_config

    saved = get_config()
    yield
    set_config(saved)
