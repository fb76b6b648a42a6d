"""Test set-up of the benchmark's own tests: the checkout's root on the
import path, the ``cuda`` marker, and no device-memory query on a CPU."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skipped where "
        "torch.cuda.is_available() is false)")


@pytest.fixture
def cpu_budget(monkeypatch):
    """A device budget for the program's planners on a CPU device."""
    from pyscf_mpcc_tpu_torch import config
    monkeypatch.setattr(config, "MAX_MEMORY", 2000)
