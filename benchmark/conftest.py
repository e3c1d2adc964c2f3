"""pytest settings of the benchmark's own tests (``benchmark/tests``).

``card``: a test that needs an NVIDIA GPU.  It takes the ``card`` fixture,
which skips it where ``torch.cuda.is_available()`` is false; on the card
run them with ``python -m pytest benchmark/tests -m card``.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
