"""Fixtures of the benchmark's own tests (run them with ``python -m pytest
port_bench/tests``; the ``gpu`` ones need the card)."""

from __future__ import annotations

import pytest
import torch


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
