"""The benchmark's own tests: ``python -m pytest perfbench/tests -q`` from
the repository's root (those marked ``cuda`` run on the card only:
``python -m pytest perfbench/tests -q -m cuda``)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cuda_device():
    """The card; the test skips where there is none (decided here, in the
    test, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
