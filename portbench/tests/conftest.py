"""The harness's own tests (CPU; the tests marked `cuda` need the card:
`python3 -m pytest -m cuda portbench/tests` on it).  Nothing here is
collected by the repository's tests/ run."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cuda():
    """The card, or a skip where there is none (decided here, never at
    import, so every worker collects the same tests)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    return torch.device("cuda")
