"""The benchmark's own tests (``python -m pytest portbench/tests``): the
files found by name, the yardstick, the reference against the program at
small sizes on the CPU, the faults that must fail the check, and the
imports. Tests marked ``requires_cuda`` run on the card only."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none (decided here, never
    at import: every worker must collect the same tests)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
