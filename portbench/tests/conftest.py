"""The harness's CPU tests put the checkout and ``src`` on the path, as
``portbench/run.py`` does; tests marked ``cuda`` skip without a card (in a
fixture, never while a module is imported)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
