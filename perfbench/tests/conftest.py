"""The benchmark's own tests: its harness on the CPU at small sizes, and
the tests marked ``card``, which need a CUDA device (they skip without
one; on the card: ``python -m pytest -m card perfbench/tests``)."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (BENCH, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the suite runs several workers at once,
    and the small products here lose far more to oversubscribed threads
    than they gain."""
    import torch
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def card():
    """Skip the test where no CUDA device is present."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
