import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for path in (str(ROOT), str(ROOT / "src")):
    if path not in sys.path:
        sys.path.insert(0, path)


@pytest.fixture
def card():
    """Skips the test where no CUDA device is present (decided when the
    test runs, never at import)."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda")


def tiny(cell, n: int = 60):
    """A cell cut to ``n`` vertices for a CPU rehearsal."""
    cell.config["graph"]["num_vertices"] = n
    return cell


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the test run puts several workers on the
    machine, and small products gain nothing from more."""
    torch = pytest.importorskip("torch")
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
