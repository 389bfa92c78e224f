import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'card: needs a CUDA card; skips on a machine without one')


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present (decided here, at run
    time, never while the module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('no CUDA card: this test runs the benchmark on the card')
    return torch.cuda.get_device_name(0)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tmp_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setenv('TMPDIR', str(tmp_path))
    return tmp_path
