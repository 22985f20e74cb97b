"""The benchmark's tests: CPU tests at tiny sizes, and ``cuda`` tests that
need the card and skip here (each decides inside a fixture)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the H100 only")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
