"""gsbench's own tests: CPU tests at tiny sizes (``python -m pytest
gsbench/tests``) and card tests marked ``cuda``, which skip inside the
test where there is no card."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips (inside the test) "
                            "without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
