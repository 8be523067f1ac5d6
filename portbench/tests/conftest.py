"""The benchmark's own tests (run with `python -m pytest portbench/tests`).
Tests that need the card carry the `cuda` marker and skip, inside a
fixture, where there is none."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)
