"""Tests of the port's benchmark (``bench_port``), on the CPU at tiny
sizes; a test that needs the card is marked ``cuda`` and skips itself
inside a fixture when there is none."""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; the test skips itself when "
        "none is present")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the card")
    return torch.device("cuda")
