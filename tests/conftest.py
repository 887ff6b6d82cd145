def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device; the test skips itself when none is "
        "present (run on the card: python -m pytest -m cuda "
        "tests/test_torch_*_cuda.py)")
