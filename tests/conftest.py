import collections

def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (hand-written kernels); skips without one")
