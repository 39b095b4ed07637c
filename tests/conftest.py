import warnings

warnings.filterwarnings("ignore")


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: slow tests (subprocess compiles)")
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")
