"""The benchmark's tests: a ``card`` marker for those that need a CUDA
device (each decides in a fixture, never at import, and skips without
one)."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips on a machine without one")
