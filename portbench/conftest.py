"""pytest settings of the benchmark's own tests (portbench/tests): the one
marker for tests that need a CUDA card.  Such a test decides inside
itself whether there is a card, and skips on the CPU."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips where there is none")
