def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card; the test skips itself when there is none",
    )
