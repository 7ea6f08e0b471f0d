import os

# tests must see the real (single) CPU device — only launch/dryrun.py asks
# for 512 fake devices
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (CUDA); skips without one")
