"""Test configuration: run the suite on a virtual 8-device CPU mesh.

Tests use the CPU so that sharding logic can be validated on 8 virtual
devices.  Tests marked ``gpu`` need the card: they skip here, and run on
a machine with an NVIDIA GPU with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips where JAX has none")
