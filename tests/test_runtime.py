"""Entry-script plumbing: the compile-cache directory, the GPU check, and
chip_smoke.py's last line."""

import json
import os
from types import SimpleNamespace

import pytest

from mgf_tpu.utils import runtime


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.compile_cache_dir() == str(tmp_path)


def test_cache_dir_defaults_to_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = runtime.compile_cache_dir()
    assert d == os.path.join(runtime.REPO, ".jax_cache")
    assert os.path.exists(os.path.join(os.path.dirname(d), "chip_smoke.py"))


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()


def test_chip_smoke_last_line_keys():
    import chip_smoke
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line([dev])
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line
