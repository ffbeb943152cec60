"""Process-level device setup (compile cache) and the published peaks
table the benchmark divides by."""

import os

import jax
import pytest

from wave_fenics_tpu.benchmarks.common import device_peaks
from wave_fenics_tpu.utils import device


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.enable_compile_cache() == str(tmp_path)
    assert calls == []  # JAX reads the variable itself; nothing else set


def test_compile_cache_defaults_to_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = device.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]


def test_peaks_known_device():
    pk = device_peaks("NVIDIA H100 80GB HBM3")
    assert pk["hbm_bytes_per_s"] == 3.35e12
    assert pk["fp32_flops_per_s"] == 67e12
    assert "data sheet" in pk["source"]


def test_peaks_unknown_device_raises():
    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks("cpu")
