"""The factor-path budget derived from the device, and the compile-cache rule."""
import os

import jax
import pytest

from storage_tpu import valuation
from storage_tpu.exceptions import StorageError
from storage_tpu.parallel.mesh import paths_mesh
from storage_tpu.utils import compile_cache


class FakeDevice:
    platform = "gpu"
    device_kind = "Fake GPU"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.fixture
def on_device(monkeypatch):
    monkeypatch.delenv("STORAGE_TPU_MAX_PATH_BYTES", raising=False)

    def use(device):
        monkeypatch.setattr(valuation, "_budget_device", lambda mesh=None: device)

    return use


def test_budget_is_fraction_of_device_limit(on_device):
    on_device(FakeDevice({"bytes_limit": 64_000_000_000, "peak_bytes_in_use": 0}))
    assert valuation.max_path_bytes() == 16_000_000_000


@pytest.mark.parametrize("stats", [{}, None, {"bytes_limit": 0}])
def test_accelerator_without_limit_is_an_error(on_device, stats):
    on_device(FakeDevice(stats))
    with pytest.raises(StorageError, match="STORAGE_TPU_MAX_PATH_BYTES"):
        valuation.max_path_bytes()


def test_cpu_budget_is_the_stated_constant(monkeypatch):
    monkeypatch.delenv("STORAGE_TPU_MAX_PATH_BYTES", raising=False)
    assert valuation.max_path_bytes() == int(valuation.CPU_PATH_BYTES)


def test_env_overrides_the_device(on_device, monkeypatch):
    on_device(FakeDevice({}))
    monkeypatch.setenv("STORAGE_TPU_MAX_PATH_BYTES", "1.5e9")
    assert valuation.max_path_bytes() == 1_500_000_000


def test_budget_device_is_the_mesh_device():
    devices = jax.devices()[2:4]
    assert valuation._budget_device(paths_mesh(devices)) == devices[0]


def test_budget_device_follows_default_device():
    assert valuation._budget_device() == jax.devices()[0]
    with jax.default_device(jax.devices()[3]):
        assert valuation._budget_device() == jax.devices()[3]


@pytest.fixture
def config_updates(monkeypatch):
    updates = []
    monkeypatch.setattr(compile_cache.jax.config, "update",
                        lambda name, value: updates.append((name, value)))
    return updates


def test_compile_cache_uses_env_dir_only(config_updates, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.use_compile_cache("elsewhere") == str(tmp_path)
    assert config_updates == [("jax_compilation_cache_dir", str(tmp_path))]


def test_compile_cache_default_is_fixed_and_absolute(config_updates, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = compile_cache.use_compile_cache(".jax_cache")
    second = compile_cache.use_compile_cache(".jax_cache")
    assert first == second == os.path.abspath(".jax_cache")
    assert str(os.getpid()) not in first
