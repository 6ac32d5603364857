"""Process-level runtime rules: compile-cache location, device memory
caps, and the on-card smoke script's refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

from mustache_tpu import pipeline, runtime
from mustache_tpu.config import DetectionConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_honours_env_and_sets_nothing(monkeypatch, tmp_path):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_default_is_one_fixed_dir_in_checkout(monkeypatch):
    import jax

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = runtime.enable_compilation_cache()
        assert got == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
        assert runtime.enable_compilation_cache() == got   # stable
        with open(os.path.join(ROOT, ".gitignore")) as fh:
            assert ".jax_cache/" in fh.read().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


class _Dev:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("limit,precision,B,fits", [
    (60_000_000_000, "float32", 32, True),    # 32 * 0.72 GB <= 30 GB
    (60_000_000_000, "float32", 64, False),
    (8_000_000_000, "float64", 2, True),      # f64 blocks are twice as large
    (8_000_000_000, "float64", 4, False),
])
def test_block_batch_checked_against_device_limit(monkeypatch, limit,
                                                  precision, B, fits):
    """The batch's modelled bytes (45 [2000, 2000] planes per block) are
    held to half of a stubbed device's allocator limit."""
    import jax

    monkeypatch.setattr(jax, "local_devices",
                        lambda: [_Dev({"bytes_limit": limit})])
    cfg = DetectionConfig(precision=precision, block_batch=B)
    if fits:
        assert pipeline.block_batch(cfg, 2000, 45) == B
    else:
        with pytest.raises(ValueError, match="block_batch"):
            pipeline.block_batch(cfg, 2000, 45)


def test_block_batch_without_device_stats(monkeypatch):
    import jax

    monkeypatch.setattr(jax, "local_devices", lambda: [_Dev(None)])
    assert pipeline.device_bytes_limit() is None
    assert pipeline.block_batch(DetectionConfig(), 2000, 45) == 1
    assert pipeline.block_batch(DetectionConfig(block_batch=64), 4000,
                                135) == 64
    with pytest.raises(ValueError):
        pipeline.block_batch(DetectionConfig(block_batch=0), 2000, 45)


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu_backend():
    r = _run_smoke(ROOT, os.path.join(ROOT, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_bench_refuses_cpu_backend():
    r = _run_smoke(ROOT, os.path.join(ROOT, "bench.py"))
    assert r.returncode != 0
    assert '"metric"' not in r.stdout


def test_chip_smoke_refuses_without_repository(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run_smoke(tmp_path, str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
