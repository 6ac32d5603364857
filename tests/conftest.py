"""Test harness config: virtual 8-device CPU mesh + float64 enabled.

Tests run on the CPU (f64 golden paths + virtual multi-device meshes):
the platform is pinned via jax.config before any backend is initialized.

GPU lane: ``MTPU_GPU_TESTS=1 pytest tests -m gpu`` keeps JAX's default
backend (the card) and runs only the ``@pytest.mark.gpu`` subset (pipeline
and differential smoke on the card). Without the env opt-in, gpu-marked
tests are skipped and everything else runs on the CPU harness.
"""

import os

import pytest

GPU_LANE = os.environ.get("MTPU_GPU_TESTS") == "1"

if GPU_LANE:
    from mustache_tpu.runtime import enable_compilation_cache

    enable_compilation_cache()
else:
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_ENABLE_X64"] = "true"

    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: runs on the GPU (MTPU_GPU_TESTS=1)")
    config.addinivalue_line(
        "markers", "smoke: seconds-fast pre-commit tier "
        "(pytest -m smoke, one test per subsystem, < 60 s total)")


# Seconds-fast pre-commit tier (`pytest -m smoke`, < 60 s total): one
# representative test per subsystem, defined centrally so the tier stays
# curated. Bare function name = every parametrization; name[param] = one.
SMOKE_TESTS = {
    "test_detect.py::test_block_matches_oracle_f32",
    "test_bh_count.py::test_count_matches_sort_full_surface[256-64-7]",
    "test_normalize.py::test_global_regime_matches_oracle",
    "test_bandnorm.py::test_device_band_matches_host[900-120-5000]",
    "test_cool.py::test_fetch_band_roundtrip",
    "test_hic.py::test_fetch_roundtrip[False-8]",
    "test_hicpro.py::test_hicpro_matches_text_triplets",
    "test_manifest.py::test_manifest_roundtrip",
    "test_kernels.py::test_blur_ladder_matches_scipy",
    "test_kernels.py::test_bh_logq_matches_statsmodels_formula[1000]",
    "test_diff.py::test_find_diff_loops_api",
    "test_config.py",
}


def _is_smoke(nodeid: str) -> bool:
    rel = nodeid.split("/")[-1]
    base = rel.split("[")[0]
    return rel in SMOKE_TESTS or base in SMOKE_TESTS \
        or base.split("::")[0] in SMOKE_TESTS


def pytest_collection_modifyitems(config, items):
    skip_cpu = pytest.mark.skip(
        reason="GPU lane active: only @pytest.mark.gpu tests run")
    skip_gpu = pytest.mark.skip(
        reason="needs MTPU_GPU_TESTS=1 on a GPU host")
    for item in items:
        if _is_smoke(item.nodeid):
            item.add_marker(pytest.mark.smoke)
        is_gpu = "gpu" in item.keywords
        if GPU_LANE and not is_gpu:
            item.add_marker(skip_cpu)
        elif not GPU_LANE and is_gpu:
            item.add_marker(skip_gpu)
