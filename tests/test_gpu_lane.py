"""On-card regression lane (``MTPU_GPU_TESTS=1 pytest tests -m gpu``).

The CPU suite runs the detection graphs on XLA's CPU backend; these tests
run the same graphs compiled for the GPU, so on-card parity rests on an
automated check instead of manual runs. Keep this lane SMALL: each test
compiles its own block shape.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu_backend():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("no GPU backend available")
    return jax


def test_pipeline_smoke_recovers_planted_anchors(gpu_backend):
    """End-to-end pipeline on the card: planted loops are recovered."""
    from mustache_tpu.config import DetectionConfig
    from mustache_tpu.pipeline import detect_loops_coo
    from synthetic import synthetic_hic

    x, y, v, anchors = synthetic_hic(1200, 150, seed=91, n_loops=25)
    cfg = DetectionConfig(resolution=5000, distance_bp=150 * 5000,
                          pt=0.1, st=0.8, precision="float32")
    loops = detect_loops_coo(x, y, v, cfg)
    assert len(loops) >= 15
    A = np.array(anchors)
    for lp in loops:
        d = np.abs(A - np.array([lp.bin1, lp.bin2])).max(axis=1).min()
        assert d <= 2, (lp.bin1, lp.bin2)


def test_diff_smoke_on_gpu(gpu_backend):
    """Differential path runs end to end on the card and calls loops."""
    from mustache_tpu.config import DetectionConfig
    from mustache_tpu.diff import detect_diff_loops_coo
    from synthetic import synthetic_hic

    x1, y1, v1, _ = synthetic_hic(1200, 150, seed=92, n_loops=20)
    x2, y2, v2, _ = synthetic_hic(1200, 150, seed=93, n_loops=20)
    cfg = DetectionConfig(resolution=5000, distance_bp=150 * 5000,
                          pt=0.2, st=0.8, precision="float32")
    rows = detect_diff_loops_coo(x1, y1, v1, x2, y2, v2, cfg)
    tags = {t for *_, t in rows}
    assert 1 in tags and 3 in tags
