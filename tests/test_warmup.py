"""Warmup planning/compile-cache coverage.

The warmup promise: the set of shapes a genome run compiles is small and
enumerable from chromosome sizes alone (row bucketing + pow2 batches),
and warm() actually compiles exactly those jobs ahead of time.
"""

from mustache_tpu.config import DetectionConfig
from mustache_tpu.warmup import HG38_SIZES, plan_shapes, warm


def test_plan_shapes_collapses_genome():
    cfg = DetectionConfig(resolution=5000, distance_bp=2_000_000)
    n_bins = [length // 5000 + 1 for length in HG38_SIZES.values()]
    shapes, norm_keys = plan_shapes(cfg, n_bins)
    # 24 chromosomes collapse to a handful of compile jobs
    assert len(shapes) <= 16
    assert len(norm_keys) <= 16
    # every batch is a power of two, every rows value is on the ladder
    from mustache_tpu.bandnorm import bucket_rows
    for rows, _Dl, B in shapes:
        assert B & (B - 1) == 0
        assert bucket_rows(rows) == rows


def test_plan_shapes_same_bucket_one_job():
    cfg = DetectionConfig(resolution=5000, distance_bp=2_000_000)
    # two lengths in the same row bucket -> one detector shape, one norm key
    shapes, norm_keys = plan_shapes(cfg, [20000, 20100])
    assert len(shapes) == 1 and len(norm_keys) == 1


def test_warm_smoke():
    """warm() runs its compile jobs end-to-end (CPU backend)."""
    cfg = DetectionConfig(resolution=100_000, distance_bp=2_000_000)
    msgs = []
    jobs = warm(cfg, [500], log=msgs.append)
    # 3 normalize variants (f32/u16/u8) + 1 detector shape
    assert jobs == 4 and len(msgs) == 4


def test_warm_diff_uses_diff_batch_picker():
    """Warmup enumerates the batch size the run will use: the config's
    block_batch, checked against the differential detector's memory model
    for diff runs."""
    cfg = DetectionConfig(resolution=100_000, distance_bp=2_000_000)
    for c in (cfg, cfg.with_(block_batch=4)):
        shapes_s, _ = plan_shapes(c, [500])
        shapes_d, _ = plan_shapes(c, [500], diff=True)
        assert shapes_s[0][2] == shapes_d[0][2] == c.block_batch


def test_warm_diff_smoke():
    cfg = DetectionConfig(resolution=100_000, distance_bp=2_000_000)
    msgs = []
    jobs = warm(cfg, [500], diff=True, log=msgs.append)
    # 3 normalize variants + 1 single-map + 1 diff detector shape
    assert jobs == 5 and len(msgs) == 5
