"""Whole-chromosome pipeline parity vs an oracle pipeline (grid + dedup)."""

import numpy as np

from mustache_tpu.config import DetectionConfig, chunk_grid, block_mask_sizes
from mustache_tpu.pipeline import detect_loops_coo, densify_block
from oracle import detect_block_oracle, normalize_sparse_oracle
from synthetic import synthetic_hic


def oracle_pipeline(x, y, v, cfg: DetectionConfig):
    x = np.asarray(x); y = np.asarray(y); v = np.asarray(v, dtype=np.float64).copy()
    d_px = cfg.distance_px
    n = int(max(x.max(), y.max())) + 1
    normalize_sparse_oracle(x, y, v, cfg.resolution, d_px)
    start, end = chunk_grid(n, cfg.chunk_size, d_px)
    masks = block_mask_sizes(start, end, d_px)
    loops = []
    for i in range(len(start)):
        cc = densify_block(x, y, v, start[i], end[i], cfg.chunk_size)
        rows = detect_block_oracle(
            cc, list(cfg.octave_values), d_px, cfg.st, cfg.pt, start=start[i])
        for r in rows:
            if r[0] >= start[i] + masks[i] or r[1] >= start[i] + masks[i]:
                loops.append(r)
    return loops


def test_multiblock_pipeline_matches_oracle():
    d_px = 200
    x, y, v, anchors = synthetic_hic(3000, d_px, seed=21, n_loops=60)
    cfg = DetectionConfig(
        resolution=5000, distance_bp=d_px * 5000, precision="float64")
    assert cfg.chunk_size == 2000

    ref = oracle_pipeline(x, y, v.copy(), cfg)
    got = detect_loops_coo(x, y, v.copy(), cfg, exact_normalize=True)

    assert len(ref) > 0
    ref_set = {(int(r[0]), int(r[1])) for r in ref}
    got_set = {(lp.bin1, lp.bin2) for lp in got}
    assert got_set == ref_set
    ref_map = {(int(r[0]), int(r[1])): (r[2], r[3]) for r in ref}
    for lp in got:
        q_ref, s_ref = ref_map[(lp.bin1, lp.bin2)]
        np.testing.assert_allclose(lp.q, q_ref, rtol=1e-5, atol=1e-11)
        assert lp.scale == s_ref


def test_single_block_map():
    d_px = 120
    x, y, v, _ = synthetic_hic(900, d_px, seed=22, n_loops=20)
    cfg = DetectionConfig(
        resolution=5000, distance_bp=d_px * 5000, precision="float64")
    ref = oracle_pipeline(x, y, v.copy(), cfg)
    got = detect_loops_coo(x, y, v.copy(), cfg, exact_normalize=True)
    assert {(lp.bin1, lp.bin2) for lp in got} == {(int(r[0]), int(r[1])) for r in ref}


def test_empty_input():
    cfg = DetectionConfig(resolution=5000, distance_bp=600_000)
    assert detect_loops_coo(
        np.array([], np.int64), np.array([], np.int64), np.array([]), cfg) == []


def test_u16_band_transfer_parity():
    """Integer-count maps travel as a uint16 raw band (half the H2D bytes);
    the on-device f32 widening is lossless so loop calls must be identical
    to the f32-band transfer (pipeline.fill_raw_band)."""
    import mustache_tpu.pipeline as P
    from mustache_tpu.io import native

    d_px = 200
    x, y, v, _ = synthetic_hic(2500, d_px, seed=33, n_loops=40)
    v = np.floor(np.abs(v)) + 1.0          # raw-count-shaped values
    cfg = DetectionConfig(resolution=5000, distance_bp=d_px * 5000,
                          pt=0.1, st=0.8, precision="float32")

    band = P.fill_raw_band(x, y, v, (2500, 256))
    assert band.dtype == np.uint16         # the compact path engaged

    got_u16 = detect_loops_coo(x, y, v.copy(), cfg)

    def f32_only(x, y, v, shape):
        band = np.zeros(shape, np.float32)
        if not native.fill_band(x, y, v, band):
            sel = (y - x >= 0) & ((y - x) < band.shape[1])
            band[x[sel], (y - x)[sel]] = v[sel]
        return band

    orig = P.fill_raw_band
    P.fill_raw_band = f32_only
    try:
        got_f32 = detect_loops_coo(x, y, v.copy(), cfg)
    finally:
        P.fill_raw_band = orig
    assert len(got_u16) > 0
    assert got_u16 == got_f32


def test_u16_band_gate():
    """Non-integer, negative, or >= 2^16 values must keep the f32 band."""
    import mustache_tpu.pipeline as P

    x = np.array([0, 1], np.int64)
    y = np.array([5, 6], np.int64)
    for bad in ([1.5, 2.0], [-1.0, 2.0], [70000.0, 2.0]):
        band = P.fill_raw_band(x, y, np.array(bad, np.float64), (10, 128))
        assert band.dtype == np.float32
        assert band[0, 5] == np.float32(bad[0])
    band = P.fill_raw_band(x, y, np.array([3.0, 65535.0], np.float64),
                           (10, 128))
    assert band.dtype == np.uint16
    assert band[1, 5] == 65535


def test_fn_band_pad_slots_match_unpadded_launch():
    """Batch slots with start -1 (power-of-two padding) are computed and
    discarded; the valid slots of a padded launch equal an unpadded
    launch's outputs."""
    import jax

    from mustache_tpu.bandnorm import bucket_rows
    from mustache_tpu.detect import band_width, build_detector
    from mustache_tpu.normalize import normalize_sparse

    n, d_px, n_bins = 256, 64, 320
    cfg = DetectionConfig(resolution=5000, distance_bp=d_px * 5000,
                          precision="float32", max_candidates=256)
    x, y, v, _ = synthetic_hic(n_bins, d_px, seed=97, n_loops=8)
    normalize_sparse(x, y, v, 5000, d_px, work_dtype=np.float32)
    band = np.zeros((bucket_rows(max(n_bins, n)), band_width(n, d_px)),
                    np.float32)
    sel = (y - x) < band.shape[1]
    band[x[sel], (y - x)[sel]] = v[sel]
    det = build_detector(cfg, n)
    ref = jax.tree.map(np.asarray,
                       det.fn_band(band, np.asarray([0, 64], np.int32)))
    got = jax.tree.map(np.asarray,
                       det.fn_band(band, np.asarray([0, 64, -1, -1],
                                                    np.int32)))
    assert int(ref["n_tested"][0]) > 0
    for k in ref:
        np.testing.assert_array_equal(ref[k], got[k][:2], err_msg=k)
