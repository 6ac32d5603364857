"""End-to-end block-detection parity vs the scipy oracle."""

import numpy as np
import pytest

from mustache_tpu.config import DetectionConfig
from mustache_tpu.detect import build_detector, finish_block
from mustache_tpu.normalize import normalize_sparse
from oracle import detect_block_oracle
from synthetic import synthetic_hic


def make_block(n=700, d_px=120, seed=11):
    x, y, v, anchors = synthetic_hic(n, d_px, seed=seed, n_loops=25)
    normalize_sparse(x, y, v, 5000, d_px, exact=True)
    c = np.zeros((n, n))
    c[x, y] = v
    return c, anchors


CFG = dict(resolution=5000, pt=0.2, st=0.88)


def run_engine(c, d_px, precision, pt=0.2, st=0.88):
    cfg = DetectionConfig(
        resolution=5000, distance_bp=d_px * 5000, pt=pt, st=st,
        precision=precision,
    )
    # distance_px must equal d_px for this test
    assert cfg.distance_px == d_px
    det = build_detector(cfg, c.shape[0])
    out = det.fn_single(c)
    import jax
    out = jax.tree.map(np.asarray, out)
    return finish_block(out, block_index=0, start=0, cfg=cfg, spec=det.spec)


def as_sets(rows, q_tol=1e-6):
    return {(int(r[0]), int(r[1])) for r in rows}


def test_block_matches_oracle_f64():
    c, _ = make_block()
    ref = detect_block_oracle(c.copy(), [1.6, 3.2], 120, 0.88, 0.2)
    got = run_engine(c, 120, "float64")
    assert len(ref) > 0, "oracle found no loops; synthetic data too weak"
    assert as_sets(got) == as_sets(ref)
    ref_map = {(r[0], r[1]): (r[2], r[3]) for r in ref}
    for r in got:
        q_ref, s_ref = ref_map[(r[0], r[1])]
        # the reference's `1 - expon.cdf(x)` cancels catastrophically for
        # tiny p (abs err ~1e-16 => rel err ~1e-16/p, amplified by n/rank in
        # BH); our log-space path is more accurate, so compare with an
        # absolute floor matching that intrinsic error.
        np.testing.assert_allclose(r[2], q_ref, rtol=1e-5, atol=1e-11)
        assert r[3] == s_ref
    # row order parity (component label order)
    assert [(r[0], r[1]) for r in got] == [(r[0], r[1]) for r in ref]


def test_block_matches_oracle_f32():
    c, _ = make_block(seed=12)
    ref = detect_block_oracle(c.copy(), [1.6, 3.2], 120, 0.88, 0.2)
    got = run_engine(c, 120, "float32")
    assert len(ref) > 0
    ref_set, got_set = as_sets(ref), as_sets(got)
    # float32 may flip razor-thin NMS ties; demand near-total agreement
    inter = len(ref_set & got_set)
    assert inter >= 0.95 * max(len(ref_set), len(got_set))
    ref_map = {(r[0], r[1]): r[2] for r in ref}
    for r in got:
        if (r[0], r[1]) in ref_map:
            np.testing.assert_allclose(r[2], ref_map[(r[0], r[1])], rtol=1e-3, atol=1e-7)


def test_small_nz_bails_out():
    cfg = DetectionConfig(resolution=5000, distance_bp=120 * 5000, precision="float64")
    c = np.zeros((700, 700))
    c[10, 20] = 1.0
    det = build_detector(cfg, 700)
    import jax
    out = jax.tree.map(np.asarray, det.fn_single(c))
    assert finish_block(out, block_index=0, start=0, cfg=cfg, spec=det.spec) == []


def test_insufficient_tested_bails_out():
    # enough nz to pass the 50 gate but fewer than 10000 -> []
    rng = np.random.default_rng(0)
    c = np.zeros((700, 700))
    xs = rng.integers(0, 500, 5000)
    ys = xs + rng.integers(5, 100, 5000)
    c[xs, ys] = rng.random(5000) + 0.5
    cfg = DetectionConfig(resolution=5000, distance_bp=120 * 5000, precision="float64")
    det = build_detector(cfg, 700)
    import jax
    out = jax.tree.map(np.asarray, det.fn_single(c))
    nz = int(out["nz_count"])
    assert 50 <= nz < 10000
    assert finish_block(out, block_index=0, start=0, cfg=cfg, spec=det.spec) == []


def _normalized_block(n, d_px, seed):
    x, y, v, _ = synthetic_hic(n, d_px, seed=seed, n_loops=8)
    normalize_sparse(x, y, v, 5000, d_px, work_dtype=np.float32)
    c = np.zeros((n, n), dtype=np.float32)
    c[x, y] = v
    return c


@pytest.mark.parametrize("n,d_px,octaves", [(256, 64, 2), (200, 40, 2),
                                            (256, 64, 3)])
def test_xla_detector_matches_oracle_f32_shapes(n, d_px, octaves):
    """The float32 XLA detector against the scipy oracle at the small,
    odd-sized and three-octave shapes: the f32 rule of
    test_block_matches_oracle_f32 (>= 95% anchor agreement, q rtol 1e-3)
    plus equal detection scales on the common anchors. The odd (200, 40)
    block holds fewer than 10000 testable pixels, so the reference bails
    out (mustache.py's FDR gate) and both sides must call nothing."""
    c = _normalized_block(n, d_px, seed=90)
    cfg = DetectionConfig(resolution=5000, distance_bp=d_px * 5000,
                          precision="float32", max_candidates=256,
                          octaves=octaves)
    det = build_detector(cfg, n)
    import jax
    out = jax.tree.map(np.asarray, det.fn_single(c))
    got = finish_block(out, block_index=0, start=0, cfg=cfg, spec=det.spec)
    ref = detect_block_oracle(c.astype(np.float64), list(cfg.octave_values),
                              d_px, cfg.st, cfg.pt)
    if n * d_px < 10000:
        assert int(out["n_tested"]) < cfg.min_tested
        assert ref == [] and got == []
        return
    assert len(ref) > 0
    rmap = {(r[0], r[1]): (r[2], r[3]) for r in ref}
    gmap = {(r[0], r[1]): (r[2], r[3]) for r in got}
    common = set(rmap) & set(gmap)
    assert len(common) >= 0.95 * max(len(rmap), len(gmap))
    for k in common:
        np.testing.assert_allclose(gmap[k][0], rmap[k][0], rtol=1e-3,
                                   atol=1e-7)
        assert gmap[k][1] == rmap[k][1]
