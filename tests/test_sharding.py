"""Sharded execution must be bit-identical to single-device execution."""

import numpy as np
import jax
import pytest

from mustache_tpu.config import DetectionConfig
from mustache_tpu.detect import build_detector
from mustache_tpu.pipeline import detect_loops_coo
from mustache_tpu.sharding import make_mesh, make_runner, shard_chromosomes
from synthetic import synthetic_hic


def test_mesh_shapes():
    mesh = make_mesh()
    assert mesh.shape["block"] * mesh.shape["row"] <= len(jax.devices())
    mesh = make_mesh(n_block=4, n_row=2)
    assert dict(mesh.shape) == {"block": 4, "row": 2}


@pytest.mark.parametrize("n_row", [1, 2])
def test_sharded_equals_unsharded(n_row):
    n, d_px = 256, 64
    cfg = DetectionConfig(resolution=5000, distance_bp=d_px * 5000,
                          precision="float32", max_candidates=256)
    det = build_detector(cfg, n)
    rng = np.random.default_rng(0)
    blocks = np.zeros((8, n, n), dtype=np.float32)
    for b in range(8):
        x, y, v, _ = synthetic_hic(n, d_px, seed=40 + b, n_loops=4)
        blocks[b][x, y] = v

    ref = jax.tree.map(np.asarray, det.fn(blocks))
    mesh = make_mesh(n_block=8 // n_row, n_row=n_row)
    got = jax.tree.map(np.asarray, make_runner(mesh)(det, blocks))

    if n_row == 1:
        # pure block-parallelism: bit-identical
        for k in ref:
            np.testing.assert_array_equal(ref[k], got[k], err_msg=k)
    else:
        # row sharding changes f32 reduction order (psum'd means, sharded
        # sort); demand identical detections and near-identical q values
        for b in range(ref["cand_x"].shape[0]):
            rset = {(int(x), int(y), int(s)) for x, y, s, ok in zip(
                ref["cand_x"][b], ref["cand_y"][b], ref["cand_sigidx"][b],
                ref["cand_valid"][b]) if ok}
            gset = {(int(x), int(y), int(s)) for x, y, s, ok in zip(
                got["cand_x"][b], got["cand_y"][b], got["cand_sigidx"][b],
                got["cand_valid"][b]) if ok}
            assert rset == gset
            rq = {(int(x), int(y)): float(q) for x, y, q, ok in zip(
                ref["cand_x"][b], ref["cand_y"][b], ref["cand_logq"][b],
                ref["cand_valid"][b]) if ok}
            for x, y, q, ok in zip(got["cand_x"][b], got["cand_y"][b],
                                   got["cand_logq"][b], got["cand_valid"][b]):
                if ok:
                    np.testing.assert_allclose(
                        float(q), rq[(int(x), int(y))], rtol=1e-4, atol=1e-5)


def test_runner_pads_partial_batches():
    n, d_px = 256, 64
    cfg = DetectionConfig(resolution=5000, distance_bp=d_px * 5000,
                          precision="float32", max_candidates=256)
    det = build_detector(cfg, n)
    blocks = np.zeros((3, n, n), dtype=np.float32)
    x, y, v, _ = synthetic_hic(n, d_px, seed=50, n_loops=4)
    for b in range(3):
        blocks[b][x, y] = v
    mesh = make_mesh(n_block=8, n_row=1)
    out = jax.tree.map(np.asarray, make_runner(mesh)(det, blocks))
    assert out["cand_x"].shape[0] == 3


def test_pipeline_with_sharded_runner_matches():
    d_px = 200
    x, y, v, _ = synthetic_hic(3000, d_px, seed=21, n_loops=60)
    cfg = DetectionConfig(resolution=5000, distance_bp=d_px * 5000,
                          precision="float32", block_batch=4)
    base = detect_loops_coo(x, y, v.copy(), cfg)
    # block-data-parallel mesh (row sharding at full block size is covered
    # at small N above; its GSPMD compile at N=2000 is minutes on CPU)
    mesh = make_mesh(n_block=8, n_row=1)
    shard = detect_loops_coo(x, y, v.copy(), cfg, runner=make_runner(mesh))
    assert [(l.bin1, l.bin2, l.scale) for l in base] == \
           [(l.bin1, l.bin2, l.scale) for l in shard]
    np.testing.assert_allclose([l.q for l in base], [l.q for l in shard],
                               rtol=1e-3)


def test_shard_chromosomes():
    chroms = [f"chr{i}" for i in range(1, 23)]
    parts = [shard_chromosomes(chroms, p, 4) for p in range(4)]
    assert sorted(sum(parts, [])) == sorted(chroms)
    assert all(abs(len(p) - len(chroms) / 4) <= 1 for p in parts)


def test_diff_pipeline_with_sharded_runner_matches():
    from mustache_tpu.diff import detect_diff_loops_coo

    d_px = 150
    x1, y1, v1, _ = synthetic_hic(2600, d_px, seed=73, n_loops=40)
    x2, y2, v2, _ = synthetic_hic(2600, d_px, seed=74, n_loops=40)
    cfg = DetectionConfig(resolution=5000, distance_bp=d_px * 5000,
                          precision="float32", block_batch=2)
    base = detect_diff_loops_coo(x1, y1, v1.copy(), x2, y2, v2.copy(), cfg)
    mesh = make_mesh(n_block=8, n_row=1)
    shard = detect_diff_loops_coo(x1, y1, v1.copy(), x2, y2, v2.copy(), cfg,
                                  runner=make_runner(mesh))
    assert [(a, b, s, t) for a, b, _, s, t in base] == \
           [(a, b, s, t) for a, b, _, s, t in shard]
    np.testing.assert_allclose([q for _, _, q, _, _ in base],
                               [q for _, _, q, _, _ in shard], rtol=1e-3)


def test_rowshard_pipeline_matches():
    """Row-sharded band placement: same loop calls as the default pipeline
    (host-vs-device normalize differ by f32 rounding only), and the
    per-chip slab is genuinely smaller than the full band."""
    from mustache_tpu.bandnorm import bucket_rows
    from mustache_tpu.runlog import RunLog

    d_px = 200
    n_bins = 9000                     # 5 blocks of 2000^2
    x, y, v, _ = synthetic_hic(n_bins, d_px, seed=91, n_loops=80)
    cfg = DetectionConfig(resolution=5000, distance_bp=d_px * 5000,
                          precision="float32", block_batch=2)
    base = detect_loops_coo(x, y, v.copy(), cfg)
    assert len(base) > 5

    mesh = make_mesh(n_block=4, n_row=1)
    runner = make_runner(mesh, band_placement="rowshard")
    log = RunLog(quiet=True)
    shard = detect_loops_coo(x, y, v.copy(), cfg, runner=runner, log=log)
    assert [(l.bin1, l.bin2, l.scale) for l in base] == \
           [(l.bin1, l.bin2, l.scale) for l in shard]
    # host-vs-device normalize differ by f32 rounding (~1e-3 rel on q)
    np.testing.assert_allclose([l.q for l in base], [l.q for l in shard],
                               rtol=5e-3)

    # slab < band: the memory/transfer win actually happened
    plan = runner.last_plan
    assert plan is not None
    assert plan.slab_rows < bucket_rows(n_bins)
    ev = [e for e in log.events if e["event"] == "rowshard_band"]
    assert ev and ev[0]["per_chip_mb"] < ev[0]["replicated_mb"] / 2


def test_rowshard_bit_identical_across_mesh_sizes():
    """The rowshard data path at 1, 2, 4, 8 chips is bit-identical to
    itself: slab contents equal the global band rows, pad slots drop, and
    the final block-order sort restores the reference output order."""
    d_px = 150
    x, y, v, _ = synthetic_hic(5200, d_px, seed=92, n_loops=50)
    cfg = DetectionConfig(resolution=5000, distance_bp=d_px * 5000,
                          precision="float32", block_batch=1)
    rows = None
    for nd in (1, 2, 4, 8):
        mesh = make_mesh(n_block=nd, n_row=1, devices=jax.devices()[:nd])
        runner = make_runner(mesh, band_placement="rowshard")
        got = detect_loops_coo(x, y, v.copy(), cfg, runner=runner)
        sig = [(l.bin1, l.bin2, l.q, l.scale) for l in got]
        if rows is None:
            rows = sig
            assert len(rows) > 3
        else:
            assert sig == rows, f"nd={nd} diverged"


def test_rowshard_regrow():
    """Candidate-table overflow reruns the block from the HOST band in
    rowshard mode (the device band is sharded); calls must match."""
    d_px = 120
    x, y, v, _ = synthetic_hic(2500, d_px, seed=93, n_loops=40,
                               loop_strength=6.0)
    big = DetectionConfig(resolution=5000, distance_bp=d_px * 5000,
                          precision="float32", max_candidates=4096)
    mesh = make_mesh(n_block=4, n_row=1)
    ref = detect_loops_coo(x, y, v.copy(), big,
                           runner=make_runner(mesh, "rowshard"))
    assert len(ref) > 5
    tiny = big.with_(max_candidates=16)
    got = detect_loops_coo(x, y, v.copy(), tiny,
                           runner=make_runner(mesh, "rowshard"))
    assert [(l.bin1, l.bin2, l.q, l.scale) for l in got] == \
           [(l.bin1, l.bin2, l.q, l.scale) for l in ref]


def test_diff_rowshard_matches_and_logs_bytes():
    """Differential rowshard: slab PAIR per chip, identical rows across
    1/2/4-chip meshes and vs the replicated runner; per-chip bytes logged
    (diff_mustache.py:630-651 shared-grid analog)."""
    from mustache_tpu.diff import detect_diff_loops_coo
    from mustache_tpu.runlog import RunLog

    d_px = 150
    x1, y1, v1, _ = synthetic_hic(5200, d_px, seed=75, n_loops=40)
    x2, y2, v2, _ = synthetic_hic(5200, d_px, seed=76, n_loops=40)
    cfg = DetectionConfig(resolution=5000, distance_bp=d_px * 5000,
                          precision="float32", block_batch=1)
    rows = None
    for nd in (1, 2, 4):
        mesh = make_mesh(n_block=nd, n_row=1, devices=jax.devices()[:nd])
        runner = make_runner(mesh, band_placement="rowshard")
        log = RunLog(quiet=True)
        got = detect_diff_loops_coo(x1, y1, v1.copy(), x2, y2, v2.copy(),
                                    cfg, runner=runner, log=log)
        if rows is None:
            rows = got
            assert len(rows) > 3
            assert {t for *_, t in rows} >= {1, 3}
        else:
            assert got == rows, f"nd={nd} diverged"
        ev = [e for e in log.events if e["event"] == "rowshard_band"]
        assert len(ev) == 2      # one slab stack per condition
        if nd > 1:
            assert ev[0]["per_chip_mb"] < ev[0]["replicated_mb"] / 2

    # replicated-runner cross-check: same calls, q to device-norm rounding
    mesh = make_mesh(n_block=4, n_row=1)
    rep = detect_diff_loops_coo(x1, y1, v1.copy(), x2, y2, v2.copy(), cfg,
                                runner=make_runner(mesh))
    assert [(a, b, s, t) for a, b, _, s, t in rows] == \
           [(a, b, s, t) for a, b, _, s, t in rep]
    np.testing.assert_allclose([q for _, _, q, _, _ in rows],
                               [q for _, _, q, _, _ in rep], rtol=5e-3)


def test_diff_rowshard_regrow():
    """Candidate-table overflow reruns the block from the HOST band pair
    in diff rowshard mode; calls must match the big-capacity run."""
    from mustache_tpu.diff import detect_diff_loops_coo

    d_px = 120
    x1, y1, v1, _ = synthetic_hic(2500, d_px, seed=77, n_loops=30,
                                  loop_strength=6.0)
    x2, y2, v2, _ = synthetic_hic(2500, d_px, seed=78, n_loops=30,
                                  loop_strength=6.0)
    big = DetectionConfig(resolution=5000, distance_bp=d_px * 5000,
                          precision="float32", max_candidates=4096)
    mesh = make_mesh(n_block=2, n_row=1, devices=jax.devices()[:2])
    ref = detect_diff_loops_coo(x1, y1, v1.copy(), x2, y2, v2.copy(), big,
                                runner=make_runner(mesh, "rowshard"))
    assert len(ref) > 3
    tiny = big.with_(max_candidates=16)
    got = detect_diff_loops_coo(x1, y1, v1.copy(), x2, y2, v2.copy(), tiny,
                                runner=make_runner(mesh, "rowshard"))
    assert got == ref
