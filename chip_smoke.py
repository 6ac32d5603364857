#!/usr/bin/env python3
"""On-card smoke check: the loop caller's main path on a GPU, compared
with the scipy oracle (tests/oracle.py).

    python3 chip_smoke.py               # one GPU, every phase below
    python3 chip_smoke.py --four-cards  # four GPUs, the mesh path only

One card, in this order:

0. the GPU test lane (tests/test_gpu_lane.py) in a child process, before
   this process touches the card;
1. device check: platform, device kind, count, JAX version, the card's
   name and power limit, h5py and the native ingest library;
2. ``python -m mustache_tpu.warmup`` for chr21 alone, then the CLI run of
   phase 3; the new compile-cache entries of each are printed;
3. the CLI (``mustache_tpu.cli.main``) on a seeded chr21-scale 5kb text
   file, float32, against the oracle pipeline on every block;
4. the same run with ``--engine-precision float64``, row for row;
5. the 1kb Micro-C slice through ``detect_loops_coo`` against the oracle
   on its first 4000^2 block;
6. ``diff_cli.main`` on two chr21-scale conditions against the
   differential oracle on the first two blocks;
7. when h5py imports, the CLI on a chr12-scale ``.cool`` file against the
   pipeline on the same triplets.

The oracles run in spawned worker processes that never use the card,
while the card works. ``--four-cards`` runs the chr21 5kb CLI with
``--engine-mesh block`` and ``rowshard`` and the diff CLI with ``block``,
each against the ``--engine-mesh off`` single-card run.

Exits non-zero, with no result line, when the repository is missing, when
JAX finds no GPU, or when any phase fails. The last line of a passing run
is ``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.join(ROOT, "tests")
WORK = os.path.join(ROOT, ".smoke_work")

RES_5KB = 5000
RES_1KB = 1000
F32_OVERLAP = 0.95        # tests/test_detect.py::test_block_matches_oracle_f32
F32_RTOL, F32_ATOL = 1e-3, 1e-7
F64_RTOL, F64_ATOL = 1e-5, 1e-11   # tests/test_pipeline.py (float64)


def card_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints it."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def log(msg: str):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# oracle side (runs in spawned workers: scipy only, no device)
# ---------------------------------------------------------------------------

def _workload(kind: str, seed: int | None = None):
    sys.path[:0] = [ROOT, TESTS]
    import bench

    if kind == "chr21":
        return bench.build_workload(seed or bench.SEED_CHR21)
    if kind == "1kb":
        return bench.build_workload_1kb()
    if kind == "chr12":
        return bench.build_workload_chr12()
    raise ValueError(kind)


def _oracle_blocks(x, y, v, res, d_px, chunk, blocks, diff_with=None,
                   pt=0.1, st=0.8, pt2=0.1):
    """Oracle loop rows of ``blocks`` (all when None), ownership masks
    applied as in the pipeline. Single map: ``[x, y, q, sigma]`` rows;
    with ``diff_with=(x2, y2, v2)``: a list of four such groups."""
    import numpy as np
    from oracle import (detect_block_oracle, diff_detect_block_oracle,
                        normalize_sparse_oracle)

    from mustache_tpu.config import block_mask_sizes, chunk_grid

    def dense(xx, yy, vv, s, e):
        sel = (xx >= s) & (xx < e) & (yy >= s) & (yy < e)
        cc = np.zeros((chunk, chunk))
        cc[xx[sel] - s, yy[sel] - s] = vv[sel]
        return cc

    v = v.astype(np.float64).copy()
    normalize_sparse_oracle(x, y, v, res, d_px)
    if diff_with is not None:
        x2, y2, v2 = diff_with
        v2 = v2.astype(np.float64).copy()
        normalize_sparse_oracle(x2, y2, v2, res, d_px)
        n = int(max(x.max(), y.max(), x2.max(), y2.max())) + 1
    else:
        n = int(max(x.max(), y.max())) + 1
    start, end = chunk_grid(n, chunk, d_px)
    masks = block_mask_sizes(start, end, d_px)
    keep = lambda r, i: (r[0] >= start[i] + masks[i]
                         or r[1] >= start[i] + masks[i])
    idx = range(len(start)) if blocks is None else blocks
    if diff_with is None:
        out = []
        for i in idx:
            rows = detect_block_oracle(dense(x, y, v, start[i], end[i]),
                                       [1.6, 3.2], d_px, st, pt,
                                       start=start[i])
            out += [r for r in rows if keep(r, i)]
        return out
    groups = [[], [], [], []]
    for i in idx:
        got = diff_detect_block_oracle(
            dense(x, y, v, start[i], end[i]),
            dense(x2, y2, v2, start[i], end[i]),
            [1.6, 3.2], d_px, st, pt, pt2, start=start[i])
        for g, rows in zip(groups, got):
            g += [r for r in rows if keep(r, i)]
    return groups


def oracle_task(name: str):
    """One oracle job, regenerated from its seed inside the worker."""
    t0 = time.time()
    if name == "chr21":
        x, y, v = _workload("chr21")
        out = _oracle_blocks(x, y, v, RES_5KB, 400, 2000, None)
    elif name == "1kb":
        x, y, v = _workload("1kb")
        out = _oracle_blocks(x, y, v, RES_1KB, 2000, 4000, [0])
    elif name == "diff":
        import bench
        x, y, v = _workload("chr21", bench.SEED_CHR21)
        other = _workload("chr21", bench.SEED_CHR21_B)
        out = _oracle_blocks(x, y, v, RES_5KB, 400, 2000, [0, 1],
                             diff_with=other)
    else:
        raise ValueError(name)
    return out, time.time() - t0


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def compare_f32(tag, ref, got):
    """Anchor-pair overlap >= 95% of the larger set (the CPU f32 test's
    rule), equal scales and q within rtol 1e-3 / atol 1e-7 on the common
    pairs."""
    import numpy as np

    rmap = {(int(r[0]), int(r[1])): (float(r[2]), float(r[3])) for r in ref}
    gmap = {(int(r[0]), int(r[1])): (float(r[2]), float(r[3])) for r in got}
    common = set(rmap) & set(gmap)
    need = F32_OVERLAP * max(len(rmap), len(gmap))
    bad_scale = [k for k in common if rmap[k][1] != gmap[k][1]]
    q_ok = all(np.isclose(gmap[k][0], rmap[k][0], rtol=F32_RTOL,
                          atol=F32_ATOL) for k in common)
    ok = (len(rmap) > 0 and len(common) >= need and not bad_scale and q_ok)
    log(f"  compare {tag}: oracle {len(rmap)} engine {len(gmap)} common "
        f"{len(common)} (need >= {need:.1f}, overlap rule {F32_OVERLAP}); "
        f"scale mismatches {len(bad_scale)}; q rtol {F32_RTOL} atol "
        f"{F32_ATOL}: {'ok' if q_ok else 'FAIL'} -> "
        f"{'PASS' if ok else 'FAIL'}")
    return ok


def compare_rows_exact(tag, ref, got):
    """Row for row: same positions and scales in the same order, q within
    the float64 tolerance."""
    import numpy as np

    same = ([(int(r[0]), int(r[1]), float(r[3])) for r in ref]
            == [(int(r[0]), int(r[1]), float(r[3])) for r in got])
    q_ok = same and bool(np.allclose([r[2] for r in got],
                                     [r[2] for r in ref],
                                     rtol=F64_RTOL, atol=F64_ATOL))
    ok = len(ref) > 0 and same and q_ok
    log(f"  compare {tag}: oracle {len(ref)} engine {len(got)} rows; "
        f"positions+scales identical: {same}; q rtol {F64_RTOL} atol "
        f"{F64_ATOL}: {q_ok} -> {'PASS' if ok else 'FAIL'}")
    return ok


def read_loop_tsv(path, res):
    rows = []
    with open(path) as fh:
        next(fh)
        for line in fh:
            p = line.rstrip("\n").split("\t")
            rows.append([int(p[1]) // res, int(p[4]) // res, float(p[6]),
                         float(p[7])])
    return rows


def write_text_contacts(path, x, y, v, res, chrom="chr21"):
    import numpy as np

    with open(path, "w") as fh:
        fh.write("".join(
            f"{chrom}\t{a}\t{chrom}\t{b}\t{c!r}\n"
            for a, b, c in zip((x * res).tolist(), (y * res).tolist(),
                               np.asarray(v, np.float64).tolist())))


def cache_entries(cache_dir) -> int:
    try:
        return len(os.listdir(cache_dir))
    except OSError:
        return 0


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

class Phases:
    def __init__(self):
        self.failed: list[str] = []
        self.times: dict[str, float] = {}

    def run(self, name, fn, *args):
        log(f"[phase] {name}: start ({card_line()})")
        t0 = time.time()
        try:
            ok = fn(*args)
        except Exception as exc:   # recorded, the run then exits non-zero
            import traceback
            traceback.print_exc()
            log(f"  {name}: raised {type(exc).__name__}: {exc}")
            ok = False
        dt = time.time() - t0
        self.times[name] = dt
        if not ok:
            self.failed.append(name)
        log(f"[phase] {name}: {'PASS' if ok else 'FAIL'} in {dt:.2f} s "
            f"({card_line()})")
        return ok


def gpu_lane() -> bool:
    env = dict(os.environ, MTPU_GPU_TESTS="1")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-m", "gpu", "tests/test_gpu_lane.py"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    tail = (r.stdout + r.stderr).strip().splitlines()[-5:]
    for ln in tail:
        log("  lane: " + ln)
    return r.returncode == 0 and "2 passed" in r.stdout \
        and "skipped" not in r.stdout


def device_check(jax) -> bool:
    import importlib.util

    from mustache_tpu.io import native

    devs = jax.devices()
    log(f"  platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)} jax={jax.__version__}")
    log(f"  card: {card_line()}")
    have_h5py = importlib.util.find_spec("h5py") is not None
    log(f"  h5py importable: {have_h5py}")
    log("  ingest: " + ("native library (built from io/native/*.cpp)"
                        if native._load() is not None
                        else "pure-Python decoders (native build failed)"))
    return jax.default_backend() == "gpu"


def warm_then_cli(x, y, v, cache_dir, txt, out_tsv):
    from mustache_tpu import cli, warmup

    sizes = os.path.join(WORK, "chr21.sizes")
    with open(sizes, "w") as fh:
        fh.write(f"chr21\t{int(max(x.max(), y.max())) * RES_5KB}\n")
    n0 = cache_entries(cache_dir)
    rc_w = warmup.main(["-r", "5kb", "--sizes-file", sizes])
    n1 = cache_entries(cache_dir)
    log(f"  warmup rc={rc_w}: {n1 - n0} new cache entries in {cache_dir}")
    t0 = time.time()
    rc = cli.main(["-f", txt, "-ch", "21", "-r", "5kb", "-o", out_tsv,
                   "-pt", "0.1", "-st", "0.8"])
    n2 = cache_entries(cache_dir)
    log(f"  CLI chr21 5kb float32 rc={rc} in {time.time() - t0:.2f} s: "
        f"{n2 - n1} new cache entries")
    return rc_w == 0 and rc == 0


def cli_f32_vs_oracle(out_tsv, oracle):
    ref, dt = oracle["chr21"].get()
    log(f"  oracle chr21 (all blocks) took {dt:.1f} s in its worker")
    return compare_f32("chr21 5kb f32 CLI vs oracle", ref,
                       read_loop_tsv(out_tsv, RES_5KB))


def cli_f64(txt, out_tsv, oracle):
    from mustache_tpu import cli

    t0 = time.time()
    rc = cli.main(["-f", txt, "-ch", "21", "-r", "5kb", "-o", out_tsv,
                   "-pt", "0.1", "-st", "0.8",
                   "--engine-precision", "float64"])
    log(f"  CLI chr21 5kb float64 rc={rc} in {time.time() - t0:.2f} s")
    ref, _ = oracle["chr21"].get()
    return rc == 0 and compare_rows_exact(
        "chr21 5kb f64 CLI vs oracle", ref, read_loop_tsv(out_tsv, RES_5KB))


def slice_1kb(oracle):
    from mustache_tpu.config import DetectionConfig
    from mustache_tpu.pipeline import detect_loops_coo

    x, y, v = _workload("1kb")
    cfg = DetectionConfig(resolution=RES_1KB, distance_bp=2_000_000,
                          pt=0.1, st=0.8, precision="float32")
    for rep in range(2):
        t0 = time.time()
        loops = detect_loops_coo(x, y, v.copy(), cfg)
        log(f"  detect_loops_coo 1kb run {rep + 1}: {len(loops)} loops in "
            f"{time.time() - t0:.2f} s")
    # every loop with bin2 < 4000 comes from block 0 (block 1 starts at
    # 2000 and keeps only loops reaching past 4000)
    got = [[lp.bin1, lp.bin2, lp.q, lp.scale] for lp in loops
           if lp.bin2 < cfg.chunk_size]
    ref, dt = oracle["1kb"].get()
    log(f"  oracle 1kb (block 0) took {dt:.1f} s in its worker")
    return compare_f32("1kb block 0 vs oracle", ref, got)


def diff_cli_vs_oracle(x1, y1, v1, x2, y2, v2, oracle):
    from mustache_tpu import diff_cli

    f1 = os.path.join(WORK, "cond1.txt")
    f2 = os.path.join(WORK, "cond2.txt")
    write_text_contacts(f1, x1, y1, v1, RES_5KB)
    write_text_contacts(f2, x2, y2, v2, RES_5KB)
    prefix = os.path.join(WORK, "diff")
    t0 = time.time()
    rc = diff_cli.main(["-f1", f1, "-f2", f2, "-ch", "21", "-r", "5kb",
                        "-o", prefix, "-pt", "0.1", "-st", "0.8"])
    log(f"  diff CLI chr21 5kb rc={rc} in {time.time() - t0:.2f} s")
    groups, dt = oracle["diff"].get()
    log(f"  oracle diff (blocks 0-1) took {dt:.1f} s in its worker")
    ok = rc == 0
    # rows of blocks 0-1 are exactly those with bin2 < 3600 (block 2
    # starts at 3200 and keeps only rows reaching past 3600)
    for tag, sfx, ref in zip((1, 2, 3, 4),
                             (".loop1", ".diffloop1", ".loop2", ".diffloop2"),
                             groups):
        got = [r for r in read_loop_tsv(prefix + sfx, RES_5KB)
               if r[1] < 3600]
        if not ref and not got:
            log(f"  compare diff {sfx}: both empty")
            continue
        ok &= compare_f32(f"diff {sfx} blocks 0-1 vs oracle", ref, got)
    return ok and any(groups[0]) and any(groups[2])


def cool_leg():
    import numpy as np

    from mustache_tpu import cli
    from mustache_tpu.config import DetectionConfig
    from mustache_tpu.pipeline import detect_loops_coo
    from test_cool import build_cool

    x, y, v = _workload("chr12")
    path = os.path.join(WORK, "chr12.cool")
    build_cool(path, [("chr12", int(max(x.max(), y.max()) + 1) * RES_5KB)],
               RES_5KB, {"chr12": (x, y, v)})
    out = os.path.join(WORK, "chr12.tsv")
    t0 = time.time()
    rc = cli.main(["-f", path, "-ch", "chr12", "-r", "5kb", "-o", out,
                   "-pt", "0.1", "-st", "0.8"])
    log(f"  CLI .cool chr12 5kb rc={rc} in {time.time() - t0:.2f} s")
    cfg = DetectionConfig(resolution=RES_5KB, distance_bp=2_000_000,
                          pt=0.1, st=0.8, precision="float32")
    ref = [[lp.bin1, lp.bin2, lp.q, lp.scale]
           for lp in detect_loops_coo(x, y, v.astype(np.float64), cfg)]
    got = read_loop_tsv(out, RES_5KB)
    same = [r[:2] + r[3:] for r in ref] == [r[:2] + r[3:] for r in got]
    log(f"  compare .cool CLI vs pipeline on the same triplets: "
        f"{len(got)} vs {len(ref)} loops, identical positions+scales: "
        f"{same}")
    return rc == 0 and same and len(ref) > 0


def four_cards(x1, y1, v1, x2, y2, v2) -> bool:
    """Mesh placements on four cards against the single-card run."""
    from mustache_tpu import cli, diff_cli

    txt = os.path.join(WORK, "cond1.txt")
    txt2 = os.path.join(WORK, "cond2.txt")
    write_text_contacts(txt, x1, y1, v1, RES_5KB)
    write_text_contacts(txt2, x2, y2, v2, RES_5KB)
    base = ["-f", txt, "-ch", "21", "-r", "5kb", "-pt", "0.1", "-st", "0.8"]
    runs = {}
    for mesh in ("off", "block", "rowshard"):
        out = os.path.join(WORK, f"mesh_{mesh}.tsv")
        t0 = time.time()
        rc = cli.main(base + ["-o", out, "--engine-mesh", mesh])
        runs[mesh] = read_loop_tsv(out, RES_5KB) if rc == 0 else None
        log(f"  CLI --engine-mesh {mesh}: rc={rc} "
            f"{len(runs[mesh] or [])} loops in {time.time() - t0:.2f} s")
    ok = runs["off"] is not None and len(runs["off"]) > 0
    for mesh, rtol in (("block", 1e-3), ("rowshard", 5e-3)):
        ok &= _same_calls(f"single-map {mesh} vs off", runs["off"],
                          runs[mesh], rtol)
    dbase = ["-f1", txt, "-f2", txt2, "-ch", "21", "-r", "5kb",
             "-pt", "0.1", "-st", "0.8"]
    drun = {}
    for mesh in ("off", "block"):
        prefix = os.path.join(WORK, f"dmesh_{mesh}")
        t0 = time.time()
        rc = diff_cli.main(dbase + ["-o", prefix, "--engine-mesh", mesh])
        drun[mesh] = None if rc else [
            read_loop_tsv(prefix + s, RES_5KB)
            for s in (".loop1", ".diffloop1", ".loop2", ".diffloop2")]
        log(f"  diff CLI --engine-mesh {mesh}: rc={rc} in "
            f"{time.time() - t0:.2f} s")
    ok &= drun["off"] is not None and drun["block"] is not None
    if ok:
        for g, (a, b) in enumerate(zip(drun["off"], drun["block"])):
            ok &= _same_calls(f"diff group {g + 1} block vs off", a, b, 1e-3)
    return ok


def _same_calls(tag, ref, got, rtol):
    import numpy as np

    if ref is None or got is None:
        log(f"  {tag}: a run failed -> FAIL")
        return False
    same = [r[:2] + r[3:] for r in ref] == [r[:2] + r[3:] for r in got]
    q_ok = same and bool(np.allclose([r[2] for r in got],
                                     [r[2] for r in ref], rtol=rtol))
    log(f"  {tag}: {len(got)} vs {len(ref)} calls, identical positions+"
        f"scales: {same}, q rtol {rtol}: {q_ok} -> "
        f"{'PASS' if q_ok else 'FAIL'}")
    return q_ok


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh path (needs 4 GPUs)")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "mustache_tpu")) \
            or not os.path.isfile(os.path.join(TESTS, "oracle.py")):
        print("chip_smoke: the repository is not beside this script",
              file=sys.stderr)
        return 2
    try:
        log(f"card: {card_line()}")
    except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
        print(f"chip_smoke: no GPU found ({exc})", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, TESTS]
    os.makedirs(WORK, exist_ok=True)
    phases = Phases()

    # the lane's child process must have the card to itself: this
    # process imports JAX only after it ends
    if not args.four_cards:
        phases.run("gpu_lane", gpu_lane)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX backend is {jax.default_backend()!r}, "
              f"not 'gpu'", file=sys.stderr)
        return 2
    from mustache_tpu.runtime import enable_compilation_cache

    cache_dir = enable_compilation_cache()
    want = 4 if args.four_cards else 1
    if len(jax.devices()) < want:
        print(f"chip_smoke: need {want} GPUs, JAX sees "
              f"{len(jax.devices())}", file=sys.stderr)
        return 2
    phases.run("device_check", device_check, jax)

    import bench

    x1, y1, v1 = bench.build_workload(bench.SEED_CHR21)
    x2, y2, v2 = bench.build_workload(bench.SEED_CHR21_B)
    if args.four_cards:
        phases.run("four_cards", four_cards, x1, y1, v1, x2, y2, v2)
    else:
        import multiprocessing as mp

        # oracle workers start now and run on the host CPUs while the
        # card works; spawned children keep off the card
        saved = {k: os.environ.get(k)
                 for k in ("JAX_PLATFORMS", "CUDA_VISIBLE_DEVICES")}
        os.environ.update(JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
        pool = mp.get_context("spawn").Pool(3)
        for k, val in saved.items():
            if val is None:
                os.environ.pop(k)
            else:
                os.environ[k] = val
        try:
            oracle = {name: pool.apply_async(oracle_task, (name,))
                      for name in ("1kb", "chr21", "diff")}
            txt = os.path.join(WORK, "chr21.txt")
            write_text_contacts(txt, x1, y1, v1, RES_5KB)
            out32 = os.path.join(WORK, "chr21_f32.tsv")
            phases.run("warmup_then_cli", warm_then_cli, x1, y1, v1,
                       cache_dir, txt, out32)
            phases.run("cli_chr21_f32", cli_f32_vs_oracle, out32, oracle)
            phases.run("cli_chr21_f64", cli_f64, txt,
                       os.path.join(WORK, "chr21_f64.tsv"), oracle)
            phases.run("slice_1kb", slice_1kb, oracle)
            phases.run("diff_cli", diff_cli_vs_oracle, x1, y1, v1,
                       x2, y2, v2, oracle)
        finally:
            pool.terminate()
            pool.join()
        import importlib.util
        if importlib.util.find_spec("h5py") is not None:
            phases.run("cool_chr12", cool_leg)
        else:
            log("[phase] cool_chr12: not run (h5py is not installed; the "
                ".cool reader needs it)")

    log("phase times: " + ", ".join(f"{k}={v:.2f}s"
                                    for k, v in phases.times.items()))
    if phases.failed:
        print(f"chip_smoke: FAILED phases: {', '.join(phases.failed)}",
              file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    log(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
