#!/usr/bin/env python3
"""Golden comparison harness: reference algorithm (scipy oracle) vs engine,
row for row, on ANY real input file.

The repo's largest standing validity risk is that every parity claim rests
on the scipy-oracle transcription plus synthetic data (the reference's
bundled chr21 `.RAWobserved` blob is stripped from this mount and there is
no egress). The moment real data appears — the reference's golden file,
any `.hic`/`.cool`/`.mcool`/text contact map — this tool makes the
comparison one command:

    python tools/golden_vs_reference.py -f data.hic -ch chr21 -r 5kb \
        -pt 0.1 -st 0.8

It ingests ONCE through the engine's readers, then runs BOTH pipelines on
the identical COO triplets:
  * oracle: tests/oracle.py — a labeled TEST-ONLY transcription of
    mustache.py:622-686 (normalize) + :697-850 (detect), block grid and
    ownership masks per :896-960, in float64;
  * engine: mustache_tpu.pipeline.detect_loops_coo at float64 precision
    (oracle-exact per tests/test_detect.py).
and diffs the calls: positions and scales must match exactly, q to 1e-5
relative (the reference computes `1 - expon.cdf` which cancels; the
engine's log-space q is more accurate — docs/PARITY.md row 8).

Exit 0 = row-for-row match, 1 = any discrepancy (listed, first 20).
To compare against an actual reference RUN instead (a TSV produced by the
original `mustache` CLI), pass --ref-tsv: the oracle stage is skipped and
the engine output is diffed against the file.
"""

import argparse
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

import numpy as np


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-f", dest="f_path", required=True)
    p.add_argument("-ch", dest="chromosome", required=True)
    p.add_argument("-ch2", dest="chromosome2", default="n")
    p.add_argument("-r", dest="resolution", default="5kb")
    p.add_argument("-b", dest="biasfile", default=False)
    p.add_argument("-norm", dest="norm_method", default=False)
    p.add_argument("-d", dest="distFilter", default=False)
    p.add_argument("-pt", dest="pt", type=float, default=0.2)
    p.add_argument("-st", dest="st", type=float, default=0.88)
    p.add_argument("-sz", dest="sigmaZero", type=float, default=1.6)
    p.add_argument("-oc", dest="octaves", type=int, default=2)
    p.add_argument("-bed", dest="bed", default="")
    p.add_argument("--ref-tsv", dest="ref_tsv", default=None,
                   help="diff engine output against a reference-CLI TSV "
                        "instead of running the oracle")
    p.add_argument("--rtol-q", type=float, default=1e-5)
    p.add_argument("--platform", default="cpu",
                   help="jax platform for the engine leg (default cpu: "
                        "the golden path is float64)")
    return p.parse_args(argv)


def run_oracle(x, y, v, cfg, d_px):
    from oracle import detect_block_oracle, normalize_sparse_oracle
    from mustache_tpu.config import block_mask_sizes, chunk_grid
    from mustache_tpu.pipeline import densify_block

    vv = v.astype(np.float64).copy()
    normalize_sparse_oracle(x, y, vv, cfg.resolution, d_px)
    n = int(max(x.max(), y.max())) + 1
    start, end = chunk_grid(n, cfg.chunk_size, d_px)
    masks = block_mask_sizes(start, end, d_px)
    rows = []
    for i in range(len(start)):
        cc = densify_block(x, y, vv, start[i], end[i], cfg.chunk_size)
        out = detect_block_oracle(cc, list(cfg.octave_values), d_px,
                                  cfg.st, cfg.pt, start=start[i])
        for r in out:
            if r[0] >= start[i] + masks[i] or r[1] >= start[i] + masks[i]:
                rows.append((int(r[0]), int(r[1]), float(r[2]), float(r[3])))
    return rows


def read_ref_tsv(path, res):
    rows = []
    with open(path) as fh:
        header = fh.readline()
        assert header.startswith("BIN1_CHR"), f"not a mustache TSV: {path}"
        for line in fh:
            p = line.rstrip("\n").split("\t")
            rows.append((int(p[1]) // res, int(p[4]) // res,
                         float(p[6]), float(p[7])))
    return rows


def diff_rows(ref, got, rtol_q, limit=20):
    rd = {(r[0], r[1]): r for r in ref}
    gd = {(g[0], g[1]): g for g in got}
    problems = []
    for k in sorted(set(rd) - set(gd)):
        problems.append(f"missing call at {k}: ref={rd[k]}")
    for k in sorted(set(gd) - set(rd)):
        problems.append(f"extra call at {k}: got={gd[k]}")
    for k in sorted(set(rd) & set(gd)):
        r, g = rd[k], gd[k]
        if abs(r[3] - g[3]) > 1e-9 * max(1.0, abs(r[3])):
            problems.append(f"scale mismatch at {k}: ref={r[3]} got={g[3]}")
        denom = max(abs(r[2]), 1e-300)
        if abs(r[2] - g[2]) / denom > rtol_q and abs(r[2] - g[2]) > 1e-12:
            problems.append(f"q mismatch at {k}: ref={r[2]} got={g[2]}")
    return problems[:limit], len(problems)


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    # the float64 golden path runs on --platform (default cpu), in x64
    import jax
    jax.config.update("jax_platforms", args.platform)
    jax.config.update("jax_enable_x64", True)
    from mustache_tpu.cli import load_contacts
    from mustache_tpu.config import (DetectionConfig, clamp_distance_filter,
                                     parse_bp)
    from mustache_tpu.pipeline import detect_loops_coo

    res = parse_bp(args.resolution)
    if not res:
        print("Error: Invalid resolution")
        return 2
    dist_bp = clamp_distance_filter(parse_bp(args.distFilter), res)
    t0 = time.time()
    x, y, v, res = load_contacts(
        args.f_path, args.norm_method, {}, dist_bp, args.chromosome,
        args.chromosome2 if args.chromosome2 != "n" else args.chromosome,
        res, args.biasfile, bed=args.bed)
    print(f"# ingest: {len(v)} contacts in {time.time() - t0:.1f}s")
    if len(v) == 0:
        print("no contacts — nothing to compare")
        return 2

    cfg = DetectionConfig(resolution=res, distance_bp=dist_bp, pt=args.pt,
                          st=args.st, sigma0=args.sigmaZero,
                          octaves=args.octaves, precision="float64")
    d_px = cfg.distance_px

    t0 = time.time()
    loops = detect_loops_coo(x, y, v.astype(np.float64).copy(), cfg,
                             exact_normalize=True)
    got = [(lp.bin1, lp.bin2, lp.q, lp.scale) for lp in loops]
    print(f"# engine: {len(got)} calls in {time.time() - t0:.1f}s")

    if args.ref_tsv:
        ref = read_ref_tsv(args.ref_tsv, res)
        print(f"# reference TSV: {len(ref)} calls")
    else:
        t0 = time.time()
        ref = run_oracle(x, y, v, cfg, d_px)
        print(f"# oracle: {len(ref)} calls in {time.time() - t0:.1f}s")

    problems, total = diff_rows(ref, got, args.rtol_q)
    if not total:
        print(f"MATCH: {len(got)} calls identical "
              f"(positions+scale exact, q rtol {args.rtol_q})")
        return 0
    print(f"MISMATCH: {total} problems (showing {len(problems)}):")
    for pr in problems:
        print("  " + pr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
