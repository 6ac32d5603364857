"""Ahead-of-time compile-cache warming.

Cold compiles of the detection ladder take seconds per shape, and a
genome-wide run touches several distinct shapes. The persistent
compilation cache (:func:`mustache_tpu.runtime.enable_compilation_cache`) makes every LATER
process load each shape in about a second — but the first run of each
shape still pays full price, in the middle of the user's run.

This module moves that price ahead of time: because band rows ride a
geometric bucket ladder (:func:`mustache_tpu.bandnorm.bucket_rows`) and
a run uses one batch size (``DetectionConfig.block_batch``), the complete
set of shapes a run will compile is ENUMERABLE from chromosome sizes
alone. ``warm()`` AOT-compiles them (``jit.lower().compile()``) into the
persistent cache so the real run is all cache hits.

Usage::

    python -m mustache_tpu.warmup -r 5kb            # hg38 sizes, detector
    python -m mustache_tpu.warmup -r 1kb --diff     # + differential
    python -m mustache_tpu.warmup -r 5kb --sizes-file my.chrom.sizes

Run it once per (resolution, distance, octaves) configuration — at
install time, in the background, or before the first production run.
Every HEAVY graph is covered: the exception-list scatter lives in its
own trivial per-bucket graph (bandnorm._build_exc_fn, sub-second
compiles), so the only on-demand compiles left are that scatter and
candidate-overflow regrow capacities.
"""

from __future__ import annotations

import sys
import time

# hg38 primary-assembly chromosome lengths (bp) — the default workload
HG38_SIZES = {
    "chr1": 248956422, "chr2": 242193529, "chr3": 198295559,
    "chr4": 190214555, "chr5": 181538259, "chr6": 170805979,
    "chr7": 159345973, "chr8": 145138636, "chr9": 138394717,
    "chr10": 133797422, "chr11": 135086622, "chr12": 133275309,
    "chr13": 114364328, "chr14": 107043718, "chr15": 101991189,
    "chr16": 90338345, "chr17": 83257441, "chr18": 80373285,
    "chr19": 58617616, "chr20": 64444167, "chr21": 46709983,
    "chr22": 50818468, "chrX": 156040895, "chrY": 57227415,
}


def plan_shapes(cfg, n_bins_list, diff: bool = False):
    """The distinct compile jobs a run over chromosomes of ``n_bins_list``
    bins would trigger: ``(detector (rows, Dl, B) shapes, normalize
    keys)`` — both small sets thanks to row bucketing and one batch size
    per run. ``diff`` applies the differential detector's memory model to
    the batch check."""
    from mustache_tpu.bandnorm import _norm_key, bucket_rows
    from mustache_tpu.detect import band_width
    from mustache_tpu.pipeline import block_batch

    width = cfg.chunk_size
    d_px = cfg.distance_px
    Dl = band_width(width, d_px)
    B = block_batch(cfg, width, 135 if diff else 45)
    shapes, norm_keys = set(), set()
    for n in n_bins_list:
        rows = bucket_rows(max(n, width))
        shapes.add((rows, Dl, B))
        norm_keys.add(_norm_key(rows, Dl, n, cfg.resolution, d_px))
    return sorted(shapes), sorted(norm_keys, key=repr)


def warm(cfg, n_bins_list, *, diff: bool = False, log=None):
    """AOT-compile every shape a run over the given chromosome bin counts
    would touch. Returns the number of compile jobs executed."""
    import jax
    import jax.numpy as jnp

    from mustache_tpu.bandnorm import _build_norm_fn
    from mustache_tpu.detect import build_detector

    log = log or (lambda msg: None)
    shapes, norm_keys = plan_shapes(cfg, n_bins_list)
    dtype = jnp.float64 if cfg.precision == "float64" else jnp.float32
    jobs = 0

    if cfg.precision != "float64":
        # the f32 fast path normalizes on device; warm the f32 band and
        # both compact-transfer widths (pure-integer data; exception-list
        # variants are data-dependent and stay on-demand)
        for key in norm_keys:
            rows, Dl = key[1], key[2]
            for dt, donate in ((jnp.float32, True), (jnp.uint16, False),
                               (jnp.uint8, False)):
                t0 = time.time()
                fn = _build_norm_fn(key, donate)
                fn.lower(jax.ShapeDtypeStruct((rows, Dl), dt)).compile()
                jobs += 1
                log(f"normalize rows={rows} Dl={Dl} {dt.__name__}: "
                    f"{time.time() - t0:.1f}s")

    det_jobs = [(build_detector(cfg, cfg.chunk_size), shapes, 1)]
    if diff:
        from mustache_tpu.diff import build_diff_detector
        # the differential batch picker has its own memory cap, so its
        # (rows, Dl, B) shape set can differ from the single-map one
        det_jobs.append((build_diff_detector(cfg, cfg.chunk_size),
                         plan_shapes(cfg, n_bins_list, diff=True)[0], 2))
    scalar = jax.ShapeDtypeStruct((), dtype)
    for det, det_shapes, nbands in det_jobs:
        for rows, Dl, B in det_shapes:
            band = jax.ShapeDtypeStruct((rows, Dl), dtype)
            starts = jax.ShapeDtypeStruct((B,), jnp.int32)
            t0 = time.time()
            det._fn_band_packed.lower(
                *([band] * nbands), starts, scalar, scalar).compile()
            jobs += 1
            log(f"{'diff ' if nbands == 2 else ''}detector rows={rows} "
                f"B={B}: {time.time() - t0:.1f}s")
    return jobs


def main(argv=None):
    import argparse

    from mustache_tpu.config import DetectionConfig, parse_bp
    from mustache_tpu.runtime import enable_compilation_cache

    ap = argparse.ArgumentParser(
        prog="mustache_tpu.warmup",
        description="Pre-compile the detection graphs for a genome run "
                    "into the persistent XLA cache.")
    ap.add_argument("-r", "--resolution", required=True,
                    help="resolution (e.g. 5kb, 1000)")
    ap.add_argument("-d", "--distance", default="2Mb",
                    help="max loop distance (default 2Mb)")
    ap.add_argument("--sizes-file", default=None,
                    help="2-column <name> <length_bp> file; default: hg38")
    ap.add_argument("--diff", action="store_true",
                    help="also warm the differential detector")
    ap.add_argument("--octaves", type=int, default=2)
    args = ap.parse_args(argv)

    res = parse_bp(args.resolution)
    dist = parse_bp(args.distance)
    if not res or not dist:
        ap.error("unparsable -r/-d")
    sizes = HG38_SIZES
    if args.sizes_file:
        sizes = {}
        with open(args.sizes_file) as fh:
            for line in fh:
                parts = line.split()
                if len(parts) >= 2:
                    sizes[parts[0]] = int(parts[1])
    cfg = DetectionConfig(resolution=res, distance_bp=dist,
                          octaves=args.octaves)
    cache = enable_compilation_cache()
    n_bins = [length // res + 1 for length in sizes.values()]
    t0 = time.time()
    jobs = warm(cfg, n_bins, diff=args.diff,
                log=lambda m: print(f"[warmup] {m}", flush=True))
    print(f"[warmup] {jobs} shapes compiled in {time.time() - t0:.0f}s "
          f"(cache: {cache})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
