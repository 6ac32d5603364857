"""``diff_mustache``-compatible CLI: differential loops between two
conditions. Mirrors diff_mustache.py:29-180 (parser) and :720-906 (driver):
four output files ``.loop1 .diffloop1 .loop2 .diffloop2``.

Engine extras match the single-map CLI: ``--engine-resume`` checkpoints
per chromosome (four per-file manifests, a unit counts as done only when
all four parts exist), and ``--engine-coordinator/-nprocs/-procid`` runs
a chromosome shard per process with process-0 assembly.
"""

from __future__ import annotations

import os
import sys
import time

from mustache_tpu.cli import (
    build_parser, load_contacts, make_cli_runner, resolve_distributed,
    _chromosome_lists,
)
from mustache_tpu.config import DetectionConfig, clamp_distance_filter, parse_bp
from mustache_tpu.diff import detect_diff_loops_coo
from mustache_tpu.io.chrom import normalize_chrom

HEADER = ("BIN1_CHR\tBIN1_START\tBIN1_END\tBIN2_CHROMOSOME\t"
          "BIN2_START\tBIN2_END\tFDR\tDETECTION_SCALE\n")
SUFFIXES = {1: ".loop1", 2: ".diffloop1", 3: ".loop2", 4: ".diffloop2"}


def parse_args(argv):
    return build_parser(diff=True).parse_args(argv)


def main(argv=None):
    start_time = time.time()
    args = parse_args(sys.argv[1:] if argv is None else argv)
    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.precision == "float64":
        jax.config.update("jax_enable_x64", True)
    from mustache_tpu.runtime import enable_compilation_cache
    enable_compilation_cache()
    print("\n")

    f1, f2 = args.f_path1, args.f_path2
    if args.bed1 and args.mat1:
        f1 = args.mat1
    if args.bed2 and args.mat2:
        f2 = args.mat2
    if not f1 or not f2 or not os.path.exists(f1) or not os.path.exists(f2):
        print("Error: Couldn't find the specified contact files")
        return 1
    res = parse_bp(args.resolution)
    if not res:
        print("Error: Invalid resolution")
        return 1

    # differential clamp caps at 2000*res / 2Mb (diff_mustache.py:759-778)
    dist_bp = clamp_distance_filter(parse_bp(args.distFilter), res, diff=True)

    chr_list, chr_list2, chrSize_in_bp = _chromosome_lists(args, f1, res)
    if chr_list is None:
        return 1

    biasf1 = args.biasfile1 if args.biasfile1 and os.path.exists(args.biasfile1) else False
    if args.biasfile1 and not biasf1:
        print("Error: Couldn't find the specified bias file1")
        return 1
    biasf2 = args.biasfile2 if args.biasfile2 and os.path.exists(args.biasfile2) else False
    if args.biasfile2 and not biasf2:
        print("Error: Couldn't find the specified bias file2")
        return 1

    if getattr(args, "engine_warmup", False) and chrSize_in_bp:
        # AOT-compile this run's differential-detector shapes up front
        # (see cli.main; diff=True adds the two-band detector variants)
        from mustache_tpu.warmup import warm
        base_cfg = DetectionConfig(
            resolution=res, distance_bp=dist_bp, pt=args.pt, pt2=args.pt2,
            st=args.st, sigma0=args.s_z, octaves=args.octaves,
            precision=args.precision, block_batch=args.block_batch)
        n_bins_list = [int(sz) // res + 1 for nm, sz in chrSize_in_bp.items()
                       if any("chr" + normalize_chrom(c) == nm
                              for c in chr_list)]
        if n_bins_list:
            warm(base_cfg, n_bins_list, diff=True)

    def ingest_one(chromosome, chromosome2):
        from mustache_tpu.faults import maybe_fail

        attempts = max(0, getattr(args, "ingest_retries", 2)) + 1
        for attempt in range(attempts):
            try:
                maybe_fail("ingest", chromosome=str(chromosome))
                chrm_size = False
                if chrSize_in_bp:
                    chrm_size = chrSize_in_bp.get(
                        "chr" + normalize_chrom(chromosome), False)
                a = load_contacts(f1, args.norm_method, chrm_size, dist_bp,
                                  chromosome, chromosome2, res, biasf1,
                                  bed=args.bed1 if args.mat1 else "")
                b = load_contacts(f2, args.norm_method, chrm_size, dist_bp,
                                  chromosome, chromosome2, res, biasf2,
                                  bed=args.bed2 if args.mat2 else "")
                return a, b
            except Exception:
                if attempt + 1 == attempts:
                    raise
                time.sleep(0.1 * (2 ** attempt))

    # validate BEFORE the jax.distributed rendezvous (a host erroring out
    # after the collective group forms strands its peers at the barrier)
    if any(str(c) != str(c2) for c, c2 in zip(chr_list, chr_list2)):
        print("Interchromosomal analysis is not supported.")
        return 1

    coordinator, nprocs, procid, local_ids = resolve_distributed(args)
    if nprocs > 1:
        from mustache_tpu.sharding import initialize_distributed
        initialize_distributed(coordinator, nprocs, procid, local_ids)

    runner = make_cli_runner(args.engine_mesh)
    from mustache_tpu.runlog import RunLog
    log = RunLog(json_mode=getattr(args, "json_log", False))

    manifests = None
    done = set()
    if args.resume or nprocs > 1:
        # four per-file manifests sharing one fingerprint; a unit counts
        # as completed only when ALL four parts carry a matching marker
        # (a crash between files leaves the unit incomplete -> rerun)
        from mustache_tpu.manifest import RunManifest, config_fingerprint
        base_cfg = DetectionConfig(
            resolution=res, distance_bp=dist_bp, pt=args.pt, pt2=args.pt2,
            st=args.st, sigma0=args.s_z, octaves=args.octaves,
            precision=args.precision)
        fp = config_fingerprint(base_cfg, {
            "f1": os.path.abspath(f1), "f2": os.path.abspath(f2),
            "norm": str(args.norm_method),
            "bias1": os.path.abspath(biasf1) if biasf1 else "",
            "bias2": os.path.abspath(biasf2) if biasf2 else "",
            "bed1": os.path.abspath(args.bed1) if args.bed1 else "",
            "bed2": os.path.abspath(args.bed2) if args.bed2 else "",
        })
        manifests = {t: RunManifest(args.outdir + sfx, fp)
                     for t, sfx in SUFFIXES.items()}
        done = set.intersection(
            *[m.completed_chromosomes() for m in manifests.values()])

    # cross-chromosome software pipelining (see cli.main): chromosome
    # k+1's two-file decode overlaps chromosome k's device compute
    pairs = list(zip(chr_list, chr_list2))
    unit_order = [str(c) for c, _ in pairs]
    if nprocs > 1:
        from mustache_tpu.sharding import shard_chromosomes
        my_idx = shard_chromosomes(list(range(len(pairs))), procid, nprocs)
        pairs = [pairs[i] for i in my_idx]
    if manifests is not None:
        if args.resume and done:
            pairs = [p for p in pairs if str(p[0]) not in done]
        elif not args.resume:
            # fresh run: stale parts must not survive into assembly
            for m in manifests.values():
                m.invalidate([str(c) for c, _ in pairs])

    prefetch = None
    if not getattr(args, "no_prefetch", False) and len(pairs) > 1:
        from concurrent.futures import ThreadPoolExecutor
        prefetch = ThreadPoolExecutor(max_workers=1)
    pending = None

    failed_units = []
    wrote_header = False
    for i, (chromosome, chromosome2) in enumerate(pairs):
        if chromosome != chromosome2:
            print("Interchromosomal analysis is not supported.")
            return 1

        ingest_err = None
        try:
            if pending is not None:
                (x1, y1, v1, res_eff), (x2, y2, v2, res2) = pending.result()
            else:
                (x1, y1, v1, res_eff), (x2, y2, v2, res2) = \
                    ingest_one(chromosome, chromosome2)
        except Exception as exc:  # retries exhausted inside ingest_one
            ingest_err = exc
        pending = None
        if prefetch is not None and i + 1 < len(pairs):
            nxt = pairs[i + 1]
            if nxt[0] == nxt[1]:  # the gate above rejects mixed pairs
                pending = prefetch.submit(ingest_one, nxt[0], nxt[1])
        if ingest_err is not None:
            print(f"Error: chromosome {chromosome} failed after retries: "
                  f"{ingest_err}")
            failed_units.append(str(chromosome))
            continue
        # reference check (diff_mustache.py:614-616): whenever f2 is .cool,
        # its binsize must equal the effective resolution (the CLI -r, or
        # f1's binsize when f1 is .cool)
        if f2.endswith(".cool") and res_eff != res2:
            raise ValueError("Both contact maps should have the same resolution.")

        cfg = DetectionConfig(
            resolution=res_eff, distance_bp=dist_bp, pt=args.pt, pt2=args.pt2,
            st=args.st, sigma0=args.s_z, octaves=args.octaves,
            precision=args.precision, block_batch=args.block_batch,
        )
        rows = detect_diff_loops_coo(x1, y1, v1, x2, y2, v2, cfg,
                                     runner=runner, log=log) \
            if len(v1) and len(v2) else []

        counters = {1: 0, 2: 0, 3: 0, 4: 0}
        row_strs = {t: [] for t in SUFFIXES}
        for b1, b2, q, scale, tag in rows:
            counters[tag] += 1
            row_strs[tag].append(
                f"{chromosome}\t{b1*res_eff}\t{(b1+1)*res_eff}\t"
                f"{chromosome2}\t{b2*res_eff}\t{(b2+1)*res_eff}\t"
                f"{q}\t{scale}\n")
        elapsed = time.time() - start_time

        if manifests is not None:
            for t, m in manifests.items():
                m.mark_complete(str(chromosome), counters[t], elapsed,
                                "".join(row_strs[t]))
        else:
            if not wrote_header:
                wrote_header = True
                for sfx in SUFFIXES.values():
                    with open(args.outdir + sfx, "w") as out:
                        out.write(HEADER)
            for t, sfx in SUFFIXES.items():
                if row_strs[t]:
                    with open(args.outdir + sfx, "a") as out:
                        out.write("".join(row_strs[t]))

        if not rows:
            # reference prints the plain count line and skips the counters
            # line for empty chromosomes (diff_mustache.py:865-869)
            print("0 loops found for chrmosome={0}, fdr<{1} in {2}sec".format(
                chromosome, args.pt, "%.2f" % elapsed))
        else:
            print(f"({counters[1]},{counters[3]}) loops and "
                  f"({counters[2]},{counters[4]}) differential-loops found "
                  f"in chrmosome={chromosome} for detection-fdr<{args.pt} "
                  f"and difference-fdr<{args.pt2} in {elapsed:.2f}sec")
        start_time = time.time()
    if prefetch is not None:
        prefetch.shutdown(wait=False)
    if nprocs > 1:
        # all parts on disk before process 0 concatenates the four files
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices("mustache-tpu-diff-parts")
        if procid == 0:
            for m in manifests.values():
                m.assemble(unit_order, HEADER)
    elif manifests is not None:
        for m in manifests.values():
            m.assemble(unit_order, HEADER)
        if not failed_units:
            for m in manifests.values():
                m.cleanup(unit_order)
    if failed_units:
        print("Error: {0} chromosome(s) failed after retries: {1}{2}".format(
            len(failed_units), ", ".join(failed_units),
            " (rerun with --engine-resume to retry exactly these)"
            if manifests is not None else ""))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
