"""``mustache``-compatible command-line interface.

Flags, defaults, error messages, chromosome discovery, and output format
mirror the reference driver (mustache.py:52-178 for the parser, :963-1111
for the main flow) so existing invocations and the benchmark configs work
unchanged. Engine-only extras are prefixed ``--engine-*``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from mustache_tpu.config import DetectionConfig, clamp_distance_filter, parse_bp
from mustache_tpu.io.bias import read_bias
from mustache_tpu.io.chrom import normalize_chrom, read_chrom_sizes
from mustache_tpu.io.text import read_text_contacts
from mustache_tpu.pipeline import detect_loops_coo


def build_parser(diff: bool = False) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Multi-scale chromatin loop detection on JAX "
                    "(reference-compatible flags)")
    if diff:
        p.add_argument("-f1", "--file1", dest="f_path1", required=False,
                       help="first condition's contact map "
                            "(.hic/.cool/.mcool/text)")
        p.add_argument("-f2", "--file2", dest="f_path2", required=False,
                       help="second condition's contact map")
    else:
        p.add_argument("-f", "--file", dest="f_path", required=False,
                       help="contact map (.hic/.cool/.mcool/text)")
    p.add_argument("-d", "--distance", dest="distFilter", required=False,
                   help="largest anchor separation tested, in bp "
                        "(clamped to the reference's bounds)")
    p.add_argument("-o", "--outfile", dest="outdir", required=True,
                   help="output TSV path")
    p.add_argument("-r", "--resolution", dest="resolution", required=True,
                   help="bin size, e.g. 5kb or 5000 (.cool overrides this "
                        "with its own bin size)")
    if diff:
        p.add_argument("-bed1", "--bed1", dest="bed1", default="",
                       help="HiC-Pro bed (condition 1)")
        p.add_argument("-m1", "--matrix1", dest="mat1", default="",
                       help="HiC-Pro matrix (condition 1)")
        p.add_argument("-b1", "--biases1", dest="biasfile1", required=False,
                       help="ICE/KR bias vector for condition 1")
        p.add_argument("-bed2", "--bed2", dest="bed2", default="",
                       help="HiC-Pro bed (condition 2)")
        p.add_argument("-m2", "--matrix2", dest="mat2", default="",
                       help="HiC-Pro matrix (condition 2)")
        p.add_argument("-b2", "--biases2", dest="biasfile2", required=False,
                       help="ICE/KR bias vector for condition 2")
    else:
        p.add_argument("-bed", "--bed", dest="bed", default="",
                       help="HiC-Pro bed file (use with -m)")
        p.add_argument("-m", "--matrix", dest="mat", default="",
                       help="HiC-Pro matrix file (use with -bed)")
        p.add_argument("-b", "--biases", dest="biasfile", required=False,
                       help="per-locus ICE/KR bias vector; raw text counts "
                            "are divided by the factor at both anchors")
    p.add_argument("-cz", "--chromosomeSize", default="", dest="chrSize_file",
                   help="chromosome-sizes file (two columns: name, bp); "
                        "needed for text input without explicit sizes",
                   required=False)
    p.add_argument("-norm", "--normalization", default=False, dest="norm_method",
                   help=".hic norm vector name (KR, VC, SCALE, ...) or the "
                        "cooler balance column",
                   required=False)
    p.add_argument("-st", "--sparsityThreshold", dest="st", type=float,
                   default=0.88,
                   help="local-support fraction below which a candidate is "
                        "discarded; lower it (e.g. 0.8) for sparse maps "
                        "(default 0.88)")
    p.add_argument("-pt", "--pThreshold", dest="pt", type=float, default=0.2,
                   help="FDR (BH q-value) cutoff for reported loops "
                        "(default 0.2)")
    if diff:
        p.add_argument("-pt2", "--pThreshold2", dest="pt2", type=float,
                       default=0.1,
                       help="FDR cutoff for the differential calls "
                            "(default 0.1)")
    p.add_argument("-sz", "--sigmaZero", dest="s_z", type=float, default=1.6,
                   help="base scale sigma0 of the Gaussian ladder "
                        "(default 1.6, tuned for 5kb)")
    p.add_argument("-oc", "--octaves", dest="octaves", default=2, type=int,
                   help="number of scale-space octaves (default 2)")
    p.add_argument("-i", "--iterations", dest="s", default=10, type=int,
                   help="accepted for compatibility; the ladder depth is "
                        "fixed at 10 as in the reference (the flag is inert "
                        "there too, mustache.py:711)")
    p.add_argument("-p", "--processes", dest="nprocesses", default=4, type=int,
                   help="accepted for compatibility; the engine "
                        "parallelizes blocks on-device instead of forking")
    p.add_argument("-ch", "--chromosome", dest="chromosome", nargs="+",
                   default="n",
                   help="chromosome(s) to analyze; auto-discovered for "
                        ".hic/.cool/.mcool inputs")
    p.add_argument("-ch2", "--chromosome2", dest="chromosome2", nargs="+",
                   default="n",
                   help="second chromosome list for inter-chromosomal "
                        "analysis")
    p.add_argument("-v", "--verbose", dest="verbose", type=bool, default=True,
                   help="accepted for compatibility (the reference never "
                        "consults it, mustache.py:171-177)")
    # engine extras (no reference counterpart)
    p.add_argument("--engine-precision", dest="precision", default="float32",
                   choices=["float32", "float64"],
                   help="Numerics of the detection core. float32 is the "
                        "fast path; float64 reproduces the reference "
                        "bit-for-bit.")
    p.add_argument("--engine-block-batch", dest="block_batch", type=int,
                   default=1, help="Blocks per device launch (default 1: "
                                   "the fastest on the H100, see PERF.md).")
    p.add_argument("--engine-profile-dir", dest="profile_dir", default="",
                   help="Write a TensorBoard trace of the run to this dir.")
    p.add_argument("--engine-resume", dest="resume", action="store_true",
                   help="Checkpoint per chromosome and skip chromosomes "
                        "already completed by a previous (crashed) run with "
                        "the same output path and parameters.")
    p.add_argument("--engine-json-log", dest="json_log", action="store_true",
                   help="Structured JSON event log on stderr.")
    p.add_argument("--engine-no-prefetch", dest="no_prefetch",
                   action="store_true",
                   help="Disable the one-chromosome ingest lookahead "
                        "(by default the next chromosome's file decode "
                        "overlaps the current chromosome's detection).")
    p.add_argument("--engine-warmup", dest="engine_warmup",
                   action="store_true",
                   help="Pre-compile every detection graph shape this run "
                        "will touch into the persistent XLA cache before "
                        "ingest starts (one-time cost; later runs of any "
                        "chromosome set at this resolution start warm). "
                        "Equivalent to `python -m mustache_tpu.warmup` "
                        "scoped to this run's chromosomes.")
    p.add_argument("--engine-ingest-retries", dest="ingest_retries",
                   type=int, default=2,
                   help="Retries per chromosome on ingest errors before "
                        "the chromosome is recorded as failed and skipped "
                        "(the run continues; rerun with --engine-resume "
                        "to retry failed chromosomes).")
    # multi-host execution (replaces the reference's sequential
    # per-chromosome loop, mustache.py:1057-1080, with a chromosome shard
    # per process; jax.distributed + process-0 assembly)
    p.add_argument("--engine-platform", dest="platform", default="",
                   choices=["", "cpu", "gpu"],
                   help="Force the JAX backend (default: JAX's own choice, "
                        "the GPU when one is present).")
    p.add_argument("--engine-mesh", dest="engine_mesh", default="auto",
                   choices=["auto", "block", "rowshard", "off"],
                   help="Multi-chip execution within this process: 'auto' "
                        "builds a block-data-parallel mesh over all local "
                        "devices when there is more than one; 'block' / "
                        "'rowshard' force that placement (rowshard holds "
                        "only each chip's band rows — the 1kb-scale "
                        "memory-bound mode; single-map runs only); 'off' "
                        "uses one device. Composes with --engine-nprocs "
                        "(chromosomes across hosts, blocks across each "
                        "host's chips).")
    p.add_argument("--engine-coordinator", dest="coordinator", default="",
                   help="host:port of process 0 for multi-host runs "
                        "(env MTPU_COORDINATOR).")
    p.add_argument("--engine-nprocs", dest="engine_nprocs", type=int,
                   default=0, help="Total engine processes in a multi-host "
                                   "run (env MTPU_NPROCS).")
    p.add_argument("--engine-procid", dest="engine_procid", type=int,
                   default=-1, help="This process's id in a multi-host run "
                                    "(env MTPU_PROCID).")
    p.add_argument("--engine-local-device", dest="local_device", type=int,
                   default=-1,
                   help="Pin this process to one card of its host (env "
                        "MTPU_LOCAL_DEVICE). Needed when several engine "
                        "processes share a host: give each its own card. "
                        "Default: the process drives every local card.")
    return p


def resolve_distributed(args):
    """(coordinator, nprocs, procid, local_device_ids) from flags, falling
    back to env; local_device_ids is None unless a card is pinned."""
    nprocs = args.engine_nprocs or int(os.environ.get("MTPU_NPROCS", "1"))
    procid = args.engine_procid if args.engine_procid >= 0 else \
        int(os.environ.get("MTPU_PROCID", "0"))
    coordinator = args.coordinator or os.environ.get("MTPU_COORDINATOR", "")
    local = args.local_device if args.local_device >= 0 else \
        int(os.environ.get("MTPU_LOCAL_DEVICE", "-1"))
    return coordinator or None, nprocs, procid, \
        ([local] if local >= 0 else None)


def make_cli_runner(mode: str):
    """Multi-chip runner for --engine-mesh: a (block, row=1) mesh over
    this process's local devices. 'auto' engages only when more than one
    local device exists (single-chip hosts keep the direct path); 'block'
    and 'rowshard' force the mesh (size-1 mesh on one device — useful for
    testing). Returns None when meshing is off."""
    if mode == "off":
        return None
    import jax

    devices = jax.local_devices()
    if mode == "auto" and len(devices) <= 1:
        return None
    from mustache_tpu.sharding import make_mesh, make_runner

    placement = "rowshard" if mode == "rowshard" else "replicate"
    mesh = make_mesh(n_block=len(devices), n_row=1, devices=devices)
    return make_runner(mesh, placement)


def parse_args(argv):
    return build_parser(diff=False).parse_args(argv)


def _chromosome_lists(args, f, res):
    """Chromosome discovery, mirroring mustache.py:979-1054."""
    chrSize_in_bp = False
    chr_list = None
    if not args.chromosome or args.chromosome == "n":
        if f.endswith(".cool") or f.endswith(".mcool"):
            from mustache_tpu.io.cool import cool_chrom_list
            chr_list = cool_chrom_list(f, res if f.endswith(".mcool") else None)
        elif not f.endswith(".hic"):
            print("Error: Please enter the chromosome name.")
            return None, None, None
    else:
        chr_list = list(args.chromosome)
    if (f.endswith(".cool") or f.endswith(".mcool")) and not chrSize_in_bp:
        # sizes feed the distance clamp nothing, but --engine-warmup needs
        # them to enumerate this run's compile shapes ahead of ingest
        from mustache_tpu.io.cool import CoolFile
        clr = CoolFile(f, resolution=res if f.endswith(".mcool") else None)
        try:
            chrSize_in_bp = {
                "chr" + normalize_chrom(nm): int(sz)
                for nm, sz in zip(clr.chromnames, clr.chromsizes)}
        finally:
            clr.close()
    if f.endswith(".hic") and (chr_list is None or not chrSize_in_bp):
        # one open serves both discovery and sizes; always closed
        from mustache_tpu.io.hic import HicFile
        hic = HicFile(f)
        try:
            if chr_list is None:
                chr_list = [c.name for c in hic.chromosomes[1:]]
            chrSize_in_bp = {
                "chr" + normalize_chrom(c.name): c.length
                for c in hic.chromosomes[1:]
            }
        finally:
            hic.close()

    if (args.chromosome2 and args.chromosome2 != "n") and \
            len(chr_list) != len(args.chromosome2):
        print("Error: the same number of chromosome1 and chromosome2 should be provided.")
        return None, None, None
    if isinstance(args.chromosome2, list):
        chr_list2 = list(args.chromosome2)
    else:
        chr_list2 = list(chr_list)

    if args.chrSize_file and not chrSize_in_bp:
        chrSize_in_bp = read_chrom_sizes(args.chrSize_file)
    return chr_list, chr_list2, chrSize_in_bp


def load_contacts(f, norm_method, chrm_size, distance_bp, chromosome,
                  chromosome2, res, biasfile, bed=""):
    """Format dispatch (mustache.py:879-886). Returns (x, y, v, res).

    ``bed`` non-empty routes to the working HiC-Pro reader (the reference
    accepts -bed/-m but ignores the bed and misparses the matrix,
    mustache.py:969-970 + :282-288 — beyond-reference fix)."""
    if bed:
        from mustache_tpu.io.hicpro import read_hicpro
        bias = read_bias(biasfile, chromosome, res)
        x, y, v = read_hicpro(f, bed, distance_bp, bias, chromosome, res)
    elif f.endswith(".hic"):
        from mustache_tpu.io.hic import read_hic_file
        x, y, v = read_hic_file(
            f, norm_method, chrm_size, distance_bp, chromosome, chromosome2, res)
    elif f.endswith(".cool"):
        from mustache_tpu.io.cool import read_cooler
        x, y, v, res = read_cooler(f, distance_bp, chromosome, chromosome2,
                                   norm_method)
    elif f.endswith(".mcool"):
        from mustache_tpu.io.cool import read_mcooler
        x, y, v = read_mcooler(f, distance_bp, chromosome, chromosome2, res,
                               norm_method)
    else:
        bias = read_bias(biasfile, chromosome, res)
        x, y, v = read_text_contacts(f, distance_bp, bias, chromosome, res)
    return x, y, v, res


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

    f = args.f_path
    if args.bed and args.mat:
        f = args.mat
    if not f or not os.path.exists(f):
        print("Error: Couldn't find the specified contact files")
        return 1
    res = parse_bp(args.resolution)
    if not res:
        print("Error: Invalid resolution")
        return 1

    dist_bp = clamp_distance_filter(parse_bp(args.distFilter), res)

    # all fallible local validation happens BEFORE the jax.distributed
    # rendezvous: a host that errors out here exits before the collective
    # group forms, instead of stranding its peers at the parts-complete
    # barrier at the end of the run (which only hosts that reach the main
    # loop ever hit)
    chr_list, chr_list2, chrSize_in_bp = _chromosome_lists(args, f, res)
    if chr_list is None:
        return 1

    biasf = False
    if args.biasfile:
        if os.path.exists(args.biasfile):
            biasf = args.biasfile
        else:
            print("Error: Couldn't find specified bias file")
            return 1

    coordinator, nprocs, procid, local_ids = resolve_distributed(args)
    if nprocs > 1:
        from mustache_tpu.sharding import initialize_distributed
        initialize_distributed(coordinator, nprocs, procid, local_ids)

    runner = make_cli_runner(args.engine_mesh)

    if args.profile_dir:
        import jax
        jax.profiler.start_trace(args.profile_dir)

    from mustache_tpu.runlog import RunLog
    log = RunLog(json_mode=args.json_log)
    header = ("BIN1_CHR\tBIN1_START\tBIN1_END\tBIN2_CHROMOSOME\t"
              "BIN2_START\tBIN2_END\tFDR\tDETECTION_SCALE\n")

    manifest = None
    if args.resume or nprocs > 1:
        # multi-host runs always go through the manifest: each process
        # writes atomic per-chromosome part files to the shared output
        # directory and process 0 assembles them after the barrier
        from mustache_tpu.manifest import RunManifest, config_fingerprint
        base_cfg = DetectionConfig(
            resolution=res, distance_bp=dist_bp, pt=args.pt, st=args.st,
            sigma0=args.s_z, octaves=args.octaves, precision=args.precision)
        # the fingerprint must cover everything that shapes the VALUES in
        # a part file, or resume would mix results computed under
        # different normalizations into one output
        manifest = RunManifest(
            args.outdir, config_fingerprint(base_cfg, {
                "f": os.path.abspath(f),
                "norm": str(args.norm_method),
                "bias": os.path.abspath(biasf) if biasf else "",
                "bed": os.path.abspath(args.bed) if args.bed else "",
            }))
        done = manifest.completed_chromosomes()
        if args.resume and done:
            log.event("resume", skipping=sorted(done))

    if manifest is None:
        with open(args.outdir, "w") as out:
            out.write(header)

    pairs = list(zip(chr_list, chr_list2))
    if nprocs > 1:
        from mustache_tpu.sharding import shard_chromosomes
        my_idx = shard_chromosomes(list(range(len(pairs))), procid, nprocs)
        pairs = [pairs[i] for i in my_idx]
        log.event("shard", process=procid, nprocs=nprocs,
                  chromosomes=[str(c) for c, _ in pairs])

    def ingest_one(chromosome, chromosome2):
        from mustache_tpu.faults import maybe_fail

        attempts = max(0, args.ingest_retries) + 1
        for attempt in range(attempts):
            try:
                maybe_fail("ingest", chromosome=str(chromosome))
                chrm_size = False
                if chrSize_in_bp:
                    chrm_size = chrSize_in_bp.get(
                        "chr" + normalize_chrom(chromosome), False)
                return load_contacts(f, args.norm_method, chrm_size, dist_bp,
                                     chromosome, chromosome2, res, biasf,
                                     bed=args.bed if args.mat else "")
            except Exception as exc:
                if attempt + 1 == attempts:
                    raise
                log.event("ingest_retry", chromosome=str(chromosome),
                          attempt=attempt + 1, error=str(exc))
                time.sleep(0.1 * (2 ** attempt))

    todo = []
    for chromosome, chromosome2 in pairs:
        unit_name = str(chromosome) if chromosome == chromosome2 else \
            f"{chromosome}__x__{chromosome2}"
        if manifest and args.resume and unit_name in done:
            continue
        todo.append((chromosome, chromosome2, unit_name))

    if args.engine_warmup:
        # AOT-compile every shape this run's chromosomes will touch into
        # the persistent cache BEFORE ingest: first runs pay the compile
        # up front and in bulk; later runs (and --engine-resume reruns)
        # start warm. Needs chromosome sizes; without them (-ch on bare
        # text input, no -cz) the shapes are unknowable ahead of ingest.
        sizes_known = bool(chrSize_in_bp)
        if not sizes_known:
            log.event("warmup_skipped",
                      reason="chromosome sizes unknown (use -cz)")
        else:
            from mustache_tpu.warmup import warm
            base_cfg = DetectionConfig(
                resolution=res, distance_bp=dist_bp, pt=args.pt, st=args.st,
                sigma0=args.s_z, octaves=args.octaves,
                precision=args.precision, block_batch=args.block_batch)
            n_bins_list = []
            for chromosome, _, _ in todo:
                sz = chrSize_in_bp.get(
                    "chr" + normalize_chrom(chromosome))
                if sz:
                    n_bins_list.append(int(sz) // res + 1)
            if n_bins_list:
                with log.phase("warmup", shapes=len(set(n_bins_list))):
                    warm(base_cfg, n_bins_list,
                         log=lambda m: log.event("warmup", detail=m))
    if manifest and not args.resume:
        # fresh run: stale parts from a previous run must not survive into
        # this run's assembly if one of these units fails
        manifest.invalidate([u for _, _, u in todo])

    # cross-chromosome software pipelining: chromosome k+1's file decode
    # (disk + zlib + bias math, all host-side) runs on a worker thread
    # while chromosome k detects on the device. One-deep lookahead bounds
    # peak memory to two chromosomes' COO triplets.
    prefetch = None
    if not args.no_prefetch and len(todo) > 1:
        from concurrent.futures import ThreadPoolExecutor
        prefetch = ThreadPoolExecutor(max_workers=1)
    pending = None
    failed_units: list[str] = []

    for i, (chromosome, chromosome2, unit_name) in enumerate(todo):
        inter = chromosome != chromosome2
        if inter and not (f.endswith(".hic") or f.endswith(".cool")
                          or f.endswith(".mcool")):
            # reference gate (mustache.py:869-871). Recorded as a failed
            # unit rather than an early return: in a multi-host run a
            # mid-loop return would leave the other processes hanging at
            # the parts-complete barrier below. The pending prefetch (THIS
            # unit's ingest) must be discarded and the next unit's
            # submitted, or unit i+1 would consume unit i's contacts.
            print("Interchromosomal analysis is only supported for .hic "
                  "and .cool input formats.")
            log.event("unit_failed", unit=unit_name, stage="gate",
                      error="inter-chromosomal needs .hic/.cool input")
            failed_units.append(unit_name)
            if pending is not None:
                try:
                    pending.result()
                except Exception:
                    pass
            pending = None
            if prefetch is not None and i + 1 < len(todo):
                nxt = todo[i + 1]
                pending = prefetch.submit(ingest_one, nxt[0], nxt[1])
            continue

        ingest_err = None
        with log.phase("ingest", chromosome=str(chromosome),
                       prefetched=pending is not None):
            try:
                if pending is not None:
                    x, y, v, res_eff = pending.result()
                else:
                    x, y, v, res_eff = ingest_one(chromosome, chromosome2)
            except Exception as exc:  # retries exhausted inside ingest_one
                ingest_err = exc
        pending = None
        if prefetch is not None and i + 1 < len(todo):
            nxt = todo[i + 1]
            pending = prefetch.submit(ingest_one, nxt[0], nxt[1])
        if ingest_err is not None:
            # elastic recovery: the chromosome is the unit of restart —
            # record the failure, keep the run alive, let a later
            # --engine-resume rerun retry exactly this unit
            log.event("unit_failed", unit=unit_name, stage="ingest",
                      error=str(ingest_err))
            failed_units.append(unit_name)
            continue

        cfg = DetectionConfig(
            resolution=res_eff, distance_bp=dist_bp, pt=args.pt, st=args.st,
            sigma0=args.s_z, octaves=args.octaves, precision=args.precision,
            block_batch=args.block_batch,
        )
        t_detect = time.time()
        try:
            with log.phase("detect", chromosome=str(chromosome),
                           contacts=len(v)):
                if not len(v):
                    loops = []
                elif inter:
                    # beyond-reference: working inter-chromosomal detection
                    # (the reference's path crashes, mustache.py:689-694)
                    from mustache_tpu.inter import detect_inter_loops_coo
                    from mustache_tpu.pipeline import Loop
                    rows_i = detect_inter_loops_coo(x, y, v, cfg)
                    loops = [Loop(int(r[0]), int(r[1]), float(r[2]),
                                  float(r[3])) for r in rows_i]
                else:
                    loops = detect_loops_coo(x, y, v, cfg, runner=runner,
                                             log=log)
        except Exception as exc:
            log.event("unit_failed", unit=unit_name, stage="detect",
                      error=str(exc))
            failed_units.append(unit_name)
            continue

        if len(v):
            # throughput counters (genome Mb/s of the detect phase)
            mb = (int(max(x.max(), y.max())) + 1) * res_eff / 1e6
            dt = max(time.time() - t_detect, 1e-9)
            log.event("throughput", chromosome=str(chromosome),
                      mb=round(mb, 2), mb_per_s=round(mb / dt, 3),
                      loops=len(loops))

        rows = "".join(lp.to_row(chromosome, chromosome2, res_eff)
                       for lp in loops)
        elapsed = time.time() - start_time
        print("{0} loops found for chrmosome={1}, fdr<{2} in {3}sec".format(
            len(loops), chromosome, args.pt, "%.2f" % elapsed))
        if manifest:
            manifest.mark_complete(unit_name, len(loops), elapsed, rows)
        elif rows:
            with open(args.outdir, "a") as out:
                out.write(rows)
        start_time = time.time()

    if prefetch is not None:
        prefetch.shutdown(wait=False)
    unit_order = [str(c) if c == c2 else f"{c}__x__{c2}"
                  for c, c2 in zip(chr_list, chr_list2)]
    if nprocs > 1:
        # all parts on disk before process 0 concatenates them
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices("mustache-tpu-parts-complete")
        if procid == 0:
            manifest.assemble(unit_order, header)
    elif manifest:
        manifest.assemble(unit_order, header)
        if not failed_units:
            # fully-successful single-host run: the parts served their
            # purpose; leaving them would only feed stale data to later
            # differently-failing runs (multi-host keeps parts — process 0
            # cannot see peer failures)
            manifest.cleanup(unit_order)

    if args.profile_dir:
        import jax
        jax.profiler.stop_trace()
    if failed_units:
        print("Error: {0} chromosome(s) failed after retries: {1}{2}".format(
            len(failed_units), ", ".join(failed_units),
            " (rerun with --engine-resume to retry exactly these)"
            if manifest else ""))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
