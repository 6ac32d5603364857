#!/usr/bin/env python3
"""GPU profile of the loop caller: reference rates, batch-size sweeps,
per-layer traces, and the float64 path.

    python3 tools/profile_gpu.py [--out DIR]   # default .profile_out/
                                 [--sections rates,sweep,diffsweep,trace]

- ``rates``: what this card reaches on a large bf16 matmul, an f32
  matmul at Precision.HIGHEST, and a device copy.
- ``sweep``: warm wall time of ``detect_loops_coo`` at B in {1, 2, 4, 8}
  (median of 3) on the chr21 5kb and the 1kb Micro-C workloads, with
  ``peak_bytes_in_use`` after each B (B ascending, so each peak is that
  B's own unless an earlier run peaked higher) beside the per-block byte
  model of ``pipeline.block_batch``.
- ``diffsweep``: the same for ``detect_diff_loops_coo`` at 5kb, B in
  {1, 2, 4}.
- ``trace``: the 1kb workload (float32) and the chr21 5kb workload in
  float32 and float64 at the default batch: median warm wall time
  untraced, then one run under ``jax.profiler.trace``; each trace and the
  detector's compiled HLO are written under ``--out`` and reduced by
  ``tools/trace_reduce.py`` into ladder / scan / epilogue device time.

Prints JSON lines on stdout; exits non-zero when JAX finds no GPU.
"""

import argparse
import glob
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests"),
                os.path.dirname(os.path.abspath(__file__))]


def emit(**kw):
    print(json.dumps(kw), flush=True)


def timed(fn, reps=3):
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls), walls


def reference_rates(jax, jnp):
    out = {}
    n = 8192
    a = jnp.ones((n, n), jnp.bfloat16)
    f = jax.jit(lambda x: x @ x)
    f(a).block_until_ready()
    t, _ = timed(lambda: f(a).block_until_ready(), 5)
    out["bf16_matmul_tflops"] = 2 * n ** 3 / t / 1e12
    a32 = jnp.ones((n, n), jnp.float32)
    g = jax.jit(lambda x: jnp.matmul(x, x,
                                     precision=jax.lax.Precision.HIGHEST))
    g(a32).block_until_ready()
    t, _ = timed(lambda: g(a32).block_until_ready(), 5)
    out["f32_highest_matmul_tflops"] = 2 * n ** 3 / t / 1e12
    big = jnp.ones((1 << 28,), jnp.float32)        # 1 GiB
    c = jax.jit(lambda x: x * 1.0001)
    c(big).block_until_ready()
    t, _ = timed(lambda: c(big).block_until_ready(), 5)
    out["copy_tb_per_s"] = 2 * big.nbytes / t / 1e12
    return out


def ladder_work(n: int, octave_values=(1.6, 3.2)):
    """FLOPs and bytes of one block's blur ladder at the algorithm's own
    size (no slab or pad rows): the row pass makes S channels over the
    padded width, the column pass is depthwise. ``bytes_min`` reads the
    block and writes the planes once; ``bytes_with_row_pass`` adds the
    row pass's output written and read back."""
    from mustache_tpu.scalespace import build_ladder

    S, W = build_ladder(octave_values).kernels.shape
    R = (W - 1) // 2
    flops = 2 * S * W * n * (n + 2 * R) + 2 * S * W * n * n
    bytes_min = 4 * (n * n + S * n * n)
    bytes_inter = bytes_min + 2 * 4 * S * n * (n + 2 * R)
    return {"S": S, "W": W, "flops": flops, "bytes_min": bytes_min,
            "bytes_with_row_pass": bytes_inter}


def trace_run(jax, jnp, name, x, y, v, cfg, out_dir, card):
    """Untraced median of 5 warm runs, then one traced run, reduced to
    per-layer device time with the detector's compiled HLO."""
    import numpy as np

    from mustache_tpu.bandnorm import bucket_rows
    from mustache_tpu.detect import band_width, build_detector
    from mustache_tpu.pipeline import detect_loops_coo
    from trace_reduce import reduce_trace

    run = lambda: detect_loops_coo(x, y, v.astype(np.float64).copy(), cfg)
    t0 = time.perf_counter()
    run()
    cold = time.perf_counter() - t0
    med, walls = timed(run, 5)
    tdir = os.path.join(out_dir, f"trace_{name}")
    with jax.profiler.trace(tdir):
        t0 = time.perf_counter()
        run()
        traced = time.perf_counter() - t0
    n = int(max(x.max(), y.max())) + 1
    N = cfg.chunk_size
    dt = jnp.float64 if cfg.precision == "float64" else jnp.float32
    det = build_detector(cfg, N)
    hlo = det._fn_band_packed.lower(
        jax.ShapeDtypeStruct((bucket_rows(max(n, N)),
                              band_width(N, cfg.distance_px)), dt),
        jax.ShapeDtypeStruct((cfg.block_batch,), jnp.int32),
        jax.ShapeDtypeStruct((), dt),
        jax.ShapeDtypeStruct((), dt)).compile().as_text()
    with open(os.path.join(out_dir, f"detector_{name}.hlo.txt"), "w") as fh:
        fh.write(hlo)
    xplane = sorted(glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                              recursive=True))[-1]
    emit(trace=name, layers=reduce_trace(xplane, [hlo]),
         B=cfg.block_batch, cold_s=cold, untraced_median_s=med,
         untraced_s=walls, traced_s=traced,
         ladder_work_per_block=ladder_work(N, cfg.octave_values),
         card=card)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, ".profile_out"))
    ap.add_argument("--sections", default="rates,sweep,diffsweep,trace")
    args = ap.parse_args(argv)
    sections = set(args.sections.split(","))
    os.makedirs(args.out, exist_ok=True)

    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        print(f"profile_gpu: backend {jax.default_backend()!r}, not 'gpu'",
              file=sys.stderr)
        return 2
    from mustache_tpu.runtime import enable_compilation_cache

    enable_compilation_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    dev = jax.devices()[0]
    emit(card=card, kind=dev.device_kind, jax=jax.__version__,
         bytes_limit=dev.memory_stats()["bytes_limit"])
    if "rates" in sections:
        emit(reference_rates=reference_rates(jax, jnp), card=card)

    import bench
    from mustache_tpu.config import DetectionConfig, chunk_grid
    from mustache_tpu.diff import detect_diff_loops_coo
    from mustache_tpu.pipeline import detect_loops_coo

    work = {
        "chr21_5kb": (bench.build_workload(), 5000),
        "micro_c_1kb": (bench.build_workload_1kb(), 1000),
    }
    base = dict(distance_bp=2_000_000, pt=0.1, st=0.8)
    if "sweep" in sections:
        for name, ((x, y, v), res) in work.items():
            n = int(max(x.max(), y.max())) + 1
            for B in (1, 2, 4, 8):
                cfg = DetectionConfig(resolution=res, block_batch=B, **base)
                nblocks = len(chunk_grid(n, cfg.chunk_size,
                                         cfg.distance_px)[0])
                run = lambda: detect_loops_coo(x, y, v.copy(), cfg)
                t0 = time.perf_counter()
                loops = run()
                cold = time.perf_counter() - t0
                med, walls = timed(run)
                N = cfg.chunk_size
                emit(sweep=name, B=B, nblocks=nblocks,
                     launches=-(-nblocks // B), loops=len(loops),
                     cold_s=cold, warm_median_s=med, warm_s=walls,
                     peak_bytes=dev.memory_stats()["peak_bytes_in_use"],
                     model_bytes=B * 45 * N * N * 4, card=card)
    if "diffsweep" in sections:
        x1, y1, v1 = bench.build_workload(bench.SEED_CHR21)
        x2, y2, v2 = bench.build_workload(bench.SEED_CHR21_B)
        for B in (1, 2, 4):
            cfg = DetectionConfig(resolution=5000, block_batch=B, **base)
            run = lambda: detect_diff_loops_coo(x1, y1, v1.copy(),
                                                x2, y2, v2.copy(), cfg)
            t0 = time.perf_counter()
            rows = run()
            cold = time.perf_counter() - t0
            med, walls = timed(run)
            N = cfg.chunk_size
            emit(sweep="diff_5kb", B=B, rows=len(rows), cold_s=cold,
                 warm_median_s=med, warm_s=walls,
                 peak_bytes=dev.memory_stats()["peak_bytes_in_use"],
                 model_bytes=B * 135 * N * N * 4, card=card)
    if "trace" in sections:
        (x, y, v), res = work["micro_c_1kb"]
        trace_run(jax, jnp, "1kb_f32", x, y, v,
                  DetectionConfig(resolution=1000, **base), args.out, card)
        (x, y, v), res = work["chr21_5kb"]
        trace_run(jax, jnp, "5kb_f32", x, y, v,
                  DetectionConfig(resolution=5000, **base), args.out, card)
        jax.config.update("jax_enable_x64", True)
        trace_run(jax, jnp, "5kb_f64", x, y, v,
                  DetectionConfig(resolution=5000, precision="float64",
                                  **base), args.out, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
