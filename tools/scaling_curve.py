#!/usr/bin/env python3
"""CPU-mesh scaling curve through the band-resident sharded runner.

Runs the REAL pipeline (`detect_loops_coo(runner=make_runner(mesh))`) on a
synthetic chromosome at 1, 2, 4, 8 virtual devices and reports blocks/s.
It checks loop-call equality at every mesh width: the mesh, shardings and
data path are exactly the multi-card ones; only the backend (host CPU)
differs, so its throughput column measures host cores, not cards.

Usage: python tools/scaling_curve.py   (re-execs itself with
XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu)
"""
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

if os.environ.get("_MTPU_SCALING_CHILD") != "1":
    env = dict(os.environ)
    env["_MTPU_SCALING_CHILD"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    flags = env.get("XLA_FLAGS", "")
    env["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    os.execve(sys.executable, [sys.executable, os.path.abspath(__file__)]
              + sys.argv[1:], env)

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

from synthetic import synthetic_hic
from mustache_tpu.config import DetectionConfig, chunk_grid
from mustache_tpu.pipeline import detect_loops_coo
from mustache_tpu.sharding import make_mesh, make_runner


def main():
    # enough blocks for an 8-wide batch axis to bite, small enough for the
    # CPU backend: 16,200 bins, 200-px band -> 9 blocks of 2000^2
    n_bins, d_px = 16_200, 200
    cfg = DetectionConfig(resolution=5000, distance_bp=d_px * 5000,
                          pt=0.1, st=0.8, precision="float32")
    x, y, v, _ = synthetic_hic(n_bins, d_px, seed=42, n_loops=160,
                               loop_strength=3.0)
    nblocks = len(chunk_grid(n_bins, cfg.chunk_size, d_px)[0])
    print(f"# n_bins={n_bins} d_px={d_px} nnz={len(v)} blocks={nblocks} "
          f"devices={len(jax.devices())}", file=sys.stderr)

    results = []
    baseline = None
    for nd in (1, 2, 4, 8):
        mesh = make_mesh(n_block=nd, n_row=1, devices=jax.devices()[:nd])
        runner = make_runner(mesh)

        def run():
            return detect_loops_coo(x, y, v.copy(), cfg, runner=runner)

        loops = run()                       # compile + warm caches
        times = []
        for _ in range(3):                  # 3+ warm reps: host jitter
            t0 = time.time()
            loops2 = run()
            times.append(time.time() - t0)
            assert [(l.bin1, l.bin2) for l in loops] == \
                [(l.bin1, l.bin2) for l in loops2]
        if nd == 1:
            ref_calls = [(l.bin1, l.bin2, l.scale) for l in loops]
        else:
            assert [(l.bin1, l.bin2, l.scale) for l in loops] == ref_calls, \
                f"loop calls differ at {nd} devices"
        best = min(times)
        med = sorted(times)[len(times) // 2]
        bps = nblocks / best
        if baseline is None:
            baseline = bps
        results.append({"devices": nd, "seconds_min": round(best, 3),
                        "seconds_median": round(med, 3),
                        "blocks_per_s": round(bps, 2),
                        "speedup": round(bps / baseline, 2),
                        "loops": len(loops)})
        print(f"# {nd} dev: min {best:.2f}s median {med:.2f}s "
              f"{bps:.1f} blocks/s speedup {bps/baseline:.2f}x "
              f"loops={len(loops)}", file=sys.stderr)
    print(json.dumps({"scaling_curve_cpu_mesh": results}))


if __name__ == "__main__":
    main()
