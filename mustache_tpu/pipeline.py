"""Per-chromosome orchestration: ingest -> normalize -> block grid -> device
batches -> host finish -> overlap dedup.

Replaces the reference's multiprocessing fan-out (mustache.py:896-960) with
a single SPMD computation: all blocks of a chromosome are densified into a
``[B, N, N]`` batch and processed by one jitted vmapped detector call
(optionally sharded over a device mesh — see mustache_tpu.sharding). The
block grid, overlap sizes, and ownership masks are identical to the
reference so per-block statistics (exponential fits, BH FDR) reproduce the
reference's numbers exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from mustache_tpu.config import DetectionConfig, chunk_grid, block_mask_sizes
from mustache_tpu.detect import (
    band_width, build_detector, finish_block, unpack_block,
)
from mustache_tpu.normalize import normalize_sparse


@dataclasses.dataclass(frozen=True)
class Loop:
    """One loop call in bin coordinates."""

    bin1: int
    bin2: int
    q: float
    scale: float

    def to_row(self, chrom, chrom2, res: int) -> str:
        return (
            f"{chrom}\t{self.bin1 * res}\t{(self.bin1 + 1) * res}\t"
            f"{chrom2}\t{self.bin2 * res}\t{(self.bin2 + 1) * res}\t"
            f"{self.q}\t{self.scale}\n"
        )


def densify_block(x, y, v, start: int, end: int, chunk: int,
                  dtype=np.float64) -> np.ndarray:
    """Dense block for [start, end) exactly as the reference densifies
    (mustache.py:919-924): entries fully inside the window, duplicate
    triplets resolved last-write-wins by fancy assignment."""
    sel = (x >= start) & (x < end) & (y >= start) & (y < end)
    cc = np.zeros((chunk, chunk), dtype=dtype)
    cc[x[sel] - start, y[sel] - start] = v[sel]
    return cc


def fill_raw_band(x, y, v, band_shape) -> np.ndarray:
    """Scatter-fill the RAW chromosome band for the device-normalize path.

    Raw integer counts < 2^16 (every unbiased text/.hic/.cool workload)
    travel as a uint16 band — HALF the H2D bytes of f32 — and are widened
    to f32 on device (bandnorm), which is lossless for such values, so the
    loop calls are bit-identical to the f32-band transfer. Non-integer or
    large values (bias-divided, balanced) keep the f32 band."""
    from mustache_tpu.io import native

    fit = native.values_fit_u16(v)
    if fit is None:   # native library unavailable: decide with numpy
        fit = (v.size > 0 and float(v.min()) >= 0.0
               and float(v.max()) < 65536.0
               and not np.any(v != np.floor(v)))
    band = np.zeros(band_shape, np.uint16 if fit else np.float32)
    filled = (native.fill_band_u16(x, y, v, band) if fit
              else native.fill_band(x, y, v, band))
    if not filled:
        d_arr = y - x
        sel = (d_arr >= 0) & (d_arr < band.shape[1])
        band[x[sel], d_arr[sel]] = v[sel]
    return band


# uint4 packing pays host census+pack plus a bigger device exception
# scatter; below this band size u8 keeps the band (threshold not yet
# measured on the GPU — see ROADMAP, transfer encodings)
_U4_MIN_BYTES = 8_000_000


def fill_raw_band_compact(x, y, v, band_shape):
    """Raw-band fill picking the narrowest LOSSLESS transfer encoding.

    Real Hi-C/Micro-C counts are almost entirely small integers with a thin
    tail of misfits (bias-divided pixels, counts over the dtype limit), so
    the band travels as uint8/uint16 plus a small (row, col, f32 value)
    exception list the device scatters over the widened band before
    normalizing — bit-identical loop calls to the f32-band transfer at
    a half to a quarter of the H2D bytes (see bandnorm; what the saving
    is worth on the card is an open question in ROADMAP). Float-heavy data
    (e.g. fully bias-divided maps) keeps the f32 band.

    Returns ``(band, exceptions, packed4)`` with ``exceptions`` either None
    or an UNPADDED (rows, cols, values) triple (callers pad via
    ``bandnorm.pad_exceptions``) and ``packed4`` True when the band is
    nibble-packed uint8 [rows, Dl//2] (two counts per byte, even logical
    column in the low nibble — bandnorm unpacks on device). Requires
    unique (x, y) pairs — the ingest-path invariant (duplicates would make
    band-vs-exception last-write-wins order ambiguous)."""
    from mustache_tpu.io import native

    rows, Dl = band_shape
    counts = native.classify_values(v)
    if counts is None and v.size:   # no native library: numpy census
        isint = np.isfinite(v) & (v >= 0) & (v == np.floor(v))
        counts = (int(np.count_nonzero(~(isint & (v < 256)))),
                  int(np.count_nonzero(~(isint & (v < 65536)))))
    if counts is not None:
        ne8, ne16 = counts
        # 12-byte exception records (i32 row + i32 col + f32 value)
        bytes8 = rows * Dl + ne8 * 12
        bytes16 = 2 * rows * Dl + ne16 * 12
        # 4-bit census only when u8 is viable (its misfits are a superset)
        # and the band is big enough for halved link bytes to beat the
        # census/pack/scatter overhead
        ne4 = bytes4 = None
        if (Dl % 2 == 0 and bytes8 <= bytes16 and bytes8 < 4 * rows * Dl
                and rows * Dl >= _U4_MIN_BYTES):
            ne4 = native.classify_values4(v)
            if ne4 is None and v.size:
                isint8 = np.isfinite(v) & (v >= 0) & (v == np.floor(v)) \
                    & (v < 256)
                ne4 = int(np.count_nonzero(~(isint8 & (v < 16))))
            if ne4 is not None:
                bytes4 = rows * Dl // 2 + ne4 * 12
        if min(bytes8, bytes16) < 4 * rows * Dl:
            dtype, cap = ((np.uint8, ne8) if bytes8 <= bytes16
                          else (np.uint16, ne16))
            band = np.zeros(band_shape, dtype)
            exc = native.fill_band_compact(x, y, v, band, cap)
            if exc is None and counts is not None:
                # numpy twin of mtpu_fill_band_compact
                d_arr = y - x
                inb = (d_arr >= 0) & (d_arr < Dl) & (x >= 0) & (x < rows)
                fit = (np.isfinite(v) & (v >= 0) & (v == np.floor(v))
                       & (v < (65536 if dtype == np.uint16 else 256)))
                sel = inb & fit
                band[x[sel], d_arr[sel]] = v[sel]
                sel = inb & ~fit
                exc = (x[sel].astype(np.int32),
                       d_arr[sel].astype(np.int32),
                       v[sel].astype(np.float32))
            if exc is not None:
                exc = exc if len(exc[0]) else None
                # nibble-pack when it beats u8 decisively (0.7x): halves
                # the link bytes again; in-band 16..255 values move to the
                # exception list (scattered on device over the unpack)
                if (bytes4 is not None and dtype == np.uint8
                        and bytes4 < 0.7 * bytes8):
                    got = native.pack_band4(band, ne4 + 16)
                    if got is not None:
                        packed, big = got
                    else:           # numpy twin of mtpu_pack_band4
                        big_r, big_c = np.nonzero(band >= 16)
                        big = (big_r.astype(np.int32),
                               big_c.astype(np.int32),
                               band[big_r, big_c].astype(np.float32))
                        band[big_r, big_c] = 0
                        packed = np.ascontiguousarray(
                            band[:, 0::2] | (band[:, 1::2] << 4))
                    if len(big[0]):
                        exc = big if exc is None else tuple(
                            np.concatenate([a, b])
                            for a, b in zip(exc, big))
                    return packed, exc, True
                return band, exc, False
    return fill_raw_band(x, y, v, band_shape), None, False


def stream_band_to_device(x, y, v, band_shape, place=None):
    """Slab-streamed compact band transfer: fill row slabs on the host and
    enqueue each slab's H2D as soon as it is ready, so the (async,
    measured-overlappable) link transfer hides most of the host fill/pack
    time: device_put enqueues asynchronously and runs concurrently with
    HOST work — fill slab k+1 while slab k is in flight. Falls back to the
    one-shot fill_raw_band_compact + device_put when the native range
    fill, the u8 encoding, or the size threshold doesn't apply.

    Returns ``(band_dev, exc, packed4)`` with ``band_dev`` a DEVICE array
    (placed via ``place`` or jax.device_put) and ``exc`` an unpadded
    global-row exception triple or None.
    """
    import jax
    import jax.numpy as jnp

    from mustache_tpu.io import native

    put = place if place is not None else jax.device_put
    rows, Dl = band_shape
    counts = native.classify_values(v)
    ne4 = native.classify_values4(v) if Dl % 2 == 0 else None
    # stream only when the band is big enough for the overlap to beat the
    # per-slab overhead (each range fill re-scans the COO); the threshold
    # is not yet measured on the GPU (ROADMAP, transfer encodings)
    streamable = (counts is not None and v.size
                  and rows >= 4096 and len(v) >= (1 << 20)
                  and rows * Dl >= 8_000_000)
    if streamable:
        ne8, ne16 = counts
        bytes8 = rows * Dl + ne8 * 12
        p4 = (ne4 is not None
              and rows * Dl // 2 + ne4 * 12 < 0.7 * bytes8)
        # stream only the u8/u4 encodings (u16/f32 data takes the one-shot
        # path — same dtype-selection outcome as fill_raw_band_compact)
        streamable = (bytes8 <= 2 * rows * Dl + ne16 * 12
                      and bytes8 < 4 * rows * Dl)
    if not streamable:
        band, exc, p4 = fill_raw_band_compact(x, y, v, band_shape)
        return put(band), exc, p4

    # 2 slabs: each range-fill call scans the whole COO (write work
    # divides, the scan does not), so more slabs cost host time faster
    # than they add transfer overlap
    n_slabs = 2
    per = -(-rows // n_slabs)
    slabs_dev, excs = [], []
    for k in range(n_slabs):
        g0, g1 = k * per, min((k + 1) * per, rows)
        if g0 >= g1:
            break
        slab = np.zeros((g1 - g0, Dl), np.uint8)
        exc = native.fill_band_compact_range(x, y, v, slab, g0, g1,
                                             ne8 + 16)
        if exc is None:        # native path refused mid-way: fall back
            band, exc, p4 = fill_raw_band_compact(x, y, v, band_shape)
            return put(band), exc, p4
        if p4:
            got = native.pack_band4(slab, (ne4 or 0) + 16)
            if got is None:
                band, exc2, p4 = fill_raw_band_compact(x, y, v, band_shape)
                return put(band), exc2, p4
            slab, big = got
            if len(big[0]):
                big = (big[0] + np.int32(g0), big[1], big[2])
                exc = tuple(np.concatenate([a, b])
                            for a, b in zip(exc, big))
        excs.append(exc)
        slabs_dev.append(put(slab))     # async enqueue; next slab fills
        # while this one is in flight
    band_dev = jnp.concatenate(slabs_dev, axis=0)
    er = np.concatenate([e[0] for e in excs])
    exc = ((er, np.concatenate([e[1] for e in excs]),
            np.concatenate([e[2] for e in excs]))
           if len(er) else None)
    return band_dev, exc, p4


def device_bytes_limit() -> int | None:
    """Allocator limit of the first local device
    (``memory_stats()["bytes_limit"]``), or None where the backend reports
    no memory statistics (the CPU)."""
    import jax

    stats = jax.local_devices()[0].memory_stats()
    if not stats or "bytes_limit" not in stats:
        return None
    return int(stats["bytes_limit"])


# Share of the device's allocator limit one launch's blocks may plan for:
# the per-block byte models count the ladder's live [N, N] planes and miss
# up to half of the measured peak (PERF.md, B-sweep), and the rest holds
# the resident chromosome band(s) and the compiled program.
_MEM_SHARE = 0.5


def block_batch(cfg: DetectionConfig, n: int, planes_per_block: int) -> int:
    """Blocks per device launch: ``cfg.block_batch``. One block per launch
    is the default because the B-sweep on the H100 found no launch cost
    to amortize and a full price for every pad slot (PERF.md). A batch
    whose modelled live bytes (``planes_per_block`` [n, n] planes of the
    compute dtype per block) exceed the device's share of memory is
    refused here, before a long compile ends in an out-of-memory error."""
    B = int(cfg.block_batch)
    if B < 1:
        raise ValueError(f"block_batch must be >= 1, got {B}")
    limit = device_bytes_limit()
    itemsize = 8 if cfg.precision == "float64" else 4
    need = B * planes_per_block * n * n * itemsize
    if limit is not None and need > _MEM_SHARE * limit:
        raise ValueError(
            f"block_batch {B} needs ~{need / 1e9:.1f} GB of device memory "
            f"for {n}x{n} blocks; at most {_MEM_SHARE * limit / 1e9:.1f} GB "
            f"is planned per launch on this device")
    return B


def dense_from_band_host(band, s: int, N: int) -> np.ndarray:
    """Host twin of detect.dense_from_band: dense [N, N] block from band
    rows [s, s+N) via the same flat [N, N+1] reinterpret (wrap cells land
    in the lower triangle, overwritten by the sentinel fill before any
    read — bit-identical to the device reconstruction)."""
    rows = band[s: s + N]
    wide = np.zeros((N, N + 1), band.dtype)
    wide[: rows.shape[0], : rows.shape[1]] = rows
    return wide.reshape(-1)[: N * N].reshape(N, N)


def detect_loops_coo(x, y, v, cfg: DetectionConfig, *, normalize: bool = True,
                     exact_normalize: bool = False,
                     runner=None, log=None) -> list[Loop]:
    """Loop calls for one intra-chromosomal COO map (bin coordinates).

    ``runner``: optional callable ``(detector, blocks[B,N,N]) -> outputs``
    used by the sharded driver; defaults to direct invocation.

    Engine-level API: when ``normalize`` is True and ``v`` is float64, the
    z-score is applied to the caller's array IN PLACE (the CLI owns its
    triplets and this avoids a copy at 1kb genome scale). Use the public
    ``find_loops`` wrapper — which copies — if you need ``v`` preserved.
    """
    import jax

    if len(v) == 0:
        return []
    x = np.asarray(x, dtype=np.int64)
    y = np.asarray(y, dtype=np.int64)
    v = np.asarray(v, dtype=np.float64)

    # the float64 path is the reference-parity path: its normalize uses the
    # reference's np.convolve window sums, not the cumulative-sum form
    # (which moves q by ~1e-4 relative at chr21 scale)
    exact_normalize = exact_normalize or cfg.precision == "float64"
    d_px = cfg.distance_px
    n = int(max(x.max(), y.max())) + 1
    chunk = cfg.chunk_size
    # blocks are ALWAYS chunk x chunk: when n <= chunk the reference still
    # densifies into a CHUNK_SIZE x CHUNK_SIZE zero-padded matrix
    # (mustache.py:923), and the zero pad region participates in the blurs
    # and sentinel wedges, shaping the per-plane statistics
    width = chunk
    # transfer in compute precision (halves H2D for the f32 fast path);
    # the f64 golden path keeps full-precision blocks on device
    dtype = np.float64 if cfg.precision == "float64" else np.float32

    # normalize ON DEVICE when the f32 fast path is in play: the host only
    # scatter-fills the RAW band; the per-diagonal windowed z-score runs
    # as column cumsums on chip (bandnorm.py). The f64 golden path and the
    # exact mode keep the host normalize. The sharded-runner path is
    # band-resident too: the raw band is placed REPLICATED over the mesh,
    # every chip normalizes its copy in place (zero communication), and
    # each launch shards only the [B] starts vector — so sharded and
    # unsharded runs see identical values with zero host densifies.
    # rowshard placement keeps each chip's band slab local; the windowed
    # per-diagonal z-score needs full-column context, so normalization
    # happens on the host (one-call native C++) before the slabs upload
    row_shard = (runner is not None
                 and getattr(runner, "band_placement", "") == "rowshard")
    device_norm = (normalize and not exact_normalize
                   and dtype == np.float32 and not row_shard)
    # ONE H2D per chromosome: the diagonal band [rows, Dl] (3-5x fewer
    # bytes than the dense blocks); each block is sliced + densified on
    # device (fn_band).
    # Entries beyond Dl >= d_px+4 cannot exist after the ingest
    # distance filters (<= d_px+1); the public-API corner where they
    # do would land in the sentinel wedge either way. Rows ride the
    # geometric bucket ladder so a genome's worth of chromosome lengths
    # compiles a handful of band shapes, not one per chromosome
    # (bandnorm.bucket_rows; pad rows are unoccupied and inert).
    from mustache_tpu.bandnorm import bucket_rows
    band_shape = (bucket_rows(max(n, width)), band_width(width, d_px))
    band = None
    if not device_norm:
        band = np.zeros(band_shape, dtype=dtype)

    band_dev = None
    if device_norm:
        from mustache_tpu.bandnorm import normalize_band_device, pad_exceptions

        place = runner.place_band if runner is not None else None
        band_placed, exc, p4 = stream_band_to_device(x, y, v, band_shape,
                                                     place=place)
        if exc is not None:
            exc = pad_exceptions(exc, band_shape[0])
            if runner is not None:
                exc = tuple(runner.place_band(e) for e in exc)
        band_dev, _ = normalize_band_device(band_placed, n, cfg.resolution,
                                            d_px, exceptions=exc,
                                            packed4=p4)
    elif normalize:
        work = (np.float64 if (exact_normalize or cfg.precision == "float64")
                else np.float32)
        # the f32 band is filled inside the (native) normalize pass
        fuse = band if band is not None and dtype == np.float32 else None
        normalize_sparse(x, y, v, cfg.resolution, d_px, exact=exact_normalize,
                         work_dtype=work, band_out=fuse, n=n)
        if band is not None and fuse is None:
            sel = (y - x >= 0) & ((y - x) < band.shape[1])
            band[x[sel], (y - x)[sel]] = v[sel]
    elif band is not None:
        sel = (y - x >= 0) & ((y - x) < band.shape[1])
        band[x[sel], (y - x)[sel]] = v[sel]

    start, end = chunk_grid(n, chunk, d_px)
    masks = block_mask_sizes(start, end, d_px)
    nblocks = len(start)

    # ~45 [N, N] live buffers per block through the ladder
    B = block_batch(cfg, width, 45)
    if runner is not None:
        # every chip gets the same per-launch block count (batch dim is
        # sharded over the mesh's block axis; pad slots detect row 0 and
        # are discarded on the host)
        B = runner.round_batch(B)
    detector = build_detector(cfg, width)

    plan = None
    if row_shard:
        # each chip uploads/holds ONLY its contiguous block range's rows
        # (total H2D ~ one band; per-chip HBM ~ slab, not band)
        plan = runner.plan_rowshard(start, width)
        band_dev = runner.place_band_rowshard(band, plan, log=log)
    elif band is not None and band_dev is None:
        band_dev = (runner.place_band(band) if runner is not None
                    else jax.device_put(band))

    def pack_starts(idxs, cap):
        # pad slots carry start -1: the slice clamps to row 0 and their
        # outputs are discarded on the host
        starts = np.asarray(
            [start[i] for i in idxs] + [-1] * (cap - len(idxs)), np.int32)
        return runner.place_starts(starts) if runner is not None else starts

    def launch(idxs):
        return idxs, detector.fn_band_packed(band_dev, pack_starts(idxs, B))

    # loop rows tagged by block index: rowshard launches interleave blocks
    # chip-major, so the reference's block-order output needs a final
    # stable sort (a no-op for the in-order paths)
    tagged: list[tuple[int, Loop]] = []

    def rerun_block(i, cap):
        """Re-detect block i with a larger candidate capacity."""
        det = build_detector(cfg, width, max_candidates=cap)
        if row_shard:
            # the normalized band is host-resident in this mode: rerun the
            # one overflowing block through the single-block entry
            blk = dense_from_band_host(band, start[i], width)
            out = det.fn_single(blk)
            return {k: np.asarray(a) for k, a in out.items()}
        nb = runner.nb if runner is not None else 1
        fl, il = det.fn_band_packed(band_dev, pack_starts([i], nb))
        return unpack_block(det.out_spec, np.asarray(fl[0]),
                            np.asarray(il[0]))

    def finish(idxs, out):
        # packed band path everywhere: 2 D2H per batch
        fh, ih = np.asarray(out[0]), np.asarray(out[1])
        get = lambda bi: unpack_block(detector.out_spec, fh[bi], ih[bi])
        for bi, i in enumerate(idxs):
            if i is None:     # rowshard pad slot
                continue
            block_out = get(bi)
            block_out = _maybe_regrow(
                block_out, cfg, lambda cap, i=i: rerun_block(i, cap))
            rows = finish_block(
                block_out, block_index=i, start=start[i], cfg=cfg,
                spec=detector.spec,
            )
            mask = masks[i]
            for r in rows:
                if r[0] >= start[i] + mask or r[1] >= start[i] + mask:
                    tagged.append((i, Loop(int(r[0]), int(r[1]),
                                           float(r[2]), float(r[3]))))

    if row_shard:
        batches = ((idxs, runner.run_rowshard(detector, band_dev, sl))
                   for idxs, sl in plan.launches(B // runner.nb))
    else:
        batches = (
            (idxs, launch(idxs)[1])
            for idxs in (list(range(b0, min(b0 + B, nblocks)))
                         for b0 in range(0, nblocks, B)))

    # software pipelining: densify+upload batch k+1 while batch k's outputs
    # are still being computed on device (jax dispatch is asynchronous)
    pending = None
    for launched in batches:
        if pending is not None:
            finish(*pending)
        pending = launched
    if pending is not None:
        finish(*pending)
    tagged.sort(key=lambda t: t[0])
    return [lp for _, lp in tagged]


def _maybe_regrow(block_out: dict, cfg: DetectionConfig, rerun) -> dict:
    """If the candidate table overflowed (more pixels below the q threshold
    than capacity), rerun this single block with a larger capacity.
    ``rerun``: callable ``(capacity) -> block_out`` re-detecting the block
    (lazy — the band fast path never materializes host blocks).

    Loops with geometric growth: the count-mode detector reports sig_count
    as the F(K+1) LOWER BOUND on overflow (exact when it fits), so one
    rerun is not guaranteed to fit; capacity at least doubles per round
    and sig_count <= band pixels, so the loop terminates."""
    cap = cfg.max_candidates
    while True:
        sig = int(block_out["sig_count"])
        if sig <= cap:
            return block_out
        cap = max(1 << (sig - 1).bit_length(), 2 * cap)
        block_out = rerun(cap)


def write_loops(path: str, per_chrom: Iterable[tuple[str, str, int, Sequence[Loop]]]):
    """Write the reference-format TSV (mustache.py:1082-1103)."""
    with open(path, "w") as fh:
        fh.write(
            "BIN1_CHR\tBIN1_START\tBIN1_END\tBIN2_CHROMOSOME\t"
            "BIN2_START\tBIN2_END\tFDR\tDETECTION_SCALE\n"
        )
        for chrom, chrom2, res, loops in per_chrom:
            for lp in loops:
                fh.write(lp.to_row(chrom, chrom2, res))


# Public convenience API ----------------------------------------------------

def find_loops(x, y, v, *, resolution: int = 5000, distance_bp: int = 2_000_000,
               pt: float = 0.2, st: float = 0.88, sigma0: float = 1.6,
               octaves: int = 2, precision: str = "float32",
               normalize: bool = True) -> list[Loop]:
    """One-call API: COO contact map in, loop calls out. The caller's
    arrays are left untouched (the engine normalizes a copy)."""
    from mustache_tpu.config import clamp_distance_filter

    cfg = DetectionConfig(
        resolution=resolution,
        distance_bp=clamp_distance_filter(distance_bp, resolution),
        pt=pt, st=st, sigma0=sigma0, octaves=octaves, precision=precision,
    )
    return detect_loops_coo(x, y, np.array(v, dtype=np.float64), cfg,
                            normalize=normalize)
