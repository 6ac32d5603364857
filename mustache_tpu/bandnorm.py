"""On-device per-diagonal z-score normalization of the chromosome band.

The pipeline's transfer layout is the diagonal band ``band[i, d] =
map[i, i+d]`` — and diagonal ``d`` is simply column ``d`` of that array,
so the reference's per-diagonal moving-window statistics
(mustache.py:622-686, reimplemented host-side in
``mustache_tpu.normalize``) become column-wise cumulative sums on device:
upload the RAW counts band once, normalize it with one jitted call, and
feed the result straight to the detector. This removes every host-side
normalize pass from the hot path (the host only scatter-fills the raw
band).

Semantics match ``normalize.normalize_sparse`` for ingested data (finite
values, v > 0, unique (x, y) pairs — the ingest paths guarantee all
three). The two documented deviations, both unreachable from ingest:
entries with v == 0 are "occupied" for the host path (it scatters
v + 0.001) but not here, and the global regime's grouped statistics here
exclude non-finite/zero entries rather than zeroing them first.

f32 precision notes: window sums are computed on globally-centered values
(subtracting each diagonal's global mean turns the cumulative sums into
zero-drift random walks, so differencing them is stable), and XLA lowers
``cumsum`` to a logarithmic-depth associative scan whose rounding grows
like log2(n) — both keep the f32 z-scores within ~1e-5 of the host's
f64-accumulated values (tested in tests/test_bandnorm.py).
"""

from __future__ import annotations

import functools
import math

import numpy as np


def _winsum_fast(a, F: int, rows: int):
    """Column-wise moving-window sums, numpy-'same' centering, for columns
    whose true length is >= F. Clamps are free: the cumulative sum is flat
    wherever the data is zero-padded, and the low clamp lands on cs[0]=0.
    Pure static slices — no gathers."""
    import jax.numpy as jnp

    off = (F - 1) // 2
    cs = jnp.concatenate([jnp.zeros_like(a[:1]), jnp.cumsum(a, axis=0)], 0)
    # hi = cs[i + off + 1] for i in [0, rows): indices reach rows + off
    hi_src = jnp.concatenate(
        [cs, jnp.broadcast_to(cs[-1:], (off, cs.shape[1]))], 0)
    hi = hi_src[off + 1: off + 1 + rows]
    # lo = cs[max(i + off - F + 1, 0)]: negative indices clamp to cs[0]=0
    sh = off - F + 1  # <= 0
    lo = jnp.concatenate(
        [jnp.zeros((-sh, cs.shape[1]), a.dtype), cs[: rows + sh]], 0)
    return hi - lo


def _winsum_indices(Dl: int, F: int, rows: int, n: int):
    """Static gather indices for the short-column regime: numpy's
    centering swap (rows shorter than the window recentre at (len-1)//2)
    is a per-column offset. Computed ONCE per (shape, config) and shared
    by all three window-sum calls — int32, so the lowered graph carries
    two small constants instead of six [rows, Dl] int64 literals."""
    lend = np.clip(n - np.arange(Dl), 0, rows)
    offd = np.where(lend < F, (np.maximum(lend, 1) - 1) // 2, (F - 1) // 2)
    i = np.arange(rows)[:, None]
    hi_idx = np.clip(i + offd[None, :] + 1, 0, lend[None, :]).astype(np.int32)
    lo_idx = np.clip(i + offd[None, :] - F + 1, 0,
                     lend[None, :]).astype(np.int32)
    return hi_idx, lo_idx


def _winsum_general(a, hi_idx, lo_idx):
    """Window sums via precomputed per-cell cumsum gather indices
    (short-column regime; see _winsum_indices)."""
    import jax.numpy as jnp

    cs = jnp.concatenate([jnp.zeros_like(a[:1]), jnp.cumsum(a, axis=0)], 0)
    return (jnp.take_along_axis(cs, hi_idx, 0)
            - jnp.take_along_axis(cs, lo_idx, 0))


def _column_stats(band, occ, dtype):
    """Per-column mean/std over occupied cells of the raw band, with the
    host path's NaN guards (empty column -> mean 0, std 1), plus the
    p-value weight vector 1 + log30(1 + mean)."""
    import jax.numpy as jnp

    occf = occ.astype(dtype)
    cnt = jnp.sum(occf, axis=0)
    mean = jnp.sum(band, axis=0) / cnt                  # NaN when empty
    mean = jnp.where(jnp.isfinite(mean), mean, dtype.type(0.0))
    var = jnp.sum(jnp.where(occ, (band - mean[None, :]) ** 2,
                            dtype.type(0.0)), axis=0) / cnt
    std = jnp.sqrt(var)
    std = jnp.where(jnp.isfinite(std), std, dtype.type(1.0))
    weights = 1.0 + jnp.log1p(mean) / dtype.type(math.log(30.0))
    return mean, std, weights


def _normalize_band_local(band, *, n, F, Dv, rows, short_cols):
    """Local (windowed) regime: normalize.normalize_sparse's >2Mb branch
    evaluated column-wise on the band."""
    import jax.numpy as jnp

    dtype = band.dtype
    occ = band != 0
    mean_g, std_g, weights = _column_stats(band, occ, dtype)

    bandp = jnp.where(occ, band + dtype.type(0.001), dtype.type(0.0))
    mcol = mean_g + dtype.type(0.001)
    bc = jnp.where(occ, bandp - mcol[None, :], dtype.type(0.0))

    if short_cols:
        import jax.numpy as jnp

        hi_idx, lo_idx = _winsum_indices(band.shape[1], F, rows, n)
        hi_idx, lo_idx = jnp.asarray(hi_idx), jnp.asarray(lo_idx)
        win = functools.partial(_winsum_general, hi_idx=hi_idx,
                                lo_idx=lo_idx)
    else:
        win = functools.partial(_winsum_fast, F=F, rows=rows)
    cnt = win(occ.astype(dtype))
    s1c = win(bc)
    s2c = win(bc * bc)

    # identical algebra to the host path's raw sums: with the global-mean
    # centering, s2 - s1^2/cnt is invariant and lm = mcol + s1c/cnt
    lm = mcol[None, :] + s1c / cnt
    lv = (s2c - s1c * s1c / cnt) / (cnt - 1)
    gs2 = (std_g * std_g)[None, :]
    gm = mean_g[None, :]
    lv = jnp.where(jnp.isfinite(lv), lv, gs2)
    low = cnt < 30
    lm = jnp.where(low, gm, lm)
    lv = jnp.where(low, gs2, lv)
    lm = jnp.where(jnp.isfinite(lm), lm, gm)

    z = (bandp - lm) / jnp.sqrt(lv)
    z = jnp.where(jnp.isfinite(z), z, dtype.type(0.0))
    z = z * weights[None, :]

    dcol = np.arange(band.shape[1], dtype=np.int32)[None, :]
    out = jnp.where(occ & (dcol < Dv), z, band)
    # host contract (normalize_sparse): one weight per diagonal d < Dv
    return out, weights[:Dv]


def _normalize_band_global(band, *, dpx):
    """Global regime (small maps): plain per-diagonal z-score of the raw
    values for d < dpx; other cells keep their raw values."""
    import jax.numpy as jnp

    dtype = band.dtype
    occ = band != 0
    mean_g, std_g, _ = _column_stats(band, occ, dtype)
    z = (band - mean_g[None, :]) / std_g[None, :]
    z = jnp.where(jnp.isfinite(z), z, dtype.type(0.0))
    dcol = np.arange(band.shape[1], dtype=np.int32)[None, :]
    out = jnp.where(occ & (dcol < dpx), z, band)
    return out, jnp.zeros((0,), dtype)


def bucket_rows(rows: int, minimum: int = 512) -> int:
    """Round a band row count up the geometric bucket ladder (ratio 9/8,
    8-aligned). Chromosome lengths are arbitrary; bucketing them bounds the
    number of distinct band shapes a genome-wide run compiles — and lets a
    warmup pass enumerate every shape a run could need — at the cost of
    <= 12.5% zero-pad rows (pads are unoccupied, so normalization and
    detection are invariant to them; tested in tests/test_bandnorm.py)."""
    b = minimum
    while b < rows:
        b = -(-b * 9 // 8 // 8) * 8
    return b


def _norm_key(rows: int, Dl: int, n: int, resolution: int,
              distance_in_px: int):
    """Canonical compile key for the normalize graph: collapses the
    chromosome length n down to the fields that actually shape the lowered
    HLO, so same-bucket chromosomes share one compile (and one persistent
    cache entry). n survives in the key only in the short-column regime,
    where the centering-swap gather indices depend on it exactly."""
    local = (n - distance_in_px) * resolution > 2_000_000
    if local:
        F = int(2_000_000 / resolution)
        short_cols = n - (Dl - 1) < F
        return ("local", rows, Dl, F, min(2 + distance_in_px, n),
                n if short_cols else -1)
    return ("global", rows, Dl, min(distance_in_px, n))


@functools.lru_cache(maxsize=64)
def _build_norm_fn(key: tuple, donate: bool = True):
    import jax

    import jax.numpy as jnp

    if key[0] == "local":
        _, rows, Dl, F, Dv, n_exact = key
        short_cols = n_exact >= 0
        # the fast (long-column) regime never reads n: pass rows, which
        # keeps the closure free of the exact chromosome length
        inner = functools.partial(_normalize_band_local,
                                  n=(n_exact if short_cols else rows),
                                  F=F, Dv=Dv, rows=rows,
                                  short_cols=short_cols)
    else:
        inner = functools.partial(_normalize_band_global, dpx=key[3])

    def fn(band):
        # compact-transfer path: mostly-integer counts upload as uint8 /
        # uint16 (4x / 2x fewer H2D bytes than f32) and widen here —
        # lossless for integer values below the dtype limit. Exception
        # scatters happen in their own tiny graph (_build_exc_fn) so this
        # graph's shape set stays warmup-enumerable.
        if band.dtype in (jnp.uint8, jnp.uint16):
            band = band.astype(jnp.float32)
        return inner(band)

    # donate: the raw band is dead after this call (2GB at 1kb genome scale).
    # f32-path only — a donated narrow-integer buffer can't back the f32
    # output, so the caller disables donation for compact transfers (avoids
    # XLA's 'donated buffer was not usable' warning on every compile).
    return jax.jit(fn, donate_argnums=(0,) if donate else ())


def pad_exceptions(exc, rows: int):
    """Pad a (rows, cols, values) exception triple to a power-of-two bucket
    so recompiles are bounded; pad slots scatter out of bounds (row index
    ``rows``) and are dropped by the device scatter."""
    r, c, v = (np.asarray(e) for e in exc)
    ne = len(r)
    bucket = max(16, 1 << max(ne - 1, 0).bit_length())
    pr = np.full(bucket, rows, np.int32)
    pc = np.zeros(bucket, np.int32)
    pv = np.zeros(bucket, np.float32)
    pr[:ne] = r
    pc[:ne] = c
    pv[:ne] = v
    return pr, pc, pv


@functools.lru_cache(maxsize=32)
def _build_exc_fn(rows: int, Dl: int, dtype_name: str, bucket: int,
                  packed4: bool = False):
    """Tiny widen+scatter graph, SEPARATE from the normalize graph: the
    exception-list bucket is data-dependent (pow2 of the misfit count),
    and fusing it into the normalize graph made every new bucket a full
    normalize recompile — one the warmup pass cannot enumerate. Split
    out, the normalize graph has ONE warmable shape per band geometry and
    the per-bucket cost is this trivial scatter (sub-second compile).

    ``packed4``: the band arrives as [rows, Dl//2] uint8 holding two
    4-bit counts per byte (even logical column in the low nibble); the
    graph unpacks to f32 before scattering. ``bucket`` 0 = no exception
    list (unpack only)."""
    import jax
    import jax.numpy as jnp

    def fn(band, exc_r=None, exc_c=None, exc_v=None):
        if packed4:
            lo = (band & jnp.uint8(0x0F)).astype(jnp.float32)
            hi = (band >> jnp.uint8(4)).astype(jnp.float32)
            band = jnp.stack([lo, hi], axis=-1).reshape(band.shape[0], -1)
        elif band.dtype in (jnp.uint8, jnp.uint16):
            band = band.astype(jnp.float32)
        if exc_r is None:
            return band
        # pad slots carry row index `rows` and are dropped
        return band.at[exc_r, exc_c].set(exc_v, mode="drop")

    return jax.jit(fn)


def normalize_band_device(band_raw, n: int, resolution: int,
                          distance_in_px: int, exceptions=None,
                          packed4: bool = False):
    """Normalize a raw chromosome band on device.

    ``band_raw``: [rows, Dl] raw counts band (host array or device array;
    host arrays are uploaded here), or [rows, Dl//2] uint8 nibble-packed
    when ``packed4`` (two counts per byte — half the H2D bytes again vs
    uint8 on link-bound transfers). ``exceptions``: optional PADDED
    (rows, cols, f32 values) triple (see :func:`pad_exceptions`) scattered
    over the widened band before normalizing — the compact-transfer path
    for mostly-integer data. Returns ``(band_norm, weights)`` device
    arrays; a float input buffer is donated.
    """
    import jax

    rows, Dl = band_raw.shape
    if packed4:
        Dl = 2 * Dl
    if not isinstance(band_raw, jax.Array):
        band_raw = jax.device_put(band_raw)
    if exceptions is not None or packed4:
        exc = tuple(e if isinstance(e, jax.Array) else jax.device_put(e)
                    for e in (exceptions or ()))
        band_raw = _build_exc_fn(
            rows, Dl, str(band_raw.dtype),
            int(exc[0].shape[0]) if exc else 0, packed4)(band_raw, *exc)
    donate = np.dtype(band_raw.dtype) not in (np.uint8, np.uint16)
    fn = _build_norm_fn(_norm_key(rows, Dl, n, resolution, distance_in_px),
                        donate)
    return fn(band_raw)
