"""Single-block scale-space loop detection — the device compute core.

One jitted, vmappable function maps a dense contact block ``[N, N]`` to a
fixed-capacity candidate table. The algorithm reproduces the reference
detection semantics (mustache.py:697-850) step for step:

1. support mask ``nz`` = nonzero ∧ at least 4 off-diagonal, computed before
   sentinel fill;
2. sentinel value 2 on the near-diagonal wedge and beyond the distance band;
3. the full blur ladder evaluated as ONE batched separable convolution,
   then a rolling scan over DoG planes performing 3x3
   local-max NMS across space and scale — the reference's sequential
   "best response so far" update is an argmax-with-strict-> reduction,
   which the scan reproduces exactly;
4. per-plane exponential tail fit (closed-form MLE: loc=min, scale=mean-min)
   with p-values carried in log space (f32-safe down to exp(-inf));
5. Benjamini-Hochberg FDR on device via sort + reverse-cummin, log space;
6. candidate selection (all pixels with q < pt, via top_k);
7. sparsity filter via an integral image of ``nz`` (the reference's
   per-candidate window loops become 8 gathers), including numpy's
   negative-slice-start => empty-window semantics;
8. enrichment filter: candidate value > 2 * nonzero-mean of its diagonal
   (diagonal means computed by a shear gather + masked column reduction);
9. the 8-neighborhood q/scale values are exported so the host can finish
   the reference's connected-component clustering bit-compatibly.

Detection scales are exported as plane indices, so the driver can print
float64 sigma values identical to the reference's output strings.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Any, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from mustache_tpu.config import DetectionConfig
from mustache_tpu.scalespace import LadderSpec, build_ladder

SENTINEL = 2.0        # fills the masked wedges; participates in the blurs
LOG2 = math.log(2.0)  # log-space image of the "untested" marker q=2

# BH strategy in _band_candidates: "count" (default — cutoff by count
# fixed-point + top_k of the significant set; no full-array sort) or
# "sort" (the round-3 full key+index sort; exact-q export for
# non-significant neighbors, which emission never uses). Both produce
# identical loop calls; see the derivation at the use site.
_BH_MODE = os.environ.get("MUSTACHE_TPU_BH", "count")


def band_width(n: int, d_px: int) -> int:
    """Diagonal-band width: data rows (d <= d_px+1 after the ingest
    distance filters) + stencil halo, rounded up to a multiple of 128.
    One formula shared by _BandGeom and the chromosome-band transfer
    layout."""
    return min(-(-min(d_px + 4, n) // 128) * 128, n)


def dense_from_band(band_blk):
    """Dense [N, N] block from its band image band[i, d] = dense[i, i+d].

    Inverse of ``_BandGeom.shear`` via the same flat [N, N+1] reinterpret:
    cell (i, d) of the widened band sits at flat index i*(N+1)+d =
    i*N + (i+d), i.e. dense (i, i+d). Band cells that would fall beyond
    dense column N-1 (block-truncated tails and the zero pad) wrap into the
    *lower triangle* of the next row, which the sentinel fill overwrites
    before anything reads it — so the reconstruction is exact without any
    masking (matches pipeline.densify_block bit for bit)."""
    N, Dl = band_blk.shape
    wide = jnp.pad(band_blk, ((0, 0), (0, N + 1 - Dl)))
    return wide.reshape(-1)[: N * N].reshape(N, N)


# ---------------------------------------------------------------------------
# device-side pieces
# ---------------------------------------------------------------------------

def _max3x3(x):
    """scipy ``maximum_filter(footprint=ones(3,3), mode='constant')``:
    3x3 window max with zero padding at the borders.

    Separable shifted-max formulation (rows then cols) — plain
    elementwise maxima, which XLA fuses without a reduce_window.
    """
    xp = jnp.pad(x, ((1, 1), (0, 0)), mode="constant", constant_values=0)
    r = jnp.maximum(jnp.maximum(xp[:-2], xp[1:-1]), xp[2:])
    rp = jnp.pad(r, ((0, 0), (1, 1)), mode="constant", constant_values=0)
    return jnp.maximum(jnp.maximum(rp[:, :-2], rp[:, 1:-1]), rp[:, 2:])


def _blur_ladder(c, kernels):
    """All S Gaussian blurs of ``c`` as one batched separable convolution.

    ``c``: [N, N] or [M, N, N] (M independent maps). ``kernels``: [S, W]
    zero-padded to the common radius R=(W-1)//2. Symmetric (scipy
    'reflect') padding by R once, then two VALID passes: axis 0 (rows)
    producing S channels, then a depthwise axis-1 pass. Returns [S, N, N]
    or [M, S, N, N].
    """
    single = c.ndim == 2
    if single:
        c = c[None]
    M = c.shape[0]
    N = c.shape[1]
    S, W = kernels.shape
    R = (W - 1) // 2
    cpad = jnp.pad(c, ((0, 0), (R, R), (R, R)), mode="symmetric")
    k_rows = kernels[:, None, :, None]            # [S, 1, W, 1]
    k_cols = kernels[:, None, None, :]            # [S, 1, 1, W]

    def pass1(lhs):                               # [m, 1, rows+2R, N+2R]
        return lax.conv_general_dilated(
            lhs, k_rows, (1, 1), "VALID",
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            precision=lax.Precision.HIGHEST,
        )

    def pass2(g):                                 # [m, S, rows, N+2R]
        return lax.conv_general_dilated(
            g, k_cols, (1, 1), "VALID",
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            feature_group_count=S,
            precision=lax.Precision.HIGHEST,
        )

    # the [M, S, N, N] output plus the convolution's scratch grows with
    # N^2 * S; above ~2000 rows (or for multi-map stacks) large inputs run
    # the convolution in row slabs (a sequential loop bounds the live
    # scratch to one slab). What this split costs on the card is an open
    # question (ROADMAP).
    if N <= 2048 and M == 1:
        g = pass2(pass1(cpad[:, None]))           # [M, S, N, N]
        return g[0] if single else g

    SLAB = 512
    nslab = -(-N // SLAB)
    pad_rows = nslab * SLAB - N
    cpad = jnp.pad(cpad, ((0, 0), (0, pad_rows), (0, 0)))

    # accumulate slabs by dynamic_update_slice into a row-major buffer
    # (no moveaxis transpose of a stacked lax.map result)
    def body(k, acc):
        rows = lax.dynamic_slice_in_dim(cpad, k * SLAB, SLAB + 2 * R,
                                        axis=1)
        out = pass2(pass1(rows[:, None]))         # [M, S, SLAB, N]
        return lax.dynamic_update_slice_in_dim(acc, out, k * SLAB, axis=2)

    # seed the accumulator from the input (cpad * 0 scalar) so its vma
    # type is varying wherever cpad is varying under shard_map — a
    # replicated zeros literal fails fori_loop carry typing there
    acc0 = jnp.zeros((M, S, nslab * SLAB, N), cpad.dtype) \
        + cpad.reshape(-1)[0] * 0
    g = lax.fori_loop(0, nslab, body, acc0)
    g = g[:, :, :N]
    return g[0] if single else g


def _bh_logq(logp_flat, n_tested):
    """Benjamini-Hochberg in log space over a fixed-size vector.

    Untested entries carry +inf and sort to the tail where they cannot
    influence the reverse cummin. Matches statsmodels fdr_bh:
    q_i = cummin_{j>=i}(p_(j) * n / j), clipped at 1 (=0 in log space).
    """
    sp, qs = _bh_sorted_logq(logp_flat, n_tested)
    order = jnp.argsort(logp_flat)
    return jnp.zeros_like(logp_flat).at[order].set(qs)


def _bh_sorted_logq(logp_flat, n_tested):
    """BH without the scatter: returns ``(sp, qs)`` — the ascending-sorted
    log p keys and the BH log-q in the same sorted order.

    The hot path sorts KEYS ONLY (no index payload) and recovers any
    pixel's q later by binary search (``_bh_lookup``): BH assigns equal q to equal p (the suffix cummin flattens rank ties), so
    a value lookup is exact. Ranks come from an integer iota — exact at
    any length, unlike an f32 cumsum of ones which saturates at 2^24
    elements (reachable at 1kb resolution with wide bands).
    """
    sp = jnp.sort(logp_flat)
    return sp, _logq_from_sorted(sp, n_tested)


def _suffix_cummin(a):
    """Reverse cummin over a flat vector, two-level (exact: min is
    associative). Splitting into 128-wide segments turns 16 of the 23
    log-doubling passes into passes over the 64x-smaller segment-min
    vector: strictly less device-memory traffic."""
    n = a.shape[0]
    SEG = 128
    if n % SEG or n <= 4 * SEG:
        return lax.cummin(a, axis=0, reverse=True)
    a2 = a.reshape(n // SEG, SEG)
    tail = lax.cummin(a2, axis=1, reverse=True)   # within-segment suffix
    carry = lax.cummin(tail[:, 0], axis=0, reverse=True)
    pinf = jnp.full((1,), np.inf, a.dtype)
    carry = jnp.concatenate([carry[1:], pinf])    # min over LATER segments
    return jnp.minimum(tail, carry[:, None]).reshape(n)


def _logq_from_sorted(sp, n_tested):
    dtype = sp.dtype
    ranks = (lax.iota(jnp.int32, sp.shape[0]) + 1).astype(dtype)
    q = sp + jnp.log(n_tested.astype(dtype)) - jnp.log(ranks)
    q = _suffix_cummin(q)
    return jnp.minimum(q, 0.0)


def _bh_lookup(sp, qs, vals):
    """q-value lookup by log-p value (exact under ties, see above); a
    binary search instead of a one-scatter position map over the full
    sorted vector."""
    pos = jnp.clip(jnp.searchsorted(sp, vals, method="scan_unrolled"),
                   0, sp.shape[0] - 1)
    return qs[pos]


def _pack_batched(out: dict):
    """Pack a batched output dict into two arrays — one for float leaves,
    one for int/bool leaves (value-cast to int32) — so a batch's results
    cross the host link as TWO transfers instead of one per leaf (~13
    single-map / ~34 differential leaves, each a D2H with its own fixed
    latency). Layout must match :func:`_out_spec` (both walk
    keys in sorted order)."""
    fparts, iparts = [], []
    B = next(iter(out.values())).shape[0]
    for k in sorted(out):
        a = out[k]
        flat = a.reshape(a.shape[0], -1)
        if jnp.issubdtype(a.dtype, jnp.floating):
            fparts.append(flat)
        else:
            iparts.append(flat.astype(jnp.int32))
    # a detector variant with no float (or no int) leaves still packs: emit
    # a [B, 0] placeholder so the concatenate never sees an empty list
    fparts = fparts or [jnp.zeros((B, 0), jnp.float32)]
    iparts = iparts or [jnp.zeros((B, 0), jnp.int32)]
    return jnp.concatenate(fparts, axis=1), jnp.concatenate(iparts, axis=1)


def _out_spec(shapes: dict):
    """Host-side layout for :func:`_pack_batched`:
    ``key -> (shape, dtype, buffer, offset, size)`` with per-block shapes
    (no batch dim). Int values survive the int32 buffer exactly (they are
    indices/counts/flags, all within int32); floats keep their own width."""
    spec = {}
    offs = {"f": 0, "i": 0}
    for k in sorted(shapes):
        s = shapes[k]
        size = int(np.prod(s.shape, dtype=np.int64)) if s.shape else 1
        buf = "f" if np.issubdtype(s.dtype, np.floating) else "i"
        spec[k] = (s.shape, s.dtype, buf, offs[buf], size)
        offs[buf] += size
    return spec


def unpack_block(spec, frow, irow):
    """Rebuild one block's output dict from its packed rows (host side)."""
    out = {}
    for k, (shape, dtype, buf, off, size) in spec.items():
        row = frow if buf == "f" else irow
        a = row[off:off + size].reshape(shape)
        out[k] = a if a.dtype == dtype else a.astype(dtype)
    return out


def _box_counts_band(cs_flat, x, y, s, smax: int, N: int, Dl: int):
    """Window sums of ``nz`` over [x-s, x+s+1) x [y-s, y+s+1) with numpy
    slice semantics — negative start => empty (count 0), overruns clamp
    (mustache.py:800-810) — evaluated on the BAND.

    The dense 2-D integral image this replaces cost two cumsums over the
    [B, N, N] dense mask (~0.5 GB of i32 at the 1kb shape, ~1 GB/launch
    of device-memory traffic); the band needs only a per-column INCLUSIVE
    prefix ``cs[i, d] = #{i' <= i : nz[i', i'+d]}`` (cumsum over [N, Dl], no
    zero-row pad — the take indices shift by one instead, saving a
    full-band copy). A dense axis-aligned box decomposes by diagonal:
    column d contributes rows ``[max(x-s, y-s-d), min(x+s, y+s-d)]`` — at
    most ``4*smax+1`` columns, gathered for all candidates in two flat
    takes. Band cells with i+d >= N are False in the mask, so row clamps
    at N are safe."""
    L = 4 * smax + 1
    rel = jnp.arange(-2 * smax, 2 * smax + 1, dtype=jnp.int32)[None, :]
    x_ = x[:, None]
    y_ = y[:, None]
    s_ = s[:, None]
    d = (y_ - x_) + rel                                   # [K, L]
    lo = jnp.maximum(x_ - s_, y_ - s_ - d)
    hi1 = jnp.minimum(x_ + s_, y_ + s_ - d) + 1           # exclusive
    lo_c = jnp.clip(lo, 0, N)
    hi_c = jnp.clip(hi1, 0, N)
    dc = jnp.clip(d, 0, Dl - 1)
    valid = (d >= 0) & (d < Dl) & (hi_c > lo_c) & (jnp.abs(rel) <= 2 * s_)
    hi_t = jnp.take(cs_flat, jnp.maximum(hi_c - 1, 0) * Dl + dc)
    lo_t = jnp.take(cs_flat, jnp.maximum(lo_c - 1, 0) * Dl + dc)
    cnt = (jnp.where(hi_c > 0, hi_t, 0)
           - jnp.where(lo_c > 0, lo_t, 0))
    total = jnp.sum(jnp.where(valid, cnt, 0), axis=1)
    empty = ((x - s) < 0) | ((y - s) < 0)
    return jnp.where(empty, 0, total)


@dataclasses.dataclass(frozen=True)
class BlockDetector:
    """Compiled detector for a fixed block size / config."""

    cfg: DetectionConfig
    spec: LadderSpec
    n: int
    _fn: Any         # jitted ([B, N, N], st, log_pt) -> dict of arrays
    _fn_single: Any  # jitted ([N, N], st, log_pt) -> dict of arrays
    _fn_band: Any    # jitted ([rows, Dl] band, [B] starts, st, log_pt)
    _fn_band_packed: Any  # fn_band with _pack_batched outputs
    out_spec: Any    # _out_spec layout for unpack_block

    @property
    def _scalars(self):
        dt = np.float64 if self.cfg.precision == "float64" else np.float32
        return dt(self.cfg.st), dt(math.log(self.cfg.pt))

    def fn(self, blocks):
        st, lp = self._scalars
        return self._fn(blocks, st, lp)

    def fn_single(self, block):
        st, lp = self._scalars
        return self._fn_single(block, st, lp)

    def fn_band(self, band, starts):
        """Batch detection from a device-resident chromosome band
        (band[i, d] = map[i, i+d], rows >= max(starts)+N): each start is
        sliced and densified on device."""
        st, lp = self._scalars
        return self._fn_band(band, starts, st, lp)

    def fn_band_packed(self, band, starts):
        """``fn_band`` with the outputs packed into (floats, ints) device
        buffers — ONE D2H per buffer instead of one per output leaf; host
        side rebuilds each block's dict with ``unpack_block(out_spec,
        floats[bi], ints[bi])``."""
        st, lp = self._scalars
        return self._fn_band_packed(band, starts, st, lp)

    def __call__(self, blocks):
        return self.fn(blocks)


def _preamble(c, d_px, intra):
    """Support mask + sentinel fill (mustache.py:699-706)."""
    dtype = c.dtype
    N = c.shape[0]
    # index arrays derived lazily from traced zeros (kept in the graph,
    # not baked as eager device constants)
    rows_np = np.arange(N, dtype=np.int32)
    diag = (jnp.zeros_like(c, dtype=jnp.int32)
            + rows_np[None, :] - rows_np[:, None])   # y - x
    nz = (c != 0) & (diag >= 4)
    nz_count = jnp.sum(nz, dtype=jnp.int32)
    sent = dtype.type(SENTINEL)
    c = jnp.where(diag <= 4, sent, c)
    if intra:
        c = jnp.where(diag >= d_px + 1, sent, c)
    return c, nz, nz_count


class _BandGeom:
    """Band-space geometry + shear/stencil helpers for one [N, N] map.

    After the convolution everything lives on the diagonal band:
    band[i, d] <-> dense[i, i+d]. Data only exists for 0 <= y-x <= d_px+1
    (the ingest distance filter), so the NMS scan, BH sort, selection,
    and filters all touch 5-20x fewer pixels than the dense [N, N] map.
    Width = data rows + stencil halo, rounded up to a multiple of 128
    (:func:`band_width`). Shared by the single-map and
    differential detection cores.
    """

    def __init__(self, c, d_px):
        N = c.shape[0]
        self.N = N
        self.dtype = c.dtype
        self.Dl = Dl = band_width(N, d_px)
        self.band_dl = (jnp.zeros_like(c[:, :Dl], dtype=jnp.int32)
                        + np.arange(Dl, dtype=np.int32)[None, :])
        self.band_il = (jnp.zeros_like(self.band_dl)
                        + np.arange(N, dtype=np.int32)[:, None])
        self.band_yl = self.band_il + self.band_dl
        self.band_validl = self.band_yl < N

    def shear(self, dense, fill):
        """band[i, d] = dense[i, i+d] via the flat [N, N+1] reinterpret
        trick (row i of the widened view starts one element later per row,
        which walks the diagonals) — a strided read, no gather."""
        N = self.N
        flat = dense.reshape(-1)
        ext = jnp.concatenate([flat, flat[:N]])
        b = ext[: N * (N + 1)].reshape(N, N + 1)[:, :self.Dl]
        return jnp.where(self.band_validl, b, fill)

    @staticmethod
    def _shift2(a, di, dd):
        """a[i+di, d+dd], zero-filled outside the array."""
        out = a
        if di > 0:
            out = jnp.concatenate([out[di:], jnp.zeros_like(out[:di])], 0)
        elif di < 0:
            out = jnp.concatenate([jnp.zeros_like(out[di:]), out[:di]], 0)
        if dd > 0:
            out = jnp.concatenate([out[:, dd:], jnp.zeros_like(out[:, :dd])], 1)
        elif dd < 0:
            out = jnp.concatenate([jnp.zeros_like(out[:, dd:]), out[:, :dd]], 1)
        return out

    def max3x3_band(self, Lb):
        """Dense 3x3 constant-0 maximum filter, evaluated in band coords:
        dense (x+dx, y+dy) = band (i+dx, d-dx+dy); taps outside the dense
        matrix contribute the 0 pad. Only rows [3, d_px+2] are exact (the
        halo needed by the detection rows); outer rows are never read."""
        N = self.N
        m = None
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                term = self._shift2(Lb, dx, dy - dx)
                yv = self.band_yl + dy
                valid = ((self.band_il + dx >= 0) & (self.band_il + dx < N)
                         & (yv >= 0) & (yv < N))
                term = jnp.where(valid, term, Lb.dtype.type(0.0))
                m = term if m is None else jnp.maximum(m, term)
        return m


def _band_candidates(geom: _BandGeom, *, band_logp, band_sigidx, band_nz,
                     band_c, ceil_table, ceil_max: int, st, log_pt, K,
                     extras=()):
    """Fixed-capacity candidate table from band-space detection state:
    BH FDR, selection, sparsity/enrichment filters, and the exported 3x3
    neighborhoods for host-side clustering (mustache.py:774-841 /
    diff_mustache.py:428-561 semantics).

    ``extras``: tuples ``(name, band_arr, inside_fill, outside_fill)``; each
    is exported as ``neigh_<name>`` over the candidate neighborhoods, with
    ``inside_fill`` at in-matrix cells outside the band and ``outside_fill``
    at out-of-matrix cells (the differential core carries pair p-values and
    best DoG responses this way).
    """
    dtype = band_logp.dtype
    pinf = dtype.type(np.inf)
    N, Dl = geom.N, geom.Dl

    found = band_nz & (band_logp < pinf)
    n_tested = jnp.sum(found, dtype=jnp.int32)
    if _BH_MODE == "sort":
        keys = jnp.where(found, band_logp, pinf)  # +inf = untested marker
        kf = keys.reshape(-1)
        # Fallback (MUSTACHE_TPU_BH=sort): ONE stable key+index sort serves
        # both BH and selection: qs[:K] / sidx[:K] are the K smallest-p
        # pixels (row-major stable on ties like the reference argsort,
        # mustache.py:792) with their q-values. BH q is non-decreasing
        # along the p-sorted order, so the K smallest-p pixels are a
        # superset of every q < pt pixel whenever sig_count <= K (the
        # regrow contract guarantees that).
        sp_full, sidx = lax.sort((kf, lax.iota(jnp.int32, kf.shape[0])),
                                 num_keys=1)
        qs_full = _logq_from_sorted(sp_full, n_tested)
        sig_count = jnp.sum(qs_full < log_pt, dtype=jnp.int32)
        cand_logq = qs_full[:K]
        flat_idx = sidx[:K]
        look_sp, look_qs = sp_full, qs_full
        in_table = None
    else:
        # Default: BH with NEITHER the full-array sort NOR full-array
        # count passes. Write F(k) = #{i : log p_i + log n < log pt +
        # log k}; the step-up cutoff k* is F's largest fixed point, and
        # k* > K  <=>  F(K+1) >= K+1 (F is monotone: if F(K+1) >= K+1 the
        # iteration from M never drops below K+1; conversely k* >= K+1
        # gives F(K+1) >= F at a point below a fixed point >= K+1). So ONE
        # O(M) count pass decides overflow, and in the no-overflow case
        # the marked set {i : F-condition at K+1} has size F(K+1) <= K, is
        # a SUPERSET of the significant set, and every suffix term the BH
        # cummin can attain for a significant pixel lies inside it (terms
        # at ranks > k* are all >= log pt) — so q for every significant
        # pixel is bit-identical to the full-sort computation, from a
        # K-sized table. Extraction of the marked set without a full-array
        # top_k: count marks per 128-element chunk (the same
        # single pass), top_k the <= K nonempty CHUNKS (tiny [G] array),
        # gather their rows, and select within the K*128 gathered slots.
        # On overflow the table is discarded and the block regrows
        # (pipeline._maybe_regrow loops, growing capacity geometrically);
        # sig_count is then the F(K+1) lower bound, exact otherwise.
        # No materialized key array: the count pass, the chunk gather, and
        # the neighbor lookups all read band_logp/band_nz directly (the
        # where-folded key view fuses into each consumer instead of a
        # materialized [N*Dl] f32 array)
        LCH = 128
        M = N * Dl
        Mp = -(-M // LCH) * LCH
        G = Mp // LCH
        lp_flat = band_logp.reshape(-1)
        nz_flat = band_nz.reshape(-1)
        if Mp != M:     # tiny/odd test shapes only: Dl is 128-aligned at
            lp_flat = jnp.pad(lp_flat, (0, Mp - M),      # production sizes
                              constant_values=np.inf)
            nz_flat = jnp.pad(nz_flat, (0, Mp - M))
        # mark threshold in log-p space: lp < log pt + log(K+1) - log n
        cthr = log_pt + dtype.type(np.log(K + 1)) \
            - jnp.log(n_tested.astype(dtype))
        marks = (nz_flat & (lp_flat < cthr)).reshape(G, LCH)
        cnt = jnp.sum(marks, axis=1, dtype=jnp.int32)         # [G]
        total1 = jnp.sum(cnt)                                 # F(K+1)
        # nonempty chunks, ascending chunk index (iota keys; ties none)
        Kc = min(K, G)
        ckey = jnp.where(cnt > 0, G - lax.iota(jnp.int32, G), 0)
        cval, cidx = lax.top_k(ckey, Kc)
        valid_chunk = cval > 0
        rows = jnp.where(nz_flat.reshape(G, LCH)[cidx],
                         lp_flat.reshape(G, LCH)[cidx], pinf)  # [Kc, LCH]
        flat = cidx[:, None] * LCH + lax.iota(jnp.int32, LCH)[None, :]
        markg = (rows < cthr) & valid_chunk[:, None]
        # K smallest-p marked elements; gathered order is ascending flat
        # index (chunks ascending x slots ascending), so the lex re-sort
        # below reproduces the reference argsort's stable row-major ties
        K_sel = min(K, Kc * LCH)
        ext_vals, ext_pos = lax.top_k(
            jnp.where(markg, -rows, dtype.type(-np.inf)).reshape(-1), K_sel)
        ext_idx = flat.reshape(-1)[ext_pos]
        sp, flat_idx = lax.sort((-ext_vals, ext_idx.astype(jnp.int32)),
                                num_keys=2)
        qs = _logq_from_sorted(sp, n_tested)
        if K_sel < K:
            pad = K - K_sel
            sp = jnp.concatenate([sp, jnp.full((pad,), pinf, dtype)])
            qs = jnp.concatenate([qs, jnp.zeros((pad,), dtype)])
            flat_idx = jnp.concatenate(
                [flat_idx, jnp.zeros((pad,), jnp.int32)])
        kstar_tbl = jnp.sum(qs < log_pt, dtype=jnp.int32)
        # exact when <= K; the F(K+1) >= K+1 lower bound on overflow
        # (enough to trigger and geometrically size the regrow)
        sig_count = jnp.where(total1 > K, jnp.maximum(total1, K + 1),
                              kstar_tbl)
        cand_logq = qs
        look_sp, look_qs = sp, qs
        in_table = jnp.minimum(total1, K)
    cand_valid = cand_logq < log_pt
    cx = (flat_idx // Dl).astype(jnp.int32)
    cd = (flat_idx % Dl).astype(jnp.int32)
    cy = cx + cd

    band_sigidx = jnp.where(band_nz, band_sigidx, -1)
    cand_sigidx = band_sigidx.reshape(-1)[flat_idx]

    # sparsity filter via per-column prefix sums of the band support
    # (see _box_counts_band — replaces the dense 2-D integral image).
    # INCLUSIVE cumsum, no zero-row pad: the pad was a full-band copy;
    # _box_counts_band shifts its take indices instead.
    cs_flat = jnp.cumsum(band_nz.astype(jnp.int32), axis=0).reshape(-1)
    s1 = jnp.where(cand_sigidx >= 0,
                   jnp.take(ceil_table, jnp.maximum(cand_sigidx, 0)), 1)
    c1 = (_box_counts_band(cs_flat, cx, cy, s1, ceil_max, N, Dl)
          .astype(dtype) / ((2 * s1 + 1) ** 2).astype(dtype))
    s2 = 2 * s1
    c2 = (_box_counts_band(cs_flat, cx, cy, s2, 2 * ceil_max, N, Dl)
          .astype(dtype) / ((2 * s2 + 1) ** 2).astype(dtype))
    pass_sparse = (cx != 0) & ~((c1 < st) | (c2 < 0.6))

    # enrichment filter: candidate > 2 * nonzero-mean of its diagonal,
    # computed on the sentinel-filled map (mustache.py:816-828). Band
    # column d IS diagonal d, so this is a masked column mean.
    occupied = geom.band_validl & (band_c != 0)
    dmeans = (jnp.sum(jnp.where(occupied, band_c, 0), axis=0)
              / jnp.sum(occupied, axis=0).astype(dtype))  # NaN when empty
    cand_mean = dmeans[jnp.clip(cd, 0, Dl - 1)]
    cand_c = band_c.reshape(-1)[flat_idx]
    pass_enrich = cand_c > 2 * cand_mean      # NaN mean => False

    cand_pass = cand_valid & pass_sparse & pass_enrich

    # 8-neighborhood q/scale export for host-side clustering. Dense
    # neighbor (x+dx, y+dy) sits at band (x+dx, d+dy-dx); tested neighbors
    # get their BH q, untested support cells the q=2
    # marker, in-matrix cells beyond the band q=1 (log 0), and cells
    # outside the matrix +inf (cannot win the component argmin).
    offs = np.array([-1, 0, 1], np.int32)
    nx = jnp.broadcast_to(cx[:, None, None] + offs[None, :, None], (K, 3, 3))
    ny = jnp.broadcast_to(cy[:, None, None] + offs[None, None, :], (K, 3, 3))
    nd = ny - nx
    inside = (nx >= 0) & (nx < N) & (ny >= 0) & (ny < N)
    in_band = inside & (nd >= 0) & (nd < Dl)
    nxc = jnp.clip(nx, 0, N - 1)
    ndc = jnp.clip(nd, 0, Dl - 1)
    # value lookup in the sorted table (BH q equal on tied p, so exact).
    # In count mode the table holds the marked superset of the significant
    # pixels; a tested neighbor beyond it resolves past the table and
    # takes the q=1 marker instead of its true q — emission-exact, because
    # the host argmin winner always has q < pt (every component contains a
    # passing candidate's center) and a >= pt neighbor can never win.
    # Every SIGNIFICANT pixel is in the table (or the launch regrows), so
    # any neighbor that could win resolves to its exact q.
    nb_val = jnp.where(found[nxc, ndc], band_logp[nxc, ndc], pinf)
    if in_table is None:
        nb_q = _bh_lookup(look_sp, look_qs, nb_val)
    else:
        # rank by direct compare-count against the K-entry table: one
        # fused [K, 3, 3, K] compare+reduce replaces the log-depth
        # searchsorted scan
        pos = jnp.sum(look_sp[None, None, None, :] < nb_val[..., None],
                      axis=-1, dtype=jnp.int32)
        nb_q = jnp.where(pos < in_table,
                         look_qs[jnp.clip(pos, 0, K - 1)], dtype.type(0.0))
    neigh_logq = jnp.where(
        in_band & found[nxc, ndc], nb_q,
        jnp.where(in_band & band_nz[nxc, ndc], dtype.type(LOG2),
                  jnp.where(inside, dtype.type(0.0), pinf)))
    neigh_sigidx = jnp.where(in_band, band_sigidx[nxc, ndc], -1)

    out = {
        "n_tested": n_tested,
        "sig_count": sig_count,
        "cand_x": cx,
        "cand_y": cy,
        "cand_logq": cand_logq,
        "cand_sigidx": cand_sigidx.astype(jnp.int16),
        "cand_pass": cand_pass,
        "cand_valid": cand_valid,
        "pass_sparse": pass_sparse,
        "pass_enrich": pass_enrich,
        "neigh_logq": neigh_logq,
        "neigh_sigidx": neigh_sigidx.astype(jnp.int16),
    }
    for name, arr, inside_fill, outside_fill in extras:
        out["neigh_" + name] = jnp.where(
            in_band, arr[nxc, ndc],
            jnp.where(inside, arr.dtype.type(inside_fill),
                      arr.dtype.type(outside_fill)))
    return out


def _detect_one(c, st, log_pt, *, kernels, det_ceil,
                planes_per_octave, n_octaves, d_px, intra, K):
    # st / log_pt are runtime scalars so threshold changes never recompile
    dtype = c.dtype
    st = st.astype(dtype)
    log_pt = log_pt.astype(dtype)
    pinf = dtype.type(np.inf)

    c, nz, nz_count = _preamble(c, d_px, intra)
    geom = _BandGeom(c, d_px)
    with jax.named_scope("blur_ladder"):
        G = _blur_ladder(c, kernels)              # [S, N, N]
        Gb = jax.vmap(lambda g: geom.shear(g, dtype.type(0.0)))(G)
    nzb = geom.shear(nz, False)
    nzbf = nzb.astype(dtype)
    inv_count = 1.0 / jnp.maximum(nz_count, 1).astype(dtype)
    max3x3_band = geom.max3x3_band

    best_v = jnp.zeros_like(nzbf)
    best_logp = jnp.full_like(nzbf, pinf)         # +inf == "never detected"
    best_sigidx = jnp.full_like(geom.band_dl, -1)

    def step(carry, xs):
        Lp, Lc, mP, mC, best_v, best_logp, best_sigidx = carry
        Ln, plane = xs
        mN = max3x3_band(Ln)
        abs_lc = jnp.abs(Lc)
        # exponential-tail MLE on |Lc[nz]|: loc=min, scale=mean-min
        loc = jnp.min(jnp.where(nzb, abs_lc, pinf))
        mean = jnp.sum(abs_lc * nzbf) * inv_count
        scale = mean - loc
        logp = -(abs_lc - loc) / scale            # log of the survival prob

        will = (
            nzb
            & (Lc > best_v)
            & (Lc == mC)
            & ((Lp == mP) | (Ln == mN))
            & (Lc > mP)
            & (Lc > mN)
        )
        best_v = jnp.where(will, Lc, best_v)
        best_logp = jnp.where(will, logp, best_logp)
        best_sigidx = jnp.where(will, plane, best_sigidx)
        return (Lc, Ln, mC, mN, best_v, best_logp, best_sigidx), None

    with jax.named_scope("dog_nms_scan"):
        bpo = planes_per_octave + 3   # blurs per octave (LadderSpec shape)
        for o in range(n_octaves):
            Go = Gb[o * bpo:(o + 1) * bpo]
            L = Go[:-1] - Go[1:]                  # [11, N, Dl]
            planes = np.arange(o * planes_per_octave,
                               (o + 1) * planes_per_octave, dtype=np.int32)
            carry = (L[0], L[1], max3x3_band(L[0]), max3x3_band(L[1]),
                     best_v, best_logp, best_sigidx)
            carry, _ = lax.scan(step, carry, (L[2:], planes))
            best_v, best_logp, best_sigidx = carry[4:]

    # lift the tiny ceil table into the graph via a traced zero (keeps it a
    # jaxpr literal instead of an eagerly-created device constant)
    ceil_table = nz_count * 0 + np.asarray(det_ceil, np.int32)
    with jax.named_scope("bh_epilogue"):
        out = _band_candidates(
            geom, band_logp=best_logp, band_sigidx=best_sigidx, band_nz=nzb,
            band_c=geom.shear(c, dtype.type(0.0)), ceil_table=ceil_table,
            ceil_max=int(np.max(det_ceil)), st=st, log_pt=log_pt, K=K)
    out["nz_count"] = nz_count
    return out


class DetectorParts(NamedTuple):
    """Compiled pieces of one block detector. Named fields (not a bare
    tuple) so call sites never positionally unpack a shape that can rot
    when a field is added."""
    spec: Any            # LadderSpec
    fn: Any              # jitted ([B, N, N], st, log_pt) -> dict
    fn_single: Any       # jitted ([N, N], st, log_pt) -> dict
    fn_band: Any         # jitted (band, starts, st, log_pt) -> dict
    fn_band_packed: Any  # fn_band + _pack_batched (2-buffer D2H)
    out_spec: Any        # _out_spec layout for unpack_block


@functools.lru_cache(maxsize=32)
def _build_detector_cached(octave_values: tuple, precision: str, d_px: int,
                           n: int, max_candidates: int) -> DetectorParts:
    spec = build_ladder(octave_values)
    dtype = jnp.float64 if precision == "float64" else jnp.float32
    kernels = spec.kernels.astype(dtype)  # numpy: lifted as an HLO literal
    kw = dict(
        det_ceil=spec.det_ceil,
        planes_per_octave=spec.planes_per_octave,
        n_octaves=len(octave_values),
        d_px=d_px,
        intra=True,
        K=max_candidates,
    )

    def one(c, st, log_pt):
        return _detect_one(c.astype(dtype), st, log_pt, kernels=kernels, **kw)

    def fn_base(blocks, st, log_pt):
        return jax.vmap(one, in_axes=(0, None, None))(blocks, st, log_pt)

    def fn_band_base(band, starts, st, log_pt):
        # chromosome band resident on device; each block is a dynamic row
        # slice + dense reconstruction — no per-batch H2D at all. Pad batch
        # slots carry start -1: their slice clamps to row 0, they are
        # computed like any block and discarded on the host
        slices = jax.vmap(
            lambda s: lax.dynamic_slice_in_dim(band, jnp.maximum(s, 0), n,
                                               axis=0))(starts)
        blocks = jax.vmap(dense_from_band)(slices)
        return fn_base(blocks, st, log_pt)

    fn = jax.jit(fn_base)
    fn_band = jax.jit(fn_band_base)
    fn_band_packed = jax.jit(
        lambda band, starts, st, lp: _pack_batched(
            fn_band_base(band, starts, st, lp)))
    fn_single = jax.jit(one)
    out_shapes = jax.eval_shape(
        one, jax.ShapeDtypeStruct((n, n), dtype),
        jax.ShapeDtypeStruct((), dtype), jax.ShapeDtypeStruct((), dtype))
    return DetectorParts(spec, fn, fn_single, fn_band, fn_band_packed,
                         _out_spec(out_shapes))


def require_x64(cfg: DetectionConfig):
    """float64 detection needs JAX's 64-bit mode; without it every f64
    array would silently be f32. The CLIs enable it for
    ``--engine-precision float64``; library callers set
    ``jax.config.update("jax_enable_x64", True)`` themselves."""
    if cfg.precision == "float64" and not jax.config.jax_enable_x64:
        raise ValueError("precision='float64' needs jax_enable_x64 "
                         "(jax.config.update('jax_enable_x64', True))")


def build_detector(cfg: DetectionConfig, n: int, *, intra: bool = True,
                   max_candidates: int | None = None) -> BlockDetector:
    if not intra:
        # the reference's inter-chromosomal path is non-functional
        # (mustache.py:689-694 references an undefined variable); the band
        # layout here additionally assumes the intra distance bound
        raise NotImplementedError("inter-chromosomal detection not supported")
    require_x64(cfg)
    # cache key holds only graph-shaping fields: thresholds are runtime args
    parts = _build_detector_cached(
        cfg.octave_values, cfg.precision, cfg.distance_px, n,
        max_candidates or cfg.max_candidates)
    return BlockDetector(cfg=cfg, spec=parts.spec, n=n, _fn=parts.fn,
                         _fn_single=parts.fn_single, _fn_band=parts.fn_band,
                         _fn_band_packed=parts.fn_band_packed,
                         out_spec=parts.out_spec)


# ---------------------------------------------------------------------------
# host-side finish: gates + connected-component clustering
# ---------------------------------------------------------------------------

def _cluster_components(cands: list[dict]) -> list[list[dict]]:
    """Group candidates whose painted 3x3 neighborhoods are 8-connected,
    i.e. candidates within Chebyshev distance 3 (mustache.py:830-841)."""
    parent = list(range(len(cands)))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    index: dict[tuple[int, int], int] = {}
    for i, cd in enumerate(cands):
        index[(cd["x"], cd["y"])] = i
    for i, cd in enumerate(cands):
        for dx in range(-3, 4):
            for dy in range(-3, 4):
                j = index.get((cd["x"] + dx, cd["y"] + dy))
                if j is not None and j != i:
                    union(i, j)

    groups: dict[int, list[dict]] = {}
    for i, cd in enumerate(cands):
        groups.setdefault(find(i), []).append(cd)
    return list(groups.values())


def finish_block(out: dict, *, block_index: int, start: int, cfg: DetectionConfig,
                 spec: LadderSpec) -> list[list[float]]:
    """Host-side finish of one block: bail-out gates, clustering, and the
    per-component argmin-q emission. Returns ``[x, y, q, sigma]`` rows in
    the same order the reference produces (component label order ==
    row-major order of each component's first painted pixel).
    """
    nz_count = int(out["nz_count"])
    if nz_count < cfg.min_nz:
        return []
    if nz_count < cfg.min_tested:
        return []

    passing = np.asarray(out["cand_pass"])
    if not passing.any():
        return []
    cx = np.asarray(out["cand_x"])[passing]
    cy = np.asarray(out["cand_y"])[passing]
    nlq = np.asarray(out["neigh_logq"])[passing]
    nsi = np.asarray(out["neigh_sigidx"])[passing]

    cands = [
        {"x": int(cx[i]), "y": int(cy[i]), "nlq": nlq[i], "nsi": nsi[i]}
        for i in range(len(cx))
    ]

    det_sigmas = spec.det_sigmas
    rows: list[tuple[tuple[int, int], list[float]]] = []
    for comp in _cluster_components(cands):
        # painted pixel set with the q/scale value at each pixel
        pixels: dict[tuple[int, int], tuple[float, int]] = {}
        for cd in comp:
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    px, py = cd["x"] + dx, cd["y"] + dy
                    lq = float(cd["nlq"][dx + 1, dy + 1])
                    si = int(cd["nsi"][dx + 1, dy + 1])
                    pixels[(px, py)] = (lq, si)
        ordered = sorted(pixels.items())  # row-major, np.argwhere order
        best = min(range(len(ordered)), key=lambda i: (ordered[i][1][0], i))
        (px, py), (lq, si) = ordered[best]
        q = float(np.exp(np.float64(lq)))
        sigma = det_sigmas[si] if si >= 0 else 1.0
        first_pixel = ordered[0][0]
        rows.append((first_pixel, [px + start, py + start, q, sigma]))

    rows.sort(key=lambda t: t[0])
    return [r for _, r in rows]
