"""Differential loop detection (two conditions), device core.

Reproduces ``diff_mustache`` semantics (diff_mustache.py:260-569): the
scale-space pyramid runs simultaneously on both normalized maps and their
difference map (joint support ``nz = nz1 & nz2``); per-map detections carry
an additional differential p-value — a two-sided folded normal tail of the
difference-map DoG response, fit ONCE PER OCTAVE on the octave's second
DoG plane over the joint support (the reference never rolls the
difference-map plane inside the scale loop, diff_mustache.py:337) —
recorded at each map's detection scale. Candidates pass per-map BH FDR, sparsity and
enrichment filters and clustering exactly as the single-map core, and a
loop is called differential when its component representative has
``pair < pt2`` and a larger best DoG response than the other condition.

Engine-wise the path shares the single-map machinery end to end: all three
ladders run as one batched separable convolution ([3, S, N, N]), everything
after the convolution lives on the diagonal band (NMS scan, BH sort,
selection, filters — see detect._BandGeom), blocks run as vmapped batches
with software-pipelined H2D, and candidate-table overflow triggers a
regrown rerun (the reference selects ALL pixels with q < pt,
diff_mustache.py:458,473 — truncation would silently drop loops).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from mustache_tpu.config import DetectionConfig
from mustache_tpu.detect import (
    SENTINEL, _BandGeom, _band_candidates, _blur_ladder, _cluster_components,
    _out_spec, _pack_batched, dense_from_band, require_x64, unpack_block,
)
from mustache_tpu.scalespace import LadderSpec, build_ladder


def _diff_detect_one(c1, c2, st, log_pt, *, kernels, det_ceil,
                     planes_per_octave, n_octaves, d_px, intra, K):
    dtype = c1.dtype
    st = st.astype(dtype)
    log_pt = log_pt.astype(dtype)
    N = c1.shape[0]
    sent = dtype.type(SENTINEL)
    rows_np = np.arange(N, dtype=np.int32)
    diag = (jnp.zeros_like(c1, dtype=jnp.int32)
            + rows_np[None, :] - rows_np[:, None])

    nz1 = (c1 != 0) & (diag >= 4)
    nz2 = (c2 != 0) & (diag >= 4)
    nzd = nz1 & nz2
    nz1_count = jnp.sum(nz1, dtype=jnp.int32)
    nz2_count = jnp.sum(nz2, dtype=jnp.int32)

    c1 = jnp.where(diag <= 4, sent, c1)
    c2 = jnp.where(diag <= 4, sent, c2)
    if intra:
        c1 = jnp.where(diag >= d_px + 1, sent, c1)
        c2 = jnp.where(diag >= d_px + 1, sent, c2)
    cd = jnp.where(nzd, c1 - c2, dtype.type(0.0))

    S = kernels.shape[0]
    bpo = planes_per_octave + 3   # blurs per octave (LadderSpec shape)
    # per-map ladders in full; the DIFFERENCE map needs only blur planes
    # 1..2 of each octave: the reference computes Lc = Gc - Gn once per
    # octave and never rolls it (diff_mustache.py:337 — the inner loop
    # reassigns Lc1/Lc2 but not Lc), so the folded-normal differential
    # p-value is FROZEN per octave
    sel = np.concatenate([[o * bpo + 1, o * bpo + 2]
                          for o in range(n_octaves)])
    geom = _BandGeom(c1, d_px)
    Dl = geom.Dl
    zerof = dtype.type(0.0)
    with jax.named_scope("blur_ladder"):
        Gdiff = _blur_ladder(cd, kernels[sel])          # [2*n_oct, N, N]
        G = _blur_ladder(jnp.stack([c1, c2]), kernels)  # [2, S, N, N]
        Gb = jax.vmap(lambda g: geom.shear(g, zerof))(
            G.reshape(2 * S, N, N)).reshape(2, S, N, Dl)
        Gdb = jax.vmap(lambda g: geom.shear(g, zerof))(Gdiff)

    pinf = dtype.type(np.inf)
    zero = dtype.type(0.0)

    nzb = {1: geom.shear(nz1, False), 2: geom.shear(nz2, False)}
    nzbd = geom.shear(nzd, False)
    nzbd_f = nzbd.astype(dtype)
    inv_nzd = (1.0 / jnp.maximum(jnp.sum(nzd, dtype=jnp.int32), 1)
               .astype(dtype))
    nzbf = {m: nzb[m].astype(dtype) for m in (1, 2)}
    inv_nz = {m: 1.0 / jnp.maximum(c, 1).astype(dtype)
              for m, c in ((1, nz1_count), (2, nz2_count))}

    def make_step(diff_p):
        def step(carry, xs):
            roll, st1, st2 = carry
            Ln1, Ln2, plane = xs
            new_roll = []
            new_states = []
            for m, st_m, Ln in ((1, st1, Ln1), (2, st2, Ln2)):
                Lp, Lc, mP, mC = roll[4 * (m - 1):4 * m]
                mN = geom.max3x3_band(Ln)
                abs_lc = jnp.abs(Lc)
                loc = jnp.min(jnp.where(nzb[m], abs_lc, pinf))
                mean = jnp.sum(abs_lc * nzbf[m]) * inv_nz[m]
                scale = mean - loc
                logp = -(abs_lc - loc) / scale
                # reference scrubs NaN p to 1 (diff_mustache.py:386-387)
                logp = jnp.where(jnp.isnan(logp), zero, logp)

                will = (
                    nzb[m]
                    & (Lc > st_m[0])
                    & (Lc == mC)
                    & ((Lp == mP) | (Ln == mN))
                    & (Lc > mP)
                    & (Lc > mN)
                )
                new_states.append((
                    jnp.where(will, Lc, st_m[0]),
                    jnp.where(will, logp, st_m[1]),
                    jnp.where(will, diff_p, st_m[2]),
                    jnp.where(will, plane, st_m[3]),
                ))
                new_roll.extend((Lc, Ln, mC, mN))
            return (tuple(new_roll), new_states[0], new_states[1]), None
        return step

    with jax.named_scope("dog_nms_scan"):
        # the per-octave frozen difference DoG plane and its folded-normal
        # p-value, fit on the joint support (diff_mustache.py:337,371-385)
        diff_ps = []
        for o in range(n_octaves):
            Lcf = Gdb[2 * o] - Gdb[2 * o + 1]
            mu = jnp.sum(Lcf * nzbd_f) * inv_nzd
            var = jnp.sum(jnp.where(nzbd, (Lcf - mu) ** 2, zero)) * inv_nzd
            sd = jnp.sqrt(var)
            phi = jax.scipy.stats.norm.cdf(Lcf, loc=mu, scale=sd)
            phi = jnp.where(jnp.isnan(phi), dtype.type(1.0), phi)
            diff_ps.append(jnp.where(phi > 0.5, 1.0 - phi, phi) * 2.0)

        # carries seeded from the input (Gb * 0 scalar) so their vma type
        # is varying under shard_map — replicated literal carries fail
        # scan typing there (same fix as detect._band_candidates)
        vzf = Gb.reshape(-1)[0] * 0
        zb = jnp.zeros((N, Dl), dtype) + vzf
        states = {m: (zb,                                      # best_v
                      jnp.full((N, Dl), pinf, dtype) + vzf,    # best_logp
                      jnp.full((N, Dl), sent, dtype) + vzf,    # best_pair
                      jnp.full((N, Dl), -1, jnp.int32)
                      + vzf.astype(jnp.int32))                 # best_sigidx
                  for m in (1, 2)}
        for o in range(n_octaves):
            G1 = Gb[0, o * bpo:(o + 1) * bpo]
            G2 = Gb[1, o * bpo:(o + 1) * bpo]
            L1 = G1[:-1] - G1[1:]
            L2 = G2[:-1] - G2[1:]
            diff_p = diff_ps[o]
            planes = np.arange(o * planes_per_octave,
                               (o + 1) * planes_per_octave, dtype=np.int32)
            roll = (L1[0], L1[1],
                    geom.max3x3_band(L1[0]), geom.max3x3_band(L1[1]),
                    L2[0], L2[1],
                    geom.max3x3_band(L2[0]), geom.max3x3_band(L2[1]))
            carry, _ = lax.scan(
                make_step(diff_p), (roll, states[1], states[2]),
                (L1[2:], L2[2:], planes))
            states = {1: carry[1], 2: carry[2]}

    out = {"nz1_count": nz1_count, "nz2_count": nz2_count}
    ceil_table = nz1_count * 0 + np.asarray(det_ceil, np.int32)
    band_c = {1: geom.shear(c1, zerof), 2: geom.shear(c2, zerof)}
    # best DoG responses on each map's own support, 1 elsewhere
    # (diff_mustache.py:446-449) — both exported on every candidate's
    # neighborhood so the host can evaluate the differential call
    band_v = {m: jnp.where(nzb[m], states[m][0], dtype.type(1.0))
              for m in (1, 2)}
    with jax.named_scope("bh_epilogue"):
        for m in (1, 2):
            best_v, best_logp, best_pair, best_sigidx = states[m]
            band_pair = jnp.where(nzb[m], best_pair, dtype.type(1.0))
            table = _band_candidates(
                geom, band_logp=best_logp, band_sigidx=best_sigidx,
                band_nz=nzb[m], band_c=band_c[m],
                ceil_table=ceil_table, ceil_max=int(np.max(det_ceil)),
                st=st, log_pt=log_pt, K=K,
                extras=(
                    ("pair", band_pair, 1.0, np.inf),
                    ("v1", band_v[1], 1.0, 1.0),
                    ("v2", band_v[2], 1.0, 1.0),
                ))
            out.update({k + str(m): v for k, v in table.items()})
    return out


@dataclasses.dataclass(frozen=True)
class DiffBlockDetector:
    cfg: DetectionConfig
    spec: LadderSpec
    n: int
    _fn: Any
    _fn_single: Any
    _fn_band: Any
    _fn_band_packed: Any
    out_spec: Any

    @property
    def _scalars(self):
        dt = np.float64 if self.cfg.precision == "float64" else np.float32
        return dt(self.cfg.st), dt(math.log(self.cfg.pt))

    def fn(self, b1, b2):
        st, lp = self._scalars
        return self._fn(b1, b2, st, lp)

    def fn_single(self, c1, c2):
        st, lp = self._scalars
        return self._fn_single(c1, c2, st, lp)

    def fn_band(self, band1, band2, starts):
        """Batch detection from device-resident chromosome bands of both
        conditions (see detect.BlockDetector.fn_band)."""
        st, lp = self._scalars
        return self._fn_band(band1, band2, starts, st, lp)

    def fn_band_packed(self, band1, band2, starts):
        """``fn_band`` packed into (floats, ints) buffers — 2 D2H per batch
        instead of ~34 (see detect.BlockDetector.fn_band_packed); unpack
        with ``detect.unpack_block(out_spec, floats[bi], ints[bi])``."""
        st, lp = self._scalars
        return self._fn_band_packed(band1, band2, starts, st, lp)


@functools.lru_cache(maxsize=16)
def _build_diff_detector_cached(octave_values: tuple, precision: str,
                                d_px: int, n: int, max_candidates: int):
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

    def one(c1, c2, st, log_pt):
        return _diff_detect_one(c1.astype(dtype), c2.astype(dtype), st,
                                log_pt, kernels=kernels, **kw)

    def fn_base(b1, b2, st, log_pt):
        return jax.vmap(one, in_axes=(0, 0, None, None))(b1, b2, st, log_pt)

    def fn_band_base(band1, band2, starts, st, log_pt):
        # chromosome bands resident on device; blocks are dynamic row
        # slices + dense reconstruction (detect.dense_from_band). Pad
        # slots carry start -1 (clamped slice; discarded on the host)
        def slc(band, s):
            return lax.dynamic_slice_in_dim(band, jnp.maximum(s, 0), n, 0)

        b1 = jax.vmap(lambda s: dense_from_band(slc(band1, s)))(starts)
        b2 = jax.vmap(lambda s: dense_from_band(slc(band2, s)))(starts)
        return fn_base(b1, b2, st, log_pt)

    out_shapes = jax.eval_shape(
        one, jax.ShapeDtypeStruct((n, n), dtype),
        jax.ShapeDtypeStruct((n, n), dtype),
        jax.ShapeDtypeStruct((), dtype), jax.ShapeDtypeStruct((), dtype))
    fn_band_packed = jax.jit(
        lambda b1, b2, starts, st, lp: _pack_batched(
            fn_band_base(b1, b2, starts, st, lp)))
    return (spec, jax.jit(fn_base), jax.jit(one), jax.jit(fn_band_base),
            fn_band_packed, _out_spec(out_shapes))


def build_diff_detector(cfg: DetectionConfig, n: int, *, intra: bool = True,
                        max_candidates: int | None = None) -> DiffBlockDetector:
    if not intra:
        raise NotImplementedError("inter-chromosomal detection not supported")
    require_x64(cfg)
    spec, fn, fn_single, fn_band, fn_band_packed, out_spec = \
        _build_diff_detector_cached(
            cfg.octave_values, cfg.precision, cfg.distance_px, n,
            max_candidates or cfg.max_candidates)
    return DiffBlockDetector(cfg=cfg, spec=spec, n=n, _fn=fn,
                             _fn_single=fn_single, _fn_band=fn_band,
                             _fn_band_packed=fn_band_packed,
                             out_spec=out_spec)


# ---------------------------------------------------------------------------
# host finish
# ---------------------------------------------------------------------------

def _finish_map(out, tag, *, start, spec):
    """Cluster one condition's surviving candidates; returns rows with the
    pair/v values needed for the differential call, or None when this map's
    bail-outs fire."""
    passing = (np.asarray(out[f"cand_valid{tag}"])
               & np.asarray(out[f"pass_sparse{tag}"]))
    if not passing.any():
        return None, None
    with_enrich = passing & np.asarray(out[f"pass_enrich{tag}"])
    if not with_enrich.any():
        return passing, None
    cx = np.asarray(out[f"cand_x{tag}"])[with_enrich]
    cy = np.asarray(out[f"cand_y{tag}"])[with_enrich]
    nlq = np.asarray(out[f"neigh_logq{tag}"])[with_enrich]
    nsi = np.asarray(out[f"neigh_sigidx{tag}"])[with_enrich]
    npair = np.asarray(out[f"neigh_pair{tag}"])[with_enrich]
    nv1 = np.asarray(out[f"neigh_v1{tag}"])[with_enrich]
    nv2 = np.asarray(out[f"neigh_v2{tag}"])[with_enrich]
    cands = []
    for i in range(len(cx)):
        cands.append({
            "x": int(cx[i]), "y": int(cy[i]),
            "nlq": nlq[i], "nsi": nsi[i], "npair": npair[i],
            "nv1": nv1[i], "nv2": nv2[i],
        })
    det_sigmas = spec.det_sigmas
    rows = []
    for comp in _cluster_components(cands):
        pixels = {}
        for cd in comp:
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    px, py = cd["x"] + dx, cd["y"] + dy
                    pixels[(px, py)] = (
                        float(cd["nlq"][dx + 1, dy + 1]),
                        int(cd["nsi"][dx + 1, dy + 1]),
                        float(cd["npair"][dx + 1, dy + 1]),
                        float(cd["nv1"][dx + 1, dy + 1]),
                        float(cd["nv2"][dx + 1, dy + 1]),
                    )
        ordered = sorted(pixels.items())
        best = min(range(len(ordered)), key=lambda i: (ordered[i][1][0], i))
        (px, py), (lq, si, pair, nv1, nv2) = ordered[best]
        q = float(np.exp(np.float64(lq)))
        sigma = det_sigmas[si] if si >= 0 else 1.0
        rows.append((ordered[0][0],
                     [px + start, py + start, q, sigma], pair, nv1, nv2))
    rows.sort(key=lambda t: t[0])
    return passing, rows


def finish_diff_block(out: dict, *, start: int, cfg: DetectionConfig,
                      spec: LadderSpec):
    """Returns (loops1, diff_loops1, loops2, diff_loops2) row lists."""
    empty = ([], [], [], [])
    # the reference's two bail-outs (nz<50 at diff_mustache.py:262-267 and
    # the >=10000-support FDR gate at :428-436) collapse into the stricter
    # one: min_tested >= min_nz always
    if int(out["nz1_count"]) < cfg.min_tested or \
            int(out["nz2_count"]) < cfg.min_tested:
        return empty

    pass1, rows1 = _finish_map(out, "1", start=start, spec=spec)
    pass2, rows2 = _finish_map(out, "2", start=start, spec=spec)
    # joint bail-outs (diff_mustache.py:507-508, :519, :526)
    if pass1 is None or pass2 is None:
        return empty
    if rows1 is None or rows2 is None:
        return empty

    def split(rows, own):
        loops, diff_loops = [], []
        for _, row, pair, nv1, nv2 in rows:
            loops.append(row)
            own_v, other_v = (nv1, nv2) if own == 1 else (nv2, nv1)
            if pair < cfg.pt2 and own_v > other_v:
                diff_loops.append(row)
        return loops, diff_loops

    loops1, diff1 = split(rows1, 1)
    loops2, diff2 = split(rows2, 2)
    return loops1, diff1, loops2, diff2


# ---------------------------------------------------------------------------
# per-chromosome orchestration (mirrors pipeline.detect_loops_coo)
# ---------------------------------------------------------------------------

def _maybe_regrow_diff(block_out: dict, cfg: DetectionConfig,
                       rerun) -> dict:
    """If either condition's candidate table overflowed (more pixels below
    the q threshold than capacity), rerun this block with a larger capacity.
    The reference selects ALL pixels with q < pt (diff_mustache.py:458,473),
    so truncation would silently drop loops. ``rerun``: callable
    ``(capacity) -> block_out`` re-detecting the block (lazy — the band
    fast path never materializes host blocks). Loops with geometric growth
    (see pipeline._maybe_regrow: the count-mode sig_count is a lower bound
    on overflow)."""
    cap = cfg.max_candidates
    while True:
        sig = max(int(block_out["sig_count1"]),
                  int(block_out["sig_count2"]))
        if sig <= cap:
            return block_out
        cap = max(1 << (sig - 1).bit_length(), 2 * cap)
        block_out = rerun(cap)


def find_diff_loops(x1, y1, v1, x2, y2, v2, *, resolution: int = 5000,
                    distance_bp: int = 2_000_000, pt: float = 0.2,
                    pt2: float = 0.1, st: float = 0.88,
                    sigma0: float = 1.6, octaves: int = 2,
                    precision: str = "float32", normalize: bool = True):
    """One-call differential API (twin of :func:`mustache_tpu.find_loops`):
    two COO contact maps in, list of ``(bin1, bin2, q, scale, tag)`` out
    with tag 1=loop1, 2=diffloop1, 3=loop2, 4=diffloop2
    (diff_mustache.py:704-715). The caller's arrays are left untouched
    (the engine normalizes copies)."""
    from mustache_tpu.config import clamp_distance_filter

    v1 = np.array(v1, dtype=np.float64)
    v2 = np.array(v2, dtype=np.float64)

    cfg = DetectionConfig(
        resolution=resolution,
        distance_bp=clamp_distance_filter(distance_bp, resolution,
                                          diff=True),
        pt=pt, pt2=pt2, st=st, sigma0=sigma0, octaves=octaves,
        precision=precision,
    )
    return detect_diff_loops_coo(x1, y1, v1, x2, y2, v2, cfg,
                                 normalize=normalize)


def detect_diff_loops_coo(x1, y1, v1, x2, y2, v2, cfg: DetectionConfig, *,
                          normalize: bool = True, exact_normalize: bool = False,
                          runner=None, log=None):
    """Differential loop calls for one chromosome, both conditions.

    Returns a list of (bin1, bin2, q, scale, tag) with tag 1=loop1,
    2=diffloop1, 3=loop2, 4=diffloop2 (diff_mustache.py:704-715).

    ``runner``: optional callable ``(detector, (b1, b2)) -> outputs`` used
    by the sharded driver; defaults to direct invocation. A MeshRunner with
    ``band_placement="rowshard"`` holds only each chip's contiguous block
    range as a slab PAIR (one per condition) — at 1kb-diff scale the
    replicated alternative is 2 x band x n_chips of HBM and H2D
    (diff_mustache.py:630-651 is the shared grid being scaled).

    Engine-level API: when ``normalize`` is True and ``v1``/``v2`` are
    float64, the z-score mutates the caller's arrays IN PLACE (the CLI
    owns its triplets). Use ``find_diff_loops`` — which copies — if you
    need them preserved.
    """
    from mustache_tpu.config import block_mask_sizes, chunk_grid
    from mustache_tpu.normalize import normalize_sparse

    if len(v1) == 0 or len(v2) == 0:
        return []
    x1 = np.asarray(x1, np.int64); y1 = np.asarray(y1, np.int64)
    x2 = np.asarray(x2, np.int64); y2 = np.asarray(y2, np.int64)
    v1 = np.asarray(v1, np.float64); v2 = np.asarray(v2, np.float64)

    # the float64 path is the reference-parity path: its normalize uses the
    # reference's np.convolve window sums, not the cumulative-sum form
    # (which moves q by ~1e-4 relative at chr21 scale)
    exact_normalize = exact_normalize or cfg.precision == "float64"
    d_px = cfg.distance_px
    n1 = int(max(x1.max(), y1.max())) + 1
    n2 = int(max(x2.max(), y2.max())) + 1
    n = max(n1, n2)
    chunk = cfg.chunk_size
    # always chunk x chunk, zero-padded (diff_mustache.py:671)
    width = chunk
    dtype = np.float64 if cfg.precision == "float64" else np.float32

    # device normalize (see pipeline.detect_loops_coo): the host only
    # scatter-fills the RAW bands; the per-diagonal windowed z-score runs
    # on chip, once per condition with its OWN bin count (the window
    # clipping at diagonal tails depends on it, diff_mustache.py:634).
    # The sharded-runner path is band-resident: both condition bands are
    # placed replicated over the mesh, normalized in place on every chip,
    # and each launch shards only the [B] starts vector — sharded ==
    # unsharded values with zero host densifies.
    row_shard = (runner is not None
                 and getattr(runner, "band_placement", None) == "rowshard")
    # rowshard keeps normalize on the host (the windowed per-diagonal
    # z-score needs full columns; same stance as the single-map pipeline)
    device_norm = (normalize and not exact_normalize
                   and dtype == np.float32 and not row_shard)

    # ONE H2D per chromosome and condition (see pipeline.detect_loops_coo);
    # rows bucketed so chromosome lengths share compiles (bandnorm)
    from mustache_tpu.bandnorm import bucket_rows
    from mustache_tpu.detect import band_width
    shape = (bucket_rows(max(n, width)), band_width(width, d_px))
    bands = None
    if not device_norm:
        bands = (np.zeros(shape, dtype=dtype), np.zeros(shape, dtype=dtype))

    def fill_raw(x, y, v, band):
        from mustache_tpu.io import native

        if not native.fill_band(x, y, v, band):
            sel = (y - x >= 0) & ((y - x) < band.shape[1])
            band[x[sel], (y - x)[sel]] = v[sel]

    def prep(x, y, v, band, n_own):
        if normalize:
            work = (np.float64
                    if (exact_normalize or cfg.precision == "float64")
                    else np.float32)
            fuse = band if band is not None and dtype == np.float32 else None
            normalize_sparse(x, y, v, cfg.resolution, d_px,
                             exact=exact_normalize, work_dtype=work,
                             band_out=fuse, n=n_own)
            if band is None or fuse is not None:
                return
        if band is not None:
            fill_raw(x, y, v, band)

    bands_dev = None
    if device_norm:
        from mustache_tpu.bandnorm import normalize_band_device, pad_exceptions

        # mostly-integer counts upload as uint8/uint16 + exception list
        # (2-4x fewer H2D bytes), per condition — see
        # pipeline.fill_raw_band_compact
        def prep_raw(x, y, v):
            from mustache_tpu.pipeline import stream_band_to_device
            place = runner.place_band if runner is not None else None
            band, exc, p4 = stream_band_to_device(x, y, v, shape,
                                                  place=place)
            if exc is not None:
                exc = pad_exceptions(exc, shape[0])
                if runner is not None:
                    exc = tuple(runner.place_band(e) for e in exc)
            return band, exc, p4

        raw = (prep_raw(x1, y1, v1), prep_raw(x2, y2, v2))
        bands_dev = (
            normalize_band_device(raw[0][0], n1, cfg.resolution, d_px,
                                  exceptions=raw[0][1],
                                  packed4=raw[0][2])[0],
            normalize_band_device(raw[1][0], n2, cfg.resolution, d_px,
                                  exceptions=raw[1][1],
                                  packed4=raw[1][2])[0])
    else:
        prep(x1, y1, v1, bands[0] if bands else None, n1)
        prep(x2, y2, v2, bands[1] if bands else None, n2)

    start, end = chunk_grid(n, chunk, d_px)
    masks = block_mask_sizes(start, end, d_px)
    nblocks = len(start)

    from mustache_tpu.pipeline import block_batch
    # triple ladder: ~3x the single-map path's live blur buffers
    B = block_batch(cfg, width, 135)
    if runner is not None:
        B = runner.round_batch(B)
    det = build_diff_detector(cfg, width)

    plan = None
    if row_shard:
        # per-chip slab PAIR: chip i holds only its block range's rows of
        # BOTH condition bands (logged bytes count the pair)
        plan = runner.plan_rowshard(start, width)
        bands_dev = (runner.place_band_rowshard(bands[0], plan, log=log),
                     runner.place_band_rowshard(bands[1], plan, log=log))
    elif bands is not None and bands_dev is None:
        place = (runner.place_band if runner is not None
                 else jax.device_put)
        bands_dev = (place(bands[0]), place(bands[1]))

    def pack_starts(idxs, cap):
        # pad slots carry start -1 (clamped slice, discarded on the host)
        starts = np.asarray(
            [start[i] for i in idxs] + [-1] * (cap - len(idxs)), np.int32)
        return runner.place_starts(starts) if runner is not None else starts

    def launch(idxs):
        return idxs, det.fn_band_packed(bands_dev[0], bands_dev[1],
                                        pack_starts(idxs, B))

    # rows tagged by block index: rowshard launches interleave blocks
    # chip-major, so the reference's block-order output needs a final
    # stable sort (a no-op for the in-order paths)
    tagged: list = []

    def rerun_block(i, cap):
        """Re-detect block i with a larger candidate capacity."""
        det2 = build_diff_detector(cfg, width, max_candidates=cap)
        if row_shard:
            # the normalized bands are host-resident in this mode: rerun
            # the one overflowing block through the single-block entry
            from mustache_tpu.pipeline import dense_from_band_host
            blk1 = dense_from_band_host(bands[0], start[i], width)
            blk2 = dense_from_band_host(bands[1], start[i], width)
            out = det2.fn_single(blk1.astype(dtype), blk2.astype(dtype))
            return {k: np.asarray(a) for k, a in out.items()}
        nb = runner.nb if runner is not None else 1
        fl, il = det2.fn_band_packed(bands_dev[0], bands_dev[1],
                                     pack_starts([i], nb))
        return unpack_block(det2.out_spec, np.asarray(fl[0]),
                            np.asarray(il[0]))

    def finish(idxs, out):
        # packed band path everywhere: 2 D2H per batch
        fh, ih = np.asarray(out[0]), np.asarray(out[1])
        get = lambda bi: unpack_block(det.out_spec, fh[bi], ih[bi])
        for bi, i in enumerate(idxs):
            if i is None:     # rowshard pad slot
                continue
            block_out = get(bi)
            block_out = _maybe_regrow_diff(
                block_out, cfg, lambda cap, i=i: rerun_block(i, cap))
            groups = finish_diff_block(block_out, start=start[i], cfg=cfg,
                                       spec=det.spec)
            mask = masks[i]
            for tag, rows in zip((1, 2, 3, 4), groups):
                for r in rows:
                    if r[0] >= start[i] + mask or r[1] >= start[i] + mask:
                        tagged.append((i, (int(r[0]), int(r[1]),
                                           float(r[2]), float(r[3]), tag)))

    if row_shard:
        batches = ((idxs, runner.run_rowshard(det, bands_dev, sl))
                   for idxs, sl in plan.launches(B // runner.nb))
    else:
        batches = (launch(list(range(b0, min(b0 + B, nblocks))))
                   for b0 in range(0, nblocks, B))

    # software pipelining: densify+upload batch k+1 while batch k computes
    pending = None
    for launched in batches:
        if pending is not None:
            finish(*pending)
        pending = launched
    if pending is not None:
        finish(*pending)
    tagged.sort(key=lambda t: t[0])
    return [row for _, row in tagged]
