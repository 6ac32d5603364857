"""Multi-device / multi-host execution: mesh construction and sharded runners.

The unit of data parallelism is the detection block (the reference's
multiprocessing fan-out, mustache.py:913-934, re-expressed as SPMD): a
``[B, N, N]`` block batch is sharded over the ``block`` mesh axis. A second
``row`` axis shards each block's rows; XLA GSPMD then partitions the blur
convolutions with automatic halo exchange and inserts collectives
(psum/all-gather) for the masked reductions, the BH sort, and top_k — in
place of the reference's fork+pickle+Manager IPC. The cards of one host are
joined all to all, so the mesh follows the algorithm alone.

Multi-host: ``initialize_distributed`` wires ``jax.distributed`` so the
same code runs across hosts, one process per host or one per card; per-host
block batches are combined with ``multihost_utils`` on the driver side.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def make_mesh(n_block: int | None = None, n_row: int = 1, devices=None):
    """Build a (block, row) mesh over the available devices."""
    import jax
    from jax.sharding import Mesh

    devices = list(devices if devices is not None else jax.devices())
    nd = len(devices)
    if n_block is None:
        n_block = nd // n_row
    if n_block < 1 or n_block * n_row > nd:
        raise ValueError(
            f"mesh {n_block}x{n_row} needs {max(n_block, 1) * n_row} "
            f"devices, have {nd}")
    arr = np.array(devices[: n_block * n_row]).reshape(n_block, n_row)
    return Mesh(arr, ("block", "row"))


def block_sharding(mesh):
    """NamedSharding for a [B, N, N] block batch: batch over `block`,
    rows over `row` (XLA adds conv halo exchange automatically)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    return NamedSharding(mesh, P("block", "row", None))


class RowShardPlan:
    """Block->chip assignment and slab geometry for the row-sharded band.

    Each chip owns a CONTIGUOUS range of detection blocks and holds only
    the band rows those blocks read: slab i covers
    ``[starts[c0_i], starts[c1_i - 1] + chunk)``. Adjacent slabs overlap by
    the block overlap (the reference's recomputed-overlap idiom,
    mustache.py:896-910, as data placement); a block's stencil halo is
    internal to its ``chunk x chunk`` dense reconstruction, so no extra
    margin is needed. All slabs are padded to one bucketed row count so a
    genome compiles a handful of shapes."""

    def __init__(self, starts, chunk: int, nd: int):
        from mustache_tpu.bandnorm import bucket_rows

        starts = np.asarray(starts, np.int64)
        nblocks = len(starts)
        per = -(-nblocks // nd) if nblocks else 0   # max blocks per chip
        self.nd = nd
        self.chunk = chunk
        self.per_chip = per
        self.c0 = [min(i * per, nblocks) for i in range(nd)]
        self.c1 = [min((i + 1) * per, nblocks) for i in range(nd)]
        self.r0 = np.asarray(
            [starts[self.c0[i]] if self.c0[i] < self.c1[i] else 0
             for i in range(nd)], np.int64)
        spans = [
            int(starts[self.c1[i] - 1] + chunk - self.r0[i])
            if self.c0[i] < self.c1[i] else chunk
            for i in range(nd)
        ]
        self.slab_rows = bucket_rows(max(spans + [chunk]))
        self.starts = starts

    def launches(self, Bl: int):
        """Yield ``(idxs, starts_local)`` per launch: ``idxs`` is the
        global block index per batch slot (None = pad, discarded on host),
        chip-major; ``starts_local`` is the [nd, Bl] slab-relative start
        matrix (pad slots carry -1: the slice clamps to local row 0 and
        the host drops them)."""
        n_launches = -(-self.per_chip // Bl) if self.per_chip else 0
        for k in range(n_launches):
            idxs: list = []
            sl = np.full((self.nd, Bl), -1, np.int32)
            for i in range(self.nd):
                for j in range(Bl):
                    g = self.c0[i] + k * Bl + j
                    if g < self.c1[i]:
                        idxs.append(int(g))
                        sl[i, j] = int(self.starts[g] - self.r0[i])
                    else:
                        idxs.append(None)
            yield idxs, sl

    def slab_stack(self, band) -> np.ndarray:
        """[nd, slab_rows, Dl] host stack of per-chip slabs (zero-padded);
        total bytes = band rows + inter-chip overlaps, NOT nd x band."""
        nd, R = self.nd, self.slab_rows
        out = np.zeros((nd, R, band.shape[1]), band.dtype)
        for i in range(nd):
            seg = band[self.r0[i]: self.r0[i] + R]
            out[i, : seg.shape[0]] = seg
        return out


class MeshRunner:
    """Band-resident sharded execution over a (block, row) mesh.

    The pipelines keep the chromosome's diagonal band RESIDENT on the mesh
    (replicated — every chip holds the band once) and shard only the tiny
    per-batch ``starts`` vector over the ``block`` axis; each chip then
    densifies and detects its own slice of the block batch from its local
    band copy. Replication costs one band H2D per chip but removes ALL
    per-batch host work (no host densify, no dense [B, N, N] re-upload —
    the round-2 transfer wins apply at mesh scale), and device-normalize
    runs on the placed band so every chip normalizes its copy in place
    (redundant FLOPs, zero communication). Outputs come back as the same
    packed two-buffer D2H the single-chip band path uses.

    ``band_placement="rowshard"`` replaces replication with row-sharded
    slabs (see :class:`RowShardPlan`): each chip uploads and holds ONLY the
    band rows of its own contiguous block range (+ the block overlap), so
    total H2D stays ~one band and per-chip HBM is bounded by the slab — the
    right trade at 1kb genome scale where a replicated chr1 band is 2 GB
    per chip (docs/SCALING.md). Normalization happens on the host in this
    mode (the windowed per-diagonal z-score needs full-column context);
    detection is embarrassingly parallel via ``shard_map`` with zero
    collectives.

    The legacy dense entry ``runner(detector, blocks)`` remains for callers
    that already hold a dense [B, N, N] batch (or a tuple of two for the
    differential detector)."""

    def __init__(self, mesh, band_placement: str = "replicate"):
        from jax.sharding import NamedSharding, PartitionSpec as P

        if band_placement not in ("replicate", "rowshard"):
            raise ValueError(f"unknown band_placement {band_placement!r}")
        self.mesh = mesh
        self.band_placement = band_placement
        self._band_sh = NamedSharding(mesh, P())          # replicated
        self._starts_sh = NamedSharding(mesh, P("block"))
        self._slab_sh = NamedSharding(mesh, P("block", None, None))
        self._starts2_sh = NamedSharding(mesh, P("block", None))
        self._dense_sh = block_sharding(mesh)
        self._rs_cache: dict = {}
        self.last_plan: RowShardPlan | None = None

    @property
    def nb(self) -> int:
        return int(self.mesh.shape["block"])

    def place_band(self, band):
        """Place a [rows, Dl] chromosome band replicated over the mesh
        (accepts host arrays or an already-placed device array)."""
        import jax

        return jax.device_put(band, self._band_sh)

    def place_starts(self, starts):
        """Place a [B] block-starts vector sharded over the `block` axis;
        B must be a multiple of the block axis size (pipelines pad)."""
        import jax

        return jax.device_put(np.asarray(starts, np.int32), self._starts_sh)

    def round_batch(self, b: int) -> int:
        """Smallest multiple of the block axis size >= b (batch shaping:
        every chip gets the same per-launch block count)."""
        return -(-b // self.nb) * self.nb

    # -- row-sharded band placement (band_placement="rowshard") ------------
    def plan_rowshard(self, starts, chunk: int) -> RowShardPlan:
        """Contiguous block->chip assignment + slab geometry for this
        chromosome's block grid; remembered for byte accounting."""
        self.last_plan = RowShardPlan(starts, chunk, self.nb)
        return self.last_plan

    def place_band_rowshard(self, band, plan: RowShardPlan, log=None):
        """Upload the per-chip slabs, sharded over the ``block`` axis:
        chip i receives ONLY slab i (total H2D ~= one band + overlaps)."""
        import jax

        stack = plan.slab_stack(band)
        if log is not None:
            log.event("rowshard_band",
                      chips=plan.nd,
                      per_chip_mb=round(stack[0].nbytes / 1e6, 2),
                      total_mb=round(stack.nbytes / 1e6, 2),
                      replicated_mb=round(band.nbytes * plan.nd / 1e6, 2))
        return jax.device_put(stack, self._slab_sh)

    def _rowshard_fn(self, detector, slab_rows: int, Dl: int, Bl: int,
                     n_bands: int = 1):
        """shard_map'd detector launch: each chip runs the packed band
        detector on its local slab(s) and its Bl-slot local starts row; the
        packed outputs concatenate over the block axis. Zero collectives.
        ``n_bands``: 1 for the single-map detector, 2 for the differential
        detector (a slab pair per chip, one per condition)."""
        import jax
        from jax.sharding import PartitionSpec as P

        key = (slab_rows, Dl, Bl, n_bands, id(detector._fn_band_packed))
        fn = self._rs_cache.get(key)
        if fn is None:
            inner = detector._fn_band_packed

            def local(*args):
                bands, (starts2, st, lp) = args[:n_bands], args[n_bands:]
                return inner(*(b[0] for b in bands), starts2[0], st, lp)

            fn = jax.jit(jax.shard_map(
                local, mesh=self.mesh,
                in_specs=(P("block", None, None),) * n_bands
                + (P("block", None), P(), P()),
                out_specs=P("block")))
            self._rs_cache[key] = fn
        return fn

    def run_rowshard(self, detector, band_stack, starts_local):
        """One launch: ``band_stack`` [nd, slab_rows, Dl] (placed) or a
        tuple of such stacks (differential: one per condition),
        ``starts_local`` [nd, Bl] slab-relative block starts."""
        import jax

        stacks = band_stack if isinstance(band_stack, tuple) else (band_stack,)
        st, lp = detector._scalars
        fn = self._rowshard_fn(detector, stacks[0].shape[1],
                               stacks[0].shape[2], starts_local.shape[1],
                               n_bands=len(stacks))
        starts_dev = jax.device_put(
            np.asarray(starts_local, np.int32), self._starts2_sh)
        return fn(*stacks, starts_dev, st, lp)

    def __call__(self, detector, blocks):
        import jax

        parts = blocks if isinstance(blocks, tuple) else (blocks,)
        B = parts[0].shape[0]
        pad = (-B) % self.nb
        if pad:
            parts = tuple(
                np.concatenate(
                    [b, np.zeros((pad,) + b.shape[1:], b.dtype)])
                for b in parts)
        arrs = tuple(jax.device_put(b, self._dense_sh) for b in parts)
        out = detector.fn(*arrs)
        if pad:
            out = jax.tree.map(lambda a: a[:B], out)
        return out


def make_runner(mesh, band_placement: str = "replicate") -> MeshRunner:
    """Build the band-resident sharded runner for ``mesh``.

    ``band_placement``: "replicate" (default; every chip holds the band)
    or "rowshard" (each chip holds only its contiguous block range's rows —
    the 1kb genome-scale memory- and transfer-bound mode)."""
    return MeshRunner(mesh, band_placement)


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           local_device_ids: Sequence[int] | None = None):
    """Multi-process bring-up (jax.distributed); no-op when single-process.

    ``local_device_ids`` pins this process to those cards of its host.
    Several processes on one host need it: without it each process opens
    every card and reserves most of its memory, so the second one fails.
    One process per host leaves it None and drives all local cards."""
    import jax

    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=(None if local_device_ids is None
                          else list(local_device_ids)),
    )


def shard_chromosomes(chromosomes: Sequence[str], process_id: int,
                      num_processes: int) -> list[str]:
    """Static chromosome partition across processes (config-4 benchmark
    shape: chromosomes over processes, blocks over each process's cards)."""
    return [c for i, c in enumerate(chromosomes)
            if i % num_processes == process_id]
