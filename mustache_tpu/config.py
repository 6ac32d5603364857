"""Configuration for the detection engine.

Flag names, defaults, and clamping rules mirror the reference CLI
(`/root/reference/mustache/mustache.py:52-178`, `:996-1015`) so that
benchmark configs expressed in reference flags map one-to-one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence


def parse_bp(s) -> int | bool:
    """Parse a genomic-distance string like ``5000``, ``5kb``, ``2Mb`` to bp.

    Returns ``False`` for garbage input (reference behavior:
    mustache.py:29-49).
    """
    if not s:
        return False
    if isinstance(s, (int, float)):
        return int(s)
    s = str(s)
    if s.isnumeric():
        return int(s)
    s = s.lower()
    for suffix, mult in (("kb", 1_000), ("mb", 1_000_000)):
        if suffix in s:
            n = s.split(suffix)[0]
            if not n.isnumeric():
                return False
            return int(n) * mult
    return False


def clamp_distance_filter(dist_bp: int | bool, res: int, *, diff: bool = False) -> int:
    """Default + clamp logic for the max loop distance.

    Single-map rules: mustache.py:996-1015. Differential rules use a tighter
    upper clamp (diff_mustache.py:759-778).
    """
    hi_mult = 2000 if diff else 10000
    hi_abs = 2_000_000 if diff else 10_000_000
    if not dist_bp:
        if 200 * res >= 2_000_000:
            return 200 * res
        if 2000 * res <= 2_000_000:
            return 2000 * res
        return 2_000_000
    if dist_bp < 200 * res:
        return 200 * res
    if dist_bp > hi_mult * res:
        return hi_mult * res
    if dist_bp > hi_abs:
        return hi_abs
    return int(dist_bp)


@dataclasses.dataclass(frozen=True)
class DetectionConfig:
    """All tunables of the detection method.

    Defaults follow the reference argparse defaults (mustache.py:110-148):
    pt=0.2, st=0.88, sigma0=1.6, octaves=2. ``iterations`` is accepted for
    CLI parity but the scale ladder subdivision is fixed at 10 exactly as in
    the reference (mustache.py:711 hardcodes s=10, making -i inert).
    """

    resolution: int = 5000
    distance_bp: int = 2_000_000          # post-clamp max loop distance, bp
    pt: float = 0.2                        # q-value threshold
    pt2: float = 0.1                       # differential q-value threshold
    st: float = 0.88                       # sparsity threshold
    sigma0: float = 1.6
    octaves: int = 2
    iterations: int = 10                   # accepted but inert (parity)
    # --- engine knobs (no reference counterpart) ---
    precision: str = "float32"             # "float32" | "float64"
    max_candidates: int = 2048             # per-block candidate capacity
    block_batch: int = 1                   # blocks per device launch
    min_nz: int = 50                       # bail-out: too-few nonzeros
    min_tested: int = 10000                # bail-out: too-few tested pixels

    @property
    def distance_px(self) -> int:
        # reference: int(math.ceil(distance_in_bp // res)) == floor division
        return int(math.ceil(self.distance_bp // self.resolution))

    @property
    def chunk_size(self) -> int:
        # reference block grid: CHUNK = max(2*d_px, 2000) (mustache.py:896)
        return max(2 * self.distance_px, 2000)

    @property
    def octave_values(self) -> tuple[float, ...]:
        # octave base sigmas: sigma0 * 2^i (mustache.py:874)
        return tuple(self.sigma0 * (2.0 ** i) for i in range(self.octaves))

    def with_(self, **kw) -> "DetectionConfig":
        return dataclasses.replace(self, **kw)


def chunk_grid(n: int, chunk: int, overlap: int) -> tuple[list[int], list[int]]:
    """Overlapping 1-D block decomposition of the genome axis.

    Identical to the reference grid (mustache.py:899-910): fixed-size chunks
    advancing by ``chunk - overlap``; the final chunk is right-aligned at
    ``n`` so every block has exactly ``chunk`` rows except when ``n <= chunk``.
    """
    if n <= chunk:
        return [0], [n]
    if chunk <= overlap:
        raise ValueError(
            f"chunk {chunk} must exceed the overlap {overlap} "
            f"(the grid cannot advance); DetectionConfig.chunk_size "
            f"guarantees this (max(2*d_px, 2000))")
    start = [0]
    end = [chunk]
    while end[-1] < n:
        start.append(end[-1] - overlap)
        end.append(start[-1] + chunk)
    end[-1] = n
    start[-1] = end[-1] - chunk
    return start, end


def block_mask_sizes(start: Sequence[int], end: Sequence[int], overlap: int) -> list[int]:
    """Ownership masks deduplicating overlapping blocks (mustache.py:948-953).

    Block i keeps a loop iff x >= start[i]+mask or y >= start[i]+mask.
    """
    masks = []
    for i in range(len(start)):
        if i == 0:
            masks.append(-1)
        elif i == len(start) - 1:
            masks.append(end[i - 1] - start[i])
        else:
            masks.append(overlap)
    return masks
