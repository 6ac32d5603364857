"""HiC-Pro ``.matrix`` + ``.bed`` loader (working, beyond-reference).

The reference CLI advertises ``-bed``/``-m`` (mustache.py:76-89) but never
uses the bed: it sets ``f = args.mat`` (mustache.py:969-970) and feeds the
matrix to the plain-text reader, whose 3-column path treats HiC-Pro's
sequential *bin ids* as genomic midpoints (``//res``, mustache.py:282-288)
— every coordinate collapses toward bin 0. Here the bed is honored:

* bed: ``chrom  start  end  bin_id`` (HiC-Pro's genome-wide, sequential,
  resolution-spaced fragments)
* matrix: ``bin_id1  bin_id2  count`` (upper-triangular sparse)

Bin ids on the requested chromosome are mapped to in-chromosome bin
indices ``start // res``; the distance filter, bias division at both
anchors, positivity filter, and upper-triangular orientation then follow
the text-path semantics exactly (mustache.py:264-277).
"""

from __future__ import annotations

import numpy as np

from mustache_tpu.io.text import read_table, sniff_separator, strip_chr


def read_hicpro(matrix_path: str, bed_path: str, distance_bp: int, bias,
                chromosome, res: int):
    """COO triplets ``(x, y, v)`` for one chromosome from HiC-Pro output."""
    from mustache_tpu.io.chrom import normalize_chrom

    empty = (np.array([], np.int64), np.array([], np.int64),
             np.array([], np.float64))

    bed = read_table(bed_path, sniff_separator(bed_path), str_cols=(0,))
    if len(bed) < 4:
        raise ValueError(
            f"HiC-Pro bed needs 4 columns (chrom start end id), "
            f"got {len(bed)} in {bed_path}")
    want = normalize_chrom(chromosome)
    on_chrom = strip_chr(bed[0]) == want
    if not on_chrom.any():
        return empty
    ids = bed[3].astype(np.int64)[on_chrom]
    starts = bed[1].astype(np.int64)[on_chrom]
    bed_rows = np.nonzero(on_chrom)[0]   # file line number per kept id
    # bin id -> in-chromosome bin index (dense lookup over the id range)
    id_lo, id_hi = int(ids.min()), int(ids.max())
    id_to_bin = np.full(id_hi - id_lo + 1, -1, np.int64)
    id_to_bin[ids - id_lo] = starts // res
    # bin id -> bed file line: the key space of 1-column (HiC-Pro ICE)
    # bias files, whose factors are one line per genome-wide bed row
    id_to_row = np.full(id_hi - id_lo + 1, -1, np.int64)
    id_to_row[ids - id_lo] = bed_rows

    mat = read_table(matrix_path, sniff_separator(matrix_path))
    if len(mat) != 3:
        raise ValueError(
            f"HiC-Pro matrix needs 3 columns (id1 id2 count), "
            f"got {len(mat)} in {matrix_path}")
    i1 = mat[0].astype(np.int64)
    i2 = mat[1].astype(np.int64)
    v = mat[2]

    keep = (i1 >= id_lo) & (i1 <= id_hi) & (i2 >= id_lo) & (i2 <= id_hi)
    i1, i2, v = i1[keep], i2[keep], v[keep]
    b1 = id_to_bin[i1 - id_lo]
    b2 = id_to_bin[i2 - id_lo]
    keep = (b1 >= 0) & (b2 >= 0)
    i1, i2 = i1[keep], i2[keep]
    b1, b2, v = b1[keep], b2[keep], v[keep]

    # same band filter as the text path (on bp distance, mustache.py:264)
    keep = np.abs(b1 - b2) * res <= (distance_bp / res + 1) * res
    i1, i2 = i1[keep], i2[keep]
    b1, b2, v = b1[keep], b2[keep], v[keep]

    if bias:
        if getattr(bias, "by_line", False):
            # 1-column bias: factors are keyed by genome-wide bed line
            k1 = id_to_row[i1 - id_lo]
            k2 = id_to_row[i2 - id_lo]
        else:
            # 3-column bias: keyed by chromosome-local bin (midpoint//res)
            k1, k2 = b1, b2
        v = v / bias.lookup(k1)
        v = v / bias.lookup(k2)

    pos = v > 0
    b1, b2, v = b1[pos], b2[pos], v[pos]
    x = np.minimum(b1, b2).astype(np.int64)
    y = np.maximum(b1, b2).astype(np.int64)
    return x, y, np.asarray(v, np.float64)
