"""Plain-text contact loader.

Accepts the two reference text layouts (mustache.py:254-297):

* 5-column ``chrom1 mid1 chrom2 mid2 count``
* 3-column ``mid1 mid2 count``

and returns upper-triangular COO triplets ``(x, y, v)`` in bin units with
the band filter ``|mid1 - mid2| <= (distance_bp/res + 1) * res`` applied on
the original bp coordinates (reference line :264) and counts divided by the
bias factor at both anchors.
"""

from __future__ import annotations

import numpy as np

# field values that the reference's pandas reader turns into NaN (and its
# dropna then drops): empty fields and the usual missing-value markers
_NA = frozenset({"", "NA", "N/A", "n/a", "NaN", "nan", "-NaN", "-nan",
                 "null", "NULL", "None", "#N/A", "<NA>"})


def sniff_separator(path: str) -> str:
    """Guess the column separator from the first line (mustache.py:199-215)."""
    with open(path) as fh:
        for line in fh:
            if "\t" in line:
                return "\t"
            if " " in line.strip():
                return " "
            if "," in line:
                return ","
            if len(line.split(" ")) == 1:
                return " "
            break
    raise FileNotFoundError(path)


def read_table(path: str, sep: str, str_cols=()) -> list[np.ndarray]:
    """Columns of a headerless delimited text file, with every row that
    has a missing field dropped — the numpy twin of the reference's
    ``pd.read_csv(path, sep=sep, header=None).dropna()``.

    The column count comes from the first non-blank line. A row with fewer
    fields, an empty field or a missing-value marker is dropped; a row
    with more fields is an error, as in pandas. Columns listed in
    ``str_cols`` come back as str arrays, the others as float64. Blank
    lines are skipped."""
    with open(path) as fh:
        first = next((ln for ln in fh if ln.strip()), None)
    if first is None:
        return []
    width = len(first.rstrip("\r\n").split(sep))
    fields = [(f"f{i}", "U64" if i in str_cols else "f8")
              for i in range(width)]
    try:
        # fast path: numpy's C parser, one pass over clean files
        arr = np.loadtxt(path, delimiter=sep, dtype=fields, comments=None,
                         ndmin=1)
        cols = [arr[name] for name, _ in fields]
    except ValueError:
        cols = _read_table_rows(path, sep, width, str_cols)
    keep = np.ones(len(cols[0]), bool)
    for i, col in enumerate(cols):
        if i in str_cols:
            keep &= ~np.isin(col, list(_NA))
        else:
            keep &= ~np.isnan(col)
    return [col[keep] for col in cols]


def _read_table_rows(path, sep, width, str_cols):
    """Row-by-row parse for files the fast path refuses (short rows, empty
    fields); rows with a missing field are dropped here already."""
    cols = [[] for _ in range(width)]
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.rstrip("\r\n")
            if not line.strip():
                continue
            parts = line.split(sep)
            if len(parts) > width:
                raise ValueError(
                    f"{path}:{lineno}: expected {width} fields, "
                    f"saw {len(parts)}")
            if len(parts) < width or any(p.strip() in _NA for p in parts):
                continue
            for i, p in enumerate(parts):
                cols[i].append(p if i in str_cols else float(p))
    return [np.asarray(c, dtype=str if i in str_cols else np.float64)
            for i, c in enumerate(cols)]


def strip_chr(names: np.ndarray) -> np.ndarray:
    """Chromosome names with every ``chr`` removed, as the reference
    matches them (``.str.replace("chr", "")``)."""
    return np.char.replace(names.astype(str), "chr", "")


def read_text_contacts(path: str, distance_bp: int, bias, chromosome, res: int):
    """Load COO triplets for one chromosome from a text contact list.

    ``bias`` is a :class:`mustache_tpu.io.bias.BiasVector` or ``False``.
    Returns ``(x, y, v)`` int64/int64/float64 arrays, possibly empty.
    """
    from mustache_tpu.io.chrom import normalize_chrom

    empty = (np.array([], np.int64), np.array([], np.int64), np.array([], np.float64))
    sep = sniff_separator(path)
    with open(path) as fh:
        first = next((ln for ln in fh if ln.strip()), "")
    ncols = len(first.rstrip("\r\n").split(sep))
    if ncols == 5:
        c1, m1, c2, m2, count = read_table(path, sep, str_cols=(0, 2))
        want = normalize_chrom(chromosome)
        chrom_ok = (strip_chr(c1) == want) & (strip_chr(c2) == want)
        if not chrom_ok.any():
            return empty
        m1, m2, count = m1[chrom_ok], m2[chrom_ok], count[chrom_ok]
    elif ncols == 3:
        m1, m2, count = read_table(path, sep)
    else:
        raise ValueError(f"unsupported column count {ncols} in {path}")

    keep = np.abs(m1 - m2) <= (distance_bp / res + 1) * res
    m1, m2, v = m1[keep], m2[keep], count[keep]

    b1 = np.floor_divide(m1, res)
    b2 = np.floor_divide(m2, res)
    if bias:
        v = v / bias.lookup(b1)
        v = v / bias.lookup(b2)

    pos = v > 0
    b1, b2, v = b1[pos], b2[pos], v[pos]
    x = np.minimum(b1, b2).astype(np.int64)
    y = np.maximum(b1, b2).astype(np.int64)
    return x, y, np.asarray(v, dtype=np.float64)
