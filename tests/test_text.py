"""The numpy text reader against the reference's pandas semantics:
separator sniffing, ``chr`` matching, 5- and 3-column layouts, and rows
with a missing field dropped (``read_csv(header=None).dropna()``)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from mustache_tpu.io.text import read_table, read_text_contacts

RES = 5000
# (file text, chromosome, expected (x, y, v)); distance 2 Mb
CASES = {
    "tab_5col": (
        "chr21\t10000\tchr21\t25000\t4\n"
        "chr21\t30000\tchr21\t15000\t2.5\n"          # swapped -> upper tri
        "chr1\t10000\tchr1\t20000\t9\n"              # other chromosome
        "21\t50000\tchr21\t55000\t1\n"               # 'chr' prefix matched
        "chr21\t0\tchr21\t9000000\t7\n",             # beyond the band
        "21", ([2, 3, 10], [5, 6, 11], [4.0, 2.5, 1.0])),
    "space_3col": (
        "10000 25000 4\n"
        "30000 15000 2\n"
        "40000 40000 0\n",                           # zero count dropped
        "21", ([2, 3], [5, 6], [4.0, 2.0])),
    "comma_nan_row": (
        "10000,25000,4\n"
        "20000,30000,nan\n"                          # NaN row dropped
        "20000,,3\n"                                 # missing field dropped
        "35000,45000\n"                              # short row dropped
        "50000,55000,6\n",
        "21", ([2, 10], [5, 11], [4.0, 6.0])),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_text_reader_reference_semantics(tmp_path, name):
    text, chrom, (ex, ey, ev) = CASES[name]
    path = tmp_path / f"{name}.txt"
    path.write_text(text)
    x, y, v = read_text_contacts(str(path), 2_000_000, False, chrom, RES)
    order = np.lexsort((y, x))
    assert x.dtype == np.int64 and y.dtype == np.int64
    assert v.dtype == np.float64
    np.testing.assert_array_equal(x[order], ex)
    np.testing.assert_array_equal(y[order], ey)
    np.testing.assert_array_equal(v[order], ev)


def test_read_table_rejects_long_rows(tmp_path):
    path = tmp_path / "long.txt"
    path.write_text("1 2 3\n4 5 6 7\n")
    with pytest.raises(ValueError):
        read_table(str(path), " ")


def test_cli_imports_without_pandas():
    code = ("import sys; sys.modules['pandas'] = None; "
            "import mustache_tpu.cli, mustache_tpu.diff_cli, "
            "mustache_tpu.io.hicpro; print('ok')")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
