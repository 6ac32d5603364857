"""CLI surface tests (text input path, reference flag semantics)."""

import numpy as np
import pytest

from mustache_tpu.cli import main, parse_args
from synthetic import synthetic_hic


@pytest.fixture(scope="module")
def contact_file(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    res = 5000
    x, y, v, anchors = synthetic_hic(2500, 200, seed=42, n_loops=40)
    path = tmp / "contacts.txt"
    with open(path, "w") as fh:
        for a, b, c in zip(x, y, v):
            fh.write(f"chr21\t{a*res}\tchr21\t{b*res}\t{c}\n")
    return str(path), anchors


def test_parse_args_defaults():
    a = parse_args(["-f", "x.txt", "-r", "5kb", "-o", "out.tsv"])
    assert a.pt == 0.2 and a.st == 0.88 and a.s_z == 1.6
    assert a.octaves == 2 and a.s == 10 and a.nprocesses == 4
    assert a.chromosome == "n"


def test_cli_end_to_end(contact_file, tmp_path):
    path, anchors = contact_file
    out = str(tmp_path / "loops.tsv")
    rc = main(["-f", path, "-ch", "21", "-r", "5kb", "-o", out,
               "-d", "1Mb", "-pt", "0.2", "-st", "0.88"])
    assert rc == 0
    lines = open(out).read().splitlines()
    assert lines[0].startswith("BIN1_CHR\tBIN1_START")
    assert len(lines) > 5
    cols = lines[1].split("\t")
    assert cols[0] == "21" and cols[3] == "21"
    assert int(cols[2]) - int(cols[1]) == 5000
    called = {(int(r.split("\t")[1]) // 5000, int(r.split("\t")[4]) // 5000)
              for r in lines[1:]}
    hits = sum(1 for a, b in called
               if any(abs(a - pa) <= 2 and abs(b - pb) <= 2 for pa, pb in anchors))
    assert hits >= 0.8 * len(called)


def test_cli_prefetch_matches_sequential(tmp_path):
    """The one-chromosome ingest lookahead must not change any output row
    (two-chromosome text run, prefetch on vs --engine-no-prefetch)."""
    res = 5000
    path = tmp_path / "two.txt"
    with open(path, "w") as fh:
        for chrom, seed in (("chr20", 7), ("chr21", 8)):
            x, y, v, _ = synthetic_hic(1200, 150, seed=seed, n_loops=20)
            for a, b, c in zip(x, y, v):
                fh.write(f"{chrom}\t{a*res}\t{chrom}\t{b*res}\t{c}\n")
    outs = []
    for extra in ([], ["--engine-no-prefetch"]):
        out = str(tmp_path / f"loops{len(extra)}.tsv")
        rc = main(["-f", str(path), "-ch", "20", "21", "-r", "5kb",
                   "-o", out, "-d", "750kb", "-pt", "0.2", "-st", "0.6"]
                  + extra)
        assert rc == 0
        outs.append(open(out).read())
    assert outs[0] == outs[1]
    assert len(outs[0].splitlines()) > 2


def test_cli_missing_file(tmp_path, capsys):
    rc = main(["-f", "/nonexistent", "-ch", "21", "-r", "5kb",
               "-o", str(tmp_path / "o.tsv")])
    assert rc == 1
    assert "Couldn't find the specified contact files" in capsys.readouterr().out


def test_cli_bad_resolution(contact_file, tmp_path, capsys):
    path, _ = contact_file
    rc = main(["-f", path, "-ch", "21", "-r", "bogus",
               "-o", str(tmp_path / "o.tsv")])
    assert rc == 1
    assert "Invalid resolution" in capsys.readouterr().out


def test_cli_text_requires_chromosome(contact_file, tmp_path, capsys):
    path, _ = contact_file
    rc = main(["-f", path, "-r", "5kb", "-o", str(tmp_path / "o.tsv")])
    assert rc == 1
    assert "chromosome name" in capsys.readouterr().out


def test_gate_failure_does_not_shift_prefetch(tmp_path):
    """A gated (inter-on-text) unit must discard its prefetched ingest:
    the unit after it must get its OWN contacts, not the gated unit's."""
    res = 5000
    path = tmp_path / "three.txt"
    anchors = {}
    with open(path, "w") as fh:
        for chrom, seed in (("chr20", 7), ("chr21", 8), ("chr23", 9)):
            x, y, v, a = synthetic_hic(1200, 150, seed=seed, n_loops=20)
            anchors[chrom] = a
            for aa, bb, cc in zip(x, y, v):
                fh.write(f"{chrom}\t{aa*res}\t{chrom}\t{bb*res}\t{cc}\n")
    out = str(tmp_path / "o.tsv")
    rc = main(["-f", str(path), "-ch", "20", "21", "23",
               "-ch2", "20", "22", "23", "-r", "5kb", "-o", out,
               "-d", "750kb", "-pt", "0.2", "-st", "0.6"])
    assert rc == 1   # the (21, 22) pair fails the text-format gate

    # chr23's calls must be chr23's own (solo-run comparison)
    solo = str(tmp_path / "solo.tsv")
    assert main(["-f", str(path), "-ch", "23", "-r", "5kb", "-o", solo,
                 "-d", "750kb", "-pt", "0.2", "-st", "0.6"]) == 0
    rows23 = [l for l in open(out).read().splitlines()[1:]
              if l.split("\t")[0] == "23"]
    solo_rows = open(solo).read().splitlines()[1:]
    assert rows23 == solo_rows and len(solo_rows) > 0


def test_cli_engine_warmup_matches(tmp_path):
    """--engine-warmup (AOT compile before ingest) must not change any
    output row, and must run its compile jobs when sizes are known."""
    res = 5000
    path = tmp_path / "w.txt"
    x, y, v, _ = synthetic_hic(1200, 150, seed=8, n_loops=20)
    with open(path, "w") as fh:
        for a, b, c in zip(x, y, v):
            fh.write(f"chr21\t{a*res}\tchr21\t{b*res}\t{c}\n")
    cz = tmp_path / "sizes.txt"
    cz.write_text(f"chr21\t{1200 * res}\n")
    outs = []
    for extra in ([], ["--engine-warmup", "-cz", str(cz)]):
        out = str(tmp_path / f"loops{len(extra)}.tsv")
        rc = main(["-f", str(path), "-ch", "21", "-r", "5kb", "-o", out,
                   "-d", "750kb", "-pt", "0.2", "-st", "0.6"] + extra)
        assert rc == 0
        outs.append(open(out).read())
    assert outs[0] == outs[1]
    assert len(outs[0].splitlines()) > 2


def test_cli_engine_warmup_without_sizes_skips(tmp_path, capsys):
    """Text input without -cz: shapes are unknowable ahead of ingest, so
    warmup is skipped (with a log note) and the run still completes."""
    res = 5000
    path = tmp_path / "nosizes.txt"
    x, y, v, _ = synthetic_hic(1200, 150, seed=8, n_loops=20)
    with open(path, "w") as fh:
        for a, b, c in zip(x, y, v):
            fh.write(f"chr21\t{a*res}\tchr21\t{b*res}\t{c}\n")
    out = str(tmp_path / "o.tsv")
    rc = main(["-f", str(path), "-ch", "21", "-r", "5kb", "-o", out,
               "-d", "750kb", "-pt", "0.2", "-st", "0.6", "--engine-warmup"])
    assert rc == 0
    assert len(open(out).read().splitlines()) > 2


def test_cli_engine_mesh_matches(tmp_path):
    """--engine-mesh block/rowshard (all 8 virtual devices) must produce
    the same loop calls as the single-device path (q to f32 normalize
    rounding for rowshard, which normalizes on the host)."""
    res = 5000
    path = tmp_path / "mesh.txt"
    x, y, v, _ = synthetic_hic(1200, 150, seed=9, n_loops=20)
    with open(path, "w") as fh:
        for a, b, c in zip(x, y, v):
            fh.write(f"chr21\t{a*res}\tchr21\t{b*res}\t{c}\n")
    outs = {}
    for mode in ("off", "block", "rowshard"):
        out = str(tmp_path / f"loops_{mode}.tsv")
        rc = main(["-f", str(path), "-ch", "21", "-r", "5kb", "-o", out,
                   "-d", "750kb", "-pt", "0.2", "-st", "0.6",
                   "--engine-mesh", mode])
        assert rc == 0, mode
        outs[mode] = open(out).read().splitlines()
    assert outs["block"] == outs["off"]
    assert len(outs["off"]) > 3
    # rowshard: same anchors/scales; q differs only by normalize rounding
    def calls(lines):
        return [tuple(l.split("\t")[:6]) + (l.split("\t")[7],)
                for l in lines[1:]]
    assert calls(outs["rowshard"]) == calls(outs["off"])
    import numpy as np
    q_off = np.array([float(l.split("\t")[6]) for l in outs["off"][1:]])
    q_rs = np.array([float(l.split("\t")[6]) for l in outs["rowshard"][1:]])
    np.testing.assert_allclose(q_rs, q_off, rtol=5e-3)


def test_engine_platform_choices():
    base = ["-f", "x.txt", "-r", "5kb", "-o", "out.tsv"]
    assert parse_args(base + ["--engine-platform", "gpu"]).platform == "gpu"
    assert parse_args(base + ["--engine-platform", "cpu"]).platform == "cpu"
    with pytest.raises(SystemExit):
        parse_args(base + ["--engine-platform", "tpu"])
