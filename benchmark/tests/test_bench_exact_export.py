"""The exact-count export (``-e``) in the harness and the check: a
configuration with ``exact_export`` gets ``-e`` into the run's directory,
and only such a one; its files are read and removed after each job; and
``exact_rows_wrong`` counts every row that differs from the reference's,
row by row in order, with missing and extra rows."""

import os

import numpy as np
import pytest
import torch

from benchmark import check, harness
from benchmark.reference import adaptfinder as ref
from benchmark.tests.test_bench_faults import CELLS


@pytest.mark.parametrize("name", CELLS)
def test_argv_takes_e_only_under_exact_export(tmp_path, name):
    cell = harness.load_cell(name)
    args, exact = cell.config["args"], cell.config.get("exact_export", False)
    jobs = harness.Jobs(args, "reads.fa", str(tmp_path), torch.device("cpu"),
                        exact=exact)
    out = str(tmp_path / "out")
    # as the harness gave every configuration before ``exact_export``
    want = args + ["--seed", "7", "-o", out, "reads.fa"]
    if exact:
        want[-1:-1] = ["-e", str(tmp_path / "exact")]
    assert jobs.argv(7) == want
    assert jobs.prm.exact_out == (str(tmp_path / "exact") if exact else "")


def test_exact_files_are_read_and_removed(tmp_path, tiny):
    cell = tiny("solid_k1.export")
    fasta, _ = harness.write_inputs(cell.traffic, str(tmp_path), 2**31 + 9)
    jobs = harness.Jobs(cell.config["args"], fasta, str(tmp_path),
                        torch.device("cpu"), exact=True)
    job = jobs.run(2**31 + 10)
    assert job.rc == 0, job.err
    assert os.listdir(tmp_path) == ["reads.fa"]
    assert len(job.exact_exports) == len(job.exports) == 2
    for raw in job.exact_exports:
        codes, counts, ok = check.parse_export(raw, 12)
        assert ok.all() and len(codes) > 40 and (counts >= 1).all()
    assert "Exporting exact kmer count" in job.log
    stats = check.pass_stats(job.log, job.err, 2)
    assert [s["n_keep"] for s in stats] == [
        raw.count(b"\n") for raw in job.exact_exports]


@pytest.fixture(scope="module")
def exact_pass():
    """One pass's windows, its exact selection from the reference at
    ``-sk 1`` and that export's bytes as the reference prints them."""
    rng = np.random.default_rng(5)
    windows = rng.integers(0, 4, (200, 40)).astype(np.uint8)
    windows[::3, 5:25] = windows[0, 5:25]   # some k-mers repeat
    ex = ref.exact_stage(windows, 12, 1.0, 40, 1, "cpu")
    raw = "".join(line + "\n" for line in
                  ref.export_lines(ex["codes"], ex["counts"], 12)).encode()
    return windows, ex, raw


def _rows(raw: bytes) -> list:
    return raw.decode().splitlines(keepends=True)


def _altered(raw):
    rows = _rows(raw)
    km, count = rows[3].split("\t")
    rows[3] = f"{km}\t{int(count) + 1}\n"
    return "".join(rows).encode()


@pytest.mark.parametrize("edit,wrong", [
    (lambda raw: raw, 0),
    (_altered, 1),                                       # one count altered
    (lambda raw: "".join(_rows(raw)[:-1]).encode(), 1),  # last row dropped
    (lambda raw: raw + b"ACGTACGTACGT\t1\n", 1),          # one row extra
    (lambda raw: raw.replace(b"\t", b" ", 1), 1),         # a malformed row
    (lambda raw: raw[:-1], 1),                           # no last newline
    (lambda raw: raw.replace(b"\t", b"\t0", 1), 1),       # a leading zero
], ids=["same", "altered", "dropped", "extra", "malformed", "unterminated",
        "leading_zero"])
def test_exact_rows_wrong_counts_each_row(exact_pass, edit, wrong):
    _, ex, raw = exact_pass
    got = check.parse_export(edit(raw), 12)
    assert check.exact_rows_wrong(got, ex["codes"], ex["counts"]) == wrong


def test_exact_rows_wrong_of_a_dropped_first_row_and_a_missing_file(
        exact_pass):
    """A row dropped at the top shifts every row after it; a file that is
    not there misses every row."""
    _, ex, raw = exact_pass
    n = len(ex["codes"])
    got = check.parse_export("".join(_rows(raw)[1:]).encode(), 12)
    assert check.exact_rows_wrong(got, ex["codes"], ex["counts"]) == n
    assert check.exact_rows_wrong(None, ex["codes"], ex["counts"]) == n


def test_first_cap_fails_the_exact_rows(exact_pass):
    """The control ``first_cap`` (``check.control_output``) exports the
    first 512 rows of a longer selection."""
    windows, ex, _ = exact_pass
    prm = harness.Jobs(["-k", "12", "-lim", "40", "-sk", "1"], "reads.fa",
                       "w", torch.device("cpu"), exact=True).prm
    got = check.control_output(windows, prm, "first_cap", "cpu")["exact"]
    assert len(ex["codes"]) > 512
    assert check.exact_rows_wrong(got, ex["codes"], ex["counts"]) == (
        len(ex["codes"]) - 512)
