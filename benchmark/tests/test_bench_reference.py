"""The plain reference gives the exports of the port's CPU path on a tiny
file, byte for byte, pass by pass; it imports nothing but NumPy and
PyTorch."""

import ast
import contextlib
import io

import numpy as np
import pytest
import torch

from benchmark import check, generate
from benchmark.harness import BENCH
from benchmark.reference import adaptfinder as ref
from benchmark.tests.test_bench_generator import TINY


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "reads.fa"
    generate.write_fasta(str(path), TINY, 2**31 + 5)
    return str(path)


@pytest.mark.parametrize("args", [
    ["-sn", "300", "-sl", "60", "-k", "12", "-lim", "40", "-mr", "2"],
    ["-sn", "300", "-sl", "60", "-k", "12", "-lim", "40", "-sk", "2"],
    ["-sn", "250", "-sl", "50", "-k", "16", "-lim", "25", "--max-error",
     "1", "-lc", "1.5"],
    ["-sn", "500", "-sl", "70", "-k", "9", "-lim", "30", "--max-error",
     "3", "-sk", "3"],
])
def test_reference_equals_port(tmp_path, fasta, args):
    from approx_counter_tpu_torch.__main__ import run
    from approx_counter_tpu_torch.config.cli import resolve_params

    seed = 2**31 + 77
    out = str(tmp_path / "out")
    prm = resolve_params(args + ["--seed", str(seed), "-o", out, fasta])
    log, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(log), contextlib.redirect_stderr(err):
        assert run(prm, torch.device("cpu")) == 0
    passes = [(r, e) for r in range(prm.nb_of_runs) for e in ("start", "end")]
    stats = check.pass_stats(log.getvalue(), err.getvalue(), len(passes))
    buf, offsets = ref.read_fasta(fasta)
    sampler = ref.Sampler(buf, offsets, prm.sn, prm.sl, seed)
    for p, (r, end) in enumerate(passes):
        windows = sampler.windows(p, end == "end")
        ex = ref.exact_stage(windows, prm.k, prm.param_lc, prm.limit,
                             prm.solid_km, "cpu")
        counts = ref.approx_counts(ex["codes"], windows, prm.k,
                                   prm.max_error, "cpu")
        codes, counts = ref.rank(ex["codes"], counts, prm.k, prm.limit)
        want = "".join(line + "\n" for line in
                       ref.export_lines(codes, counts, prm.k))
        with open(f"{out}_{r}.{end}") as f:
            assert f.read() == want, (r, end)
        assert stats[p]["had_n"] == ex["had_n"]
        if prm.nb_of_runs == 1:
            assert (stats[p]["n_unique"], stats[p]["n_keep"],
                    stats[p]["n_valid"]) == (ex["n_unique"], ex["n_keep"],
                                             len(windows))


def test_myers_equals_dynamic_programming():
    """The bit-vector distance is Sellers' semi-global distance."""
    rng = np.random.default_rng(3)
    k = 8
    codes = rng.integers(0, 4**k, 40).astype(np.uint64)
    windows = rng.integers(0, 5, (30, 25)).astype(np.uint8)
    windows[:, :k] = ref._patterns(codes[:30], k)  # some exact hits
    pats = torch.from_numpy(ref._patterns(codes, k))
    got = ref._dmin_edit(pats, torch.from_numpy(windows), k).numpy()
    ham = ref._dmin_hamming(pats, torch.from_numpy(windows), k).numpy()
    for c in range(len(codes)):
        for w in range(len(windows)):
            want = sellers(ref._patterns(codes[c:c + 1], k)[0], windows[w])
            assert got[c, w] == want
            assert ham[c, w] >= want


def sellers(pat, text) -> int:
    prev = [0] * (len(text) + 1)
    for i, p in enumerate(pat, 1):
        cur = [i]
        for j, t in enumerate(text, 1):
            cur.append(min(prev[j - 1] + (p != t or t > 3), prev[j] + 1,
                           cur[j - 1] + 1))
        prev = cur
    return min(prev)


def test_read_fasta_wrapped_lines(tmp_path):
    path = tmp_path / "w.fa"
    path.write_bytes(b">a x\nACGT\nacgn\r\n>b\n\n>c\nTTRA\n")
    buf, offsets = ref.read_fasta(str(path))
    assert offsets.tolist() == [0, 8, 8, 12]
    assert buf.tolist() == [0, 1, 2, 3, 0, 1, 2, 4, 3, 3, 4, 0]


def test_reference_imports_only_numpy_and_torch():
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                names.add((node.module or "").split(".")[0])
        assert names <= {"__future__", "numpy", "torch"}, (path, names)
