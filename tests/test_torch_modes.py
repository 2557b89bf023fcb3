"""The port's solid mode (``-sk``), resume mode (``--from-exact``) and
``--profile`` on the CPU vs the JAX package, end to end.

As in ``test_torch_pipeline.py``: the same seeded input and ``Params`` go
through both ``run_pipeline``s; every exported file must be byte-equal,
stdout equal once the log's timestamps are stripped, and stderr equal.  No
tolerance: everything is compared byte for byte.
"""

import json
import os
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from approx_counter_tpu.count.exact import exact_count_select_rows  # noqa: E402
from approx_counter_tpu.core.codec import join_code, split_code  # noqa: E402
from approx_counter_tpu.io.export import (  # noqa: E402
    parse_exact_export as jax_parse_exact_export,
)
from approx_counter_tpu.io.fastx import InputFormatError as JaxFormatError  # noqa: E402
from approx_counter_tpu.params import Params as JaxParams  # noqa: E402
from approx_counter_tpu.pipeline import run_pipeline as jax_run  # noqa: E402
from approx_counter_tpu_torch.__main__ import run as torch_cli_run  # noqa: E402
from approx_counter_tpu_torch.params import Params  # noqa: E402
from approx_counter_tpu_torch.pipeline import run_pipeline  # noqa: E402
from test_torch_pipeline import (  # noqa: E402,F401
    _strip_ms,
    _write_fasta,
    jax_numpy_paths,
)


def _normalize(stdout: str) -> str:
    """Timestamps stripped; at -v 2 the numbers of the ``[stats]`` lines
    (times and rates) become ``#``, and their `` (pipelined)`` tag stays."""
    return re.sub(r"^\t*\[stats\].*$",
                  lambda line: re.sub(r"\d[\d.e+-]*", "#", line.group()),
                  _strip_ms(stdout), flags=re.M)


def run_both(tmp_path, capsys, input_file, **kw):
    """Both packages' ``run_pipeline`` on ``input_file`` with the same
    params, each writing into its own directory; returns per package (rc,
    stdout, stderr, {file name: bytes})."""
    outputs = {}
    for tag, run in (("jax", lambda p: jax_run(JaxParams(**p))),
                     ("torch", lambda p: run_pipeline(Params(**p),
                                                      device="cpu"))):
        d = tmp_path / tag
        d.mkdir()
        prm = dict(kw, input_file=str(input_file), output=str(d / "out.txt"),
                   exact_out=str(d / "exact.txt"))
        rc = run(prm)
        cap = capsys.readouterr()
        files = {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}
        outputs[tag] = (rc, _normalize(cap.out), cap.err, files)
    return outputs["jax"], outputs["torch"]


def assert_same(want, got, n_files):
    assert want[0] == got[0] == 0
    assert got[1] == want[1]  # stdout, timestamps stripped
    assert got[2] == want[2]  # stderr
    assert list(got[3]) == list(want[3])
    assert len(want[3]) == n_files
    for name, data in want[3].items():
        assert got[3][name] == data, name


def _random_fasta(path, seed, n_reads, read_len):
    """The JAX tests' uniform reads (``tests/test_pipeline.py:115``)."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n_reads):
            s = "".join("ACGT"[c] for c in rng.integers(0, 4, read_len))
            f.write(f">r{i}\n{s}\n")


# --- pipelined passes: the [stats] tag --------------------------------------


@pytest.mark.parametrize("case,prm,n_tagged", [
    # in memory: every pass after the first was prefetched, the next run's
    # start pass included
    ("mr2", dict(nb_of_runs=2), 3),
    # -se at -v 2: the break fires, one pass, nothing to prefetch
    ("se_quirks", dict(skip_end=True, compat_quirks=True), 0),
    # streaming prefetches the end pass within a run, never across runs
    ("stream_mr2", dict(stream=True, nb_of_runs=2), 2),
    # resume passes are not pipelined
    ("from_exact", dict(), 0),
])
def test_stats_tags_match_jax(tmp_path, capsys, case, prm, n_tagged):
    """At -v 2 the ``[stats]`` lines carry `` (pipelined)`` on exactly the
    passes the JAX package prefetched; reads shorter than ``sl`` make the
    sampler warn, and the prefetched passes' warnings come out deferred,
    at the reference's point in stderr."""
    fasta = tmp_path / "reads.fasta"
    _write_fasta(fasta, 21, 40, 15, 150, n_frac=0.01)
    prm = dict(prm, k=9, sl=30, sn=12, limit=15, v=2, seed=6)
    if case == "from_exact":
        prm["from_exact"] = str(_prior_export(tmp_path, capsys, fasta,
                                              dict(prm, v=0)))
    want, got = run_both(tmp_path, capsys, fasta, **prm)
    n_files = (2 if case == "from_exact" else 4) * prm.get("nb_of_runs", 1)
    if case == "se_quirks":
        n_files = 2
    assert_same(want, got, n_files)
    stats = [ln for ln in got[1].splitlines() if "[stats]" in ln]
    assert len(stats) == n_files // (1 if case == "from_exact" else 2)
    assert all(ln.endswith("[stats] sample # ms | count+score # ms"
                           + " (pipelined)" * (" (pipelined)" in ln)
                           + " | # windows/s | # pairs/s") for ln in stats)
    assert sum(" (pipelined)" in ln for ln in stats) == n_tagged
    assert "Cut size is longer that current read!" in got[2]


# --- solid mode ---------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    # tests/test_pipeline.py:115: k=7, sl=18, limit=25, -sk 2, identity
    dict(reads=dict(seed=15, n_reads=12, read_len=40),
         prm=dict(k=7, sl=18, sn=12, limit=25, solid_km=2, v=1, seed=3)),
    # tests/test_edge_cases.py:133: -sk 1 keeps every unique k-mer, past
    # the JAX package's first cap of 512 (it regrows; the port has no cap)
    dict(reads=dict(seed=1234, n_reads=40, read_len=80),
         prm=dict(k=10, sl=40, sn=100, limit=2000, solid_km=1, v=1, seed=0),
         min_keep=513),
    # two-word codes with Ns and a forbidden list
    dict(fasta=dict(seed=5, n_reads=80, len_lo=60, len_hi=200, n_frac=0.01),
         prm=dict(k=17, sl=40, sn=60, limit=30, solid_km=2, v=1, seed=8),
         forbid=True),
    # -mr 2 -se --compat-quirks --max-error 1, the approx ranking cut to 20
    dict(fasta=dict(seed=4, n_reads=40, len_lo=60, len_hi=120),
         prm=dict(k=8, sl=25, sn=30, limit=20, solid_km=3, nb_of_runs=2,
                  skip_end=True, compat_quirks=True, max_error=1, v=1,
                  seed=5)),
    # k = 24, the planted adapter's length, at -v 2
    dict(fasta=dict(seed=6, n_reads=40, len_lo=80, len_hi=150),
         prm=dict(k=24, sl=50, sn=40, limit=30, solid_km=2, v=2, seed=9)),
], ids=["sk2_k7", "sk1_past_cap", "sk2_k17_n_fk", "sk3_mr2_se_quirks",
        "sk2_k24_v2"])
def test_solid_mode_matches_jax(tmp_path, capsys, cfg):
    fasta = tmp_path / "reads.fasta"
    if "reads" in cfg:
        _random_fasta(fasta, **cfg["reads"])
    else:
        _write_fasta(fasta, **cfg["fasta"])
    prm = dict(cfg["prm"])
    if cfg.get("forbid"):
        (tmp_path / "forbid.txt").write_text(
            "ACGTCCTAGCATTGCAG\nCGTCCTAGCATTGCAGG\n")
        prm["forbid_kmer"] = str(tmp_path / "forbid.txt")
    want, got = run_both(tmp_path, capsys, fasta, **prm)
    n_runs = prm.get("nb_of_runs", 1)
    assert_same(want, got, 4 * n_runs)
    assert "Keeping solid k-mer" in got[1] or prm.get("nb_of_runs", 1) > 1
    exact = got[3]["exact.txt_0.start"].decode().splitlines()
    counts = [int(line.split("\t")[1]) for line in exact]
    assert len(exact) >= cfg.get("min_keep", 1)
    assert min(counts) >= prm["solid_km"]
    assert counts == sorted(counts, reverse=True)
    approx = got[3]["out.txt_0.start"].decode().splitlines()
    assert len(approx) == min(len(exact), prm["limit"])


def test_exact_count_select_solid_matches_jax():
    """The selection alone: ``solid_km`` keeps every passing code counted
    that often, whatever ``limit`` says."""
    from approx_counter_tpu.core.complexity import lc_sum_threshold
    from approx_counter_tpu_torch.count.exact import exact_count_select

    rng = np.random.default_rng(3)
    k, n, m = 6, 80, 30
    wins = rng.integers(0, 4, (n, m)).astype(np.uint8)
    wins[1::3] = wins[0]
    wins[5, 4] = 4
    wins_t = np.ascontiguousarray(wins.T)
    mask = np.ones(n, bool)
    mask[-3:] = False
    thr = lc_sum_threshold(1.0, k)
    for solid_km in (1, 2, 3, 30):
        fhi, flo = split_code(np.empty(0, np.uint64))
        ex = exact_count_select_rows(
            wins_t, mask, k, np.int32(thr), fhi, flo, np.int32(5),
            np.int32(solid_km), cap=4096, n_forbidden=0, use_solid=True,
            transposed=True)
        n_keep = int(ex["n_keep"])
        got = exact_count_select(
            torch.from_numpy(wins_t), torch.from_numpy(mask), k, thr,
            torch.zeros(0, dtype=torch.int64), 5, solid_km)
        assert got["n_keep"] == n_keep == got["n_pass"] == int(ex["n_pass"])
        assert n_keep > 5 if solid_km < 30 else n_keep == 0
        np.testing.assert_array_equal(
            got["sel_codes"].numpy().view(np.uint64),
            join_code(np.asarray(ex["sel_hi"])[:n_keep],
                      np.asarray(ex["sel_lo"])[:n_keep]))
        np.testing.assert_array_equal(got["sel_counts"].numpy(),
                                      np.asarray(ex["sel_count"])[:n_keep])


# --- resume mode ----------------------------------------------------------


def _prior_export(tmp_path, capsys, fasta, prm):
    """The JAX package's full run's exact ``.start`` export."""
    d = tmp_path / "prior"
    d.mkdir()
    assert jax_run(JaxParams(**prm, input_file=str(fasta),
                             output=str(d / "o"), exact_out=str(d / "e"))) == 0
    capsys.readouterr()
    return d / "e_0.start"


@pytest.mark.parametrize("case", ["jax_export", "repeats_past_limit",
                                  "empty", "k17_mr2"])
def test_resume_matches_jax(tmp_path, capsys, case):
    fasta = tmp_path / "reads.fasta"
    _write_fasta(fasta, 11, 50, 60, 140, n_frac=0.01)
    prm = dict(k=9, sl=30, sn=40, limit=20, v=1, seed=2)
    if case == "jax_export":
        prior = _prior_export(tmp_path, capsys, fasta, prm)
    elif case == "repeats_past_limit":
        prior = tmp_path / "prior.txt"
        lines = ["ACGTCCTAG\t9", "CGTCCTAGC\t8", "ACGTCCTAG\t7", "",
                 *(f"{'ACGT'[i % 4]}GCATTGCA\t1" for i in range(30)),
                 "TTTTTTTTT\t0"]
        prior.write_text("\n".join(lines) + "\n")
    elif case == "empty":
        prior = tmp_path / "prior.txt"
        prior.write_text("")
    else:
        prm.update(k=17, nb_of_runs=2, v=2, max_error=3)
        prior = _prior_export(tmp_path, capsys, fasta, prm)
    want, got = run_both(tmp_path, capsys, fasta, from_exact=str(prior),
                         **prm)
    n_runs = prm.get("nb_of_runs", 1)
    assert_same(want, got, 2 * n_runs)  # no exact export
    assert "Resuming from" in got[1]
    n_lines = len(got[3]["out.txt_0.start"].decode().splitlines())
    n_codes = len([ln for ln in prior.read_text().splitlines() if ln])
    assert n_lines == min(n_codes, prm["limit"])
    if case == "repeats_past_limit":
        # the repeated code is ranked twice, side by side
        ranked = got[3]["out.txt_0.start"].decode().splitlines()
        rep = [i for i, ln in enumerate(ranked) if ln.startswith("ACGTCCTAG\t")]
        assert len(rep) == 2 and rep[1] == rep[0] + 1


def test_resume_start_equals_full_run(tmp_path, capsys):
    """``tests/test_stream.py:230``: at identity sampling the resumed
    ``.start`` scores the same candidates against the same windows."""
    fasta = tmp_path / "reads.fasta"
    _write_fasta(fasta, 12, 20, 40, 40)
    d = tmp_path / "port"
    d.mkdir()
    prm = dict(input_file=str(fasta), k=6, sl=12, sn=100, limit=10, v=0,
               seed=1)
    assert run_pipeline(Params(**prm, output=str(d / "full"),
                               exact_out=str(d / "ex")), device="cpu") == 0
    assert run_pipeline(Params(**prm, output=str(d / "res"),
                               from_exact=str(d / "ex_0.start")),
                        device="cpu") == 0
    capsys.readouterr()
    assert (d / "res_0.start").read_bytes() == (d / "full_0.start").read_bytes()


def test_resume_wrong_k_exits_1_like_jax(tmp_path, capsys):
    fasta = tmp_path / "reads.fasta"
    _write_fasta(fasta, 1, 8, 60, 60)
    prior = tmp_path / "bad.start"
    prior.write_text("ACGTACGTA\t5\nACGT\t5\n")
    prm = dict(input_file=str(fasta), output=str(tmp_path / "o"),
               from_exact=str(prior), k=9, sl=20, v=0)
    with pytest.raises(JaxFormatError) as e:
        jax_run(JaxParams(**prm))
    capsys.readouterr()
    assert torch_cli_run(Params(**prm), "cpu") == 1
    err = capsys.readouterr().err
    assert err == f"/!\\ ERROR: {e.value}\n"
    assert f"{prior}:2: 'ACGT' is not a pure-ACGT 9-mer" in err
    assert not list(tmp_path.glob("o_*"))


def test_parse_exact_export_matches_jax(tmp_path):
    from approx_counter_tpu_torch.io.export import parse_exact_export

    p = tmp_path / "e.txt"
    p.write_text("TTTTGGGGCCCCAAAATTTTGGGGCCCCAAAA\t3\n\n"
                 "ACGTACGTACGTACGTACGTACGTACGTACGT\t1\n"
                 "TTTTGGGGCCCCAAAATTTTGGGGCCCCAAAA\t0\n")
    got = parse_exact_export(str(p), 32)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, jax_parse_exact_export(str(p), 32))
    assert got[0] == got[2] and int(got[0]) >= 1 << 63
    assert len(parse_exact_export(str(tmp_path / "e.txt"), 32)) == 3
    (tmp_path / "n.txt").write_text("ACGN\t1\n")
    with pytest.raises(ValueError, match="n.txt:1: 'ACGN'"):
        parse_exact_export(str(tmp_path / "n.txt"), 4)


def test_missing_resume_file_names_it(tmp_path, capsys, monkeypatch):
    """A missing ``--from-exact`` file exits 1 with the JAX package's CLI
    stderr byte for byte: the errno that ``open`` raises, 2, where the file
    name might be expected."""
    from approx_counter_tpu.__main__ import main as jax_main
    from approx_counter_tpu_torch.config.cli import resolve_params

    monkeypatch.setenv("APPROX_COUNTER_CACHE", "off")
    fasta = tmp_path / "reads.fasta"
    _write_fasta(fasta, 1, 8, 60, 60)
    argv = [str(fasta), "-o", str(tmp_path / "o"), "--from-exact",
            str(tmp_path / "missing.txt"), "-k", "9", "-sl", "20", "-v", "0"]
    assert jax_main(argv) == 1
    want = capsys.readouterr()
    assert torch_cli_run(resolve_params(argv), "cpu") == 1
    got = capsys.readouterr()
    assert (got.out, got.err) == (want.out, want.err)
    assert got.err == "/!\\ ERROR: COULD NOT OPEN FILE 2\n"
    assert not list(tmp_path.glob("o_*"))


# --- profile ----------------------------------------------------------------


def test_profile_writes_trace_and_same_exports(tmp_path, capsys):
    fasta = tmp_path / "reads.fasta"
    _write_fasta(fasta, 2, 60, 100, 200)
    files = {}
    for tag in ("plain", "profiled"):
        d = tmp_path / tag
        d.mkdir()
        prm = Params(input_file=str(fasta), output=str(d / "out.txt"),
                     exact_out=str(d / "exact.txt"), k=12, sl=40, sn=50,
                     limit=30, seed=4,
                     profile_dir=str(tmp_path / "trace" / "run")
                     if tag == "profiled" else "")
        assert torch_cli_run(prm, "cpu") == 0
        files[tag] = {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}
    capsys.readouterr()
    assert files["plain"] == files["profiled"]
    assert len(files["plain"]) == 4
    with open(tmp_path / "trace" / "run" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"start pass", "end pass"} <= names


# --- the sliced kernel's launch plan ---------------------------------------


@pytest.mark.parametrize("n_words,plan", [
    (1, [(0, 1)]),
    (16, [(0, 16)]),
    (65535, [(0, 65535)]),  # C = 2,097,120: one launch, as before
    (65536, [(0, 65535), (65535, 1)]),
    (65625, [(0, 65535), (65535, 90)]),  # C = 2,100,000
    (3 * 65535 + 7, [(0, 65535), (65535, 65535), (131070, 65535),
                     (196605, 7)]),
])
def test_word_launches_cover_the_words(n_words, plan):
    from approx_counter_tpu_torch.kernels.bpm import MAX_GRID_Y, word_launches

    got = word_launches(n_words)
    assert got == plan
    assert all(0 < n <= MAX_GRID_Y for _, n in got)
    assert sum(n for _, n in got) == n_words
    assert all(a + n == b for (a, n), (b, _) in zip(got, got[1:]))


# --- the alternate kernels' launch plan -------------------------------------


@pytest.mark.parametrize("rows,group,plan", [
    (1, 32, [(0, 1)]),
    (500, 32, [(0, 500)]),
    (2097120, 32, [(0, 2097120)]),  # Myers C = 2,097,120: one launch
    (2097121, 32, [(0, 2097120), (2097120, 1)]),
    (2100000, 32, [(0, 2097120), (2097120, 2880)]),  # C = 2,100,000
    (2 * 2097120 + 9, 32, [(0, 2097120), (2097120, 2097120), (4194240, 9)]),
    (1050000, 16, [(0, 1048560), (1048560, 1440)]),  # pack 2, C = 2,100,000
    (525000, 4, [(0, 262140), (262140, 262140), (524280, 720)]),  # pack 8
    (131250, 2, [(0, 131070), (131070, 180)]),  # pack 16, C = 2,100,000
])
def test_group_launches_cover_the_rows(rows, group, plan):
    """``word_launches`` with ``group`` rows a ``grid.y`` block, as the
    kernels on a bit-sliced core take their 32 candidates (unpacked Myers:
    32 rows; packed Myers and the packed NFA: 32 // pack words): every
    launch holds at most 65,535 whole groups, and the launches tile the
    rows in order."""
    from approx_counter_tpu_torch.kernels.bpm import (
        MAX_GRID_Y,
        SLICED_CANDS,
        word_launches,
    )

    assert SLICED_CANDS == 32
    assert group in (SLICED_CANDS // p for p in (1, 2, 4, 8, 16))
    got = word_launches(rows, group)
    assert got == plan
    assert all(-(-n // group) <= MAX_GRID_Y for _, n in got)
    assert all(a % group == 0 for a, _ in got)
    assert sum(n for _, n in got) == rows
    assert all(a + n == b for (a, n), (b, _) in zip(got, got[1:]))


@pytest.mark.parametrize("name,const", [("bpm_myers.cu", "kCands"),
                                        ("bpm_packed.cu", "kCands"),
                                        ("nfa_packed.cu", "kCands")])
def test_group_size_matches_the_kernel_source(name, const):
    """The wrappers' group size is the rows a block of the kernel takes:
    the 32 candidates of the bit-sliced core it includes (``kCands`` in
    ``myers_sliced.cuh`` or ``nfa_sliced.cuh``); the packed kernels take
    them as kCands / PACK words."""
    from approx_counter_tpu_torch.kernels.bpm import SLICED_CANDS

    csrc = (Path(__file__).resolve().parents[1] / "approx_counter_tpu_torch"
            / "csrc")
    src = (csrc / name).read_text()
    core, ns = (("nfa_sliced.cuh", "nfa") if name.startswith("nfa")
                else ("myers_sliced.cuh", "myers"))
    assert f'#include "{core}"' in src
    defs = (csrc / core).read_text()
    n = int(re.search(rf"constexpr int {const} = (\d+);", defs).group(1))
    assert n == SLICED_CANDS
    if name != "bpm_myers.cu":
        assert f"kWords = {ns}::kCands / PACK;" in src
    assert "groups > 65535" in src  # the one-launch limit the plan serves

