"""The port's ``--stream`` mode, its native parser and its reservoirs vs the
JAX package, on the CPU.

``run_pipeline`` with ``stream=True`` must export the same bytes, print the
same stdout (timestamps stripped) and stderr as the JAX package's for
FASTA, wrapped FASTA, FASTQ and gzip FASTQ, with reservoir replacement,
``-mr``, ``-se --compat-quirks``, short-read warnings and ``--from-exact``.
Below that: the record stream of the port's native chunk parser, on plain
and gzip files, against the JAX package's line iterators, the reservoir
batches
against ``stream_sample_windows``, and the native whole-file parser against
the JAX package's Python parser.  No tolerance: all compared exactly.
"""

import gzip
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from approx_counter_tpu.io import stream as jax_stream  # noqa: E402
from approx_counter_tpu.io.fastx import read_fastx_py as jax_read_py  # noqa: E402
from approx_counter_tpu_torch.io import stream  # noqa: E402
from approx_counter_tpu_torch.io.fastx import read_fastx, read_fastx_py  # noqa: E402
from test_torch_modes import assert_same, run_both  # noqa: E402
from test_torch_pipeline import (  # noqa: E402,F401
    ADAPTER,
    _write_fasta,
    jax_numpy_paths,
)


def _write_fastq(path, seed, n_reads, len_lo, len_hi, wrap=None,
                 compress=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_reads):
        s = rng.choice(list("ACGT"), int(rng.integers(len_lo, len_hi + 1)))
        if i % 3 and len(s) >= len(ADAPTER):
            s[:len(ADAPTER)] = list(ADAPTER)
        s = "".join(s)
        q = "".join(rng.choice(list("!#+@I"), len(s)))
        if wrap:
            s, q = ("\n".join(x[j:j + wrap] for j in range(0, len(x), wrap))
                    for x in (s, q))
        out.append(f"@read{i}\n{s}\n+\n{q}\n")
    data = "".join(out).encode()
    with open(path, "wb") as f:
        f.write(gzip.compress(data) if compress else data)


@pytest.mark.parametrize("cfg", [
    # identity sampling: every eligible read in both reservoirs
    dict(fasta=dict(seed=1, n_reads=40, len_lo=30, len_hi=120),
         prm=dict(k=8, sl=25, sn=100, limit=20, v=1, seed=3),
         stderr="Sequence set too small"),
    # sn below the eligible count: reservoir replacement draws
    dict(fasta=dict(seed=2, n_reads=300, len_lo=50, len_hi=300, wrap=37),
         prm=dict(k=12, sl=40, sn=60, limit=30, v=1, seed=4)),
    dict(fastq=dict(seed=3, n_reads=200, len_lo=60, len_hi=200),
         prm=dict(k=10, sl=30, sn=50, limit=25, v=1, seed=5)),
    # wrapped gzip FASTQ: the native chunk parser on the decompressed bytes
    dict(fastq=dict(seed=4, n_reads=200, len_lo=60, len_hi=200, wrap=50,
                    compress=True),
         prm=dict(k=10, sl=30, sn=50, limit=25, max_error=1, v=1, seed=6)),
    # -mr 2: the file streamed again per run, the rng carried on
    dict(fasta=dict(seed=5, n_reads=120, len_lo=60, len_hi=200, n_frac=0.01),
         prm=dict(k=17, sl=30, sn=40, limit=25, nb_of_runs=2, v=2, seed=7),
         stderr="sequences with 'N' symbols"),
    # -se --compat-quirks muted: the second reservoir samples starts again
    dict(fasta=dict(seed=6, n_reads=120, len_lo=60, len_hi=200),
         prm=dict(k=9, sl=30, sn=40, limit=25, nb_of_runs=2, skip_end=True,
                  compat_quirks=True, v=1, seed=8)),
    # -v 2: one short-read warning per read shorter than sl, file order
    dict(fasta=dict(seed=7, n_reads=150, len_lo=10, len_hi=150),
         prm=dict(k=8, sl=40, sn=30, limit=20, v=2, seed=9),
         stderr="Cut size is longer that current read! (read id: "),
    # solid mode on the stream
    dict(fasta=dict(seed=8, n_reads=200, len_lo=60, len_hi=200),
         prm=dict(k=11, sl=30, sn=80, limit=15, solid_km=3, v=1, seed=10)),
], ids=["fasta_identity", "wrapped_reservoir", "fastq", "gzip_fastq_wrapped",
        "mr2_k17_v2", "mr2_se_quirks", "v2_short_reads", "solid"])
def test_stream_matches_jax(tmp_path, capsys, cfg):
    path = tmp_path / "reads.in"
    if "fasta" in cfg:
        _write_fasta(path, **cfg["fasta"])
    else:
        _write_fastq(path, **cfg["fastq"])
    prm = dict(cfg["prm"], stream=True)
    want, got = run_both(tmp_path, capsys, path, **prm)
    n_runs = prm.get("nb_of_runs", 1)
    assert_same(want, got, 4 * n_runs)
    assert "Streaming pass" in got[1] or n_runs > 1
    assert cfg.get("stderr", "") in got[2]


def test_stream_from_exact_matches_jax(tmp_path, capsys):
    path = tmp_path / "reads.fasta"
    _write_fasta(path, 9, 150, 60, 200)
    prior = tmp_path / "prior.txt"
    prior.write_text("ACGTCCTAGC\t5\nCATTGCAGGA\t4\nACGTCCTAGC\t3\n"
                     + "".join(f"{'ACGT'[i % 4] * 5}ACGTA\t1\n"
                               for i in range(8)))
    want, got = run_both(tmp_path, capsys, path, k=10, sl=30, sn=60,
                         limit=9, v=1, seed=11, stream=True,
                         from_exact=str(prior))
    assert_same(want, got, 2)


def test_stream_equals_in_memory_at_identity(tmp_path, capsys):
    """``tests/test_stream.py:206``: with sn above the read count both
    modes see every eligible read, and counting ignores their order."""
    from approx_counter_tpu_torch.params import Params
    from approx_counter_tpu_torch.pipeline import run_pipeline

    path = tmp_path / "reads.fasta"
    _write_fasta(path, 10, 40, 40, 90)
    outs = {}
    for mode in ("mem", "stream"):
        d = tmp_path / mode
        d.mkdir()
        assert run_pipeline(Params(input_file=str(path),
                                   output=str(d / "o"), exact_out=str(d / "e"),
                                   k=6, sl=12, sn=100, limit=10, v=0, seed=1,
                                   stream=mode == "stream"),
                            device="cpu") == 0
        outs[mode] = sorted((p.name, p.read_bytes()) for p in d.iterdir())
    capsys.readouterr()
    assert outs["mem"] == outs["stream"]
    assert len(outs["mem"]) == 4


def test_stream_missing_file(tmp_path, capsys):
    from approx_counter_tpu_torch.__main__ import run
    from approx_counter_tpu_torch.params import Params

    missing = tmp_path / "none.fasta"
    assert run(Params(input_file=str(missing), stream=True, v=0), "cpu") == 1
    assert capsys.readouterr().err == (
        f"/!\\ ERROR: COULD NOT OPEN FILE {missing}\n")


# --- record streams ---------------------------------------------------------

RECORD_CASES = [
    # FASTA: wraps, lowercase, blank line, trailing no-newline
    (b">r0\nACGT\nTTNN\n>r1\nacgt\n\n>r2\nGG", False),
    # FASTQ: CRLF, '+' with tag, final record w/ truncated quality
    (b"@a\nACGT\n+\nIIII\n@b\r\nTTTT\r\n+x\r\nJJJJ\r\n@c\nGGGG\n+\nII", True),
    # multi-line FASTQ: wrapped seq + wrapped qual, qual lines starting
    # with '@' and '+', CRLF wraps, EOF mid-accumulation
    (b"@a\nACGT\nTTGG\nA\n+\n@IIII\n+JJ\nK\n"
     b"@b x\r\nCC\r\nGG\r\n+x\r\nII\r\nII\r\n@c\nAC\nGT", True),
    # a qual line exactly fills need at a chunk edge; final record closed
    # by a bare '+' tail at EOF
    (b"@a\nACGTT\nT\n+\nIII\nIII\n@b\nGG\nCC\n+", True),
]


def _long_fastq() -> bytes:
    rng = np.random.default_rng(0)
    parts = []
    for i in range(200):
        s = bytes(rng.choice(list(b"ACGTN"), int(rng.integers(1, 200))))
        parts.append(b"@r%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s)))
    return b"".join(parts)


@pytest.mark.parametrize("cs", [1, 3, 17, 4096])
def test_record_stream_matches_jax(tmp_path, cs):
    """``tests/test_stream.py:133``: the port's native chunk parser gives
    the JAX package's record sequence across chunk boundaries (1-byte
    chunks included) and EOF edge cases, on plain and gzip files."""
    from approx_counter_tpu.io.fastx import _TRANS

    for i, (data, fq) in enumerate(RECORD_CASES + [(_long_fastq(), True)]):
        j_iter = jax_stream._iter_fastq if fq else jax_stream._iter_fasta
        want = [r.translate(_TRANS) for r in j_iter(io.BytesIO(data), cs)]
        native = [batch.read(r).tobytes()
                  for batch in stream._iter_native(io.BytesIO(data), cs)
                  for r in range(len(batch))]
        assert native == want, (data[:40], cs)
        for gz in (False, True):
            f = tmp_path / f"c{i}{gz:d}"
            f.write_bytes(gzip.compress(data) if gz else data)
            got = [batch.read(r).tobytes()
                   for batch in stream.iter_read_batches(str(f), cs)
                   for r in range(len(batch))]
            assert got == want, (data[:40], cs, gz)
            assert got == [r.tobytes()
                           for r in jax_stream.iter_read_seqs(str(f), cs)]


def test_record_stream_errors_match_jax(tmp_path):
    for data in (b"@a\nACGT\n+\nIIIII\n@b\nA\n+\nI\n",  # quality mismatch
                 b"@a\nAC\n+\nII\nxyz\n",               # no '@' header
                 b"xyz\n"):                             # no format
        for gz in (False, True):
            f = tmp_path / f"bad{gz:d}"
            f.write_bytes(gzip.compress(data) if gz else data)
            with pytest.raises(ValueError) as want:
                list(jax_stream.iter_read_seqs(str(f), 3))
            with pytest.raises(ValueError) as got:
                list(stream.iter_read_batches(str(f), 3))
            if b"xyz" not in data[:3]:
                assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("end_is_start", [False, True])
def test_stream_sample_windows_matches_jax(tmp_path, capsys, seed,
                                           end_is_start):
    """Same seed, same batches: reservoir fills, replacement draws shared
    by the two reservoirs and short-read warnings at v=2, over several IO
    chunk sizes."""
    path = tmp_path / "r.fasta"
    _write_fasta(path, 20 + seed, 400, 10, 160, n_frac=0.01)
    for sn, cs in ((50, 1 << 22), (50, 999), (1000, 4096), (0, 1 << 22)):
        want = jax_stream.stream_sample_windows(
            str(path), sn, 30, rng=np.random.default_rng(seed), pad_to=8,
            chunk_size=cs, end_is_start=end_is_start, v=2)
        want_err = capsys.readouterr().err
        rng = np.random.default_rng(seed)
        got = stream.stream_sample_windows(
            str(path), sn, 30, rng=rng, pad_to=8, chunk_size=cs,
            end_is_start=end_is_start, v=2)
        assert capsys.readouterr().err == want_err
        assert "Cut size is longer" in want_err
        assert got[2] == want[2] == 400
        for g, w in zip(got[:2], want[:2]):
            assert g.n_valid == w.n_valid
            np.testing.assert_array_equal(g.windows, w.windows)
        # the generator is left where the JAX package leaves it
        j_rng = np.random.default_rng(seed)
        jax_stream.stream_sample_windows(str(path), sn, 30, rng=j_rng,
                                         chunk_size=cs,
                                         end_is_start=end_is_start)
        assert rng.integers(0, 1 << 40) == j_rng.integers(0, 1 << 40)


def test_batched_draws_equal_one_by_one():
    """The reservoirs draw a batch's slots with one ``integers`` call over
    an array of bounds; numpy gives the values of one call per bound."""
    bounds = np.repeat(np.arange(5, 70000, 7), 2)
    a, b = np.random.default_rng(4), np.random.default_rng(4)
    one_by_one = [int(a.integers(0, hi)) for hi in bounds]
    assert b.integers(0, bounds).tolist() == one_by_one
    assert a.integers(0, 1 << 40) == b.integers(0, 1 << 40)


# --- the native whole-file parser ---------------------------------------------


@pytest.mark.parametrize("data", [
    b">r0\nACGT\nTTNN\n>r1\nacgt\n\n>r2\nGG",
    b">r0\r\nACGTX\r\nAC\r\n>r1\n",
    b">only header",
    b"",
    b"@a\nACGT\n+\nIIII\n@b\r\nTTTT\r\n+x\r\nJJJJ\r\n\n\n@c\nGG\n+\nII\n",
    b"@a\nACGT\nTTGG\nA\n+\n@IIII\n+JJ\nK\n@b\nCC\n+\n++\n",
])
def test_native_read_fastx_matches_jax(tmp_path, data):
    from approx_counter_tpu_torch.io.native import read_fastx_native

    f = tmp_path / "x"
    f.write_bytes(data)
    want = jax_read_py(str(f))
    for got in (read_fastx(str(f)), read_fastx_native(str(f)),
                read_fastx_py(str(f))):
        np.testing.assert_array_equal(got.buf, want.buf)
        np.testing.assert_array_equal(got.offsets, want.offsets)


def test_native_read_fastx_large_and_gzip(tmp_path):
    path = tmp_path / "r.fasta"
    _write_fasta(path, 3, 500, 50, 900, n_frac=0.01, wrap=61)
    want = jax_read_py(str(path))
    got = read_fastx(str(path))
    np.testing.assert_array_equal(got.buf, want.buf)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    gz = tmp_path / "r.fasta.gz"
    gz.write_bytes(gzip.compress(path.read_bytes()))
    got = read_fastx(str(gz))
    np.testing.assert_array_equal(got.buf, want.buf)


@pytest.mark.parametrize("data", [
    b"@a\nACGT\n+\nIIIII\n",           # quality longer than the sequence
    b"@a\nACGT\n+\nII\n",              # quality cut by EOF
    b"@a\nACGT\nno plus line\n",       # truncated record
    b"@a\nAC\n+\nII\n>b\nAC\n",        # header of another format
])
def test_malformed_fastq_message_matches_jax(tmp_path, data):
    f = tmp_path / "bad.fastq"
    f.write_bytes(data)
    with pytest.raises(ValueError) as want:
        jax_read_py(str(f))
    with pytest.raises(ValueError) as got:
        read_fastx(str(f))
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("Malformed FASTQ")


def test_parser_build_without_gxx_raises(tmp_path, monkeypatch):
    """No g++, no parser: the build raises instead of falling back to the
    Python parser."""
    from approx_counter_tpu_torch.io import native
    from approx_counter_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_builds", {})
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    f = tmp_path / "r.fasta"
    f.write_bytes(b">a\nACGT\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        read_fastx(str(f))
    assert list(tmp_path.iterdir()) == [f]


def test_build_cache_is_keyed_by_the_toolchain(tmp_path, monkeypatch):
    """A cached library is reused by the same compiler, machine and C
    library, and rebuilt under another toolchain, never loaded from a
    build made elsewhere."""
    import ctypes

    from approx_counter_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "one.cpp"
    src.write_text('extern "C" int one() { return 1; }\n')

    def build():
        return _build._compile(_build._gxx, _build.GXX_FLAGS, src, "one")

    so, _, seconds = build()
    assert seconds > 0
    assert build()[0] == so and build()[2] == 0.0
    monkeypatch.setattr(_build, "_toolchain", lambda cc: b"another host")
    other, _, seconds = build()
    assert other != so and seconds > 0
    assert ctypes.CDLL(str(other)).one() == 1
    assert len(list((tmp_path / "build").glob("one_*.so"))) == 2
