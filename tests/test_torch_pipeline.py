"""The port's ``run_pipeline`` on the CPU vs the JAX package's, end to end.

Both run on the same seeded FASTA with the same ``Params``.  The exported
``.start``/``.end`` files must be byte-equal, stdout equal once the log's
``[<ms> ms]\\t`` timestamps are stripped, and stderr equal.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from approx_counter_tpu.io import native as jax_native  # noqa: E402
from approx_counter_tpu.params import Params as JaxParams  # noqa: E402
from approx_counter_tpu.pipeline import run_pipeline as jax_run  # noqa: E402
from approx_counter_tpu_torch.__main__ import main as torch_main  # noqa: E402
from approx_counter_tpu_torch.params import Params  # noqa: E402
from approx_counter_tpu_torch.pipeline import run_pipeline  # noqa: E402

ADAPTER = "ACGTCCTAGCATTGCAGGATCCAT"


@pytest.fixture(autouse=True)
def jax_numpy_paths(monkeypatch):
    """The JAX package runs on its numpy paths here: its native library,
    ``native/libfastx.so``, reports itself not built.  That library is
    built while the suite runs (``tests/test_io.py``), and a JAX run in
    another worker could load it half-written.  The JAX package's own
    tests hold its native and numpy paths equal.  The port's test files
    that run the JAX package import this fixture."""
    def not_built():
        raise ImportError("the JAX package's native library is not used "
                          "by the port's tests")

    monkeypatch.setattr(jax_native, "_load", not_built)


def _write_fasta(path, seed, n_reads, len_lo, len_hi, n_frac=0.0,
                 wrap=None):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n_reads):
            s = rng.choice(list("ACGT"), int(rng.integers(len_lo, len_hi + 1)))
            if i % 4 != 3 and len(s) >= len(ADAPTER):
                s[:len(ADAPTER)] = list(ADAPTER)
            s[rng.random(len(s)) < n_frac] = "N"
            s = "".join(s)
            if wrap:
                s = "\n".join(s[j:j + wrap] for j in range(0, len(s), wrap))
            f.write(f">read{i}\n{s}\n")


def _strip_ms(text):
    return re.sub(r"^\[[^\]\n]* ms\]\t", "", text, flags=re.M)


def _run_both(tmp_path, capsys, **kw):
    fasta = str(tmp_path / "reads.fasta")
    outputs = {}
    for tag, run in (("jax", lambda p: jax_run(JaxParams(**p))),
                     ("torch", lambda p: run_pipeline(Params(**p),
                                                      device="cpu"))):
        d = tmp_path / tag
        d.mkdir()
        prm = dict(kw, input_file=fasta, output=str(d / "out.txt"),
                   exact_out=str(d / "exact.txt"))
        rc = run(prm)
        cap = capsys.readouterr()
        files = {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}
        outputs[tag] = (rc, _strip_ms(cap.out), cap.err, files)
    return outputs["jax"], outputs["torch"]


@pytest.mark.parametrize("cfg", [
    # the tests/test_pipeline.py fixture: identity sampling, sn clamped
    dict(fasta=dict(seed=1234, n_reads=16, len_lo=80, len_hi=80, wrap=40),
         prm=dict(k=8, sl=25, sn=21, limit=15, v=1, seed=7),
         stderr="Sequence set too small"),
    # the default k and sl, sub-sampled
    dict(fasta=dict(seed=2, n_reads=400, len_lo=250, len_hi=600),
         prm=dict(k=16, sl=100, sn=300, v=1, seed=3)),
    # Ns, a forbidden list and --max-error 1
    dict(fasta=dict(seed=3, n_reads=60, len_lo=80, len_hi=150, n_frac=0.02),
         prm=dict(k=10, sl=30, sn=50, limit=40, max_error=1, v=1, seed=4),
         forbid="ACGTCCTAGC\nCGTCCTAGCA\nNNNNNNNNNN\n",
         stderr="sequences with 'N' symbols"),
    # -mr 2 -se --compat-quirks: muted runs, the end pass re-samples starts
    dict(fasta=dict(seed=4, n_reads=40, len_lo=60, len_hi=120),
         prm=dict(k=8, sl=25, sn=30, limit=25, nb_of_runs=2, skip_end=True,
                  compat_quirks=True, v=1, seed=5)),
    # two-word codes: k = 17 with Ns and --max-error 3
    dict(fasta=dict(seed=5, n_reads=80, len_lo=60, len_hi=200, n_frac=0.01),
         prm=dict(k=17, sl=40, sn=60, limit=40, max_error=3, v=1, seed=8),
         stderr="sequences with 'N' symbols"),
    # k = 32: codes starting with G or T have bit 63 set
    dict(fasta=dict(seed=6, n_reads=60, len_lo=80, len_hi=150),
         prm=dict(k=32, sl=50, sn=50, limit=30, v=1, seed=9)),
], ids=["fixture", "k16_sl100", "n_fk_maxerr1", "mr2_se_quirks", "k17_n_maxerr3",
        "k32"])
def test_run_pipeline_matches_jax(tmp_path, capsys, cfg):
    _write_fasta(tmp_path / "reads.fasta", **cfg["fasta"])
    prm = dict(cfg["prm"])
    if "forbid" in cfg:
        (tmp_path / "forbid.txt").write_text(cfg["forbid"])
        prm["forbid_kmer"] = str(tmp_path / "forbid.txt")
    want, got = _run_both(tmp_path, capsys, **prm)
    assert want[0] == got[0] == 0
    assert got[1] == want[1]  # stdout, timestamps stripped
    assert got[2] == want[2]  # stderr
    assert cfg.get("stderr", "") in want[2]
    assert list(got[3]) == list(want[3])
    assert len(want[3]) >= 2
    for name, data in want[3].items():
        assert got[3][name] == data, name


@pytest.mark.parametrize("end", [False, True])
def test_sample_windows_matches_jax(tmp_path, capsys, end):
    """Same seed, same reads, same windows -- and at v=2 the same per-read
    short-read warnings, in walk order."""
    from approx_counter_tpu.io.fastx import read_fastx as jax_read
    from approx_counter_tpu.sample.sampler import sample_windows as jax_sample
    from approx_counter_tpu_torch.io.fastx import read_fastx
    from approx_counter_tpu_torch.sample.sampler import sample_windows

    path = tmp_path / "r.fasta"
    _write_fasta(path, 6, 60, 10, 90, n_frac=0.01)  # short reads included
    for sn in (25, 1000):
        want = jax_sample(jax_read(str(path)), sn, 30, end=end,
                          rng=np.random.default_rng(sn), pad_to=8, v=2)
        want_err = capsys.readouterr().err
        got = sample_windows(read_fastx(str(path)), sn, 30, end=end,
                             rng=np.random.default_rng(sn), pad_to=8, v=2)
        assert capsys.readouterr().err == want_err
        assert "Cut size is longer" in want_err
        assert got.n_valid == want.n_valid > 0
        np.testing.assert_array_equal(got.windows, want.windows)


@pytest.mark.parametrize("argv", [
    ["--stream"],
    ["--from-exact", "prior.txt"],
    ["-sk", "3"],
    ["--profile", "trace"],
], ids=["stream", "from-exact", "sk", "profile"])
def test_flag_runs_like_jax(tmp_path, capsys, argv):
    """The flags the port once refused run through ``resolve_params`` and
    ``run_pipeline`` like the JAX package's (``--profile`` is the CLI's
    wrapper around the run, so the pipeline ignores it in both)."""
    from approx_counter_tpu.config.cli import resolve_params as jax_resolve
    from approx_counter_tpu_torch.config.cli import resolve_params

    fasta = str(tmp_path / "r.fasta")
    _write_fasta(fasta, 1, 30, 60, 90)
    (tmp_path / "prior.txt").write_text("ACGTCCTAGCAT\t4\nTTGCAGGATCCA\t2\n")
    argv = [str(tmp_path / a) if a == "prior.txt" else a for a in argv]
    results = []
    for tag, resolve, run in (("jax", jax_resolve, jax_run),
                              ("torch", resolve_params,
                               lambda p: run_pipeline(p, device="cpu"))):
        out = str(tmp_path / f"{tag}_o")
        rc = run(resolve([fasta, "-k", "12", "-sl", "30", "-sn", "20",
                          "-lim", "15", "--seed", "3", "-o", out,
                          "-e", str(tmp_path / f"{tag}_e"), *argv]))
        cap = capsys.readouterr()
        files = {p.name[len(tag) + 1:]: p.read_bytes()
                 for p in sorted(tmp_path.glob(f"{tag}_*"))}
        results.append((rc, _strip_ms(cap.out), cap.err, files))
    want, got = results
    assert got == want
    assert got[0] == 0
    assert len(got[3]) == (2 if "--from-exact" in argv else 4)
    assert not (tmp_path / "trace").exists()


@pytest.mark.parametrize("k", [17, 33])
def test_k_range_matches_jax(tmp_path, capsys, k):
    """-k 17 runs like the JAX package's (no longer refused by the port);
    -k 33 exits 1 with its message and writes nothing."""
    from approx_counter_tpu.config.cli import resolve_params as jax_resolve
    from approx_counter_tpu_torch.config.cli import resolve_params

    fasta = str(tmp_path / "r.fasta")
    _write_fasta(fasta, 7, 12, 60, 90)
    results = []
    for tag, resolve, run in (("jax", jax_resolve, jax_run),
                              ("torch", resolve_params,
                               lambda p: run_pipeline(p, device="cpu"))):
        out = str(tmp_path / f"{tag}_o")
        rc = run(resolve([fasta, "-k", str(k), "-sl", "40", "-sn", "12",
                          "-lim", "20", "--seed", "3", "-o", out]))
        cap = capsys.readouterr()
        files = {p.name[len(tag) + 1:]: p.read_bytes()
                 for p in sorted(tmp_path.glob(f"{tag}_o*"))}
        results.append((rc, _strip_ms(cap.out), cap.err, files))
    want, got = results
    assert got == want
    assert got[0] == (0 if k == 17 else 1)
    if k == 33:
        assert got[2] == ("/!\\ ERROR: kmer size must be between 2 and 32 "
                          "(included)\n")
        assert not got[3]
    else:
        assert len(got[3]) == 2  # o_0.start, o_0.end


def test_cli_without_cuda_exits_1(tmp_path, capsys, monkeypatch):
    """The CLI runs on the GPU only: with no CUDA device it exits 1 and
    writes nothing, instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _write_fasta(tmp_path / "r.fasta", 1, 8, 60, 60)
    rc = torch_main([str(tmp_path / "r.fasta"), "-o", str(tmp_path / "o")])
    assert rc == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not list(tmp_path.glob("o_*"))
