"""The port's public host helpers vs the JAX package's.

The helpers: the codec's ``codes_to_seq``, ``is_dna`` and ``decode_kmer``;
the DUST ``complexity_score`` (bit-equal float32), ``complexity_score_np``
and ``have_low_complexity``; the CompareCount helpers
``compare_count_keys``, ``sort_by_compare_count`` and ``compare_count_np``;
``approx_count_rank``; ``print_counters``; and what each sub-package's
``__init__`` re-exports.  The same numpy-seeded inputs go through both
packages; every comparison is exact.
"""

import importlib
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from approx_counter_tpu_torch.core import codec, complexity, ordering  # noqa: E402
from approx_counter_tpu_torch.count.approx import approx_count_rank  # noqa: E402
from approx_counter_tpu_torch.io import export  # noqa: E402

jcodec = pytest.importorskip("approx_counter_tpu.core.codec")
jcomplexity = pytest.importorskip("approx_counter_tpu.core.complexity")
jordering = pytest.importorskip("approx_counter_tpu.core.ordering")


def _codes(rng, k, n, distinct=False):
    """uint64 codes of k-mers, bit 63 included at k = 32; a few of low
    complexity (poly-A, poly-T, a repeated dimer)."""
    top = 1 << (2 * k)
    codes = rng.integers(0, top - 1, n, dtype=np.uint64, endpoint=True)
    ac = int("01" * k, 2) & (top - 1)   # ACAC...
    codes[:3] = [0, top - 1, ac]
    if distinct:
        codes = np.unique(codes)
        rng.shuffle(codes)
    return codes


def _t(codes):
    return torch.from_numpy(codes.view(np.int64).copy())


@pytest.mark.parametrize("k", [2, 5, 16, 31, 32])
def test_codec_helpers_match(k):
    rng = np.random.default_rng(k)
    codes = _codes(rng, k, 40)
    for c, c64 in zip(codes.tolist(), codes.view(np.int64).tolist()):
        want = jcodec.decode_kmer(c, k)
        assert codec.decode_kmer(c, k) == want
        assert codec.decode_kmer(c64, k) == want   # negative at k = 32
    syms = rng.integers(0, 5, (6, k)).astype(np.uint8)
    syms[0] = syms[0] % 4
    for row in syms:
        seq = codec.codes_to_seq(row)
        assert seq == jcodec.codes_to_seq(row)
        for x in (row, seq, seq.lower(), seq.encode()):
            assert codec.is_dna(x) == jcodec.is_dna(x)
    assert codec.is_dna(syms[0]) and not codec.is_dna("ACGTN")
    assert codec.is_dna("acgt") and not codec.is_dna("ACGR")


@pytest.mark.parametrize("k", [2, 3, 8, 16, 17, 31, 32])
def test_complexity_helpers_match(k):
    rng = np.random.default_rng(k)
    codes = _codes(rng, k, 200)
    hi, lo = jcodec.split_code(codes)
    got = complexity.complexity_score(_t(codes), k).numpy()
    want = np.asarray(jcomplexity.complexity_score(hi, lo, k))
    assert got.dtype == np.float32 and want.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    want_np = jcomplexity.complexity_score_np(codes, k)
    for x in (codes, codes.view(np.int64)):
        got_np = complexity.complexity_score_np(x, k)
        assert np.array_equal(got_np.view(np.uint32), want_np.view(np.uint32))
    for thr in (0.5, 1.0, 2.0, 3.0, 100.0):
        got = complexity.have_low_complexity(_t(codes), k, thr).numpy()
        assert np.array_equal(
            got, np.asarray(jcomplexity.have_low_complexity(hi, lo, k, thr)))
        if k == 2:   # NaN score: never rejects
            assert not got.any()
    if k > 3:
        assert complexity.have_low_complexity(_t(codes[:2]), k, 1.0).all()


@pytest.mark.parametrize("k", [2, 8, 16, 32])
def test_ordering_helpers_match(k):
    """The keys map onto the JAX package's four uint32 keys one to one;
    sorting with a mask and extras and the host argsort give its order."""
    rng = np.random.default_rng(k)
    codes = _codes(rng, k, 300, distinct=True)
    n = len(codes)
    counts = rng.integers(0, 4, n).astype(np.int64)
    valid = rng.random(n) < 0.8
    extras = (np.arange(n, dtype=np.int64), rng.random(n).astype(np.float32))
    hi, lo = jcodec.split_code(codes)

    j1, j2, j3, j4 = (np.asarray(x).astype(np.int64) for x in
                      jordering.compare_count_keys(hi, lo, counts, k, valid))
    p1, p2, p3 = (x.numpy().astype(np.int64) for x in ordering.compare_count_keys(
        _t(codes), torch.from_numpy(counts), k, torch.from_numpy(valid)))
    assert np.array_equal(p1, j1 - (1 << 32))
    assert np.array_equal(p2, j2)
    # ~code as uint64 minus 2**63, in int64 arithmetic
    assert np.array_equal(p3, ((j3 << 32) | j4) ^ np.int64(-(1 << 63)))

    jout = [np.asarray(x) for x in jordering.sort_by_compare_count(
        hi, lo, counts, k, valid, extras)]
    pout = [x.numpy() for x in ordering.sort_by_compare_count(
        _t(codes), torch.from_numpy(counts), k, torch.from_numpy(valid),
        tuple(torch.from_numpy(e) for e in extras))]
    assert np.array_equal(pout[0].view(np.uint64),
                          jcodec.join_code(jout[0], jout[1]))
    for got, want in zip(pout[1:], jout[2:]):
        assert np.array_equal(got, want)
    # masked entries rank as count 0, after every count >= 1
    assert (np.diff(np.where(valid, counts, 0)[pout[2]]) <= 0).all()

    want = jordering.compare_count_np(codes, counts, k)
    assert np.array_equal(ordering.compare_count_np(codes, counts, k), want)
    assert np.array_equal(
        ordering.compare_count_np(codes.view(np.int64), counts, k), want)
    assert np.array_equal(ordering.compare_count_order(
        _t(codes), torch.from_numpy(counts), k).numpy(), want)


@pytest.mark.parametrize("k,maxerr", [(8, 2), (16, 3), (32, 1)])
def test_approx_count_rank_matches_jax(k, maxerr):
    """On the CPU against the JAX function on its jnp path: a padded
    selection (invalid slots scattered, code 0) with planted hits, some
    zero counts, and invalid tail windows."""
    from approx_counter_tpu.count.approx import approx_count_rank as jrank

    rng = np.random.default_rng(k + maxerr)
    cap, W, m = 40, 48, 45
    codes = _codes(rng, k, cap)
    sel_valid = rng.random(cap) < 0.75
    codes[~sel_valid] = 0
    wins = rng.integers(0, 4, (W, m)).astype(np.uint8)
    for w in range(0, W, 2):
        c = int(codes[w % cap])
        pat = [(c >> (2 * (k - 1 - i))) & 3 for i in range(k)]
        p = rng.integers(0, m - k + 1)
        wins[w, p:p + k] = pat
    n_valid = W - 5
    hi, lo = jcodec.split_code(codes)
    j_hi, j_lo, j_cnt, j_val = map(np.asarray, jrank(
        wins, np.int32(n_valid), hi, lo, sel_valid, k, ct=None, wt=None,
        use_pallas=False, maxerr=maxerr))
    p_codes, p_cnt, p_val = approx_count_rank(
        torch.from_numpy(wins), n_valid, _t(codes),
        torch.from_numpy(sel_valid), k, maxerr)
    assert np.array_equal(p_codes.numpy().view(np.uint64),
                          jcodec.join_code(j_hi, j_lo))
    assert np.array_equal(p_cnt.numpy(), j_cnt.astype(np.int64))
    assert np.array_equal(p_val.numpy(), j_val)
    n = int(sel_valid.sum())
    assert p_val[:n].all() and not p_val[n:].any()
    assert (p_cnt[:n] > 0).any() and (p_cnt[n:] == 0).all()


def test_print_counters_matches(capsys):
    from approx_counter_tpu.io.export import print_counters as jprint

    rng = np.random.default_rng(7)
    for k in (2, 16, 32):
        codes = _codes(rng, k, 30)
        counts = rng.integers(0, 1000, 30)
        jprint(codes, counts, k)
        want = capsys.readouterr().out
        export.print_counters(codes, counts, k)
        assert capsys.readouterr().out == want
        export.print_counters(codes.view(np.int64), counts, k)
        assert capsys.readouterr().out == want
        assert want.splitlines()[0] == (f"{jcodec.decode_kmer(int(codes[0]), k)}"
                                        f" {counts[0]}")


# JAX sub-package -> {name its __init__ exports: the port's counterpart}
REEXPORTS = {
    "core": {n: n for n in (
        "BASE_A", "BASE_C", "BASE_G", "BASE_N", "BASE_PAD", "BASE_T",
        "decode_kmer", "decode_kmers", "encode_kmer", "seq_to_codes",
        "codes_to_seq", "adjust_threshold", "complexity_score",
        "complexity_score_np")},
    "count": {"exact_count_select": "exact_count_select",
              "exact_count_select_rows": "exact_count_select"},
    "io": {n: n for n in ("Log", "Reads", "read_fastx", "export_counter",
                          "print_counters")},
    "kernels": {"approx_counts": "approx_counts",
                "approx_counts_jnp": "approx_counts_ref",
                "approx_counts_pallas": "approx_counts_myers",
                "build_peq": "build_peq"},
    "dist": {"approx_counts_sharded": "approx_counts_sharded",
             "data_mesh": "initialize", "shard_windows": "gather_windows"},
    "sample": {n: n for n in ("WindowBatch", "sample_windows")},
    "config": {n: n for n in ("parse_config", "build_parser",
                              "resolve_params")},
}


@pytest.mark.parametrize("sub", sorted(REEXPORTS))
def test_subpackage_reexports(sub):
    """Each JAX sub-package's exports have their counterpart in the port's
    sub-package, defined in the port."""
    jpkg = importlib.import_module(f"approx_counter_tpu.{sub}")
    pkg = importlib.import_module(f"approx_counter_tpu_torch.{sub}")
    exported = {n for n, v in vars(jpkg).items()
                if not n.startswith("_") and not inspect.ismodule(v)}
    assert exported == set(REEXPORTS[sub])
    for jname, name in REEXPORTS[sub].items():
        obj = getattr(pkg, name)
        if isinstance(obj, int):
            assert obj == getattr(jpkg, jname)
        else:
            assert obj.__module__.startswith(f"approx_counter_tpu_torch.{sub}.")
