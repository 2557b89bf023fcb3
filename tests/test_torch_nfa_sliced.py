"""The plain candidate-bit-sliced level-NFA core vs the JAX package's
sliced NFA, its plain Myers scan, the port's plain versions and the
search-scheme oracle.

``approx_counts_nfa_sliced_ref`` repeats, step for step, the core that
``csrc/nfa_sliced.cu`` and ``csrc/nfa_packed.cu`` share
(``csrc/nfa_sliced.cuh``): 32 candidates a word, each text symbol's
matches read from the word's six-row match table, one state word per
level and pattern position, the word form's shifts as plane indices, the
levels above k - 1 constant.  On the adversarial windows of
``gpu_check.searchscheme_case`` (edge occurrences, one edit away, short
prefixes, all N, symbols 0-5, invalid windows) at C=37, past one
32-candidate word and a multiple of no pack above 1, it must equal the
JAX package's ``approx_counts_jnp`` (fed by the JAX ``build_peq``) and its
Pallas ``_nfa_kernel_sliced`` in interpret mode, the port's
``approx_counts_ref`` and ``search_scheme_error_count``, and on the same
inputs the plain SWAR level NFA ``approx_counts_packed_ref`` at every
pack.  Counts are integers: every comparison is exact, with no tolerance.

The ``cuda`` test holds both CUDA kernels on the core to it on the card.
The GPU host has no JAX, so this file imports the JAX package only through
a fixture; run it there with
``python -m pytest --noconftest -m cuda tests/test_torch_nfa_sliced.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from approx_counter_tpu_torch import gpu_check  # noqa: E402
from approx_counter_tpu_torch import searchscheme as ss  # noqa: E402
from approx_counter_tpu_torch.core.codec import split_code  # noqa: E402
from approx_counter_tpu_torch.kernels import bpm  # noqa: E402

KS = (2, 3, 4, 8, 16, 31, 32)
PACKS = (1, 2, 4, 8, 16)
C, W, M = 37, 24, 40


@pytest.fixture
def jbpm():
    """The JAX package's kernels module (the GPU host has no JAX)."""
    return pytest.importorskip("approx_counter_tpu.kernels.bpm")


def _case(k, maxerr, w=W):
    """(codes int64 [C], windows_t uint8 [M, w], valid bool [w])."""
    return gpu_check.searchscheme_case(
        np.random.default_rng(100 * k + maxerr), C, w, M, k)


def _args(codes, wins_t, valid, k, maxerr, device="cpu"):
    return (bpm.build_peq(torch.from_numpy(codes).to(device), k),
            torch.from_numpy(wins_t).to(device),
            torch.from_numpy(valid).to(device), k, maxerr)


def _oracle(codes, wins_t, valid, k, maxerr):
    texts = [wins_t[:, w] for w in np.flatnonzero(valid)]
    counts = ss.search_scheme_error_count(texts, codes, k, maxerr)
    return [counts[int(c)] for c in codes]


@pytest.mark.parametrize("maxerr", [0, 1, 2, 3])
@pytest.mark.parametrize("k", KS)
def test_sliced_ref_matches_jnp_ref_and_search_scheme(k, maxerr, jbpm):
    codes, wins_t, valid = _case(k, maxerr)
    got = bpm.approx_counts_nfa_sliced_ref(
        *_args(codes, wins_t, valid, k, maxerr))
    assert got.dtype == torch.int32 and got.shape == (C,)
    want = _oracle(codes, wins_t, valid, k, maxerr)
    assert sum(want) > 0
    assert got.tolist() == want
    hi, lo = split_code(codes.view(np.uint64))
    jax_counts = np.asarray(jbpm.approx_counts_jnp(
        jbpm.build_peq(hi, lo, k), wins_t, valid, k, maxerr=maxerr))
    np.testing.assert_array_equal(got.numpy(), jax_counts)
    assert torch.equal(
        got, bpm.approx_counts_ref(*_args(codes, wins_t, valid, k, maxerr)))


@pytest.mark.parametrize("k,maxerr", [(2, 3), (3, 2), (4, 0), (8, 1),
                                      (16, 2), (32, 3)])
def test_sliced_ref_matches_pallas_sliced_interpret(k, maxerr, jbpm):
    """The plain core against the Pallas kernel ``_nfa_kernel_sliced`` it
    mirrors, run in interpret mode as the JAX package's tests run it."""
    codes, wins_t, valid = _case(k, maxerr, w=32)
    hi, lo = split_code(codes.view(np.uint64))
    want = np.asarray(jbpm.approx_counts_pallas_sliced(
        jbpm.build_peq(hi, lo, k), wins_t, valid, k, ctw=1, wt=32,
        interpret=True, maxerr=maxerr))
    got = bpm.approx_counts_nfa_sliced_ref(
        *_args(codes, wins_t, valid, k, maxerr))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("maxerr", [0, 1, 2, 3])
@pytest.mark.parametrize("k,pack", [(k, p) for p in PACKS for k in KS
                                    if k <= 32 // p])
def test_sliced_ref_matches_packed_ref(k, pack, maxerr):
    """The bit-sliced core == the SWAR level NFA on interleaved words, the
    input ``nfa_packed.cu`` takes apart into planes (C=37: the last word
    holds pad candidates at every pack above 1)."""
    args = _args(*_case(k, maxerr), k, maxerr)
    assert torch.equal(bpm.approx_counts_nfa_sliced_ref(*args),
                       bpm.approx_counts_packed_ref(*args, pack, "nfa"))


@pytest.mark.parametrize("symbol", range(bpm.N_SYMBOLS))
@pytest.mark.parametrize("k", KS)
def test_match_table_rows(k, symbol):
    """Row s of the core's match table == the masks the core once computed
    at every step, (P0 ^ x0) & (P1 ^ x1) & vm for text symbol s, and bit c
    of word i set iff candidate c's base i is s: rows 4 (N) and 5 (pad)
    are zero."""
    codes = _case(k, 0)[0]
    peq = bpm.build_peq(torch.from_numpy(codes), k)
    peq = torch.cat([peq, peq.new_zeros((64 - C, 4))])
    P0, P1 = bpm.build_sliced_planes(peq, k)
    row = bpm.build_match_table(P0, P1)[symbol]
    assert row.shape == (2, k) and row.dtype == torch.int64
    m32 = 0xFFFFFFFF
    x0 = ((symbol & 1) - 1) & m32
    x1 = (((symbol >> 1) & 1) - 1) & m32
    vm = m32 if symbol < 4 else 0
    assert torch.equal(row, (P0 ^ x0) & (P1 ^ x1) & vm)
    bases = (torch.from_numpy(codes)[:, None]
             >> (2 * (k - 1 - torch.arange(k)))) & 3            # [C, k]
    bits = (row.reshape(2, 1, k) >> torch.arange(32)[None, :, None]) & 1
    assert torch.equal(bits.reshape(64, k)[:C].bool(), bases == symbol)
    # the zero peq rows that pad C to a word read as poly-A
    assert (bits.reshape(64, k)[C:] == int(symbol == 0)).all()


@pytest.mark.parametrize("k", [2, 16])
def test_sliced_ref_empty_text_and_no_candidates(k):
    """No text: only the constant levels hit, so each valid window adds
    max(0, maxerr + 1 - k); no candidate: an empty result."""
    codes = np.arange(5, dtype=np.int64)
    valid = np.array([1, 0, 1], bool)
    for maxerr in range(4):
        got = bpm.approx_counts_nfa_sliced_ref(
            *_args(codes, np.zeros((0, 3), np.uint8), valid, k, maxerr))
        assert got.tolist() == [2 * max(0, maxerr + 1 - k)] * 5
    got = bpm.approx_counts_nfa_sliced_ref(
        *_args(codes[:0], np.zeros((M, 3), np.uint8), valid, k, 2))
    assert got.shape == (0,) and got.dtype == torch.int32


@pytest.mark.cuda
def test_cuda_kernels_match_sliced_ref():
    """``nfa_sliced.cu`` and ``nfa_packed.cu`` at every pack == the plain
    bit-sliced core, the plain SWAR NFA and the search-scheme oracle on the
    card, past a 32-candidate word and a 256-window block; each launched
    once a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    for k, maxerr in ((2, 3), (3, 0), (4, 2), (8, 1), (16, 2), (17, 3),
                      (32, 2)):
        codes, wins_t, valid = gpu_check.searchscheme_case(
            np.random.default_rng(k), 70, 300, M, k)
        args = _args(codes, wins_t, valid, k, maxerr, "cuda")
        want = bpm.approx_counts_nfa_sliced_ref(*args)
        assert want.tolist() == _oracle(codes, wins_t, valid, k, maxerr)
        n = bpm.approx_counts.launches
        assert torch.equal(bpm.approx_counts(*args), want), (k, maxerr)
        assert bpm.approx_counts.launches == n + 1
        for pack in PACKS:
            if k <= 32 // pack:
                n = bpm.approx_counts_packed.launches["nfa"]
                got = bpm.approx_counts_packed(*args, pack, "nfa")
                assert torch.equal(got, want), (k, maxerr, pack)
                assert torch.equal(
                    got, bpm.approx_counts_packed_ref(*args, pack, "nfa"))
                assert bpm.approx_counts_packed.launches["nfa"] == n + 1
    torch.cuda.synchronize()
