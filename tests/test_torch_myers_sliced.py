"""The plain candidate-bit-sliced Myers core vs the JAX package's plain
Myers scan, the port's and the search-scheme oracle.

``approx_counts_myers_sliced_ref`` repeats, step for step, the core that
``csrc/bpm_myers.cu`` and ``csrc/bpm_packed.cu`` share
(``csrc/myers_sliced.cuh``): 32 candidates in k bit planes, the add's
carry rippled along the planes, a bit-sliced score.  On the adversarial
windows of ``gpu_check.searchscheme_case`` (edge occurrences, one edit
away, short prefixes, all N, symbols 0-5, invalid windows) at C=40, past
one 32-candidate word, it must equal the JAX package's ``approx_counts_jnp``
(fed by the JAX ``build_peq``), the port's ``approx_counts_ref`` and
``search_scheme_error_count``, and on the same inputs the plain SWAR Myers
``approx_counts_packed_ref`` at pack 2 and 4.  Counts are integers: every
comparison is exact, with no tolerance.

The ``cuda`` test holds both CUDA kernels to it on the card.  The GPU host
has no JAX, so this file imports the JAX package only through a fixture;
run it there with
``python -m pytest --noconftest -m cuda tests/test_torch_myers_sliced.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from approx_counter_tpu_torch import gpu_check  # noqa: E402
from approx_counter_tpu_torch import searchscheme as ss  # noqa: E402
from approx_counter_tpu_torch.core.codec import split_code  # noqa: E402
from approx_counter_tpu_torch.kernels import bpm  # noqa: E402

KS = (2, 3, 8, 15, 16, 17, 31, 32)
C, W, M = 40, 24, 40


@pytest.fixture
def jbpm():
    """The JAX package's kernels module (the GPU host has no JAX)."""
    return pytest.importorskip("approx_counter_tpu.kernels.bpm")


def _case(k, maxerr):
    """(codes int64 [C], windows_t uint8 [M, W], valid bool [W])."""
    return gpu_check.searchscheme_case(
        np.random.default_rng(100 * k + maxerr), C, W, M, k)


def _args(codes, wins_t, valid, k, maxerr, device="cpu"):
    return (bpm.build_peq(torch.from_numpy(codes).to(device), k),
            torch.from_numpy(wins_t).to(device),
            torch.from_numpy(valid).to(device), k, maxerr)


@pytest.mark.parametrize("maxerr", [0, 1, 2, 3])
@pytest.mark.parametrize("k", KS)
def test_sliced_ref_matches_jnp_ref_and_search_scheme(k, maxerr, jbpm):
    codes, wins_t, valid = _case(k, maxerr)
    got = bpm.approx_counts_myers_sliced_ref(
        *_args(codes, wins_t, valid, k, maxerr))
    assert got.dtype == torch.int32 and got.shape == (C,)
    texts = [wins_t[:, w] for w in np.flatnonzero(valid)]
    oracle = ss.search_scheme_error_count(texts, codes, k, maxerr)
    want = [oracle[int(c)] for c in codes]
    assert sum(want) > 0
    assert got.tolist() == want
    hi, lo = split_code(codes.view(np.uint64))
    jax_counts = np.asarray(jbpm.approx_counts_jnp(
        jbpm.build_peq(hi, lo, k), wins_t, valid, k, maxerr=maxerr))
    np.testing.assert_array_equal(got.numpy(), jax_counts)
    assert torch.equal(
        got, bpm.approx_counts_ref(*_args(codes, wins_t, valid, k, maxerr)))


@pytest.mark.parametrize("maxerr", [0, 1, 2, 3])
@pytest.mark.parametrize("k,pack", [(2, 2), (3, 2), (8, 2), (15, 2),
                                    (16, 2), (2, 4), (3, 4), (8, 4)])
def test_sliced_ref_matches_packed_ref(k, pack, maxerr):
    """The bit-sliced core == the SWAR Myers on interleaved words, the
    input ``bpm_packed.cu`` takes apart into planes."""
    args = _args(*_case(k, maxerr), k, maxerr)
    assert torch.equal(bpm.approx_counts_myers_sliced_ref(*args),
                       bpm.approx_counts_packed_ref(*args, pack, "myers"))


@pytest.mark.parametrize("k", [2, 16])
def test_sliced_ref_empty_text_and_no_candidates(k):
    """No text: the score stays k, so each valid window adds
    max(0, maxerr + 1 - k); no candidate: an empty result."""
    codes = np.arange(5, dtype=np.int64)
    valid = np.array([1, 0, 1], bool)
    for maxerr in range(4):
        got = bpm.approx_counts_myers_sliced_ref(
            *_args(codes, np.zeros((0, 3), np.uint8), valid, k, maxerr))
        assert got.tolist() == [2 * max(0, maxerr + 1 - k)] * 5
    got = bpm.approx_counts_myers_sliced_ref(
        *_args(codes[:0], np.zeros((M, 3), np.uint8), valid, k, 2))
    assert got.shape == (0,) and got.dtype == torch.int32


@pytest.mark.cuda
def test_cuda_kernels_match_sliced_ref():
    """``bpm_myers.cu`` and ``bpm_packed.cu`` (pack 2 and 4) == the plain
    bit-sliced core and the search-scheme oracle on the card, past a
    32-candidate word and a 256-window block; each launched once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    for k, maxerr in ((2, 3), (3, 0), (8, 1), (16, 2), (17, 3), (32, 2)):
        codes, wins_t, valid = gpu_check.searchscheme_case(
            np.random.default_rng(k), 70, 300, M, k)
        args = _args(codes, wins_t, valid, k, maxerr, "cuda")
        want = bpm.approx_counts_myers_sliced_ref(*args)
        texts = [wins_t[:, w] for w in np.flatnonzero(valid)]
        oracle = ss.search_scheme_error_count(texts, codes, k, maxerr)
        assert want.tolist() == [oracle[int(c)] for c in codes]
        n = bpm.approx_counts_myers.launches
        assert torch.equal(bpm.approx_counts_myers(*args), want), (k, maxerr)
        assert bpm.approx_counts_myers.launches == n + 1
        for pack in (2, 4):
            if k <= 32 // pack:
                n = bpm.approx_counts_packed.launches["myers"]
                got = bpm.approx_counts_packed(*args, pack, "myers")
                assert torch.equal(got, want), (k, maxerr, pack)
                assert bpm.approx_counts_packed.launches["myers"] == n + 1
    torch.cuda.synchronize()
