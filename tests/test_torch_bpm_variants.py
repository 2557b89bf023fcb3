"""The port's alternate approximate-count kernels' plain versions vs the JAX
package's Pallas kernels they stand for.

``approx_counts_packed_ref`` (the plain SWAR Myers and SWAR level NFA) and
``approx_counts_myers`` on CPU tensors (the plain Myers scan) get the same
numpy-seeded inputs as the Pallas kernels, run in interpret mode as the JAX
package's tests run them.  Counts are integers: every comparison is exact.

The ``cuda`` tests hold each CUDA kernel against its plain version on the
card; run them there with
``python -m pytest --noconftest -m cuda tests/test_torch_bpm_variants.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from approx_counter_tpu_torch import interop  # noqa: E402
from approx_counter_tpu_torch.core.codec import encode_kmer, split_code  # noqa: E402
from approx_counter_tpu_torch.kernels import bpm  # noqa: E402


@pytest.fixture
def jbpm():
    """The JAX package's kernels module (the GPU host has no JAX)."""
    return pytest.importorskip("approx_counter_tpu.kernels.bpm")


def _case(seed, k, C=16, W=128, m=40, pats=None, wins=None):
    """Symbols 0-5 (N and pad included), planted exact hits, 7 invalid
    windows; ``pats``/``wins`` override the random patterns and text."""
    rng = np.random.default_rng(seed)
    if pats is None:
        pats = rng.integers(0, 4, (C, k)).astype(np.uint8)
    if wins is None:
        wins = rng.integers(0, 6, (W, m)).astype(np.uint8)
        for w in range(0, W, 4):
            pos = rng.integers(0, m - k + 1)
            wins[w, pos:pos + k] = pats[w % len(pats)]
    valid = np.ones(len(wins), bool)
    valid[-7:] = False
    hi, lo = split_code(np.array([encode_kmer(p) for p in pats], np.uint64))
    return hi, lo, np.ascontiguousarray(wins.T), valid


def _torch_inputs(hi, lo, wins_t, valid, k, device="cpu"):
    peq = bpm.build_peq(interop.codes_to_torch(hi, lo, device), k)
    return (peq, interop.windows_to_torch(wins_t, device),
            interop.mask_to_torch(valid, device))


def _pallas_packed(jbpm, hi, lo, wins_t, valid, k, maxerr, pack, algo):
    C = len(hi)
    return np.asarray(jbpm.approx_counts_pallas_packed(
        jbpm.build_peq(hi, lo, k), wins_t, valid, k, ct=C, wt=128,
        interpret=True, maxerr=maxerr, pack=pack, algo=algo))


PACKED = [("myers", 5, 4), ("myers", 8, 4), ("myers", 16, 2),
          ("nfa", 2, 16), ("nfa", 4, 8), ("nfa", 8, 4), ("nfa", 16, 2),
          ("nfa", 20, 1), ("nfa", 32, 1)]


@pytest.mark.parametrize("algo,k,pack", PACKED)
@pytest.mark.parametrize("maxerr", [0, 2, 3])
def test_packed_ref_matches_pallas_interpret(jbpm, algo, k, pack, maxerr):
    case = _case(1000 * pack + 10 * k + maxerr, k)
    want = _pallas_packed(jbpm, *case, k, maxerr, pack, algo)
    got = bpm.approx_counts_packed_ref(*_torch_inputs(*case, k), k, maxerr,
                                       pack, algo)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,pack", [(8, 4), (16, 2), (32, 1)])
def test_packed_nfa_saturated_state_no_field_leak(jbpm, k, pack):
    """Poly-A candidates next to candidates with no A, against a poly-A
    text: every state bit of the poly-A fields is set, so each step shifts a
    1 into the neighbouring field (tests/test_bpm.py's leak case)."""
    rng = np.random.default_rng(k)
    pats = np.zeros((8, k), np.uint8)
    pats[1::2] = rng.integers(1, 4, (4, k))
    case = _case(0, k, pats=pats, wins=np.zeros((128, 40), np.uint8))
    args = _torch_inputs(*case, k)
    for maxerr in range(4):
        want = np.asarray(jbpm.approx_counts_jnp(
            jbpm.build_peq(case[0], case[1], k), case[2], case[3], k,
            maxerr=maxerr))
        got = bpm.approx_counts_packed(*args, k, maxerr, pack, "nfa")
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("algo,pack", [("nfa", 2), ("nfa", 16), ("myers", 2)])
def test_packed_k_at_most_maxerr(jbpm, algo, pack):
    """k <= maxerr: every window aligns to the empty substring, seeded by the
    NFA's initial state (tests/test_bpm.py ``test_nfa_maxerr_at_least_k``)."""
    k, W = 2, 128
    rng = np.random.default_rng(pack)
    case = _case(0, k, pats=rng.integers(0, 4, (4, k)).astype(np.uint8),
                 wins=rng.integers(0, 4, (W, 24)).astype(np.uint8))
    want = np.asarray(jbpm.approx_counts_jnp(
        jbpm.build_peq(case[0], case[1], k), case[2], case[3], k, maxerr=3))
    got = bpm.approx_counts_packed(*_torch_inputs(*case, k), k, 3, pack, algo)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 2 * (W - 7)).all()  # d_min <= k = 2 on every window


@pytest.mark.parametrize("k", [2, 16, 32])
def test_approx_counts_myers_matches_pallas_interpret(jbpm, k):
    hi, lo, wins_t, valid = _case(31 * k, k, C=32)
    want = np.asarray(jbpm.approx_counts_pallas(
        jbpm.build_peq(hi, lo, k), wins_t, valid, k, ct=32, wt=128,
        interpret=True, maxerr=2))
    got = bpm.approx_counts_myers(*_torch_inputs(hi, lo, wins_t, valid, k), k, 2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_count_no_launch_on_cpu():
    """On CPU tensors each wrapper runs its plain version and counts no
    launch; C need not be a multiple of the pack."""
    k = 8
    args = _torch_inputs(*_case(5, k, C=13), k)
    before = (bpm.approx_counts.launches, bpm.approx_counts_myers.launches,
              dict(bpm.approx_counts_packed.launches))
    want = bpm.approx_counts_ref(*args, k, 2)
    assert torch.equal(bpm.approx_counts(*args, k, 2), want)
    assert torch.equal(bpm.approx_counts_myers(*args, k, 2), want)
    for algo, pack in (("myers", 4), ("nfa", 1), ("nfa", 4)):
        assert torch.equal(bpm.approx_counts_packed(*args, k, 2, pack, algo),
                           want)
    after = (bpm.approx_counts.launches, bpm.approx_counts_myers.launches,
             dict(bpm.approx_counts_packed.launches))
    assert after == before


@pytest.mark.parametrize("algo,k,pack", [("myers", 8, 1), ("myers", 8, 8),
                                         ("myers", 9, 4), ("nfa", 17, 2),
                                         ("nfa", 3, 16), ("nfa", 8, 3),
                                         ("wu", 8, 2)])
def test_packed_rejects_what_no_kernel_takes(algo, k, pack):
    args = _torch_inputs(*_case(3, k, C=4), k)
    with pytest.raises(ValueError, match="no packed"):
        bpm.approx_counts_packed(*args, k, 2, pack, algo)
    with pytest.raises(ValueError, match="no packed"):
        bpm.approx_counts_packed_ref(*args, k, 2, pack, algo)


@pytest.mark.cuda
@pytest.mark.parametrize("algo,k,pack,maxerr", [
    ("myers", 2, 1, 3), ("myers", 32, 1, 2), ("myers", 16, 2, 2),
    ("myers", 8, 4, 3), ("nfa", 32, 1, 3), ("nfa", 16, 2, 2),
    ("nfa", 8, 4, 0), ("nfa", 4, 8, 3), ("nfa", 2, 16, 3)])
def test_cuda_kernels_match_plain(algo, k, pack, maxerr):
    """Each alternate CUDA kernel against its plain version and against the
    plain Myers scan on the card (pack 1 Myers is the unpacked kernel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    args = (*_torch_inputs(*_case(k, k, C=100, W=1000), k, "cuda"), k, maxerr)
    want = bpm.approx_counts_ref(*args)
    if algo == "myers" and pack == 1:
        n = bpm.approx_counts_myers.launches
        got = bpm.approx_counts_myers(*args)
        assert bpm.approx_counts_myers.launches == n + 1
    else:
        n = bpm.approx_counts_packed.launches[algo]
        got = bpm.approx_counts_packed(*args, pack, algo)
        assert bpm.approx_counts_packed.launches[algo] == n + 1
        assert torch.equal(got, bpm.approx_counts_packed_ref(*args, pack, algo))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
