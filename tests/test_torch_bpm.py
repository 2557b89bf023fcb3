"""The port's approximate-count kernels module vs the JAX package's.

The same numpy-seeded candidates and windows go through the JAX functions
and, converted by ``approx_counter_tpu_torch.interop``, through the port.
Counts are integers: every comparison is exact, with no tolerance.

The ``cuda`` tests hold the CUDA kernel against the plain version on the
card.  The GPU host has no JAX, so this file imports the JAX package only
through the ``jbpm`` fixture; run them there with
``python -m pytest --noconftest -m cuda tests/test_torch_bpm.py``.
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


def _case(seed, k, C=40, W=128, m=40):
    """The inputs of tests/test_bpm.py's sliced-NFA cases: symbols 0-5
    (N and pad included), planted exact hits, 7 invalid windows."""
    rng = np.random.default_rng(seed)
    pats = [rng.integers(0, 4, k).astype(np.uint8) for _ in range(C)]
    wins = rng.integers(0, 6, (W, m)).astype(np.uint8)
    for w in range(0, W, 4):
        pos = rng.integers(0, m - k + 1)
        wins[w, pos:pos + k] = pats[w % C]
    valid = np.ones(W, bool)
    valid[-7:] = False
    hi, lo = split_code(np.array([encode_kmer(p) for p in pats], np.uint64))
    return hi, lo, np.ascontiguousarray(wins.T), valid


def _torch_inputs(hi, lo, wins_t, valid, k, device="cpu"):
    peq = bpm.build_peq(interop.codes_to_torch(hi, lo, device), k)
    return (peq, interop.windows_to_torch(wins_t, device),
            interop.mask_to_torch(valid, device))


@pytest.mark.parametrize("k", [2, 3, 5, 16, 31, 32])
@pytest.mark.parametrize("maxerr", [0, 1, 2, 3])
def test_approx_counts_ref_matches_jnp(jbpm, k, maxerr):
    hi, lo, wins_t, valid = _case(100 * k + maxerr, k)
    want = np.asarray(jbpm.approx_counts_jnp(
        jbpm.build_peq(hi, lo, k), wins_t, valid, k, maxerr=maxerr))
    got = bpm.approx_counts_ref(*_torch_inputs(hi, lo, wins_t, valid, k), k,
                                maxerr=maxerr)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("W", [257, 700])
def test_approx_counts_ref_blocks_match_jnp(jbpm, W):
    """Past ``CPU_BLOCK`` windows the CPU scan runs in blocks; invalid
    windows straddle a block boundary."""
    assert bpm.CPU_BLOCK < W
    k = 16
    hi, lo, wins_t, valid = _case(W, k, C=24, W=W, m=30)
    valid[bpm.CPU_BLOCK - 3:bpm.CPU_BLOCK + 2] = False
    want = np.asarray(jbpm.approx_counts_jnp(
        jbpm.build_peq(hi, lo, k), wins_t, valid, k, maxerr=2))
    got = bpm.approx_counts_ref(*_torch_inputs(hi, lo, wins_t, valid, k), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


@pytest.mark.parametrize("k", [2, 16, 32])
@pytest.mark.parametrize("maxerr", [2, 3])
def test_approx_counts_matches_pallas_sliced_interpret(jbpm, k, maxerr):
    """The CPU dispatch of ``approx_counts`` against the Pallas kernel it
    ports, run in interpret mode as the JAX package's tests run it."""
    hi, lo, wins_t, valid = _case(7 * k + maxerr, k)
    want = np.asarray(jbpm.approx_counts_pallas_sliced(
        jbpm.build_peq(hi, lo, k), wins_t, valid, k, ctw=1, wt=128,
        interpret=True, maxerr=maxerr))
    launches = bpm.approx_counts.launches
    got = bpm.approx_counts(*_torch_inputs(hi, lo, wins_t, valid, k), k,
                            maxerr=maxerr)
    np.testing.assert_array_equal(got.numpy(), want)
    assert bpm.approx_counts.launches == launches  # CPU: no kernel launch


@pytest.mark.parametrize("k", [2, 7, 16, 17, 32])
def test_build_peq_and_sliced_planes_match_jax(jbpm, k):
    hi, lo, _, _ = _case(k, k, C=64)
    jpeq = np.asarray(jbpm.build_peq(hi, lo, k))
    peq = bpm.build_peq(interop.codes_to_torch(hi, lo), k)
    np.testing.assert_array_equal(interop.u32_from_torch(peq), jpeq)
    j0, j1 = jbpm.build_sliced_planes(jpeq, k)
    p0, p1 = bpm.build_sliced_planes(peq, k)
    np.testing.assert_array_equal(interop.u32_from_torch(p0), np.asarray(j0))
    np.testing.assert_array_equal(interop.u32_from_torch(p1), np.asarray(j1))


def test_approx_counts_rejects_bad_inputs():
    hi, lo, wins_t, valid = _case(3, 8)
    peq, wt, vt = _torch_inputs(hi, lo, wins_t, valid, 8)
    with pytest.raises(ValueError, match="peq must be int64"):
        bpm.approx_counts(peq.to(torch.int32), wt, vt, 8)
    with pytest.raises(ValueError, match="windows_t must be uint8"):
        bpm.approx_counts(peq, wt.to(torch.int64), vt, 8)
    with pytest.raises(ValueError, match="window_valid must be bool"):
        bpm.approx_counts(peq, wt, vt[:-1], 8)
    with pytest.raises(ValueError, match="contiguous"):
        bpm.approx_counts(peq, wt.t().contiguous().t(), vt, 8)
    with pytest.raises(ValueError, match="maxerr"):
        bpm.approx_counts(peq, wt, vt, 8, maxerr=4)


@pytest.mark.cuda
@pytest.mark.parametrize("k,maxerr", [(2, 3), (16, 2), (32, 3)])
def test_cuda_kernel_matches_ref(k, maxerr):
    """The CUDA kernel against the plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    hi, lo, wins_t, valid = _case(k, k, C=100, W=1000)
    args = _torch_inputs(hi, lo, wins_t, valid, k, "cuda")
    launches = bpm.approx_counts.launches
    got = bpm.approx_counts(*args, k, maxerr=maxerr)
    want = bpm.approx_counts_ref(*args, k, maxerr=maxerr)
    torch.cuda.synchronize()
    assert bpm.approx_counts.launches == launches + 1
    assert torch.equal(got, want)


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No nvcc, no kernel: the build raises instead of falling back."""
    from approx_counter_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_builds", {})
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nfa_sliced_build(16, 2)
    assert not list(tmp_path.iterdir())


@pytest.mark.cuda
def test_cuda_kernel_build_failure_raises(tmp_path, monkeypatch):
    """A source nvcc rejects raises with the compiler's message and leaves
    no library behind."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    from approx_counter_tpu_torch.kernels import _build

    bad = tmp_path / "csrc"
    bad.mkdir()
    (bad / "nfa_sliced.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(_build, "SRC_DIR", bad)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_builds", {})
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.nfa_sliced_build(16, 2)
    assert not list((tmp_path / "build").glob("*.so"))
