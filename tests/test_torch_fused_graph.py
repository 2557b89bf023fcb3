"""The fused pass's packed output and its CUDA graph.

The packed vector must carry every field of a fixed-shape pass through
one fetch: ``pack_pass_output`` then ``unpack_pass_output`` gives back the
scalars, the codes (both words at k > 16, so k = 32's negative int64 codes
too), the counts and the validity masks.  The ``cuda`` test holds the
graph on the card: its replays equal the body run eagerly there and the
CPU's pass, and the count kernel's counter goes up by one for the warm-up
and by one for each replay, never for the capture.  The GPU host has no
JAX and this file imports none; run the ``cuda`` test there with
``python -m pytest --noconftest -m cuda tests/test_torch_fused_graph.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from approx_counter_tpu_torch.kernels import bpm  # noqa: E402
from approx_counter_tpu_torch.params import Params  # noqa: E402
from approx_counter_tpu_torch.pipeline import (  # noqa: E402
    Engine,
    pack_pass_output,
    pass_cap,
    unpack_pass_output,
)


@pytest.mark.parametrize("k", [16, 17, 32])
def test_pack_pass_output_round_trips(k):
    cap = 256
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 1 << (2 * k), 2 * cap, dtype=np.uint64)
    as_t = lambda c: torch.from_numpy(c.view(np.int64))  # noqa: E731
    ex = dict(sel_codes=as_t(codes[:cap]),
              sel_counts=torch.from_numpy(rng.integers(0, 1 << 31, cap)),
              sel_valid=torch.arange(cap) < 100,
              n_unique=torch.tensor(2_792_355), n_keep=torch.tensor(100),
              had_n=torch.tensor(7), n_pass=torch.tensor(123))
    approx = (as_t(codes[cap:]),
              torch.from_numpy(rng.integers(0, 1 << 31, cap)).int(),
              torch.arange(cap) < 90)
    packed = pack_pass_output(ex, approx, k)
    assert packed.dtype == torch.int32
    assert packed.numel() == 4 + (8 if k > 16 else 6) * cap
    out = unpack_pass_output(packed.numpy(), cap, k)
    exact = out["exact"]
    assert [int(exact[n]) for n in ("n_unique", "n_keep", "had_n",
                                    "n_pass")] == [2_792_355, 100, 7, 123]
    join = lambda hi, lo: (hi.astype(np.uint64) << np.uint64(32)) | lo  # noqa: E731
    np.testing.assert_array_equal(join(exact["sel_hi"], exact["sel_lo"]),
                                  codes[:cap])
    np.testing.assert_array_equal(exact["sel_count"],
                                  ex["sel_counts"].numpy())
    np.testing.assert_array_equal(exact["sel_valid"], ex["sel_valid"].numpy())
    np.testing.assert_array_equal(join(out["approx_hi"], out["approx_lo"]),
                                  codes[cap:])
    np.testing.assert_array_equal(out["approx_count"], approx[1].numpy())
    np.testing.assert_array_equal(out["approx_valid"], approx[2].numpy())


@pytest.mark.cuda
def test_fused_graph_replays_the_eager_body():
    """On the card: two passes through the graph equal the CPU's pass and
    the body run eagerly; the kernel's counter counts the warm-up and the
    two replays (three launches), not the capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    rng = np.random.default_rng(3)
    n, m, n_valid, k = 300, 41, 290, 12
    wins = rng.integers(0, 4, (n, m)).astype(np.uint8)
    wins[::3, 4:30] = rng.integers(0, 4, 26).astype(np.uint8)
    prm = Params(k=k, sl=m - 1, limit=20)
    engine, cpu = Engine(prm, "cuda"), Engine(prm, "cpu")
    try:
        before = bpm.approx_counts.launches
        got = [engine.count_one_end(wins, n_valid) for _ in range(2)]
        assert bpm.approx_counts.launches == before + 3
        want = cpu.count_one_end(wins, n_valid)
        for one in got:
            assert one[2] == want[2]
            for a, b in zip(one[:2], want[:2]):
                np.testing.assert_array_equal(a[0], b[0])
                np.testing.assert_array_equal(a[1], b[1])
        windows_t, row_mask = engine.device_windows(wins, n_valid)
        cap = pass_cap(prm.limit)
        eager = engine._fused_body(windows_t, row_mask, cap).cpu().numpy()
        np.testing.assert_array_equal(
            engine._pass_output(cap, windows_t, row_mask), eager)
        (graph,) = engine._graphs.values()
        assert graph.launches == 1 and graph.replays == 3
    finally:
        engine.close()
        cpu.close()
