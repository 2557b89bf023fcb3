"""The port's stage network and probe vs the JAX package's sort-stage probe.

``native/sort_stage_probe5.py`` sets up a compile cache and times 16 MB
arrays when it is imported, so it is never imported here: its
``make_probe`` is read with ``ast`` and run at a small size (ROWS=256,
BLOCKS=2, STAGES=210) with the Pallas call in interpret mode and a ``jit``
that does nothing.  The same numpy-seeded int32 inputs, negatives and ties
included, go through it, through ``stage_network_ref`` and through the
port's ``make_probe``.  Every comparison is exact.

The ``cuda`` test holds the CUDA kernel against the plain version on the
card; run it there with ``python -m pytest --noconftest -m cuda
tests/test_torch_sort_probe.py``.
"""

import ast
import functools
import types
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from approx_counter_tpu_torch.kernels import sort_stage  # noqa: E402
from approx_counter_tpu_torch.native import (  # noqa: E402
    sort_stage_probe5 as probe,
)

SCRIPT = Path(__file__).resolve().parents[1] / "native" / "sort_stage_probe5.py"
ROWS, BLOCKS, STAGES = 256, 2, 210


@pytest.fixture(scope="module")
def jax_probe():
    """``make_probe(transpose_every)`` of the script, run in interpret mode
    on the CPU; each call's full output is appended to ``outputs``."""
    jax = pytest.importorskip("jax")
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    tree = ast.parse(SCRIPT.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "make_probe")
    outputs = []

    def pallas_call(kernel, **kw):
        call = functools.partial(pl.pallas_call, interpret=True)(kernel, **kw)

        def run(x):
            outputs.append(np.asarray(call(x)))
            return outputs[-1]

        return run

    ns = dict(
        jax=types.SimpleNamespace(jit=lambda f: f, lax=jax.lax,
                                  ShapeDtypeStruct=jax.ShapeDtypeStruct),
        jnp=jax.numpy, pltpu=pltpu,
        pl=types.SimpleNamespace(pallas_call=pallas_call,
                                 BlockSpec=pl.BlockSpec),
        ROWS=ROWS, LANES=128, BLOCKS=BLOCKS, STAGES=STAGES,
    )
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(SCRIPT), "exec"),
         ns)
    return ns["make_probe"], outputs


def _x(seed, rows, lo=-(1 << 31)):
    """int32 [rows, 128] from a seed, with INT32_MIN/MAX and ties."""
    rng = np.random.default_rng(seed)
    x = rng.integers(lo, 1 << 31, (rows, 128)).astype(np.int32)
    x[rng.random(x.shape) < 0.2] = rng.integers(-3, 3)
    x.flat[:2] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    return x


@pytest.mark.parametrize("transpose_every", [0, 20])
@pytest.mark.parametrize("seed,lo", [(1, -(1 << 31)), (7, 0)])
def test_port_matches_pallas_probe(jax_probe, transpose_every, seed, lo):
    """Full output and the ``run`` slice, (s1) and (s2), bit for bit."""
    make_probe, outputs = jax_probe
    x = _x(seed, BLOCKS * ROWS, lo)
    head = np.asarray(make_probe(transpose_every)(x))
    want = outputs[-1]
    got = sort_stage.stage_network_ref(torch.from_numpy(x), STAGES,
                                       transpose_every)
    np.testing.assert_array_equal(got.numpy(), want)
    port_run = probe.make_probe(transpose_every, STAGES)
    np.testing.assert_array_equal(port_run(torch.from_numpy(x)).numpy(), head)
    assert head.shape == (64, 1)


def _one_stage_then_transpose(x):
    return sort_stage.stage_network_ref(x, 1, 1)


@settings(max_examples=25, deadline=None, database=None)
@given(seed=st.integers(0, 2**32 - 1), tiles=st.integers(1, 3),
       stages=st.integers(1, 45),
       transpose_every=st.sampled_from([0, 1, 5, 20]))
def test_ref_is_one_stage_per_level(seed, tiles, stages, transpose_every):
    """A stage is idempotent: s >= 1 stages equal one stage, and a level of
    t stages and a transpose equals one stage and a transpose."""
    x = torch.from_numpy(_x(seed, 128 * tiles))
    got = sort_stage.stage_network_ref(x, stages, transpose_every)
    if transpose_every == 0:
        want = sort_stage.stage_network_ref(x, 1)
    else:
        want = x
        for _ in range(stages // transpose_every):
            want = _one_stage_then_transpose(want)
    assert torch.equal(got, want)


@pytest.mark.parametrize("rows", [16, 144, 128])
@pytest.mark.parametrize("stages", [0, 1, 21])
def test_ref_matches_numpy(rows, stages):
    """One stage written out in numpy, per group and lane, at shapes with a
    partial last tile; the input is left as it was."""
    x = _x(rows + stages, rows)
    want = x.copy()
    for _ in range(min(stages, 1)):
        g = want.reshape(rows // 16, 2, 8, 128)
        want = np.concatenate([np.minimum(g[:, :1], g[:, 1:]),
                               np.maximum(g[:, :1], g[:, 1:])], 1)
        want = want.reshape(rows, 128)
    xt = torch.from_numpy(x.copy())
    got = sort_stage.stage_network(xt, stages)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(xt.numpy(), x)
    assert got.data_ptr() != xt.data_ptr()


@pytest.mark.parametrize("stages,transpose_every,run", [
    (210, 0, 210), (210, 20, 200), (19, 20, 0), (21, 1, 21), (0, 0, 0)])
def test_stages_run(stages, transpose_every, run):
    assert sort_stage.stages_run(stages, transpose_every) == run


@pytest.mark.parametrize("shape,dtype,stages,te,match", [
    ((16, 64), torch.int32, 1, 0, "int32"),
    ((16, 128), torch.int64, 1, 0, "int32"),
    ((24, 128), torch.int32, 1, 0, "rows"),
    ((144, 128), torch.int32, 1, 20, "rows"),
    ((128, 128), torch.int32, -1, 0, "stages"),
    ((128, 128), torch.int32, 1, -1, "transpose_every"),
])
def test_bad_inputs_raise(shape, dtype, stages, te, match):
    x = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        sort_stage.stage_network(x, stages, te)


def test_non_contiguous_raises():
    x = torch.zeros((128, 256), dtype=torch.int32)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        sort_stage.stage_network(x, 1)


def test_probe_main_on_cpu(capsys):
    """The entry point at a small size on the CPU: rc 0, the script's lines
    with the stages actually run, and no kernel launch."""
    launches = sort_stage.stage_network.launches
    rc = probe.main(["--device", "cpu"], rows=64, blocks=2, stages=21,
                    iters=2, keys=1000)
    err = capsys.readouterr().err
    assert rc == 0
    assert sort_stage.stage_network.launches == launches
    assert "model: 21 stages x 2 x 64x128 int32" in err
    assert "over the 21 stages run" in err
    assert "(s2) + transpose/20" in err and "over the 20 stages run" in err
    assert "torch.sort P=1000 int32, sign bit flipped" in err
    assert "torch.sort P=1000 int64" in err
    assert err.rstrip().endswith("[bench] done")


def test_probe_main_without_cuda_exits_1(monkeypatch, capsys):
    """No card, no fallback: the default device is cuda and it exits 1."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.cuda
@pytest.mark.parametrize("rows,stages,transpose_every", [
    (16, 210, 0), (144, 19, 0), (384, 21, 1), (384, 210, 20), (32768, 210, 0),
    (32768, 210, 20)])
def test_cuda_kernel_matches_ref(rows, stages, transpose_every):
    """The CUDA kernel against the plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    x = torch.from_numpy(_x(rows, rows)).cuda()
    launches = sort_stage.stage_network.launches
    got = sort_stage.stage_network(x, stages, transpose_every)
    want = sort_stage.stage_network_ref(x, stages, transpose_every)
    torch.cuda.synchronize()
    assert sort_stage.stage_network.launches == launches + 1
    assert torch.equal(got, want)
