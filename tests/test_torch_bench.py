"""The port's bench (``approx_counter_tpu_torch/bench.py``) vs the JAX
package's ``bench.py``.

``bench.py`` is never imported: its kernel inputs are the lines of
``bench_tpu`` from ``rng = ...`` to ``wv = ...``, read with ``ast`` and run
with ``jax.device_put`` as the identity, and its ``metric`` and ``unit``
strings are read from ``main``'s ``json.dumps``.  The port's draws equal
them exactly, and its counts on them (the plain version, on the CPU) equal
the JAX ``approx_counts(..., use_pallas=False)``.  Then the bench runs on
the CPU at a small size: one JSON line on stdout, ``[bench]`` on every
stderr line, exit 1 for ``--device cuda`` without a card, a failing
diagnostic raised, and the C++ baseline built into ``build/`` from
``native/cpu_baseline.cpp``.
"""

import ast
import json
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from approx_counter_tpu_torch import bench  # noqa: E402
from approx_counter_tpu_torch.kernels import _build  # noqa: E402
from approx_counter_tpu_torch.kernels.bpm import (  # noqa: E402
    approx_counts,
    build_peq,
)

SCRIPT = Path(__file__).resolve().parents[1] / "bench.py"
C, W, M, K, ITERS = 40, 64, 101, 16, 2
SMALL = dict(C=C, W=W, M=M, K=K, iters=ITERS, n_reads=128, sub_w=64,
             threads=1)


def _function(name: str) -> ast.FunctionDef:
    tree = ast.parse(SCRIPT.read_text())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _assigned(stmt) -> str | None:
    if isinstance(stmt, ast.Assign) and isinstance(stmt.targets[0], ast.Name):
        return stmt.targets[0].id
    return None


@pytest.fixture(scope="module")
def jax_draws():
    """The namespace after ``bench_tpu``'s input lines ran at the small
    shape: ``codes``, ``peq``, ``wts`` (ITERS + 1 buffers) and ``wv``."""
    jax = pytest.importorskip("jax")
    from approx_counter_tpu.kernels.bpm import build_peq as jax_build_peq

    body = _function("bench_tpu").body
    names = [_assigned(s) for s in body]
    lines = body[names.index("rng"):names.index("wv") + 1]
    ns = dict(np=np, jnp=jax.numpy,
              jax=types.SimpleNamespace(device_put=lambda x: x),
              build_peq=jax_build_peq, C=C, W=W, M=M, K=K, ITERS=ITERS)
    exec(compile(ast.Module(body=lines, type_ignores=[]), str(SCRIPT),
                 "exec"), ns)
    return ns


def _contract() -> dict:
    """The ``metric`` and ``unit`` of ``bench.py:main``'s JSON line."""
    call = next(n for n in ast.walk(_function("main"))
                if isinstance(n, ast.Dict))
    return {k.value: v.value for k, v in zip(call.keys, call.values)
            if k.value in ("metric", "unit")}


def test_kernel_inputs_are_the_jax_bench_draws(jax_draws):
    codes, windows_t, valid = bench.kernel_inputs(
        np.random.default_rng(12345), C, W, M, K, ITERS + 1)
    assert codes.dtype == np.uint64
    np.testing.assert_array_equal(codes, jax_draws["codes"])
    assert len(windows_t) == len(jax_draws["wts"]) == ITERS + 1
    for got, want in zip(windows_t, jax_draws["wts"]):
        assert got.dtype == np.uint8 and got.flags.c_contiguous
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(valid, np.asarray(jax_draws["wv"]))
    peq = build_peq(torch.from_numpy(codes.view(np.int64)), K)
    np.testing.assert_array_equal(
        peq.numpy(), np.asarray(jax_draws["peq"]).astype(np.int64))


def test_counts_on_the_bench_inputs_equal_the_jax_package(jax_draws):
    from approx_counter_tpu.kernels.bpm import approx_counts as jax_counts

    codes, windows_t, valid = bench.kernel_inputs(
        np.random.default_rng(12345), C, W, M, K, ITERS + 1)
    peq = build_peq(torch.from_numpy(codes.view(np.int64)), K)
    for i, wt in enumerate(windows_t):
        got = approx_counts(peq, torch.from_numpy(wt),
                            torch.from_numpy(valid), K, bench.MAXERR)
        want = jax_counts(jax_draws["peq"], jax_draws["wts"][i],
                          jax_draws["wv"], K, use_pallas=False)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_metric_and_unit_are_the_jax_bench_strings():
    assert _contract() == {"metric": bench.METRIC, "unit": bench.UNIT}


def test_cpu_run_prints_one_json_line(capsys):
    assert bench.main(["--device", "cpu"], **SMALL) == 0
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1, out
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert {k: line[k] for k in ("metric", "unit")} == _contract()
    assert line["value"] > 0
    assert isinstance(line["vs_baseline"], float)
    assert err and all(s.startswith("[bench] ") for s in err.splitlines())
    for what in ("kernel:", "full pass (exact", "full pass (dense",
                 "window upload raw", "window upload packed",
                 "host pack (dense", "host pack (sparse", "pipelined",
                 "full pass on device-resident", "device-pool",
                 "cpu baseline"):
        assert f"[bench] {what}" in err, what


def test_cuda_without_a_card_exits_1(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--device", "cuda"], **SMALL) == 1
    out, err = capsys.readouterr()
    assert out == ""
    assert len(err.splitlines()) == 1 and err.startswith("[bench] ")
    assert bench.main([], **SMALL) == 1  # cuda is the default


def test_a_failing_diagnostic_fails_the_bench(capsys, monkeypatch):
    monkeypatch.setattr(bench.Engine, "build_pool", lambda *a, **kw: False)
    with pytest.raises(RuntimeError, match="device pool"):
        bench.main(["--device", "cpu"], **SMALL)
    assert capsys.readouterr().out == ""


def test_baseline_builds_into_build_and_runs(capsys):
    per_s = bench.cpu_baseline(64, 512, M, K, threads=1)
    assert per_s > 0
    exe = _build.host_program(bench.BASELINE_SRC, bench.BASELINE_FLAGS)
    assert exe.parent == _build.BUILD_DIR and exe.name.startswith(
        "cpu_baseline_")
    assert bench.BASELINE_SRC == SCRIPT.parent / "native" / "cpu_baseline.cpp"
    assert "scaled to 4 threads" in capsys.readouterr().err
