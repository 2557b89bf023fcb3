"""No run loads JAX or the JAX package, compared by whole top-level
name; without a card the benchmark prints no result and fails."""

import json
import shutil
import subprocess
import sys
import textwrap

import pytest

from benchmark.harness import BENCH, ROOT

RUN = textwrap.dedent(r"""
    import json, sys
    sys.path.insert(0, sys.argv[1])
    import torch
    from benchmark import harness
    from benchmark.tests.conftest import shrink
    cell = shrink(harness.load_cell("porechop_abi.mr10"))
    for trace in (False, True):
        got = harness.run_cell(cell, 2**31 + 1, 0.5, trace,
                               torch.device("cpu"))
        assert got.result["correct"], got.checks
    print(json.dumps(harness.forbidden_modules()))
""")


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", RUN, str(ROOT)],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_whole():
    code = textwrap.dedent(r"""
        import sys, types
        sys.path.insert(0, sys.argv[1])
        from benchmark import harness
        import approx_counter_tpu_torch
        assert harness.forbidden_modules() == [], harness.forbidden_modules()
        sys.modules["approx_counter_tpu.core"] = types.ModuleType("x")
        sys.modules["jaxlib"] = types.ModuleType("jaxlib")
        print(harness.forbidden_modules())
    """)
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "['approx_counter_tpu', 'jaxlib']", (
        out.stdout, out.stderr[-2000:])


def result_lines(stdout: str) -> list:
    return [x for x in stdout.splitlines() if x.startswith('{"correct"')]


@pytest.mark.parametrize("cell", ["porechop_abi.mr10",
                                  "porechop_abi.multihost4"])
def test_no_card_no_result(tmp_path, cell):
    """Here there is no card: no result, a non-zero exit, and the cards
    the cell takes named.  Likewise in a directory that holds only
    ``BENCHMARK.json`` and ``benchmark/``."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for root in (ROOT, tmp_path):
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", cell,
             "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=root,
            capture_output=True, text=True, timeout=300)
        assert out.returncode == 1
        assert "CUDA card(s); found 0" in out.stderr
        assert result_lines(out.stdout) == []
