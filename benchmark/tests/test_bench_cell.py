"""One short run of a cell on the card (marked ``cuda``; skips without
one): ``python3 -m pytest -m cuda benchmark/tests/test_bench_cell.py``."""

import json
import subprocess
import sys

import pytest

from benchmark.harness import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_short_cell_on_the_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "porechop_abi.mr10", "--seed", str(2**31 + 11), "--seconds", "3",
         "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0
    assert result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
    want = {"windows_per_s", "job_ms_p50", "setup_s"} if trace == 0 else {
        "parse.ms", "dispatch.prefetch_ms", "pass.device_ms",
        "kernel.nfa_sliced_ms", "kernel.nfa_sliced_roofline",
        "device.idle_pct"}
    assert set(result["metrics"]) == want
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert result["metrics"]["kernel.nfa_sliced_roofline"]["value"] < 100
