"""Short runs of cells on the cards (marked ``cuda``; each skips with
fewer cards than its cell takes): ``python3 -m pytest -m cuda
benchmark/tests/test_bench_cell.py``."""

import json
import subprocess
import sys

import pytest

from benchmark.harness import ROOT

END_TO_END = {"windows_per_s", "job_ms_p50", "setup_s"}
#: the per-layer metrics each cell reports in a traced run
TRACED = {
    "porechop_abi.mr10": {
        "parse.ms", "dispatch.prefetch_ms", "pass.device_ms",
        "kernel.nfa_sliced_ms", "kernel.nfa_sliced_roofline",
        "device.idle_pct", "pass.capture_ms", "pass.regrow_reruns",
        "dispatch.sample_ms", "dispatch.upload_bytes", "export.ms"},
    "porechop_abi.multihost4": {
        "device.idle_pct", "kernel.nfa_sliced_ms", "dispatch.sample_ms",
        "pass.capture_ms", "mesh.collective_ms"},
}
CHIPS = {"porechop_abi.mr10": 1, "porechop_abi.multihost4": 4}


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", list(TRACED))
def test_short_cell_on_the_card(cell, trace):
    import torch

    if torch.cuda.device_count() < CHIPS[cell]:
        pytest.skip(f"needs {CHIPS[cell]} CUDA card(s)")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2**31 + 11), "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["count"] == CHIPS[cell]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == (END_TO_END if trace == 0
                                      else TRACED[cell])
    if trace:
        values = {k: v["value"] for k, v in result["metrics"].items()}
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert 0 < values["device.idle_pct"] < 100
        assert values["kernel.nfa_sliced_ms"] > 0
        assert values.get("kernel.nfa_sliced_roofline", 0) < 100
        assert values.get("mesh.collective_ms", 1) > 0
