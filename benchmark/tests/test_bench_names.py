"""Every configuration, traffic mix, cell and metric loads by its name,
and ``BENCHMARK.json`` keeps to the limits the benchmark is checked by."""

import json
import re

import pytest

from benchmark import harness
from benchmark.harness import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads(name):
    cell = harness.load_cell(name)
    assert cell.chips == 1
    assert cell.config["args"]
    assert set(cell.workload) == {"trace_jobs", "check_passes"}
    assert {m["name"] for m in cell.end_to_end} >= {
        "windows_per_s", "job_ms_p50", "setup_s"}
    assert cell.per_layer
    from approx_counter_tpu_torch.config.cli import resolve_params
    from benchmark import check

    prm = resolve_params(cell.config["args"] + ["reads.fa"])
    assert check.control_kind(prm) == ("first_cap" if "-sk" in
                                       cell.config["args"] else "hamming")


@pytest.mark.parametrize("name", [m["name"] for m in METRICS])
def test_metric_reader_loads(name):
    assert callable(harness.reader(name))


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (BENCH / "traffic").glob("*.json")))
def test_traffic_loads(name):
    mix = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    for key in ("reads", "length_min", "length_max", "n_rate", "adapters"):
        assert key in mix


def test_config_args_parse():
    """Each configuration's arguments are the CLI's own."""
    from approx_counter_tpu_torch.config.cli import resolve_params

    for c in SPEC["configs"]:
        args = json.loads((ROOT / c["file"]).read_text())["args"]
        prm = resolve_params(args + ["x.fa"])
        assert (prm.k, prm.sn, prm.sl, prm.limit, prm.max_error) == (
            16, 40000, 100, 500, 2)


def test_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    n = len(SPEC["workloads"])
    # a full check of 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 \
        + 1200 <= 43200
    assert 1 <= n <= 24
    names = [x["name"] for x in SPEC["configs"] + SPEC["workloads"] + METRICS]
    assert all(NAME.fullmatch(x) for x in names)
    assert len(set(x["name"] for x in METRICS)) == len(METRICS)
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == n
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert c["file"].startswith("benchmark/")
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (BENCH / "workloads" / f"{w['name']}.json").exists()
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["per_layer"]:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert set(m["workloads"]) <= set(CELLS)
        assert "bound" not in m
    for m in METRICS:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                            "higher")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
