"""Every configuration, traffic mix, cell and metric loads by its name,
and ``BENCHMARK.json`` keeps to the limits the benchmark is checked by,
as do the entries of ``pending.json`` (cells left out of it)."""

import json
import re

import pytest

from benchmark import harness
from benchmark.harness import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PENDING = json.loads((BENCH / "pending.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"] + PENDING["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"] + PENDING["per_layer"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads(name):
    cell = harness.load_cell(name)
    assert cell.chips in (1, 4)
    # a cell on four cards runs the --multihost path, one on one does not
    assert ("--multihost" in cell.config["args"]) == (cell.chips == 4)
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


def test_pending_cells_join_the_metrics_that_read_them():
    """A pending cell reports its own per-layer metrics and those that
    ``pending.json`` lists under ``also_in``, each as ``BENCHMARK.json``
    has it but for ``workloads``; ``BENCHMARK.json``'s cells keep theirs."""
    for w in PENDING["workloads"]:
        cell = harness.load_cell(w["name"])
        assert {m["name"] for m in cell.per_layer} == set(
            PENDING["also_in"]) | {m["name"] for m in PENDING["per_layer"]}
        have = {m["name"]: m for m in SPEC["per_layer"]}
        for m in cell.per_layer:
            if m["name"] in have:
                assert dict(m, workloads=None) == dict(have[m["name"]],
                                                       workloads=None)
    for name in (w["name"] for w in SPEC["workloads"]):
        assert harness.load_cell(name).per_layer == [
            m for m in SPEC["per_layer"] if name in m["workloads"]]


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (BENCH / "traffic").glob("*.json")))
def test_traffic_loads(name):
    mix = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    for key in ("reads", "length_min", "length_max", "n_rate", "adapters"):
        assert key in mix


def test_config_args_parse():
    """Each configuration's arguments are the CLI's own."""
    from approx_counter_tpu_torch.config.cli import resolve_params

    for c in SPEC["configs"] + PENDING["configs"]:
        args = json.loads((ROOT / c["file"]).read_text())["args"]
        prm = resolve_params(args + ["x.fa"])
        assert (prm.k, prm.sn, prm.sl, prm.limit, prm.max_error) == (
            16, 40000, 100, 500, 2)


@pytest.mark.parametrize("which", ["BENCHMARK.json", "with pending.json"])
def test_contract_shape(which):
    spec = SPEC if which == "BENCHMARK.json" else harness.load_spec(
        ROOT, pending=True)
    metrics = spec["end_to_end"] + spec["per_layer"]
    cells = [w["name"] for w in spec["workloads"]]
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    n = len(spec["workloads"])
    # a full check of 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 2 * 90 \
        + 1200 <= 43200
    assert 1 <= n <= 24
    names = [x["name"] for x in spec["configs"] + spec["workloads"] + metrics]
    assert all(NAME.fullmatch(x) for x in names)
    assert len(set(x["name"] for x in metrics)) == len(metrics)
    # at most a quarter of the cells, or one, take four cards
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= max(1, n // 4)
    assert all(w["chips"] in (1, 4) for w in spec["workloads"])
    pairs = {(w["config"], w["traffic"]) for w in spec["workloads"]}
    assert len(pairs) == n == len(set(cells))
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert c["file"].startswith("benchmark/")
        assert any(w["config"] == c["name"] for w in spec["workloads"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (BENCH / "workloads" / f"{w['name']}.json").exists()
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    for m in spec["per_layer"]:
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
        assert set(m["workloads"]) <= set(cells)
        assert "bound" not in m
    for m in metrics:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                            "higher")
    if which == "BENCHMARK.json":
        assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    else:  # as it would be written, with BENCHMARK.json's indentation
        assert len(json.dumps(spec, indent=2).encode()) <= 64 * 1024
