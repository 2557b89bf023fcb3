"""``correct`` at a size the CPU holds, in each cell of ``BENCHMARK.json``
and ``pending.json``: true for the program as it is, false for each
cell's control and for each fault a cell can have,
planted in the timed path underneath a whole run (the harness's look for
a card skipped, the rest of a run driven as on the card; a cell on four
cards as four gloo ranks of ``ranks.launch``, with the fault planted in
every rank).

The faults: a pass that returns an earlier pass's answer unchanged (a
step that returns its state unchanged); half of each batch's windows left
out; an answer altered where it is produced (the first count of each
pass's approximate and exact selections, so of each export);
in a cell on several cards, the exchange between them left out (each
rank keeps the buckets it would send and reads them as received)."""

import json
from types import SimpleNamespace

import pytest
import torch

from benchmark import check, harness
from benchmark.tests.conftest import launch

WORKLOADS = [w for spec in (harness.ROOT / "BENCHMARK.json",
                            harness.BENCH / "pending.json")
             for w in json.loads(spec.read_text())["workloads"]]
CELLS = [w["name"] for w in WORKLOADS]
MULTI = {w["name"] for w in WORKLOADS if w["chips"] > 1}
SEED = 2**31 + 4242

def run(cell, control=None, fault=None):
    """One run's ``Outcome``-like numbers: ``result``, ``checks`` and
    ``control``."""
    if cell.chips == 1:
        return harness.run_cell(cell, SEED, 1.0, False, torch.device("cpu"),
                                control=control)
    got = launch(cell, control=bool(control), setup=(
        "from benchmark.tests import test_bench_faults as t\n"
        f"t.{fault.__name__}(t.SimpleNamespace(setattr=setattr))"
        if fault else ""))
    assert got.rc == 0, got.err
    line = json.loads(got.out[0].splitlines()[-1])
    if control:
        return SimpleNamespace(result=dict(correct=line["correct"]),
                               checks=line["program"],
                               control=line["control"])
    return SimpleNamespace(result=line, checks=line["checks"], control=None)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_and_control(tiny, name):
    cell = tiny(name)
    got = run(cell, control=True)
    assert got.result["correct"], got.checks
    assert all(v == 0 for v in got.checks.values())
    assert not check.correct(got.control), got.control
    if cell.config.get("exact_export"):
        assert "exact_rows_wrong" in got.checks
        assert got.control["exact_rows_wrong"] > 0, got.control


def stale(monkeypatch):
    from approx_counter_tpu_torch import pipeline

    real = pipeline.Engine._count

    def first_answer(self, *args, **kw):
        if not hasattr(self, "_first"):
            self._first = real(self, *args, **kw)
        return self._first

    monkeypatch.setattr(pipeline.Engine, "_count", first_answer)


def half_batch(monkeypatch):
    from approx_counter_tpu_torch import pipeline

    real = pipeline.Engine._count

    def halved(self, windows_t, row_mask, *args, **kw):
        keep = torch.arange(len(row_mask)) < (len(row_mask) + 1) // 2
        return real(self, windows_t, row_mask & keep.to(row_mask.device),
                    *args, **kw)

    monkeypatch.setattr(pipeline.Engine, "_count", halved)


def altered(monkeypatch):
    """Both drivers reach ``report_and_export_end`` through
    ``pipeline.count_and_export_end``; its arguments 7 and 8 are the exact
    and the approximate selections."""
    from approx_counter_tpu_torch import pipeline

    real = pipeline.report_and_export_end

    def plus_one(*args, **kw):
        args = list(args)
        for i in (7, 8):
            codes, counts = args[i]
            counts = counts.copy()
            counts[:1] += 1
            args[i] = (codes, counts)
        return real(*args, **kw)

    monkeypatch.setattr(pipeline, "report_and_export_end", plus_one)


def no_exchange(monkeypatch):
    from approx_counter_tpu_torch.dist import mesh

    monkeypatch.setattr(mesh, "exchange", lambda send, group=None:
                        send.clone())


FAULTS = [(f, name) for name in CELLS
          for f in [stale, half_batch, altered]
          + ([no_exchange] if name in MULTI else [])]


@pytest.mark.parametrize("fault,name", FAULTS,
                         ids=[f"{n}-{f.__name__}" for f, n in FAULTS])
def test_fault_is_not_correct(tiny, monkeypatch, name, fault):
    cell = tiny(name)
    if cell.chips == 1:
        fault(monkeypatch)
    got = run(cell, fault=fault)
    assert not got.result["correct"], (fault.__name__, got.checks)
    if fault is altered and cell.config.get("exact_export"):
        assert got.checks["exact_rows_wrong"] >= 1, got.checks
