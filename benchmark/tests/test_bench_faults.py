"""``correct`` at a size the CPU holds: true for the program as it is,
false for each cell's control and for each fault a cell can have,
planted in the timed path underneath a whole run (the harness's look for
a card skipped, the rest of a run driven as on the card).

The faults: a pass that returns an earlier pass's answer unchanged (a
step that returns its state unchanged); half of each batch's windows left
out; an answer altered where it is produced (one count of each export).
There is no exchange between chips to leave out: every cell takes one."""

import json

import pytest
import torch

from benchmark import check, harness

CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def run(cell, control=None):
    return harness.run_cell(cell, 2**31 + 4242, 1.0, False,
                            torch.device("cpu"), control=control)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_and_control(tiny, name):
    got = run(tiny(name), control=True)
    assert got.result["correct"], got.checks
    assert all(v == 0 for v in got.checks.values())
    assert not check.correct(got.control), got.control


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
    from approx_counter_tpu_torch import pipeline

    real = pipeline.report_and_export_end

    def plus_one(*args, **kw):
        args = list(args)
        codes, counts = args[8]
        counts = counts.copy()
        counts[0] += 1
        args[8] = (codes, counts)
        return real(*args, **kw)

    monkeypatch.setattr(pipeline, "report_and_export_end", plus_one)


@pytest.mark.parametrize("fault", [stale, half_batch, altered])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(tiny, monkeypatch, name, fault):
    fault(monkeypatch)
    got = run(tiny(name))
    assert not got.result["correct"], (fault.__name__, got.checks)
