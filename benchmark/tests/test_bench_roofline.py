"""The count kernel's roofline: the work depends on the shapes alone, and
at the launch times measured on the card it reads under 100%."""

import pytest

from benchmark.metrics import nfa_sliced_work as work

H100 = dict(name="NVIDIA H100 80GB HBM3", sm_count=132,
            max_sm_clock_mhz=1980.0)


def test_ops_of_the_default_pass():
    # 16 words of 32 candidates, 40,000 windows, 100 bases, 3 levels of 16
    assert work.ops(500, 40000, 100, 2, 16) == 16 * 40000 * 100 * 48
    assert work.ops(500, 40000, 100, 2, 16) == pytest.approx(3.072e9)
    # candidates count in whole words of 32
    assert work.ops(481, 10, 10, 0, 4) == work.ops(512, 10, 10, 0, 4)
    assert work.ops(513, 10, 10, 0, 4) == 17 * 10 * 10 * 4


def test_peak_and_least_time():
    ops_s, bytes_s = work.peak(H100)
    assert ops_s == pytest.approx(132 * 64 * 1.98e9)
    assert bytes_s == 3.35e12
    t = work.least_s(500, 40000, 100, 2, 16, (ops_s, bytes_s))
    assert t == pytest.approx(3.072e9 / ops_s)   # bound by operations
    assert 0.18e-3 < t < 0.19e-3
    # at 0.64-0.72 ms a launch (one launch a pass) the share is under 100%
    for ms in (0.64, 0.72):
        assert 0 < 100 * t / (ms * 1e-3) < 100


def test_unknown_card_has_no_peak():
    assert work.peak(dict(name="cpu")) is None


def test_reads_only_shapes():
    a = work.least_s(37300, 40000, 101, 2, 16, work.peak(H100))
    b = work.least_s(37300, 40000, 101, 2, 16, work.peak(H100))
    assert a == b and a == pytest.approx(
        1166 * 40000 * 101 * 48 / (132 * 64 * 1.98e9))
