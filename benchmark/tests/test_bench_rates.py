"""The rate arithmetic of the window: whole units only, and a stall
anywhere in the window lowers the rate."""

import pytest
import torch

from harness import common


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _measure(monkeypatch, durations, seconds):
    clock = Clock()
    monkeypatch.setattr(common.time, "perf_counter", clock)
    it = iter(durations)

    def unit(i):
        clock.t += next(it)
        return 32

    return common.measure(unit, seconds, torch.device("cpu"))


def test_whole_units_only(monkeypatch):
    # units end at 4, 8, 12 (inside a 10 s window: 4 and 8) and 12 (out)
    m = _measure(monkeypatch, [4.0, 4.0, 4.0, 4.0], 10.0)
    assert (m["units"], m["images"], m["started"]) == (2, 64, 3)
    assert m["window_s"] == pytest.approx(8.0)
    assert common.rate(m["images"], m["window_s"]) == pytest.approx(8.0)


def test_a_stall_lowers_the_rate(monkeypatch):
    steady = _measure(monkeypatch, [2.0] * 10, 10.0)
    stalled = _measure(monkeypatch, [2.0, 2.0, 3.0, 2.0, 2.0, 2.0], 10.0)
    r0 = common.rate(steady["images"], steady["window_s"])
    r1 = common.rate(stalled["images"], stalled["window_s"])
    assert r1 < r0
    assert stalled["units"] == 4 and stalled["window_s"] == pytest.approx(9.0)


def test_a_unit_longer_than_the_window_counts_alone(monkeypatch):
    m = _measure(monkeypatch, [15.0, 15.0], 10.0)
    assert (m["units"], m["started"]) == (1, 1)
    assert m["window_s"] == pytest.approx(15.0)


def test_unit_ending_on_the_deadline_counts(monkeypatch):
    m = _measure(monkeypatch, [5.0, 5.0, 5.0], 10.0)
    assert (m["units"], m["started"]) == (2, 2)
