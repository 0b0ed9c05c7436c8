"""The readers of the program's phase and device timers
(`metrics/stage_ms.fit.py`, `readback_wait_ms.fit.py`,
`readback_copy_ms.fit.py`, `estimator_ms.fit.py`, `device_ms.fit.py`,
`device_ms.score.py`) on synthetic run records: their values, None on
the other kind of request, and None where the program records no such
timer (a program older than these timers)."""

import pytest

from portbench import harness, load
from portbench.plugins import plugin

FIT, SCORE = "lr_sparse.fit_sweep", "lr_dense_conf.score_10m"


def _timer(total_ms, count):
    return {"count": count, "totalMs": total_ms, "lastMs": total_ms / max(count, 1)}


def _record(cell, timers, completed=4):
    window = load.Window(seconds=1.0, attempted=completed, completed=completed, rows=0,
                         failed=0)
    counters = {"timers": timers, "gauges": {}, "counters": {}}
    return harness.RunRecord(harness.Cell(harness.benchmark_spec(), cell), 1.0, window,
                             counters, None, None)


FIT_TIMERS = {
    "stage.fit": _timer(40.0, 4),
    "sgd.stage": _timer(4.0, 4),
    "iteration.dispatch": _timer(2.0, 4),
    "readback.wait": _timer(20.0, 4),
    "readback.copy": _timer(6.0, 4),
    "readback": _timer(26.0, 4),
    "replay.device": _timer(60.0, 3),
}


@pytest.mark.parametrize("metric, want", [
    ("stage_ms.fit", 1.0),
    ("readback_wait_ms.fit", 5.0),
    ("readback_copy_ms.fit", 1.5),
    ("estimator_ms.fit", 2.0),
    ("device_ms.fit", 20.0),
])
def test_fit_readers(metric, want):
    read = plugin("metrics", metric).read
    assert read(_record(FIT, FIT_TIMERS)) == pytest.approx(want)
    assert read(_record(SCORE, FIT_TIMERS)) is None
    assert read(_record(FIT, {})) is None
    assert read(_record(FIT, FIT_TIMERS, completed=0)) is None


def test_device_ms_reads_its_own_count():
    """The device timers time a sample of the requests, so the reader
    divides by the timer's own count, not the window's requests."""
    read = plugin("metrics", "device_ms.fit").read
    assert read(_record(FIT, FIT_TIMERS, completed=4)) == read(_record(FIT, FIT_TIMERS,
                                                                       completed=2))


@pytest.mark.parametrize("child", ["sgd.stage", "iteration.dispatch", "readback.wait",
                                   "readback.copy", "stage.fit"])
def test_estimator_ms_needs_every_phase(child):
    timers = {k: v for k, v in FIT_TIMERS.items() if k != child}
    assert plugin("metrics", "estimator_ms.fit").read(_record(FIT, timers)) is None


def test_estimator_ms_is_not_clamped():
    timers = dict(FIT_TIMERS, **{"stage.fit": _timer(20.0, 4)})
    assert plugin("metrics", "estimator_ms.fit").read(_record(FIT, timers)) == pytest.approx(-3.0)


def test_device_ms_score():
    read = plugin("metrics", "device_ms.score").read
    timers = {"transform.device": _timer(8.0, 4), "stage.transform": _timer(12.0, 5)}
    assert read(_record(SCORE, timers)) == pytest.approx(2.0)
    assert read(_record(FIT, timers)) is None
    assert read(_record(SCORE, {"stage.transform": _timer(12.0, 5)})) is None
    assert read(_record(SCORE, {"transform.device": _timer(0.0, 0)})) is None
