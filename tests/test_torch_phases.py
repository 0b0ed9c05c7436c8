"""The port's always-on phase timers, device timers and profiler ranges
(flink_ml_tpu_torch/obs/tracing.py `timed`, `device_timed`), and the
constant-memory timers of utils/metrics.py.

- a small dense and a small sparse LogisticRegression fit each add one
  sample to `stage.fit`, `sgd.stage`, `iteration.dispatch`,
  `readback.wait` and `readback.copy`; the two readback phases sum to the
  JAX-named `readback` timer, and `stage.fit`'s self time is not negative;
- under torch.profiler the phases are `user_annotation` ranges nested in
  `stage.fit` (a fit) and `stage.transform` (a transform); with no sink
  and no profiler no code path enters a `record_function` or emits a
  record, and `span()` is the shared no-op;
- the CUDA-event fold, with a fake event: one call in a sample records a
  pair, a pair folds only once its end event has passed, nothing waits,
  the pending cap drops the oldest and counts it, and nothing is recorded
  off the card, while capturing or while the profiler records;
- timers keep constant storage over 100,000 samples and read exactly as
  a list of every sample would, also when threads record at once.
"""

import json
import random
import sys
import threading
from collections import deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flink_ml_tpu_torch import SparseBatch, Table, config
from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression
from flink_ml_tpu_torch.obs import tracing
from flink_ml_tpu_torch.utils import metrics

FIT_PHASES = ("sgd.stage", "iteration.dispatch", "readback.wait", "readback.copy")


def _table(kind, n=96, d=6, seed=4):
    rng = np.random.default_rng(seed)
    label = torch.from_numpy((rng.random(n) > 0.5).astype(np.float32))
    if kind == "dense":
        return Table({"features": torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)),
                      "label": label})
    idx = torch.from_numpy(rng.integers(0, 40, (n, 3)).astype(np.int32))
    return Table({"features": SparseBatch(40, idx, torch.rand(n, 3)), "label": label})


def _fit(table):
    return LogisticRegression().set_max_iter(3).set_global_batch_size(32).fit(table)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_a_fit_adds_one_sample_to_each_phase(kind):
    table = _table(kind)
    with config.use_device("cpu"):
        _fit(table)  # the signature's capture
        before = metrics.snapshot()
        _fit(table)
        timers = metrics.snapshot_delta(before, metrics.snapshot())["timers"]
    for name in ("stage.fit",) + FIT_PHASES + ("readback",):
        assert timers[name]["count"] == 1, name
    assert timers["readback.wait"]["totalMs"] + timers["readback.copy"]["totalMs"] == \
        pytest.approx(timers["readback"]["totalMs"], rel=1e-9)
    children = sum(timers[name]["totalMs"] for name in FIT_PHASES)
    assert timers["stage.fit"]["totalMs"] - children >= 0.0


def _annotations(prof, tmp_path, name):
    path = str(tmp_path / f"{name}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def _inside(inner, outer):
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_phases_are_profiler_ranges(kind, tmp_path):
    table = _table(kind, seed=5)
    with config.use_device("cpu"):
        model = _fit(table)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _fit(table)
        fit = _annotations(prof, tmp_path, "fit")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            model.transform(table)
        transform = _annotations(prof, tmp_path, "transform")
    (outer,) = [e for e in fit if e["name"] == "stage.fit"]
    for name in FIT_PHASES:
        (phase,) = [e for e in fit if e["name"] == name]
        assert _inside(phase, outer), name
    assert [e["name"] for e in transform if e["name"].startswith("stage.")] == ["stage.transform"]


def test_nothing_records_with_no_sink_and_no_profiler(monkeypatch):
    entered, emitted = [], []

    class Range:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(tracing._profiler, "record_function", Range)
    monkeypatch.setattr(tracing, "_emit", emitted.append)
    assert not tracing.enabled() and not tracing._profiler._is_profiler_enabled
    assert tracing.span("x", a=1) is tracing._NOOP
    table = _table("sparse", seed=6)
    with config.use_device("cpu"):
        _fit(table).transform(table)
    assert entered == [] and emitted == []
    # the same calls with the profiler's flag up enter one range a phase
    monkeypatch.setattr(tracing._profiler, "_is_profiler_enabled", True)
    assert isinstance(tracing.span("x"), tracing._Range)
    with config.use_device("cpu"):
        _fit(table)
    assert {"stage.fit", "iteration.run"}.union(FIT_PHASES) <= set(entered)
    assert emitted == []


# ---------------------------------------------------------------------------
# the CUDA-event fold, with a fake event
# ---------------------------------------------------------------------------

class FakeEvent:
    made = 0

    def __init__(self):
        FakeEvent.made += 1
        self.passed = False
        self.at_ms = None

    def record(self, stream=None):
        assert stream == "stream"
        self.passed = False

    def query(self):
        return self.passed

    def pass_at(self, ms):
        self.passed, self.at_ms = True, ms

    def elapsed_time(self, end):
        assert self.passed and end.passed, "elapsed_time of an event not yet passed"
        return end.at_ms - self.at_ms

    def synchronize(self):
        _never_wait()

    wait = synchronize


def _never_wait(*args, **kwargs):
    raise AssertionError("the device timers never wait")


CARD = torch.device("cuda", 0)


@pytest.fixture
def fake_card(monkeypatch):
    FakeEvent.made = 0
    capturing = []
    monkeypatch.setattr(tracing, "_new_event", FakeEvent)
    monkeypatch.setattr(tracing, "_device_pending", deque(maxlen=tracing.DEVICE_PENDING))
    monkeypatch.setattr(tracing, "_event_pool", {})
    monkeypatch.setattr(tracing, "_device_calls", {})
    monkeypatch.setattr(tracing, "DEVICE_SAMPLE_EVERY", 1)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: bool(capturing))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "stream")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "synchronize", _never_wait)
    return capturing


def _pair(name, device=CARD):
    with tracing.device_timed(name, device):
        pass
    return tracing._device_pending[-1] if tracing._device_pending else None


def _timer(name):
    return metrics.snapshot()["timers"].get(name)


def test_a_pair_folds_once_its_end_has_passed(fake_card):
    name = "fake.device.fold"
    _, _, start, end = _pair(name)
    tracing.poll_device_timers()
    assert _timer(name) is None and len(tracing._device_pending) == 1
    start.pass_at(1.0)
    tracing.poll_device_timers()
    assert _timer(name) is None  # the end event has not passed
    end.pass_at(3.5)
    tracing.poll_device_timers()
    assert _timer(name) == {"count": 1, "totalMs": pytest.approx(2.5), "lastMs": pytest.approx(2.5)}
    assert not tracing._device_pending
    made = FakeEvent.made
    _pair(name, device=None)  # the current card, events from the pool
    assert FakeEvent.made == made


def test_pairs_fold_oldest_first_after_the_next_pair(fake_card):
    name = "fake.device.order"
    first = _pair(name)
    second = _pair(name)
    for event, ms in zip(second[2:], (10.0, 11.0)):
        event.pass_at(ms)
    tracing.poll_device_timers()
    assert _timer(name) is None  # the oldest has not passed
    for event, ms in zip(first[2:], (0.0, 4.0)):
        event.pass_at(ms)
    _pair(name)  # a new pair polls after its second record
    assert _timer(name)["count"] == 2
    assert _timer(name)["totalMs"] == pytest.approx(5.0)
    assert len(tracing._device_pending) == 1


def test_the_pending_cap_drops_the_oldest(fake_card, monkeypatch):
    assert tracing._device_pending.maxlen == tracing.DEVICE_PENDING
    monkeypatch.setattr(tracing, "_device_pending", deque(maxlen=3))
    dropped = metrics.get_counter("device_timer.dropped")
    for i in range(5):
        _pair(f"fake.device.cap{i}")
    assert [p[0] for p in tracing._device_pending] == [f"fake.device.cap{i}" for i in (2, 3, 4)]
    assert metrics.get_counter("device_timer.dropped") - dropped == 2


def test_one_call_in_a_sample_records_a_pair(fake_card, monkeypatch):
    monkeypatch.setattr(tracing, "DEVICE_SAMPLE_EVERY", 4)
    pending = []
    for _ in range(8):
        _pair("fake.device.sampled")
        pending.append(len(tracing._device_pending))
    assert pending == [1, 1, 1, 1, 2, 2, 2, 2]
    assert FakeEvent.made == 4


@pytest.mark.parametrize("where", ["capturing", "cpu", "profiling", "raised"])
def test_nothing_is_recorded_off_the_card_or_while_capturing(fake_card, where, monkeypatch):
    if where == "capturing":
        fake_card.append(True)
    if where == "profiling":
        monkeypatch.setattr(tracing._profiler, "_is_profiler_enabled", True)
    device = torch.device("cpu") if where == "cpu" else CARD
    if where == "raised":
        with pytest.raises(KeyError):
            with tracing.device_timed("fake.device.off", device):
                raise KeyError("x")
    else:
        _pair("fake.device.off", device)
    assert not tracing._device_pending
    assert FakeEvent.made == (1 if where == "raised" else 0)


# ---------------------------------------------------------------------------
# constant-memory timers
# ---------------------------------------------------------------------------

def _list_based(samples):
    """What the registry returned when it kept every sample in a list."""
    return ({"count": len(samples), "totalMs": sum(samples) * 1000.0,
             "lastMs": samples[-1] * 1000.0}, float(sum(samples)))


def test_timers_keep_constant_storage_and_read_as_a_list():
    rng = random.Random(7)
    name = "test.phases.constant"
    samples = [rng.random() * 10.0 ** rng.randint(-9, 2) for _ in range(100_000)]
    metrics.record_time(name, samples[0])
    entry = metrics._timers[name]
    size = sys.getsizeof(entry)
    for s in samples[1:]:
        metrics.record_time(name, s)
    assert metrics._timers[name] is entry and sys.getsizeof(entry) == size and len(entry) == 4
    want_snapshot, want_total = _list_based(samples)
    assert metrics.snapshot()["timers"][name] == want_snapshot
    assert metrics.timer_totals()[name] == want_total


@pytest.mark.parametrize("seed", range(3))
def test_timer_totals_equal_pythons_sum(seed):
    rng = random.Random(seed)
    name = f"test.phases.sum{seed}"
    samples = [rng.choice([rng.random() * 1e-9, rng.random() * 1e3, -rng.random(), 1e16, -1e16])
               for _ in range(500)]
    for s in samples:
        metrics.record_time(name, s)
    got = (metrics.snapshot()["timers"][name], metrics.timer_totals()[name])
    assert got == _list_based(samples)


def test_threads_recording_at_once_lose_no_sample():
    name, threads, each = "test.phases.threads", 16, 2_000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [metrics.record_time(name, 0.5)
                                                    for _ in range(each)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert metrics.snapshot()["timers"][name]["count"] == threads * each
    assert metrics.timer_totals()[name] == 0.5 * threads * each
