"""Every examples/*.py script on flink_ml_tpu_torch, against the JAX
package's run of the same script.

Each case reads one example, rewrites the package name `flink_ml_tpu` to
`flink_ml_tpu_torch` (`port_source`) and runs it in-process with
`__name__ == "__main__"` and its asserts active, under
`config.use_device("cpu")`. It also runs the script on the JAX package,
as tests/test_examples.py does. Both runs confine the files a script
writes at a literal `/tmp/` path to a directory of the test's own
(`confined`), so two checkouts tested on one machine never share one.
Held to:

- the port's run passes the script's own asserts and prints something;
- its stdout has the JAX run's lines once every number is masked;
- each printed number equals the JAX run's: integers exactly, the others
  within NUMBER_RTOL (float32 reductions in another order: the linear
  regression's mse differs by 2.7e-5 relative).

One stated exception, `multi_tenant_serving_example.py`: the port's
constant upload ledgers the whole aligned buffer (ROADMAP C.39), so its
estimate and bytes are larger by rule (512 bytes a model against the JAX
package's 260, budgets 2.3 times those). Its budget, bytes and peak are
held to their rule instead: bytes == resident x estimate, peak <= budget.
Its hit, miss and eviction counts depend in both packages on how the
server's dispatch worker groups the queued requests, a race between two
threads, so two runs of one package can differ. The case therefore
records the port store's accesses in the order the store served them and
replays that sequence through the JAX package's ModelStore over the same
models: the JAX store must give the same hits, misses, evictions,
resident and models at the example's read of `store.stats`. The models
and resident counts, and eviction, are also held against the JAX run.
The grouping itself is held by
`test_the_multi_tenant_server_groups_and_pages_as_jax_on_one_timeline`
(ROADMAP C.42): on one scripted timeline of arrivals and dispatch times,
on a virtual clock, both packages' servers form the same batches in the
same order and their stores give the same counts. The example's own
counts differ between the packages because their dispatch times do: on a
CPU the port's dispatch ends inside the 5 ms forming budget, so it
batches four requests a tenant and pages 0/9/7, where the JAX package's
outlasts it and pages 2/7/5.

`test_torch_examples_cover_every_example` keeps the case list equal to
the examples directory, so a new example cannot go unported.
"""

import ast
import builtins
import contextlib
import gc
import glob
import io
import os
import re
import threading

import numpy as np
import pytest

from flink_ml_tpu_torch import config
from flink_ml_tpu_torch.data import modelstore as port_store

EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "examples")
EXAMPLES = sorted(glob.glob(os.path.join(EXAMPLES_DIR, "*.py")))
MULTI_TENANT = "multi_tenant_serving_example.py"
#: the multi-tenant example's tenants, and its budget in model estimates
TENANTS, BUDGET_MODELS = ("a", "b", "c"), 2.3
#: a printed number: integer, decimal or exponent form
NUMBER = re.compile(r"(?<![\w.])[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")
NUMBER_RTOL = 1e-4


def confined(text: str, tmp) -> str:
    """`text` with each literal `/tmp/` path moved under the directory
    `tmp`."""
    text = re.sub(r"(?<=[\"'])/tmp/", f"{tmp}/", text)
    assert "/tmp/" not in text.replace(f"{tmp}/", "")
    return text


def example_source(path: str, tmp) -> str:
    """The example's source, its `/tmp/` paths confined to `tmp`."""
    with open(path) as f:
        return confined(f.read(), tmp)


def port_source(path: str, tmp) -> str:
    """The example's source with the JAX package's name replaced by the
    port's, its `/tmp/` paths confined to `tmp`."""
    return re.sub(r"\bflink_ml_tpu\b", "flink_ml_tpu_torch", example_source(path, tmp))


def _captured(run):
    """stdout of `run()` (threads included), and what it returned. Garbage
    is collected first, so the ledgers hold no model of an earlier run."""
    gc.collect()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = run()
    return out.getvalue(), result


def _run_source(source: str, path: str, place):
    code = compile(source, path, "exec")
    namespace = {"__name__": "__main__", "__file__": path, "__builtins__": builtins}

    def run():
        with place:
            exec(code, namespace)
        return namespace

    return _captured(run)


def run_jax(path: str, tmp):
    return _run_source(example_source(path, tmp), path, contextlib.nullcontext())


def run_port(path: str, tmp):
    return _run_source(port_source(path, tmp), path, config.use_device("cpu"))


def _masked(text: str):
    return [NUMBER.sub("#", line) for line in text.strip().splitlines()]


def _numbers(text: str):
    return NUMBER.findall(text)


def _is_integer(token: str) -> bool:
    return not any(c in token for c in ".eE")


def assert_same_output(port: str, ref: str, skip_lines=()):
    """The same lines once numbers are masked; integers equal, other
    numbers within NUMBER_RTOL. Lines in `skip_lines` (indices) are held by
    the caller instead."""
    assert port.strip(), "the example printed nothing on the port"
    assert _masked(port) == _masked(ref)
    port_lines, ref_lines = port.strip().splitlines(), ref.strip().splitlines()
    for i, (mine, theirs) in enumerate(zip(port_lines, ref_lines)):
        if i in skip_lines:
            continue
        for a, b in zip(_numbers(mine), _numbers(theirs)):
            if _is_integer(a) and _is_integer(b):
                assert a == b, f"line {i}: {mine!r} against {theirs!r}"
            else:
                x, y = float(a), float(b)
                assert abs(x - y) <= NUMBER_RTOL * max(abs(x), abs(y)), \
                    f"line {i}: {a} against {b} (rtol {NUMBER_RTOL}): {mine!r}"


@pytest.mark.parametrize("path", EXAMPLES, ids=[os.path.basename(p) for p in EXAMPLES])
def test_example_on_the_port_matches_jax(path, monkeypatch, tmp_path):
    name = os.path.basename(path)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    ref, _ = run_jax(path, tmp_path / "jax")
    assert ref.strip()
    if name == MULTI_TENANT:
        log = _record_paging(monkeypatch)
        port, namespace = run_port(path, tmp_path / "port")
        _check_multi_tenant(port, ref, namespace, log)
        return
    port, _ = run_port(path, tmp_path / "port")
    assert_same_output(port, ref)


def test_an_example_writes_under_its_own_directory(tmp_path):
    path = os.path.join(EXAMPLES_DIR, "quick_start.py")
    with open(path) as f:
        assert '"/tmp/quickstart_model"' in f.read()
    for source in (example_source(path, tmp_path), port_source(path, tmp_path)):
        assert "/tmp/" not in source.replace(f"{tmp_path}/", "")
        assert f'"{tmp_path}/quickstart_model"' in source


def test_torch_examples_cover_every_example():
    names = sorted(n for n in os.listdir(EXAMPLES_DIR) if n.endswith(".py"))
    assert [os.path.basename(p) for p in EXAMPLES] == names
    assert len(names) >= 38


# -- the multi-tenant example ------------------------------------------------

def _record_paging(monkeypatch):
    """Record the port store's accesses in the order it serves them:
    ("page_in", key) for a page-in asked by the server or the example,
    ("refresh", key) for a republish (whose own page-in is part of it), and
    ("stats", stats) at each read of `stats`. Each record is taken under the
    store's lock, the lock that orders the accesses themselves."""
    log = []
    inside = threading.local()
    cls = port_store.ModelStore
    page_in, refresh, stats = cls.page_in, cls.refresh, cls.stats

    def recorded_page_in(self, key):
        with self._lock:
            if not getattr(inside, "refresh", False):
                log.append(("page_in", key))
            return page_in(self, key)

    def recorded_refresh(self, key):
        with self._lock:
            log.append(("refresh", key))
            inside.refresh = True
            try:
                return refresh(self, key)
            finally:
                inside.refresh = False

    def recorded_stats(self):
        with self._lock:
            value = stats.fget(self)
            log.append(("stats", dict(value)))
            return value

    monkeypatch.setattr(cls, "page_in", recorded_page_in)
    monkeypatch.setattr(cls, "refresh", recorded_refresh)
    monkeypatch.setattr(cls, "stats", property(recorded_stats))
    return log


def _replay_on_jax(log):
    """The recorded accesses through the JAX package's ModelStore over the
    example's models (seeds 0, 1, 2 of a 64-wide OnlineLogisticRegression
    in a PipelineModel) under a budget of BUDGET_MODELS times its
    estimate, as the example sizes it. Returns the JAX store's stats at
    each recorded read of `stats`."""
    from flink_ml_tpu.data.modelstore import ModelStore
    from flink_ml_tpu.models.classification.onlinelogisticregression import (
        OnlineLogisticRegressionModel,
    )
    from flink_ml_tpu.pipeline import PipelineModel

    def make_model(seed):
        m = OnlineLogisticRegressionModel()
        m.publish_model_arrays((np.random.RandomState(seed).randn(64),), 0)
        m.set_features_col("features").set_prediction_col("pred")
        return PipelineModel([m])

    probe = ModelStore(budget_bytes=None)
    probe.register("a", make_model(0))
    store = ModelStore(budget_bytes=int(probe.estimated_nbytes("a") * BUDGET_MODELS))
    for i, t in enumerate(TENANTS):
        store.register(t, make_model(i))
    seen = []
    for kind, arg in log:
        if kind == "page_in":
            store.page_in(arg)
        elif kind == "refresh":
            store.refresh(arg)
        else:
            seen.append(store.stats)
    return seen


def _check_multi_tenant(port: str, ref: str, namespace, log):
    """The stated exception (module docstring)."""
    port_lines, ref_lines = port.strip().splitlines(), ref.strip().splitlines()
    # line 0: "3 models x E bytes (est) into a B-byte budget"; line 2: the
    # served counts and the store's stats; line 3: "peak model bytes P <=
    # budget B; ..."
    assert_same_output(port, ref, skip_lines=(0, 2, 3))
    models, estimate, budget = (int(v) for v in _numbers(port_lines[0])[:3])
    assert namespace["per_model"] == estimate and namespace["budget"] == budget
    assert models == len(TENANTS) and budget == int(estimate * BUDGET_MODELS)
    served, stats = (ast.literal_eval(part) for part in re.findall(r"\{[^}]*\}", port_lines[2]))
    ref_served, ref_stats = (ast.literal_eval(part)
                             for part in re.findall(r"\{[^}]*\}", ref_lines[2]))
    assert served == ref_served
    assert stats["models"] == ref_stats["models"] == models
    assert stats["resident"] == ref_stats["resident"]
    assert stats["evictions"] > 0 and ref_stats["evictions"] > 0
    assert stats["bytes"] == stats["resident"] * estimate
    peak, peak_budget = (int(v) for v in _numbers(port_lines[3])[:2])
    assert peak_budget == budget and peak <= budget
    # paging exactly as the JAX store pages the same accesses
    reads = [arg for kind, arg in log if kind == "stats"]
    assert reads and reads[-1] == stats
    jax_reads = _replay_on_jax(log)
    for mine, theirs in zip(reads, jax_reads):
        keys = ("models", "resident", "hits", "misses", "evictions")
        assert {k: mine[k] for k in keys} == {k: theirs[k] for k in keys}
    assert len(jax_reads) == len(reads)


# -- the multi-tenant server's grouping on one timeline (ROADMAP C.42) ------

class _Clock:
    """A virtual `time` module for the server: `monotonic` reads `now`,
    every other name is the real module's."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def __getattr__(self, name):
        import time
        return getattr(time, name)


class _Timeline:
    """The admission queue of a scripted timeline: `events` are (time,
    action) pairs, an action submits a request (whose `put` lands here)
    or promotes a model. `get` fires every event whose time has come,
    moves the clock to the next event when the worker would wait for it,
    and raises TimeoutError when the worker's timeout ends first; after
    the last event the queue reads as closed."""

    def __init__(self, clock, events, closed):
        self.clock, self.events, self.closed = clock, list(events), closed
        self.queue = []

    def put(self, item, timeout=None):
        self.queue.append(item)
        return True

    def __len__(self):
        return len(self.queue)

    def close(self):
        pass

    def get(self, timeout=None):
        while True:
            while self.events and self.events[0][0] <= self.clock.now:
                self.events.pop(0)[1]()
            if self.queue:
                return self.queue.pop(0)
            if not self.events:
                raise self.closed()
            at = self.events[0][0]
            if timeout is not None and at > self.clock.now + timeout:
                self.clock.now += timeout
                raise TimeoutError
            self.clock.now = at


def serve_on_a_timeline(package: str, gap_ms: float, dispatch_ms):
    """The multi-tenant example's serving run on one package's
    MicroBatchServer and ModelStore, on a virtual clock: its 15 round-robin
    requests, tenant b's promote and 15 more arrive `gap_ms` apart, and a
    dispatch takes dispatch_ms[0] the first time and dispatch_ms[1] after.
    The worker runs in this thread. Returns the forming batches in dispatch
    order ("a4" is four of tenant a's requests), the store's (hits, misses,
    evictions, resident) and the served (seq, tenant) pairs."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{package}.{name}")

    serving, flow, table = mod("serving"), mod("flow"), mod("table")
    olr = mod("models.classification.onlinelogisticregression")

    def make_model(seed):
        m = olr.OnlineLogisticRegressionModel()
        m.publish_model_arrays((np.random.RandomState(seed).randn(64),), 0)
        m.set_features_col("features").set_prediction_col("pred")
        return mod("pipeline").PipelineModel([m])

    models = {t: make_model(i) for i, t in enumerate(TENANTS)}
    store_cls = mod("data.modelstore").ModelStore
    probe = store_cls(budget_bytes=None)
    probe.register("a", models["a"])
    store = store_cls(budget_bytes=int(probe.estimated_nbytes("a") * BUDGET_MODELS))
    for t in TENANTS:
        lifecycle = mod("lifecycle").ModelLifecycle(models[t].stages[0]) if t == "b" else None
        store.register(t, models[t], lifecycle=lifecycle, quota=8)
    server = serving.MicroBatchServer(store=store, batching="continuous", form_rows=16,
                                      buckets=(16,), admission=32)
    rng, clock = np.random.RandomState(7), _Clock()

    def submit(i):
        return lambda: server.submit(
            table.Table({"features": rng.randn(4, 64).astype(np.float32)}),
            tenant=TENANTS[i % len(TENANTS)])

    actions = [submit(i) for i in range(15)]
    actions.append(lambda: store.promote("b", (np.linspace(1.0, -1.0, 64),)))
    actions += [submit(i) for i in range(15)]
    events = [(clock.now + (i + 1) * gap_ms / 1000.0, a) for i, a in enumerate(actions)]
    groups, dispatched = [], []
    cls = serving.MicroBatchServer
    flush_group, dispatch = cls._flush_group, cls._dispatch

    def recorded_flush(self, group, window):
        groups.append(f"{group.tenant}{len(group.reqs)}")
        return flush_group(self, group, window)

    def timed_dispatch(self, *args, **kwargs):
        out = dispatch(self, *args, **kwargs)
        clock.now += dispatch_ms[0 if not dispatched else 1] / 1000.0
        dispatched.append(1)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cls, "_flush_group", recorded_flush)
        mp.setattr(cls, "_dispatch", timed_dispatch)
        mp.setattr(serving, "time", clock)
        server._requests = _Timeline(clock, events, flow.ChannelClosed)
        server._out = flow.BoundedChannel(1000, policy=flow.BLOCK, name="serving.results")
        server._worker = "the test's thread"
        server._run()
        results = list(server._out)
    assert all(r.status == "ok" for r in results)
    stats = store.stats
    return ("".join(groups), (stats["hits"], stats["misses"], stats["evictions"],
                              stats["resident"]),
            [(r.seq, r.tenant) for r in results])


#: (gap between arrivals, (first, later) dispatch) in ms; the first is the
#: port's run of the example on a CPU (each dispatch well inside the 5 ms
#: forming budget), the second a run whose dispatches outlast the budget,
#: as the JAX package's do on a CPU
TIMELINES = [(0.05, (0.3, 0.3)), (0.05, (100.0, 2.0)), (0.2, (6.0, 6.0)), (0.1, (30.0, 3.0)),
             (1.0, (2.0, 2.0)), (3.0, (3.0, 3.0))]


@pytest.mark.parametrize("gap_ms,dispatch_ms", TIMELINES,
                         ids=[f"gap{g}-dispatch{d[0]}-{d[1]}" for g, d in TIMELINES])
def test_the_multi_tenant_server_groups_and_pages_as_jax_on_one_timeline(gap_ms, dispatch_ms):
    """On the same arrivals and dispatch times the port's continuous
    server forms the JAX server's batches, in its order, and its store
    pages as the JAX store does (ROADMAP C.42): the grouping the example's
    counts depend on is the JAX package's, and only the dispatch times
    differ between the two packages' runs."""
    ref = serve_on_a_timeline("flink_ml_tpu", gap_ms, dispatch_ms)
    with config.use_device("cpu"):
        port = serve_on_a_timeline("flink_ml_tpu_torch", gap_ms, dispatch_ms)
    assert port == ref
    assert sum(int(g[1:]) for g in re.findall(r"[abc]\d+", port[0])) == 30
    if (gap_ms, dispatch_ms) == TIMELINES[0]:  # four requests a batch: the port's CPU run
        assert port[0] == "a4b4c4a4b4c4a2b2c2"
    if (gap_ms, dispatch_ms) == TIMELINES[1]:  # the budget expires behind each dispatch
        assert port[0] == "a4b3c3b4c4a4b3c3a2"
