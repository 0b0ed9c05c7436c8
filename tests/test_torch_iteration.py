"""The runtime of the port's stream and online training, on the CPU:

- the native data cache (built from native/src/datacache.cc at first use)
  and ReplayableStreamTable: round trips of dense and sparse batches, the
  memory budget and spill, the replay of a partly consumed first pass;
- staging and the one-worker Prefetcher: input order, an error in the
  stage or the source surfacing at the consumer, an early close that stops
  the worker; the device epoch cache and its loader;
- iterate_bounded against the JAX package's on a small body (the same stop
  epoch, criteria and carry), and iterate_unbounded's versions and
  listener calls;
- the checkpoint arguments that raised until checkpoints were ported
  (ROADMAP A.13) now checkpoint: each such call, killed at its fault site,
  resumes to its unkilled result bit for bit (test_torch_checkpoint.py
  holds the rest); the lossy overload policies are held against the JAX
  package in test_torch_flow.py.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flink_ml_tpu.parallel import iteration as jax_iteration
from flink_ml_tpu_torch import SparseBatch, StreamTable, Table, config, native
from flink_ml_tpu_torch.data.devicecache import CachedEpochLoader, DeviceEpochCache
from flink_ml_tpu_torch.models.classification import onlinelogisticregression as port_olr
from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression
from flink_ml_tpu_torch.models.clustering import onlinekmeans as port_okm
from flink_ml_tpu_torch.models.clustering.kmeans import KMeans
from flink_ml_tpu_torch.native.datacache import DataCache, ReplayableStreamTable
from flink_ml_tpu_torch.ops import losses
from flink_ml_tpu_torch.ops.optimizer import SGD
from flink_ml_tpu_torch.parallel import iteration
from flink_ml_tpu_torch.parallel.prefetch import DeviceStager, Prefetcher, stage_to_device


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32, np.int64])
def test_data_cache_round_trip(tmp_path, dtype):
    cache = DataCache(1 << 20, str(tmp_path))
    arrays = [np.arange(12, dtype=dtype).reshape(3, 4), np.zeros((0, 5), dtype), np.array(7, dtype)]
    segs = [cache.append_array(a) for a in arrays]
    assert segs == [0, 1, 2] and cache.num_segments == 3
    for seg, a in zip(segs, arrays):
        got = cache.read_array(seg)
        assert got.dtype == a.dtype and got.shape == a.shape and got.flags.writeable
        np.testing.assert_array_equal(got, a)
    buf = np.full(200, 255, np.uint8)
    view = cache.read_into(0, buf)
    np.testing.assert_array_equal(view, arrays[0])
    assert np.all(buf[arrays[0].nbytes:] == 255)
    with pytest.raises(ValueError, match="buffer"):
        cache.read_into(0, np.empty(4, np.uint8))
    cache.close()
    cache.close()


def test_data_cache_spills_over_its_budget(tmp_path):
    cache = DataCache(1000, str(tmp_path))
    arrays = [np.random.default_rng(i).random(100) for i in range(4)]  # 800 bytes each
    for a in arrays:
        cache.append_array(a)
    assert cache.stats == {"numSegments": 4, "spilledSegments": 3, "memoryUsedBytes": 800}
    assert (tmp_path / cache.spill_path.split("/")[-1]).exists()
    for seg in (3, 0, 2, 1):  # out of order, from memory and from the file
        np.testing.assert_array_equal(cache.read_array(seg), arrays[seg])
    cache.close()
    assert list(tmp_path.iterdir()) == []


def test_native_build_failure_raises_with_the_compiler_output(tmp_path, monkeypatch):
    broken = tmp_path / "broken.cc"
    broken.write_text("int main( {\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "_build" / "libbroken.so")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*broken.cc"):
        native.load()


def _tables():
    rng = np.random.default_rng(0)
    out = []
    for n in (3, 5, 4):
        idx = rng.integers(-1, 6, (n, 2)).astype(np.int32)
        out.append(Table({"x": rng.random((n, 2)), "label": rng.integers(0, 2, n),
                          "s": SparseBatch(6, idx, rng.random((n, 2)))}))
    return out


def _assert_tables_equal(a, b):
    assert a.column_names == b.column_names
    for name in a.column_names:
        x, y = a.column(name), b.column(name)
        if isinstance(x, SparseBatch):
            assert x.size == y.size
            np.testing.assert_array_equal(x.indices, y.indices)
            np.testing.assert_array_equal(x.values, y.values)
        else:
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_replayable_stream_round_trips_dense_and_sparse(tmp_path):
    tables = _tables()
    replay = ReplayableStreamTable(iter(tables), 64, str(tmp_path))  # spills
    for _ in range(3):
        got = list(replay)
        assert len(got) == 3
        for a, b in zip(tables, got):
            _assert_tables_equal(a, b)
    assert replay.stats["numSegments"] == 12 and replay.stats["spilledSegments"] > 0
    replay.close()


def test_replayable_stream_partial_first_pass(tmp_path):
    tables = _tables()
    consumed = []

    def source():
        for t in tables:
            consumed.append(t)
            yield t

    replay = ReplayableStreamTable(source(), 1 << 20, str(tmp_path))
    first = iter(replay)
    next(first)  # an early stop after one batch
    assert len(consumed) == 1
    second = list(replay)
    assert len(second) == 3 and len(consumed) == 3
    for a, b in zip(tables, second):
        _assert_tables_equal(a, b)
    with pytest.raises(TypeError, match="python objects"):
        list(ReplayableStreamTable([Table({"o": ["a", "b"]})], 1 << 20, str(tmp_path)))


def test_replayable_stream_random_access(tmp_path):
    tables = _tables()
    replay = ReplayableStreamTable(iter(tables), 1 << 20, str(tmp_path))
    assert replay.batch_rows() == [3, 5, 4]  # caches the whole source first
    _assert_tables_equal(replay.batch(1), tables[1])
    only = replay.batch(2, ["s"])
    assert only.column_names == ["s"]
    np.testing.assert_array_equal(only.column("s").values, tables[2].column("s").values)
    assert len(list(replay)) == 3
    replay.close()


def test_stage_to_device_on_the_cpu_is_a_copy():
    X = np.arange(6, dtype=np.float64).reshape(3, 2)
    pieces = [np.ones((2, 2)), np.zeros((1, 2))]
    tree = stage_to_device((X, (pieces, np.arange(3))), torch.device("cpu"), torch.float32).wait()
    X[0, 0] = 100.0
    got_X, (got_p, got_i) = tree
    assert got_X.dtype == torch.float32 and got_X[0, 0] == 0.0
    assert torch.equal(got_p, torch.tensor([[1.0, 1.0], [1.0, 1.0], [0.0, 0.0]]))
    assert got_i.dtype == torch.int64 and got_i.tolist() == [0, 1, 2]


def _worker_threads():
    return [t for t in threading.enumerate() if t.name == "prefetch"]


def test_prefetcher_keeps_input_order():
    def stage(i):
        time.sleep(0.002 * (i % 3))
        return i * i

    out = list(Prefetcher(stage, depth=2).iterate(range(40)))
    assert out == [i * i for i in range(40)]
    assert _worker_threads() == []


@pytest.mark.parametrize("where", ["stage", "source"])
def test_prefetcher_surfaces_errors_after_earlier_items(where):
    def source():
        for i in range(10):
            if where == "source" and i == 4:
                raise KeyError("source broke")
            yield i

    def stage(i):
        if where == "stage" and i == 4:
            raise KeyError("stage broke")
        return i

    it = Prefetcher(stage, depth=3).iterate(source())
    assert [next(it) for _ in range(4)] == [0, 1, 2, 3]
    with pytest.raises(KeyError, match=f"{where} broke"):
        next(it)
    assert _worker_threads() == []


def test_prefetcher_early_close_stops_the_worker():
    staged = []

    def stage(i):
        staged.append(i)
        return i

    it = Prefetcher(stage, depth=2).iterate(iter(range(1000)))
    assert next(it) == 0
    it.close()
    assert _worker_threads() == []
    assert len(staged) <= 4  # the one consumed, the window and the one in hand


def test_prefetchers_under_thread_pressure():
    """Sixteen consumers, each with its own prefetch worker, switching
    threads as often as the interpreter allows: every consumer still gets
    its items once each, in order, and every thread ends."""
    results, old = {}, sys.getswitchinterval()

    def consume(k):
        results[k] = list(Prefetcher(lambda i: (k, i), depth=1 + k % 3).iterate(range(300)))

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=consume, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert results == {k: [(k, i) for i in range(300)] for k in range(16)}
    assert _worker_threads() == []


def test_device_epoch_cache_budget_and_lru():
    stager = DeviceStager(torch.device("cpu"))
    batch = lambda v: stager(np.full(64, v, np.float32))  # noqa: E731  256 bytes
    cache = DeviceEpochCache(600)
    assert cache.put("a", batch(1)) and cache.put("b", batch(2))
    assert cache.get("a") is not None  # "b" is now the least recent
    cache.put("c", batch(3))
    assert cache.get("b") is None and len(cache) == 2
    assert not cache.put("big", stager(np.zeros(1000, np.float32)))
    assert cache.stats["evictions"] == 1 and cache.stats["residentBytes"] == 512
    assert not DeviceEpochCache(0).enabled


@pytest.mark.parametrize("budget", [0, 300, None])
def test_cached_epoch_loader_gives_the_same_batches_at_any_budget(budget):
    stager = DeviceStager(torch.device("cpu"))
    staged = []

    def stage(key):
        staged.append(key)
        return stager(np.full(64, key, np.float32))

    loader = CachedEpochLoader(stage, DeviceEpochCache(budget))
    keys = [0, 1, 2, 0, 1, 2, 2, 2, 1]
    got = [int(b[0]) for b in loader.epoch(keys)]
    assert got == keys
    if budget is None:
        assert staged == [0, 1, 2]
    if budget == 0:
        assert staged == [0, 1, 2, 0, 1, 2, 1]  # a repeated key is not staged again


def _body(lib):
    """The same body in torch and jnp: carry (x, s), criteria |x - 3|."""

    def body(carry, epoch):
        x, s = carry
        x = x + 0.5 * (3.0 - x)
        return (x, s + epoch), lib.abs(x - 3.0)

    return body


class _Recorder(iteration.IterationListener):
    def __init__(self):
        self.epochs, self.terminated = [], None

    def on_epoch_watermark_incremented(self, epoch, carry):
        self.epochs.append(epoch)

    def on_iteration_terminated(self, carry):
        self.terminated = carry


@pytest.mark.parametrize("listener", [False, True], ids=["device", "host"])
@pytest.mark.parametrize("max_iter,tol", [(20, 1e-3), (5, 1e-3), (8, None), (1, 10.0)])
def test_iterate_bounded_matches_jax(max_iter, tol, listener):
    recorder = _Recorder() if listener else None
    got = iteration.iterate_bounded(
        _body(torch), (torch.tensor(0.0), torch.tensor(0)), max_iter, tol, listener=recorder)
    jax_recorder = jax_iteration.IterationListener() if listener else None
    want = jax_iteration.iterate_bounded(
        _body(jnp), (jnp.asarray(0.0), jnp.asarray(0)), max_iter, tol, listener=jax_recorder)
    assert got.num_epochs == want.num_epochs
    np.testing.assert_allclose(got.final_criteria, want.final_criteria, rtol=1e-6)
    np.testing.assert_allclose(float(got.carry[0]), float(want.carry[0]), rtol=1e-6)
    assert int(got.carry[1]) == int(want.carry[1])
    if listener:
        assert recorder.epochs == list(range(1, got.num_epochs + 1))
        assert recorder.terminated is not None


def test_iterate_unbounded_versions_and_listener():
    recorder = _Recorder()
    read = []

    def batches():
        for b in (2, 3, 4):
            read.append(b)
            yield b

    updates = iteration.iterate_unbounded(batches(), lambda s, b: s * b, 1, listener=recorder)
    assert read == []
    assert list(updates) == [(1, 2), (2, 6), (3, 24)]
    assert recorder.epochs == [1, 2, 3] and recorder.terminated == 24


def _not_ported_calls(ckpt):
    """name -> (the fault site, a call of each path that once raised
    NotImplementedError for its checkpoint argument, naming A.13). Each
    call checkpoints into `ckpt` and returns what a resume must equal."""
    X = np.random.default_rng(0).standard_normal((240, 2))
    y = (X[:, 0] > 0).astype(np.float64)

    def stream():
        return StreamTable.from_batches(
            [Table({"features": X[i:i + 40], "label": y[i:i + 40]}) for i in range(0, 240, 40)])

    def online(est):
        model = est.fit(stream())
        model.process_updates()
        return (model.model_version,
                np.asarray(getattr(model, "coefficient", getattr(model, "centroids", None))))

    olr = lambda: port_olr.OnlineLogisticRegression().set_global_batch_size(40) \
        .set_initial_model_data(Table({"coefficient": [port_olr.DenseVector(np.zeros(2))]}))  # noqa: E731
    okm = lambda: port_okm.OnlineKMeans().set_global_batch_size(40).set_initial_model_data(  # noqa: E731
        port_okm.generate_random_model_data(2, 2, 1.0))
    return {
        "iterate_bounded": ("chunk", lambda: iteration.iterate_bounded(
            _body(torch), (torch.tensor(0.0), torch.tensor(0)), 6, checkpoint_dir=ckpt).carry),
        "iterate_unbounded": ("batch", lambda: list(iteration.iterate_unbounded(
            iter([2.0, 3.0, 4.0]), lambda s, b: s * b, torch.tensor(1.0), checkpoint_dir=ckpt))[-1]),
        "optimize_stream": ("epoch", lambda: SGD(checkpoint_dir=ckpt, max_iter=6,
                                                 global_batch_size=40).optimize_stream(
            None, ((X[i:i + 40], y[i:i + 40], None) for i in range(0, 240, 40)),
            losses.BINARY_LOGISTIC_LOSS)[0]),
        "config checkpoint, stream fit": ("epoch", lambda: _with_config(
            "iteration_checkpoint_dir", ckpt,
            lambda: LogisticRegression().set_max_iter(6).set_global_batch_size(40)
            .fit(stream()).coefficient)),
        "config checkpoint, kmeans stream": ("epoch", lambda: _with_config(
            "iteration_checkpoint_dir", ckpt,
            lambda: KMeans().set_k(2).set_max_iter(4).fit(stream()).centroids)),
        "config checkpoint, online lr": ("batch", lambda: _with_config(
            "iteration_checkpoint_dir", ckpt, lambda: online(olr()))),
        "config checkpoint, online kmeans": ("batch", lambda: _with_config(
            "iteration_checkpoint_dir", ckpt, lambda: online(okm()))),
    }


def _with_config(name, value, call):
    old = getattr(config, name)
    setattr(config, name, value)
    try:
        return call()
    finally:
        setattr(config, name, old)


NOT_PORTED = [
    "iterate_bounded", "iterate_unbounded", "optimize_stream", "config checkpoint, stream fit",
    "config checkpoint, kmeans stream", "config checkpoint, online lr",
    "config checkpoint, online kmeans",
]


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        return all(_equal(x, y) for x, y in zip(a, b)) and len(a) == len(b)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", NOT_PORTED)
def test_unported_options_raise_naming_their_roadmap_item(name, tmp_path):
    """These checkpoint options raised NotImplementedError naming ROADMAP
    A.13 until checkpoints were ported; each now checkpoints, and a run
    killed at its fault site resumes to the unkilled run's result."""
    from flink_ml_tpu_torch.ckpt import faults

    assert sorted(_not_ported_calls(str(tmp_path))) == sorted(NOT_PORTED)
    with config.use_device("cpu"):
        site, call = _not_ported_calls(str(tmp_path / "ref"))[name]
        want = call()
        site, call = _not_ported_calls(str(tmp_path / "kill"))[name]
        with faults.inject(site, after=2):
            with pytest.raises(faults.InjectedFault):
                call()
        assert _equal(call(), want)


def test_unknown_overload_policy_is_refused():
    with pytest.raises(ValueError, match="unknown overload policy"):
        Prefetcher(lambda i: i, policy="drop_newest")
