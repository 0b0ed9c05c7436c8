"""The port's runtime concurrency sanitizer
(flink_ml_tpu_torch/analysis/sanitizer.py), case for case as
tests/test_sanitizer.py holds the JAX one, on the port's `flow`:

- the recorder catches an ABBA pattern on a throwaway pair of locks, stays
  quiet on consistently ordered and reentrant acquisitions, and keeps its
  held stack true across a condition wait;
- the channel and worker ledgers: an unclosed pump channel and a leaked
  worker are problems, an unpumped channel needs no close;
- the collective-sequence ledger (host plumbing: the port has no
  collective until the multi-card slice, so the JAX package's traced
  `mesh8` case has no counterpart here);
- end to end through the instrumented flow layer, each in a subprocess
  (so no other test runs instrumented): a clean pump drain exits 0, an
  abandoned pump worker exits 66, a cancel releases the worker, and a
  `Prefetcher` and a push-mode `MicroBatchServer` driven to completion
  leave no problem; `enable()` wraps both bindings of `capture_lock`;
- the port's recorder against the JAX package's: the same sequences fed
  to both give the same cycles, problems, edges and stats (the port's
  extra `locks` count aside), and the instrumented flow scripts end with
  the same exit code and verdict on both packages; the one deviation, the
  channel ledger keyed by a token and not by `id()`, is tested on its own
  (`test_a_dead_channels_id_does_not_hide_a_new_one`);
- the Prefetcher's bounded join (the repair of untimed-wait's finding at
  its `worker.join()`), also when its generator is dropped without close()
  or closed through `iterate_unbounded`.
"""

import gc
import itertools
import os
import subprocess
import sys
import textwrap
import threading

import pytest

from flink_ml_tpu.analysis import sanitizer as jax_sanitizer
from flink_ml_tpu_torch import config
from flink_ml_tpu_torch.analysis import sanitizer
from flink_ml_tpu_torch.parallel import iteration, prefetch
from flink_ml_tpu_torch.utils import metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestLockOrderRecorder:
    def test_abba_cycle_detected_sequentially(self):
        rec = sanitizer.Recorder()
        a = sanitizer.TrackedLock("test.A", rec)
        b = sanitizer.TrackedLock("test.B", rec)

        def t1():
            with a:
                with b:
                    pass

        def t2():
            with b:
                with a:
                    pass

        for fn in (t1, t2):
            t = threading.Thread(target=fn)
            t.start()
            t.join(timeout=10)
        cycles = rec.cycles()
        assert cycles, "inverted acquisition order must record a cycle"
        assert sorted(cycles[0]) == ["test.A", "test.B"]
        with pytest.raises(sanitizer.SanitizerError) as err:
            rec.check()
        assert "test.A" in str(err.value) and "test.B" in str(err.value)

    def test_real_abba_deadlock_pattern(self):
        """Both threads take their first lock, then attempt the other: the
        deadlock interleaving. Timed second acquires keep the test finite;
        the attempt-time edges still pin the cycle."""
        rec = sanitizer.Recorder()
        a = sanitizer.TrackedLock("abba.A", rec)
        b = sanitizer.TrackedLock("abba.B", rec)
        barrier = threading.Barrier(2)
        blocked = []

        def worker(first, second):
            with first:
                barrier.wait(timeout=10)  # both hold their first lock
                got = second.acquire(timeout=0.2)
                if got:
                    second.release()
                else:
                    blocked.append(second._name)

        t1 = threading.Thread(target=worker, args=(a, b))
        t2 = threading.Thread(target=worker, args=(b, a))
        t1.start(), t2.start()
        t1.join(timeout=10), t2.join(timeout=10)
        assert blocked, "at least one second acquire must have been blocked"
        cycles = rec.cycles()
        assert cycles and sorted(cycles[0]) == ["abba.A", "abba.B"]

    def test_consistent_order_is_clean(self):
        rec = sanitizer.Recorder()
        a = sanitizer.TrackedLock("ok.A", rec)
        b = sanitizer.TrackedLock("ok.B", rec)
        for _ in range(3):
            with a:
                with b:
                    pass
        assert rec.cycles() == []
        rec.check()  # no raise
        assert rec.stats()["locks"] == 2 and rec.stats()["acquisitions"] == 6

    def test_reentrant_reacquire_is_not_an_edge(self):
        rec = sanitizer.Recorder()
        r = sanitizer.TrackedRLock("re.R", rec)
        with r:
            with r:
                pass
        assert rec.edges == {}
        assert rec.cycles() == []

    def test_condition_wait_keeps_held_stack_truthful(self):
        rec = sanitizer.Recorder()
        cv = sanitizer.TrackedCondition("cv.C", rec)
        other = sanitizer.TrackedLock("cv.L", rec)
        with cv:
            cv.wait(timeout=0.01)
        with other:
            pass
        # cv was fully released before `other` was taken: no edge
        assert ("cv.C", "cv.L") not in rec.edges


class _FakeChannel:
    def __init__(self, name):
        self.name = name


class TestLedger:
    def test_unclosed_pump_channel_is_a_problem(self):
        rec = sanitizer.Recorder()
        ch = _FakeChannel("leaky")
        rec.register_channel(ch)
        rec.channel_pumped(ch)
        problems = rec.problems(join_timeout=0.01)
        assert any("leaky" in p and "unclosed" in p for p in problems)
        rec.channel_closed(ch)
        assert rec.problems(join_timeout=0.01) == []

    def test_a_dead_channels_id_does_not_hide_a_new_one(self):
        """Entries are keyed by a token stamped on the channel, not by
        id(): a channel made where a dead one lay is a channel of its own,
        and its missing close is still seen."""
        rec = sanitizer.Recorder()
        for i in range(3):
            ch = _FakeChannel(f"c{i}")
            rec.register_channel(ch)
            rec.channel_pumped(ch)
            if i < 2:
                rec.channel_closed(ch)
            del ch
        assert rec.stats()["channels"] == 3 and rec.stats()["channelsClosed"] == 2
        assert [p for p in rec.problems(join_timeout=0.01) if "unclosed" in p] == [
            "unclosed pump channel 'c2': a producer worker was attached but close()/cancel() "
            "never ran"]

    def test_unpumped_channel_needs_no_close(self):
        rec = sanitizer.Recorder()
        ch = _FakeChannel("scratch")
        rec.register_channel(ch)
        assert rec.problems(join_timeout=0.01) == []

    def test_leaked_worker_is_a_problem(self):
        rec = sanitizer.Recorder()
        release = threading.Event()
        t = threading.Thread(target=release.wait, args=(30,), daemon=True)
        t.start()
        rec.register_worker(t, "spawn")
        problems = rec.problems(join_timeout=0.05)
        assert any("leaked worker" in p for p in problems)
        release.set()
        t.join(2.0)
        assert rec.problems(join_timeout=0.5) == []


class TestCollectiveSequenceRecorder:
    def test_matching_sequences_are_clean(self):
        rec = sanitizer.Recorder()
        for shard in (0, 1, 2):
            with rec.shard_scope(shard, group="hosts"):
                rec.record_collective("all_reduce", "data", (128,), "float32")
                rec.record_collective("all_gather", "data", (16,), "float32")
        assert rec.collective_divergences() == []
        rec.check(join_timeout=0.01)

    def test_mismatched_op_is_a_divergence(self):
        rec = sanitizer.Recorder()
        with rec.shard_scope(0, group="hosts"):
            rec.record_collective("all_reduce", "data", (128,), "float32")
        with rec.shard_scope(1, group="hosts"):
            rec.record_collective("all_gather", "data", (128,), "float32")
        problems = rec.problems(join_timeout=0.01)
        assert any("collective-sequence divergence" in p for p in problems)
        with pytest.raises(sanitizer.SanitizerError):
            rec.check(join_timeout=0.01)

    def test_missing_trailing_collective_is_a_divergence(self):
        rec = sanitizer.Recorder()
        with rec.shard_scope("host0", group="hosts"):
            rec.record_collective("all_reduce", "data", (4,), "float32")
            rec.record_collective("all_reduce", "data", (4,), "float32")
        with rec.shard_scope("host1", group="hosts"):
            rec.record_collective("all_reduce", "data", (4,), "float32")
        problems = rec.problems(join_timeout=0.01)
        assert any("deadlock" in p for p in problems)

    def test_shape_dtype_mismatch_is_a_divergence(self):
        rec = sanitizer.Recorder()
        with rec.shard_scope(0, group="hosts"):
            rec.record_collective("all_reduce", "data", (128,), "float32")
        with rec.shard_scope(1, group="hosts"):
            rec.record_collective("all_reduce", "data", (128,), "bfloat16")
        assert rec.collective_divergences()

    def test_single_scope_and_default_trace_context_cannot_diverge(self):
        rec = sanitizer.Recorder()
        rec.record_collective("all_reduce", "data", (8,), "float32")
        rec.record_collective("all_gather", "data", (8,), "float32")
        with rec.shard_scope(0, group="solo"):
            rec.record_collective("all_reduce", "data", (8,), "float32")
        assert rec.collective_divergences() == []

    def test_scoped_recording_detaches_afterwards(self):
        """`collective_recording` feeds a throwaway recorder; outside it
        the funnel is a no-op (the sanitizer is off in this process)."""
        with sanitizer.collective_recording() as rec:
            sanitizer.record_collective("all_reduce", "data", (1,), "float32")
        assert rec.collective_sequences["trace"]["0"] == [("all_reduce", "data", (1,), "float32")]
        sanitizer.record_collective("all_reduce", "data", (1,), "float32")
        assert rec.collective_count == 1


def _run_script(source: str):
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(source)],
        capture_output=True,
        text=True,
        cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "FLINK_ML_TPU_SANITIZE": "1"},
        timeout=300,
    )


class TestInstrumentedFlowEndToEnd:
    def test_clean_pump_drain_exits_zero(self):
        result = _run_script(
            """
            from flink_ml_tpu_torch.analysis import sanitizer
            sanitizer.enable()
            from flink_ml_tpu_torch import flow

            ch = flow.BoundedChannel(4, name="t.clean")
            flow.pump(range(32), ch, transform=lambda x: x * 2)
            assert list(ch) == [x * 2 for x in range(32)]
            """
        )
        assert result.returncode == 0, result.stderr
        assert "FLINK_ML_TPU_SANITIZE: clean" in result.stderr

    def test_abandoned_pump_worker_fails_at_exit(self):
        result = _run_script(
            """
            import itertools
            from flink_ml_tpu_torch.analysis import sanitizer
            sanitizer.enable()
            from flink_ml_tpu_torch import flow

            ch = flow.BoundedChannel(2, name="t.leak")
            flow.pump(itertools.count(), ch)  # unbounded producer
            ch.get(timeout=60)  # consume one, then abandon WITHOUT cancel/close
            """
        )
        assert result.returncode == 66, result.stdout + result.stderr
        assert "leaked worker" in result.stderr
        assert "unclosed pump channel" in result.stderr

    def test_cancel_releases_the_worker(self):
        result = _run_script(
            """
            import itertools
            from flink_ml_tpu_torch.analysis import sanitizer
            sanitizer.enable()
            from flink_ml_tpu_torch import flow

            ch = flow.BoundedChannel(2, name="t.cancelled")
            flow.pump(itertools.count(), ch)
            ch.get(timeout=60)
            ch.cancel()  # the consumer-side handshake
            """
        )
        assert result.returncode == 0, result.stdout + result.stderr
        assert "FLINK_ML_TPU_SANITIZE: clean" in result.stderr

    def test_the_variable_enables_it_at_import(self):
        """FLINK_ML_TPU_SANITIZE=1 alone instruments a driver process that
        imports the package; enable() wraps both bindings of capture_lock
        with one tracked RLock, which lifecycle's import then sees."""
        result = _run_script(
            """
            import flink_ml_tpu_torch
            from flink_ml_tpu_torch import pipeline
            from flink_ml_tpu_torch.analysis import sanitizer
            from flink_ml_tpu_torch.utils import lazyjit

            assert sanitizer._enabled
            assert pipeline.capture_lock is lazyjit.capture_lock
            assert isinstance(lazyjit.capture_lock, sanitizer.TrackedRLock)
            from flink_ml_tpu_torch.pipeline import capture_lock
            with capture_lock:
                with capture_lock:  # reentrant: no edge
                    pass
            assert "utils.lazyjit.capture_lock" in sanitizer.recorder.locks
            assert sanitizer.recorder.edges == {}
            """
        )
        assert result.returncode == 0, result.stdout + result.stderr
        assert "FLINK_ML_TPU_SANITIZE: clean" in result.stderr

    def test_prefetcher_driven_to_completion_is_clean(self):
        result = _run_script(
            """
            import itertools
            from flink_ml_tpu_torch import config
            from flink_ml_tpu_torch.analysis import sanitizer
            from flink_ml_tpu_torch.parallel.prefetch import Prefetcher

            with config.use_device("cpu"):
                out = list(Prefetcher(lambda x: x * 2, depth=2, name="t.prefetch").iterate(range(16)))
                assert out == [x * 2 for x in range(16)], out
                early = Prefetcher(lambda x: x, depth=2, name="t.early").iterate(itertools.count())
                assert next(early) == 0
                early.close()  # cancel, then the bounded join
            assert sanitizer.recorder.problems(join_timeout=5.0) == []
            stats = sanitizer.recorder.stats()
            assert stats["workers"] == 2 and stats["channelsClosed"] == 2, stats
            """
        )
        assert result.returncode == 0, result.stdout + result.stderr
        assert "FLINK_ML_TPU_SANITIZE: clean" in result.stderr

    def test_push_mode_server_driven_to_completion_is_clean(self):
        result = _run_script(
            """
            import numpy as np
            from flink_ml_tpu_torch import Table, config, flow
            from flink_ml_tpu_torch.analysis import sanitizer
            from flink_ml_tpu_torch.models.feature import normalizer, standardscaler
            from flink_ml_tpu_torch.pipeline import PipelineModel
            from flink_ml_tpu_torch.serving import MicroBatchServer

            rng = np.random.RandomState(11)
            ss = standardscaler.StandardScalerModel()
            ss.mean, ss.std = rng.randn(4), np.abs(rng.randn(4)) + 0.1
            ss.set_input_col("features").set_output_col("scaled")
            norm = normalizer.Normalizer().set_p(2.0).set_input_col("scaled").set_output_col("norm")
            pm = PipelineModel([ss, norm])
            tables = [Table({"features": rng.randn(n, 4).astype(np.float32)}) for n in (3, 5, 8, 2)]
            with config.use_device("cpu"):
                for mode in ("request", "continuous"):
                    server = MicroBatchServer(pm, batching=mode, in_flight=2, form_rows=8)
                    seqs = [server.submit(t) for t in tables]
                    server.close()
                    out = []
                    consumer = flow.spawn(lambda: out.extend(server.results()), name="t.results")
                    consumer.join(timeout=120)
                    assert not consumer.is_alive()
                    assert sorted(r.seq for r in out) == seqs
                    assert all(r.status == "ok" for r in out), [r.status for r in out]
            assert sanitizer.recorder.problems(join_timeout=5.0) == []
            stats = sanitizer.recorder.stats()
            assert stats["workers"] == 4 and stats["acquisitions"] > 0, stats
            """
        )
        assert result.returncode == 0, result.stdout + result.stderr
        assert "FLINK_ML_TPU_SANITIZE: clean" in result.stderr


def _in_threads(*jobs):
    """Run (name, fn) jobs one after the other, each in a thread of that
    name, so the edges' thread samples are the same on both recorders."""
    for name, fn in jobs:
        t = threading.Thread(target=fn, name=name)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()


def _abba(san):
    rec = san.Recorder()
    a, b = san.TrackedLock("d.A", rec), san.TrackedLock("d.B", rec)

    def nested(first, second):
        with first:
            with second:
                pass

    _in_threads(("t1", lambda: nested(a, b)), ("t2", lambda: nested(b, a)))
    return rec, []


def _timed_abba(san):
    """The deadlock interleaving: both threads hold their first lock and
    both timed second acquires expire before either lets go."""
    rec = san.Recorder()
    a, b = san.TrackedLock("d.A", rec), san.TrackedLock("d.B", rec)
    held, tried = threading.Barrier(2), threading.Barrier(2)
    got = []

    def worker(first, second):
        with first:
            held.wait(timeout=10)
            got.append(second.acquire(timeout=0.1))
            tried.wait(timeout=10)

    threads = [threading.Thread(target=worker, args=args, name=name)
               for name, args in (("t1", (a, b)), ("t2", (b, a)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert got == [False, False]
    return rec, []


def _consistent(san):
    rec = san.Recorder()
    a, b, c = (san.TrackedLock(f"d.{n}", rec) for n in "ABC")

    def ordered():
        for _ in range(3):
            with a:
                with b:
                    with c:
                        pass

    _in_threads(("t1", ordered), ("t2", ordered))
    return rec, []


def _reentrant(san):
    rec = san.Recorder()
    r = san.TrackedRLock("d.R", rec)
    other = san.TrackedLock("d.L", rec)

    def nested():
        with r:
            with r:
                with other:
                    pass

    _in_threads(("t1", nested))
    return rec, []


def _condition_waits(san):
    rec = san.Recorder()
    cv = san.TrackedCondition("d.C", rec)
    other = san.TrackedLock("d.L", rec)
    ready = []

    def waiter():
        with cv:
            cv.wait_for(lambda: ready, timeout=10)
            cv.wait(timeout=0.01)
        with other:
            pass

    def notifier():
        with other:
            with cv:
                ready.append(1)
                cv.notify_all()

    t = threading.Thread(target=waiter, name="t1")
    t.start()
    _in_threads(("t2", notifier))
    t.join(timeout=10)
    return rec, []


def _channels(san):
    rec = san.Recorder()
    pumped, scratch, closed = (_FakeChannel(n) for n in ("leaky", "scratch", "done"))
    for ch in (pumped, scratch, closed):
        rec.register_channel(ch)
    for ch in (pumped, closed):
        rec.channel_pumped(ch)
    rec.channel_closed(closed)
    return rec, [pumped, scratch, closed]  # kept alive: the same ids on both


def _leaked_worker(san):
    rec = san.Recorder()
    release = threading.Event()
    t = threading.Thread(target=release.wait, args=(30,), name="t.leaked", daemon=True)
    t.start()
    rec.register_worker(t, "spawn")
    done = threading.Thread(target=lambda: None, name="t.done")
    done.start()
    rec.register_worker(done, "pump")
    return rec, [release]


def _collectives(san):
    rec = san.Recorder()
    for shard in (0, 1, 2):
        with rec.shard_scope(shard, group="same"):
            rec.record_collective("all_reduce", "data", (128,), "float32")
            rec.record_collective("all_gather", "data", (16,), "float32")
    for shard, op in ((0, "all_reduce"), (1, "all_gather")):
        with rec.shard_scope(shard, group="op"):
            rec.record_collective(op, "data", (128,), "float32")
    with rec.shard_scope("host0", group="short"):
        rec.record_collective("all_reduce", "data", (4,), "float32")
        rec.record_collective("all_reduce", "data", (4,), "float32")
    with rec.shard_scope("host1", group="short"):
        rec.record_collective("all_reduce", "data", (4,), "float32")
    for shard, dtype in ((0, "float32"), (1, "bfloat16")):
        with rec.shard_scope(shard, group="dtype"):
            rec.record_collective("all_reduce", "data", (128,), dtype)
    rec.record_collective("all_reduce", "data", (8,), "float32")
    with rec.shard_scope(0, group="solo"):
        rec.record_collective("all_gather", "data", (8,), "float32")
    return rec, []


SCENARIOS = {
    "abba": _abba,
    "timed_abba": _timed_abba,
    "consistent_order": _consistent,
    "reentrant": _reentrant,
    "condition_waits": _condition_waits,
    "pumped_unclosed_channel": _channels,
    "leaked_worker": _leaked_worker,
    "collective_divergences": _collectives,
}


def _verdict(rec):
    stats = rec.stats()
    return {
        "cycles": rec.cycles(),
        "problems": rec.problems(join_timeout=0.05),
        "edges": {k: list(v) for k, v in rec.edges.items()},
        "stats": stats,
    }


class TestAgreesWithTheJaxRecorder:
    @pytest.mark.parametrize("scenario", sorted(SCENARIOS))
    def test_the_same_sequence_gives_the_same_verdict(self, scenario):
        jax_rec, jax_keep = SCENARIOS[scenario](jax_sanitizer)
        rec, keep = SCENARIOS[scenario](sanitizer)
        want, got = _verdict(jax_rec), _verdict(rec)
        # the port's one addition to stats(): the distinct locks acquired
        assert got["stats"].pop("locks") == len({n for e in rec.edges for n in e} | rec.locks)
        assert got["stats"]["acquisitions"] == rec.acquisitions
        assert got == want
        for event in jax_keep + keep:
            if isinstance(event, threading.Event):
                event.set()
        if scenario == "leaked_worker":
            assert rec.problems(join_timeout=5.0) == jax_rec.problems(join_timeout=5.0) == []
        assert (jax_rec.problems(join_timeout=0.05) != []) == (scenario in (
            "abba", "timed_abba", "pumped_unclosed_channel", "collective_divergences"))

    @pytest.mark.parametrize("script", ["clean", "abandoned", "cancelled"])
    def test_the_instrumented_flow_ends_as_the_jax_flow_does(self, script):
        """The same flow script on each package, under the variable: the
        same exit code and the same verdict lines."""
        body = {
            "clean": """
                ch = flow.BoundedChannel(4, name="t.clean")
                flow.pump(range(32), ch, transform=lambda x: x * 2)
                assert list(ch) == [x * 2 for x in range(32)]
                """,
            "abandoned": """
                ch = flow.BoundedChannel(2, name="t.leak")
                flow.pump(itertools.count(), ch)
                ch.get(timeout=60)
                """,
            "cancelled": """
                ch = flow.BoundedChannel(2, name="t.cancelled")
                flow.pump(itertools.count(), ch)
                ch.get(timeout=60)
                ch.cancel()
                """,
        }[script]
        outcomes = []
        for package in ("flink_ml_tpu", "flink_ml_tpu_torch"):
            result = _run_script(
                f"import itertools\n"
                f"from {package}.analysis import sanitizer\n"
                f"sanitizer.enable()\n"
                f"from {package} import flow\n" + textwrap.dedent(body))
            verdict = [line for line in result.stderr.splitlines()
                       if line.startswith(("FLINK_ML_TPU_SANITIZE", "  - "))]
            outcomes.append((result.returncode, verdict))
        assert outcomes[0] == outcomes[1], outcomes
        assert outcomes[1][0] == (66 if script == "abandoned" else 0)


class TestPrefetcherBoundedJoin:
    def test_a_worker_blocked_in_its_source_raises_after_the_bound(self, monkeypatch):
        """cancel() wakes a put-blocked worker, not one blocked in its
        source: the consumer's exit then raises after `JOIN_TIMEOUT_S`
        instead of hanging."""
        monkeypatch.setattr(prefetch, "JOIN_TIMEOUT_S", 0.2)
        release = threading.Event()

        def source():
            yield 0
            release.wait(30)  # the source blocks
            yield 1

        with config.use_device("cpu"):
            it = prefetch.Prefetcher(lambda x: x, depth=1, name="t.blocked").iterate(source())
            assert next(it) == 0
            with pytest.raises(RuntimeError, match="still runs 0.2 s after cancel"):
                it.close()
        release.set()

    def test_a_dropped_generator_keeps_the_failure_and_stages_nothing_more(self, monkeypatch):
        """A generator dropped without close() is closed by the collector,
        which swallows the raise: the Prefetcher keeps the error and counts
        it, Python reports it, and the worker, once its source wakes,
        stages nothing into what the consumer may reuse."""
        monkeypatch.setattr(prefetch, "JOIN_TIMEOUT_S", 0.2)
        reported = []
        monkeypatch.setattr(sys, "unraisablehook", reported.append)
        release, staged = threading.Event(), []

        def source():
            yield 0
            release.wait(30)
            yield 1

        before = metrics.get_counter("prefetch.abandonedWorkers")
        with config.use_device("cpu"):
            p = prefetch.Prefetcher(lambda x: staged.append(x) or x, depth=1, name="t.dropped")
            it = p.iterate(source())
            assert next(it) == 0
            del it
            gc.collect()
        assert isinstance(p.error, RuntimeError) and "still runs 0.2 s" in str(p.error)
        assert [r.exc_value for r in reported] == [p.error]
        assert metrics.get_counter("prefetch.abandonedWorkers") == before + 1
        worker = next(t for t in threading.enumerate() if t.name == "flow-pump-t.dropped")
        release.set()
        worker.join(timeout=10)
        assert not worker.is_alive() and staged == [0]

    def test_a_closed_unbounded_loop_closes_its_prefetcher(self, monkeypatch):
        """iterate_unbounded closes its batches when its own consumer closes
        it, so a Prefetcher's failed join reaches that consumer."""
        monkeypatch.setattr(prefetch, "JOIN_TIMEOUT_S", 0.2)
        release = threading.Event()

        def source():
            yield 1.0
            release.wait(30)
            yield 2.0

        with config.use_device("cpu"):
            batches = prefetch.Prefetcher(lambda x: x, depth=1, name="t.online").iterate(source())
            updates = iteration.iterate_unbounded(batches, lambda s, b: s + b, 0.0)
            assert next(updates) == (1, 1.0)
            with pytest.raises(RuntimeError, match="still runs 0.2 s after cancel"):
                updates.close()
        release.set()

    def test_an_early_exit_joins_a_put_blocked_worker(self):
        with config.use_device("cpu"):
            p = prefetch.Prefetcher(lambda x: x, depth=1, name="t.put-blocked")
            it = p.iterate(itertools.count())
            assert next(it) == 0
            it.close()  # no raise: cancel woke the worker
        assert p.channel.closed
