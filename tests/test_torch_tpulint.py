"""The port's tpulint (flink_ml_tpu_torch/analysis/) against the JAX
package's (flink_ml_tpu/analysis/).

- the engine: the same source texts through both `source` and `engine`
  modules give the same stripped code, the same suppressions, the same
  unused-suppression findings and the same `Finding.format`;
- the eleven text rules: a fixture in the JAX idiom linted by the JAX
  rule and its torch transliteration linted by the port's rule give the
  same rule id on the same lines, and the negative fixtures give none in
  either package; port-only cases show where the port reads further
  (untimed-wait asks what a receiver is, channel-protocol checks nested
  workers, lock-order follows `capture_lock` across modules) and that
  `Summary.param_closes` survives the summary cache;
- the port's own tree: `flink_ml_tpu_torch/` lints clean, every
  suppression carries a `-- reason`, and a warm summary cache gives the
  findings of a cold run (the full lint runs once, in a module fixture);
- the CLI, `python -m flink_ml_tpu_torch.analysis`: `--list-rules` shows
  exactly the JAX package's twenty rules and `unused-suppression`, the
  exit codes, and `--format json`.

The two coverage gates are held in tests/test_torch_tpulint_coverage.py,
the seven SPMD rules (analysis/spmd.py) in tests/test_torch_tpulint_spmd.py.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from flink_ml_tpu.analysis import engine as jax_engine
from flink_ml_tpu.analysis import source as jax_source
from flink_ml_tpu_torch.analysis import __main__ as cli
from flink_ml_tpu_torch.analysis import cache, callgraph, engine, source

REPO = Path(__file__).resolve().parent.parent
#: the rules with line-aligned fixtures (the two coverage gates walk the
#: live class graph: tests/test_torch_tpulint_coverage.py)
TEXT_RULES = ["host-sync-leak", "resident-program", "retrace-hazard", "serve-path-trace",
              "unledgered-residency", "upload-accounting", "channel-protocol", "lock-order",
              "snapshot-commit", "unbounded-queue", "untimed-wait"]
#: the rules over the SPMD interpreter (tests/test_torch_tpulint_spmd.py)
SPMD_RULES = ["collective-accounting", "collective-divergence", "donation-after-use",
              "mesh-axis", "precision-determinism", "sharding-tags", "spec-consistency"]
RULES = sorted(TEXT_RULES + SPMD_RULES + ["checkpoint-coverage", "fusion-coverage"])


def _tree(root, package, files):
    for rel, text in files.items():
        path = root / package / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(text))
    return root


def _lint(tmp_path, pkg, files, rule_ids):
    """Run `rule_ids` of one package over a fixture tree of `files`."""
    eng, package = (jax_engine, "flink_ml_tpu") if pkg == "jax" else (engine, "flink_ml_tpu_torch")
    root = _tree(tmp_path / pkg, package, {"__init__.py": "", **files})
    project = eng.Project.load(root=str(root), scope=(package,))
    return eng.run(root=str(root), rules=[eng.get_rule(r) for r in rule_ids], project=project)


def _where(report, package):
    """(rule, path inside the package, line) of each finding."""
    return sorted((f.rule, f.path.split("/", 1)[1], f.line) for f in report.findings)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

SOURCES = [
    'x = "lax.psum"  # lax.psum\ny = 2\n',
    '"""doc\nstring"""\nz = f"{a}"  # tpulint: disable=retrace-hazard -- reason\n',
    "import numpy as np\n# tpulint: disable=rule-a -- above\n\nx = 1\n"
    "y = 2  # tpulint: disable=rule-b,rule-c -- inline\n"
    "s = '# tpulint: disable=rule-d -- inside a string'\n",
    "# tpulint: disable=host-sync-leak\n# a comment\nv = w.item()\n",
    "def f(:\n    pass\n",
]


@pytest.mark.parametrize("text", SOURCES, ids=range(len(SOURCES)))
def test_source_model_matches_jax(text):
    assert source.code_only(text) == jax_source.code_only(text)
    port = [(s.rule, s.line, s.comment_line, s.reason) for s in source._parse_suppressions(text)]
    ref = [(s.rule, s.line, s.comment_line, s.reason) for s in jax_source._parse_suppressions(text)]
    assert port == ref


def test_finding_format_matches_jax():
    args = dict(path="pkg/m.py", line=7, rule="host-sync-leak", message="a message")
    assert engine.Finding(**args).format() == jax_engine.Finding(**args).format()
    assert engine.Finding(**args).format() == "pkg/m.py:7: host-sync-leak: a message"


UNUSED = """\
    # tpulint: disable=retrace-hazard -- stale
    x = 1
    y = 2  # tpulint: disable=host-sync-leak -- stale too
    # tpulint: disable=no-such-rule -- unknown
    z = 3
"""


def test_unused_suppressions_match_jax(tmp_path):
    """No rule runs, so every suppression is unused: the same findings on
    the same lines, and for a known rule the same message."""
    port = _lint(tmp_path, "port", {"models/m.py": UNUSED}, [])
    ref = _lint(tmp_path, "jax", {"models/m.py": UNUSED}, [])
    assert _where(port, "port") == _where(ref, "jax") == [
        ("unused-suppression", "models/m.py", 1), ("unused-suppression", "models/m.py", 3),
        ("unused-suppression", "models/m.py", 4)]
    assert [f.message for f in port.findings[:2]] == [f.message for f in ref.findings[:2]]
    assert "unknown rule 'no-such-rule'" in port.findings[2].message
    assert port.exit_code == ref.exit_code == 1


# ---------------------------------------------------------------------------
# the text rules: the JAX idiom and its torch transliteration, line for line
# ---------------------------------------------------------------------------

CASES = {
    "upload-accounting": {
        "jax": {"models/up.py": """\
            import jax
            import numpy as np


            def fit(X, device):
                a = jax.device_put(np.asarray(X))
                b = jax.device_put(X, device)
                c = jax.device_put(X)
                d = jax.device_put(X, device)
                return a, b, c, d
            """},
        "port": {"models/up.py": """\
            import torch
            import numpy as np


            def fit(X, device):
                a = torch.as_tensor(np.asarray(X), device=device)
                b = X.to(device)
                c = X.cuda()
                d = a.copy_(torch.from_numpy(X))
                return a, b, c, d
            """},
        "negative_jax": {"models/up.py": """\
            import numpy as np
            from ..parallel import prefetch


            def fit(X, device):
                a = prefetch.stage_to_device(np.asarray(X))
                return a
            """},
        "negative_port": {"models/up.py": """\
            import torch
            import numpy as np
            from ..parallel import prefetch


            def fit(X, device):
                a = prefetch.stage_to_device(np.asarray(X))
                b = prefetch.to_device(X, device)
                c = X.to(torch.float32).to(X.dtype)
                d = torch.zeros(3, device=device)
                e = torch.as_tensor(X, device="cpu")
                return a, b, c, d, e


            def accounted(X, device):
                out = torch.as_tensor(X, device=device)
                prefetch.account_h2d(out.numel() * out.element_size())
                return out
            """},
    },
    "host-sync-leak": {
        "jax": {"models/sync.py": """\
            import jax.numpy as jnp
            import numpy as np


            def _pull(x):
                return np.asarray(x)


            class Est:
                def fit(self, X):
                    dev = jnp.sum(X, axis=0)
                    a = float(dev)
                    b = np.asarray(dev)
                    c = dev.item()
                    dev.block_until_ready()
                    return _pull(dev), a, b, c
            """},
        "port": {"models/sync.py": """\
            import torch
            import numpy as np


            def _pull(x):
                return x.cpu()


            class Est:
                def fit(self, X, device):
                    dev = torch.as_tensor(X).to(device).sum(0)
                    a = float(dev)
                    b = dev.numpy()
                    c = dev.item()
                    torch.cuda.synchronize()
                    return _pull(dev), a, b, c
            """},
        "negative_jax": {"models/sync.py": """\
            import jax.numpy as jnp
            import numpy as np
            from ..utils.packing import packed_device_get


            class Est:
                def fit(self, X):
                    dev = jnp.sum(X, axis=0)
                    (host,) = packed_device_get(dev)
                    return float(host[0]), np.asarray(X)
            """},
        "negative_port": {"models/sync.py": """\
            import torch
            import numpy as np
            from ..utils.packing import packed_device_get


            class Est:
                def fit(self, X, device):
                    dev = torch.zeros(3, device=device) + 1.0
                    (host,) = packed_device_get(dev)
                    if dev.shape[0] > 2 and dev is not None:
                        host = host + len(dev)
                    return float(host[0]), X.cpu().numpy(), torch.zeros(3).item()


            def unreachable(device):
                return torch.zeros(3, device=device).item()
            """},
    },
    "unledgered-residency": {
        "jax": {"models/res.py": """\
            import jax
            import jax.numpy as jnp

            _TABLE = jnp.zeros((4, 4))


            class Model:
                def __init__(self, k, d, X):
                    self._centroids = jnp.zeros((k, d))
                    self._data = jax.device_put(X)
            """},
        "port": {"models/res.py": """\
            import torch
            import numpy as np

            _TABLE = torch.zeros((4, 4), device="cuda")


            class Model:
                def __init__(self, k, d, X, device):
                    self._centroids = torch.zeros((k, d), device=device)
                    self._data = X.to(device)
            """},
        "negative_jax": {"models/res.py": """\
            import jax.numpy as jnp
            import numpy as np
            from ..parallel.prefetch import stage_to_device
            from ..obs import memledger


            class Model:
                def __init__(self, k, d, X):
                    self._host = np.zeros((k, d))
                    self._staged = stage_to_device(X, category="model")
                    self._tracked = memledger.track(jnp.zeros((k, d)), "model")
                    local = jnp.zeros((k, d))
                    self._constants = self.device_constants()
            """},
        "negative_port": {"models/res.py": """\
            import torch
            import numpy as np
            from ..parallel.prefetch import stage_to_device
            from ..obs import memledger


            class Model:
                def __init__(self, k, d, X, device):
                    self._host = torch.zeros((k, d))
                    self._staged = stage_to_device(X, category="model")
                    self._tracked = memledger.track(torch.zeros((k, d), device=device), "model")
                    local = torch.zeros((k, d), device=device)
                    self._constants = self.device_constants()
            """},
    },
    "resident-program": {
        "jax": {"ops/prog.py": """\
            import jax
            from ..utils.lazyjit import lazy_jit


            def _impl(x, n):
                print(x)
                jax.debug.print("x {x}", x=x)
                return x * n


            KERNEL = lazy_jit(_impl, static_argnames=("n",))
            """},
        "port": {"ops/prog.py": """\
            import torch
            from ..utils.lazyjit import lazy_jit


            def _impl(x, n):
                print(x)
                if x.sum() > 0:
                    return x * n
                return x


            KERNEL = lazy_jit(_impl, static_argnames=("n",))
            """},
        "negative_jax": {"ops/prog.py": """\
            import jax.numpy as jnp
            from ..utils.lazyjit import lazy_jit


            def _impl(x, n):
                if n > 1:
                    return jnp.where(x > 0, x * n, x)
                return x


            KERNEL = lazy_jit(_impl, static_argnames=("n",))


            def host_side(x):
                print(x)
            """},
        "negative_port": {"ops/prog.py": """\
            import torch
            from ..utils.lazyjit import lazy_jit


            def _impl(x, n):
                if n > 1:
                    return torch.where(x > 0, x * n, x)
                return x


            KERNEL = lazy_jit(_impl, static_argnames=("n",))


            def host_side(x):
                print(x.sum())
            """},
    },
    "retrace-hazard": {
        "jax": {"ops/jit.py": """\
            import jax
            from ..utils.lazyjit import lazy_jit


            def make(scale, step):
                f = jax.jit(step)
                g = lazy_jit(lambda x: x * scale)
                h = lazy_jit(step, static_argnames=f"a{scale}")
                return f, g, h
            """},
        "port": {"ops/jit.py": """\
            import torch
            from ..utils.lazyjit import lazy_jit


            def make(scale, step):
                f = torch.cuda.CUDAGraph()
                g = lazy_jit(lambda x: x * scale)
                h = lazy_jit(step, static_argnames=f"a{scale}")
                return f, g, h
            """},
        "negative_jax": {"ops/jit.py": """\
            from ..utils.lazyjit import lazy_jit


            def _step(x, scale):
                return x * scale


            STEP = lazy_jit(_step, static_argnames=("scale",))


            def run(x):
                return STEP(x, scale=2.0)
            """},
        "negative_port": {"ops/jit.py": """\
            from ..utils.lazyjit import lazy_jit


            def _step(x, scale):
                return x * scale


            STEP = lazy_jit(_step, static_argnames=("scale",))


            def run(x):
                return STEP(x, scale=2.0)
            """},
    },
    "serve-path-trace": {
        "jax": {"serving.py": """\
            import jax
            from .utils.lazyjit import lazy_jit


            class MicroBatchServer:
                def _dispatch(self, x):
                    return self._run(x)

                def _run(self, x):
                    fn = jax.jit(_body)
                    k = lazy_jit(_body)
                    return fn(x), k(x)


            def _body(v):
                return v
            """},
        "port": {"serving.py": """\
            import torch
            from .utils.lazyjit import lazy_jit


            class MicroBatchServer:
                def _dispatch(self, x):
                    return self._run(x)

                def _run(self, x):
                    fn = torch.cuda.CUDAGraph()
                    k = lazy_jit(_body)
                    return fn, k(x)


            def _body(v):
                return v
            """},
        "negative_jax": {"serving.py": """\
            import jax
            from .utils.lazyjit import lazy_jit


            def _body(v):
                return v


            _KERNEL = lazy_jit(_body)


            class MicroBatchServer:
                def _dispatch(self, x):
                    return _KERNEL(x)


            def offline_training(x):
                return jax.jit(_body)(x)
            """},
        "negative_port": {"serving.py": """\
            import torch
            from .utils.lazyjit import lazy_jit


            def _body(v):
                return v


            _KERNEL = lazy_jit(_body)


            class MicroBatchServer:
                def _dispatch(self, x):
                    return _KERNEL(x)


            def offline_training(x):
                return torch.cuda.CUDAGraph()
            """},
    },
    "unbounded-queue": {
        "jax": {"models/q.py": """\
            import queue
            import threading
            from collections import deque


            def run(items):
                pending = deque()
                inbox = queue.Queue()
                t = threading.Thread(target=print)
                bounded = deque(maxlen=4)
                return pending, inbox, t, bounded
            """},
        "port": {"models/q.py": """\
            import queue
            import threading
            from collections import deque


            def run(items):
                pending = deque([items])
                inbox = queue.SimpleQueue()
                t = threading.Thread(target=print, daemon=True)
                bounded = deque(maxlen=4)
                return pending, inbox, t, bounded
            """},
        "negative_jax": {
            "models/q.py": """\
                import queue
                from collections import deque


                def run(n):
                    return deque(maxlen=n), queue.Queue(maxsize=4), queue.Queue(n)
                """,
            "flow.py": """\
                import threading
                from collections import deque

                _items = deque()
                worker = threading.Thread(target=print)
                """,
            "parallel/prefetch.py": "import threading\nworker = threading.Thread(target=print)\n"},
        "negative_port": {
            "models/q.py": """\
                import queue
                from collections import deque

                import torch


                def run(n):
                    return deque(maxlen=n), queue.Queue(maxsize=4), torch.zeros(n)
                """,
            "flow.py": """\
                import threading
                from collections import deque

                _items = deque()
                worker = threading.Thread(target=print)
                """,
            "parallel/prefetch.py": "import threading\nworker = threading.Thread(target=print)\n"},
    },
    "untimed-wait": {
        "jax": {"models/w.py": """\
            import multiprocessing
            import queue
            import threading
            import jax


            def run(worker):
                done = threading.Event()
                q = queue.Queue(4)
                done.wait()
                worker.join()
                item = q.get()
                done.wait(timeout=None)
                q.join()
                Pump(target=print).join()
                multiprocessing.Process(target=print).join()
                return jax.numpy.asarray(item)


            class Pump(threading.Thread):
                pass
            """},
        "port": {"models/w.py": """\
            import multiprocessing
            import queue
            import threading
            import torch


            def run(worker):
                done = threading.Event()
                q = queue.Queue(4)
                done.wait()
                worker.join()
                item = q.get()
                done.wait(timeout=None)
                q.join()
                Pump(target=print).join()
                multiprocessing.Process(target=print).join()
                return torch.as_tensor(item)


            class Pump(threading.Thread):
                pass
            """},
        "negative_jax": {
            "models/w.py": """\
                import threading


                def run(worker, q, parts):
                    done = threading.Event()
                    done.wait(1.0)
                    worker.join(timeout=5)
                    return ", ".join(parts), q.get(timeout=2), {}.get("k")
                """,
            "flow.py": """\
                import threading


                class BoundedChannel:
                    def __init__(self):
                        self._cv = threading.Condition()

                    def get(self):
                        with self._cv:
                            self._cv.wait()
                """},
        # port-only negatives: a stream-ordered Staged.wait(), a CUDA
        # event's wait and synchronize (host-sync-leak's), a class whose
        # wait() is a synchronize (serving._Readback), a class whose join()
        # is a timed join, and flow.py
        "negative_port": {
            "parallel/__init__.py": "",
            "parallel/prefetch.py": """\
                import torch


                class Staged:
                    def __init__(self, value, event, buffer):
                        self.value, self.event, self.buffer = value, event, buffer

                    def wait(self):
                        stream = torch.cuda.current_stream(self.buffer.device)
                        stream.wait_event(self.event)
                        return self.value


                class DeviceStager:
                    def __call__(self, tree) -> Staged:
                        return Staged(tree, None, tree)


                def stage_to_device(tree, device) -> Staged:
                    return DeviceStager()(tree)
                """,
            "models/w.py": """\
                import torch

                from ..parallel.prefetch import DeviceStager, Staged, stage_to_device


                class _Readback:
                    def __init__(self):
                        self.event = torch.cuda.Event()

                    def wait(self):
                        self.event.synchronize()
                        return {}


                class Server:
                    def __init__(self):
                        self._stager = DeviceStager()

                    def stage(self, tree, device, entry, readback: _Readback):
                        first = stage_to_device(tree, device).wait()
                        staged = self._stager(tree)
                        ev = torch.cuda.Event()
                        ev.wait()
                        ev.synchronize()
                        out = entry.wait() if isinstance(entry, Staged) else entry
                        return first, staged.wait(), out, readback.wait()


                class Worker:
                    def __init__(self, thread):
                        self._thread = thread

                    def join(self):
                        self._thread.join(timeout=5)


                def finish(thread):
                    Worker(thread).join()
                """,
            "flow.py": """\
                import threading


                class BoundedChannel:
                    def __init__(self):
                        self._cv = threading.Condition()

                    def get(self):
                        with self._cv:
                            self._cv.wait()
                """},
    },
    "channel-protocol": {
        "jax": {"serving.py": """\
            import jax.numpy as jnp
            from . import flow


            class Server:
                def start(self):
                    self._out = flow.BoundedChannel(4)
                    self._worker = flow.spawn(self._run, name="w")

                def _run(self):
                    for item in range(3):
                        self._out.put(jnp.zeros(item))
                    self._out.close()


            def leak():
                ch = flow.BoundedChannel(2)
                ch.put(1)
                return None


            def push(server, batch):
                return server.submit(batch)
            """},
        "port": {"serving.py": """\
            import torch
            from . import flow


            class Server:
                def start(self):
                    self._out = flow.BoundedChannel(4)
                    self._worker = flow.spawn(self._run, name="w")

                def _run(self):
                    for item in range(3):
                        self._out.put(torch.zeros(item))
                    self._out.close()


            def leak():
                ch = flow.BoundedChannel(2)
                ch.put(1)
                return None


            def push(server, batch):
                return server.submit(batch)
            """},
        "negative_jax": {"serving.py": """\
            import jax.numpy as jnp
            from . import flow


            class Server:
                def start(self):
                    self._out = flow.BoundedChannel(4)
                    self._worker = flow.spawn(self._run, name="w")

                def _run(self):
                    try:
                        for item in range(3):
                            self._out.put(jnp.zeros(item))
                        self._out.close()
                    except BaseException as e:
                        self._out.close(error=e)


            def _finish(ch):
                ch.close()


            def drained(items):
                pumped = flow.BoundedChannel(2)
                flow.pump(items, pumped)
                closed = flow.BoundedChannel(2)
                _finish(closed)
                return list(pumped)


            def push(server, batch):
                server.submit(batch)
                return list(server.results())
            """},
        "negative_port": {"serving.py": """\
            import torch
            from . import flow


            class Server:
                def start(self):
                    self._out = flow.BoundedChannel(4)
                    self._worker = flow.spawn(self._run, name="w")

                def _run(self):
                    try:
                        for item in range(3):
                            self._out.put(torch.zeros(item))
                        self._out.close()
                    except BaseException as e:
                        self._out.close(error=e)


            def _finish(ch):
                ch.close()


            def drained(items):
                pumped = flow.BoundedChannel(2)
                flow.pump(items, pumped)
                closed = flow.BoundedChannel(2)
                _finish(closed)
                return list(pumped)


            def push(server, batch):
                server.submit(batch)
                return list(server.results())
            """},
    },
    "lock-order": {
        "jax": {"parallel/locks.py": """\
            import threading
            import jax

            _a = threading.Lock()
            _b = threading.Lock()
            _r = threading.RLock()


            def _take_b():
                with _b:
                    pass


            def one():
                with _a:
                    _take_b()


            def two():
                with _b:
                    with _a:
                        pass


            def again():
                with _a:
                    with _a:
                        pass


            def reentrant(g):
                with _r:
                    with jax.named_scope(g):
                        with _r:
                            pass
            """},
        "port": {"parallel/locks.py": """\
            import threading
            import torch

            _a = threading.Lock()
            _b = threading.Lock()
            _r = threading.RLock()


            def _take_b():
                with _b:
                    pass


            def one():
                with _a:
                    _take_b()


            def two():
                with _b:
                    with _a:
                        pass


            def again():
                with _a:
                    with _a:
                        pass


            def reentrant(g):
                with _r:
                    with torch.cuda.graph(g):
                        with _r:
                            pass
            """},
        "negative_jax": {"parallel/locks.py": """\
            import threading

            _a = threading.Lock()
            _b = threading.Lock()


            def _take_b():
                with _b:
                    pass


            def one():
                with _a:
                    _take_b()


            def two():
                with _a:
                    with _b:
                        pass
            """},
        "negative_port": {"parallel/locks.py": """\
            import threading

            import torch

            _a = threading.Lock()
            _b = threading.Lock()


            def _take_b(s):
                with _b:
                    with torch.cuda.stream(s):
                        pass


            def one(s):
                with _a:
                    _take_b(s)


            def two(g):
                with torch.cuda.graph(g):
                    with _a:
                        with _b:
                            pass
            """},
    },
    "snapshot-commit": {
        "jax": {"ckpt/store.py": """\
            import json
            import os

            import numpy as np


            def save(path, arrays, meta):
                np.savez(path + ".tmp", **arrays)
                os.replace(path + ".tmp", path)
                with open(path + ".json", "w") as f:
                    json.dump(meta, f)
            """},
        "port": {"ckpt/store.py": """\
            import json
            import os

            import torch


            def save(path, arrays, meta):
                torch.save(arrays, path + ".tmp")
                os.rename(path + ".tmp", path)
                with open(path + ".json", mode="w") as f:
                    json.dump(meta, f)
            """},
        "negative_jax": {
            "ckpt/store.py": """\
                import json

                import numpy as np

                from .coordinator import atomic_commit


                def _dump(tmp, meta):
                    with open(tmp, "w") as f:
                        json.dump(meta, f)


                def save(path, arrays, meta):
                    atomic_commit(path, lambda tmp: np.savez(tmp, **arrays))
                    atomic_commit(path + ".json", lambda tmp: _dump(tmp, meta))
                    with open(path, "rb") as f:
                        return f.read()
                """,
            "models/out.py": "import numpy as np\n\n\ndef save(p, a):\n    np.save(p, a)\n"},
        "negative_port": {
            "ckpt/store.py": """\
                import json

                import torch

                from .coordinator import atomic_commit


                def _dump(tmp, meta):
                    with open(tmp, "w") as f:
                        json.dump(meta, f)


                def save(path, arrays, meta):
                    atomic_commit(path, lambda tmp: torch.save(arrays, tmp))
                    atomic_commit(path + ".json", lambda tmp: _dump(tmp, meta))
                    with open(path, "rb") as f:
                        return f.read()
                """,
            "models/out.py": "import torch\n\n\ndef save(p, a):\n    torch.save(a, p)\n"},
    },
}

#: the lines each positive fixture is flagged on, in both packages
EXPECTED_LINES = {"upload-accounting": [6, 7, 8, 9], "host-sync-leak": [12, 13, 14, 15, 16],
                  "unledgered-residency": [4, 9, 10], "resident-program": [6, 7],
                  "retrace-hazard": [6, 7, 8], "serve-path-trace": [10, 11],
                  "unbounded-queue": [7, 8, 9], "untimed-wait": [10, 11, 12, 13, 14, 15, 16],
                  "channel-protocol": [8, 17, 23], "lock-order": [16, 27],
                  "snapshot-commit": [8, 9, 10, 11]}


@pytest.mark.parametrize("rule", TEXT_RULES)
def test_rule_flags_the_lines_the_jax_rule_flags(tmp_path, rule):
    port = _lint(tmp_path, "port", CASES[rule]["port"], [rule])
    ref = _lint(tmp_path, "jax", CASES[rule]["jax"], [rule])
    assert _where(port, "port") == _where(ref, "jax")
    assert sorted({f.line for f in port.findings}) == EXPECTED_LINES[rule]
    assert {f.rule for f in port.findings} == {rule}


@pytest.mark.parametrize("rule", TEXT_RULES)
def test_negative_fixtures_are_clean_in_both(tmp_path, rule):
    port = _lint(tmp_path, "port", CASES[rule]["negative_port"], [rule])
    ref = _lint(tmp_path, "jax", CASES[rule]["negative_jax"], [rule])
    assert port.findings == [] and ref.findings == []


def test_a_suppression_hides_a_finding_and_callers_inherit_none(tmp_path):
    """A host-sync-leak suppression on a helper's sink documents the sync:
    the census finding stays (suppressed) and callers are not flagged, as in
    the JAX package."""
    files = {"models/sync.py": """\
        import torch


        def _pull(x):
            return x.cpu()  # tpulint: disable=host-sync-leak -- the helper's documented readback


        class Est:
            def fit(self, X, device):
                return _pull(torch.zeros(3, device=device))
        """}
    report = _lint(tmp_path, "port", files, ["host-sync-leak"])
    assert report.findings == []
    assert [(f.line, f.data[0]) for f in report.suppressed] == [(5, "pull-param")]


def test_port_only_syncs_branch_and_unknown_device(tmp_path):
    """A device tensor as an if test is a sync; a value whose device cannot
    be told raises nothing; a function no entry reaches is not linted."""
    files = {"models/sync.py": """\
        import torch


        class Est:
            def fit(self, X, device, table):
                dev = torch.ones(3, device=device)
                if dev.sum() > 0:
                    pass
                unknown = table.column("x")
                return unknown.item(), X.to(device).tolist()


        def orphan(device):
            return torch.ones(3, device=device).item()
        """}
    report = _lint(tmp_path, "port", files, ["host-sync-leak"])
    assert [(f.line, f.data[0]) for f in report.findings] == [(7, "branch"), (10, "pull")]


def test_resident_program_follows_capture_and_transform_kernels(tmp_path):
    files = {"pipeline.py": """\
        import torch
        from .utils import lazyjit


        class Stage:
            def transform_kernel(self, consts, cols, ctx):
                x = cols["x"] * consts["w"]
                ctx.guard(x.isnan().any(), "NaN")
                return {"y": x, "n": int(x.sum())}


        def run(pool, device):
            def body():
                y = torch.ones(3, device=device)
                return y.tolist()
            return lazyjit.capture(pool, body)
        """}
    report = _lint(tmp_path, "port", files, ["resident-program"])
    assert [(f.line, f.data[0]) for f in report.findings] == [(9, "cast"), (15, "pull")]


def test_untimed_wait_reads_the_receiver_not_the_name(tmp_path):
    """The JAX rule flags every bare `.wait()` and `.join()` of the
    port-only negative fixture; the port's rule, which asks what each
    receiver is, flags none of them, but still flags a thread wait of
    unknown type."""
    files = dict(CASES["untimed-wait"]["negative_port"])
    ref = _lint(tmp_path, "jax", files, ["untimed-wait"])
    assert [f.line for f in ref.findings if f.path.endswith("models/w.py")] == [
        20, 23, 25, 26, 26, 38]
    files["models/unknown.py"] = "def run(done, staged):\n    return done.wait(), staged.wait(1)\n"
    port = _lint(tmp_path, "port", files, ["untimed-wait"])
    assert _where(port, "port") == [("untimed-wait", "models/unknown.py", 2)]


NESTED = {"parallel/supervisor.py": """\
    from .. import flow


    def supervise(fit):
        result = flow.BoundedChannel(1)

        def run():
            try:
                result.put(fit())
            except BaseException as e:
                result.close(error=e)

        worker = flow.spawn(run, name="fit")
        return worker, result.get(timeout=5)


    class Store:
        def prefetch(self, keys):
            def _warm():
                for k in keys:
                    self.page_in(k)

            return flow.spawn(_warm, name="prefetch")

        def page_in(self, k):
            return k
    """}


def test_channel_protocol_checks_nested_workers(tmp_path):
    """A worker defined inside the spawning function is checked in the
    port (the JAX rule cannot resolve it): one that closes its channel on
    the error path is clean, one that closes nothing is flagged."""
    port = _lint(tmp_path, "port", NESTED, ["channel-protocol"])
    ref = _lint(tmp_path, "jax", NESTED, ["channel-protocol"])
    assert ref.findings == []
    assert [(f.line, f.data) for f in port.findings] == [
        (23, ("worker", "prefetch.<locals>._warm"))]


CROSS_MODULE = {
    "utils/__init__.py": "",
    "utils/lazyjit.py": """\
        import threading

        capture_lock = threading.RLock()


        class GraphCache:
            def __init__(self):
                self.lock = threading.RLock()


        def capture(body):
            with capture_lock:
                return body()
        """,
    "pipeline.py": """\
        from .utils import lazyjit

        capture_lock = lazyjit.capture_lock


        class _GraphCache(lazyjit.GraphCache):
            pass


        class Segment:
            def __init__(self):
                self.graphs = _GraphCache()

            def run(self, body):
                with self.graphs.lock:
                    return lazyjit.capture(body)
        """,
    "lifecycle.py": """\
        from .pipeline import Segment


        class Lifecycle:
            def __init__(self):
                self.segment = Segment()

            def promote(self, body):
                from .pipeline import capture_lock

                with capture_lock:
                    with self.segment.graphs.lock:
                        return body()
        """,
}


def test_lock_order_follows_capture_lock_across_modules(tmp_path):
    """capture_lock bound by name in another module and imported inside a
    method, a subclass's inherited lock and a typed receiver's lock are
    one node each: the port finds the ABBA cycle the JAX rule cannot see."""
    port = _lint(tmp_path, "port", CROSS_MODULE, ["lock-order"])
    ref = _lint(tmp_path, "jax", CROSS_MODULE, ["lock-order"])
    assert ref.findings == []
    assert [(f.path.split("/", 1)[1], f.line, f.data[0]) for f in port.findings] == [
        ("lifecycle.py", 12, "cycle")]
    assert set(port.findings[0].data[1:]) == {"flink_ml_tpu_torch.utils.lazyjit.capture_lock",
                                              "flink_ml_tpu_torch.utils.lazyjit.GraphCache.lock"}


def test_the_lock_graph_takes_the_ports_own_locks():
    """Every Lock/RLock/Condition the port makes is a node, the port's own
    ones with no JAX twin among them, each of its kind; `capture_lock` is
    reached through its pipeline binding and lifecycle's import; and the
    port's graph has no cycle."""
    from flink_ml_tpu_torch.analysis.rules import lockorder

    project = engine.Project.load()
    analysis = lockorder._ProjectLockAnalysis(project, (engine.PACKAGE,))
    nodes = {n.node_id: n.kind for locks in analysis.module_locks.values()
             for n in list(locks.module_locks.values())
             + [m for cls in locks.class_locks.values() for m in cls.values()]}
    pkg = "flink_ml_tpu_torch."
    assert {k[len(pkg):]: v for k, v in nodes.items() if k.startswith(pkg) and (
        "lazyjit" in k or "serving" in k or "cuda_build" in k or k.endswith("native._lock")
        or "compilebank" in k)} == {
        "utils.lazyjit.capture_lock": "RLock", "utils.lazyjit.GraphCache.lock": "RLock",
        "serving.MicroBatchServer._stage_lock": "Lock",
        "serving.MicroBatchServer._start_lock": "Lock", "ops.cuda_build._lock": "Lock",
        "native._lock": "Lock", "compilebank.ProgramBank._lock": "RLock",
        "compilebank._active_lock": "RLock"}
    pipeline_lock = analysis._module_lock(project.module_named(pkg + "pipeline"), "capture_lock")
    assert pipeline_lock.node_id == pkg + "utils.lazyjit.capture_lock"
    held = {(a.node_id, b.node_id) for a, targets in analysis.edges.items() for b in targets}
    assert (pkg + "utils.lazyjit.GraphCache.lock", pkg + "utils.lazyjit.capture_lock") in held
    assert any(a == pkg + "utils.lazyjit.capture_lock" for a, _ in held)  # lifecycle's promote
    assert analysis.cycles() == []


def test_param_closes_survives_the_summary_cache(tmp_path):
    """A channel closed through a helper of another module satisfies
    channel-protocol through `Summary.param_closes`; a warm lint served
    from the cache gives the cold findings."""
    files = {"parallel/__init__.py": "",
             "parallel/helpers.py": "def finish(ch):\n    ch.cancel()\n",
             "models/m.py": """\
                 from .. import flow
                 from ..parallel import helpers


                 def run():
                     closed = flow.BoundedChannel(2)
                     helpers.finish(closed)
                     leaked = flow.BoundedChannel(2)
                     return None
                 """}
    root = _tree(tmp_path, "flink_ml_tpu_torch", {"__init__.py": "", "models/__init__.py": "",
                                                  **files})
    path = str(tmp_path / cache.DEFAULT_NAME)
    rule = [engine.get_rule("channel-protocol")]
    cold = engine.run(root=str(root), rules=rule, summary_cache=cache.SummaryCache(path))
    warm_cache = cache.SummaryCache.load(path)
    warm = engine.run(root=str(root), rules=rule, summary_cache=warm_cache)
    assert [(f.line, f.data) for f in cold.findings] == [(8, ("undrained-channel", "leaked"))]
    assert [f.format() for f in warm.findings] == [f.format() for f in cold.findings]
    assert warm_cache.hits > 0
    project = engine.Project.load(root=str(root))
    graph = callgraph.get(project)
    finish = graph.decls_in("flink_ml_tpu_torch/parallel/helpers.py")["finish"]
    assert graph.summary(finish).param_closes == frozenset({0})
    assert cache._summary_from_json(cache._summary_to_json(graph.summary(finish))).param_closes \
        == frozenset({0})


# ---------------------------------------------------------------------------
# the port's own tree, linted once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_lint(tmp_path_factory):
    """A cold full lint that writes a summary cache, and a warm one that
    reads it."""
    path = str(tmp_path_factory.mktemp("tpulint") / cache.DEFAULT_NAME)
    cold = engine.run(summary_cache=cache.SummaryCache(path))
    warm_cache = cache.SummaryCache.load(path)
    warm = engine.run(summary_cache=warm_cache)
    return cold, warm, warm_cache


def test_the_port_lints_clean(port_lint):
    cold, _, _ = port_lint
    assert cold.findings == [], "\n".join(f.format() for f in cold.findings)
    assert {f.rule for f in cold.suppressed} <= set(RULES)


def test_every_port_suppression_carries_a_reason():
    project = engine.Project.load()
    suppressions = [(m.path, s) for m in project.modules for s in m.suppressions]
    assert suppressions
    for path, s in suppressions:
        assert s.reason, f"{path}:{s.comment_line}: {s.rule} has no '-- reason'"
        assert s.rule in RULES, f"{path}:{s.comment_line}: {s.rule}"


def test_a_warm_cache_gives_the_cold_findings(port_lint):
    cold, warm, warm_cache = port_lint
    key = lambda f: (f.path, f.line, f.rule, f.message)  # noqa: E731
    assert sorted(map(key, warm.findings)) == sorted(map(key, cold.findings))
    assert sorted(map(key, warm.suppressed)) == sorted(map(key, cold.suppressed))
    assert warm_cache.hits > 0 and not warm_cache.dirty


def test_the_cache_file_is_the_ports_own():
    assert cache.cache_path("/r") == "/r/.tpulint_torch_cache.json"
    assert ".tpulint_torch_cache.json" in (REPO / ".gitignore").read_text().split()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_list_rules_shows_the_thirteen_rules(capsys):
    """All twenty rules now (the name is the thirteen-rule test's): exactly
    the JAX package's rule ids, and `unused-suppression`."""
    assert cli.main(["--list-rules"]) == 0
    listed = [line.split(":")[0] for line in capsys.readouterr().out.splitlines()
              if line and not line.startswith(" ")]
    assert listed == RULES + ["unused-suppression"]
    assert len(RULES) == 20 and RULES == sorted(r.id for r in jax_engine.all_rules())


def test_cli_exit_codes_and_json(tmp_path, capsys):
    dirty = _tree(tmp_path / "dirty", "flink_ml_tpu_torch",
                  {"__init__.py": "", **CASES["retrace-hazard"]["port"]})
    clean = _tree(tmp_path / "clean", "flink_ml_tpu_torch",
                  {"__init__.py": "", **CASES["retrace-hazard"]["negative_port"]})
    assert cli.main(["--root", str(clean), "--no-cache"]) == 0
    assert "tpulint: clean" in capsys.readouterr().out
    assert cli.main(["--root", str(dirty), "--no-cache", "--format", "json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["clean"] is False
    assert [(f["file"], f["line"], f["rule"]) for f in payload["findings"]] == [
        ("flink_ml_tpu_torch/ops/jit.py", line, "retrace-hazard") for line in (6, 7, 8)]
    assert cli.main(["--root", str(dirty), "--rule", "upload-accounting"]) == 0
    capsys.readouterr()
    assert cli.main(["--root", str(dirty), "--format", "sarif"]) == 1
    sarif = json.loads(capsys.readouterr().out)
    assert {r["ruleId"] for r in sarif["runs"][0]["results"]} == {"retrace-hazard"}
    with pytest.raises(SystemExit):
        cli.main(["--rule", "no-such-rule"])


def test_cli_runs_as_a_module(tmp_path):
    clean = _tree(tmp_path / "clean", "flink_ml_tpu_torch",
                  {"__init__.py": "", **CASES["upload-accounting"]["negative_port"]})
    proc = subprocess.run([sys.executable, "-m", "flink_ml_tpu_torch.analysis", "--root",
                           str(clean), "--show-suppressed"], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "tpulint: clean" in proc.stdout
