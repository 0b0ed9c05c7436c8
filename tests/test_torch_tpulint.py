"""The port's tpulint (flink_ml_tpu_torch/analysis/) against the JAX
package's (flink_ml_tpu/analysis/).

- the engine: the same source texts through both `source` and `engine`
  modules give the same stripped code, the same suppressions, the same
  unused-suppression findings and the same `Finding.format`;
- the six rules: a fixture in the JAX idiom linted by the JAX rule and its
  torch transliteration linted by the port's rule give the same rule id on
  the same lines, and the negative fixtures give none in either package;
- the port's own tree: `flink_ml_tpu_torch/` lints clean, every
  suppression carries a `-- reason`, and a warm summary cache gives the
  findings of a cold run (the full lint runs once, in a module fixture);
- the CLI, `python -m flink_ml_tpu_torch.analysis`: `--list-rules` shows
  exactly the six rules and `unused-suppression`, the exit codes, and
  `--format json`.
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
from flink_ml_tpu_torch.analysis import cache, engine, source

REPO = Path(__file__).resolve().parent.parent
RULES = ["host-sync-leak", "resident-program", "retrace-hazard", "serve-path-trace",
         "unledgered-residency", "upload-accounting"]


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
# the six rules: the JAX idiom and its torch transliteration, line for line
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
}

#: the lines each positive fixture is flagged on, in both packages
EXPECTED_LINES = {"upload-accounting": [6, 7, 8, 9], "host-sync-leak": [12, 13, 14, 15, 16],
                  "unledgered-residency": [4, 9, 10], "resident-program": [6, 7],
                  "retrace-hazard": [6, 7, 8], "serve-path-trace": [10, 11]}


@pytest.mark.parametrize("rule", RULES)
def test_rule_flags_the_lines_the_jax_rule_flags(tmp_path, rule):
    port = _lint(tmp_path, "port", CASES[rule]["port"], [rule])
    ref = _lint(tmp_path, "jax", CASES[rule]["jax"], [rule])
    assert _where(port, "port") == _where(ref, "jax")
    assert sorted({f.line for f in port.findings}) == EXPECTED_LINES[rule]
    assert {f.rule for f in port.findings} == {rule}


@pytest.mark.parametrize("rule", RULES)
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

def test_list_rules_shows_the_six_rules(capsys):
    assert cli.main(["--list-rules"]) == 0
    listed = [line.split(":")[0] for line in capsys.readouterr().out.splitlines()
              if line and not line.startswith(" ")]
    assert listed == RULES + ["unused-suppression"]


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
