"""The repo's operator tools on the port, each held against its JAX script.

scripts/torch_obs_report.py, torch_obs_timeline.py,
torch_smoke_fit_timeline.py, torch_coldstart_smoke.py,
torch_make_reference_fixture.py and torch_gen_operator_docs.py are the
port's counterparts of the JAX scripts of the same names without `torch_`.
Each tool that may touch a device runs in a child process as its
`__main__` under `config.use_device("cpu")` (the tools take no device
flag; without a card and without that request they raise), the JAX script
in a child under `JAX_PLATFORMS=cpu`:

- the trace report: the same stdout as text, as `--format json`, with
  `--json` and `--max-epochs`, the same "dropped ... truncated" warning on
  tests/fixtures/traces/truncated.jsonl, exit 2 on `--format xml`, the
  same `render_hbm_dump` text and `--hbm-dump` output, alone and beside a
  trace; `--device-profile` reads a torch.profiler chrome trace;
- the timeline: the same Chrome JSON (but for the process's name) and
  the same attribution on an events file and on a span trace;
- the fit-timeline smoke: exit 0, 56 epochs, 7 chunked cycles and one
  whole-fit cycle, as the JAX script reports, and the typed budget
  rejection;
- the cold-start smoke: populate -> serve -> baseline, serve exits 0 with
  no capture and bank hits, its output's sha256 is the baseline's, the
  `norm` column is within rtol 1e-6 of the JAX workload's, and a bank
  whose manifest has a flipped byte makes serve exit 1;
- the fixture writer writes the committed tests/fixtures/reference_*
  byte for byte, and its table is the JAX script's;
- the operator-doc writer finds the same (area, class, kind, Param rows)
  as the JAX script's helpers, and docs/torch_operators.md is what it
  writes;
- each tool runs to its end in a child where `jax` and `flink_ml_tpu`
  cannot be imported (as on the card's machine). No test writes into the
  repo.
"""

import importlib.util
import json
import os
import pathlib
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from flink_ml_tpu_torch import config

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"
TRUNCATED = REPO / "tests" / "fixtures" / "traces" / "truncated.jsonl"
#: a tool run as `__main__` under use_device("cpu")
CPU_RUNNER = ("import runpy, sys\n"
              "from flink_ml_tpu_torch import config\n"
              "sys.argv = sys.argv[1:]\n"
              "with config.use_device('cpu'):\n"
              "    runpy.run_path(sys.argv[0], run_name='__main__')\n")


def _env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("FLINK_ML_TPU_")}
    env["JAX_PLATFORMS"] = "cpu"
    return env


def port_tool(script, *args, cwd=REPO):
    """(exit status, stdout, stderr) of scripts/<script> on the port."""
    proc = subprocess.run([sys.executable, "-c", CPU_RUNNER, str(SCRIPTS / script),
                           *map(str, args)], cwd=cwd, env=_env(), capture_output=True, text=True,
                          timeout=300)
    return proc.returncode, proc.stdout, proc.stderr


def jax_tool(script, *args, cwd=REPO):
    proc = subprocess.run([sys.executable, str(SCRIPTS / script), *map(str, args)], cwd=cwd,
                          env=_env(), capture_output=True, text=True, timeout=300)
    return proc.returncode, proc.stdout, proc.stderr


def _both(script, *args):
    """The port's and the JAX script's runs of the same arguments, side by side."""
    return {"port": lambda: port_tool(f"torch_{script}", *args),
            "jax": lambda: jax_tool(script, *args)}


def run_all(jobs):
    """{key: result} of every job, four processes at a time."""
    with ThreadPoolExecutor(max_workers=4) as pool:
        futures = {key: pool.submit(job) for key, job in jobs.items()}
        return {key: f.result() for key, f in futures.items()}


def load_script(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}", SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---------------------------------------------------------------------------
# the trace report
# ---------------------------------------------------------------------------

def _hbm_dump():
    """A ledger snapshot of the port's memledger over tracked tensors."""
    from flink_ml_tpu_torch.obs import memledger

    memledger.reset()
    keep = [torch.zeros(1000), torch.zeros((64, 32)), torch.zeros(300, dtype=torch.int32)]
    memledger.track(keep[0], "model")
    memledger.track(keep[1], "streamSegments")
    memledger.track(keep[2], "optimizer")
    snap = memledger.snapshot()
    memledger.reset()
    return snap


@pytest.fixture(scope="module")
def report_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("report")
    dump = tmp / "hbm.json"
    dump.write_text(json.dumps(_hbm_dump()))
    profile = tmp / "profile"
    profile.mkdir()
    (profile / "trace.json").write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 10.0, "dur": 30.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 70.0, "dur": 10.0}]}))
    cases = {
        "text": (TRUNCATED,), "json": (TRUNCATED, "--format", "json"),
        "json alias": (TRUNCATED, "--json"), "max epochs": (TRUNCATED, "--max-epochs", "0"),
        "xml": (TRUNCATED, "--format", "xml"), "hbm alone": ("--hbm-dump", dump),
        "hbm beside": (TRUNCATED, "--hbm-dump", dump), "help": ("--help",),
    }
    jobs = {}
    for name, args in cases.items():
        for pkg, job in _both("obs_report.py", *args).items():
            jobs[(name, pkg)] = job
    jobs[("device profile", "port")] = lambda: port_tool(
        "torch_obs_report.py", TRUNCATED, "--device-profile", profile)
    return {"dump": dump, **run_all(jobs)}


REPORT_CASES = ["text", "json", "json alias", "max epochs", "hbm alone", "hbm beside"]


@pytest.mark.parametrize("case", REPORT_CASES)
def test_report_prints_what_the_jax_script_prints(report_runs, case):
    port, jax = report_runs[(case, "port")], report_runs[(case, "jax")]
    assert port[0] == jax[0] == 0, port[2][-2000:] + jax[2][-2000:]
    assert port[1] == jax[1]
    assert port[1].strip()


@pytest.mark.parametrize("case", ["text", "json"])
def test_report_warns_of_the_dropped_records_alike(report_runs, case):
    port, jax = report_runs[(case, "port")], report_runs[(case, "jax")]
    warning = [line for line in port[2].splitlines() if line.startswith("warning:")]
    assert warning == [line for line in jax[2].splitlines() if line.startswith("warning:")]
    assert len(warning) == 1 and "dropped" in warning[0] and "truncated" in warning[0]


def test_report_json_is_the_jax_payload(report_runs):
    port = json.loads(report_runs[("json", "port")][1])
    assert port == json.loads(report_runs[("json", "jax")][1])
    assert set(port) == {"stages", "epochs", "runs", "compileCost"}
    assert port == json.loads(report_runs[("json alias", "port")][1])


def test_report_refuses_an_unknown_format_with_exit_2(report_runs):
    port, jax = report_runs[("xml", "port")], report_runs[("xml", "jax")]
    assert port[0] == jax[0] == 2
    assert port[2].strip().splitlines()[-1] == jax[2].strip().splitlines()[-1]
    assert "unknown --format 'xml'" in port[2]


def test_report_help_exits_0(report_runs):
    port = report_runs[("help", "port")]
    assert port[0] == report_runs[("help", "jax")][0] == 0
    assert "torch_obs_report" in port[1] and "--hbm-dump" in port[1]


def test_render_hbm_dump_gives_the_jax_text(report_runs):
    dump = json.loads(report_runs["dump"].read_text())
    port = load_script("torch_obs_report").render_hbm_dump(dump)
    assert port == load_script("obs_report").render_hbm_dump(dump)
    assert "by category" in port and "top 3 entries" in port
    empty = {"liveBytes": 0, "entryCount": 0, "peakBytes": 0}
    assert load_script("torch_obs_report").render_hbm_dump(empty) == \
        load_script("obs_report").render_hbm_dump(empty)


def test_report_reads_a_torch_profiler_trace(report_runs):
    code, out, err = report_runs[("device profile", "port")]
    assert code == 0, err[-2000:]
    assert "== Device profile (" in out and "deviceBusyMs: 0.0" in out
    assert "deviceEvents: 2" in out and "gemm" in out


# ---------------------------------------------------------------------------
# the timeline
# ---------------------------------------------------------------------------

def _events(path, seed=11):
    """A seeded flight-recorder dump: three dispatch/device/readback
    cycles, host spans, counters, an unmatched begin and a line cut short."""
    rng = np.random.default_rng(seed)
    lines, t = [], 1000.0
    lines.append({"ph": "B", "lane": "host:MainThread", "name": "iteration.run", "tsUs": t,
                  "ref": 1})
    for epoch in range(3):
        d = float(rng.integers(50, 200))
        lines.append({"ph": "X", "lane": "dispatch", "name": "dispatch.chunk", "tsUs": t,
                      "durUs": d, "args": {"start": 4 * epoch, "end": 4 * epoch + 4}})
        dev = float(rng.integers(100, 900))
        lines.append({"ph": "X", "lane": "device", "name": "device.chunk", "tsUs": t + d,
                      "durUs": dev})
        rb = float(rng.integers(5, 40))
        lines.append({"ph": "X", "lane": "readback", "name": "readback", "tsUs": t + d + dev,
                      "durUs": rb, "args": {"bytes": 8}})
        lines.append({"ph": "C", "lane": "memory", "name": "hbm", "tsUs": t + 1.0,
                      "args": {"model": 4096 * (epoch + 1)}})
        lines.append({"ph": "i", "lane": "host:MainThread", "name": "checkpoint", "tsUs": t + 2.0})
        t += d + dev + rb + float(rng.integers(0, 50))
    lines.append({"ph": "E", "lane": "host:MainThread", "name": "iteration.run", "tsUs": t,
                  "ref": 1})
    lines.append({"ph": "B", "lane": "host:MainThread", "name": "orphan", "tsUs": t + 5,
                  "ref": 9})
    text = "\n".join(json.dumps(x) for x in lines) + '\n{"ph": "X", "lane": "dev'
    path.write_text(text)
    return path


@pytest.fixture(scope="module")
def timeline_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("timeline")
    inputs = {"events": _events(tmp / "events.jsonl"), "spans": TRUNCATED}
    jobs = {}
    for name, path in inputs.items():
        for pkg in ("port", "jax"):
            out = tmp / f"{name}.{pkg}.json"
            script = "torch_obs_timeline.py" if pkg == "port" else "obs_timeline.py"
            run = port_tool if pkg == "port" else jax_tool

            def job(run=run, script=script, path=path, out=out):
                return run(script, path, "-o", out, "--attribution", "--json"), out
            jobs[(name, pkg)] = job
    for pkg, job in _both("obs_timeline.py", inputs["events"], "-o", tmp / "text.json",
                          "--attribution").items():
        jobs[("text", pkg)] = job
    jobs[("missing", "port")] = lambda: port_tool("torch_obs_timeline.py", tmp / "nothing.jsonl")
    return run_all(jobs)


def _chrome(path):
    doc = json.loads(pathlib.Path(path).read_text())
    for e in doc["traceEvents"]:
        if e.get("name") == "process_name":
            e["args"]["name"] = "flink_ml_tpu"  # the one field that names the package
    return doc


@pytest.mark.parametrize("name", ["events", "spans"])
def test_timeline_writes_the_jax_chrome_json(timeline_runs, name):
    (port, port_out), (jax, jax_out) = timeline_runs[(name, "port")], timeline_runs[(name, "jax")]
    assert port[0] == jax[0] == 0, port[2][-2000:] + jax[2][-2000:]
    assert _chrome(port_out) == _chrome(jax_out)
    assert [x for x in port[2].splitlines() if x.startswith("warning")] == \
        [x for x in jax[2].splitlines() if x.startswith("warning")]
    assert "skipped 1 unparseable line" in port[2]


def test_timeline_attribution_is_the_jax_one(timeline_runs):
    (port, _), (jax, _) = timeline_runs[("events", "port")], timeline_runs[("events", "jax")]
    attr = json.loads(port[1][port[1].index("{"):])
    assert attr == json.loads(jax[1][jax[1].index("{"):])
    assert attr["gapCount"] == 3
    parts = sum(attr[k] for k in ("dispatchMs", "deviceMs", "readbackMs", "idleGapMs"))
    assert parts == pytest.approx(attr["windowMs"], abs=1e-9)
    assert "dropped 1 unmatched begin/end event" in port[2]


def test_timeline_span_trace_has_no_attribution_alike(timeline_runs):
    (port, _), (jax, _) = timeline_runs[("spans", "port")], timeline_runs[("spans", "jax")]
    assert port[1].splitlines()[-1] == jax[1].splitlines()[-1] == \
        "No dispatch-lane events: attribution unavailable."


def test_timeline_text_attribution_is_the_jax_text(timeline_runs):
    port, jax = timeline_runs[("text", "port")], timeline_runs[("text", "jax")]
    assert port[0] == jax[0] == 0
    assert port[1] == jax[1]
    assert "Dispatch-wall attribution" in port[1] and "over 3 chunk(s)" in port[1]


def test_timeline_exits_2_on_a_missing_file(timeline_runs):
    code, _, err = timeline_runs[("missing", "port")]
    assert code == 2 and "cannot read" in err


def test_load_any_never_crashes_on_cut_input(tmp_path):
    port, jax = load_script("torch_obs_timeline"), load_script("obs_timeline")
    path = tmp_path / "cut.jsonl"
    path.write_text('{"name": "a", "startUs": 1.0, "durUs": 2.0}\n[1, 2]\n{"x": 1}\n{"ph": "B"')
    assert port.load_any(str(path)) == jax.load_any(str(path))
    events, skipped = port.load_any(str(path))
    assert skipped == 3 and len(events) == 1 and events[0]["lane"] == "host:trace"


# ---------------------------------------------------------------------------
# the fit-timeline smoke
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("smoke")
    return {"tmp": tmp, **run_all({
        "port": lambda: port_tool("torch_smoke_fit_timeline.py", tmp / "port.jsonl"),
        "jax": lambda: jax_tool("smoke_fit_timeline.py", tmp / "jax.jsonl")})}


def _smoke_report(stdout):
    """[(label, epochs)] of the fits and the cycles of each attribution line."""
    fits, cycles = [], []
    for line in stdout.splitlines():
        if line.startswith("smoke fit ("):
            fits.append((line.split("(")[1].split(")")[0], int(line.split(": ")[1].split()[0])))
        elif line.startswith("attribution:"):
            cycles.append(int(line.rsplit("over ", 1)[1].split()[0]))
    return fits, cycles


def test_fit_timeline_smoke_reports_what_the_jax_script_reports(smoke_runs):
    port, jax = smoke_runs["port"], smoke_runs["jax"]
    assert port[0] == jax[0] == 0, port[1][-2000:] + port[2][-2000:]
    fits, cycles = _smoke_report(port[1])
    assert fits == [("chunked", 56), ("whole-fit", 56)]
    assert cycles == [7, 1]
    assert _smoke_report(jax[1]) == (fits, cycles)
    # which upload the JAX package admits first varies between its runs
    # (X's 12,800 bytes or y's 1,600): hold the port's to the form
    probe = re.compile(r"budget probe: clean typed rejection: staging \d+ bytes would exceed "
                       r"hbm_budget_bytes=1024: 0 bytes live \(nothing ledgered\)")
    assert probe.fullmatch(port[1].splitlines()[-1]) and probe.fullmatch(jax[1].splitlines()[-1])
    assert port[1].splitlines()[-1].endswith("staging 12800 bytes would exceed "
                                             "hbm_budget_bytes=1024: 0 bytes live (nothing "
                                             "ledgered)")


def test_fit_timeline_smoke_dumps_open_in_the_timeline_tool(smoke_runs):
    tmp = smoke_runs["tmp"]
    for name in ("port.jsonl", "port-wholefit.jsonl"):
        events, skipped = load_script("torch_obs_timeline").load_any(str(tmp / name))
        assert skipped == 0 and any(e["lane"] == "dispatch" for e in events)
    from flink_ml_tpu_torch.obs import timeline

    whole = load_script("torch_obs_timeline").load_any(str(tmp / "port-wholefit.jsonl"))[0]
    assert timeline.dispatch_attribution(whole)["gapCount"] == 1


def test_the_in_memory_fit_is_budget_admitted_as_in_the_jax_package():
    """A host array staged for the flat fit is admitted first (ROADMAP
    C.46): the same typed rejection and message as the JAX package's."""
    from flink_ml_tpu import config as jax_config
    from flink_ml_tpu.obs import memledger as jax_memledger
    from flink_ml_tpu.ops import losses as jax_losses
    from flink_ml_tpu.ops.optimizer import SGD as JaxSGD
    from flink_ml_tpu_torch.obs import memledger
    from flink_ml_tpu_torch.ops import losses
    from flink_ml_tpu_torch.ops.optimizer import SGD

    rng = np.random.RandomState(3)
    X = rng.randn(400, 8).astype(np.float32)
    y = (X @ np.linspace(1, -1, 8) > 0).astype(np.float32)
    with config.use_device("cpu"), config.hbm_budget_mode(1024):
        memledger.reset()
        with pytest.raises(memledger.HbmBudgetExceeded) as port:
            SGD(max_iter=4, global_batch_size=100).optimize(
                np.zeros(8), X, y, None, losses.BINARY_LOGISTIC_LOSS)
    with jax_config.hbm_budget_mode(1024):
        jax_memledger.reset()
        with pytest.raises(jax_memledger.HbmBudgetExceeded) as jax:
            JaxSGD(max_iter=4, global_batch_size=100).optimize(
                np.zeros(8), X, y, None, jax_losses.BINARY_LOGISTIC_LOSS)
    # which upload the JAX package admits first depends on its path (X's
    # 12,800 bytes or y's 1,600); the port admits X first
    form = re.compile(r"staging \d+ bytes would exceed hbm_budget_bytes=1024: 0 bytes live "
                      r"\(nothing ledgered\)")
    assert form.fullmatch(str(port.value)) and form.fullmatch(str(jax.value))
    assert port.value.requested_bytes == 400 * 8 * 4 and port.value.budget_bytes == 1024
    with config.use_device("cpu"), config.hbm_budget_mode(1 << 20):
        coeff, _, epochs = SGD(max_iter=4, global_batch_size=100).optimize(
            np.zeros(8), X, y, None, losses.BINARY_LOGISTIC_LOSS)
    assert epochs == 4 and np.isfinite(coeff).all()


# ---------------------------------------------------------------------------
# the cold-start smoke
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def coldstart(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("coldstart")
    bank = tmp / "bank"
    runs = {mode: port_tool("torch_coldstart_smoke.py", bank, mode)
            for mode in ("populate", "serve", "baseline")}
    flipped = tmp / "flipped"
    flipped.mkdir()
    for f in bank.iterdir():
        (flipped / f.name).write_bytes(f.read_bytes())
    manifest = bytearray((flipped / "manifest.json").read_bytes())
    manifest[0] ^= 0x01
    (flipped / "manifest.json").write_bytes(bytes(manifest))
    runs["flipped"] = port_tool("torch_coldstart_smoke.py", flipped, "serve")
    runs["usage"] = port_tool("torch_coldstart_smoke.py", bank)
    return {mode: (code, json.loads(out.strip().splitlines()[-1]) if code in (0, 1) else None,
                   err) for mode, (code, out, err) in runs.items()}


def test_coldstart_populates_then_serves_with_no_capture(coldstart):
    for mode in ("populate", "serve", "baseline"):
        assert coldstart[mode][0] == 0, coldstart[mode][2][-2000:]
    populate, serve, base = (coldstart[m][1] for m in ("populate", "serve", "baseline"))
    assert populate["programs"] == 2.0 and populate["bankMisses"] == 2.0
    assert serve["serveTraceCount"] == serve["serveCompileCount"] == 0.0
    assert serve["bankHits"] > 0 and serve["bankLoads"] > 0
    assert base["serveTraceCount"] > 0 and base["bankLoads"] == 0.0
    assert serve["outSha"] == base["outSha"]


def test_coldstart_prints_the_jax_keys(coldstart):
    keys = {"mode", "coldStartMs", "firstServeMs", "serveTraceCount", "serveCompileCount",
            "bankHits", "bankMisses", "bankLoads", "bankLoadMs", "outSha"}
    assert set(coldstart["serve"][1]) == set(coldstart["baseline"][1]) == keys
    assert set(coldstart["populate"][1]) >= {"mode", "programs", "warmupMs", "bankHits",
                                             "bankMisses"}


def test_coldstart_serve_exits_1_on_a_refused_bank(coldstart):
    code, payload, err = coldstart["flipped"]
    assert code == 1, err[-2000:]
    assert payload["bankHits"] == 0.0 and payload["serveTraceCount"] > 0
    assert "cold-start SLA violated" in err
    assert payload["outSha"] == coldstart["baseline"][1]["outSha"]


def test_coldstart_usage_exits_2(coldstart):
    code, _, err = coldstart["usage"]
    assert code == 2 and "populate|serve|baseline" in err


def test_coldstart_workload_is_the_jax_workload(coldstart):
    port_model, port_example = load_script("torch_coldstart_smoke").build_workload()
    jax_model, jax_example = load_script("coldstart_smoke").build_workload()
    np.testing.assert_array_equal(np.asarray(port_example.column("features")),
                                  np.asarray(jax_example.column("features")))
    with config.use_device("cpu"):
        got = np.asarray(port_model.transform(port_example)[0].column("norm"), np.float32)
    want = np.asarray(jax_model.transform(jax_example)[0].column("norm"), np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# the writers
# ---------------------------------------------------------------------------

def _tree(root, names):
    out = {}
    for name in names:
        for path in sorted((root / name).rglob("*")):
            if path.is_file():
                out[str(path.relative_to(root))] = path.read_bytes()
    return out


def test_fixture_writer_writes_the_committed_fixtures(tmp_path):
    committed = REPO / "tests" / "fixtures"
    names = sorted(p.name for p in committed.iterdir() if p.name.startswith("reference_"))
    assert load_script("torch_make_reference_fixture").main(["--out", str(tmp_path)]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == names
    assert _tree(tmp_path, names) == _tree(committed, names)


def test_fixture_writer_table_is_the_jax_table():
    port, jax = load_script("torch_make_reference_fixture"), load_script("make_reference_fixture")
    assert list(port.FAMILIES) == list(jax.FAMILIES)
    for name in jax.FAMILIES:
        assert port.FAMILIES[name] == jax.FAMILIES[name], name
    for const in ("KMEANS_CENTROIDS", "KMEANS_WEIGHTS", "LR_COEFFICIENT"):
        np.testing.assert_array_equal(getattr(port, const), getattr(jax, const))


def _doc_rows(script):
    rows = []
    for module in script.iter_stage_modules():
        area = module.__name__.split(".")[2]
        for cls_name in sorted(vars(module)):
            cls = vars(module)[cls_name]
            if not isinstance(cls, type) or cls.__module__ != module.__name__:
                continue
            bases = (script.Estimator, script.Model, script.Transformer, script.AlgoOperator)
            if not issubclass(cls, bases) or cls.__name__.endswith("Params") \
                    or cls.__name__.startswith("_"):
                continue
            rows.append((area, cls.__name__, script.stage_kind(cls), [
                (p.name, script.fmt_default(p.default_value), p.description or "")
                for p in script.params_of(cls)]))
    return sorted(rows)


def test_operator_docs_rows_are_the_jax_rows():
    port = _doc_rows(load_script("torch_gen_operator_docs"))
    assert port == _doc_rows(load_script("gen_operator_docs"))
    assert len(port) == 67


def test_operator_docs_committed_are_what_the_writer_writes(tmp_path):
    out = tmp_path / "torch_operators.md"
    assert load_script("torch_gen_operator_docs").main(["--out", str(out)]) == 0
    assert out.read_bytes() == (REPO / "docs" / "torch_operators.md").read_bytes()


# ---------------------------------------------------------------------------
# no JAX on the card's machine
# ---------------------------------------------------------------------------

POISONED_RUNNER = ("import runpy, sys\n"
                   "sys.modules['jax'] = sys.modules['jaxlib'] = sys.modules['flink_ml_tpu'] = None\n"
                   + CPU_RUNNER)


def _poisoned_args(tmp):
    return {
        "torch_obs_report.py": [TRUNCATED],
        "torch_obs_timeline.py": [TRUNCATED, "-o", tmp / "spans.json"],
        "torch_smoke_fit_timeline.py": [tmp / "events.jsonl"],
        "torch_coldstart_smoke.py": [tmp / "bank", "populate"],
        "torch_make_reference_fixture.py": ["--out", tmp / "fixtures"],
        "torch_gen_operator_docs.py": ["--out", tmp / "operators.md"],
    }


@pytest.fixture(scope="module")
def poisoned_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("poisoned")

    def job(script, args):
        proc = subprocess.run([sys.executable, "-c", POISONED_RUNNER, str(SCRIPTS / script),
                               *map(str, args)], cwd=REPO, env=_env(), capture_output=True,
                              text=True, timeout=300)
        return proc.returncode, proc.stdout, proc.stderr
    return run_all({script: (lambda s=script, a=args: job(s, a))
                    for script, args in _poisoned_args(tmp).items()})


@pytest.mark.parametrize("script", sorted(_poisoned_args(pathlib.Path("."))))
def test_each_tool_runs_where_jax_cannot_be_imported(poisoned_runs, script):
    code, out, err = poisoned_runs[script]
    assert code == 0, out[-2000:] + err[-2000:]
    assert out.strip()
