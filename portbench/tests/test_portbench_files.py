"""BENCHMARK.json against the benchmark's contract, and every file a cell
needs found by its name."""

import json
import re

import pytest

from portbench import harness
from portbench.plugins import ROOT, has

SPEC = harness.benchmark_spec()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_entries_and_names():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for section, allowed in keys.items():
        names = [e["name"] for e in SPEC[section]]
        assert len(names) == len(set(names))
        for e in SPEC[section]:
            assert set(e) - {"workloads"} == allowed, (section, e["name"])
            assert NAME.fullmatch(e["name"])
            if "unit" in e:
                assert UNIT.fullmatch(e["unit"]) and e["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]


def test_bounds_and_sources():
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell in m.get("workloads", CELLS):
            assert harness.applies(e2e[m["moves"]], cell), (m["name"], cell)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = harness.Cell(SPEC, cell)
    assert c.chips == 1
    assert has("data", c.config["data"]["kind"]) and has("reference", c.config["reference"])
    assert c.limits and all(has("checks", name) for name in c.limits)
    for m in c.end_to_end + c.per_layer:
        assert has("metrics", m["name"]), m["name"]
    assert any(m["name"] == "setup_s" for m in c.end_to_end) and len(c.end_to_end) >= 2
    assert c.per_layer


def test_configs_are_used_and_their_files_lie_under_paths():
    used = {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert {c["name"] for c in SPEC["configs"]} == used and len(set(files)) == len(files)
    for c in SPEC["configs"]:
        assert c["file"].startswith("portbench/")
        with open(ROOT.parent / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["dtype"] == "float32"
