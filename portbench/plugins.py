"""Files of the benchmark found by name.

A configuration, a traffic mix, a metric, a count or a check lives in a
file of its own under this folder, named after it; nothing lists them.
`plugin(kind, name)` loads `<kind>/<name>.py` (a name may hold dots, so
the file is loaded by its path), `data_file(kind, name)` reads
`<kind>/<name>.json`.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parent
#: what a name may be (BENCHMARK.json's rule for every name)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _path(kind: str, name: str, suffix: str) -> Path:
    if not NAME.fullmatch(name):
        raise ValueError(f"{name!r} is not a benchmark name")
    path = ROOT / kind / f"{name}{suffix}"
    if not path.is_file():
        raise LookupError(f"no {kind} named {name!r} (looked for {path.relative_to(ROOT.parent)})")
    return path


def plugin(kind: str, name: str):
    """The module `<kind>/<name>.py`, loaded once a process."""
    key = f"{__package__}.{kind}.{name.replace('.', '__')}"
    if key not in sys.modules:
        path = _path(kind, name, ".py")
        spec = importlib.util.spec_from_file_location(key, path,
                                                      submodule_search_locations=None)
        module = importlib.util.module_from_spec(spec)
        module.__package__ = f"{__package__}.{kind}"
        sys.modules[key] = module
        spec.loader.exec_module(module)
    return sys.modules[key]


def data_file(kind: str, name: str) -> Dict:
    """The JSON object in `<kind>/<name>.json`."""
    with open(_path(kind, name, ".json")) as f:
        return json.load(f)


def has(kind: str, name: str, suffix: str = ".py") -> bool:
    return NAME.fullmatch(name) is not None and (ROOT / kind / f"{name}{suffix}").is_file()
