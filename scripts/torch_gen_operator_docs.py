"""Generate docs/torch_operators.md — one section per algorithm stage of
flink_ml_tpu_torch with its kind, parameters (name/default/description),
and the reference citation from the module docstring. The port's
counterpart of scripts/gen_operator_docs.py (which writes
docs/operators.md for the JAX package); it imports only
flink_ml_tpu_torch, so it runs where JAX is not installed, and touches no
device.

Run: python scripts/torch_gen_operator_docs.py [--out PATH]
(rewrites docs/torch_operators.md, or PATH)
"""

from __future__ import annotations

import importlib
import inspect
import os
import pkgutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import flink_ml_tpu_torch.models as models_pkg  # noqa: E402
from flink_ml_tpu_torch.api import AlgoOperator, Estimator, Model, Transformer  # noqa: E402
from flink_ml_tpu_torch.param import Param  # noqa: E402


def iter_stage_modules():
    for modinfo in pkgutil.walk_packages(models_pkg.__path__, models_pkg.__name__ + "."):
        name = modinfo.name
        if any(part.startswith("_") for part in name.split(".")):
            continue
        yield importlib.import_module(name)


def stage_kind(cls) -> str:
    if issubclass(cls, Estimator):
        return "Estimator"
    if issubclass(cls, Model):
        return "Model"
    if issubclass(cls, Transformer):
        return "Transformer"
    if issubclass(cls, AlgoOperator):
        return "AlgoOperator"
    return "Stage"


def params_of(cls):
    seen = {}
    for klass in reversed(cls.__mro__):
        for attr_name, value in vars(klass).items():
            if isinstance(value, Param):
                seen[value.name] = value
    return sorted(seen.values(), key=lambda p: p.name)


def fmt_default(value) -> str:
    if value is None:
        return "`None`"
    text = repr(value)
    if len(text) > 40:
        text = text[:37] + "..."
    return f"`{text}`"


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(REPO, "docs", "torch_operators.md"),
                        help="the Markdown file to write")
    path = parser.parse_args(argv).out
    sections = {}
    for module in iter_stage_modules():
        area = module.__name__.split(".")[2] if module.__name__.count(".") >= 2 else ""
        doc_first = (module.__doc__ or "").strip().splitlines()
        summary = doc_first[0] if doc_first else ""
        for _, cls in sorted(inspect.getmembers(module, inspect.isclass)):
            if cls.__module__ != module.__name__:
                continue
            if not issubclass(cls, (Estimator, Model, Transformer, AlgoOperator)):
                continue
            if cls.__name__.endswith("Params") or cls.__name__.startswith("_"):
                continue
            lines = [f"### {cls.__name__}", ""]
            lines.append(f"*{stage_kind(cls)}* — `{cls.__module__}`")
            if summary:
                lines.append("")
                lines.append(summary)
            ps = params_of(cls)
            if ps:
                lines += ["", "| param | default | description |", "|---|---|---|"]
                for p in ps:
                    desc = (p.description or "").replace("|", "\\|")
                    lines.append(f"| `{p.name}` | {fmt_default(p.default_value)} | {desc} |")
            sections.setdefault(area, []).append("\n".join(lines))

    out = [
        "# Operators",
        "",
        "Every algorithm stage of `flink_ml_tpu_torch`, generated by",
        "`scripts/torch_gen_operator_docs.py`",
        "(the analogue of the reference's per-operator docs under",
        "`docs/content/docs/operators/**`). Parameters use the reference's",
        "Java camelCase names, so saved metadata cross-loads.",
        "",
    ]
    for area in sorted(sections):
        out.append(f"## {area}")
        out.append("")
        out.extend(s + "\n" for s in sections[area])
    with open(path, "w") as f:
        f.write("\n".join(out))
    count = sum(len(v) for v in sections.values())
    print(f"wrote {path}: {count} stages in {len(sections)} areas")
    return 0


if __name__ == "__main__":
    sys.exit(main())
