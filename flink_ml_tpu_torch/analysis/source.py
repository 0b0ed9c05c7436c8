"""The source model of the port's tpulint.

Port of flink_ml_tpu/analysis/source.py. One `SourceModule` a scanned
file carries what a rule reads: the raw text, the text with comments and
strings blanked (`code_only`), the parsed AST and the file's
suppressions, so every rule reads a file once and reports lines in the
same coordinates.

Suppression syntax::

    x = coeff.item()  # tpulint: disable=host-sync-leak -- the fit's one readback

    # tpulint: disable=retrace-hazard -- one graph per plan, keyed on stage ids
    graph = torch.cuda.CUDAGraph()

A suppression on its own line covers the next source line; an inline one
covers its own line. Several ids are separated by commas. The
`-- reason` tail says why the finding is deliberate: a suppression turns
a finding into documentation. A suppression that matches no finding is
itself reported (rule id `unused-suppression`).
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, List, Optional

_SUPPRESS_RE = re.compile(
    r"#\s*tpulint:\s*disable=([A-Za-z0-9_,-]+)(?:\s*--\s*(.*\S))?\s*$"
)


@dataclass
class Suppression:
    """One ``# tpulint: disable=<rule>`` comment, resolved to the source
    line it covers."""

    rule: str
    line: int  # line the suppression COVERS (not necessarily the comment's)
    comment_line: int
    reason: str = ""
    used: bool = False


def code_only(source: str) -> str:
    """`source` with comments and string/docstring tokens blanked
    (newlines kept, so reported line numbers stay true)."""
    out = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except tokenize.TokenError:
        return source
    lines = source.splitlines(keepends=True)
    drop = []  # (srow, scol, erow, ecol) spans to blank
    for tok in tokens:
        if tok.type in (tokenize.COMMENT, tokenize.STRING):
            drop.append((tok.start, tok.end))
    for line_no, line in enumerate(lines, start=1):
        buf = list(line)
        for (srow, scol), (erow, ecol) in drop:
            if srow <= line_no <= erow:
                lo = scol if line_no == srow else 0
                hi = ecol if line_no == erow else len(buf)
                for i in range(lo, min(hi, len(buf))):
                    if buf[i] not in "\r\n":
                        buf[i] = " "
        out.append("".join(buf))
    return "".join(out)


def _parse_suppressions(source: str) -> List[Suppression]:
    """Extract suppressions via the tokenizer (a ``# tpulint:`` inside a
    string literal is not a suppression)."""
    suppressions: List[Suppression] = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except tokenize.TokenError:
        return suppressions
    lines = source.splitlines()
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        match = _SUPPRESS_RE.search(tok.string)
        if not match:
            continue
        comment_line = tok.start[0]
        text_before = lines[comment_line - 1][: tok.start[1]]
        if text_before.strip():
            covered = comment_line  # inline: covers its own line
        else:
            # standalone comment: covers the next non-blank, non-comment line
            covered = comment_line
            for lookahead in range(comment_line, len(lines)):
                candidate = lines[lookahead].strip()
                if candidate and not candidate.startswith("#"):
                    covered = lookahead + 1
                    break
        for rule_id in match.group(1).split(","):
            rule_id = rule_id.strip()
            if rule_id:
                suppressions.append(
                    Suppression(
                        rule=rule_id,
                        line=covered,
                        comment_line=comment_line,
                        reason=(match.group(2) or "").strip(),
                    )
                )
    return suppressions


@dataclass
class SourceModule:
    """One parsed source file, shared by every rule that inspects it."""

    path: str  # repo-relative, forward slashes
    abspath: str
    source: str
    stripped: str = ""  # comment/string-blanked source (code_only)
    tree: Optional[ast.AST] = None
    parse_error: Optional[str] = None
    suppressions: List[Suppression] = field(default_factory=list)
    module_name: str = ""  # dotted import path, e.g. flink_ml_tpu_torch.ops.tokens
    is_package: bool = False  # an __init__.py (relative imports resolve to itself)

    @classmethod
    def load(cls, abspath: str, relpath: str) -> "SourceModule":
        with open(abspath) as f:
            source = f.read()
        mod = cls(path=relpath.replace("\\", "/"), abspath=abspath, source=source)
        mod.stripped = code_only(source)
        mod.suppressions = _parse_suppressions(source)
        parts = mod.path[:-3].split("/") if mod.path.endswith(".py") else []
        if parts and parts[-1] == "__init__":
            parts = parts[:-1]
            mod.is_package = True
        mod.module_name = ".".join(parts)
        try:
            mod.tree = ast.parse(source, filename=relpath)
        except SyntaxError as e:
            mod.parse_error = f"{e.__class__.__name__}: {e}"
        return mod

    def stripped_lines(self) -> List[str]:
        return self.stripped.splitlines()

    def suppressions_for(self, rule_id: str) -> Dict[int, Suppression]:
        return {s.line: s for s in self.suppressions if s.rule == rule_id}


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def resolve_relative_import(
    module_name: str, node: ast.ImportFrom, is_package: bool = False
) -> Optional[str]:
    """The absolute dotted module an ``ImportFrom`` pulls from, resolving
    leading dots against ``module_name`` (the importing module)."""
    if node.level == 0:
        return node.module
    base = module_name.split(".")
    # one dot reaches the containing package: the module itself when the
    # importer is a package __init__, its parent otherwise
    trim = node.level - 1 if is_package else node.level
    if trim > len(base):
        return None
    prefix = base[: len(base) - trim] if trim else base
    if node.module:
        return ".".join(prefix + [node.module])
    return ".".join(prefix) or None
