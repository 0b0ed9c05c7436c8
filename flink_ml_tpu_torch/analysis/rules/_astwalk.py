"""Statement-ordered AST walking shared by the dataflow rules.

Port of flink_ml_tpu/analysis/rules/_astwalk.py.

Linear (source-order) statement walks need one invariant: a compound
statement contributes only its OWN header expressions (test, iter,
with-items); its nested blocks are yielded as separate statements. A rule
that walks a compound statement wholesale scans nested code twice, and
out of order relative to the state it is tracking.
"""

from __future__ import annotations

import ast
from typing import List


def header_nodes(stmt: ast.stmt) -> List[ast.AST]:
    """The statement's own expressions, excluding nested statement blocks
    (and excluding nested function/class bodies, which are separate
    scopes)."""
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.target, stmt.iter]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        out: List[ast.AST] = []
        for item in stmt.items:
            out.append(item.context_expr)
            if item.optional_vars is not None:
                out.append(item.optional_vars)
        return out
    if isinstance(
        stmt, (ast.Try, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
    ):
        return []
    return [stmt]


def statements_in_order(body: List[ast.stmt]) -> List[ast.stmt]:
    """Every statement reachable from ``body``, linearized in source order;
    branch arms concatenate, loop back-edges are not modeled, nested
    function/class bodies are skipped (separate scopes)."""
    out: List[ast.stmt] = []

    def visit_block(stmts) -> None:
        for stmt in stmts:
            out.append(stmt)
            if isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            for block in (
                getattr(stmt, "body", None),
                getattr(stmt, "orelse", None),
                getattr(stmt, "finalbody", None),
            ):
                if block:
                    visit_block(block)
            for handler in getattr(stmt, "handlers", []) or []:
                visit_block(handler.body)

    visit_block(body)
    return out
