"""SQLTransformer — applies a SQL statement with __THIS__ as the input table.

Port of flink_ml_tpu/models/feature/sqltransformer.py (the reference's
feature/sqltransformer/SQLTransformer.java:193, which runs
`SELECT ... FROM __THIS__` through the Flink Table API). Two paths, as in
the JAX package:

- the columnwise projection: `SELECT <items> FROM __THIS__ [WHERE cond]`
  whose items are column references, numeric literals, + - * / and
  ABS/SQRT/EXP/LN/LOG10/SIN/COS over float columns, vector columns too.
  Each operator acts on the column's own type: a numpy array stays numpy,
  a tensor stays on its device. The WHERE mask follows SQL's three-valued
  logic for NaN (a NaN operand is unknown; NOT, AND and OR propagate it;
  only rows that are surely true survive) and is computed on the
  column's device; `Table.take` of its rows keeps vector columns. A
  constant item is a column on the table's device in its float dtype.
  Integer, string and object columns bail to sqlite, whose integer
  division this path would not repeat.
- the sqlite path for everything else (GROUP BY, aggregates, DISTINCT,
  strings): the scalar columns go row by row into an in-memory stdlib
  sqlite3 database, device columns read back first. A star select with no
  GROUP BY or DISTINCT passes the other (vector) columns through by row
  identity.

Where the two paths differ, they differ as in the JAX package: float
division by zero and out-of-domain SQRT/LN/LOG10 give inf or NaN
columnwise (IEEE, as the reference's Flink SQL on DOUBLE) and NULL in
sqlite.
"""

from __future__ import annotations

import re
import sqlite3
from typing import List

import numpy as np
import torch

from ... import config
from ...api import Transformer
from ...param import ParamValidators, StringParam
from ...table import Table, _to_numpy


class SQLTransformer(Transformer):
    fusable = False
    fusable_reason = "interprets a SQL statement over host rows (arbitrary expressions, aggregates, row filters)"

    STATEMENT = StringParam("statement", "SQL statement.", None, ParamValidators.not_null())

    def get_statement(self) -> str:
        return self.get(self.STATEMENT)

    def set_statement(self, value: str):
        if "__THIS__" not in value:
            raise ValueError("Parameter statement must contain '__THIS__'")
        return self.set(self.STATEMENT, value)

    def transform(self, *inputs: Table) -> List[Table]:
        config.device()  # an entry point: no silent CPU without a request
        (table,) = inputs
        statement = self.get_statement()
        if statement is None:
            raise ValueError("Parameter statement must be set")
        projected = _try_vectorized_projection(statement, table)
        if projected is not None:
            return [projected]
        return [_sqlite_transform(statement, table)]


def _is_scalar_column(col) -> bool:
    """A column sqlite can hold: 1-D numbers, or an object column of
    strings, numbers and None."""
    if isinstance(col, torch.Tensor):
        return col.ndim == 1
    if not isinstance(col, np.ndarray):
        return False
    if col.ndim == 1 and col.dtype != object:
        return True
    return col.dtype == object and all(isinstance(v, (str, int, float, type(None))) for v in col)


def _sqlite_transform(statement: str, table: Table) -> Table:
    sql = re.sub(r"__THIS__", "__this__", statement)
    scalar_cols = [c for c in table.column_names if _is_scalar_column(table.column(c))]
    if not scalar_cols:
        raise ValueError("SQLTransformer requires at least one scalar column")
    conn = sqlite3.connect(":memory:")
    try:
        quoted = ", ".join(f'"{c}"' for c in scalar_cols)
        conn.execute(f"CREATE TABLE __this__ ({quoted})")
        rows = list(zip(*[_to_numpy(table.column(c)).tolist() for c in scalar_cols]))
        conn.executemany(
            f"INSERT INTO __this__ ({quoted}) VALUES ({', '.join('?' * len(scalar_cols))})",
            rows,
        )
        # the surviving rows' identities, so the non-scalar columns can pass
        # through a star select; not with GROUP BY or DISTINCT, where sqlite
        # would give an arbitrary rowid a group
        row_ids = None
        names, data = None, None
        m = re.match(r"(?is)^\s*select\s+(?=\*)", sql)
        if m is not None and not re.search(r"(?i)\bgroup\s+by\b|\bdistinct\b", sql):
            with_rid = sql[: m.end()] + "rowid AS __rid__, " + sql[m.end():]
            try:
                cursor = conn.execute(with_rid)
                names = [d[0] for d in cursor.description]
                data = cursor.fetchall()
                rid_pos = names.index("__rid__")
                row_ids = [row[rid_pos] - 1 for row in data]
                names = [n for n in names if n != "__rid__"]
                data = [tuple(v for i, v in enumerate(row) if i != rid_pos) for row in data]
            except sqlite3.Error:
                row_ids = None
        if row_ids is None:
            cursor = conn.execute(sql)
            names = [d[0] for d in cursor.description]
            data = cursor.fetchall()
    finally:
        conn.close()
    out = Table({name: [row[i] for row in data] for i, name in enumerate(names)})
    non_scalar = [c for c in table.column_names if c not in scalar_cols]
    if row_ids is not None and non_scalar:
        passthrough = table.take(np.asarray(row_ids, dtype=np.int64))
        out = out.with_columns({c: passthrough.column(c) for c in non_scalar})
    return out


# -- the columnwise projection --------------------------------------------------

_FUNCS = frozenset({"abs", "sqrt", "exp", "ln", "log10", "sin", "cos"})
_TORCH_FUNCS = {"exp": torch.exp, "ln": torch.log, "log10": torch.log10, "sin": torch.sin,
                "cos": torch.cos}
_NUMPY_FUNCS = {"exp": np.exp, "ln": np.log, "log10": np.log10, "sin": np.sin, "cos": np.cos}


def _apply_func(name: str, arg):
    if name == "abs":
        return abs(arg)
    if name == "sqrt":
        return arg ** 0.5
    funcs = _TORCH_FUNCS if isinstance(arg, torch.Tensor) else _NUMPY_FUNCS
    return funcs[name](arg)


def _isnan(x):
    """NaN of a column (on its device) or of a constant (a Python bool)."""
    if isinstance(x, torch.Tensor):
        return torch.isnan(x)
    nan = np.isnan(x)
    return bool(nan) if np.ndim(nan) == 0 else nan


def _ndim(x) -> int:
    return x.ndim if isinstance(x, torch.Tensor) else np.ndim(x)


_TOKEN = re.compile(
    r"\s*(?:(?P<num>\d+\.\d*|\.\d+|\d+)|(?P<name>[A-Za-z_][A-Za-z_0-9]*)"
    r"|(?P<op><=|>=|<>|!=|[-+*/()<>=]))"
)


def _tokenize(expr: str):
    pos, out = 0, []
    while pos < len(expr):
        m = _TOKEN.match(expr, pos)
        if m is None or m.end() == pos:
            if expr[pos:].strip():
                raise ValueError(f"unsupported token at {expr[pos:]!r}")
            break
        out.append((m.lastgroup, m.group(m.lastgroup)))
        pos = m.end()
    return out


def _float_column(col) -> bool:
    if isinstance(col, torch.Tensor):
        return col.dtype.is_floating_point
    return isinstance(col, np.ndarray) and col.dtype.kind == "f"


class _ExprParser:
    """Recursive-descent arithmetic and boolean logic over table columns."""

    def __init__(self, tokens, table: Table):
        self.tokens = tokens
        self.i = 0
        self.table = table

    def peek(self):
        return self.tokens[self.i] if self.i < len(self.tokens) else (None, None)

    def take(self):
        tok = self.peek()
        self.i += 1
        return tok

    def parse(self):
        value = self.add()
        if self.i != len(self.tokens):
            raise ValueError("trailing tokens")
        return value

    # the boolean layer (WHERE): OR < AND < NOT < comparison. Each node is
    # a (true mask, false mask) pair; a NaN operand (sqlite's NULL) makes a
    # row neither, and only true rows survive the filter

    def parse_where(self):
        true_mask, _ = self.bool_or()
        if self.i != len(self.tokens):
            raise ValueError("trailing tokens")
        return true_mask

    def _is_kw(self, word: str) -> bool:
        kind, text = self.peek()
        return kind == "name" and text.lower() == word

    def bool_or(self):
        t, f = self.bool_and()
        while self._is_kw("or"):
            self.take()
            t2, f2 = self.bool_and()
            t, f = t | t2, f & f2
        return t, f

    def bool_and(self):
        t, f = self.bool_not()
        while self._is_kw("and"):
            self.take()
            t2, f2 = self.bool_not()
            t, f = t & t2, f | f2
        return t, f

    def bool_not(self):
        if self._is_kw("not"):
            self.take()
            t, f = self.bool_not()
            return f, t
        if self.peek() == ("op", "("):
            # "(" opens a boolean group or an arithmetic one ("(a + 1) > 2"):
            # try boolean first, back up on failure
            mark = self.i
            try:
                self.take()
                value = self.bool_or()
                if self.take() != ("op", ")"):
                    raise ValueError("unbalanced parens")
                return value
            except ValueError:
                self.i = mark
        return self.comparison()

    def comparison(self):
        lhs = self.add()
        kind, text = self.peek()
        if kind == "op" and text in ("<", ">", "<=", ">=", "=", "!=", "<>"):
            self.take()
            rhs = self.add()
            unknown = _isnan(lhs) | _isnan(rhs)
            known = ~unknown if not isinstance(unknown, bool) else (not unknown)
            if text == "=":
                cmp = lhs == rhs
            elif text in ("!=", "<>"):
                cmp = lhs != rhs
            elif text == "<":
                cmp = lhs < rhs
            elif text == ">":
                cmp = lhs > rhs
            elif text == "<=":
                cmp = lhs <= rhs
            else:
                cmp = lhs >= rhs
            return cmp & known, ~cmp & known
        raise ValueError("WHERE term must be a comparison")

    def add(self):
        value = self.mul()
        while self.peek() == ("op", "+") or self.peek() == ("op", "-"):
            _, op = self.take()
            rhs = self.mul()
            value = value + rhs if op == "+" else value - rhs
        return value

    def mul(self):
        value = self.unary()
        while self.peek() == ("op", "*") or self.peek() == ("op", "/"):
            _, op = self.take()
            rhs = self.unary()
            value = value * rhs if op == "*" else value / rhs
        return value

    def unary(self):
        if self.peek() == ("op", "-"):
            self.take()
            return -self.unary()
        if self.peek() == ("op", "+"):
            self.take()
            return self.unary()
        return self.atom()

    def atom(self):
        kind, text = self.take()
        if kind == "num":
            return float(text)
        if kind == "op" and text == "(":
            value = self.add()
            if self.take() != ("op", ")"):
                raise ValueError("unbalanced parens")
            return value
        if kind == "name":
            lowered = text.lower()
            if self.peek() == ("op", "(") and lowered in _FUNCS:
                self.take()
                arg = self.add()
                if self.take() != ("op", ")"):
                    raise ValueError("unbalanced parens")
                return _apply_func(lowered, arg)
            if text in self.table:
                col = self.table.column(text)
                if not _float_column(col):
                    # integers: sqlite divides them as integers; strings,
                    # objects, sparse and token columns: not columnwise math
                    raise ValueError("only float columns supported in the columnwise path")
                return col
            raise ValueError(f"unknown name {text!r}")
        raise ValueError(f"unexpected token {text!r}")


def _split_select_items(select_list: str) -> List[str]:
    items, depth, cur = [], 0, []
    for ch in select_list:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            items.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if "".join(cur).strip():
        items.append("".join(cur).strip())
    return items


def _constant_column(table: Table, value: float):
    """A constant as a column: on the device and in the float dtype of the
    table's first float tensor column, else a float64 host array."""
    for name in table.column_names:
        col = table.column(name)
        if isinstance(col, torch.Tensor) and col.dtype.is_floating_point:
            return torch.full((table.num_rows,), float(value), dtype=col.dtype, device=col.device)
    return np.full(table.num_rows, float(value))


def _row_mask(mask, num_rows: int):
    """The WHERE mask as a (num_rows,) bool array or tensor, or None when
    it is not one (a comparison over a vector column, a constant)."""
    if isinstance(mask, torch.Tensor):
        ok = mask.dtype == torch.bool and tuple(mask.shape) == (num_rows,)
        return mask if ok else None
    mask = np.asarray(mask)
    return mask if mask.dtype == np.bool_ and mask.shape == (num_rows,) else None


def _try_vectorized_projection(statement: str, table: Table):
    """`SELECT items FROM __THIS__ [WHERE cond]` columnwise, or None when it
    is not expressible so (the caller takes the sqlite path)."""
    m = re.match(
        r"(?is)^\s*select\s+(.*?)\s+from\s+__THIS__(?:\s+where\s+(.*?))?\s*;?\s*$",
        statement,
    )
    if m is None:
        return None
    where = m.group(2)
    mask = None
    if where is not None:
        try:
            mask = _ExprParser(_tokenize(where), table).parse_where()
        except (ValueError, KeyError, IndexError, TypeError, ZeroDivisionError, RuntimeError):
            return None
        mask = _row_mask(mask, table.num_rows)
        if mask is None:
            return None
    out = {}
    for item in _split_select_items(m.group(1)):
        if item == "*":
            for name in table.column_names:
                out[name] = table.column(name)
            continue
        alias_m = re.match(r"(?is)^(.*?)\s+as\s+([A-Za-z_][A-Za-z_0-9]*)$", item)
        expr, alias = (alias_m.group(1), alias_m.group(2)) if alias_m else (item, None)
        expr = expr.strip()
        if alias is None:
            if not re.fullmatch(r"[A-Za-z_][A-Za-z_0-9]*", expr) or expr not in table:
                return None  # an unnamed computed column: sqlite names it
            out[expr] = table.column(expr)
            continue
        try:
            value = _ExprParser(_tokenize(expr), table).parse()
        except (ValueError, KeyError, IndexError, TypeError, ZeroDivisionError, RuntimeError):
            return None
        if _ndim(value) == 0:
            value = _constant_column(table, value)
        out[alias] = value
    result = Table(out)
    if mask is not None:
        idx = torch.nonzero(mask).flatten() if isinstance(mask, torch.Tensor) \
            else np.flatnonzero(mask)
        result = result.take(idx)
    return result
