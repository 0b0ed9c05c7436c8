"""The one traffic generator: a mix's parameters (`traffic/<mix>.json`)
turned into requests on the program, sent in a closed loop.

A mix says:

- `request`: "fit" (the configuration's estimator fits the rows; the
  answer is the fitted coefficient on the host) or "transform" (the model
  the set-up fitted at the configuration's own parameters transforms the
  rows; the answer is the new output columns, on the device);
- `rows`: "all" (the whole table) or a count (a block of that many rows,
  its start drawn from the seed for each request);
- `grid`: estimator parameters by name, each with its values; a request
  takes one point of their product, the points cycling in an order
  drawn from the seed (a seeded shuffle of the product);
- `loop`: "closed" with `clients`: 1: the next request is sent when the
  last has answered;
- `sample`: which answers the comparison reads: "each_grid_point" (one
  answer of each point, drawn from the seed) or a count (that many
  answers of the whole window, drawn from the seed).

Every seed gets the same set of requests, in another order.
"""

from __future__ import annotations

import itertools
import time
import traceback
from typing import Dict, List, NamedTuple

import torch

from . import program, seeds
from .plugins import plugin


class Answer(NamedTuple):
    """One request's answer as the comparison reads it: its parameters,
    its rows [lo, hi) and what the program returned."""

    request: str
    point: Dict
    lo: int
    hi: int
    value: object


class Window(NamedTuple):
    """A closed loop's record: its length in seconds, the requests sent and
    answered, the rows they covered, the requests that raised."""

    seconds: float
    attempted: int
    completed: int
    rows: int
    failed: int


def grid_points(grid: Dict) -> List[Dict]:
    """The product of the grid's values, as parameter dicts, keys in the
    file's order."""
    keys = list(grid)
    return [dict(zip(keys, values)) for values in itertools.product(*(grid[k] for k in keys))]


class Workload:
    """One cell's traffic on one table: built at set-up, then `warm`,
    `run` for the window, `answers` for the comparison."""

    def __init__(self, mix: Dict, config: Dict, tensors: Dict, seed: int, device):
        if mix.get("loop") != "closed" or int(mix.get("clients", 1)) != 1:
            raise ValueError("the generator sends a closed loop of one client")
        if mix["request"] not in ("fit", "transform"):
            raise ValueError(f"unknown request {mix['request']!r}")
        self.mix, self.device = mix, device
        data = config["data"]
        self.table = program.table(plugin("data", data["kind"]).columns(tensors, data, program))
        self.n = int(self.table.num_rows)
        points = grid_points(mix.get("grid", {}))
        seeds.host_random(seed, "order").shuffle(points)
        self.points = points
        self.rows = mix.get("rows", "all")
        self._blocks = seeds.host_random(seed, "rows")
        self._sample = seeds.host_random(seed, "sample")
        self._kept: Dict = {}
        self._seen: Dict = {}
        cls, params = config["estimator"]["class"], config["estimator"]["params"]
        if mix["request"] == "fit":
            self.estimators = [program.estimator(cls, {**params, **p}) for p in points]
        else:
            self.model = program.estimator(cls, params).fit(self.table)
            self._inputs = set(self.table.column_names)

    # -- requests -----------------------------------------------------------
    def _block(self):
        if self.rows == "all":
            return 0, self.n
        count = min(int(self.rows), self.n)
        lo = self._blocks.randrange(0, self.n - count + 1)
        return lo, lo + count

    def _rows(self, lo: int, hi: int):
        if (lo, hi) == (0, self.n):
            return self.table
        return program.table({name: _slice(self.table.column(name), lo, hi)
                              for name in self.table.column_names})

    def request(self, i: int) -> Answer:
        """Send request i and wait for its answer."""
        k = i % len(self.points)
        lo, hi = self._block()
        rows = self._rows(lo, hi)
        if self.mix["request"] == "fit":
            value = self.estimators[k].fit(rows).coefficient
        else:
            out = self.model.transform(rows)[0]
            value = {name: out.column(name) for name in out.column_names
                     if name not in self._inputs}
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return Answer(self.mix["request"], self.points[k], lo, hi, value)

    def warm(self) -> None:
        """Every point of the grid once: the first request of a signature
        captures its program, the rest replay it."""
        for i in range(len(self.points)):
            self.request(i)

    def _keep(self, answer: Answer, index: int) -> None:
        """A sample of the answers, drawn from the seed (reservoirs)."""
        spec = self.mix.get("sample", 1)
        if spec == "each_grid_point":
            key, size = index % len(self.points), 1
        else:
            key, size = "all", int(spec)
        seen = self._seen.get(key, 0) + 1
        self._seen[key] = seen
        kept = self._kept.setdefault(key, [])
        if len(kept) < size:
            kept.append(answer)
        else:
            j = self._sample.randrange(seen)
            if j < size:
                kept[j] = answer

    def run(self, seconds: float, start: int = 0, annotate=None) -> Window:
        """The closed loop for `seconds`: requests are sent back to back
        until one answers past the deadline; the window ends with that
        answer. `annotate(name)`, if given, is a context that names each
        request (the profiler's record_function)."""
        i = start
        completed = failed = rows = 0
        t_start = time.perf_counter()
        deadline = t_start + seconds
        end = t_start
        while end < deadline:
            try:
                if annotate is None:
                    answer = self.request(i)
                else:
                    with annotate(f"portbench.{self.mix['request']}"):
                        answer = self.request(i)
            except Exception:  # a request that raised is counted and the loop goes on
                failed += 1
                if failed == 1:
                    traceback.print_exc()
            else:
                completed += 1
                rows += answer.hi - answer.lo
                self._keep(answer, i)
            i += 1
            end = time.perf_counter()
        self.sent = i
        return Window(end - t_start, i - start, completed, rows, failed)

    def answers(self) -> List[Answer]:
        """The sampled answers, in request order of their grid points."""
        return [a for key in sorted(self._kept, key=str) for a in self._kept[key]]


def _slice(col, lo: int, hi: int):
    if hasattr(col, "indices") and hasattr(col, "values") and hasattr(col, "size"):
        return program.sparse_column(col.size, col.indices[lo:hi], col.values[lo:hi])
    return col[lo:hi]

