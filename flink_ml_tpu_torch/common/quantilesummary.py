"""Mergeable Greenwald-Khanna quantile sketch: the out-of-core quantile engine.

The port's own copy of flink_ml_tpu/common/quantilesummary.py (the
reference's common/util/QuantileSummary.java, the GK01 algorithm "Space-
efficient Online Computation of Quantile Summaries"). It is host numpy on
both sides and computes the same summaries: a sketch built with relative
error eps answers any percentile with rank error <= eps * n, sketches
merge, and query() resolves percentiles as the reference does
(QuantileSummary.java:226-279), with its p <= eps and p >= 1 - eps
endpoint short-circuits.

The summary is three parallel arrays (value, g, delta); inserts are
batched: a mini-batch is sorted once and merged with searchsorted
arithmetic. compress() is the one sequential pass, over a summary that GK
bounds at O((1/eps) log(eps n)) entries.

RobustScaler, KBinsDiscretizer (quantile) and Imputer (median) fit a
`StreamTable` through it, one sketch per column.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = ["QuantileSummary", "column_sketches", "update_column_sketches"]

_DEFAULT_HEAD_SIZE = 50000
_DEFAULT_COMPRESS_THRESHOLD = 10000


class QuantileSummary:
    """GK quantile summary over a scalar stream.

    Mutable (unlike the reference's persistent-functional style): `insert`
    and `insert_batch` update in place; `merge` returns a new summary.
    """

    __slots__ = ("relative_error", "compress_threshold", "count",
                 "_values", "_g", "_delta", "_head", "_compressed")

    def __init__(self, relative_error: float,
                 compress_threshold: int = _DEFAULT_COMPRESS_THRESHOLD):
        if not 0.0 <= relative_error <= 1.0:
            raise ValueError("relative error must be in [0, 1]")
        if compress_threshold <= 0:
            raise ValueError("compress threshold must be > 0")
        self.relative_error = float(relative_error)
        self.compress_threshold = int(compress_threshold)
        self.count = 0
        self._values = np.empty(0, dtype=np.float64)
        self._g = np.empty(0, dtype=np.int64)
        self._delta = np.empty(0, dtype=np.int64)
        self._head: List[np.ndarray] = []
        self._compressed = True

    # -- ingestion ----------------------------------------------------------
    def insert(self, item: float) -> "QuantileSummary":
        return self.insert_batch(np.asarray([item], dtype=np.float64))

    def insert_batch(self, values) -> "QuantileSummary":
        """Buffer a batch; flush + compress when the buffer passes the head
        size (the reference's DEFAULT_HEAD_SIZE flush, QuantileSummary.java:121)."""
        arr = np.asarray(values, dtype=np.float64).ravel()
        if arr.size == 0:
            return self
        self._head.append(arr)
        self._compressed = False
        if sum(a.size for a in self._head) >= _DEFAULT_HEAD_SIZE:
            self._flush_head()
            if self._values.size >= self.compress_threshold:
                self._compress_sampled()
        return self

    def _flush_head(self) -> None:
        """Merge the sorted head buffer into the sampled summary
        (insertHeadBuffer, QuantileSummary.java:291-318) — vectorized: one
        sort + one searchsorted instead of a per-element cursor walk."""
        if not self._head:
            return
        buf = np.sort(np.concatenate(self._head))
        self._head = []
        n_old, n_new = self._values.size, buf.size
        # reference cursor rule: existing samples with value <= new value go
        # first => new element i lands after searchsorted(..., 'right')
        pos = np.searchsorted(self._values, buf, side="right")
        new_pos = pos + np.arange(n_new)
        total = n_old + n_new
        values = np.empty(total, dtype=np.float64)
        g = np.empty(total, dtype=np.int64)
        delta = np.empty(total, dtype=np.int64)
        old_mask = np.ones(total, dtype=bool)
        old_mask[new_pos] = False
        values[new_pos], values[old_mask] = buf, self._values
        g[new_pos], g[old_mask] = 1, self._g
        # delta = floor(2*eps*count_before_flush); 0 at the global ends
        # (QuantileSummary.java:305-309)
        new_delta = np.full(n_new, int(np.floor(2.0 * self.relative_error * self.count)),
                            dtype=np.int64)
        if new_pos[0] == 0:
            new_delta[0] = 0
        if new_pos[-1] == total - 1:
            new_delta[-1] = 0
        delta[new_pos], delta[old_mask] = new_delta, self._delta
        self._values, self._g, self._delta = values, g, delta
        self.count += n_new

    # -- compression --------------------------------------------------------
    def compress(self) -> "QuantileSummary":
        if self._compressed:
            return self
        self._flush_head()
        self._compress_sampled()
        return self

    def _compress_sampled(self) -> None:
        """COMPRESS from the GK paper: greedy right-to-left merge of adjacent
        tuples while g_i + g_head + delta_head < 2*eps*n
        (compressInternal, QuantileSummary.java:321-346)."""
        n = self._values.size
        if n == 0:
            self._compressed = True
            return
        threshold = 2.0 * self.relative_error * self.count
        values, g, delta = self._values, self._g, self._delta
        # the sequential merge walks Python lists: a numpy scalar per step
        # costs ~15x more, and the counts stay exact integers either way
        g_list, delta_list = g.tolist(), delta.tolist()
        keep_idx: List[int] = []  # surviving tuple indices, built right-to-left
        keep_g: List[int] = []  # their merged g counts
        head = n - 1
        head_g = g_list[head]
        for i in range(n - 2, 0, -1):
            if g_list[i] + head_g + delta_list[head] < threshold:
                head_g += g_list[i]
            else:
                keep_idx.append(head)
                keep_g.append(head_g)
                head = i
                head_g = g_list[i]
        keep_idx.append(head)
        keep_g.append(head_g)
        keep_idx.reverse()
        keep_g.reverse()
        # reference keeps the first tuple if it is still the minimum
        if n > 1 and values[0] <= values[head]:
            keep_idx.insert(0, 0)
            keep_g.insert(0, g_list[0])
        idx = np.asarray(keep_idx, dtype=np.int64)
        self._values = values[idx]
        self._g = np.asarray(keep_g, dtype=np.int64)
        self._delta = delta[idx]
        self._compressed = True

    # -- merge --------------------------------------------------------------
    def merge(self, other: "QuantileSummary") -> "QuantileSummary":
        """Merge two compressed sketches (QuantileSummary.java:161-217):
        interleave sorted, ties taken from `other` first; elements strictly
        inside the other sketch's value range absorb the other sketch's
        worst-case rank slack floor(2*eps_other*n_other) into delta."""
        if self._head or other._head:
            raise ValueError("compress() both summaries before merge()")
        if other.count == 0:
            return self._copy()
        if self.count == 0:
            return other._copy()
        merged_eps = max(self.relative_error, other.relative_error)
        merged_count = self.count + other.count
        add_self = int(np.floor(2.0 * other.relative_error * other.count))
        add_other = int(np.floor(2.0 * self.relative_error * self.count))

        sv, ov = self._values, other._values
        # additional delta rules (vectorized restatement of the cursor walk):
        # self[i] is consumed in-loop iff sv[i] < max(ov) and had other
        # elements before it iff sv[i] >= min(ov); symmetric for other with
        # strict/non-strict flipped by the tie rule (other wins ties).
        self_extra = np.where((sv >= ov[0]) & (sv < ov[-1]), add_self, 0)
        other_extra = np.where((ov > sv[0]) & (ov <= sv[-1]), add_other, 0)

        # stable sort of [other, self] keeps other before self on ties,
        # matching the reference's `self < other ? self : other` pick
        cat_v = np.concatenate([ov, sv])
        order = np.argsort(cat_v, kind="stable")
        cat_g = np.concatenate([other._g, self._g])
        cat_d = np.concatenate([other._delta + other_extra, self._delta + self_extra])

        out = QuantileSummary(merged_eps, max(self.compress_threshold, other.compress_threshold))
        out._values = cat_v[order]
        out._g = cat_g[order]
        out._delta = cat_d[order]
        out.count = merged_count
        out._compressed = False
        out._compress_sampled()
        return out

    def _copy(self) -> "QuantileSummary":
        out = QuantileSummary(self.relative_error, self.compress_threshold)
        out._values = self._values.copy()
        out._g = self._g.copy()
        out._delta = self._delta.copy()
        out.count = self.count
        out._compressed = self._compressed
        return out

    # -- query --------------------------------------------------------------
    def is_empty(self) -> bool:
        return not self._head and self._values.size == 0

    def query(self, percentiles) -> np.ndarray:
        """Answer percentile queries (QuantileSummary.java:226-279). Must be
        compressed first. Vectorized: for each target rank, the first sampled
        tuple whose [min_rank - e, max_rank + e] window covers it."""
        scalar = np.isscalar(percentiles)
        ps = np.atleast_1d(np.asarray(percentiles, dtype=np.float64))
        if np.any((ps < 0) | (ps > 1)):
            raise ValueError("percentile should be in the range [0.0, 1.0]")
        if self._head:
            raise ValueError("call compress() before query()")
        if self._values.size == 0:
            raise ValueError("cannot query an empty summary")
        min_rank = np.cumsum(self._g)
        max_rank = min_rank + self._delta
        target_error = np.max(self._delta + self._g) / 2.0
        ranks = np.ceil(ps * self.count)
        # window test per (percentile, sample); first hit wins
        ok = (max_rank[None, :] - target_error < ranks[:, None]) & (
            ranks[:, None] <= min_rank[None, :] + target_error
        )
        # exclude the last index from the scan (reference loops i < size-1
        # and falls through to the last value)
        if ok.shape[1] > 1:
            ok[:, -1] = True
        idx = np.argmax(ok, axis=1)
        result = self._values[idx]
        result = np.where(ps <= self.relative_error, self._values[0], result)
        result = np.where(ps >= 1.0 - self.relative_error, self._values[-1], result)
        return float(result[0]) if scalar else result


# -- per-feature column helpers ---------------------------------------------

def column_sketches(num_features: int, relative_error: float) -> List[QuantileSummary]:
    """One sketch per feature column."""
    return [QuantileSummary(relative_error) for _ in range(num_features)]


def update_column_sketches(sketches: Sequence[QuantileSummary], X,
                           mask: Optional[np.ndarray] = None) -> None:
    """Feed a (n, d) batch into d per-feature sketches. `mask`, if given,
    selects which entries count (the Imputer skips NaN/missing values)."""
    X = np.asarray(X, dtype=np.float64)
    if X.ndim == 1:
        X = X[:, None]
    for j, sketch in enumerate(sketches):
        col = X[:, j]
        if mask is not None:
            col = col[mask[:, j]]
        sketch.insert_batch(col)
