"""Columnar Table: the data plane of the port.

Port of the bounded half of flink_ml_tpu/table.py. A Table is a dict of
named columns. Numeric columns are (n,) or (n, d) numpy arrays or torch
tensors; a tensor column stays on the device it lives on, and stages
return their outputs there (device in, device out). A SparseBatch holds
padded-CSR rows: (n, k) int32 indices with -1 padding and (n, k) values.

A StreamTable is an iterable of bounded Tables, the input of the online
and out-of-core fits. A DictTokenMatrix is a dictionary-encoded token
column: a host vocabulary and an (n, k) int32 id matrix, a tensor on the
card or a numpy array, -1 marking an absent token. A token column may also
be a 2-D unicode numpy matrix (one row per token array) or an object
column of token lists.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .linalg import DenseVector, SparseVector, Vector

__all__ = ["Table", "SparseBatch", "StreamTable", "DictTokenMatrix", "as_dense_matrix",
           "as_sparse_batch", "global_batches", "rows_to_sparse_batch"]


class DictTokenMatrix:
    """Dictionary-encoded token-array column (flink_ml_tpu/table.py:68-118):
    a host unicode `vocab` and an (n, k) integer `ids` matrix, a tensor on
    its device or a numpy array. id -1 is the absent token, so rows may be
    ragged (StopWordsRemover emits it). The string stages compute on the id
    matrix and touch the strings only through the vocabulary."""

    __slots__ = ("vocab", "ids")

    def __init__(self, vocab, ids):
        self.vocab = np.asarray(vocab)
        self.ids = ids

    @property
    def n(self) -> int:
        return int(self.ids.shape[0])

    @property
    def k(self) -> int:
        return int(self.ids.shape[1])

    def __len__(self):
        return self.n

    def host_ids(self) -> np.ndarray:
        return _to_numpy(self.ids)

    def row(self, i: int) -> list:
        return [str(self.vocab[j]) for j in _to_numpy(self.ids[i]) if j >= 0]

    def to_object_column(self) -> np.ndarray:
        """Per-row token lists, on the host."""
        ids = self.host_ids()
        out = np.empty(ids.shape[0], dtype=object)
        for i in range(ids.shape[0]):
            out[i] = [str(self.vocab[j]) for j in ids[i] if j >= 0]
        return out

    def __repr__(self):
        return f"DictTokenMatrix(n={self.n}, k={self.k}, vocab={len(self.vocab)})"


class SparseBatch:
    """Padded-CSR batch of sparse vectors.

    `indices`: (n, k) int32, padding entries = -1; `values`: (n, k) float.
    Host arrays are normalized to int32/float64 numpy; torch tensors are
    kept as they are, on their device."""

    __slots__ = ("size", "indices", "values")

    def __init__(self, size: int, indices, values):
        self.size = int(size)
        if isinstance(indices, torch.Tensor) or isinstance(values, torch.Tensor):
            if not (isinstance(indices, torch.Tensor) and isinstance(values, torch.Tensor)):
                raise TypeError("SparseBatch indices and values must both be tensors or both host arrays")
            if indices.device != values.device:
                raise ValueError("SparseBatch indices and values must share a device")
            self.indices = indices
            self.values = values
        else:
            self.indices = np.asarray(indices, dtype=np.int32)
            self.values = np.asarray(values, dtype=np.float64)
        if tuple(self.indices.shape) != tuple(self.values.shape) or self.indices.ndim != 2:
            raise ValueError("SparseBatch requires matching (n, k) indices/values")

    @property
    def n(self) -> int:
        return int(self.indices.shape[0])

    def to_dense(self) -> np.ndarray:
        indices, values = _to_numpy(self.indices), _to_numpy(self.values)
        out = np.zeros((self.n, self.size), dtype=np.float64)
        rows, cols = np.nonzero(indices >= 0)
        out[rows, indices[rows, cols]] = values[rows, cols]
        return out

    def row(self, i: int) -> SparseVector:
        indices, values = _to_numpy(self.indices[i]), _to_numpy(self.values[i])
        mask = indices >= 0
        return SparseVector(self.size, indices[mask], values[mask])

    def __len__(self):
        return self.n


class StreamTable:
    """An unbounded table: an iterable of bounded mini-batch Tables.

    The input of the online estimators and of the out-of-core fits (the
    reference's unbounded DataStream, OnlineKMeans.java:44-60). A
    StreamTable over a one-shot iterable may be iterated once; one made by
    `from_batches` holds a list and replays."""

    def __init__(self, batches: Iterable[Table]):
        self._batches = batches

    def __iter__(self) -> Iterator[Table]:
        return iter(self._batches)

    @staticmethod
    def from_batches(batches: Sequence[Table]) -> "StreamTable":
        return StreamTable(list(batches))


def global_batches(stream, columns: Sequence[Callable], batch_size: int) -> Iterator[tuple]:
    """Exact global batches of `batch_size` rows, in arrival order (the
    reference's countWindowAll); rows left at the end of the stream are
    dropped. `columns` map a Table to one array each; a batch holds, per
    column, the list of row slices of the incoming Tables that make it up,
    so no batch is concatenated on the host (the stager copies the slices
    into one buffer)."""
    pieces: List[List] = [[] for _ in columns]
    buffered = 0
    for table in stream:
        arrays = [column(table) for column in columns]
        n, off = len(arrays[0]), 0
        while off < n:
            take = min(batch_size - buffered, n - off)
            for parts, array in zip(pieces, arrays):
                parts.append(array[off:off + take])
            buffered += take
            off += take
            if buffered == batch_size:
                yield tuple(pieces)
                pieces, buffered = [[] for _ in columns], 0


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _normalize_column(values: Any):
    """Normalize a user-provided column into an internal representation."""
    if isinstance(values, (np.ndarray, SparseBatch, DictTokenMatrix, torch.Tensor)):
        return values
    values = list(values)
    if values and isinstance(values[0], Vector):
        if all(isinstance(v, DenseVector) for v in values):
            if len({v.size() for v in values}) == 1:
                return np.stack([v.values for v in values])
        if all(isinstance(v, SparseVector) for v in values):
            return _sparse_vectors_to_batch(values)
        return _object_array(values)
    try:
        arr = np.asarray(values)
    except (ValueError, TypeError):
        return _object_array(values)
    if arr.dtype == object or arr.dtype.kind in "US" or arr.shape[:1] != (len(values),):
        return _object_array(values)
    return arr


def _object_array(values: Sequence) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def _sparse_vectors_to_batch(vectors: Sequence[SparseVector]) -> SparseBatch:
    size = max((v.size() for v in vectors), default=0)
    k = max((v.indices.size for v in vectors), default=1) or 1
    indices = np.full((len(vectors), k), -1, dtype=np.int32)
    values = np.zeros((len(vectors), k), dtype=np.float64)
    for i, v in enumerate(vectors):
        indices[i, : v.indices.size] = v.indices
        values[i, : v.indices.size] = v.values
    return SparseBatch(size, indices, values)


def rows_to_sparse_batch(size: int, row_indices, row_values) -> SparseBatch:
    """Per-row (indices, values) lists as a host SparseBatch, as wide as
    its widest row (at least one slot)."""
    n = len(row_indices)
    width = max((len(ia) for ia in row_indices), default=0) or 1
    indices = np.full((n, width), -1, dtype=np.int32)
    values = np.zeros((n, width), dtype=np.float64)
    for i, (ia, va) in enumerate(zip(row_indices, row_values)):
        indices[i, : len(ia)] = ia
        values[i, : len(va)] = va
    return SparseBatch(size, indices, values)


def _is_unicode_matrix(col) -> bool:
    return isinstance(col, np.ndarray) and col.ndim == 2 and col.dtype.kind in "US"


def _is_token_col(col) -> bool:
    return isinstance(col, DictTokenMatrix) or _is_unicode_matrix(col)


def _as_dict_tokens(col) -> DictTokenMatrix:
    """A token column of any layout as a DictTokenMatrix."""
    if isinstance(col, DictTokenMatrix):
        return col
    A = np.asarray(col)
    if _is_unicode_matrix(A):
        uniq, inv = np.unique(A, return_inverse=True)
        return DictTokenMatrix(uniq, inv.reshape(A.shape).astype(np.int32))
    if A.ndim == 1 and A.dtype == object:
        rows = [[str(t) for t in r] for r in A]
        vocab = np.unique(np.asarray(sorted({t for r in rows for t in r}) or [""]))
        index = {t: i for i, t in enumerate(vocab)}
        k = max((len(r) for r in rows), default=1) or 1
        ids = np.full((len(rows), k), -1, np.int32)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = [index[t] for t in r]
        return DictTokenMatrix(vocab, ids)
    raise ValueError(
        f"Cannot concatenate token column with incompatible column {type(col).__name__}")


def _concat_token_columns(a, b) -> DictTokenMatrix:
    """Two token columns of any layouts as one DictTokenMatrix: the union
    of the vocabularies, each side's ids remapped on the host, the narrower
    side padded with -1. The ids go to the device of a tensor side."""
    da, db = _as_dict_tokens(a), _as_dict_tokens(b)
    vocab = np.union1d(da.vocab.astype(str), db.vocab.astype(str))

    def remap(d: DictTokenMatrix) -> np.ndarray:
        lut = np.searchsorted(vocab, d.vocab.astype(str)).astype(np.int32)
        ids = d.host_ids()
        return np.where(ids >= 0, lut[np.where(ids >= 0, ids, 0)], -1).astype(np.int32)

    ia, ib = remap(da), remap(db)
    k = max(ia.shape[1], ib.shape[1])
    ids = np.concatenate([np.pad(i, ((0, 0), (0, k - i.shape[1])), constant_values=-1)
                          for i in (ia, ib)])
    tensors = [d.ids for d in (da, db) if isinstance(d.ids, torch.Tensor)]
    if tensors:
        ids = torch.as_tensor(ids, device=tensors[0].device)
    return DictTokenMatrix(vocab, ids)


class Table:
    """A bounded, named-column table."""

    def __init__(self, data: Dict[str, Any]):
        self._columns: Dict[str, Any] = {}
        n = None
        for name, values in data.items():
            col = _normalize_column(values)
            rows = (len(col) if isinstance(col, (SparseBatch, DictTokenMatrix))
                    else int(col.shape[0]))
            if n is None:
                n = rows
            elif rows != n:
                raise ValueError(f"Column {name} has {rows} rows, expected {n}")
            self._columns[name] = col
        self._num_rows = n or 0

    @staticmethod
    def from_dict(data: Dict[str, Any]) -> "Table":
        return Table(data)

    @staticmethod
    def from_rows(rows: Sequence[Sequence], names: Sequence[str]) -> "Table":
        cols: Dict[str, List] = {name: [] for name in names}
        for row in rows:
            for name, value in zip(names, row):
                cols[name].append(value)
        return Table(cols)

    @property
    def column_names(self) -> List[str]:
        return list(self._columns)

    @property
    def num_rows(self) -> int:
        return self._num_rows

    def column(self, name: str):
        if name not in self._columns:
            raise KeyError(f"Column {name!r} not in table (have {self.column_names})")
        return self._columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self._columns

    def __len__(self) -> int:
        return self._num_rows

    def with_column(self, name: str, values) -> "Table":
        return self.with_columns({name: values})

    def with_columns(self, updates: Dict[str, Any]) -> "Table":
        data = dict(self._columns)
        data.update(updates)
        return Table(data)

    def select(self, *names: str) -> "Table":
        """The named columns, in that order; the column objects are shared."""
        return Table({name: self.column(name) for name in names})

    def drop(self, *names: str) -> "Table":
        return Table({k: v for k, v in self._columns.items() if k not in names})

    def rename(self, mapping: Dict[str, str]) -> "Table":
        return Table({mapping.get(k, k): v for k, v in self._columns.items()})

    def take(self, indices) -> "Table":
        """The rows at `indices` (host integers or an integer tensor), from
        every column; tensor columns are gathered on their own device
        (`index_select`, the indices staged there once a device), so a
        device table is never read back."""
        staged: Dict[Any, Any] = {}  # the indices on each device
        out = {}
        for name, col in self._columns.items():
            if isinstance(col, SparseBatch):
                out[name] = SparseBatch(col.size, _take(col.indices, indices, staged),
                                        _take(col.values, indices, staged))
            elif isinstance(col, DictTokenMatrix):
                out[name] = DictTokenMatrix(col.vocab, _take(col.ids, indices, staged))
            else:
                out[name] = _take(col, indices, staged)
        return Table(out)

    def head(self, k: int) -> "Table":
        """The first k rows, through `take`: a device table stays on its device."""
        return self.take(np.arange(min(k, self._num_rows)))

    def concat(self, other: "Table") -> "Table":
        """The rows of `self`, then those of `other`, column by column. A
        column that is a tensor on either side is joined on that tensor's
        device (device in, device out); host columns join on the host. Sparse
        columns pad the narrower side's slots with -1. Token columns of any
        mix of layouts (but two unicode matrices of one width) join as one
        DictTokenMatrix."""
        out = {}
        for name, a in self._columns.items():
            b = other.column(name)
            if (_is_token_col(a) or _is_token_col(b)) and not (
                    _is_unicode_matrix(a) and _is_unicode_matrix(b) and a.shape[1] == b.shape[1]):
                out[name] = _concat_token_columns(a, b)
            elif isinstance(a, SparseBatch):
                if not isinstance(b, SparseBatch) or a.size != b.size:
                    raise ValueError(f"Column {name}: SparseBatch size mismatch in concat")
                k = max(a.indices.shape[1], b.indices.shape[1])
                parts = [_pad_slots(sb, k) for sb in (a, b)]
                out[name] = SparseBatch(a.size, _cat([p[0] for p in parts]),
                                        _cat([p[1] for p in parts]))
            else:
                out[name] = _cat([a, b])
        return Table(out)

    def rows(self) -> Iterator[Dict[str, Any]]:
        """Row iterator for host-side consumption (tests, collect())."""
        host = {}
        for name, col in self._columns.items():
            if isinstance(col, DictTokenMatrix):
                col = DictTokenMatrix(col.vocab, col.host_ids())
            host[name] = col if isinstance(col, (SparseBatch, DictTokenMatrix)) else _to_numpy(col)
        for i in range(self._num_rows):
            row = {}
            for name, col in host.items():
                if isinstance(col, (SparseBatch, DictTokenMatrix)):
                    row[name] = col.row(i)
                else:
                    v = col[i]
                    if isinstance(v, np.ndarray) and v.ndim == 1:
                        # a token matrix row is its token list; every other
                        # row is a DenseVector (an object row of strings raises)
                        v = v.tolist() if v.dtype.kind in "US" else DenseVector(v)
                    row[name] = v
            yield row

    def collect(self) -> List[Dict[str, Any]]:
        return list(self.rows())

    def __repr__(self):
        return f"Table(rows={self._num_rows}, columns={self.column_names})"


def _take(col, indices, staged):
    """Rows `indices` of one column; `staged` keeps the indices by device
    (None: the host) across the columns of one take."""
    device = col.device if isinstance(col, torch.Tensor) else None
    if device not in staged:
        staged[device] = (_to_numpy(indices) if device is None else
                          torch.as_tensor(indices, dtype=torch.long, device=device).reshape(-1))
    return col[staged[device]] if device is None else col.index_select(0, staged[device])


def _cat(parts):
    """Concatenate along rows: on the device of the first tensor part when
    there is one, else with numpy."""
    tensors = [p for p in parts if isinstance(p, torch.Tensor)]
    if not tensors:
        return np.concatenate(parts)
    device = tensors[0].device
    return torch.cat([torch.as_tensor(p, device=device) for p in parts])


def _pad_slots(batch: SparseBatch, k: int):
    """(indices, values) of a SparseBatch widened to k slots with -1 padding."""
    pad = k - batch.indices.shape[1]
    indices, values = batch.indices, batch.values
    if pad == 0:
        return indices, values
    if isinstance(indices, torch.Tensor):
        return (torch.nn.functional.pad(indices, (0, pad), value=-1),
                torch.nn.functional.pad(values, (0, pad)))
    return (np.pad(indices, ((0, 0), (0, pad)), constant_values=-1),
            np.pad(values, ((0, 0), (0, pad))))


def _densify_on_device(batch: SparseBatch) -> torch.Tensor:
    """A tensor SparseBatch as a dense (n, size) tensor on its device, with
    no host sync: padding (and any index out of [0, size)) scatters a zero
    into a spare last column, which is cut off."""
    idx, vals = batch.indices, batch.values
    keep = (idx >= 0) & (idx < batch.size)
    slot = torch.where(keep, idx, batch.size).long()
    out = torch.zeros((batch.n, batch.size + 1), dtype=vals.dtype, device=vals.device)
    out.scatter_(1, slot, torch.where(keep, vals, 0.0))
    return out[:, : batch.size].contiguous()


def as_dense_matrix(col, allow_device: bool = False):
    """Coerce a features column to a dense (n, d) float matrix. float32
    host input stays float32. With `allow_device`, a torch tensor column is
    returned as a tensor on its own device (1-D becomes (n, 1)), and a
    tensor SparseBatch is densified there; without it, the column is copied
    to a host numpy array."""
    if isinstance(col, SparseBatch):
        if allow_device and isinstance(col.indices, torch.Tensor):
            return _densify_on_device(col)
        return col.to_dense()
    if isinstance(col, torch.Tensor):
        if allow_device:
            return col if col.ndim > 1 else col[:, None]
        col = _to_numpy(col)
    arr = col
    if isinstance(arr, np.ndarray) and arr.dtype == object:
        rows = [
            np.asarray(v.to_array() if isinstance(v, Vector) else v, dtype=np.float64)
            for v in arr
        ]
        return np.stack(rows) if rows else np.zeros((0, 0), dtype=np.float64)
    arr = np.asarray(arr)
    if arr.dtype not in (np.float32, np.float64):
        arr = arr.astype(np.float64)
    if arr.ndim == 1:
        arr = arr[:, None]
    return arr


def as_sparse_batch(col, size: Optional[int] = None) -> SparseBatch:
    """A features column as a SparseBatch: a SparseBatch as it is, an object
    column of vectors through `to_sparse`, a dense (n, d) column with every
    index 0..d-1 in every row (zeros included) and `size` (default d). A
    tensor column stays on its device."""
    if isinstance(col, SparseBatch):
        return col
    if isinstance(col, np.ndarray) and col.dtype == object:
        return _sparse_vectors_to_batch([v.to_sparse() for v in col])
    dense = as_dense_matrix(col, allow_device=True)
    n, d = dense.shape
    if isinstance(dense, torch.Tensor):
        indices = torch.arange(d, dtype=torch.int32, device=dense.device).expand(n, d)
    else:
        indices = np.tile(np.arange(d, dtype=np.int32), (n, 1))
    return SparseBatch(size or d, indices, dense)
