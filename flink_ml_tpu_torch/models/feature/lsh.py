"""MinHashLSH — locality-sensitive hashing for the Jaccard distance.

Port of flink_ml_tpu/models/feature/lsh.py (the reference's feature/lsh/:
LSH.java, LSHModel.java:99-258, MinHashLSH.java, MinHashLSHModelData.java).
The model data is numHashTables x numHashFunctionsPerTable random affine
coefficients drawn with java.util.Random's sequence (`utils/javarandom.py`,
a then b for each function), so a seed gives the reference's model. A row's
hash is, for each function, min over its indices of
((1 + index) * a + b) % HASH_PRIME; only the indices count, not the values.

- The min-hash runs on the device in int64, in chunks of rows whose
  (rows, slots, functions) products fit `HASH_CHUNK_BYTES`: the product
  stays below 2^62 and % of a non-negative int64 is exact, so the hashes
  equal the JAX package's int64 numpy values.
- The transform's output column keeps the JAX layout: an object column of
  per-row lists of numHashTables float64 arrays.
- `approx_nearest_neighbors` compares the hashes with the key's on the
  device, then takes the Jaccard distances of the candidates on the host
  (float64, as Python sets give them) in the JAX package's stable order;
  `approx_similarity_join` joins same buckets on the host as the JAX
  package does.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ... import config
from ...api import Estimator, Model
from ...common.param import HasInputCol, HasOutputCol, HasSeed
from ...parallel.prefetch import to_device
from ...param import IntParam, ParamValidators
from ...table import SparseBatch, Table, _to_numpy, as_sparse_batch
from ...utils import javacodec, read_write
from ...utils.javarandom import JavaRandom
from ...utils.param_utils import update_existing_params

HASH_PRIME = 2038074743  # MinHashLSHModelData.java HASH_PRIME
#: bytes one chunk's (rows, slots, functions) int64 hash products may take
HASH_CHUNK_BYTES = 256 << 20


class LSHParams(HasInputCol, HasOutputCol):
    NUM_HASH_TABLES = IntParam(
        "numHashTables", "Number of hash tables.", 1, ParamValidators.gt_eq(1)
    )
    NUM_HASH_FUNCTIONS_PER_TABLE = IntParam(
        "numHashFunctionsPerTable",
        "Number of hash functions per hash table.",
        1,
        ParamValidators.gt_eq(1),
    )

    def get_num_hash_tables(self) -> int:
        return self.get(self.NUM_HASH_TABLES)

    def set_num_hash_tables(self, value: int):
        return self.set(self.NUM_HASH_TABLES, value)

    def get_num_hash_functions_per_table(self) -> int:
        return self.get(self.NUM_HASH_FUNCTIONS_PER_TABLE)

    def set_num_hash_functions_per_table(self, value: int):
        return self.set(self.NUM_HASH_FUNCTIONS_PER_TABLE, value)


class MinHashLSHParams(LSHParams, HasSeed):
    pass


def min_hash(indices, coeff_a: np.ndarray, coeff_b: np.ndarray, device=None) -> torch.Tensor:
    """(n, k) indices (-1 absent) -> (n, h) int64 min-hash values on the
    indices' device (a host array is staged to `device`, else to
    `config.device()`); a row of only padding gives HASH_PRIME."""
    if not isinstance(indices, torch.Tensor):
        indices = to_device(np.asarray(indices),
                            device if device is not None else config.device())
    dev = indices.device
    a = to_device(np.asarray(coeff_a, dtype=np.int64), dev)
    b = to_device(np.asarray(coeff_b, dtype=np.int64), dev)
    n, k = indices.shape
    out = torch.empty((n, a.numel()), dtype=torch.int64, device=dev)
    step = max(1, HASH_CHUNK_BYTES // (8 * max(k, 1) * max(a.numel(), 1)))
    for r0 in range(0, n, step):
        idx = indices[r0: r0 + step].long()[:, :, None]
        vals = ((1 + idx) * a + b) % HASH_PRIME
        out[r0: r0 + step] = torch.where(idx >= 0, vals, HASH_PRIME).amin(dim=1)
    return out


def _jaccard_distance(a_indices: np.ndarray, b_indices: np.ndarray) -> float:
    a = set(int(i) for i in a_indices)
    b = set(int(i) for i in b_indices)
    union = len(a | b)
    if union == 0:
        raise ValueError("The union of two input sets must have at least 1 elements")
    return 1.0 - len(a & b) / union


def _row_indices(indices: np.ndarray, i: int) -> np.ndarray:
    row = indices[i]
    return row[row >= 0]


class MinHashLSHModel(Model, LSHParams):
    fusable = False
    fusable_reason = "emits a per-row list of hash vectors (object column) — not a fixed-shape device array"

    def __init__(self):
        self.rand_coefficient_a: np.ndarray = None  # (numHashFunctions,) int64
        self.rand_coefficient_b: np.ndarray = None

    def set_model_data(self, *inputs: Table) -> "MinHashLSHModel":
        (model_data,) = inputs
        row = model_data.collect()[0]
        self.rand_coefficient_a = np.asarray(row["randCoefficientA"], dtype=np.int64)
        self.rand_coefficient_b = np.asarray(row["randCoefficientB"], dtype=np.int64)
        return self

    def get_model_data(self) -> List[Table]:
        return [Table({"randCoefficientA": [self.rand_coefficient_a.tolist()],
                       "randCoefficientB": [self.rand_coefficient_b.tolist()]})]

    def _hash(self, batch: SparseBatch) -> torch.Tensor:
        """(n, numHashTables * numHashFunctionsPerTable) int64 hashes on the
        device."""
        return min_hash(batch.indices, self.rand_coefficient_a, self.rand_coefficient_b)

    def _shape(self, hashes: torch.Tensor) -> torch.Tensor:
        return hashes.reshape(hashes.shape[0], self.get_num_hash_tables(),
                              self.get_num_hash_functions_per_table())

    def transform(self, *inputs: Table) -> List[Table]:
        config.device()  # an entry point: no silent CPU without a request
        (table,) = inputs
        batch = as_sparse_batch(table.column(self.get_input_col()))
        present = (batch.indices >= 0).sum(1)
        if bool((present == 0).any()):
            raise ValueError("Must have at least 1 non zero entry.")
        nt = self.get_num_hash_tables()
        # tpulint: disable=host-sync-leak -- the hashes' one readback: the output is host vectors
        rows = list(_to_numpy(self._hash(batch)).astype(np.float64).reshape(
            batch.n * nt, self.get_num_hash_functions_per_table()))
        out = np.empty(batch.n, dtype=object)
        out[:] = [rows[i: i + nt] for i in range(0, len(rows), nt)]
        return [table.with_columns({self.get_output_col(): out})]

    def approx_nearest_neighbors(self, dataset: Table, key, k: int,
                                 dist_col: str = "distCol") -> Table:
        """The (at most) k rows of `dataset` nearest `key` among those that
        share a whole hash table's bucket with it, nearest first, with
        their Jaccard distances in `dist_col` (LSHModel.java:137)."""
        config.device()
        batch = as_sparse_batch(dataset.column(self.get_input_col()))
        hashes = self._hash(batch)
        key_sparse = key.to_sparse()
        key_hash = min_hash(key_sparse.indices[None, :], self.rand_coefficient_a,
                            self.rand_coefficient_b, device=hashes.device)
        same = (self._shape(hashes) == self._shape(key_hash)).all(dim=2).any(dim=1)
        candidates = _to_numpy(torch.nonzero(same).flatten())
        idx = batch.indices
        rows = (_to_numpy(idx[to_device(candidates, idx.device)])
                if isinstance(idx, torch.Tensor) else idx[candidates])
        dists = [_jaccard_distance(_row_indices(rows, r), key_sparse.indices)
                 for r in range(candidates.size)]
        order = np.argsort(dists, kind="stable")[:k]
        result = dataset.take(candidates[order])
        return result.with_columns({dist_col: np.asarray(dists, dtype=np.float64)[order]})

    def approx_similarity_join(self, table_a: Table, table_b: Table, threshold: float,
                               id_col: str, dist_col: str = "distCol") -> Table:
        """The pairs (a row of each table) that share a hash table's bucket
        and whose Jaccard distance is at most `threshold`, in (row of A,
        row of B) order, with both ids and the distance
        (LSHModel.java:199)."""
        config.device()
        batch_a = as_sparse_batch(table_a.column(self.get_input_col()))
        batch_b = as_sparse_batch(table_b.column(self.get_input_col()))
        ha = _to_numpy(self._shape(self._hash(batch_a)))
        hb = _to_numpy(self._shape(self._hash(batch_b)))
        ids_a, ids_b = _to_numpy(table_a.column(id_col)), _to_numpy(table_b.column(id_col))
        pairs = set()
        buckets = {}
        for i in range(batch_a.n):
            for t in range(ha.shape[1]):
                buckets.setdefault((t, tuple(ha[i, t])), []).append(i)
        for j in range(batch_b.n):
            for t in range(hb.shape[1]):
                for i in buckets.get((t, tuple(hb[j, t])), ()):
                    pairs.add((i, j))
        idx_a, idx_b = _to_numpy(batch_a.indices), _to_numpy(batch_b.indices)
        rows = []
        for i, j in sorted(pairs):
            d = _jaccard_distance(_row_indices(idx_a, i), _row_indices(idx_b, j))
            if d <= threshold:
                rows.append((ids_a[i], ids_b[j], d))
        return Table({f"{id_col}A": [r[0] for r in rows], f"{id_col}B": [r[1] for r in rows],
                      dist_col: [r[2] for r in rows]})

    def _save_extra(self, path: str) -> None:
        read_write.save_model_arrays(path, randCoefficientA=self.rand_coefficient_a,
                                     randCoefficientB=self.rand_coefficient_b)

    def _load_extra(self, path: str) -> None:
        arrays = read_write.load_arrays_or_reference(path, javacodec.load_reference_minhashlsh)
        self.rand_coefficient_a = arrays["randCoefficientA"]
        self.rand_coefficient_b = arrays["randCoefficientB"]


def draw_coefficients(seed: int, num_fns: int):
    """(a, b) int64 coefficients in MinHashLSHModelData.generateModelData's
    order of draws from one java.util.Random: a[i] then b[i]."""
    rng = JavaRandom(seed)
    a = np.empty(num_fns, dtype=np.int64)
    b = np.empty(num_fns, dtype=np.int64)
    for i in range(num_fns):
        a[i] = 1 + rng.next_int(HASH_PRIME - 1)
        b[i] = rng.next_int(HASH_PRIME - 1)
    return a, b


class MinHashLSH(Estimator, MinHashLSHParams):

    checkpointable = False
    checkpoint_reason = (
        "fit only derives seeded hash coefficients; deterministic "
        "recompute on restart"
    )

    def fit(self, *inputs: Table) -> MinHashLSHModel:
        config.device()  # an entry point: no silent CPU without a request
        (table,) = inputs
        batch = as_sparse_batch(table.column(self.get_input_col()))
        if batch.size > HASH_PRIME:
            raise ValueError(
                f"The input vector dimension {batch.size} exceeds the threshold {HASH_PRIME}."
            )
        model = MinHashLSHModel()
        model.rand_coefficient_a, model.rand_coefficient_b = draw_coefficients(
            self.get_seed(),
            self.get_num_hash_tables() * self.get_num_hash_functions_per_table())
        update_existing_params(model, self)
        return model
