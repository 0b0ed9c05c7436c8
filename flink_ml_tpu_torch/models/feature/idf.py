"""IDF: inverse document frequency weighting.

Port of flink_ml_tpu/models/feature/idf.py (the reference's IDF.java:
idf = log((m + 1) / (df(t) + 1)), a term in fewer than minDocFreq
documents gets 0; IDFModel.java multiplies each feature by its idf).

The fit counts each feature's documents (its non-zero entries) and the
model keeps float64 idf from the same float64 formula as the JAX package:
a tensor SparseBatch is counted on its device with one `bincount` (the
JAX package pulls the indices to the host and adds with `np.add.at`; the
counts are integers, so they are equal), a host one with `np.add.at`, a
dense column on its device. The transform follows each JAX path's
precision: a tensor column (dense or sparse) times the idf in float32,
`float32(v) * float32(idf)` (the JAX device path with x64 off); a host
column times the float64 idf. Dense columns run the transform kernel (a
host column staged in float64); a SparseBatch, which the kernel does not
take, keeps its layout in a branch of its own.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ... import config
from ...api import Estimator, Model, as_kernel_matrix
from ...common.param import HasInputCol, HasOutputCol
from ...linalg import DenseVector
from ...parallel.prefetch import to_device
from ...param import IntParam, ParamValidators
from ...table import SparseBatch, Table
from ...utils import javacodec, read_write
from ...utils.param_utils import update_existing_params
from .. import _linear
from . import _columns


class IDFModelParams(HasInputCol, HasOutputCol):
    pass


class IDFParams(IDFModelParams):
    MIN_DOC_FREQ = IntParam(
        "minDocFreq",
        "Minimum number of documents that a term should appear for filtering.",
        0,
        ParamValidators.gt_eq(0),
    )

    def get_min_doc_freq(self) -> int:
        return self.get(self.MIN_DOC_FREQ)

    def set_min_doc_freq(self, value: int):
        return self.set(self.MIN_DOC_FREQ, value)


def sparse_doc_freq(col: SparseBatch) -> np.ndarray:
    """Each feature's count of rows with a non-zero entry, float64."""
    if not _linear.is_device_column(col):
        df = np.zeros(col.size, dtype=np.float64)
        np.add.at(df, col.indices[(col.indices >= 0) & (col.values != 0)], 1.0)
        return df
    present = (col.indices >= 0) & (col.values != 0)
    slots = torch.where(present, col.indices, col.size).reshape(-1).long()
    counts = torch.bincount(slots, minlength=col.size + 1)
    if counts.numel() > col.size + 1:
        raise IndexError(f"a sparse index is not below the batch size {col.size}")
    return counts[:col.size].cpu().numpy().astype(np.float64)


class IDFModel(Model, IDFModelParams):
    fusable = True

    def __init__(self):
        self.idf: np.ndarray = None
        self.doc_freq: np.ndarray = None
        self.num_docs: int = 0

    def _constant_sources(self):
        return (self.idf,)

    def _kernel_constants(self):
        return {"idf": self.idf}

    def transform_kernel(self, consts, cols, ctx):
        X = as_kernel_matrix(cols[self.get_input_col()])
        cols[self.get_output_col()] = X * consts["idf"].to(X.dtype)[None, :]
        return cols

    def set_model_data(self, *inputs: Table) -> "IDFModel":
        (model_data,) = inputs
        row = model_data.collect()[0]
        self.idf = np.asarray(row["idf"].to_array(), dtype=np.float64)
        self.doc_freq = np.asarray(row["docFreq"].to_array(), dtype=np.float64)
        self.num_docs = int(row["numDocs"])
        return self

    def get_model_data(self) -> List[Table]:
        return [Table({"idf": [DenseVector(self.idf)], "docFreq": [DenseVector(self.doc_freq)],
                       "numDocs": [self.num_docs]})]

    def transform(self, *inputs: Table) -> List[Table]:
        config.device()  # an entry point: no silent CPU without a request
        (table,) = inputs
        col = table.column(self.get_input_col())
        if not isinstance(col, SparseBatch):
            return [self._transform_with_kernel(
                table, lambda c: _columns.staged_matrix(c, torch.float64))]
        # a SparseBatch keeps its layout, which the kernel does not take
        if _linear.is_device_column(col):
            idf = to_device(self.idf, col.values.device, torch.float32)
            valid = col.indices >= 0
            gathered = torch.where(valid, idf[torch.where(valid, col.indices, 0).long()], 0.0)
            out = SparseBatch(col.size, col.indices.clone(), col.values * gathered.to(col.values.dtype))
        else:
            gathered = np.where(col.indices >= 0, self.idf[np.clip(col.indices, 0, None)], 0.0)
            out = SparseBatch(col.size, col.indices.copy(), col.values * gathered)
        return [table.with_columns({self.get_output_col(): out})]

    def _save_extra(self, path: str) -> None:
        read_write.save_model_arrays(path, idf=self.idf, docFreq=self.doc_freq,
                                     numDocs=np.int64(self.num_docs))

    def _load_extra(self, path: str) -> None:
        arrays = read_write.load_arrays_or_reference(path, javacodec.load_reference_idf)
        self.idf = arrays["idf"]
        self.doc_freq = arrays["docFreq"]
        self.num_docs = int(arrays["numDocs"])


class IDF(Estimator, IDFParams):

    checkpointable = False
    checkpoint_reason = "single-pass document-frequency count; a restart recomputes the fit"

    def fit(self, *inputs: Table) -> IDFModel:
        config.device()  # an entry point: no silent CPU without a request
        (table,) = inputs
        col = table.column(self.get_input_col())
        if isinstance(col, SparseBatch):
            df, n_docs = sparse_doc_freq(col), col.n
        else:
            X = _columns.staged_matrix(col)
            # tpulint: disable=host-sync-leak -- the fit's one readback (a host idf)
            df, n_docs = (X != 0).sum(dim=0).cpu().numpy().astype(np.float64), X.shape[0]
        idf = np.where(df >= self.get_min_doc_freq(), np.log((n_docs + 1.0) / (df + 1.0)), 0.0)
        model = IDFModel()
        model.idf = idf
        model.doc_freq = df
        model.num_docs = n_docs
        update_existing_params(model, self)
        return model
