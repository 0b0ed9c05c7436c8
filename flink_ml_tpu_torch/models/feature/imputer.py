"""Imputer: fills missing values with the mean, median or most frequent value.

Port of flink_ml_tpu/models/feature/imputer.py (the reference's
Imputer.java, its MeanStrategy / MedianStrategy / MostFrequentStrategy
aggregators, and ImputerModel.java). The fit computes one surrogate per
column from its valid entries, those neither NaN nor `missingValue`; a
column with none raises. The transform replaces `missingValue` only.

A tensor column's surrogate is computed on its device in its dtype, as
the JAX device path computes it: the mean as (sum, count), divided on the
host in float64; the median and the mode from one sort that pushes the
invalid entries to +inf, so the valid ones are a dense prefix: the median
is (lo + hi) * 0.5 of the middle pair, the mode the first longest run
(the smallest of the most frequent values), its length found by a binary
search of the sorted column. All surrogates come back in
one readback. A host column's surrogate follows the JAX host path in
float64 numpy terms, computed on the device in float64 (np.mean's
pairwise sum is matched to a float64 rounding, not bit for bit).

A `StreamTable` fits on the host as the JAX package does: a running
(sum, count) for mean, a Greenwald-Khanna sketch per column at
`relativeError` for median, value counts for most_frequent.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from ... import config
from ...api import Estimator, Model, column_dtype
from ...common.param import HasInputCols, HasMissingValue, HasOutputCols, HasRelativeError
from ...common.quantilesummary import QuantileSummary
from ...linalg import DenseVector
from ...parallel.prefetch import to_device
from ...param import ParamValidators, StringParam
from ...table import StreamTable, Table
from ...utils import javacodec, read_write
from ...utils.param_utils import update_existing_params
from .. import _linear
from . import _columns

MEAN = "mean"
MEDIAN = "median"
MOST_FREQUENT = "most_frequent"


def _missing_mask(arr: torch.Tensor, missing: float) -> torch.Tensor:
    """The entries the fit leaves out: NaN, and `missing` itself."""
    if math.isnan(missing):
        return torch.isnan(arr)
    return (arr == missing) | torch.isnan(arr)


def surrogate(arr: torch.Tensor, missing: float, strategy: str) -> torch.Tensor:
    """One column's surrogate as (numerator, denominator) in arr's dtype:
    mean -> (sum, count); median and most_frequent -> (value, 1). A column
    with no valid entry gives a zero count (mean) or +inf (the others)."""
    valid = ~_missing_mask(arr, missing)
    count = valid.sum()
    if strategy == MEAN:
        return torch.stack([torch.where(valid, arr, 0).sum(), count.to(arr.dtype)])
    one = torch.ones((), dtype=arr.dtype, device=arr.device)
    S = torch.sort(torch.where(valid, arr, math.inf)).values
    if strategy == MEDIAN:
        lo = S[torch.clamp((count - 1) // 2, min=0)]
        hi = S[torch.clamp(count // 2, min=0)]
        return torch.stack([(lo + hi) * 0.5, one])
    # most_frequent: run lengths over the sorted valid prefix, each run
    # ending where a binary search for its value past the run lands (the
    # JAX package finds the next run start with a reversed cummin instead,
    # the same lengths); the first longest run is the smallest of the most
    # frequent values
    n = S.shape[0]
    idx = torch.arange(n, device=arr.device)
    first = torch.ones(n, dtype=torch.bool, device=arr.device)
    first[1:] = S[1:] != S[:-1]
    first &= idx < count
    run_end = torch.minimum(torch.searchsorted(S, S, right=True), count)
    runlen = torch.where(first, run_end - idx, 0)
    return torch.stack([S[torch.argmax(runlen)], one])


def _host_surrogate(arr: torch.Tensor, missing: float, strategy: str) -> torch.Tensor:
    """(value, valid count) of a host column staged in float64, in numpy's
    terms: np.mean, np.median, and the smallest of np.unique's most
    frequent values."""
    valid = arr[~_missing_mask(arr, missing)]
    count = to_device(float(valid.numel()), arr.device, arr.dtype)
    if valid.numel() == 0:
        return torch.stack([torch.zeros((), dtype=arr.dtype, device=arr.device), count])
    if strategy == MEAN:
        value = valid.mean()
    elif strategy == MEDIAN:
        S = torch.sort(valid).values
        k = valid.numel()
        value = S[(k - 1) // 2] if k % 2 else (S[k // 2 - 1] + S[k // 2]) / 2
    else:
        values, counts = torch.unique(valid, sorted=True, return_counts=True)
        value = values[torch.argmax(counts)]
    return torch.stack([value, count])


def _impute(arr: torch.Tensor, missing: float, fill: torch.Tensor) -> torch.Tensor:
    """`arr` with `fill` where it holds the missing value: only that value is
    replaced at transform time (ImputerModel.java:159); the fit always
    leaves NaN out."""
    mask = torch.isnan(arr) if math.isnan(missing) else arr == missing
    return torch.where(mask, fill, arr)


class ImputerModelParams(HasInputCols, HasOutputCols, HasMissingValue):
    pass


class ImputerParams(ImputerModelParams, HasRelativeError):
    STRATEGY = StringParam(
        "strategy",
        "The imputation strategy.",
        MEAN,
        ParamValidators.in_array([MEAN, MEDIAN, MOST_FREQUENT]),
    )

    def get_strategy(self) -> str:
        return self.get(self.STRATEGY)

    def set_strategy(self, value: str):
        return self.set(self.STRATEGY, value)


class ImputerModel(Model, ImputerModelParams):
    fusable = True

    def __init__(self):
        self.surrogates: Dict[str, float] = None

    def _constant_sources(self):
        return (self.surrogates,)

    def _kernel_constants(self):
        return {"surrogates": [np.asarray(self.surrogates[name]) for name in self.get_input_cols()]}

    def kernel_output_dtypes(self, cols):
        return {out: column_dtype(cols[name])
                for name, out in zip(self.get_input_cols(), self.get_output_cols())}

    def transform_kernel(self, consts, cols, ctx):
        missing = float(self.get_missing_value())
        for i, (name, out_name) in enumerate(zip(self.get_input_cols(), self.get_output_cols())):
            arr = cols[name]
            cols[out_name] = _impute(arr, missing, consts["surrogates"][i].to(arr.dtype))
        return cols

    def set_model_data(self, *inputs: Table) -> "ImputerModel":
        (model_data,) = inputs
        row = model_data.collect()[0]
        self.surrogates = {k: float(v) for k, v in zip(row["columnNames"], row["values"])}
        return self

    def get_model_data(self) -> List[Table]:
        names = list(self.surrogates)
        return [Table({"columnNames": [names],
                       "values": [DenseVector([self.surrogates[k] for k in names])]})]

    def transform(self, *inputs: Table) -> List[Table]:
        (table,) = inputs
        return [self._transform_with_kernel(table, _columns.staged_numbers)]

    def _save_extra(self, path: str) -> None:
        names = list(self.surrogates)
        read_write.save_model_arrays(
            path,
            columnNames=np.asarray(names, dtype=object),
            values=np.asarray([self.surrogates[k] for k in names]),
        )

    def _load_extra(self, path: str) -> None:
        arrays = read_write.load_arrays_or_reference(
            path, javacodec.load_reference_imputer, allow_pickle=True)
        self.surrogates = {str(k): float(v) for k, v in zip(arrays["columnNames"], arrays["values"])}


class Imputer(Estimator, ImputerParams):

    checkpointable = False
    checkpoint_reason = "single-pass surrogate aggregation; a restart recomputes the fit"

    def fit(self, *inputs: Table) -> ImputerModel:
        (table,) = inputs
        if isinstance(table, StreamTable):
            return self._fit_stream(table)
        missing = float(self.get_missing_value())
        strategy = self.get_strategy()
        names = list(self.get_input_cols())
        parts = []
        for name in names:
            col = table.column(name)
            if _columns.is_device_column(col):
                parts.append(surrogate(col, missing, strategy))
            else:
                parts.append(_host_surrogate(_columns.staged_numbers(col), missing, strategy))
        devices = {p.device for p in parts}
        packed = [p.to(torch.float64) for p in parts]
        if len(devices) > 1:
            packed = [p.cpu() for p in packed]
        host = _linear.packed_to_host(*packed)
        surrogates: Dict[str, float] = {}
        for name, col, (num, den) in zip(names, (table.column(n) for n in names), host):
            on_device = _columns.is_device_column(col)
            # each JAX path's own rule: the device path takes a non-finite
            # sum for an empty column too, the host path only a zero count
            # (a host column holding inf imputes inf)
            if den == 0 or (on_device and not np.isfinite(num)):
                raise ValueError(f"Column {name} has no valid values to impute from")
            device_mean = on_device and strategy == MEAN
            surrogates[name] = float(num / den) if device_mean else float(num)
        model = ImputerModel()
        model.surrogates = surrogates
        update_existing_params(model, self)
        return model

    def _fit_stream(self, stream) -> ImputerModel:
        """Out-of-core fit over a StreamTable on the host: (sum, count) for
        mean, a GK sketch per column at `relativeError` for median, value
        counts for most_frequent, all updated one batch at a time."""
        config.device()  # an entry point: no silent CPU without a request
        missing = float(self.get_missing_value())
        strategy = self.get_strategy()
        cols = self.get_input_cols()
        sums = {name: 0.0 for name in cols}
        counts = {name: 0 for name in cols}
        sketches = {name: QuantileSummary(self.get_relative_error()) for name in cols}
        freqs: Dict[str, Dict[float, int]] = {name: {} for name in cols}
        for batch in stream:
            for name in cols:
                col = batch.column(name)
                arr = (col.detach().cpu().numpy() if isinstance(col, torch.Tensor)
                       else np.asarray(col)).astype(np.float64)
                mask = np.isnan(arr) if np.isnan(missing) else (arr == missing) | np.isnan(arr)
                valid = arr[~mask]
                if valid.size == 0:
                    continue
                if strategy == MEAN:
                    sums[name] += float(valid.sum())
                    counts[name] += int(valid.size)
                elif strategy == MEDIAN:
                    sketches[name].insert_batch(valid)
                else:
                    values, vcounts = np.unique(valid, return_counts=True)
                    table_counts = freqs[name]
                    for v, c in zip(values, vcounts):
                        table_counts[float(v)] = table_counts.get(float(v), 0) + int(c)
        surrogates: Dict[str, float] = {}
        for name in cols:
            if strategy == MEAN:
                if counts[name] == 0:
                    raise ValueError(f"Column {name} has no valid values to impute from")
                surrogates[name] = sums[name] / counts[name]
            elif strategy == MEDIAN:
                if sketches[name].is_empty():
                    raise ValueError(f"Column {name} has no valid values to impute from")
                surrogates[name] = float(sketches[name].compress().query(0.5))
            else:
                if not freqs[name]:
                    raise ValueError(f"Column {name} has no valid values to impute from")
                surrogates[name] = max(freqs[name].items(), key=lambda kv: (kv[1], -kv[0]))[0]
        model = ImputerModel()
        model.surrogates = surrogates
        update_existing_params(model, self)
        return model
