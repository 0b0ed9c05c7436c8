"""StringIndexer, StringIndexerModel and IndexToStringModel: string <-> index.

Port of flink_ml_tpu/models/feature/stringindexer.py (the reference's
StringIndexer.java, StringIndexerModel.java: a string -> double index map
per column, handleInvalid error/skip/keep with an unseen value at
len(strings); StringIndexerParams.java: stringOrderType arbitrary,
frequencyDesc, frequencyAsc, alphabetDesc or alphabetAsc;
IndexToStringModel.java, the reverse map). A number is indexed by its
Java string form (`_java_double_to_string`, `_java_float_to_string`,
which FeatureHasher shares). Host work: a unicode string column is
counted and looked up once per distinct value with numpy, any other
column value by value; a tensor column is read to the host first.
"""

from __future__ import annotations

import math
from collections import Counter
from decimal import Decimal
from typing import List

import numpy as np
import torch

from ... import config
from ...api import Estimator, Model
from ...common.param import HasHandleInvalid, HasInputCols, HasOutputCols
from ...param import ParamValidators, StringParam
from ...table import Table, _to_numpy
from ...utils import javacodec, read_write
from ...utils.param_utils import update_existing_params
from . import _tokens

ARBITRARY_ORDER = "arbitrary"
FREQUENCY_DESC_ORDER = "frequencyDesc"
FREQUENCY_ASC_ORDER = "frequencyAsc"
ALPHABET_DESC_ORDER = "alphabetDesc"
ALPHABET_ASC_ORDER = "alphabetAsc"


def _java_fp_to_string(v: float, shortest_repr) -> str:
    """Shared Double.toString/Float.toString form contract: decimal form
    for 1e-3 <= |v| < 1e7, otherwise d.dddE±x scientific (e.g. '1.0E7',
    '1.0E-4'), with 'NaN'/'Infinity'/'0.0' specials. ``shortest_repr``
    supplies the shortest round-trip digits at the value's own precision
    (float64 vs float32)."""
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "Infinity" if v > 0 else "-Infinity"
    sign = "-" if (v < 0 or (v == 0 and math.copysign(1.0, v) < 0)) else ""
    a = abs(v)
    if a == 0:
        return sign + "0.0"
    if 1e-3 <= a < 1e7:
        s = shortest_repr(a)
        if "." not in s and "e" not in s and "E" not in s:
            s += ".0"
        return sign + s
    dec = Decimal(shortest_repr(a))
    _, digits, dexp = dec.as_tuple()
    ds = "".join(map(str, digits))
    exp = len(ds) - 1 + dexp
    ds = ds.rstrip("0") or "0"
    frac = ds[1:] or "0"
    return f"{sign}{ds[0]}.{frac}E{exp}"


def _java_double_to_string(v: float) -> str:
    """Java Double.toString semantics. Needed so numeric columns index
    identically to reference-written StringIndexer models.

    Known limit: digits come from Python's shortest round-trip repr; the
    legacy (pre-JDK19) FloatingDecimal occasionally emits non-shortest
    digits (e.g. Double.MIN_VALUE prints '4.9E-324' there, '5.0E-324'
    here). Only subnormal-magnitude keys are affected."""
    return _java_fp_to_string(float(v), repr)


def _java_float_to_string(v) -> str:
    """Java Float.toString semantics: same form contract as Double.toString
    but digits are the float32 shortest round-trip sequence."""
    f = np.float32(v)
    # str(), not repr(): numpy 2 scalar repr is 'np.float32(0.1)'
    return _java_fp_to_string(float(f), lambda a: str(np.float32(a)))


def _host_column(col):
    """A column as the host sees it: a tensor is read back to numpy."""
    return _to_numpy(col) if isinstance(col, torch.Tensor) else col


def _to_string(value) -> str:
    if isinstance(value, str):
        return value
    if isinstance(value, (float, np.floating)):
        return _java_double_to_string(float(value))
    return str(value)


class StringIndexerModelParams(HasInputCols, HasOutputCols, HasHandleInvalid):
    pass


class StringIndexerParams(StringIndexerModelParams):
    STRING_ORDER_TYPE = StringParam(
        "stringOrderType",
        "How to order strings of each column.",
        ARBITRARY_ORDER,
        ParamValidators.in_array(
            [
                ARBITRARY_ORDER,
                FREQUENCY_DESC_ORDER,
                FREQUENCY_ASC_ORDER,
                ALPHABET_DESC_ORDER,
                ALPHABET_ASC_ORDER,
            ]
        ),
    )

    def get_string_order_type(self) -> str:
        return self.get(self.STRING_ORDER_TYPE)

    def set_string_order_type(self, value: str):
        return self.set(self.STRING_ORDER_TYPE, value)


class StringIndexerModel(Model, StringIndexerModelParams):
    fusable = False
    fusable_reason = "string-keyed dictionary lookup over host string columns"

    def __init__(self):
        self.string_arrays: List[List[str]] = None

    def set_model_data(self, *inputs: Table) -> "StringIndexerModel":
        (model_data,) = inputs
        row = model_data.collect()[0]
        self.string_arrays = [list(arr) for arr in row["stringArrays"]]
        return self

    def get_model_data(self) -> List[Table]:
        return [Table({"stringArrays": [[list(a) for a in self.string_arrays]]})]

    def transform(self, *inputs: Table) -> List[Table]:
        config.device()  # an entry point: no silent CPU without a request
        (table,) = inputs
        handle = self.get_handle_invalid()
        updates = {}
        drop_mask = np.zeros(table.num_rows, dtype=bool)
        for strings, name, out_name in zip(
            self.string_arrays, self.get_input_cols(), self.get_output_cols()
        ):
            mapping = {s: float(i) for i, s in enumerate(strings)}
            unseen = float(len(strings))
            col = _host_column(table.column(name))
            if _tokens.string_column(col) is not None:
                # columnar string path: look each DISTINCT value up once
                uniq, inv = np.unique(col, return_inverse=True)
                uniq_out = np.empty(len(uniq), dtype=np.float64)
                uniq_bad = np.zeros(len(uniq), dtype=bool)
                for j, u in enumerate(uniq):
                    key = str(u)
                    if key in mapping:
                        uniq_out[j] = mapping[key]
                    elif handle == HasHandleInvalid.KEEP_INVALID:
                        uniq_out[j] = unseen
                    elif handle == HasHandleInvalid.SKIP_INVALID:
                        uniq_out[j] = np.nan
                        uniq_bad[j] = True
                    else:
                        raise ValueError(
                            f"The input contains unseen string: {key}. See "
                            "handleInvalid parameter for more options."
                        )
                inv = inv.reshape(-1)
                updates[out_name] = uniq_out[inv]
                drop_mask |= uniq_bad[inv]
                continue
            out = np.empty(len(col), dtype=np.float64)
            for i, v in enumerate(col):
                key = _to_string(v)
                if key in mapping:
                    out[i] = mapping[key]
                elif handle == HasHandleInvalid.KEEP_INVALID:
                    out[i] = unseen
                elif handle == HasHandleInvalid.SKIP_INVALID:
                    out[i] = np.nan
                    drop_mask[i] = True
                else:
                    raise ValueError(
                        f"The input contains unseen string: {key}. See "
                        "handleInvalid parameter for more options."
                    )
            updates[out_name] = out
        result = table.with_columns(updates)
        if drop_mask.any():
            result = result.take(np.nonzero(~drop_mask)[0])
        return [result]

    def _save_extra(self, path: str) -> None:
        read_write.save_model_arrays(
            path,
            stringArrays=np.asarray(
                [np.asarray(a, dtype=object) for a in self.string_arrays], dtype=object
            ),
        )

    def _load_extra(self, path: str) -> None:
        arrays = read_write.load_arrays_or_reference(
            path, javacodec.load_reference_stringindexer, allow_pickle=True)
        self.string_arrays = [list(a) for a in arrays["stringArrays"]]


class IndexToStringModelParams(HasInputCols, HasOutputCols):
    pass


class IndexToStringModel(Model, IndexToStringModelParams):
    """Reverse transform: index -> original string (IndexToStringModel.java)."""

    fusable = False
    fusable_reason = "renders output strings on host"

    def __init__(self):
        self.string_arrays: List[List[str]] = None

    def set_model_data(self, *inputs: Table) -> "IndexToStringModel":
        (model_data,) = inputs
        row = model_data.collect()[0]
        self.string_arrays = [list(arr) for arr in row["stringArrays"]]
        return self

    def get_model_data(self) -> List[Table]:
        return [Table({"stringArrays": [[list(a) for a in self.string_arrays]]})]

    def transform(self, *inputs: Table) -> List[Table]:
        config.device()  # an entry point: no silent CPU without a request
        (table,) = inputs
        updates = {}
        for strings, name, out_name in zip(
            self.string_arrays, self.get_input_cols(), self.get_output_cols()
        ):
            col = _host_column(table.column(name))
            out = np.empty(len(col), dtype=object)
            for i, v in enumerate(col):
                idx = int(v)
                if idx < 0 or idx >= len(strings):
                    raise ValueError(
                        f"The input contains unseen index: {idx}."
                    )
                out[i] = strings[idx]
            updates[out_name] = out
        return [table.with_columns(updates)]

    def _save_extra(self, path: str) -> None:
        read_write.save_model_arrays(
            path,
            stringArrays=np.asarray(
                [np.asarray(a, dtype=object) for a in self.string_arrays], dtype=object
            ),
        )

    def _load_extra(self, path: str) -> None:
        arrays = read_write.load_arrays_or_reference(
            path, javacodec.load_reference_stringindexer, allow_pickle=True)
        self.string_arrays = [list(a) for a in arrays["stringArrays"]]


class StringIndexer(Estimator, StringIndexerParams):

    checkpointable = False
    checkpoint_reason = "single-pass frequency count over the input; a restart recomputes the fit"

    def fit(self, *inputs: Table) -> StringIndexerModel:
        config.device()  # an entry point: no silent CPU without a request
        (table,) = inputs
        order = self.get_string_order_type()
        string_arrays: List[List[str]] = []
        for name in self.get_input_cols():
            col = _host_column(table.column(name))
            if _tokens.string_column(col) is not None:
                # columnar string path: one np.unique instead of a host loop
                uniq, cnt = np.unique(col, return_counts=True)
                counts = Counter(dict(zip((str(u) for u in uniq), cnt)))
            else:
                counts = Counter(_to_string(v) for v in col)
            if order in (ARBITRARY_ORDER, ALPHABET_ASC_ORDER):
                strings = sorted(counts)
            elif order == ALPHABET_DESC_ORDER:
                strings = sorted(counts, reverse=True)
            elif order == FREQUENCY_DESC_ORDER:
                strings = [s for s, _ in counts.most_common()]
            else:  # frequencyAsc
                strings = [s for s, _ in sorted(counts.items(), key=lambda kv: (kv[1], kv[0]))]
            string_arrays.append(strings)
        model = StringIndexerModel()
        model.string_arrays = string_arrays
        update_existing_params(model, self)
        return model
