"""VectorIndexer: indexes categorical features inside vectors.

Port of flink_ml_tpu/models/feature/vectorindexer.py (the reference's
VectorIndexer.java and VectorIndexerModel.java). A feature with at most
maxCategories distinct values gets a value -> index map: values ascending,
0.0 moved to the front when present. `handleInvalid`: error, skip (drop
the row) or keep (an unseen value maps to len(map)).

The fit counts each column's distinct values on the device with one
column-wise sort (NaNs distinct for a tensor column, as the JAX device
path counts them; one value for a host column, as `np.unique` counts
them); only the columns under the limit come to the host to build their
maps. The transform maps on the column's device with one `searchsorted`
per categorical column, against the keys in float64, as the JAX
package's dict lookup of `float(v)` compares them. A tensor column gives a
tensor in its dtype, a host column float64 numpy; with no categorical
column the input passes through.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ...api import Estimator, Model
from ...common.param import HasHandleInvalid, HasInputCol, HasOutputCol
from ...parallel.prefetch import to_device
from ...param import IntParam, ParamValidators
from ...table import Table
from ...ops.quantile import count_distinct
from ...utils import javacodec, read_write
from ...utils.param_utils import update_existing_params
from . import _columns


class VectorIndexerModelParams(HasInputCol, HasOutputCol, HasHandleInvalid):
    pass


class VectorIndexerParams(VectorIndexerModelParams):
    MAX_CATEGORIES = IntParam(
        "maxCategories",
        "Threshold for the number of values a categorical feature can take. If a "
        "feature is found to have > maxCategories values, then it is declared continuous.",
        20,
        ParamValidators.gt(1),
    )

    def get_max_categories(self) -> int:
        return self.get(self.MAX_CATEGORIES)

    def set_max_categories(self, value: int):
        return self.set(self.MAX_CATEGORIES, value)


def build_category_map(values: np.ndarray) -> Dict[float, int]:
    """Sorted ascending, with 0.0 hoisted to the front if present
    (VectorIndexer.java model builder)."""
    vals = list(np.sort(np.unique(values)))
    if 0.0 in vals:
        vals.remove(0.0)
        vals.insert(0, 0.0)
    return {float(v): i for i, v in enumerate(vals)}


class VectorIndexerModel(Model, VectorIndexerModelParams):
    fusable = False
    fusable_reason = "python-dict category re-mapping with handleInvalid row drops (data-dependent row count)"

    def __init__(self):
        self.category_maps: Dict[int, Dict[float, int]] = None

    def set_model_data(self, *inputs: Table) -> "VectorIndexerModel":
        (model_data,) = inputs
        row = model_data.collect()[0]
        self.category_maps = {
            int(k): {float(a): int(b) for a, b in v.items()}
            for k, v in row["categoryMaps"].items()
        }
        return self

    def get_model_data(self) -> List[Table]:
        return [Table({"categoryMaps": [dict(self.category_maps)]})]

    def transform(self, *inputs: Table) -> List[Table]:
        (table,) = inputs
        col = table.column(self.get_input_col())
        X = _columns.staged_matrix(col, torch.float64)
        if not self.category_maps:  # nothing to re-index: pass through
            # tpulint: disable=host-sync-leak -- a host column passed through goes back to the host
            return [table.with_columns({self.get_output_col(): _columns.output(X, col)})]
        handle = self.get_handle_invalid()
        out = X.clone()
        drop = torch.zeros(X.shape[0], dtype=torch.bool, device=X.device)
        for col_id, mapping in self.category_maps.items():
            keys = np.fromiter(mapping.keys(), dtype=np.float64, count=len(mapping))
            order = np.argsort(keys)  # a NaN key sorts last and never matches, as in a dict
            keys_t = to_device(keys[order], X.device)
            index_t = to_device(np.fromiter(mapping.values(), dtype=np.float64,
                                            count=len(mapping))[order], X.device)
            values = X[:, col_id].to(torch.float64).contiguous()
            pos = torch.searchsorted(keys_t, values).clamp(max=keys.size - 1)
            found = keys_t[pos] == values
            # tpulint: disable=host-sync-leak -- eager error check (fused: a guard)
            if handle == HasHandleInvalid.ERROR_INVALID and not bool(found.all()):
                # tpulint: disable=host-sync-leak -- only on the way to the raise
                unseen = float(values[~found][0])
                raise ValueError(
                    f"The input contains unseen value: {unseen}. See "
                    "handleInvalid parameter for more options."
                )
            if handle == HasHandleInvalid.SKIP_INVALID:
                drop |= ~found
            # an unseen value maps to len(map) under keep; under skip its row goes
            unseen_to = float(len(mapping)) if handle == HasHandleInvalid.KEEP_INVALID else values
            out[:, col_id] = torch.where(found, index_t[pos], unseen_to).to(out.dtype)
        # tpulint: disable=host-sync-leak -- a host column's output goes back to the host
        result = table.with_columns({self.get_output_col(): _columns.output(out, col)})
        # tpulint: disable=host-sync-leak -- skip: kept rows set the output's shape
        if bool(drop.any()):
            result = result.take(torch.nonzero(~drop).flatten())
        return [result]

    def _save_extra(self, path: str) -> None:
        cols = sorted(self.category_maps)
        read_write.save_model_arrays(
            path,
            columns=np.asarray(cols, dtype=np.int64),
            keys=np.asarray(
                [np.asarray(sorted(self.category_maps[c], key=self.category_maps[c].get))
                 for c in cols],
                dtype=object,
            ),
        )

    def _load_extra(self, path: str) -> None:
        arrays = read_write.load_arrays_or_reference(
            path, javacodec.load_reference_vectorindexer, allow_pickle=True)
        self.category_maps = {
            int(c): {float(v): i for i, v in enumerate(keys)}
            for c, keys in zip(arrays["columns"], arrays["keys"])
        }


class VectorIndexer(Estimator, VectorIndexerParams):

    checkpointable = False
    checkpoint_reason = "single-pass distinct-value aggregation; a restart recomputes the fit"

    def fit(self, *inputs: Table) -> VectorIndexerModel:
        (table,) = inputs
        col = table.column(self.get_input_col())
        on_device = _columns.is_device_column(col)
        X = _columns.staged_matrix(col)
        # tpulint: disable=host-sync-leak -- the fit's readback (host category maps)
        counts = count_distinct(X, nan_equal=not on_device).cpu().numpy()
        category_maps = {}
        for j in np.nonzero(counts <= self.get_max_categories())[0]:
            # the distinct values come to the host, not the column
            # tpulint: disable=host-sync-leak -- the fit's readback (a column's values)
            category_maps[int(j)] = build_category_map(torch.unique(X[:, j]).cpu().numpy())
        model = VectorIndexerModel()
        model.category_maps = category_maps
        update_existing_params(model, self)
        return model
