"""OnlineLogisticRegression: a streaming binary classifier trained with
FTRL-Proximal.

Port of flink_ml_tpu/models/classification/onlinelogisticregression.py
(the reference's OnlineLogisticRegression.java: FtrlIterationBody with
l1 = elasticNet * reg and l2 = (1 - elasticNet) * reg,
CalculateLocalGradient's per-feature mean over the rows where the feature
is non-zero, UpdateModel's FTRL z/n update; and
OnlineLogisticRegressionModel.java:133, the model version and its
column).

`fit` re-cuts the stream into exact global batches in arrival order, has
the prefetch worker stage batch b+1 to the device while batch b trains,
and publishes one model version per global batch through the lazy
`iterate_unbounded`: nothing trains until `process_updates` reads the
versions. Each version's coefficient comes back to the host as float64,
one small readback per batch (the model's `coefficient` is a host array).
The model's transform kernel serves tensor features; host features keep
a branch of their own, scored on the host in float64 as the JAX host path
scores them.
"""

from __future__ import annotations

from typing import Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from ... import config
from ...api import Estimator, Model
from ...common.param import (
    HasBatchStrategy,
    HasElasticNet,
    HasFeaturesCol,
    HasGlobalBatchSize,
    HasLabelCol,
    HasModelVersionCol,
    HasPredictionCol,
    HasRawPredictionCol,
    HasReg,
    HasWeightCol,
)
from ...linalg import DenseVector
from ...param import DoubleParam, ParamValidators
from ...parallel.iteration import checkpoint_job_key, iterate_unbounded
from ...parallel.prefetch import DeviceStager, Prefetcher, to_device
from ...table import StreamTable, Table, as_dense_matrix, global_batches
from ...utils import read_write
from ...utils.param_utils import update_existing_params
from .. import _linear


class OnlineLogisticRegressionModelParams(
    HasFeaturesCol, HasPredictionCol, HasRawPredictionCol, HasModelVersionCol
):
    pass


class OnlineLogisticRegressionParams(
    OnlineLogisticRegressionModelParams,
    HasLabelCol,
    HasWeightCol,
    HasBatchStrategy,
    HasGlobalBatchSize,
    HasReg,
    HasElasticNet,
):
    ALPHA = DoubleParam("alpha", "The alpha parameter of ftrl.", 0.1, ParamValidators.gt(0.0))
    BETA = DoubleParam("beta", "The beta parameter of ftrl.", 0.1, ParamValidators.gt(0.0))

    def get_alpha(self) -> float:
        return self.get(self.ALPHA)

    def set_alpha(self, value: float):
        return self.set(self.ALPHA, value)

    def get_beta(self) -> float:
        return self.get(self.BETA)

    def set_beta(self, value: float):
        return self.set(self.BETA, value)


def _ftrl_step(coeff, z, n, X, y, alpha, beta, l1, l2):
    """One global batch: the mean gradient of each feature over the rows
    where it is non-zero, then the FTRL-Proximal update
    (OnlineLogisticRegression.UpdateModel.processElement)."""
    p = 1.0 / (1.0 + torch.exp(-(X @ coeff)))
    grad_sum = X.T @ (p - y)
    weight_sum = torch.sum(X != 0.0, dim=0).to(X.dtype)
    g = torch.where(weight_sum > 0, grad_sum / torch.clamp(weight_sum, min=1.0), grad_sum)
    sigma = (torch.sqrt(n + g * g) - torch.sqrt(n)) / alpha
    z = z + g - sigma * coeff
    n = n + g * g
    new_coeff = torch.where(
        torch.abs(z) <= l1,
        0.0,
        (torch.sign(z) * l1 - z) / ((beta + torch.sqrt(n)) / alpha + l2),
    )
    return new_coeff, z, n


class _PublishedLR(NamedTuple):
    """One published model version. The model swaps the one reference to
    this record, so a reader always sees a consistent (version,
    coefficient) pair."""

    version: int
    coefficient: Optional[np.ndarray]


class OnlineLogisticRegressionModel(Model, OnlineLogisticRegressionModelParams):
    """Predicts with the latest published version and stamps each row with
    it (`modelVersionCol`). Tensor features are scored on their device and
    give tensors (float32 predictions, int32 versions); host features are
    scored on the host in float64, as the JAX package's host path does."""

    fusable = True
    swap_capable = True
    graph_shareable = True

    def __init__(self):
        self._published = _PublishedLR(0, None)
        self._updates: Optional[Iterator] = None

    @property
    def coefficient(self) -> Optional[np.ndarray]:
        return self._published.coefficient

    @coefficient.setter
    def coefficient(self, value) -> None:
        self._publish(value, self._published.version)

    @property
    def model_version(self) -> int:
        return self._published.version

    @model_version.setter
    def model_version(self, value: int) -> None:
        self._publish(self._published.coefficient, int(value))

    def _publish(self, coefficient, version: int) -> None:
        coefficient = None if coefficient is None else np.asarray(coefficient, dtype=np.float64)
        self._published = _PublishedLR(int(version), coefficient)
        self.bump_model_data_version()

    def model_arrays(self) -> tuple:
        return (self._published.coefficient,)

    def publish_model_arrays(self, arrays: tuple, version: int) -> None:
        (coefficient,) = arrays
        self._publish(coefficient, version)

    def _kernel_constants(self):
        pub = self._published  # one record read: version-consistent constants
        return self.kernel_constants_for((pub.coefficient,), pub.version)

    def kernel_constants_for(self, arrays: tuple, version: int = 0):
        (coefficient,) = arrays
        return {"coefficient": np.asarray(coefficient, dtype=np.float32),
                "version": np.int32(version)}

    def _constant_sources(self) -> tuple:
        return (self._published.coefficient,)

    def kernel_output_cols(self) -> List[str]:
        return [self.get_prediction_col(), self.get_raw_prediction_col(),
                self.get_model_version_col()]

    def kernel_output_dtypes(self, cols):
        return {self.get_prediction_col(): torch.float32,
                self.get_raw_prediction_col(): torch.float32,
                self.get_model_version_col(): torch.int32}

    def kernel_ready(self, cols) -> bool:
        return self._published.coefficient is not None

    def transform_kernel(self, consts, cols, ctx):
        # tpulint: disable=resident-program -- a tensor column stays on the card
        X = as_dense_matrix(cols[self.get_features_col()], allow_device=True).to(torch.float32)
        # each row's dot reduced on its own, in an order set by the width
        # alone: a served row's bits do not depend on the rows batched with
        # it (a matrix-vector product picks its kernel by the row count;
        # ROADMAP C.20)
        dot = torch.sum(X * consts["coefficient"], dim=1)
        prob = 1.0 / (1.0 + torch.exp(-dot))
        cols[self.get_prediction_col()] = torch.where(dot >= 0, 1.0, 0.0)
        cols[self.get_raw_prediction_col()] = torch.stack([1.0 - prob, prob], dim=1)
        cols[self.get_model_version_col()] = consts["version"].repeat(X.shape[0])
        return cols

    def set_model_data(self, *inputs) -> "OnlineLogisticRegressionModel":
        """A model-data Table (a coefficient, and a modelVersion if it has
        one), or a stream of (version, coefficient) updates."""
        if len(inputs) == 1 and isinstance(inputs[0], Table):
            row = inputs[0].collect()[0]
            coefficient = np.asarray(row["coefficient"].to_array(), dtype=np.float64)
            version = self._published.version
            if "modelVersion" in inputs[0].column_names:
                version = int(row["modelVersion"])
            self._publish(coefficient, version)
            return self
        (stream,) = inputs
        self._updates = iter(stream)
        return self

    def get_model_data(self) -> List[Table]:
        return [Table({
            "coefficient": [DenseVector(self.coefficient)],
            "modelVersion": [self.model_version],
        })]

    def process_updates(self, max_batches: Optional[int] = None) -> int:
        """Train on pending global batches, at most `max_batches`, each
        published as one new version; returns the model version."""
        if self._updates is None:
            return self.model_version
        processed = 0
        for version, coeff in self._updates:
            self._publish(coeff.cpu().numpy(), version)
            processed += 1
            if max_batches is not None and processed >= max_batches:
                break
        return self.model_version

    def transform(self, *inputs: Table) -> List[Table]:
        (table,) = inputs
        col = table.column(self.get_features_col())
        if _linear.is_device_column(col):  # the kernel densifies a tensor SparseBatch
            return [self._transform_with_kernel(table)]
        pub = self._published  # one read: a consistent (version, coefficient)
        dot = as_dense_matrix(col) @ pub.coefficient
        prob = 1.0 / (1.0 + np.exp(-dot))
        pred = np.where(dot >= 0, 1.0, 0.0)
        raw = np.stack([1.0 - prob, prob], axis=1)
        version = np.full(dot.shape[0], pub.version, dtype=np.int64)
        return [table.with_columns({
            self.get_prediction_col(): pred,
            self.get_raw_prediction_col(): raw,
            self.get_model_version_col(): version,
        })]

    def _save_extra(self, path: str) -> None:
        read_write.save_model_arrays(
            path, coefficient=self.coefficient, modelVersion=np.int64(self.model_version)
        )

    def _load_extra(self, path: str) -> None:
        arrays = read_write.load_model_arrays(path)
        self._publish(arrays["coefficient"], int(arrays.get("modelVersion", 0)))


class OnlineLogisticRegression(Estimator, OnlineLogisticRegressionParams):
    """Estimator (OnlineLogisticRegression.java). Needs initial model data,
    from a batch LogisticRegression, say."""

    # snapshots (coeff, z, n) per global batch through iterate_unbounded
    checkpointable = True

    def __init__(self):
        self._initial_model_data: Optional[Table] = None

    def set_initial_model_data(self, model_data: Table) -> "OnlineLogisticRegression":
        self._initial_model_data = model_data
        return self

    def fit(self, *inputs) -> OnlineLogisticRegressionModel:
        (stream,) = inputs
        if not isinstance(stream, StreamTable):
            raise TypeError("OnlineLogisticRegression.fit expects a StreamTable")
        if self._initial_model_data is None:
            raise ValueError("OnlineLogisticRegression requires initial model data")
        stager = DeviceStager(config.device(), torch.float32)
        row = self._initial_model_data.collect()[0]
        coeff = np.asarray(row["coefficient"].to_array(), dtype=np.float64)
        reg, en = self.get_reg(), self.get_elastic_net()
        l1, l2 = en * reg, (1.0 - en) * reg
        alpha, beta = self.get_alpha(), self.get_beta()

        def step(state, batch):
            X, y = batch
            return _ftrl_step(*state, X, y, alpha, beta, l1, l2)

        features_col, label_col = self.get_features_col(), self.get_label_col()
        batches = global_batches(stream, (
            lambda t: as_dense_matrix(t.column(features_col)),
            lambda t: np.asarray(_linear._host(t.column(label_col)), dtype=np.float64),
        ), self.get_global_batch_size())
        # the ingest window under config.online_overload_policy: "block"
        # folds every batch; "shed_oldest" bounds memory and model staleness
        # when the stream outruns the step, "sample" memory only (flow.shed)
        staged = Prefetcher(stager, policy=config.online_overload_policy,
                            name="online.ingest").iterate(batches)
        init = to_device(coeff, stager.device, torch.float32)
        # under config.iteration_checkpoint_dir each version snapshots the
        # FTRL state (coeff, z, n), and a resumed fit republishes it first
        updates = iterate_unbounded(
            staged, step, (init, torch.zeros_like(init), torch.zeros_like(init)),
            job_key=checkpoint_job_key(self))
        model = OnlineLogisticRegressionModel()
        model.coefficient = coeff
        model.set_model_data((version, state[0]) for version, state in updates)
        update_existing_params(model, self)
        return model
