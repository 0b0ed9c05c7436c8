"""OnlineKMeans: streaming k-means with decayed centroid updates.

Port of flink_ml_tpu/models/clustering/onlinekmeans.py (the reference's
OnlineKMeans.java:44-60, OnlineKMeansModel.java:166 and
KMeansModelData.generateRandomModelData). The stream is re-cut into exact
global batches; each batch is one assignment and one update
(ModelDataLocalUpdater): a centroid becomes the weighted mean of its
decayed old self and the batch's mean of its points, its weight
`decayFactor * weight + count`; a centroid no point chose keeps its place.
Each batch publishes a new model version. As in OnlineLogisticRegression,
the prefetch worker stages batch b+1 while batch b updates, and nothing
trains until `process_updates` reads the versions.
"""

from __future__ import annotations

from typing import Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from ... import config
from ...api import Estimator, Model
from ...common.param import (
    HasBatchStrategy,
    HasDecayFactor,
    HasGlobalBatchSize,
    HasSeed,
)
from ...linalg import DenseVector
from ...ops.distance import DistanceMeasure
from ...parallel.iteration import checkpoint_job_key, iterate_unbounded
from ...parallel.prefetch import DeviceStager, Prefetcher, to_device
from ...table import StreamTable, Table, as_dense_matrix, global_batches
from ...utils import read_write
from ...utils.param_utils import update_existing_params
from .. import _linear
from .kmeans import KMeansModelParams, closest_centroids, staged_features


def generate_random_model_data(k: int, dim: int, weight: float, seed: int = 0) -> Table:
    """KMeansModelData.generateRandomModelData: N(0, 1) centroids, drawn
    as the JAX package draws them."""
    rng = np.random.RandomState(seed % (2**32))
    centroids = rng.standard_normal((k, dim))
    return Table({
        "centroids": [[DenseVector(c) for c in centroids]],
        "weights": [DenseVector(np.full(k, weight))],
    })


class OnlineKMeansParams(
    KMeansModelParams, HasBatchStrategy, HasGlobalBatchSize, HasDecayFactor, HasSeed
):
    pass


def _extract_model_data(table: Table):
    """(centroids (k, d), weights (k,)) as float64 from a KMeansModelData
    table, in either column layout (vectors, or a stacked array)."""
    row = table.collect()[0]
    c = row["centroids"]
    if isinstance(c, np.ndarray) and c.ndim == 2:
        centroids = np.asarray(c, dtype=np.float64)
    else:
        centroids = np.stack([
            np.asarray(v.to_array() if hasattr(v, "to_array") else v, dtype=np.float64) for v in c
        ])
    w = row["weights"]
    weights = np.asarray(w.to_array() if hasattr(w, "to_array") else w, dtype=np.float64)
    return centroids, weights


def _batch_update(centroids, weights, X, decay: float, measure_name: str):
    """One global batch's update; returns (centroids, weights)."""
    k = centroids.shape[0]
    assign = DistanceMeasure.get_instance(measure_name).find_closest(X, centroids)
    one_hot = (assign[:, None] == torch.arange(k, device=X.device)).to(X.dtype)
    counts = torch.sum(one_hot, dim=0)
    sums = one_hot.T @ X
    batch_means = torch.where(
        counts[:, None] > 0, sums / torch.clamp(counts[:, None], min=1e-16), centroids
    )
    decayed = weights * decay
    new_centroids = (
        centroids * decayed[:, None] + batch_means * counts[:, None]
    ) / torch.clamp(decayed + counts, min=1e-16)[:, None]
    return new_centroids, decayed + counts


class _PublishedKMeans(NamedTuple):
    """One published model version; swapping the model's one reference to
    it is atomic, so a reader never sees new centroids with old weights."""

    version: int
    centroids: Optional[np.ndarray]
    weights: Optional[np.ndarray]


class OnlineKMeansModel(Model, KMeansModelParams):
    """Assigns rows to the centroids of the latest published version:
    int32, a tensor on the features' device, or host numpy for host
    features (computed on `config.device()`)."""

    fusable = True
    swap_capable = True
    graph_shareable = True

    def __init__(self):
        self._published = _PublishedKMeans(0, None, None)
        self._updates: Optional[Iterator] = None

    @property
    def centroids(self) -> Optional[np.ndarray]:
        return self._published.centroids

    @centroids.setter
    def centroids(self, value) -> None:
        pub = self._published
        self._publish(value, pub.weights, pub.version)

    @property
    def weights(self) -> Optional[np.ndarray]:
        return self._published.weights

    @weights.setter
    def weights(self, value) -> None:
        pub = self._published
        self._publish(pub.centroids, value, pub.version)

    @property
    def model_version(self) -> int:
        return self._published.version

    @model_version.setter
    def model_version(self, value: int) -> None:
        pub = self._published
        self._publish(pub.centroids, pub.weights, int(value))

    def _publish(self, centroids, weights, version: int) -> None:
        centroids = None if centroids is None else np.asarray(centroids, dtype=np.float64)
        weights = None if weights is None else np.asarray(weights, dtype=np.float64)
        self._published = _PublishedKMeans(int(version), centroids, weights)
        self.bump_model_data_version()

    def model_arrays(self) -> tuple:
        pub = self._published
        return (pub.centroids, pub.weights)

    def publish_model_arrays(self, arrays: tuple, version: int) -> None:
        centroids, weights = arrays
        self._publish(centroids, weights, version)

    def _kernel_constants(self):
        pub = self._published  # one record read: version-consistent constants
        return self.kernel_constants_for((pub.centroids, pub.weights), pub.version)

    def kernel_constants_for(self, arrays: tuple, version: int = 0):
        centroids, _ = arrays
        return {"centroids": np.asarray(centroids, dtype=np.float32)}

    def _constant_sources(self) -> tuple:
        pub = self._published
        return (pub.centroids, pub.weights)

    def kernel_ready(self, cols) -> bool:
        return self._published.centroids is not None

    def kernel_output_dtypes(self, cols):
        return dict.fromkeys(self.kernel_output_cols(), torch.int32)

    def transform_kernel(self, consts, cols, ctx):
        cols[self.get_prediction_col()] = closest_centroids(
            self.get_distance_measure(), cols[self.get_features_col()], consts["centroids"])
        return cols

    def set_model_data(self, *inputs) -> "OnlineKMeansModel":
        """A KMeansModelData Table, or a stream of (version, (centroids,
        weights)) updates."""
        if len(inputs) == 1 and isinstance(inputs[0], Table):
            centroids, weights = _extract_model_data(inputs[0])
            self._publish(centroids, weights, self._published.version)
            return self
        (stream,) = inputs
        self._updates = iter(stream)
        return self

    def get_model_data(self) -> List[Table]:
        return [Table({
            "centroids": [[DenseVector(c) for c in self.centroids]],
            "weights": [DenseVector(self.weights)],
        })]

    def process_updates(self, max_batches: Optional[int] = None) -> int:
        """Train on pending global batches, at most `max_batches`, each
        published as one new version; returns the model version."""
        if self._updates is None:
            return self.model_version
        processed = 0
        for version, (centroids, weights) in self._updates:
            centroids, weights = _linear.packed_to_host(centroids, weights)
            self._publish(centroids, weights, version)
            processed += 1
            if max_batches is not None and processed >= max_batches:
                break
        return self.model_version

    def transform(self, *inputs: Table) -> List[Table]:
        (table,) = inputs
        return [self._transform_with_kernel(table, staged_features)]

    def _save_extra(self, path: str) -> None:
        read_write.save_model_arrays(
            path, centroids=self.centroids, weights=self.weights,
            modelVersion=np.int64(self.model_version),
        )

    def _load_extra(self, path: str) -> None:
        arrays = read_write.load_model_arrays(path)
        self._publish(arrays["centroids"], arrays["weights"], int(arrays.get("modelVersion", 0)))


class OnlineKMeans(Estimator, OnlineKMeansParams):
    """Estimator (OnlineKMeans.java:44-60). Needs initial model data, from
    a batch KMeans or `generate_random_model_data`."""

    # snapshots (centroids, weights) per global batch through iterate_unbounded
    checkpointable = True

    def __init__(self):
        self._initial_model_data: Optional[Table] = None

    def set_initial_model_data(self, model_data: Table) -> "OnlineKMeans":
        self._initial_model_data = model_data
        return self

    def fit(self, *inputs) -> OnlineKMeansModel:
        (stream,) = inputs
        if not isinstance(stream, StreamTable):
            raise TypeError("OnlineKMeans.fit expects a StreamTable")
        if self._initial_model_data is None:
            raise ValueError("OnlineKMeans requires initial model data")
        stager = DeviceStager(config.device(), torch.float32)
        centroids, weights = _extract_model_data(self._initial_model_data)
        decay, measure_name = self.get_decay_factor(), self.get_distance_measure()

        def step(state, batch):
            (X,) = batch
            return _batch_update(*state, X, decay, measure_name)

        features_col = self.get_features_col()
        batches = global_batches(stream, (lambda t: as_dense_matrix(t.column(features_col)),),
                                 self.get_global_batch_size())
        # the ingest window under config.online_overload_policy: "block"
        # folds every batch; "shed_oldest" bounds memory and model staleness
        # when the stream outruns the step, "sample" memory only (flow.shed)
        staged = Prefetcher(stager, policy=config.online_overload_policy,
                            name="online.ingest").iterate(batches)
        init = tuple(to_device(a, stager.device, torch.float32)
                     for a in (centroids, weights))
        model = OnlineKMeansModel()
        model.centroids, model.weights = centroids, weights
        # under config.iteration_checkpoint_dir each version snapshots
        # (centroids, weights), and a resumed fit republishes it first
        model.set_model_data(iterate_unbounded(staged, step, init,
                                               job_key=checkpoint_job_key(self)))
        update_existing_params(model, self)
        return model
