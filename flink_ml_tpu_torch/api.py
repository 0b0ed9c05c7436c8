"""The five-interface Stage contract.

Port of flink_ml_tpu/api.py (the reference's api/Stage.java,
AlgoOperator.java, Transformer.java, Model.java, Estimator.java) without
the fused-transform protocol and the tracing hook. Save/load keeps the
reference's directory layout: `{path}/metadata` JSON plus model data under
`{path}/data`.
"""

from __future__ import annotations

import abc
from typing import List

from .param import WithParams
from .table import Table


class Stage(WithParams, abc.ABC):
    """Base class for all pipeline nodes; persistable with params (Stage.java:43)."""

    def save(self, path: str) -> None:
        from .utils import read_write

        read_write.save_metadata(self, path)
        self._save_extra(path)

    def _save_extra(self, path: str) -> None:
        """Hook for subclasses to persist model data under `{path}/data`."""

    @classmethod
    def load(cls, path: str) -> "Stage":
        from .utils import read_write

        stage = read_write.instantiate_with_params(read_write.load_metadata(path))
        if not isinstance(stage, cls):
            raise TypeError(f"Loaded stage {type(stage).__name__} is not a {cls.__name__}")
        stage._load_extra(path)
        return stage

    def _load_extra(self, path: str) -> None:
        """Hook for subclasses to restore model data from `{path}/data`."""


class AlgoOperator(Stage):
    """A stage that transforms N input tables into M output tables (AlgoOperator.java:31)."""

    @abc.abstractmethod
    def transform(self, *inputs: Table) -> List[Table]:
        ...


class Transformer(AlgoOperator):
    """Marker: a one-in-one-out record-wise AlgoOperator (Transformer.java:31)."""


class Model(Transformer):
    """A Transformer with explicit model data tables (Model.java:31-50)."""

    def set_model_data(self, *inputs: Table) -> "Model":
        raise NotImplementedError(f"{type(self).__name__} does not support set_model_data")

    def get_model_data(self) -> List[Table]:
        raise NotImplementedError(f"{type(self).__name__} does not support get_model_data")


class Estimator(Stage):
    """A stage that fits a Model from training tables (Estimator.java:30)."""

    @abc.abstractmethod
    def fit(self, *inputs: Table) -> Model:
        ...
