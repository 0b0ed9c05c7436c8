"""Pipeline and PipelineModel: stages run in sequence.

Port of the eager half of flink_ml_tpu/pipeline.py (the reference's
builder/Pipeline.java:79-107 and PipelineModel.java:63-68). `Pipeline.fit`
fits each Estimator on the data as the stages before it transformed it,
and transforms only up to the last Estimator; `PipelineModel.transform`
runs every stage in turn. Each stage keeps its own device convention, so
device-resident columns stay on the device from stage to stage.

Save and load keep the reference's layout: the pipeline's metadata with
`numStages`, and each stage under `stages/{index}`. The JAX package's
transform fusion planner and `transform_deferred` are not ported yet
(ROADMAP A.7); this is its `pipeline_fusion == "off"` path.
"""

from __future__ import annotations

from typing import List, Sequence

from .api import AlgoOperator, Estimator, Model, Stage
from .table import Table
from .utils import read_write


def _transform_one(stage: Stage, table: Table) -> Table:
    outputs = stage.transform(table)  # type: ignore[attr-defined]
    if len(outputs) != 1:
        raise ValueError(f"Stage {type(stage).__name__} must produce exactly 1 output table")
    return outputs[0]


class _StageList(Stage):
    """The stage list and its save/load in the `stages/{index}` layout."""

    def __init__(self, stages: Sequence[Stage] = ()):
        self._stages: List[Stage] = list(stages)

    @property
    def stages(self) -> List[Stage]:
        return self._stages

    def save(self, path: str) -> None:
        read_write.save_metadata(self, path, {"numStages": len(self._stages)})
        for i, stage in enumerate(self._stages):
            stage.save(read_write.get_path_for_pipeline_stage(i, len(self._stages), path))

    def _load_extra(self, path: str) -> None:
        metadata = read_write.load_metadata(path)
        num_stages = int(metadata.get("numStages", metadata.get("num_stages", 0)))
        self._stages = [
            read_write.load_stage(read_write.resolve_pipeline_stage_path(i, num_stages, path))
            for i in range(num_stages)
        ]


class PipelineModel(_StageList, Model):
    """Model produced by Pipeline.fit (builder/PipelineModel.java)."""

    def transform(self, *inputs: Table) -> List[Table]:
        if len(inputs) != 1:
            raise ValueError("PipelineModel.transform expects exactly 1 input table")
        table = inputs[0]
        for stage in self._stages:
            table = _transform_one(stage, table)
        return [table]


class Pipeline(_StageList, Estimator):
    """Sequential Estimator (builder/Pipeline.java:79-107)."""

    def fit(self, *inputs: Table) -> PipelineModel:
        if len(inputs) != 1:
            raise ValueError("Pipeline.fit expects exactly 1 input table")
        table = inputs[0]
        last_estimator_idx = max(
            (i for i, stage in enumerate(self._stages) if isinstance(stage, Estimator)),
            default=-1,
        )
        model_stages: List[Stage] = []
        for i, stage in enumerate(self._stages):
            model = stage.fit(table) if isinstance(stage, Estimator) else stage
            model_stages.append(model)
            if i < last_estimator_idx:
                if not isinstance(model, AlgoOperator):
                    raise TypeError(
                        f"Intermediate stage {type(stage).__name__} cannot transform data"
                    )
                table = _transform_one(model, table)
        return PipelineModel(model_stages)
