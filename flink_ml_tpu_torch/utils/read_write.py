"""Stage persistence: metadata JSON plus `.npz` model data.

Port of flink_ml_tpu/utils/read_write.py, on the same on-disk layout
(the reference's util/ReadWriteUtils.java): `{path}/metadata` is a JSON
object with `className`, `timestamp` and `paramMap`; model arrays live in
`{path}/data/model_data.npz`. A model directory that the reference (Flink
ML) wrote keeps its model data as binary part files under `{path}/data`
instead; `load_arrays_or_reference` reads either, through the stage's
decoder in `utils/javacodec.py`. A stage saved by either package loads in
the other:

- the port writes the reference's Java class name for its model stages
  (`org.apache.flink.ml.classification.logisticregression.
  LogisticRegressionModel`), which the JAX package already resolves;
- the port reads Java, pyflink and `flink_ml_tpu.` class names and maps
  each to its own module, without importing the JAX package;
- a Pipeline, PipelineModel, Graph or GraphModel is written as the
  reference's own class (`org.apache.flink.ml.builder.Pipeline`), which
  the JAX package aliases too; a pipeline's stages go under
  `stages/{index}` (ReadWriteUtils.java:193-246), a graph's under
  `stages/{nodeId}`.
"""

from __future__ import annotations

import importlib
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np

_PACKAGE = "flink_ml_tpu_torch."
_MODELS = _PACKAGE + "models."
_JAX_PACKAGE = "flink_ml_tpu."
_JAVA_PREFIX = "org.apache.flink.ml."
_PYFLINK_PREFIX = "pyflink.ml.lib."
#: the className the port writes for its pipelines and graphs: the reference's
_WRITTEN_PIPELINE_NAMES = {
    _PACKAGE + "pipeline.Pipeline": "org.apache.flink.ml.builder.Pipeline",
    _PACKAGE + "pipeline.PipelineModel": "org.apache.flink.ml.builder.PipelineModel",
    _PACKAGE + "graph.Graph": "org.apache.flink.ml.builder.Graph",
    _PACKAGE + "graph.GraphModel": "org.apache.flink.ml.builder.GraphModel",
}
#: the reference's (Java and pyflink) pipeline and graph class names -> the port's
_PIPELINE_ALIASES = {java: port for port, java in _WRITTEN_PIPELINE_NAMES.items()}
_PIPELINE_ALIASES.update({
    "pyflink.ml.core.builder.Pipeline": _PACKAGE + "pipeline.Pipeline",
    "pyflink.ml.core.builder.PipelineModel": _PACKAGE + "pipeline.PipelineModel",
})


def _port_class_name(class_name: str) -> str:
    """Map a class name written by the reference, the JAX package or the
    port to the port's fully qualified class name."""
    if class_name in _PIPELINE_ALIASES:
        return _PIPELINE_ALIASES[class_name]
    if class_name.startswith(_PACKAGE):
        return class_name
    if class_name.startswith(_JAX_PACKAGE):
        return _PACKAGE + class_name[len(_JAX_PACKAGE):]
    if class_name.startswith(_JAVA_PREFIX):
        package, _, cls = class_name[len(_JAVA_PREFIX):].rpartition(".")
        return _MODELS + package.lower() + "." + cls
    if class_name.startswith(_PYFLINK_PREFIX):
        return _MODELS + class_name[len(_PYFLINK_PREFIX):]
    return class_name


def _written_class_name(stage) -> str:
    """The className the port writes: the reference's Java name for model
    stages and pipelines, so the reference's own loaders and the JAX
    package resolve it."""
    module, cls = type(stage).__module__, type(stage).__qualname__
    if module.startswith(_MODELS):
        return _JAVA_PREFIX + module[len(_MODELS):] + "." + cls
    name = f"{module}.{cls}"
    return _WRITTEN_PIPELINE_NAMES.get(name, name)


def _resolve_class_name(class_name: str):
    module_name, _, cls_name = _port_class_name(class_name).rpartition(".")
    if not module_name.startswith(_PACKAGE):
        raise ValueError(f"Cannot resolve stage class {class_name!r}")
    try:
        module = importlib.import_module(module_name)
    except ModuleNotFoundError as e:
        raise NotImplementedError(
            f"Stage class {class_name!r} is not ported to flink_ml_tpu_torch yet "
            "(ROADMAP.md queue A)"
        ) from e
    return getattr(module, cls_name)


def save_metadata(stage, path: str, extra_metadata: Optional[Dict[str, Any]] = None) -> None:
    os.makedirs(path, exist_ok=True)
    metadata: Dict[str, Any] = dict(extra_metadata or {})
    metadata["className"] = _written_class_name(stage)
    metadata["timestamp"] = int(time.time() * 1000)
    metadata["paramMap"] = {
        p.name: p.json_encode(v) for p, v in stage.get_param_map().items()
    }
    metadata_file = os.path.join(path, "metadata")
    if os.path.exists(metadata_file):
        raise IOError(f"File {metadata_file} already exists")
    with open(metadata_file, "w") as f:
        json.dump(metadata, f)


def load_metadata(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, "metadata")) as f:
        return json.load(f)


def instantiate_with_params(metadata: Dict[str, Any]):
    """Re-instantiate a stage from metadata (ReadWriteUtils.instantiateWithParams:376)."""
    cls = _resolve_class_name(metadata["className"])
    stage = cls()
    for name, json_value in metadata.get("paramMap", {}).items():
        param = stage.get_param(name)
        if param is None:
            continue  # tolerate params from other versions, as the reference does
        stage.set(param, param.json_decode(json_value))
    return stage


def load_stage(path: str):
    """Load any stage by the class named in its metadata (ReadWriteUtils.loadStage:410)."""
    cls = _resolve_class_name(load_metadata(path)["className"])
    return cls.load(path)


def get_data_path(path: str) -> str:
    return os.path.join(path, "data")


def save_model_arrays(path: str, name: str = "model_data", **arrays) -> None:
    """Persist host arrays under `{path}/data/{name}.npz` (ReadWriteUtils.saveModelData:440)."""
    data_dir = get_data_path(path)
    os.makedirs(data_dir, exist_ok=True)
    np.savez(os.path.join(data_dir, name + ".npz"), **{
        k: np.asarray(v) for k, v in arrays.items()
    })


def load_model_arrays(path: str, name: str = "model_data",
                      allow_pickle: bool = False) -> Dict[str, np.ndarray]:
    """Restore arrays saved by `save_model_arrays` (ReadWriteUtils.loadModelData:460).
    `allow_pickle` reads object arrays (ragged bin edges, column names, key
    lists), which the container can only hold pickled; only a stage whose
    model data has such arrays asks for it."""
    with np.load(os.path.join(get_data_path(path), name + ".npz"), allow_pickle=allow_pickle) as f:
        return {k: f[k] for k in f.files}


def load_arrays_or_reference(path: str, reference_decoder, name: str = "model_data",
                             allow_pickle: bool = False):
    """Model-data loading shared by every model's `_load_extra`: the npz
    container when present, else `reference_decoder(path)` for a
    reference-written binary directory (utils/javacodec.py), else a
    FileNotFoundError naming both accepted formats. A part file cut short
    or corrupt raises the decoder's IOError."""
    if model_data_exists(path, name):
        return load_model_arrays(path, name, allow_pickle)
    decoded = reference_decoder(path)
    if decoded is None:
        raise FileNotFoundError(
            f"No model data under {get_data_path(path)}: neither the native "
            "npz container nor reference-format binary part files"
        )
    return decoded


def model_data_exists(path: str, name: str = "model_data") -> bool:
    return os.path.exists(os.path.join(get_data_path(path), name + ".npz"))


def get_path_for_pipeline_stage(index: int, num_stages: int, path: str) -> str:
    """`stages/{index}`, zero-padded to len(str(numStages)) as the reference
    pads it (ReadWriteUtils.java:193-198), so directories cross-load."""
    width = len(str(num_stages))
    return os.path.join(path, "stages", str(index).zfill(width))


def resolve_pipeline_stage_path(index: int, num_stages: int, path: str) -> str:
    """The stage directory to load: the reference's width, else the 5-wide
    padding that older JAX-package saves used."""
    primary = get_path_for_pipeline_stage(index, num_stages, path)
    if os.path.isdir(primary):
        return primary
    legacy = os.path.join(path, "stages", str(index).zfill(max(len(str(num_stages - 1)), 5)))
    if os.path.isdir(legacy):
        return legacy
    return primary
