"""Stage persistence: metadata JSON plus `.npz` model data.

Port of flink_ml_tpu/utils/read_write.py, on the same on-disk layout
(the reference's util/ReadWriteUtils.java): `{path}/metadata` is a JSON
object with `className`, `timestamp` and `paramMap`; model arrays live in
`{path}/data/model_data.npz`. A stage saved by either package loads in
the other:

- the port writes the reference's Java class name for its model stages
  (`org.apache.flink.ml.classification.logisticregression.
  LogisticRegressionModel`), which the JAX package already resolves;
- the port reads Java, pyflink and `flink_ml_tpu.` class names and maps
  each to its own module, without importing the JAX package.
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


def _port_class_name(class_name: str) -> str:
    """Map a class name written by the reference, the JAX package or the
    port to the port's fully qualified class name."""
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
    stages, so the reference's own loaders and the JAX package resolve it."""
    module, cls = type(stage).__module__, type(stage).__qualname__
    if module.startswith(_MODELS):
        return _JAVA_PREFIX + module[len(_MODELS):] + "." + cls
    return f"{module}.{cls}"


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


def load_model_arrays(path: str, name: str = "model_data") -> Dict[str, np.ndarray]:
    """Restore arrays saved by `save_model_arrays` (ReadWriteUtils.loadModelData:460).
    Model data in the reference's binary format is not read yet."""
    npz = os.path.join(get_data_path(path), name + ".npz")
    if not os.path.exists(npz):
        data_dir = get_data_path(path)
        if os.path.isdir(data_dir) and os.listdir(data_dir):
            raise NotImplementedError(
                f"{data_dir} holds no {name}.npz; reading the reference's binary "
                "model-data format is not ported yet (ROADMAP A.15)"
            )
        raise FileNotFoundError(f"No model data under {data_dir}")
    with np.load(npz, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}
