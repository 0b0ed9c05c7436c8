"""flink_ml_tpu_torch: the PyTorch/CUDA port of flink_ml_tpu.

A second package beside the JAX one, with the same module paths and names.
It imports torch and numpy and nothing of JAX or of flink_ml_tpu. Entry
points compute on the CUDA card unless the caller asks for the CPU with
`config.use_device("cpu")`; the TPU's Pallas kernels are hand-written CUDA
under `csrc/`, built at first use into `_build/`.

Ported so far: the Stage API, params, Table/SparseBatch, save/load, the
linear losses, one-device SGD and LogisticRegression (dense and sparse).
ROADMAP.md lists what is left.
"""

from .api import AlgoOperator, Estimator, Model, Stage, Transformer
from .linalg import DenseVector, SparseVector, Vectors
from .table import SparseBatch, StreamTable, Table

__version__ = "0.1.0"

__all__ = [
    "AlgoOperator",
    "Estimator",
    "Model",
    "Stage",
    "Transformer",
    "Table",
    "StreamTable",
    "SparseBatch",
    "DenseVector",
    "SparseVector",
    "Vectors",
]
