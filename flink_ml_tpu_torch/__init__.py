"""flink_ml_tpu_torch: the PyTorch/CUDA port of flink_ml_tpu.

A second package beside the JAX one, with the same module paths and names.
It imports torch and numpy and nothing of JAX or of flink_ml_tpu. Entry
points compute on the CUDA card unless the caller asks for the CPU with
`config.use_device("cpu")`; the TPU's Pallas kernels are hand-written CUDA
under `csrc/`, built at first use into `_build/`.

Ported so far: the Stage API, params, Table/SparseBatch/StreamTable,
save/load, the linear losses, one-device SGD (bounded and out of core over
the native spillable data cache), LogisticRegression, LinearSVC and
LinearRegression (dense and sparse), KMeans (bounded and out of core),
OnlineLogisticRegression (FTRL) and OnlineKMeans with the iteration
runtime, StandardScaler, OneHotEncoder, VectorAssembler, the eager
Pipeline/PipelineModel, the fifteen numeric feature stages (scalers,
discretizers, Imputer, selectors, vector transforms; RobustScaler,
KBinsDiscretizer and Imputer also on a StreamTable), and the nine string
and token stages (Tokenizer, RegexTokenizer, StopWordsRemover, NGram,
HashingTF, CountVectorizer, IDF, StringIndexer, FeatureHasher) on
dictionary-encoded token columns (DictTokenMatrix), the statistics
slice (ChiSqTest, ANOVATest, FValueTest, UnivariateFeatureSelector,
NaiveBayes, BinaryClassificationEvaluator), RandomSplitter, Knn, the
vector/array column functions, AgglomerativeClustering (with the window
descriptors and the windowed stream helpers), MinHashLSH, SQLTransformer
and Graph/GraphModel (`graph.py`). ROADMAP.md lists what is left.
"""

from .api import AlgoOperator, Estimator, Model, Stage, Transformer
from .functions import array_to_vector, vector_to_array
from .linalg import DenseMatrix, DenseVector, SparseVector, Vectors
from .pipeline import Pipeline, PipelineModel
from .table import DictTokenMatrix, SparseBatch, StreamTable, Table

__version__ = "0.1.0"

# FLINK_ML_TPU_SANITIZE=1: record this process's locks, workers and
# channels, and fail it (status 66) at exit on a violation
from .analysis import sanitizer as _sanitizer  # noqa: E402

if _sanitizer.enabled_by_env():
    _sanitizer.enable()

__all__ = [
    "AlgoOperator",
    "Estimator",
    "Model",
    "Stage",
    "Transformer",
    "Pipeline",
    "PipelineModel",
    "Table",
    "StreamTable",
    "SparseBatch",
    "DictTokenMatrix",
    "DenseMatrix",
    "DenseVector",
    "SparseVector",
    "Vectors",
    "vector_to_array",
    "array_to_vector",
]
