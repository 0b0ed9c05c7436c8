"""Benchmark data generators: param-driven random table sources.

Port of flink_ml_tpu/benchmark/datagenerator.py, itself a redesign of
flink-ml-benchmark/.../datagenerator/ (DataGenerator.java,
InputDataGenerator.java:NUM_VALUES/COL_NAMES/SEED,
common/DenseVectorGenerator.java, DenseVectorArrayGenerator.java,
DoubleGenerator.java, LabeledPointWithWeightGenerator.java,
RandomStringGenerator.java, RandomStringArrayGenerator.java,
clustering/KMeansModelDataGenerator.java). The param names, JSON names,
defaults and per-column seed offsets (`seed + i`, `seed + 1`, `seed + 2`)
are the JAX package's.

Two paths, as in the JAX package:

- at or above `DEVICE_GEN_THRESHOLD` rows the matrix and scalar tables
  are born on `config.device()` in float32, each column from its own
  `torch.Generator` seeded with `(seed + offset) % 2**32`, and the token
  matrices as `DictTokenMatrix` ids (`ops.tokens.random_token_ids`). The
  bits are torch's generator's, not jax.random's (ROADMAP C.43);
- below it, with `FLINK_ML_TPU_DEVICE_DATAGEN=0`, or under
  `set_prefer_host(True)`, float64 host columns from
  `np.random.RandomState(seed % 2**32)`: the JAX package's numpy path,
  so the tables equal its tables bit for bit.

The device draws are plain torch calls; the JAX package wraps its draws
in `lazy_jit`, and nothing here is captured.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from .. import config
from ..common.param import HasSeed
from ..param import IntParam, LongParam, Param, ParamValidators
from ..table import DictTokenMatrix, Table

#: rows at or above which matrix generators birth their tables on the
#: device (the reference generates data inside the cluster: its
#: InputTableGenerator runs as a Flink source, not a client upload)
DEVICE_GEN_THRESHOLD = 1_024

_prefer_host = False


def set_prefer_host(value: bool) -> None:
    """Generate the next tables on the host. The runner sets this for
    stages whose compute is host work (`Stage.prefers_host_input`), so
    their inputs are not born on the device only to be read back."""
    global _prefer_host
    _prefer_host = value


def _device_gen_enabled() -> bool:
    if _prefer_host:
        return False
    return os.environ.get("FLINK_ML_TPU_DEVICE_DATAGEN", "1") != "0"


def _generator(seed: int) -> torch.Generator:
    gen = torch.Generator(device=config.device())
    gen.manual_seed(int(seed) % (2**32))
    return gen


def _device_uniform(seed: int, shape) -> torch.Tensor:
    """Uniform [0, 1) float32 of `shape`, born on the device."""
    return torch.rand(tuple(shape), generator=_generator(seed), device=config.device(),
                      dtype=torch.float32)


def _device_randint_float(seed: int, shape, arity: int) -> torch.Tensor:
    """Integers in [0, arity) as float32 of `shape`, born on the device."""
    ints = torch.randint(0, int(arity), tuple(shape), generator=_generator(seed),
                         device=config.device())
    return ints.to(torch.float32)


class _ColNamesParam(Param):
    """String[][] colNames (InputDataGenerator.java COL_NAMES)."""

    def json_encode(self, value):
        return value

    def json_decode(self, json_value):
        return json_value


class DataGenerator(HasSeed):
    """Base generator: get_data() -> list of Tables (DataGenerator.java)."""

    NUM_VALUES = LongParam(
        "numValues", "Number of data rows to generate.", 10, ParamValidators.gt(0)
    )
    COL_NAMES = _ColNamesParam("colNames", "Column names of the generated tables.", None)

    def get_num_values(self) -> int:
        return self.get(self.NUM_VALUES)

    def set_num_values(self, value: int):
        return self.set(self.NUM_VALUES, value)

    def get_col_names(self):
        return self.get(self.COL_NAMES)

    def set_col_names(self, *values):
        return self.set(self.COL_NAMES, [list(v) for v in values])

    def _rng(self) -> np.random.RandomState:
        return np.random.RandomState(self.get_seed() % (2**32))

    def get_data(self) -> List[Table]:
        raise NotImplementedError


class DenseVectorGenerator(DataGenerator):
    """Random uniform dense vectors (common/DenseVectorGenerator.java)."""

    VECTOR_DIM = IntParam("vectorDim", "Dimension of generated vectors.", 1, ParamValidators.gt(0))

    def get_vector_dim(self) -> int:
        return self.get(self.VECTOR_DIM)

    def set_vector_dim(self, value: int):
        return self.set(self.VECTOR_DIM, value)

    def get_data(self) -> List[Table]:
        (names,) = self.get_col_names()
        n, d = self.get_num_values(), self.get_vector_dim()
        if n >= DEVICE_GEN_THRESHOLD and _device_gen_enabled():
            X = _device_uniform(self.get_seed(), (n, d))
        else:
            X = self._rng().rand(n, d)
        return [Table({names[0]: X})]


class DenseVectorArrayGenerator(DenseVectorGenerator):
    """Arrays of dense vectors per row (common/DenseVectorArrayGenerator.java)."""

    ARRAY_SIZE = IntParam("arraySize", "Size of the vector array.", 1, ParamValidators.gt(0))

    def get_array_size(self) -> int:
        return self.get(self.ARRAY_SIZE)

    def set_array_size(self, value: int):
        return self.set(self.ARRAY_SIZE, value)

    def get_data(self) -> List[Table]:
        from ..linalg import DenseVector

        (names,) = self.get_col_names()
        rng = self._rng()
        n, k, d = self.get_num_values(), self.get_array_size(), self.get_vector_dim()
        col = np.empty(n, dtype=object)
        for i in range(n):
            col[i] = [DenseVector(rng.rand(d)) for _ in range(k)]
        return [Table({names[0]: col})]


class DoubleGenerator(DataGenerator):
    """Random doubles (common/DoubleGenerator.java): uniform [0, 1) by
    default; with arity > 0, integer-valued doubles in [0, arity)."""

    ARITY = IntParam(
        "arity",
        "Arity of the generated values: 0 means continuous in [0, 1).",
        0,
        ParamValidators.gt_eq(0),
    )

    def get_arity(self) -> int:
        return self.get(self.ARITY)

    def set_arity(self, value: int):
        return self.set(self.ARITY, value)

    def get_data(self) -> List[Table]:
        (names,) = self.get_col_names()
        n, arity = self.get_num_values(), self.get_arity()
        if n >= DEVICE_GEN_THRESHOLD and _device_gen_enabled():
            seed = self.get_seed() % (2**32)
            cols = {}
            for i, name in enumerate(names):
                if arity > 0:
                    cols[name] = _device_randint_float(seed + i, (n,), arity)
                else:
                    cols[name] = _device_uniform(seed + i, (n,))
            return [Table(cols)]
        rng = self._rng()
        if arity > 0:
            return [
                Table({name: rng.randint(0, arity, size=n).astype(np.float64) for name in names})
            ]
        return [Table({name: rng.rand(n) for name in names})]


class LabeledPointWithWeightGenerator(DataGenerator):
    """(features, label, weight) rows (common/LabeledPointWithWeightGenerator.java):
    feature values uniform in [0, 1) or categorical of featureArity; label
    uniform integer in [0, labelArity); weight uniform in [0, 1)."""

    FEATURE_ARITY = IntParam(
        "featureArity",
        "Arity of each feature: 0 means continuous in [0, 1).",
        2,
        ParamValidators.gt_eq(0),
    )
    LABEL_ARITY = IntParam(
        "labelArity", "Arity of the label.", 2, ParamValidators.gt(1)
    )
    VECTOR_DIM = IntParam("vectorDim", "Dimension of the feature vector.", 1, ParamValidators.gt(0))

    def get_feature_arity(self) -> int:
        return self.get(self.FEATURE_ARITY)

    def set_feature_arity(self, value: int):
        return self.set(self.FEATURE_ARITY, value)

    def get_label_arity(self) -> int:
        return self.get(self.LABEL_ARITY)

    def set_label_arity(self, value: int):
        return self.set(self.LABEL_ARITY, value)

    def get_vector_dim(self) -> int:
        return self.get(self.VECTOR_DIM)

    def set_vector_dim(self, value: int):
        return self.set(self.VECTOR_DIM, value)

    def get_data(self) -> List[Table]:
        (names,) = self.get_col_names()
        n, d = self.get_num_values(), self.get_vector_dim()
        arity = self.get_feature_arity()
        if n >= DEVICE_GEN_THRESHOLD and _device_gen_enabled():
            seed = self.get_seed() % (2**32)
            if arity == 0:
                X = _device_uniform(seed, (n, d))
            else:
                X = _device_randint_float(seed, (n, d), arity)
            y = _device_randint_float(seed + 1, (n,), self.get_label_arity())
            w = _device_uniform(seed + 2, (n,))
            return [Table({names[0]: X, names[1]: y, names[2]: w})]
        rng = self._rng()
        if arity == 0:
            X = rng.rand(n, d)
        else:
            X = rng.randint(0, arity, size=(n, d)).astype(np.float64)
        y = rng.randint(0, self.get_label_arity(), size=n).astype(np.float64)
        w = rng.rand(n)
        return [Table({names[0]: X, names[1]: y, names[2]: w})]


def _string_vocab(m: int) -> np.ndarray:
    """The decimal token vocabulary at its narrowest unicode width:
    `astype(str)` alone gives '<U21' (84 bytes an element), which makes a
    10M x 100 token matrix 17 GB; '<U{digits}' keeps it 8 bytes at
    m <= 100. A copy of the JAX package's helper."""
    return np.arange(m).astype(str).astype(f"<U{len(str(max(m - 1, 1)))}")


class RandomStringGenerator(DataGenerator):
    """Random strings from a fixed-size token universe
    (common/RandomStringGenerator.java). Host columns at every size, as in
    the JAX package."""

    NUM_DISTINCT_VALUES = IntParam(
        "numDistinctValues", "Number of distinct string values.", 10, ParamValidators.gt(0)
    )

    def get_num_distinct_values(self) -> int:
        return self.get(self.NUM_DISTINCT_VALUES)

    def set_num_distinct_values(self, value: int):
        return self.set(self.NUM_DISTINCT_VALUES, value)

    def get_data(self) -> List[Table]:
        (names,) = self.get_col_names()
        rng = self._rng()
        n, m = self.get_num_values(), self.get_num_distinct_values()
        # fancy indexing into the vocabulary: fixed-width unicode columns
        # with no per-row Python loop
        vocab = _string_vocab(m)
        cols = {}
        for name in names:
            cols[name] = vocab[rng.randint(0, m, size=n)]
        return [Table(cols)]


class RandomStringArrayGenerator(RandomStringGenerator):
    """Arrays of random strings (common/RandomStringArrayGenerator.java)."""

    ARRAY_SIZE = IntParam("arraySize", "Size of the string arrays.", 1, ParamValidators.gt(0))

    def get_array_size(self) -> int:
        return self.get(self.ARRAY_SIZE)

    def set_array_size(self, value: int):
        return self.set(self.ARRAY_SIZE, value)

    def get_data(self) -> List[Table]:
        (names,) = self.get_col_names()
        n, m, k = self.get_num_values(), self.get_num_distinct_values(), self.get_array_size()
        vocab = _string_vocab(m)
        cols = {}
        if n >= DEVICE_GEN_THRESHOLD and _device_gen_enabled():
            # dictionary-encoded, the ids born on the device: the string
            # stages compute on the id matrix there
            from ..ops import tokens as tokens_ops

            seed = self.get_seed() % (2**32)
            for i, name in enumerate(names):
                ids = tokens_ops.random_token_ids((seed + i) % (2**32), n, k, m)
                cols[name] = DictTokenMatrix(vocab, ids)
            return [Table(cols)]
        rng = self._rng()
        for name in names:
            # an (n, k) fixed-width unicode token matrix: each row one
            # token array, the columnar layout the string stages read
            cols[name] = vocab[rng.randint(0, m, size=(n, k))]
        return [Table(cols)]


class KMeansModelDataGenerator(DataGenerator):
    """Random KMeansModelData (clustering/KMeansModelDataGenerator.java)."""

    ARRAY_SIZE = IntParam("arraySize", "Number of centroids.", 2, ParamValidators.gt(0))
    VECTOR_DIM = IntParam("vectorDim", "Dimension of centroids.", 1, ParamValidators.gt(0))

    def get_data(self) -> List[Table]:
        from ..linalg import DenseVector

        (names,) = self.get_col_names()
        rng = self._rng()
        k, d = self.get(self.ARRAY_SIZE), self.get(self.VECTOR_DIM)
        centroids = [DenseVector(rng.rand(d)) for _ in range(k)]
        weights = DenseVector(np.zeros(k))
        return [Table({names[0]: [centroids], names[1]: [weights]})]
