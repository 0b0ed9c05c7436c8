"""Binary codecs for model data written by the reference's Java encoders.

Port of flink_ml_tpu/utils/javacodec.py, kept as the port's own copy (it
needs numpy only), byte for byte the same formats. One difference, on
corrupt input only: a length or count the file cannot hold ends at the end
of the file (reads go in chunks of at most `_READ_CHUNK` bytes, lists are
read before arrays are allocated), and a value no writer makes raises the
same IOError as a cut record, where the JAX package's copy may first ask
for the memory the corrupt length claims. The reference persists model
data as binary part files
under `{stage_path}/data/`, one encoder per model class
(ReadWriteUtils.saveModelData/loadModelData,
flink-ml-core/.../util/ReadWriteUtils.java:440-460). The wire format is
Java DataOutput (big-endian):

- DenseVector  (linalg/typeinfo/DenseVectorSerializer.java:78-99):
  int32 length + length x float64 values.
- KMeansModelData  (clustering/kmeans/KMeansModelData.java:140-154):
  int32 numCentroids + numCentroids x DenseVector + weights DenseVector.
- LogisticRegressionModelData
  (classification/logisticregression/LogisticRegressionModelData.java:
  110-121): DenseVector coefficient + int64 modelVersion.
- LinearSVCModelData / LinearRegressionModelData mirror the LR layout
  minus the version long (a single DenseVector coefficient).

Every other Estimator model type (NaiveBayes, Knn, StringIndexer, OneHot,
IDF, CountVectorizer, the four scalers, KBins, VectorIndexer, Imputer,
MinHashLSH, the two selectors) has its codec below, composed from the
Flink primitive serializer formats documented mid-file; the full
per-model byte-format table with Java source citations is
docs/model_formats.md.

These codecs let models LOAD reference-written directories (the npz
container stays the format the port saves) and write reference-format
directories for tests. Encoders and decoders are exact inverses. Every
decoded array is a writable array in native byte order (`np.frombuffer`
of a big-endian buffer is neither, and `torch.from_numpy` refuses it).
"""

from __future__ import annotations

import glob
import io
import os
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

_INT = struct.Struct(">i")
_LONG = struct.Struct(">q")


def encode_dense_vector(values: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(np.asarray(values, dtype=np.float64))
    return _INT.pack(arr.shape[0]) + arr.astype(">f8").tobytes()


def read_dense_vector(stream: io.BufferedIOBase) -> np.ndarray:
    raw = stream.read(4)
    if len(raw) < 4:
        raise EOFError("end of stream")
    (length,) = _INT.unpack(raw)
    try:
        data = _read_exact(stream, 8 * length)
    except EOFError:
        raise EOFError("truncated DenseVector payload") from None
    return np.frombuffer(data, dtype=">f8").astype(np.float64)


def encode_kmeans_model_data(centroids: np.ndarray, weights: np.ndarray) -> bytes:
    out = [_INT.pack(int(np.shape(centroids)[0]))]
    for c in np.asarray(centroids, dtype=np.float64):
        out.append(encode_dense_vector(c))
    out.append(encode_dense_vector(weights))
    return b"".join(out)


def read_kmeans_model_data(stream) -> Tuple[np.ndarray, np.ndarray]:
    raw = stream.read(4)
    if len(raw) < 4:
        raise EOFError("end of stream")
    (num,) = _INT.unpack(raw)
    centroids = np.stack([read_dense_vector(stream) for _ in range(num)])
    weights = read_dense_vector(stream)
    return centroids, weights


def encode_logisticregression_model_data(
    coefficient: np.ndarray, model_version: int = 0
) -> bytes:
    return encode_dense_vector(coefficient) + _LONG.pack(int(model_version))


def read_logisticregression_model_data(stream) -> Tuple[np.ndarray, int]:
    coefficient = read_dense_vector(stream)
    raw = stream.read(8)
    if len(raw) < 8:
        raise EOFError("truncated modelVersion")
    (version,) = _LONG.unpack(raw)
    return coefficient, version


def encode_coefficient_model_data(coefficient: np.ndarray) -> bytes:
    """LinearSVCModelData / LinearRegressionModelData: one DenseVector."""
    return encode_dense_vector(coefficient)


# ---------------------------------------------------------------------------
# Flink primitive serializer wire formats
# ---------------------------------------------------------------------------
# The model-data encoders below compose these primitives exactly as the
# reference's ModelDataEncoder classes compose the corresponding Flink
# serializers (all big-endian DataOutput unless noted):
#
# - StringValue.writeString (flink-core StringValue.java): length+1 as a
#   7-bit varint (0 encodes null), then each UTF-16 code unit as a varint.
#   Used by StringSerializer and StringArraySerializer.
# - {Int,Long,Double}PrimitiveArraySerializer: int32 length + N fixed-width
#   big-endian values.
# - MapSerializer: int32 size, then per entry key, then a null flag byte
#   for the value (0x01 = null) followed by the value when present.
# - DenseMatrixSerializer (linalg/typeinfo/DenseMatrixSerializer.java:76-95):
#   int32 numRows + int32 numCols + numRows*numCols float64 column-major.

_HIGH_BIT = 0x80


def _write_varint(out: list, value: int) -> None:
    while value >= _HIGH_BIT:
        out.append(bytes([(value & 0x7F) | _HIGH_BIT]))
        value >>= 7
    out.append(bytes([value]))


def _read_varint(stream) -> int:
    shift, result = 0, 0
    while True:
        raw = stream.read(1)
        if not raw:
            raise EOFError("truncated varint")
        b = raw[0]
        result |= (b & 0x7F) << shift
        if b < _HIGH_BIT:
            return result
        shift += 7


def encode_java_string(s: Optional[str]) -> bytes:
    """StringValue.writeString: None -> 0x00; else varint(len+1) + per-char
    varints of the UTF-16 code units."""
    if s is None:
        return b"\x00"
    units: List[int] = []
    for c in s:
        cp = ord(c)
        if cp > 0xFFFF:  # Java chars are UTF-16 code units
            cp -= 0x10000
            units.append(0xD800 + (cp >> 10))
            units.append(0xDC00 + (cp & 0x3FF))
        else:
            units.append(cp)
    out: List[bytes] = []
    _write_varint(out, len(units) + 1)
    for u in units:
        _write_varint(out, u)
    return b"".join(out)


def read_java_string(stream) -> Optional[str]:
    length = _read_varint(stream)
    if length == 0:
        return None
    units = [_read_varint(stream) for _ in range(length - 1)]
    chars: List[str] = []
    i = 0
    while i < len(units):
        u = units[i]
        if 0xD800 <= u <= 0xDBFF and i + 1 < len(units) and 0xDC00 <= units[i + 1] <= 0xDFFF:
            chars.append(chr(0x10000 + ((u - 0xD800) << 10) + (units[i + 1] - 0xDC00)))
            i += 2
        else:
            chars.append(chr(u))
            i += 1
    return "".join(chars)


def encode_string_array(strings) -> bytes:
    out = [_INT.pack(len(strings))]
    for s in strings:
        out.append(encode_java_string(None if s is None else str(s)))
    return b"".join(out)


def read_string_array(stream) -> List[Optional[str]]:
    (count,) = _INT.unpack(_read_exact(stream, 4))
    return [read_java_string(stream) for _ in range(count)]


#: the most one read asks of a stream: a corrupt length prefix then ends
#: at the end of the file instead of allocating the length it claims
_READ_CHUNK = 64 << 20


def _read_exact(stream, size: int) -> bytes:
    if size < 0:
        raise EOFError(f"negative length {size}")
    parts, left = [], size
    while left > 0:
        part = stream.read(min(left, _READ_CHUNK))
        if not part:
            raise EOFError("end of stream")
        parts.append(part)
        left -= len(part)
    return b"".join(parts)


def _encode_primitive_array(values, fmt: str) -> bytes:
    arr = np.ascontiguousarray(np.asarray(values))
    return _INT.pack(arr.shape[0]) + arr.astype(fmt).tobytes()


def _read_primitive_array(stream, fmt: str, width: int) -> np.ndarray:
    (length,) = _INT.unpack(_read_exact(stream, 4))
    return np.frombuffer(_read_exact(stream, width * length), dtype=fmt)


def encode_double_array(values) -> bytes:
    return _encode_primitive_array(values, ">f8")


def read_double_array(stream) -> np.ndarray:
    return _read_primitive_array(stream, ">f8", 8).astype(np.float64)


def encode_int_array(values) -> bytes:
    return _encode_primitive_array(values, ">i4")


def read_int_array(stream) -> np.ndarray:
    return _read_primitive_array(stream, ">i4", 4).astype(np.int32)


def encode_long_array(values) -> bytes:
    return _encode_primitive_array(values, ">i8")


def read_long_array(stream) -> np.ndarray:
    return _read_primitive_array(stream, ">i8", 8).astype(np.int64)


_SCALAR_CODECS = {
    "double": (
        lambda v: struct.pack(">d", float(v)),
        lambda s: struct.unpack(">d", _read_exact(s, 8))[0],
    ),
    "int": (
        lambda v: _INT.pack(int(v)),
        lambda s: _INT.unpack(_read_exact(s, 4))[0],
    ),
    "long": (
        lambda v: _LONG.pack(int(v)),
        lambda s: _LONG.unpack(_read_exact(s, 8))[0],
    ),
    "string": (encode_java_string, read_java_string),
}


def encode_java_map(mapping: dict, key_codec: str, value_codec) -> bytes:
    """Flink MapSerializer: size + (key, valueNullFlag, value) entries.
    ``value_codec`` is a codec name or a (encode, read) pair for nesting."""
    k_enc, _ = _SCALAR_CODECS[key_codec]
    v_enc = _SCALAR_CODECS[value_codec][0] if isinstance(value_codec, str) else value_codec[0]
    out = [_INT.pack(len(mapping))]
    for k, v in mapping.items():
        out.append(k_enc(k))
        if v is None:
            out.append(b"\x01")
        else:
            out.append(b"\x00")
            out.append(v_enc(v))
    return b"".join(out)


def read_java_map(stream, key_codec: str, value_codec) -> dict:
    _, k_read = _SCALAR_CODECS[key_codec]
    v_read = _SCALAR_CODECS[value_codec][1] if isinstance(value_codec, str) else value_codec[1]
    (size,) = _INT.unpack(_read_exact(stream, 4))
    result = {}
    for _ in range(size):
        k = k_read(stream)
        null_flag = _read_exact(stream, 1)
        result[k] = None if null_flag == b"\x01" else v_read(stream)
    return result


def encode_dense_matrix(matrix: np.ndarray) -> bytes:
    arr = np.asarray(matrix, dtype=np.float64)
    rows, cols = arr.shape
    # DenseMatrix stores values column-major (DenseMatrix.java:83)
    return _INT.pack(rows) + _INT.pack(cols) + arr.astype(">f8").T.tobytes()


def read_dense_matrix(stream) -> np.ndarray:
    (rows,) = _INT.unpack(_read_exact(stream, 4))
    (cols,) = _INT.unpack(_read_exact(stream, 4))
    flat = np.frombuffer(_read_exact(stream, 8 * rows * cols), dtype=">f8")
    return flat.reshape(cols, rows).T.astype(np.float64)


def _part_sort_key(path: str):
    """Numeric-aware part-file ordering: 'part-0-10' sorts after 'part-0-9'
    (plain lexical order would make records[-1] a stale model once a
    writer produces 10+ parts)."""
    name = os.path.basename(path)
    pieces = name.replace("_", "-").split("-")
    return [int(p) if p.isdigit() else p for p in pieces]


def _data_files(stage_path: str) -> List[str]:
    """The binary part files under {stage_path}/data (everything that is
    not the native npz container), in numeric-aware name order."""
    data_dir = os.path.join(stage_path, "data")
    return sorted(
        (
            f
            for f in glob.glob(os.path.join(data_dir, "*"))
            if os.path.isfile(f) and not f.endswith(".npz")
        ),
        key=_part_sort_key,
    )


def _iter_records(stage_path: str, read_one) -> Iterator:
    for file_path in _data_files(stage_path):
        with open(file_path, "rb") as f:
            stream = io.BufferedReader(f)
            while True:
                if not stream.peek(1):  # clean end of file
                    break
                try:
                    yield read_one(stream)
                # a mid-record cut is corruption, not EOF; so is a value no
                # writer makes (a code unit past U+10FFFF, a negative count)
                except (EOFError, ValueError, OverflowError) as e:
                    raise IOError(
                        f"Corrupt reference model data file {file_path}: {e}"
                    ) from e


def load_reference_kmeans(stage_path: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Decode a reference-written KMeans model directory; None if no
    binary part files exist."""
    records = list(_iter_records(stage_path, read_kmeans_model_data))
    if not records:
        return None
    # bounded KMeans writes one record; online writers append versions —
    # the LAST record is the current model (OnlineKMeansModel semantics)
    return records[-1]


def load_reference_logisticregression(stage_path: str) -> Optional[Tuple[np.ndarray, int]]:
    records = list(_iter_records(stage_path, read_logisticregression_model_data))
    if not records:
        return None
    return records[-1]


def load_reference_coefficient(stage_path: str) -> Optional[np.ndarray]:
    records = list(_iter_records(stage_path, read_dense_vector))
    if not records:
        return None
    return records[-1]


# ---------------------------------------------------------------------------
# Per-model codecs (one per reference ModelDataEncoder)
# ---------------------------------------------------------------------------
# Each encode_* mirrors the cited encoder; each load_reference_* decodes a
# reference-layout stage directory and returns a dict keyed like the
# model's native npz container so Model._load_extra handles both formats
# with the same code.


def encode_naivebayes_model_data(theta, pi, labels) -> bytes:
    """NaiveBayesModelData.ModelDataEncoder (NaiveBayesModelData.java:94-118):
    labels DenseVector + piArray DenseVector + int numLabels + int
    numFeatures + numLabels*numFeatures Map<Double, Double>."""
    out = [encode_dense_vector(labels), encode_dense_vector(pi)]
    num_labels = len(theta)
    num_features = len(theta[0]) if num_labels else 0
    out.append(_INT.pack(num_labels))
    out.append(_INT.pack(num_features))
    for label_maps in theta:
        for m in label_maps:
            out.append(encode_java_map(m, "double", "double"))
    return b"".join(out)


def read_naivebayes_model_data(stream) -> dict:
    labels = read_dense_vector(stream)
    pi = read_dense_vector(stream)
    (num_labels,) = _INT.unpack(_read_exact(stream, 4))
    (num_features,) = _INT.unpack(_read_exact(stream, 4))
    maps = [[read_java_map(stream, "double", "double") for _ in range(num_features)]
            for _ in range(num_labels)]
    theta = np.empty((num_labels, num_features), dtype=object)
    for i, row in enumerate(maps):
        for j, m in enumerate(row):
            theta[i, j] = m
    return {"theta": theta, "piArray": pi, "labels": labels}


def encode_countvectorizer_model_data(vocabulary) -> bytes:
    """CountVectorizerModelData.ModelDataEncoder (:71-78): StringArray."""
    return encode_string_array(vocabulary)


def read_countvectorizer_model_data(stream) -> dict:
    return {"vocabulary": np.asarray(read_string_array(stream), dtype=object)}


def encode_idf_model_data(idf, doc_freq, num_docs: int) -> bytes:
    """IDFModelData.ModelDataEncoder (:79-89): idf DenseVector + long[]
    docFreq + long numDocs."""
    return (
        encode_dense_vector(idf)
        + encode_long_array(doc_freq)
        + _LONG.pack(int(num_docs))
    )


def read_idf_model_data(stream) -> dict:
    idf = read_dense_vector(stream)
    doc_freq = read_long_array(stream)
    (num_docs,) = _LONG.unpack(_read_exact(stream, 8))
    return {"idf": idf, "docFreq": doc_freq, "numDocs": np.int64(num_docs)}


def encode_imputer_model_data(surrogates: dict) -> bytes:
    """ImputerModelData.ModelDataEncoder (:75-81): Map<String, Double>."""
    return encode_java_map(surrogates, "string", "double")


def read_imputer_model_data(stream) -> dict:
    surrogates = read_java_map(stream, "string", "double")
    names = list(surrogates)
    return {
        "columnNames": np.asarray(names, dtype=object),
        "values": np.asarray([surrogates[k] for k in names], dtype=np.float64),
    }


def encode_kbinsdiscretizer_model_data(bin_edges) -> bytes:
    """KBinsDiscretizerModelData.ModelDataEncoder (:77-87): int numColumns +
    numColumns x double[]."""
    out = [_INT.pack(len(bin_edges))]
    for edges in bin_edges:
        out.append(encode_double_array(edges))
    return b"".join(out)


def read_kbinsdiscretizer_model_data(stream) -> dict:
    (num_cols,) = _INT.unpack(_read_exact(stream, 4))
    read = [read_double_array(stream) for _ in range(num_cols)]
    edges = np.empty(num_cols, dtype=object)
    for i, e in enumerate(read):
        edges[i] = e
    return {"binEdges": edges}


def encode_minhashlsh_model_data(
    num_hash_tables: int, num_hash_functions_per_table: int, coeff_a, coeff_b
) -> bytes:
    """MinHashLSHModelData.ModelDataEncoder (MinHashLSHModelData.java:173-182):
    int numHashTables + int numHashFunctionsPerTable + int[] randCoefficientA
    + int[] randCoefficientB."""
    return (
        _INT.pack(int(num_hash_tables))
        + _INT.pack(int(num_hash_functions_per_table))
        + encode_int_array(coeff_a)
        + encode_int_array(coeff_b)
    )


def read_minhashlsh_model_data(stream) -> dict:
    (tables,) = _INT.unpack(_read_exact(stream, 4))
    (per_table,) = _INT.unpack(_read_exact(stream, 4))
    a = read_int_array(stream)
    b = read_int_array(stream)
    return {
        "numHashTables": tables,
        "numHashFunctionsPerTable": per_table,
        "randCoefficientA": a.astype(np.int64),
        "randCoefficientB": b.astype(np.int64),
    }


def encode_maxabsscaler_model_data(max_vector) -> bytes:
    """MaxAbsScalerModelData.ModelDataEncoder (:74-78): one DenseVector."""
    return encode_dense_vector(max_vector)


def read_maxabsscaler_model_data(stream) -> dict:
    return {"maxVector": read_dense_vector(stream)}


def encode_minmaxscaler_model_data(min_vector, max_vector) -> bytes:
    """MinMaxScalerModelData.ModelDataEncoder (:80-85): min + max vectors."""
    return encode_dense_vector(min_vector) + encode_dense_vector(max_vector)


def read_minmaxscaler_model_data(stream) -> dict:
    return {
        "minVector": read_dense_vector(stream),
        "maxVector": read_dense_vector(stream),
    }


def encode_onehotencoder_model_record(column_index: int, max_index: int) -> bytes:
    """OneHotEncoderModelData.ModelDataEncoder (:71-76): Kryo Output
    writeInt x2 — LITTLE-endian, unlike every DataOutput format here. One
    record per column: (columnIndex, max category index)."""
    return struct.pack("<ii", int(column_index), int(max_index))


def read_onehotencoder_model_record(stream) -> Tuple[int, int]:
    return struct.unpack("<ii", _read_exact(stream, 8))


def encode_robustscaler_model_data(medians, ranges) -> bytes:
    """RobustScalerModelData.ModelDataEncoder (:79-85): medians + ranges."""
    return encode_dense_vector(medians) + encode_dense_vector(ranges)


def read_robustscaler_model_data(stream) -> dict:
    return {
        "medians": read_dense_vector(stream),
        "ranges": read_dense_vector(stream),
    }


def encode_standardscaler_model_data(mean, std) -> bytes:
    """StandardScalerModelData.ModelDataEncoder (:84-91): mean + std."""
    return encode_dense_vector(mean) + encode_dense_vector(std)


def read_standardscaler_model_data(stream) -> dict:
    return {"mean": read_dense_vector(stream), "std": read_dense_vector(stream)}


def encode_stringindexer_model_data(string_arrays) -> bytes:
    """StringIndexerModelData.ModelDataEncoder (:72-82): int numCols +
    numCols x StringArray."""
    out = [_INT.pack(len(string_arrays))]
    for arr in string_arrays:
        out.append(encode_string_array(arr))
    return b"".join(out)


def read_stringindexer_model_data(stream) -> dict:
    (num_cols,) = _INT.unpack(_read_exact(stream, 4))
    read = [read_string_array(stream) for _ in range(num_cols)]
    arrays = np.empty(num_cols, dtype=object)
    for i, strings in enumerate(read):
        arrays[i] = np.asarray(strings, dtype=object)
    return {"stringArrays": arrays}


def encode_univariatefeatureselector_model_data(indices) -> bytes:
    """UnivariateFeatureSelectorModelData.ModelDataEncoder (:74-78): int[]."""
    return encode_int_array(indices)


def read_univariatefeatureselector_model_data(stream) -> dict:
    return {"indices": read_int_array(stream).astype(np.int64)}


def encode_variancethresholdselector_model_data(num_features: int, indices) -> bytes:
    """VarianceThresholdSelectorModelData.ModelDataEncoder (:79-84): int
    numOfFeatures + int[] indices."""
    return _INT.pack(int(num_features)) + encode_int_array(indices)


def read_variancethresholdselector_model_data(stream) -> dict:
    (num_features,) = _INT.unpack(_read_exact(stream, 4))
    return {
        "numOfFeatures": num_features,
        "indices": read_int_array(stream).astype(np.int64),
    }


def encode_vectorindexer_model_data(category_maps: dict) -> bytes:
    """VectorIndexerModelData.ModelDataEncoder (:81-92):
    Map<Integer, Map<Double, Integer>> categoryMaps."""
    inner = (
        lambda m: encode_java_map(m, "double", "int"),
        lambda s: read_java_map(s, "double", "int"),
    )
    return encode_java_map(category_maps, "int", inner)


def read_vectorindexer_model_data(stream) -> dict:
    inner = (
        lambda m: encode_java_map(m, "double", "int"),
        lambda s: read_java_map(s, "double", "int"),
    )
    category_maps = read_java_map(stream, "int", inner)
    cols = sorted(category_maps)
    keys = np.empty(len(cols), dtype=object)
    for i, c in enumerate(cols):
        m = category_maps[c]
        keys[i] = np.asarray(sorted(m, key=m.get), dtype=np.float64)
    return {"columns": np.asarray(cols, dtype=np.int64), "keys": keys}


def encode_knn_model_data(features, labels) -> bytes:
    """KnnModelData.ModelDataEncoder (KnnModelData.java:89-94): packed
    (featureDim, numPoints) DenseMatrix + featureNormSquares DenseVector +
    labels DenseVector. ``features`` is this framework's (numPoints,
    featureDim) row layout."""
    F = np.asarray(features, dtype=np.float64)
    norms = np.sum(F * F, axis=1)
    return (
        encode_dense_matrix(F.T)
        + encode_dense_vector(norms)
        + encode_dense_vector(labels)
    )


def read_knn_model_data(stream) -> Tuple[np.ndarray, np.ndarray]:
    matrix = read_dense_matrix(stream)
    read_dense_vector(stream)  # featureNormSquares: recomputed on load
    labels = read_dense_vector(stream)
    return matrix.T, labels


def write_reference_data_file(stage_path: str, payload: bytes, part: int = 0) -> str:
    """Write a reference-layout binary part file (fixture/export helper)."""
    data_dir = os.path.join(stage_path, "data")
    os.makedirs(data_dir, exist_ok=True)
    path = os.path.join(data_dir, f"part-0-{part}")
    with open(path, "wb") as f:
        f.write(payload)
    return path


def _last_record_loader(read_one):
    """Directory loader for single-record model data (the bounded
    estimators write one record; online writers append versions — the LAST
    record is the current model)."""

    def load(stage_path: str):
        records = list(_iter_records(stage_path, read_one))
        return records[-1] if records else None

    return load


load_reference_naivebayes = _last_record_loader(read_naivebayes_model_data)
load_reference_countvectorizer = _last_record_loader(read_countvectorizer_model_data)
load_reference_idf = _last_record_loader(read_idf_model_data)
load_reference_imputer = _last_record_loader(read_imputer_model_data)
load_reference_kbinsdiscretizer = _last_record_loader(read_kbinsdiscretizer_model_data)
load_reference_minhashlsh = _last_record_loader(read_minhashlsh_model_data)
load_reference_maxabsscaler = _last_record_loader(read_maxabsscaler_model_data)
load_reference_minmaxscaler = _last_record_loader(read_minmaxscaler_model_data)
load_reference_robustscaler = _last_record_loader(read_robustscaler_model_data)
load_reference_standardscaler = _last_record_loader(read_standardscaler_model_data)
load_reference_stringindexer = _last_record_loader(read_stringindexer_model_data)
load_reference_univariatefeatureselector = _last_record_loader(
    read_univariatefeatureselector_model_data
)
load_reference_variancethresholdselector = _last_record_loader(
    read_variancethresholdselector_model_data
)
load_reference_vectorindexer = _last_record_loader(read_vectorindexer_model_data)


def load_reference_onehotencoder(stage_path: str) -> Optional[dict]:
    """OneHot model data is a STREAM of (columnIndex, maxIndex) Tuple2
    records, one per column, possibly split across part files
    (OneHotEncoder.java:236). categorySizes[i] = maxIndex + 1, this
    framework's per-column 'max index + 1' convention
    (OneHotEncoderModel.java:168 adds the dropLast offset at transform
    time, as does OneHotEncoderModel.transform here)."""
    records = list(_iter_records(stage_path, read_onehotencoder_model_record))
    if not records:
        return None
    sizes = {col: max_idx + 1 for col, max_idx in records}
    return {
        "categorySizes": np.asarray(
            [sizes[i] for i in range(len(sizes))], dtype=np.int64
        )
    }


def load_reference_knn(stage_path: str) -> Optional[dict]:
    """Knn writes one packed-matrix record per task bundle
    (Knn.java:116); all bundles together are the model — concatenate."""
    records = list(_iter_records(stage_path, read_knn_model_data))
    if not records:
        return None
    return {
        "features": np.concatenate([r[0] for r in records], axis=0),
        "labels": np.concatenate([r[1] for r in records]),
    }
