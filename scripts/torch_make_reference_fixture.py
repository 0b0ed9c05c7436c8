"""Generate the reference-layout model directories under tests/fixtures/
with flink_ml_tpu_torch (the port's counterpart of
scripts/make_reference_fixture.py: the same directories, byte for byte; it
imports only flink_ml_tpu_torch, so it runs where JAX is not installed).

PROVENANCE: the fixtures are not written by a JVM — they are written by
`flink_ml_tpu_torch/utils/javacodec.py`, which implements the reference's
cited binary formats byte for byte (KMeansModelData.ModelDataEncoder,
LogisticRegressionModelData.ModelDataEncoder, DenseVectorSerializer,
ReadWriteUtils.saveMetadata/savePipeline JSON + directory layout). Each
byte can be checked against the Java sources cited in javacodec.py; if a
JVM-written directory ever disagrees, the codec (and fixture) are wrong
and must be fixed.

Run: python scripts/torch_make_reference_fixture.py [--out DIR]
(idempotent, overwrites; DIR defaults to tests/fixtures/). Nothing here
touches a device.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from flink_ml_tpu_torch.utils import javacodec  # noqa: E402

FIXTURES = os.path.join(REPO, "tests", "fixtures")

# deterministic model values, repeated in the tests' expectations
KMEANS_CENTROIDS = np.array([[0.0, 0.0], [10.0, 10.0]])
KMEANS_WEIGHTS = np.array([3.0, 2.0])
LR_COEFFICIENT = np.array([1.5, -2.0, 0.25, 3.0])


def write_metadata(path: str, class_name: str, param_map: dict, extra: dict = None):
    os.makedirs(path, exist_ok=True)
    metadata = {
        "className": class_name,
        "timestamp": 1700000000000,
        "paramMap": param_map,
        **(extra or {}),
    }
    with open(os.path.join(path, "metadata"), "w") as f:
        json.dump(metadata, f)


# One reference-layout spec per model-data codec family:
# name -> (java class name, paramMap, encoded binary payload), the entries
# of scripts/make_reference_fixture.py (tests/test_torch_tools.py holds the
# two tables and the directories they write equal).
FAMILIES = {
    "standardscaler": (
        "org.apache.flink.ml.feature.standardscaler.StandardScalerModel",
        {"inputCol": "input", "outputCol": "output", "withMean": True, "withStd": True},
        javacodec.encode_standardscaler_model_data([1.0, 2.0], [2.0, 4.0]),
    ),
    "minmaxscaler": (
        "org.apache.flink.ml.feature.minmaxscaler.MinMaxScalerModel",
        {"inputCol": "input", "outputCol": "output", "min": 0.0, "max": 1.0},
        javacodec.encode_minmaxscaler_model_data([0.0, 10.0], [10.0, 30.0]),
    ),
    "maxabsscaler": (
        "org.apache.flink.ml.feature.maxabsscaler.MaxAbsScalerModel",
        {"inputCol": "input", "outputCol": "output"},
        javacodec.encode_maxabsscaler_model_data([4.0, 8.0]),
    ),
    "robustscaler": (
        "org.apache.flink.ml.feature.robustscaler.RobustScalerModel",
        {"inputCol": "input", "outputCol": "output", "withCentering": True,
         "withScaling": True},
        javacodec.encode_robustscaler_model_data([1.0, 2.0], [2.0, 4.0]),
    ),
    "idf": (
        "org.apache.flink.ml.feature.idf.IDFModel",
        {"inputCol": "input", "outputCol": "output"},
        javacodec.encode_idf_model_data([0.405465, 1.098612], [1, 2], 3),
    ),
    "imputer": (
        "org.apache.flink.ml.feature.imputer.ImputerModel",
        {"inputCols": ["a", "b"], "outputCols": ["ao", "bo"], "strategy": "mean"},
        javacodec.encode_imputer_model_data({"a": 1.5, "b": 9.0}),
    ),
    "kbinsdiscretizer": (
        "org.apache.flink.ml.feature.kbinsdiscretizer.KBinsDiscretizerModel",
        {"inputCol": "input", "outputCol": "output"},
        javacodec.encode_kbinsdiscretizer_model_data([[0.0, 1.0, 2.0]]),
    ),
    "stringindexer": (
        "org.apache.flink.ml.feature.stringindexer.StringIndexerModel",
        {"inputCols": ["c"], "outputCols": ["ci"], "handleInvalid": "error"},
        javacodec.encode_stringindexer_model_data([["b", "a"]]),
    ),
    "onehotencoder": (
        "org.apache.flink.ml.feature.onehotencoder.OneHotEncoderModel",
        {"inputCols": ["c"], "outputCols": ["v"], "dropLast": True,
         "handleInvalid": "error"},
        javacodec.encode_onehotencoder_model_record(0, 2),
    ),
    "vectorindexer": (
        "org.apache.flink.ml.feature.vectorindexer.VectorIndexerModel",
        {"inputCol": "input", "outputCol": "output", "handleInvalid": "error"},
        javacodec.encode_vectorindexer_model_data({0: {5.0: 0, 7.0: 1}}),
    ),
    "countvectorizer": (
        "org.apache.flink.ml.feature.countvectorizer.CountVectorizerModel",
        {"inputCol": "input", "outputCol": "output", "minTF": 1.0},
        javacodec.encode_countvectorizer_model_data(["apple", "pear"]),
    ),
    "minhashlsh": (
        "org.apache.flink.ml.feature.lsh.MinHashLSHModel",
        {"inputCol": "vec", "outputCol": "hashes", "numHashTables": 3,
         "numHashFunctionsPerTable": 2},
        javacodec.encode_minhashlsh_model_data(
            3, 2, [1, 2, 3, 4, 5, 6], [11, 12, 13, 14, 15, 16]
        ),
    ),
    "univariatefeatureselector": (
        "org.apache.flink.ml.feature.univariatefeatureselector."
        "UnivariateFeatureSelectorModel",
        {"featuresCol": "features", "outputCol": "output"},
        javacodec.encode_univariatefeatureselector_model_data([1]),
    ),
    "variancethresholdselector": (
        "org.apache.flink.ml.feature.variancethresholdselector."
        "VarianceThresholdSelectorModel",
        {"inputCol": "input", "outputCol": "output"},
        javacodec.encode_variancethresholdselector_model_data(3, [0, 2]),
    ),
    "naivebayes": (
        "org.apache.flink.ml.classification.naivebayes.NaiveBayesModel",
        {"featuresCol": "features", "predictionCol": "prediction",
         "modelType": "multinomial", "smoothing": 1.0},
        javacodec.encode_naivebayes_model_data(
            [[{0.0: -0.105361, 1.0: -2.302585}], [{0.0: -1.609438, 1.0: -0.223144}]],
            np.log([0.5, 0.5]),
            np.array([10.0, 20.0]),
        ),
    ),
    "knn": (
        "org.apache.flink.ml.classification.knn.KnnModel",
        {"featuresCol": "features", "predictionCol": "prediction", "k": 1},
        javacodec.encode_knn_model_data(
            np.array([[0.0, 0.0], [10.0, 10.0]]), np.array([1.0, 2.0])
        ),
    ),
}


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=FIXTURES,
                        help="directory the reference_* directories go into")
    out = parser.parse_args(argv).out
    # 1. a KMeansModel directory (org.apache class name, binary model data)
    kmeans_dir = os.path.join(out, "reference_kmeans_model")
    shutil.rmtree(kmeans_dir, ignore_errors=True)
    write_metadata(
        kmeans_dir,
        "org.apache.flink.ml.clustering.kmeans.KMeansModel",
        {
            "featuresCol": "features",
            "predictionCol": "prediction",
            "distanceMeasure": "euclidean",
            "k": 2,
        },
    )
    javacodec.write_reference_data_file(
        kmeans_dir, javacodec.encode_kmeans_model_data(KMEANS_CENTROIDS, KMEANS_WEIGHTS)
    )

    # 2. a PipelineModel wrapping a LogisticRegressionModel (reference
    # stages/%0{len(numStages)}d naming: 1 stage -> stages/0)
    pipe_dir = os.path.join(out, "reference_lr_pipelinemodel")
    shutil.rmtree(pipe_dir, ignore_errors=True)
    write_metadata(
        pipe_dir,
        "org.apache.flink.ml.builder.PipelineModel",
        {},
        {"numStages": 1},
    )
    stage_dir = os.path.join(pipe_dir, "stages", "0")
    write_metadata(
        stage_dir,
        "org.apache.flink.ml.classification.logisticregression.LogisticRegressionModel",
        {
            "featuresCol": "features",
            "predictionCol": "prediction",
            "rawPredictionCol": "rawPrediction",
        },
    )
    javacodec.write_reference_data_file(
        stage_dir,
        javacodec.encode_logisticregression_model_data(LR_COEFFICIENT, model_version=0),
    )

    # 3. one reference-layout directory PER model-data family (the full
    # codec surface of utils/javacodec.py)
    for name, (class_name, param_map, payload) in FAMILIES.items():
        family_dir = os.path.join(out, f"reference_{name}_model")
        shutil.rmtree(family_dir, ignore_errors=True)
        write_metadata(family_dir, class_name, param_map)
        javacodec.write_reference_data_file(family_dir, payload)

    print(f"fixtures written under {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
