"""The port stands alone and does not hide the device.

- no module of the port pulls in JAX when imported, with or without a card
  (each module of the serving, checkpoint and tpulint slices also alone);
- no module of the port, and neither chip_smoke.py nor
  scripts/torch_kernel_designs.py, scripts/rehearse_chip_smoke.py,
  scripts/chip_funnel_phase.py, scripts/chip_checkpoint_phase.py,
  scripts/chip_host_attribution.py, scripts/chip_mesh_phase.py,
  scripts/probe_distributed_backends.py, scripts/chip_benchmark_phase.py,
  scripts/chip_tools_phase.py, scripts/chip_sgd_epoch_phase.py (and the card's tests it runs,
  tests/test_torch_sgd_fused.py), the operator tools scripts/torch_*.py (each also runs with jax and
  flink_ml_tpu poisoned: tests/test_torch_tools.py) nor the rank jobs of the mesh
  tests (tests/torch_mesh_jobs.py, tests/torch_mesh2d_jobs.py), imports
  jax or flink_ml_tpu;
- each module of the benchmark CLI alone, and a config naming the JAX
  package's generator resolves to the port's;
- each module of the mesh slice alone, and what a spawned rank imports
  (the launcher's rank entry `_rank_main` resolves its target by module
  path: the mesh tests' jobs, chip_smoke's phase-16 and phase-17 jobs,
  the supervisor's rank entry), pulls in neither;
- chip_smoke.py fails without a card, and its CPU rehearsal runs through;
- an entry point that was not asked for the CPU raises without a card,
  rather than falling back to the CPU; that holds for the stages whose work
  is host work in both packages too (the chi-square test, RandomSplitter's
  draw, NaiveBayes' host paths, AgglomerativeClustering's merge loop, the
  SQL statements, a Graph's own wiring). `functions.py` only converts columns and
  needs no device.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from flink_ml_tpu_torch import DenseVector, SparseBatch, StreamTable, Table, config
from flink_ml_tpu_torch.models.classification.logisticregression import (
    LogisticRegression,
    LogisticRegressionModel,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
#: the operator tools (A.19): the port's counterparts of the JAX scripts
TOOL_SCRIPTS = ["torch_coldstart_smoke.py", "torch_gen_operator_docs.py",
                "torch_make_reference_fixture.py", "torch_obs_report.py",
                "torch_obs_timeline.py", "torch_smoke_fit_timeline.py"]
PORT_FILES = sorted((REPO / "flink_ml_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "scripts" / "torch_kernel_designs.py",
    REPO / "scripts" / "rehearse_chip_smoke.py", REPO / "scripts" / "chip_funnel_phase.py",
    REPO / "scripts" / "chip_checkpoint_phase.py", REPO / "scripts" / "chip_host_attribution.py",
    REPO / "scripts" / "chip_mesh_phase.py", REPO / "scripts" / "probe_distributed_backends.py",
    REPO / "scripts" / "chip_benchmark_phase.py", REPO / "scripts" / "chip_tools_phase.py",
    REPO / "scripts" / "chip_sgd_epoch_phase.py", REPO / "tests" / "test_torch_sgd_fused.py",
    *(REPO / "scripts" / name for name in TOOL_SCRIPTS),
    REPO / "tests" / "torch_mesh_jobs.py", REPO / "tests" / "torch_mesh2d_jobs.py"]


PORT_MODULES = sorted(
    "flink_ml_tpu_torch." + ".".join(p.relative_to(REPO / "flink_ml_tpu_torch").with_suffix("").parts)
    for p in (REPO / "flink_ml_tpu_torch").rglob("*.py") if p.name != "__init__.py"
)


def test_import_leaves_jax_out():
    """Every module of the port imports without JAX and without a card."""
    code = (
        "import sys, importlib, torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "import flink_ml_tpu_torch\n"
        f"for name in {PORT_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'flink_ml_tpu' or m.startswith('flink_ml_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


SERVING_SLICE = ["flink_ml_tpu_torch.serving", "flink_ml_tpu_torch.data.modelstore",
                 "flink_ml_tpu_torch.lifecycle", "flink_ml_tpu_torch.flow",
                 "flink_ml_tpu_torch.ckpt.faults", "flink_ml_tpu_torch.obs.hist",
                 "flink_ml_tpu_torch.obs.timeline", "flink_ml_tpu_torch.obs.memledger"]


@pytest.mark.parametrize("name", SERVING_SLICE)
def test_the_serving_slice_imports_neither_jax_nor_the_jax_package(name):
    """Each module of the serving slice, imported alone in a fresh
    interpreter, pulls in neither jax nor flink_ml_tpu."""
    code = (
        "import sys, importlib\n"
        f"importlib.import_module({name!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flink_ml_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert name in PORT_MODULES


CHECKPOINT_SLICE = ["flink_ml_tpu_torch.ckpt", "flink_ml_tpu_torch.ckpt.snapshot",
                    "flink_ml_tpu_torch.ckpt.coordinator", "flink_ml_tpu_torch.parallel.supervisor",
                    "flink_ml_tpu_torch.parallel.iteration", "flink_ml_tpu_torch.data.devicecache",
                    "flink_ml_tpu_torch.native.datacache", "flink_ml_tpu_torch.utils.packing"]


@pytest.mark.parametrize("name", CHECKPOINT_SLICE)
def test_the_checkpoint_slice_imports_neither_jax_nor_the_jax_package(name):
    """Each module of checkpointing and recovery, imported alone in a
    fresh interpreter, pulls in neither jax nor flink_ml_tpu, and needs no
    card."""
    code = (
        "import sys, importlib\n"
        f"importlib.import_module({name!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flink_ml_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert name in PORT_MODULES or name == "flink_ml_tpu_torch.ckpt"


ANALYSIS_SLICE = ["flink_ml_tpu_torch.analysis", "flink_ml_tpu_torch.analysis.__main__",
                  "flink_ml_tpu_torch.analysis.source", "flink_ml_tpu_torch.analysis.engine",
                  "flink_ml_tpu_torch.analysis.callgraph", "flink_ml_tpu_torch.analysis.cache",
                  "flink_ml_tpu_torch.analysis.rules", "flink_ml_tpu_torch.analysis.rules._astwalk",
                  "flink_ml_tpu_torch.analysis.rules._jitindex",
                  "flink_ml_tpu_torch.analysis.rules.accounting",
                  "flink_ml_tpu_torch.analysis.rules.hostsync",
                  "flink_ml_tpu_torch.analysis.rules.memledger",
                  "flink_ml_tpu_torch.analysis.rules.residentprogram",
                  "flink_ml_tpu_torch.analysis.rules.retrace",
                  "flink_ml_tpu_torch.analysis.rules.servepath",
                  "flink_ml_tpu_torch.analysis.sanitizer",
                  "flink_ml_tpu_torch.analysis.rules._receivers",
                  "flink_ml_tpu_torch.analysis.rules.channelprotocol",
                  "flink_ml_tpu_torch.analysis.rules.coverage",
                  "flink_ml_tpu_torch.analysis.rules.flowcontrol",
                  "flink_ml_tpu_torch.analysis.rules.lockorder",
                  "flink_ml_tpu_torch.analysis.rules.snapshotcommit",
                  "flink_ml_tpu_torch.analysis.rules.untimedwait",
                  "flink_ml_tpu_torch.analysis.spmd",
                  "flink_ml_tpu_torch.analysis.rules.divergence",
                  "flink_ml_tpu_torch.analysis.rules.donation",
                  "flink_ml_tpu_torch.analysis.rules.meshaxis",
                  "flink_ml_tpu_torch.analysis.rules.precision",
                  "flink_ml_tpu_torch.analysis.rules.shardingtags",
                  "flink_ml_tpu_torch.analysis.rules.specconsistency"]


@pytest.mark.parametrize("name", ANALYSIS_SLICE)
def test_the_analysis_slice_imports_neither_jax_nor_the_jax_package(name):
    """Each module of the port's tpulint, imported alone in a fresh
    interpreter, pulls in neither jax nor flink_ml_tpu (it keeps its own
    copy of every helper, even of the JAX package's modules that do no JAX
    work), and its rules register."""
    code = (
        "import sys, importlib\n"
        f"importlib.import_module({name!r})\n"
        "from flink_ml_tpu_torch.analysis import engine\n"
        "assert len(engine.all_rules()) == 20\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flink_ml_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert name in PORT_MODULES or name.endswith(("analysis", "rules"))


MESH_SLICE = ["flink_ml_tpu_torch.parallel.mesh", "flink_ml_tpu_torch.parallel.collectives",
              "flink_ml_tpu_torch.parallel.overlap", "flink_ml_tpu_torch.parallel.dispatch",
              "flink_ml_tpu_torch.parallel.launcher"]


@pytest.mark.parametrize("name", MESH_SLICE)
def test_the_mesh_slice_imports_neither_jax_nor_the_jax_package(name):
    """Each module of the mesh slice, imported alone in a fresh
    interpreter, pulls in neither jax nor flink_ml_tpu, and needs no card."""
    code = (
        "import sys, importlib\n"
        f"importlib.import_module({name!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flink_ml_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert name in PORT_MODULES


BENCHMARK_SLICE = ["flink_ml_tpu_torch.benchmark", "flink_ml_tpu_torch.benchmark.__main__",
                   "flink_ml_tpu_torch.benchmark.runner",
                   "flink_ml_tpu_torch.benchmark.datagenerator"]


@pytest.mark.parametrize("name", BENCHMARK_SLICE)
def test_the_benchmark_slice_imports_neither_jax_nor_the_jax_package(name):
    """Each module of the benchmark CLI, imported alone in a fresh
    interpreter (`__main__` with no arguments prints its usage), pulls in
    neither jax nor flink_ml_tpu, and needs no card."""
    code = (
        "import sys, importlib\n"
        f"importlib.import_module({name!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flink_ml_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert name in PORT_MODULES or name == "flink_ml_tpu_torch.benchmark"


def test_a_jax_generator_name_resolves_to_the_port():
    """A config naming the JAX package's generator module gets the port's
    class, and nothing of JAX or the JAX package is imported for it."""
    code = (
        "import sys\n"
        "from flink_ml_tpu_torch.benchmark import datagenerator, runner\n"
        "gen = runner.instantiate_generator({'className': "
        "'flink_ml_tpu.benchmark.datagenerator.DenseVectorGenerator', "
        "'paramMap': {'vectorDim': 4}})\n"
        "assert type(gen) is datagenerator.DenseVectorGenerator, type(gen)\n"
        "assert gen.get_vector_dim() == 4\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flink_ml_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("target", ["torch_mesh_jobs:sgd_fit", "chip_smoke:mesh_rank_job",
                                    "chip_smoke:nccl_rank_job", "torch_mesh2d_jobs:sparse_fit",
                                    "torch_mesh2d_jobs:fleet_fit", "chip_smoke:mesh2d_rank_job",
                                    "chip_smoke:mesh_supervised_job",
                                    "flink_ml_tpu_torch.parallel.supervisor:supervised_rank"])
def test_what_a_rank_imports_leaves_jax_out(target):
    """A spawned rank imports its job by module path (launcher.resolve, in
    `_rank_main`): the mesh tests' jobs, chip_smoke's phase-16 and
    phase-17 jobs and the supervisor's rank entry pull in neither jax nor
    flink_ml_tpu."""
    code = (
        "import sys, inspect\n"
        f"sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'tests')!r}]\n"
        "from flink_ml_tpu_torch.parallel import launcher\n"
        "assert 'resolve(path)' in inspect.getsource(launcher._rank_main)\n"
        f"assert callable(launcher.resolve({target!r}))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flink_ml_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_operator_tools_are_checked():
    """Every scripts/torch_*.py is parsed below: the six tools, each beside
    the JAX script it ports, and the kernel-design script."""
    scripts = {p for p in PORT_FILES if p.parent == REPO / "scripts"}
    assert set((REPO / "scripts").glob("torch_*.py")) <= scripts
    for name in TOOL_SCRIPTS:
        assert (REPO / "scripts" / name[len("torch_"):]).exists()


def test_the_slice_modules_are_checked():
    """The fleet and the reference-format codecs are port modules like the
    rest: imported without JAX above and parsed below."""
    for name in ("flink_ml_tpu_torch.fleet", "flink_ml_tpu_torch.utils.javacodec"):
        assert name in PORT_MODULES
    assert {REPO / "flink_ml_tpu_torch" / "fleet.py",
            REPO / "flink_ml_tpu_torch" / "utils" / "javacodec.py"} <= set(PORT_FILES)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_import(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "flink_ml_tpu"}, roots


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _data():
    rng = np.random.default_rng(0)
    return rng.random((40, 3)), (rng.random(40) > 0.5).astype(np.float64)


def test_device_raises_without_card_or_cpu_request(no_card):
    with pytest.raises(RuntimeError, match="CUDA"):
        config.device()
    with config.use_device("cpu") as dev:
        assert config.device() == dev == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        config.device()


def test_fit_raises_without_card_or_cpu_request(no_card):
    X, y = _data()
    with pytest.raises(RuntimeError, match="CUDA"):
        LogisticRegression().fit(Table({"features": X, "label": y}))


def test_transform_raises_without_card_or_cpu_request(no_card):
    X, _ = _data()
    model = LogisticRegressionModel()
    model.coefficient = np.ones(3)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.transform(Table({"features": X}))
    sparse = SparseBatch(3, np.zeros((40, 2), np.int32), np.ones((40, 2)))
    with pytest.raises(RuntimeError, match="CUDA"):
        model.transform(Table({"features": sparse}))


def _entry_points():
    """name -> call of each entry point of the later slices, on host data."""
    from flink_ml_tpu_torch import Pipeline
    from flink_ml_tpu_torch.models.classification.linearsvc import LinearSVC, LinearSVCModel
    from flink_ml_tpu_torch.models.classification.onlinelogisticregression import (
        OnlineLogisticRegression)
    from flink_ml_tpu_torch.models.clustering.kmeans import KMeans, KMeansModel
    from flink_ml_tpu_torch.models.clustering.onlinekmeans import (
        OnlineKMeans, OnlineKMeansModel, generate_random_model_data)
    from flink_ml_tpu_torch.models.feature.onehotencoder import OneHotEncoder, OneHotEncoderModel
    from flink_ml_tpu_torch.models.feature.standardscaler import StandardScaler, StandardScalerModel
    from flink_ml_tpu_torch.models.feature.vectorassembler import VectorAssembler
    from flink_ml_tpu_torch.models.regression.linearregression import (
        LinearRegression, LinearRegressionModel)

    X, y = _data()
    table = Table({"features": X, "label": y, "cat": (y * 2).astype(np.float64)})
    linear = {}
    for cls in (LinearSVCModel, LinearRegressionModel):
        linear[cls] = cls()
        linear[cls].coefficient = np.ones(3)
    kmeans = KMeansModel()
    kmeans.centroids, kmeans.weights = np.eye(2, 3), np.ones(2)
    online_kmeans = OnlineKMeansModel()
    online_kmeans.centroids, online_kmeans.weights = np.eye(2, 3), np.ones(2)
    stream = StreamTable.from_batches([table.take(np.arange(20)), table.take(np.arange(20, 40))])
    online_lr = OnlineLogisticRegression().set_initial_model_data(
        Table({"coefficient": [DenseVector(np.zeros(3))]}))
    online_km = OnlineKMeans().set_initial_model_data(generate_random_model_data(2, 3, 1.0))
    scaler = StandardScalerModel().set_input_col("features")
    scaler.mean, scaler.std = np.zeros(3), np.ones(3)
    encoder = OneHotEncoderModel().set_input_cols("cat").set_output_cols("v")
    encoder.category_sizes = np.array([3])
    return dict([
        ("LinearSVC.fit", lambda: LinearSVC().fit(table)),
        ("LinearSVCModel.transform", lambda: linear[LinearSVCModel].transform(table)),
        ("LinearRegression.fit", lambda: LinearRegression().fit(table)),
        ("LinearRegressionModel.transform", lambda: linear[LinearRegressionModel].transform(table)),
        ("KMeans.fit", lambda: KMeans().fit(table)),
        ("KMeansModel.transform", lambda: kmeans.transform(table)),
        ("StandardScaler.fit", lambda: StandardScaler().set_input_col("features").fit(table)),
        ("StandardScalerModel.transform", lambda: scaler.transform(table)),
        ("OneHotEncoder.fit",
         lambda: OneHotEncoder().set_input_cols("cat").set_output_cols("v").fit(table)),
        ("OneHotEncoderModel.transform", lambda: encoder.transform(table)),
        ("VectorAssembler.transform",
         lambda: VectorAssembler().set_input_cols("features", "cat").transform(table)),
        ("Pipeline.fit", lambda: Pipeline([LinearSVC()]).fit(table)),
        ("LogisticRegression.fit on a StreamTable", lambda: LogisticRegression().fit(stream)),
        ("KMeans.fit on a StreamTable", lambda: KMeans().fit(stream)),
        ("OnlineLogisticRegression.fit", lambda: online_lr.fit(stream).process_updates()),
        ("OnlineKMeans.fit", lambda: online_km.fit(stream).process_updates()),
        ("OnlineKMeansModel.transform", lambda: online_kmeans.transform(table)),
        *_feature_entry_points(table, stream),
        *_text_entry_points(),
        *_stats_entry_points(),
        *_slice8_entry_points(),
        *_slice9_entry_points(),
        *_serving_entry_points(),
    ])


def _serving_entry_points():
    """(name, call) of the serving slice: a server (built and driven), a
    model store's page-in and a lifecycle's canary gate, on host data."""
    from flink_ml_tpu_torch import PipelineModel
    from flink_ml_tpu_torch.data.modelstore import ModelStore
    from flink_ml_tpu_torch.lifecycle import ModelLifecycle
    from flink_ml_tpu_torch.models.classification.onlinelogisticregression import (
        OnlineLogisticRegressionModel)
    from flink_ml_tpu_torch.serving import MicroBatchServer

    X, _ = _data()
    table = Table({"features": X})
    model = LogisticRegressionModel()
    model.coefficient = np.ones(3)

    def serve():
        return list(MicroBatchServer(PipelineModel([model])).serve([table]))

    def page_in():
        store = ModelStore(budget_bytes=None)
        store.register("t", PipelineModel([model]))
        store.page_in("t")

    def canary_gate():
        online = OnlineLogisticRegressionModel()
        online.publish_model_arrays((np.ones(3),), 1)
        ModelLifecycle(online, canary={"features": X.astype(np.float32)}).promote((np.ones(3),))

    return [("MicroBatchServer.serve", serve), ("ModelStore.page_in", page_in),
            ("ModelLifecycle.promote with a canary", canary_gate)]


def _feature_entry_points(table, stream):
    """(name, call) of each numeric feature stage's fit and transform, and
    of the three stream fits; the models are fitted on the CPU first."""
    import importlib

    def stage(module, cls, **params):
        obj = getattr(importlib.import_module(f"flink_ml_tpu_torch.models.feature.{module}"), cls)()
        for name, value in params.items():
            getattr(obj, f"set_{name}")(*value if isinstance(value, tuple) else (value,))
        return obj

    vec = dict(input_col="features", output_col="o")
    transformers = {
        "Binarizer": stage("binarizer", "Binarizer", input_cols=("label",), output_cols=("o",),
                           thresholds=(0.5,)),
        "VectorSlicer": stage("vectorslicer", "VectorSlicer", indices=(0, 2), **vec),
        "ElementwiseProduct": stage("elementwiseproduct", "ElementwiseProduct",
                                    scaling_vec=DenseVector(np.ones(3)), **vec),
        "Normalizer": stage("normalizer", "Normalizer", **vec),
        "Interaction": stage("interaction", "Interaction", input_cols=("features", "label"),
                             output_col="o"),
        "PolynomialExpansion": stage("polynomialexpansion", "PolynomialExpansion", **vec),
        "DCT": stage("dct", "DCT", **vec),
        "Bucketizer": stage("bucketizer", "Bucketizer", input_cols=("label",), output_cols=("o",),
                            splits_array=[[0.0, 0.5, 1.0]]),
    }
    estimators = {
        "MaxAbsScaler": stage("maxabsscaler", "MaxAbsScaler", **vec),
        "MinMaxScaler": stage("minmaxscaler", "MinMaxScaler", **vec),
        "VarianceThresholdSelector": stage("variancethresholdselector",
                                           "VarianceThresholdSelector", **vec),
        "VectorIndexer": stage("vectorindexer", "VectorIndexer", **vec),
        "KBinsDiscretizer": stage("kbinsdiscretizer", "KBinsDiscretizer", **vec),
        "RobustScaler": stage("robustscaler", "RobustScaler", **vec),
        "Imputer": stage("imputer", "Imputer", input_cols=("label",), output_cols=("o",)),
    }
    with config.use_device("cpu"):
        models = {name: est.fit(table) for name, est in estimators.items()}
    calls = [(f"{name}.transform", lambda s=s: s.transform(table)) for name, s in transformers.items()]
    for name, est in estimators.items():
        calls.append((f"{name}.fit", lambda e=est: e.fit(table)))
        calls.append((f"{name}Model.transform", lambda m=models[name]: m.transform(table)))
    for name in ("KBinsDiscretizer", "RobustScaler", "Imputer"):
        calls.append((f"{name}.fit on a StreamTable", lambda e=estimators[name]: e.fit(stream)))
    return calls


def _text_entry_points():
    """(name, call) of each string and token stage's fit and transform, on
    a dictionary-encoded token column, strings and numbers; the models are
    fitted on the CPU first."""
    from flink_ml_tpu_torch.models.feature import (
        countvectorizer, featurehasher, hashingtf, idf, ngram, regextokenizer, stopwordsremover,
        stringindexer, tokenizer)
    from flink_ml_tpu_torch.table import DictTokenMatrix

    ids = np.random.default_rng(1).integers(-1, 4, (40, 5)).astype(np.int32)
    table = Table({"tok": DictTokenMatrix(np.asarray(["a", "b", "the", "d"]), ids),
                   "s": np.asarray(["x y", "z"] * 20), "x": np.arange(40.0)})
    cv = countvectorizer.CountVectorizer().set_input_col("tok")
    idf_est = idf.IDF().set_input_col("x")
    indexer = stringindexer.StringIndexer().set_input_cols("s").set_output_cols("i")
    with config.use_device("cpu"):
        models = {"CountVectorizer": cv.fit(table), "IDF": idf_est.fit(table),
                  "StringIndexer": indexer.fit(table)}
    back = stringindexer.IndexToStringModel().set_input_cols("x").set_output_cols("r")
    back.string_arrays = [[str(i) for i in range(40)]]
    transformers = {
        "FeatureHasher": featurehasher.FeatureHasher().set_input_cols("x", "s"),
        "HashingTF": hashingtf.HashingTF().set_input_col("tok"),
        "NGram": ngram.NGram().set_input_col("tok"),
        "RegexTokenizer": regextokenizer.RegexTokenizer().set_input_col("s"),
        "StopWordsRemover": stopwordsremover.StopWordsRemover().set_input_cols("tok")
        .set_output_cols("o"),
        "Tokenizer": tokenizer.Tokenizer().set_input_col("s"),
        "IndexToStringModel": back,
    }
    calls = [(f"{name}.transform", lambda s=s: s.transform(table)) for name, s in transformers.items()]
    for name, est in (("CountVectorizer", cv), ("IDF", idf_est), ("StringIndexer", indexer)):
        calls.append((f"{name}.fit", lambda e=est: e.fit(table)))
        calls.append((f"{name}Model.transform", lambda m=models[name]: m.transform(table)))
    return calls


def _stats_entry_points():
    """(name, call) of each entry point of the statistics slice, RandomSplitter
    and Knn, on host columns; the models are fitted on the CPU first."""
    from flink_ml_tpu_torch.models.classification.knn import Knn
    from flink_ml_tpu_torch.models.classification.naivebayes import NaiveBayes
    from flink_ml_tpu_torch.models.evaluation.binaryclassification import (
        BinaryClassificationEvaluator)
    from flink_ml_tpu_torch.models.feature.randomsplitter import RandomSplitter
    from flink_ml_tpu_torch.models.feature.univariatefeatureselector import (
        UnivariateFeatureSelector)
    from flink_ml_tpu_torch.models.stats.anovatest import ANOVATest
    from flink_ml_tpu_torch.models.stats.chisqtest import ChiSqTest
    from flink_ml_tpu_torch.models.stats.fvaluetest import FValueTest

    rng = np.random.default_rng(2)
    table = Table({"features": rng.integers(0, 3, (40, 3)).astype(np.float64),
                   "label": (rng.random(40) > 0.5).astype(np.float64),
                   "rawPrediction": rng.random((40, 2))})
    selector = UnivariateFeatureSelector().set_feature_type("continuous") \
        .set_label_type("categorical").set_selection_threshold(2)
    estimators = {"UnivariateFeatureSelector": selector, "NaiveBayes": NaiveBayes(), "Knn": Knn()}
    with config.use_device("cpu"):
        models = {name: est.fit(table) for name, est in estimators.items()}
    transformers = {"ChiSqTest": ChiSqTest(), "ANOVATest": ANOVATest(), "FValueTest": FValueTest(),
                    "BinaryClassificationEvaluator": BinaryClassificationEvaluator(),
                    "RandomSplitter": RandomSplitter()}
    calls = [(f"{name}.transform", lambda s=s: s.transform(table)) for name, s in transformers.items()]
    for name, est in estimators.items():
        calls.append((f"{name}.fit", lambda e=est: e.fit(table)))
        calls.append((f"{name}Model.transform", lambda m=models[name]: m.transform(table)))
    return calls


def _slice9_entry_points():
    """(name, call) of FitFleet (linear and KMeans) and of a model loaded
    from the reference's binary layout, on host columns."""
    from flink_ml_tpu_torch.fleet import FitFleet
    from flink_ml_tpu_torch.models.clustering.kmeans import KMeans
    from flink_ml_tpu_torch.utils import read_write

    X, y = _data()
    table = Table({"features": X, "label": y})
    fixture = REPO / "tests" / "fixtures" / "reference_lr_pipelinemodel"
    reference = read_write.load_stage(str(fixture))  # host work: loads without a card
    wide = Table({"features": np.ones((4, 4))})
    return [
        ("FitFleet.fit", lambda: FitFleet([LogisticRegression().set_max_iter(2)] * 2).fit(table)),
        ("FitFleet.fit of KMeans", lambda: FitFleet([KMeans().set_seed(s) for s in (1, 2)]).fit(table)),
        ("reference-format PipelineModel.transform", lambda: reference.transform(wide)),
    ]


def _slice8_entry_points():
    """(name, call) of AgglomerativeClustering, MinHashLSH, SQLTransformer
    and Graph/GraphModel on host columns; the models are fitted on the CPU
    first."""
    from flink_ml_tpu_torch.graph import GraphBuilder
    from flink_ml_tpu_torch.models.clustering.agglomerativeclustering import (
        AgglomerativeClustering)
    from flink_ml_tpu_torch.models.feature.lsh import MinHashLSH
    from flink_ml_tpu_torch.models.feature.sqltransformer import SQLTransformer
    from flink_ml_tpu_torch.models.feature.standardscaler import StandardScaler

    X, y = _data()
    table = Table({"features": X, "label": y})
    lsh = MinHashLSH().set_input_col("features").set_output_col("hashes")
    builder = GraphBuilder()
    source = builder.create_table_id()
    out = builder.add_estimator(StandardScaler().set_input_col("features"), [source])
    graph = builder.build_estimator([source], [out[0]])
    with config.use_device("cpu"):
        models = {"MinHashLSH": lsh.fit(table), "Graph": graph.fit(table)}
    return [
        ("AgglomerativeClustering.transform", lambda: AgglomerativeClustering().transform(table)),
        ("MinHashLSH.fit", lambda: lsh.fit(table)),
        ("MinHashLSHModel.transform", lambda: models["MinHashLSH"].transform(table)),
        ("SQLTransformer.transform",
         lambda: SQLTransformer().set_statement("SELECT *, label + 1 AS l FROM __THIS__")
         .transform(table)),
        ("Graph.fit", lambda: graph.fit(table)),
        ("GraphModel.transform", lambda: models["Graph"].transform(table)),
    ]


STATS_TRANSFORMERS = ["ChiSqTest", "ANOVATest", "FValueTest", "BinaryClassificationEvaluator",
                      "RandomSplitter"]
STATS_ESTIMATORS = ["UnivariateFeatureSelector", "NaiveBayes", "Knn"]
TEXT_TRANSFORMERS = ["FeatureHasher", "HashingTF", "NGram", "RegexTokenizer", "StopWordsRemover",
                     "Tokenizer", "IndexToStringModel"]
TEXT_ESTIMATORS = ["CountVectorizer", "IDF", "StringIndexer"]
FEATURE_STAGES = ["Binarizer", "VectorSlicer", "ElementwiseProduct", "Normalizer", "Interaction",
                  "PolynomialExpansion", "DCT", "Bucketizer"]
FEATURE_ESTIMATORS = ["MaxAbsScaler", "MinMaxScaler", "VarianceThresholdSelector", "VectorIndexer",
                      "KBinsDiscretizer", "RobustScaler", "Imputer"]


ENTRY_POINTS = [
    "LinearSVC.fit", "LinearSVCModel.transform", "LinearRegression.fit",
    "LinearRegressionModel.transform", "KMeans.fit", "KMeansModel.transform",
    "StandardScaler.fit", "StandardScalerModel.transform", "OneHotEncoder.fit",
    "OneHotEncoderModel.transform", "VectorAssembler.transform", "Pipeline.fit",
    "LogisticRegression.fit on a StreamTable", "KMeans.fit on a StreamTable",
    "OnlineLogisticRegression.fit", "OnlineKMeans.fit", "OnlineKMeansModel.transform",
    *[f"{name}.transform" for name in FEATURE_STAGES],
    *[f"{name}{kind}" for name in FEATURE_ESTIMATORS for kind in (".fit", "Model.transform")],
    *[f"{name}.fit on a StreamTable" for name in ("KBinsDiscretizer", "RobustScaler", "Imputer")],
    *[f"{name}.transform" for name in TEXT_TRANSFORMERS],
    *[f"{name}{kind}" for name in TEXT_ESTIMATORS for kind in (".fit", "Model.transform")],
    *[f"{name}.transform" for name in STATS_TRANSFORMERS],
    *[f"{name}{kind}" for name in STATS_ESTIMATORS for kind in (".fit", "Model.transform")],
    "AgglomerativeClustering.transform", "MinHashLSH.fit", "MinHashLSHModel.transform",
    "SQLTransformer.transform", "Graph.fit", "GraphModel.transform",
    "FitFleet.fit", "FitFleet.fit of KMeans", "reference-format PipelineModel.transform",
    "MicroBatchServer.serve", "ModelStore.page_in", "ModelLifecycle.promote with a canary",
]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_later_entry_points_raise_without_card_or_cpu_request(no_card, name):
    calls = _entry_points()
    assert sorted(calls) == sorted(ENTRY_POINTS)
    call = calls[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    with config.use_device("cpu"):
        call()


def test_use_device_cuda_refuses_without_card(no_card):
    with pytest.raises(RuntimeError, match="CUDA"):
        with config.use_device("cuda"):
            pass


def test_chip_smoke_fails_without_a_card():
    """chip_smoke.py exits non-zero and prints no result line where there
    is no CUDA card (as here)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run for real")
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_rehearses_on_the_cpu():
    """scripts/rehearse_chip_smoke.py runs every phase and gate of
    chip_smoke.py on the CPU at small sizes (torch.cuda stubbed) and ends
    with the result line."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "rehearse_chip_smoke.py")],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1].startswith('{"ok": true')
    assert lines[-2].startswith('{"kernels"')
