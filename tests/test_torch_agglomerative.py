"""AgglomerativeClustering of the port against the JAX package's.

The same seeded numpy inputs go to both packages: the JAX side on a
one-device mesh (a device column is a `jax.Array`), the port under
`config.use_device("cpu")` (a device column is a CPU tensor). Both build
the float64 pairwise matrix with the same numpy formulas and run the same
merge loop (native/src/agglomerative.cc, built by each package's own
loader), so every comparison is exact: predictions, and the merge log's
ids, distances and sizes. Covered: every linkage under the three stop
modes (numClusters, distanceThreshold, computeFullTree) on three datasets
(uniform, an integer grid with heavy ties, duplicated rows), cosine and
manhattan, count and event-time windows (unsorted timestamps included),
the ward/cosine error, save/load both ways; and the native loop against
the port's numpy loop, its plain version, on the tied grid and on an input
where the JAX package's own two loops differ (ROADMAP C.15).
"""

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.common import window as jax_window
from flink_ml_tpu.models.clustering import agglomerativeclustering as jax_agg
from flink_ml_tpu.parallel import mesh as mesh_lib
from flink_ml_tpu_torch import Table, config, native
from flink_ml_tpu_torch.api import Stage
from flink_ml_tpu_torch.common import window as port_window
from flink_ml_tpu_torch.models.clustering import agglomerativeclustering as port_agg

LINKAGES = ["ward", "complete", "single", "average"]
STOPS = {"numClusters": dict(num_clusters=4), "distanceThreshold": None,
         "computeFullTree": dict(num_clusters=3, compute_full_tree=True)}
DATASETS = ["uniform", "grid_ties", "duplicates"]


@pytest.fixture(autouse=True)
def both_on_one_device():
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            yield


def _data(name, n=60, d=3, seed=0):
    rng = np.random.default_rng(seed)
    if name == "uniform":
        return rng.random((n, d))
    if name == "grid_ties":
        return rng.integers(0, 4, (n, d)).astype(np.float64)
    base = rng.random((n // 3, d))
    return np.concatenate([base, base, base[::-1]])


def _threshold(name):
    """A threshold that stops the uniform and tied data mid-way."""
    return {"uniform": 0.4, "grid_ties": 1.5, "duplicates": 0.3}[name]


def _stages(**params):
    out = []
    for m in (jax_agg, port_agg):
        stage = m.AgglomerativeClustering()
        for name, value in params.items():
            getattr(stage, f"set_{name}")(value)
        out.append(stage)
    return out


def _host(col):
    return col.numpy() if isinstance(col, torch.Tensor) else np.asarray(col)


def _assert_same(jax_out, port_out):
    (jo, jm), (po, pm) = jax_out, port_out
    np.testing.assert_array_equal(_host(po.column("prediction")), np.asarray(jo.column("prediction")))
    assert pm.column_names == jm.column_names == ["clusterId1", "clusterId2", "distance",
                                                  "sizeOfMergedCluster"]
    assert pm.num_rows == jm.num_rows
    for name in jm.column_names:
        np.testing.assert_array_equal(_host(pm.column(name)), np.asarray(jm.column(name)))
    for name in jo.column_names:
        np.testing.assert_array_equal(_host(po.column(name)), np.asarray(jo.column(name)))


def _tables(X, device, **extra):
    """(JAX table, port table): float64 numpy columns, or a float32
    jax.Array against a float32 tensor."""
    if device:
        X32 = X.astype(np.float32)
        return (JaxTable({"features": jax.device_put(X32), **extra}),
                Table({"features": torch.from_numpy(X32.copy()), **extra}))
    return JaxTable({"features": X, **extra}), Table({"features": X.copy(), **extra})


@pytest.mark.parametrize("device", [False, True], ids=["numpy", "device"])
@pytest.mark.parametrize("stop", sorted(STOPS))
@pytest.mark.parametrize("linkage", LINKAGES)
@pytest.mark.parametrize("dataset", DATASETS)
def test_linkages_and_stops_equal_jax(dataset, linkage, stop, device):
    X = _data(dataset)
    params = STOPS[stop] or dict(distance_threshold=_threshold(dataset))
    jax_stage, port_stage = _stages(linkage=linkage, **params)
    jax_table, port_table = _tables(X, device)
    _assert_same(jax_stage.transform(jax_table), port_stage.transform(port_table))


@pytest.mark.parametrize("device", [False, True], ids=["numpy", "device"])
@pytest.mark.parametrize("linkage", ["average", "complete", "single"])
@pytest.mark.parametrize("measure", ["cosine", "manhattan"])
def test_cosine_and_manhattan_equal_jax(measure, linkage, device):
    X = _data("uniform", seed=1) - 0.5
    jax_stage, port_stage = _stages(linkage=linkage, distance_measure=measure, num_clusters=5)
    jax_table, port_table = _tables(X, device)
    _assert_same(jax_stage.transform(jax_table), port_stage.transform(port_table))


def test_prediction_stays_on_the_features_device():
    _, port_stage = _stages(num_clusters=3)
    out, merges = port_stage.transform(_tables(_data("uniform"), True)[1])
    assert isinstance(out.column("prediction"), torch.Tensor)
    assert out.column("prediction").dtype == torch.int32
    assert isinstance(merges.column("distance"), np.ndarray)


@pytest.mark.parametrize("device", [False, True], ids=["numpy", "device"])
@pytest.mark.parametrize("windows", ["count", "count_ragged", "event_tumbling", "event_unsorted",
                                     "event_session", "processing"])
def test_windows_equal_jax(windows, device):
    rng = np.random.default_rng(4)
    X = rng.random((50, 2))
    ts = np.repeat([0, 1000, 2000, 3000, 4000], 10)
    if windows == "event_unsorted":
        ts = rng.permutation(ts) + rng.integers(0, 100, 50)
    make = {
        "count": lambda w: w.CountTumblingWindows.of(10),
        "count_ragged": lambda w: w.CountTumblingWindows.of(15),
        "event_tumbling": lambda w: w.EventTimeTumblingWindows.of(1000),
        "event_unsorted": lambda w: w.EventTimeTumblingWindows.of(2000),
        "event_session": lambda w: w.EventTimeSessionWindows.with_gap(500),
        "processing": lambda w: w.ProcessingTimeTumblingWindows.of(1000),
    }[windows]
    jax_stage, port_stage = _stages(num_clusters=2)
    jax_stage.set_windows(make(jax_window))
    port_stage.set_windows(make(port_window))
    jax_table, port_table = _tables(X, device, timestamp=ts)
    _assert_same(jax_stage.transform(jax_table), port_stage.transform(port_table))


def test_event_windows_need_a_timestamp_column():
    _, port_stage = _stages()
    port_stage.set_windows(port_window.EventTimeTumblingWindows.of(10))
    with pytest.raises(ValueError, match="timestamp"):
        port_stage.transform(Table({"features": np.random.default_rng(0).random((4, 2))}))


@pytest.mark.parametrize("measure", ["cosine", "manhattan"])
def test_ward_needs_euclidean_as_in_jax(measure):
    jax_stage, port_stage = _stages(linkage="ward", distance_measure=measure)
    X = _data("uniform")
    with pytest.raises(ValueError, match="Ward only works with euclidean") as jax_err:
        jax_stage.transform(JaxTable({"features": X}))
    with pytest.raises(ValueError, match="Ward only works with euclidean") as port_err:
        port_stage.transform(Table({"features": X}))
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("stop", sorted(STOPS))
@pytest.mark.parametrize("linkage", LINKAGES)
def test_native_loop_equals_numpy_loop_on_ties(linkage, stop):
    """The stage's native loop and its plain version take the same merges
    in the same order on an integer grid full of tied distances."""
    X = _data("grid_ties", n=90, d=2, seed=5)
    params = STOPS[stop] or dict(distance_threshold=_threshold("grid_ties"))
    args = (linkage, params.get("num_clusters", 2), params.get("distance_threshold"),
            params.get("compute_full_tree", False))
    dist = port_agg.distance_matrix(X, "euclidean")
    pred_n, merges_n = port_agg.cluster_block_native(dist.copy(), *args)
    pred_p, merges_p = port_agg.cluster_block_plain(dist.copy(), *args)
    np.testing.assert_array_equal(pred_n, pred_p)
    assert merges_n == merges_p


def test_pairwise_matrix_is_the_jax_packages():
    X = _data("uniform", seed=2)
    for measure in ("euclidean", "cosine", "manhattan"):
        np.testing.assert_array_equal(port_agg.pairwise_host(X, measure),
                                      jax_agg._pairwise_host(X, measure))


def test_the_stage_has_no_numpy_fallback(monkeypatch):
    """Without its native library the stage raises; it never runs the numpy loop."""
    def missing():
        raise RuntimeError("g++ failed to build agglomerative.cc")

    monkeypatch.setattr(port_agg, "load_agglomerative", missing)
    monkeypatch.setattr(port_agg, "cluster_block_plain", lambda *a: pytest.fail("numpy loop ran"))
    _, port_stage = _stages()
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        port_stage.transform(Table({"features": _data("uniform")}))


def test_a_failed_native_build_raises_with_the_compiler_output(tmp_path):
    broken = tmp_path / "agglomerative.cc"
    broken.write_text("extern \"C\" long agg_cluster( {\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native._open(broken, tmp_path / "lib.so", native.AGG_GXX_FLAGS)
    assert "error" in str(err.value)
    assert "-ffp-contract=off" in native.AGG_GXX_FLAGS


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_save_load_both_ways(direction, tmp_path):
    jax_stage, port_stage = _stages(linkage="average", num_clusters=3, compute_full_tree=True)
    jax_stage.set_windows(jax_window.CountTumblingWindows.of(20))
    port_stage.set_windows(port_window.CountTumblingWindows.of(20))
    path = str(tmp_path / "agg")
    if direction == "jax_to_port":
        jax_stage.save(path)
        port_stage = Stage.load(path)
        assert isinstance(port_stage, port_agg.AgglomerativeClustering)
    else:
        port_stage.save(path)
        jax_stage = jax_agg.AgglomerativeClustering.load(path)
    assert port_stage.get_windows() == port_window.CountTumblingWindows.of(20)
    assert jax_stage.get_windows() == jax_window.CountTumblingWindows.of(20)
    X = _data("uniform", seed=3)
    _assert_same(jax_stage.transform(JaxTable({"features": X})),
                 port_stage.transform(Table({"features": X.copy()})))


def test_default_params_are_jax_s():
    jax_stage, port_stage = _stages()
    for p in jax_stage.get_param_map():
        port_p = port_stage.get_param(p.name)
        assert port_p is not None, p.name
        assert p.json_encode(jax_stage.get(p)) == port_p.json_encode(port_stage.get(port_p)), p.name


def test_plain_loop_squares_by_products_as_the_native_loop(monkeypatch):
    """ROADMAP C.15: the JAX package's numpy loop squares the merge distance
    with `d_ij**2` on a numpy float64 scalar, which goes through the C
    library's pow and is an ulp off d_ij * d_ij for a few values; its
    native loop multiplies. On this ward input the two JAX loops log
    different distances; the port's plain loop multiplies and equals the
    native loop, and the stage (native in both packages) equals JAX."""
    from flink_ml_tpu.ops.distance import DistanceMeasure

    X = np.random.default_rng(70).random((150, 4))
    measure = DistanceMeasure.get_instance("euclidean")
    jax_native = jax_agg._cluster_block(X, "ward", measure, 1, None, False)
    monkeypatch.setattr(jax_agg, "_cluster_block_native", lambda *args: None)
    jax_numpy = jax_agg._cluster_block(X, "ward", measure, 1, None, False)
    assert jax_numpy[1] != jax_native[1]
    dist = port_agg.distance_matrix(X, "euclidean")
    plain = port_agg.cluster_block_plain(dist.copy(), "ward", 1, None, False)
    native = port_agg.cluster_block_native(dist.copy(), "ward", 1, None, False)
    assert plain[1] == native[1] == jax_native[1]
    np.testing.assert_array_equal(plain[0], jax_native[0])
