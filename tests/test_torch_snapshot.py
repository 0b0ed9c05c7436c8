"""flink_ml_tpu_torch/ckpt/snapshot.py (the JobSnapshot format) against the
JAX package's, on the CPU.

Case for case the JAX package's tests/test_job_snapshot.py and the format
half of tests/test_checkpointing.py, each run on both packages where its
subject exists in the port, plus the cross-package reads: a snapshot or a
legacy `ckpt-*.npz` written by either package restores in the other,
bit for bit. Also: the port's pytree order against `jax.tree_util`, the
one packed copy of a save, the job keys of every checkpointable estimator
against the JAX package's, and the checkpoint contract (`checkpointable`)
of every port estimator against its JAX counterpart.
"""

import importlib
import inspect
import json
import os
import pkgutil
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flink_ml_tpu.ckpt import snapshot as jax_snapshot
from flink_ml_tpu.parallel import iteration as jax_iteration
from flink_ml_tpu_torch import config
from flink_ml_tpu_torch.ckpt import InjectedFault, faults
from flink_ml_tpu_torch.ckpt import snapshot as port_snapshot
from flink_ml_tpu_torch.parallel import iteration as port_iteration
from flink_ml_tpu_torch.utils import metrics

PKGS = ("jax", "port")


@pytest.fixture(autouse=True)
def on_cpu():
    with config.use_device("cpu"):
        yield


def _snap(pkg):
    return jax_snapshot if pkg == "jax" else port_snapshot


def _arr(pkg, a):
    """A device array of `pkg` holding numpy `a`."""
    return jnp.asarray(a) if pkg == "jax" else torch.as_tensor(np.asarray(a))


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


# ---------------------------------------------------------------------------
# pytrees
# ---------------------------------------------------------------------------

TREES = {
    "tuple": (1, (2, 3), [4, None, 5]),
    "dict": {"b": 1, "a": (2, 3), "c": {"z": 4, "y": 5}},
    "none": (None, 1, None),
    "list of tuples": [(1, 2), (3,), ()],
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_tree_order_is_jax_tree_util_order(name):
    tree = TREES[name]
    leaves, treedef = port_snapshot.tree_flatten(tree)
    assert leaves == jax.tree_util.tree_leaves(tree)
    assert port_snapshot.tree_unflatten(treedef, leaves) == tree


# ---------------------------------------------------------------------------
# format roundtrip (test_job_snapshot.py), on each package and across
# ---------------------------------------------------------------------------

def _save_multisection(pkg, path):
    model = (_arr(pkg, np.arange(6, dtype=np.float32)), np.float64([1.5, -2.5]),
             _arr(pkg, np.int32(3)))
    rng = (np.arange(8, dtype=np.uint32),)
    return _snap(pkg).save_job_snapshot(
        path, "job-a", {"model": model, "rng": rng}, epoch=4, criteria=0.125,
        specs={"model": ("replicated", "replicated", "replicated"), "rng": "host"},
        meta={"numBatches": 7, "streamOffset": 4},
    )


@pytest.mark.parametrize("writer,reader", [(w, r) for w in PKGS for r in PKGS])
def test_roundtrip_multisection(tmp_path, writer, reader):
    target = _save_multisection(writer, str(tmp_path))
    assert os.path.basename(target) == "snap-job-a.npz"
    template = (_arr(reader, np.zeros(6, np.float32)), np.zeros(2), _arr(reader, np.int32(0)))
    snap = _snap(reader).load_job_snapshot(str(tmp_path), "job-a", templates={"model": template})
    assert (snap.epoch, snap.criteria) == (4, 0.125)
    assert snap.meta == {"numBatches": 7, "streamOffset": 4}
    assert tuple(snap.specs["rng"]) == ("host",)
    c, f64, e = snap.sections["model"]
    np.testing.assert_array_equal(c, np.arange(6, dtype=np.float32))
    assert f64.dtype == np.float64
    np.testing.assert_array_equal(f64, [1.5, -2.5])
    assert int(e) == 3 and np.asarray(e).dtype == np.int32
    np.testing.assert_array_equal(snap.sections["rng"][0], np.arange(8, dtype=np.uint32))


def test_the_two_packages_write_the_same_manifest(tmp_path):
    manifests = {}
    for pkg in PKGS:
        target = _save_multisection(pkg, str(tmp_path / pkg))
        with np.load(target) as f:
            manifests[pkg] = json.loads(str(f["manifest"]))
            files = sorted(f.files)
        manifests[pkg]["files"] = files
    assert manifests["port"] == manifests["jax"]


@pytest.mark.parametrize("pkg", PKGS)
def test_save_gathers_device_leaves_in_one_sync(tmp_path, pkg):
    from flink_ml_tpu.utils import metrics as jax_metrics

    reg = jax_metrics if pkg == "jax" else metrics
    before = reg.get_counter("iteration.host_sync.checkpoint")
    leaves = (_arr(pkg, np.zeros(4, np.float32)), _arr(pkg, np.ones(3, np.float32)),
              _arr(pkg, np.int32(5)))
    _snap(pkg).save_job_snapshot(str(tmp_path), "k", {"model": leaves}, epoch=1)
    assert reg.get_counter("iteration.host_sync.checkpoint") == before + 1


def test_the_packed_copy_keeps_every_dtype_bit_for_bit():
    from flink_ml_tpu_torch.utils.packing import packed_bytes_get

    rng = np.random.default_rng(0)
    leaves = [rng.standard_normal((3, 5)).astype(np.float32), np.int32(2**30 + 7),
              rng.standard_normal(4), np.arange(6, dtype=np.int64) * 2**40,
              rng.standard_normal((5, 3)).astype(np.float32).T]
    got = packed_bytes_get(*[torch.as_tensor(np.asarray(a)) for a in leaves],
                           sync_kind="checkpoint")
    for want, have in zip(leaves, got):
        assert have.dtype == np.asarray(want).dtype and have.shape == np.shape(want)
        np.testing.assert_array_equal(have, want)


# ---------------------------------------------------------------------------
# atomicity: torn writes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_torn_save_leaves_previous_snapshot_intact(tmp_path, pkg):
    S = _snap(pkg)
    template = _arr(pkg, np.zeros(5, np.float32))
    S.save_job_snapshot(str(tmp_path), "j", {"model": _arr(pkg, np.arange(5.0, dtype=np.float32))},
                        epoch=1)
    fault_mod = faults if pkg == "port" else jax_faults()
    with fault_mod.inject("snapshot.write"):
        with pytest.raises(fault_mod.InjectedFault):
            S.save_job_snapshot(str(tmp_path), "j",
                                {"model": _arr(pkg, 10 * np.arange(5.0, dtype=np.float32))},
                                epoch=2)
    snap = S.load_job_snapshot(str(tmp_path), "j", templates={"model": template})
    assert snap.epoch == 1
    np.testing.assert_array_equal(snap.sections["model"], np.arange(5.0, dtype=np.float32))
    S.save_job_snapshot(str(tmp_path), "j",
                        {"model": _arr(pkg, 10 * np.arange(5.0, dtype=np.float32))}, epoch=2)
    snap = S.load_job_snapshot(str(tmp_path), "j", templates={"model": template})
    assert snap.epoch == 2
    np.testing.assert_array_equal(snap.sections["model"], 10 * np.arange(5.0, dtype=np.float32))


def jax_faults():
    from flink_ml_tpu.ckpt import faults as jf

    return jf


def _sgd_problem(seed, n=300, d=6):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X @ np.linspace(1, -1, d) > 0).astype(np.float32)
    return X, y


def _port_fit(X, y, ckpt, key, max_iter=12, batch=100):
    from flink_ml_tpu_torch.ops import losses
    from flink_ml_tpu_torch.ops.optimizer import SGD

    return SGD(max_iter=max_iter, global_batch_size=batch, tol=0.0, checkpoint_dir=ckpt,
               checkpoint_key=key).optimize(np.zeros(X.shape[1]), X, y, None,
                                            losses.BINARY_LOGISTIC_LOSS)


def test_kill_during_snapshot_save_resumes_from_previous(tmp_path):
    X, y = _sgd_problem(3)
    ckpt = str(tmp_path / "ckpt")
    expected, _, _ = _port_fit(X, y, ckpt, "torn")
    os.remove(port_snapshot.snapshot_file(ckpt, "torn"))
    with faults.inject("snapshot.write", after=5):
        with pytest.raises(InjectedFault):
            _port_fit(X, y, ckpt, "torn")
    template = (np.zeros(6, np.float32), np.zeros(6, np.float32), np.float32(0), np.int32(0))
    snap = port_snapshot.load_job_snapshot(ckpt, "torn", templates={"model": template})
    assert snap is not None and snap.epoch == 4
    resumed, _, epochs = _port_fit(X, y, ckpt, "torn")
    assert epochs == 12
    np.testing.assert_array_equal(resumed, expected)


# ---------------------------------------------------------------------------
# guards: versioning, structure, meta cursors
# ---------------------------------------------------------------------------

def _rewrite_manifest(file, mutate):
    with np.load(file) as f:
        arrays = {k: f[k] for k in f.files}
    manifest = json.loads(str(arrays.pop("manifest")))
    mutate(manifest)
    np.savez(file, manifest=np.asarray(json.dumps(manifest)), **arrays)


@pytest.mark.parametrize("pkg", PKGS)
def test_future_format_version_refused(tmp_path, pkg):
    S = _snap(pkg)
    file = S.save_job_snapshot(str(tmp_path), "v", {"model": _arr(pkg, np.zeros(3))}, epoch=2)
    _rewrite_manifest(file, lambda m: m.update(version=99))
    with pytest.warns(UserWarning, match="format version 99"):
        snap = S.load_job_snapshot(str(tmp_path), "v", templates={"model": _arr(pkg, np.zeros(3))})
    assert snap is None


@pytest.mark.parametrize("pkg", PKGS)
def test_foreign_structure_refused(tmp_path, pkg):
    S = _snap(pkg)
    S.save_job_snapshot(str(tmp_path), "s", {"model": _arr(pkg, np.zeros(4))}, epoch=1)
    with pytest.warns(UserWarning, match="structurally incompatible"):
        snap = S.load_job_snapshot(str(tmp_path), "s", templates={"model": _arr(pkg, np.zeros(5))})
    assert snap is None


@pytest.mark.parametrize("pkg", PKGS)
def test_meta_cursor_mismatch_refused(tmp_path, pkg):
    S = _snap(pkg)
    S.save_job_snapshot(str(tmp_path), "m", {"model": _arr(pkg, np.zeros(4))}, epoch=1,
                        meta={"numBatches": 10})
    template = {"model": _arr(pkg, np.zeros(4))}
    with pytest.warns(UserWarning, match="numBatches"):
        snap = S.load_job_snapshot(str(tmp_path), "m", templates=template,
                                   expect_meta={"numBatches": 7})
    assert snap is None
    assert S.load_job_snapshot(str(tmp_path), "m", templates=template,
                               expect_meta={"numBatches": 10}) is not None


@pytest.mark.parametrize("pkg", PKGS)
def test_unkeyed_restore_warns_keyed_does_not(tmp_path, pkg):
    S = _snap(pkg)
    S.save_job_snapshot(str(tmp_path), None, {"model": _arr(pkg, np.zeros(2))}, epoch=1)
    with pytest.warns(UserWarning, match="un-keyed"):
        assert S.load_job_snapshot(str(tmp_path), None, templates={"model": _arr(pkg, np.zeros(2))})
    S.save_job_snapshot(str(tmp_path), "keyed", {"model": _arr(pkg, np.zeros(2))}, epoch=1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert S.load_job_snapshot(str(tmp_path), "keyed",
                                   templates={"model": _arr(pkg, np.zeros(2))})


@pytest.mark.parametrize("pkg", PKGS)
def test_corrupt_leaf_fails_loudly_naming_the_leaf(tmp_path, pkg):
    from flink_ml_tpu.ckpt.coordinator import SnapshotIntegrityError as JaxIntegrity
    from flink_ml_tpu_torch.ckpt.coordinator import SnapshotIntegrityError

    S = _snap(pkg)
    file = S.save_job_snapshot(str(tmp_path), "rot", {"model": _arr(pkg, np.arange(4.0))}, epoch=1)
    with np.load(file) as f:
        arrays = {k: f[k] for k in f.files}
    arrays["s_model_0"] = arrays["s_model_0"] + 1
    np.savez(file, **arrays)
    with pytest.raises(JaxIntegrity if pkg == "jax" else SnapshotIntegrityError,
                       match="s_model_0"):
        S.load_job_snapshot(str(tmp_path), "rot", templates={"model": _arr(pkg, np.zeros(4))})


# ---------------------------------------------------------------------------
# legacy migration (one way), both packages' writers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [(w, r) for w in PKGS for r in PKGS])
def test_legacy_checkpoint_reads_through_snapshot_loader(tmp_path, writer, reader):
    save = (jax_iteration if writer == "jax" else port_iteration).save_iteration_checkpoint
    save(str(tmp_path), (_arr(writer, np.asarray([1.0, 2.0], np.float32)),
                         _arr(writer, np.int32(7))), epoch=3, criteria=0.5, job_key="lg")
    carry = (_arr(reader, np.zeros(2, np.float32)), _arr(reader, np.int32(0)))
    with pytest.warns(UserWarning, match="legacy checkpoint"):
        snap = _snap(reader).load_job_snapshot(str(tmp_path), "lg", templates={"model": carry})
    assert (snap.epoch, snap.criteria, snap.version) == (3, 0.5, 0)
    assert snap.meta["migratedFrom"].startswith("ckpt-")
    np.testing.assert_array_equal(snap.sections["model"][0], [1.0, 2.0])
    assert int(snap.sections["model"][1]) == 7


def test_legacy_sgd_checkpoint_resumes_and_migrates(tmp_path):
    X, y = _sgd_problem(5)
    y = 1.0 - y
    expected, _, _ = _port_fit(X, y, str(tmp_path / "ref"), "mig", max_iter=15)
    leg_dir = str(tmp_path / "legacy")
    _port_fit(X, y, leg_dir, "mig", max_iter=6)
    template = (np.zeros(6, np.float32), np.zeros(6, np.float32), np.float32(0), np.int32(0))
    snap = port_snapshot.load_job_snapshot(leg_dir, "mig", templates={"model": template})
    assert snap.epoch == 6
    port_iteration.save_iteration_checkpoint(leg_dir, snap.sections["model"], snap.epoch,
                                             snap.criteria, "mig")
    os.remove(port_snapshot.snapshot_file(leg_dir, "mig"))
    with pytest.warns(UserWarning, match="legacy checkpoint"):
        resumed, _, epochs = _port_fit(X, y, leg_dir, "mig", max_iter=15)
    assert epochs == 15
    np.testing.assert_array_equal(resumed, expected)
    assert os.path.exists(port_snapshot.snapshot_file(leg_dir, "mig"))


# ---------------------------------------------------------------------------
# staging (one card: every non-host tag is the caller's device)
# ---------------------------------------------------------------------------

def test_stage_section_puts_leaves_on_the_device_and_keeps_host_leaves(tmp_path):
    coeff, rows = torch.arange(16.0), torch.arange(32.0).reshape(8, 4)
    port_snapshot.save_job_snapshot(
        str(tmp_path), "el", {"model": (coeff, rows, np.float64(2.0), torch.tensor(3))},
        epoch=1, specs={"model": ("replicated", "data", "host", "replicated")})
    snap = port_snapshot.load_job_snapshot(
        str(tmp_path), "el",
        templates={"model": (torch.zeros(16), torch.zeros(8, 4), np.float64(0), torch.tensor(0))})
    c, r, host_leaf, e = port_snapshot.stage_section(snap, "model", device=torch.device("cpu"))
    assert isinstance(c, torch.Tensor) and isinstance(r, torch.Tensor) and isinstance(e, torch.Tensor)
    assert torch.equal(c, coeff) and torch.equal(r, rows) and e.shape == () and int(e) == 3
    assert e.dtype == torch.int64
    assert isinstance(host_leaf, np.ndarray) and float(host_leaf) == 2.0


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------

def test_checkpoint_counters_and_spans(tmp_path):
    from flink_ml_tpu_torch.obs import tracing

    count0 = metrics.get_counter("checkpoint.count")
    bytes0 = metrics.get_counter("checkpoint.bytes")
    restore0 = metrics.get_counter("checkpoint.restore.count")
    tracing.configure(ring_size=64)
    try:
        port_snapshot.save_job_snapshot(str(tmp_path), "obs", {"model": torch.zeros(8)}, epoch=1)
        assert port_snapshot.load_job_snapshot(str(tmp_path), "obs",
                                               templates={"model": torch.zeros(8)})
        names = [r["name"] for r in tracing.drain_ring()]
    finally:
        tracing.configure()
    assert "checkpoint.save" in names and "checkpoint.restore" in names
    assert metrics.get_counter("checkpoint.count") == count0 + 1
    assert metrics.get_counter("checkpoint.bytes") == bytes0 + 8 * 4
    assert metrics.get_counter("checkpoint.restore.count") == restore0 + 1


# ---------------------------------------------------------------------------
# test_checkpointing.py: job keys, intervals, corrupt files
# ---------------------------------------------------------------------------

def _estimator_pairs():
    """(name, jax estimator, port estimator) with the same non-default
    params, for every checkpointable estimator."""
    from flink_ml_tpu.models.classification import linearsvc as jl_svc
    from flink_ml_tpu.models.classification import logisticregression as jl_lr
    from flink_ml_tpu.models.classification import onlinelogisticregression as jl_olr
    from flink_ml_tpu.models.clustering import kmeans as jl_km
    from flink_ml_tpu.models.clustering import onlinekmeans as jl_okm
    from flink_ml_tpu.models.regression import linearregression as jl_linr
    from flink_ml_tpu_torch.models.classification import linearsvc as pl_svc
    from flink_ml_tpu_torch.models.classification import logisticregression as pl_lr
    from flink_ml_tpu_torch.models.classification import onlinelogisticregression as pl_olr
    from flink_ml_tpu_torch.models.clustering import kmeans as pl_km
    from flink_ml_tpu_torch.models.clustering import onlinekmeans as pl_okm
    from flink_ml_tpu_torch.models.regression import linearregression as pl_linr

    def lin(mod, cls):
        return getattr(mod, cls)().set_reg(0.1).set_elastic_net(0.5).set_global_batch_size(64) \
            .set_learning_rate(0.2).set_weight_col("w")

    return {
        "LogisticRegression": (lin(jl_lr, "LogisticRegression"), lin(pl_lr, "LogisticRegression")),
        "LinearSVC": (lin(jl_svc, "LinearSVC"), lin(pl_svc, "LinearSVC")),
        "LinearRegression": (lin(jl_linr, "LinearRegression"), lin(pl_linr, "LinearRegression")),
        "KMeans": tuple(m.KMeans().set_k(4).set_seed(11).set_distance_measure("cosine")
                        for m in (jl_km, pl_km)),
        "OnlineLogisticRegression": tuple(
            m.OnlineLogisticRegression().set_alpha(0.2).set_beta(0.3).set_reg(0.01)
            .set_global_batch_size(100) for m in (jl_olr, pl_olr)),
        "OnlineKMeans": tuple(m.OnlineKMeans().set_k(3).set_decay_factor(0.5).set_seed(7)
                              for m in (jl_okm, pl_okm)),
    }


@pytest.mark.parametrize("name", ["LogisticRegression", "LinearSVC", "LinearRegression", "KMeans",
                                  "OnlineLogisticRegression", "OnlineKMeans"])
@pytest.mark.parametrize("params", ["default", "set"])
def test_checkpoint_job_key_equals_the_jax_packages(name, params):
    if params == "set":
        jax_est, port_est = _estimator_pairs()[name]
    else:
        jax_est, port_est = (type(e)() for e in _estimator_pairs()[name])
    key = port_iteration.checkpoint_job_key(port_est)
    assert key == jax_iteration.checkpoint_job_key(jax_est)
    assert key.startswith(name + "-")


def test_checkpoint_job_key_stability():
    from flink_ml_tpu_torch.models.clustering.onlinekmeans import OnlineKMeans

    a = OnlineKMeans().set_k(3).set_decay_factor(0.5)
    b = OnlineKMeans().set_k(3).set_decay_factor(0.5)
    c = OnlineKMeans().set_k(3).set_decay_factor(0.9)
    key = port_iteration.checkpoint_job_key
    assert key(a) == key(b) and key(a) != key(c)
    # termination params do not change the job: resuming with a larger maxIter
    from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression

    assert key(LogisticRegression().set_max_iter(5)) == key(LogisticRegression().set_max_iter(50))
    assert key(LogisticRegression().set_tol(0.1)) == key(LogisticRegression())


def test_job_key_namespacing_prevents_cross_restore(tmp_path):
    X, y = _sgd_problem(8)
    ckpt = str(tmp_path)
    _port_fit(X, y, ckpt, "job-one", max_iter=6)
    fresh, _, _ = _port_fit(X, 1.0 - y, str(tmp_path / "fresh"), "job-two", max_iter=6)
    other, _, epochs = _port_fit(X, 1.0 - y, ckpt, "job-two", max_iter=6)
    assert epochs == 6
    np.testing.assert_array_equal(other, fresh)
    assert sorted(os.listdir(ckpt)) == ["fresh", "snap-job-one.npz", "snap-job-two.npz"]


@pytest.mark.parametrize("interval", [1, 3, 5, 12])
def test_checkpoint_interval(tmp_path, interval):
    X, y = _sgd_problem(1)
    ref, _, _ = _port_fit(X, y, None, None)
    from flink_ml_tpu_torch.ops import losses
    from flink_ml_tpu_torch.ops.optimizer import SGD

    saves = metrics.get_counter("checkpoint.count")
    got, _, epochs = SGD(max_iter=12, global_batch_size=100, tol=0.0, checkpoint_dir=str(tmp_path),
                         checkpoint_interval=interval, checkpoint_key="iv").optimize(
        np.zeros(6), X, y, None, losses.BINARY_LOGISTIC_LOSS)
    assert epochs == 12 and metrics.get_counter("checkpoint.count") - saves == 12 // interval
    np.testing.assert_array_equal(got, ref)
    snap = port_snapshot.load_job_snapshot(
        str(tmp_path), "iv",
        templates={"model": (np.zeros(6, np.float32),) * 2 + (np.float32(0), np.int32(0))})
    assert snap.epoch == 12 // interval * interval


def test_corrupt_checkpoint_is_refused_loudly(tmp_path):
    """A snapshot file that is not an npz raises (an operator error, not a
    fresh start), as the JAX package's loader does."""
    os.makedirs(tmp_path, exist_ok=True)
    with open(port_snapshot.snapshot_file(str(tmp_path), "bad"), "wb") as f:
        f.write(b"not an npz")
    with pytest.raises(Exception):
        port_snapshot.load_job_snapshot(str(tmp_path), "bad",
                                        templates={"model": np.zeros(2, np.float32)})


# ---------------------------------------------------------------------------
# the checkpoint contract (test_checkpoint_coverage.py)
# ---------------------------------------------------------------------------

def _estimator_classes(pkgname):
    pkg = importlib.import_module(pkgname)
    api = importlib.import_module(pkgname + ".api")
    out = {}
    for info in pkgutil.walk_packages(pkg.__path__, pkgname + "."):
        if any(part in info.name for part in ("benchmark", "analysis", "__main__", "exporters")):
            continue
        try:
            module = importlib.import_module(info.name)
        except Exception:  # noqa: BLE001 — modules that need a missing extra
            continue
        for name, cls in inspect.getmembers(module, inspect.isclass):
            if (issubclass(cls, api.Estimator) and cls.__module__ == module.__name__
                    and not inspect.isabstract(cls)):
                out[(info.name.split(".", 1)[1], name)] = cls
    return out


def test_every_port_estimator_declares_the_jax_packages_contract():
    jax_classes = _estimator_classes("flink_ml_tpu")
    port_classes = _estimator_classes("flink_ml_tpu_torch")
    assert sorted(port_classes) == sorted(jax_classes)
    for key, cls in port_classes.items():
        want = jax_classes[key]
        assert "checkpointable" in cls.__dict__, key
        assert cls.checkpointable is want.checkpointable, key
        if not cls.checkpointable:
            assert cls.checkpoint_reason.strip(), key


def test_known_contracts_hold():
    from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression
    from flink_ml_tpu_torch.models.classification.onlinelogisticregression import (
        OnlineLogisticRegression,
    )
    from flink_ml_tpu_torch.models.clustering.kmeans import KMeans
    from flink_ml_tpu_torch.models.clustering.onlinekmeans import OnlineKMeans
    from flink_ml_tpu_torch.models.feature.standardscaler import StandardScaler

    for cls in (LogisticRegression, KMeans, OnlineKMeans, OnlineLogisticRegression):
        assert cls.checkpointable is True
    assert StandardScaler.checkpointable is False and StandardScaler.checkpoint_reason.strip()
