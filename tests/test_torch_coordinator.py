"""flink_ml_tpu_torch/ckpt/coordinator.py (sharded snapshot cuts) against
the JAX package's, on the CPU.

Case for case the JAX package's tests/test_multihost_snapshot.py, each run
on both packages (`pkg`): the shard layout and manifest, the torn-commit
battery (kills mid-shard-write and mid-manifest-commit, missing shards,
stale digests, bit rot), straggler aborts, sweeps, retention and GC,
retried reads and never-retried refusals, the single file's per-leaf
digests, N-host to M-host rewrites and the online loop's sharded resume.
On one card the hosts are simulated: the elastic cases re-stage onto the
one device. Across packages: a cut written by either restores in the
other, and the two write the same manifest.
"""

import json
import os
import threading
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flink_ml_tpu.ckpt as jax_ckpt
from flink_ml_tpu import config as jax_config
from flink_ml_tpu.ckpt import coordinator as jax_coordinator
from flink_ml_tpu.ckpt import faults as jax_faults
from flink_ml_tpu.parallel import iteration as jax_iteration
from flink_ml_tpu.utils import metrics as jax_metrics
import flink_ml_tpu_torch.ckpt as port_ckpt
from flink_ml_tpu_torch import config as port_config
from flink_ml_tpu_torch.ckpt import coordinator as port_coordinator
from flink_ml_tpu_torch.ckpt import faults as port_faults
from flink_ml_tpu_torch.parallel import iteration as port_iteration
from flink_ml_tpu_torch.utils import metrics as port_metrics

PKGS = ("jax", "port")


class Pkg:
    """One package's checkpoint surface, with its device arrays."""

    def __init__(self, name):
        self.name = name
        jax_side = name == "jax"
        self.ckpt = jax_ckpt if jax_side else port_ckpt
        self.coordinator = jax_coordinator if jax_side else port_coordinator
        self.faults = jax_faults if jax_side else port_faults
        self.config = jax_config if jax_side else port_config
        self.metrics = jax_metrics if jax_side else port_metrics
        self.iteration = jax_iteration if jax_side else port_iteration
        self.arr = (lambda a: jnp.asarray(np.asarray(a))) if jax_side else \
            (lambda a: torch.as_tensor(np.asarray(a)))

    def save(self, path, key="j", epoch=1, scale=1.0, hosts=4, meta=None):
        f32 = np.float32
        return self.ckpt.save_job_snapshot(
            str(path), key,
            {"model": (self.arr(np.arange(8.0, dtype=f32) * f32(scale)),
                       self.arr(np.arange(32.0, dtype=f32).reshape(8, 4) * f32(scale)),
                       np.float64(scale))},
            epoch=epoch, criteria=0.5, specs={"model": ("replicated", "data", "host")},
            meta=meta or {"numBatches": 4}, hosts=hosts)

    def template(self):
        return {"model": (self.arr(np.zeros(8, np.float32)),
                          self.arr(np.zeros((8, 4), np.float32)), np.float64(0))}

    def load(self, path, key="j", **kw):
        return self.ckpt.load_job_snapshot(str(path), key, templates=self.template(), **kw)


@pytest.fixture(params=PKGS)
def pkg(request):
    with port_config.use_device("cpu"):
        yield Pkg(request.param)


def _corrupt(file, offset=60):
    with open(file, "r+b") as f:
        f.seek(offset)
        f.write(b"\xde\xad\xbe\xef")


def _cut_files(p, path, cut, base="snap-j"):
    return [n for n in os.listdir(path) if p.coordinator._cut_of(n, base) == cut]


# ---------------------------------------------------------------------------
# format: shard layout, digests, manifest contents
# ---------------------------------------------------------------------------

def test_sharded_roundtrip_and_manifest_inventory(tmp_path, pkg):
    target = pkg.save(tmp_path, epoch=3, scale=2.0)
    assert os.path.basename(target) == "snap-j.c000001.manifest.json"
    with open(target) as f:
        manifest = json.load(f)
    assert manifest["formatVersion"] == pkg.coordinator.SHARDED_FORMAT_VERSION
    assert manifest["hosts"] == 4
    assert set(manifest["shards"]) == {f"snap-j.c000001.host{h}.npz" for h in range(4)}
    for info in manifest["shards"].values():
        assert {"crc32", "sha256", "bytes", "host"} <= set(info)
    parts = manifest["layout"]["s_model_1"]
    assert [(p["start"], p["stop"]) for p in parts] == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert all(p["axis"] == 0 for p in parts)
    assert manifest["layout"]["s_model_0"][0]["axis"] is None
    assert manifest["layout"]["s_model_0"][0]["shard"].endswith("host0.npz")
    snap = pkg.load(tmp_path)
    assert (snap.epoch, snap.criteria) == (3, 0.5)
    c, r, host_leaf = snap.sections["model"]
    np.testing.assert_array_equal(c, 2.0 * np.arange(8, dtype=np.float32))
    np.testing.assert_array_equal(r, 2.0 * np.arange(32, dtype=np.float32).reshape(8, 4))
    assert float(host_leaf) == 2.0 and host_leaf.dtype == np.float64
    assert tuple(snap.specs["model"]) == ("replicated", "data", "host")


def test_the_two_packages_write_the_same_cut(tmp_path):
    out = {}
    for name in PKGS:
        p = Pkg(name)
        with open(p.save(tmp_path / name, epoch=3, scale=2.0)) as f:
            manifest = json.load(f)
        shards = {}
        for h in range(4):
            with np.load(p.coordinator.shard_file(str(tmp_path / name), "j", 1, h)) as f:
                shards[h] = {k: f[k].tobytes() for k in f.files}
        out[name] = (manifest, shards)
    assert out["port"][0] == out["jax"][0]  # the digests too: the same bytes
    assert out["port"][1] == out["jax"][1]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_a_cut_written_by_one_package_restores_in_the_other(tmp_path, writer, reader):
    with port_config.use_device("cpu"):
        Pkg(writer).save(tmp_path, epoch=1, scale=1.0)
        Pkg(writer).save(tmp_path, epoch=2, scale=3.0, hosts=3)
        snap = Pkg(reader).load(tmp_path)
    assert snap.epoch == 2
    c, r, host_leaf = snap.sections["model"]
    np.testing.assert_array_equal(r, 3.0 * np.arange(32, dtype=np.float32).reshape(8, 4))
    np.testing.assert_array_equal(c, 3.0 * np.arange(8, dtype=np.float32))
    assert float(host_leaf) == 3.0


def test_each_host_shard_holds_only_its_slice(tmp_path, pkg):
    pkg.save(tmp_path, scale=3.0)
    for h in range(4):
        with np.load(pkg.coordinator.shard_file(str(tmp_path), "j", 1, h)) as f:
            if h == 0:
                np.testing.assert_array_equal(f["s_model_0"], 3.0 * np.arange(8, dtype=np.float32))
            else:
                assert "s_model_0" not in f.files
            np.testing.assert_array_equal(
                f["s_model_1"],
                3.0 * np.arange(32, dtype=np.float32).reshape(8, 4)[2 * h : 2 * h + 2])


def test_uneven_rows_and_surplus_hosts(tmp_path, pkg):
    pkg.ckpt.save_job_snapshot(
        str(tmp_path), "u",
        {"model": (pkg.arr(np.arange(10.0, dtype=np.float32).reshape(5, 2)),
                   pkg.arr(np.arange(2.0, dtype=np.float32)))},
        epoch=1, specs={"model": ("data", "data")}, hosts=3)
    snap = pkg.ckpt.load_job_snapshot(
        str(tmp_path), "u", templates={"model": (pkg.arr(np.zeros((5, 2), np.float32)),
                                                 pkg.arr(np.zeros(2, np.float32)))})
    np.testing.assert_array_equal(snap.sections["model"][0],
                                  np.arange(10, dtype=np.float32).reshape(5, 2))
    np.testing.assert_array_equal(snap.sections["model"][1], np.arange(2, dtype=np.float32))


def test_host_slice_bounds_and_tag_axes_match_the_mesh_rules():
    from flink_ml_tpu.parallel import mesh as mesh_lib

    for length, hosts in [(8, 4), (5, 3), (2, 4), (0, 2), (7, 1)]:
        assert port_coordinator.host_slice_bounds(length, hosts) == \
            mesh_lib.host_slice_bounds(length, hosts)
    for tag in ("data", "model", "replicated", "host"):
        for ndim in (0, 1, 2, 3):
            assert port_coordinator.shard_axis_for_tag(tag, ndim) == \
                mesh_lib.shard_axis_for_tag(tag, ndim)
    with pytest.raises(ValueError):
        port_coordinator.host_slice_bounds(8, 0)


def test_model_tag_shards_trailing_axis(tmp_path, pkg):
    pkg.ckpt.save_job_snapshot(str(tmp_path), "m",
                               {"model": pkg.arr(np.arange(24.0, dtype=np.float32).reshape(2, 12))},
                               epoch=1, specs={"model": "model"}, hosts=4)
    with np.load(pkg.coordinator.shard_file(str(tmp_path), "m", 1, 2)) as f:
        np.testing.assert_array_equal(
            f["s_model_0"], np.arange(24, dtype=np.float32).reshape(2, 12)[:, 6:9])
    snap = pkg.ckpt.load_job_snapshot(str(tmp_path), "m",
                                      templates={"model": pkg.arr(np.zeros((2, 12), np.float32))})
    np.testing.assert_array_equal(snap.sections["model"],
                                  np.arange(24, dtype=np.float32).reshape(2, 12))


# ---------------------------------------------------------------------------
# the torn-manifest battery
# ---------------------------------------------------------------------------

def test_kill_mid_shard_write_leaves_previous_cut_restorable(tmp_path, pkg):
    pkg.save(tmp_path, epoch=1, scale=1.0)
    with pkg.faults.inject("snapshot.shard.write", after=3) as plan:
        with pytest.raises(pkg.faults.InjectedFault):
            pkg.save(tmp_path, epoch=2, scale=9.0)
    assert plan.fired
    snap = pkg.load(tmp_path)
    assert snap.epoch == 1
    np.testing.assert_array_equal(snap.sections["model"][0], np.arange(8, dtype=np.float32))
    assert _cut_files(pkg, tmp_path, 2) == []
    pkg.save(tmp_path, epoch=2, scale=2.0)
    assert pkg.load(tmp_path).epoch == 2


def test_kill_mid_manifest_commit_leaves_previous_cut_restorable(tmp_path, pkg):
    pkg.save(tmp_path, epoch=1)
    with pkg.faults.inject("snapshot.commit") as plan:
        with pytest.raises(pkg.faults.InjectedFault):
            pkg.save(tmp_path, epoch=2, scale=9.0)
    assert plan.fired
    assert os.path.exists(pkg.coordinator.shard_file(str(tmp_path), "j", 2, 3))
    assert not os.path.exists(pkg.coordinator.manifest_file(str(tmp_path), "j", 2))
    assert pkg.load(tmp_path).epoch == 1


def test_torn_first_commit_is_a_fresh_start(tmp_path, pkg):
    with pkg.faults.inject("snapshot.commit"):
        with pytest.raises(pkg.faults.InjectedFault):
            pkg.save(tmp_path, epoch=1)
    assert pkg.load(tmp_path) is None


def test_manifest_present_but_shard_missing_falls_back(tmp_path, pkg):
    pkg.save(tmp_path, epoch=1)
    pkg.save(tmp_path, epoch=2, scale=2.0)
    os.remove(pkg.coordinator.shard_file(str(tmp_path), "j", 2, 1))
    before = pkg.metrics.get_counter("checkpoint.restore.fallback", 0)
    with pytest.warns(UserWarning, match="missing"):
        snap = pkg.load(tmp_path)
    assert snap.epoch == 1
    assert pkg.metrics.get_counter("checkpoint.restore.fallback", 0) == before + 1


def test_stale_digest_shard_falls_back_and_counts(tmp_path, pkg):
    pkg.save(tmp_path, epoch=1)
    pkg.save(tmp_path, epoch=2, scale=2.0)
    np.savez(pkg.coordinator.shard_file(str(tmp_path), "j", 2, 1),
             s_model_1=np.zeros((2, 4), np.float32))
    before = pkg.metrics.get_counter("checkpoint.digest.mismatch", 0)
    with pytest.warns(UserWarning, match="mismatch"):
        snap = pkg.load(tmp_path)
    assert snap.epoch == 1
    assert pkg.metrics.get_counter("checkpoint.digest.mismatch", 0) == before + 1


def test_all_cuts_corrupt_raises_loudly(tmp_path, pkg):
    with pkg.config.snapshot_retention_mode(2):
        pkg.save(tmp_path, epoch=1)
        pkg.save(tmp_path, epoch=2)
    for cut in (1, 2):
        _corrupt(pkg.coordinator.shard_file(str(tmp_path), "j", cut, 0))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(pkg.ckpt.SnapshotIntegrityError, match="cannot produce"):
            pkg.load(tmp_path)


def test_bit_rot_injection_mid_file(tmp_path, pkg):
    pkg.save(tmp_path, epoch=1)
    pkg.save(tmp_path, epoch=2, scale=5.0)
    _corrupt(pkg.coordinator.shard_file(str(tmp_path), "j", 2, 2))
    with pytest.warns(UserWarning, match="crc32 mismatch"):
        snap = pkg.load(tmp_path)
    assert snap.epoch == 1


def test_future_manifest_format_version_falls_back(tmp_path, pkg):
    pkg.save(tmp_path, epoch=1)
    pkg.save(tmp_path, epoch=2)
    mfile = pkg.coordinator.manifest_file(str(tmp_path), "j", 2)
    with open(mfile) as f:
        manifest = json.load(f)
    manifest["formatVersion"] = 99
    with open(mfile, "w") as f:
        json.dump(manifest, f)
    with pytest.warns(UserWarning, match="format version 99"):
        snap = pkg.load(tmp_path)
    assert snap.epoch == 1


def test_meta_cursor_mismatch_refused_not_fallen_back(tmp_path, pkg):
    pkg.save(tmp_path, epoch=1, meta={"numBatches": 4})
    pkg.save(tmp_path, epoch=2, meta={"numBatches": 4})
    with pytest.warns(UserWarning, match="numBatches"):
        assert pkg.load(tmp_path, expect_meta={"numBatches": 7}) is None
    assert pkg.load(tmp_path, expect_meta={"numBatches": 4}).epoch == 2


def test_sharded_state_is_authoritative_over_stale_single_file(tmp_path, pkg):
    pkg.ckpt.save_job_snapshot(
        str(tmp_path), "j", {"model": (pkg.arr(np.zeros(8, np.float32)),
                                       pkg.arr(np.zeros((8, 4), np.float32)), np.float64(0))},
        epoch=7, meta={"numBatches": 4})
    assert os.path.exists(pkg.ckpt.snapshot_file(str(tmp_path), "j"))
    pkg.save(tmp_path, epoch=9)
    with pytest.warns(UserWarning, match="numBatches"):
        assert pkg.load(tmp_path, expect_meta={"numBatches": 7}) is None


# ---------------------------------------------------------------------------
# straggler abort-this-cut, sweeps
# ---------------------------------------------------------------------------

def test_straggler_host_aborts_cut_previous_restorable(tmp_path, pkg):
    pkg.save(tmp_path, epoch=1)
    before = pkg.metrics.get_counter("checkpoint.abort", 0)
    with pkg.config.transient_retry_mode(1):
        with pkg.faults.flaky("snapshot.shard.write", times=99):
            with pytest.warns(UserWarning, match="aborted"):
                assert pkg.save(tmp_path, epoch=2, scale=9.0) is None
    assert pkg.metrics.get_counter("checkpoint.abort", 0) == before + 1
    assert _cut_files(pkg, tmp_path, 2) == []
    assert pkg.load(tmp_path).epoch == 1
    assert pkg.save(tmp_path, epoch=3, scale=3.0) is not None
    assert pkg.load(tmp_path).epoch == 3


def test_straggler_deadline_bounds_the_wait(tmp_path, pkg):
    pkg.save(tmp_path, epoch=1)
    prev = pkg.config.snapshot_host_deadline_s
    pkg.config.snapshot_host_deadline_s = 0.0
    try:
        with pkg.config.transient_retry_mode(50):
            with pkg.faults.flaky("snapshot.shard.write", times=1) as plan:
                with pytest.warns(UserWarning, match="aborted"):
                    assert pkg.save(tmp_path, epoch=2) is None
    finally:
        pkg.config.snapshot_host_deadline_s = prev
    assert plan.failures == 1
    assert pkg.load(tmp_path).epoch == 1


def test_unexpected_exception_mid_cut_sweeps_partials(tmp_path, pkg):
    pkg.save(tmp_path, epoch=1)
    before = pkg.metrics.get_counter("checkpoint.sweep", 0)
    with pkg.faults.inject("snapshot.shard.write", after=3):
        with pytest.raises(pkg.faults.InjectedFault):
            pkg.save(tmp_path, epoch=2, scale=9.0)
    assert _cut_files(pkg, tmp_path, 2) == []
    assert pkg.metrics.get_counter("checkpoint.sweep", 0) == before + 1
    assert pkg.load(tmp_path).epoch == 1


def test_mid_commit_kill_keeps_torn_2pc_shape_and_sweep_cancels_it(tmp_path, pkg):
    pkg.save(tmp_path, epoch=1)
    with pkg.faults.inject("snapshot.commit"):
        with pytest.raises(pkg.faults.InjectedFault):
            pkg.save(tmp_path, epoch=2, scale=9.0)
    assert os.path.exists(pkg.coordinator.shard_file(str(tmp_path), "j", 2, 0))
    assert pkg.coordinator.sweep_uncommitted(str(tmp_path), "j") >= 4
    assert _cut_files(pkg, tmp_path, 2) == []
    assert pkg.load(tmp_path).epoch == 1
    assert pkg.coordinator.sweep_uncommitted(str(tmp_path), "j") == 0


def test_sweep_uncommitted_spares_reused_stable_shards(tmp_path, pkg):
    arrays = {"model": (pkg.arr(np.arange(8.0, dtype=np.float32)),)}

    def save(epoch):
        return pkg.ckpt.save_job_snapshot(
            str(tmp_path), "j", arrays, epoch=epoch,
            specs={"model": ("data",), "cache": "data"}, meta={"numBatches": 2}, hosts=2,
            stable_sections={"cache": lambda: (np.arange(16.0),)})

    save(1)
    stable = pkg.coordinator.stable_shard_file(str(tmp_path), "j", "cache", 0)
    assert os.path.exists(stable)
    with pkg.faults.inject("snapshot.commit"):
        with pytest.raises(pkg.faults.InjectedFault):
            save(2)
    pkg.coordinator.sweep_uncommitted(str(tmp_path), "j")
    assert os.path.exists(stable)
    snap = pkg.ckpt.load_job_snapshot(str(tmp_path), "j",
                                      templates={"model": (pkg.arr(np.zeros(8, np.float32)),)})
    assert snap.epoch == 1
    np.testing.assert_array_equal(np.asarray(snap.sections["cache"][0]), np.arange(16.0))


def test_stable_section_is_written_once_and_reused(tmp_path, pkg):
    calls = []

    def contents():
        calls.append(1)
        return (np.arange(12.0).reshape(6, 2),)

    for epoch in (1, 2, 3):
        pkg.ckpt.save_job_snapshot(
            str(tmp_path), "st", {"model": (pkg.arr(np.arange(4.0, dtype=np.float32)),)},
            epoch=epoch, specs={"cache": "data"}, meta={"numSegments": 6}, hosts=3,
            stable_sections={"cache": contents})
    assert len(calls) == 1  # rewritten by no later cut
    snap = pkg.ckpt.load_job_snapshot(str(tmp_path), "st")
    assert snap.epoch == 3
    np.testing.assert_array_equal(snap.sections["cache"][0], np.arange(12.0).reshape(6, 2))


def test_concurrent_straggler_abort_racing_retention_gc(tmp_path, pkg):
    pkg.save(tmp_path, epoch=1)
    pkg.save(tmp_path, epoch=2, scale=2.0)
    stop = threading.Event()
    errors = []

    def gc_loop():
        try:
            while not stop.is_set():
                pkg.coordinator.gc_snapshots(str(tmp_path), "j")
        except BaseException as e:  # noqa: BLE001 — surfaced by the assert below
            errors.append(e)

    worker = threading.Thread(target=gc_loop, daemon=True)
    worker.start()
    try:
        for k in range(4):
            with pkg.config.transient_retry_mode(0):
                with pkg.faults.flaky("snapshot.shard.write", times=99):
                    with pytest.warns(UserWarning, match="aborted"):
                        assert pkg.save(tmp_path, epoch=3 + k, scale=9.0) is None
    finally:
        stop.set()
        worker.join(timeout=10.0)
    assert not worker.is_alive() and errors == []
    snap = pkg.load(tmp_path)
    assert snap.epoch == 2
    np.testing.assert_array_equal(snap.sections["model"][0], np.arange(8, dtype=np.float32) * 2.0)
    cuts = pkg.coordinator.committed_cuts(str(tmp_path), "j")
    stray = [n for n in os.listdir(tmp_path)
             if pkg.coordinator._cut_of(n, "snap-j") is not None
             and pkg.coordinator._cut_of(n, "snap-j") not in cuts]
    assert stray == []


def test_transient_shard_write_retried_within_budget(tmp_path, pkg):
    with pkg.config.transient_retry_mode(3):
        with pkg.faults.flaky("snapshot.shard.write", times=2) as plan:
            assert pkg.save(tmp_path, epoch=4, scale=4.0) is not None
    assert plan.failures == 2
    assert pkg.load(tmp_path).epoch == 4


# ---------------------------------------------------------------------------
# retention + GC
# ---------------------------------------------------------------------------

def test_retention_keeps_last_n_cuts(tmp_path, pkg):
    with pkg.config.snapshot_retention_mode(3):
        for e in range(1, 6):
            pkg.save(tmp_path, epoch=e, scale=float(e))
    assert pkg.coordinator.committed_cuts(str(tmp_path), "j") == [3, 4, 5]
    assert not any(pkg.coordinator._cut_of(n, "snap-j") in (1, 2) for n in os.listdir(tmp_path))
    _corrupt(pkg.coordinator.shard_file(str(tmp_path), "j", 5, 0))
    with pytest.warns(UserWarning):
        assert pkg.load(tmp_path).epoch == 4


def test_gc_removes_stale_temps_and_unreferenced_stable_shards(tmp_path, pkg):
    pkg.save(tmp_path, epoch=1)
    stray_tmp = os.path.join(str(tmp_path), "snap-j.c000001.host9.tmp.npz")
    stray_stable = os.path.join(str(tmp_path), "snap-j.stable-cache.host0.npz")
    np.savez(stray_tmp, x=np.zeros(1))
    np.savez(stray_stable, x=np.zeros(1))
    pkg.save(tmp_path, epoch=2)
    assert not os.path.exists(stray_tmp) and not os.path.exists(stray_stable)
    assert pkg.load(tmp_path).epoch == 2


def test_purge_removes_every_file_of_the_job(tmp_path, pkg):
    pkg.save(tmp_path, epoch=1)
    pkg.save(tmp_path, key="other", epoch=1)
    assert pkg.coordinator.purge(str(tmp_path), "j") == 5
    assert sorted(os.listdir(tmp_path)) == sorted(
        os.path.basename(pkg.coordinator.shard_file(str(tmp_path), "other", 1, h))
        for h in range(4)) + ["snap-other.c000001.manifest.json"]


# ---------------------------------------------------------------------------
# retries: flaky reads retried, refusals never
# ---------------------------------------------------------------------------

def test_flaky_manifest_and_shard_reads_retried_to_success(tmp_path, pkg):
    pkg.save(tmp_path, epoch=6, scale=6.0)
    with pkg.config.transient_retry_mode(3):
        with pkg.faults.flaky("snapshot.manifest.read", times=2) as mplan:
            assert pkg.load(tmp_path).epoch == 6
        with pkg.faults.flaky("snapshot.shard.read", times=2) as splan:
            snap = pkg.load(tmp_path)
    assert mplan.failures == 2 and splan.failures == 2
    np.testing.assert_array_equal(snap.sections["model"][0], 6.0 * np.arange(8, dtype=np.float32))


def test_flaky_read_budget_exhausted_reraises_original(tmp_path, pkg):
    pkg.save(tmp_path, epoch=1)
    with pkg.config.transient_retry_mode(1):
        with pkg.faults.flaky("snapshot.shard.read", times=10):
            with pytest.raises(pkg.faults.TransientFault) as ei:
                pkg.load(tmp_path)
    assert ei.value.retry_attempts == 2


def test_refusals_are_never_retried(tmp_path, pkg):
    pkg.save(tmp_path, epoch=1)
    pkg.save(tmp_path, epoch=2)
    _corrupt(pkg.coordinator.shard_file(str(tmp_path), "j", 2, 0))
    before = pkg.metrics.get_counter("flow.retry", 0)
    with pkg.config.transient_retry_mode(5):
        with pytest.warns(UserWarning, match="mismatch"):
            assert pkg.load(tmp_path).epoch == 1
    assert pkg.metrics.get_counter("flow.retry", 0) == before


# ---------------------------------------------------------------------------
# the single file's per-leaf digests
# ---------------------------------------------------------------------------

def _rewrite_single_file_leaf(file, leaf_key, new_array):
    with np.load(file) as f:
        arrays = {k: f[k] for k in f.files}
    arrays[leaf_key] = new_array
    manifest = arrays.pop("manifest")
    np.savez(file, manifest=manifest, **arrays)


def test_single_file_corrupt_leaf_fails_loudly_naming_leaf(tmp_path, pkg):
    file = pkg.ckpt.save_job_snapshot(
        str(tmp_path), "sf", {"model": (pkg.arr(np.arange(4.0, dtype=np.float32)),
                                        pkg.arr(np.ones(3, np.float32)))}, epoch=2)
    _rewrite_single_file_leaf(file, "s_model_1", np.full(3, 7.0, np.float32))
    with pytest.raises(pkg.ckpt.SnapshotIntegrityError, match="s_model_1"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            pkg.ckpt.load_job_snapshot(
                str(tmp_path), "sf", templates={"model": (pkg.arr(np.zeros(4, np.float32)),
                                                          pkg.arr(np.zeros(3, np.float32)))})


def test_single_file_digest_failure_not_retried(tmp_path, pkg):
    file = pkg.ckpt.save_job_snapshot(str(tmp_path), "sf",
                                      {"model": pkg.arr(np.arange(4.0, dtype=np.float32))}, epoch=1)
    _rewrite_single_file_leaf(file, "s_model_0", np.zeros(4, np.float32))
    before = pkg.metrics.get_counter("flow.retry.snapshot.read", 0)
    with pkg.config.transient_retry_mode(5):
        with pytest.raises(pkg.ckpt.SnapshotIntegrityError):
            pkg.ckpt.load_job_snapshot(str(tmp_path), "sf",
                                       templates={"model": pkg.arr(np.zeros(4, np.float32))})
    assert pkg.metrics.get_counter("flow.retry.snapshot.read", 0) == before


def test_single_file_pre_digest_snapshot_still_loads(tmp_path, pkg):
    file = pkg.ckpt.save_job_snapshot(str(tmp_path), "old",
                                      {"model": pkg.arr(np.arange(4.0, dtype=np.float32))}, epoch=3)
    with np.load(file) as f:
        arrays = {k: f[k] for k in f.files}
    manifest = json.loads(str(arrays.pop("manifest")))
    for section in manifest["sections"].values():
        for entry in section["leaves"]:
            entry.pop("crc32", None)
    np.savez(file, manifest=np.asarray(json.dumps(manifest)), **arrays)
    snap = pkg.ckpt.load_job_snapshot(str(tmp_path), "old",
                                      templates={"model": pkg.arr(np.zeros(4, np.float32))})
    assert snap is not None and snap.epoch == 3


def test_legacy_reader_warns_it_cannot_verify(tmp_path, pkg):
    carry = (pkg.arr(np.asarray([1.0, 2.0], np.float32)),)
    pkg.iteration.save_iteration_checkpoint(str(tmp_path), carry, epoch=3, criteria=0.5,
                                            job_key="lg")
    with pytest.warns(UserWarning, match="CANNOT be verified"):
        snap = pkg.ckpt.load_job_snapshot(str(tmp_path), "lg", templates={"model": carry})
    assert snap is not None and snap.epoch == 3


# ---------------------------------------------------------------------------
# N hosts to M hosts
# ---------------------------------------------------------------------------

def test_stage_section_restages_a_sharded_snapshot_on_the_device(tmp_path):
    p = Pkg("port")
    with port_config.use_device("cpu"):
        p.save(tmp_path, epoch=1, scale=4.0, hosts=8)
        c, r, host_leaf = port_ckpt.stage_section(p.load(tmp_path), "model")
    assert isinstance(c, torch.Tensor) and isinstance(r, torch.Tensor)
    np.testing.assert_array_equal(r.numpy(), 4.0 * np.arange(32, dtype=np.float32).reshape(8, 4))
    assert isinstance(host_leaf, np.ndarray)


@pytest.mark.parametrize("from_hosts,to_hosts", [(1, 8), (8, 2)])
def test_sharded_snapshot_rewrites_across_host_counts(tmp_path, pkg, from_hosts, to_hosts):
    pkg.save(tmp_path / "a", epoch=1, scale=7.0, hosts=from_hosts)
    snap = pkg.load(tmp_path / "a")
    pkg.ckpt.save_job_snapshot(
        str(tmp_path / "b"), "j",
        {"model": tuple(pkg.arr(leaf) if i < 2 else leaf
                        for i, leaf in enumerate(snap.sections["model"]))},
        epoch=1, specs={"model": ("replicated", "data", "host")}, hosts=to_hosts)
    again = pkg.load(tmp_path / "b")
    for a, b in zip(snap.sections["model"], again.sections["model"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("from_hosts,to_hosts", [(1, 4), (4, 2)])
def test_sharded_resume_parity_with_single_file(tmp_path, from_hosts, to_hosts):
    """A dense SGD fit killed with N-host sharded snapshots and resumed
    with M hosts lands on the coefficients of the same kill and resume
    through the single file, bit for bit: the transport is lossless."""
    from flink_ml_tpu_torch.ops import losses
    from flink_ml_tpu_torch.ops.optimizer import SGD

    rng = np.random.RandomState(4)
    X = rng.randn(384, 8).astype(np.float32)
    y = (X @ np.linspace(1, -1, 8) > 0).astype(np.float32)

    def fit(ckpt):
        return SGD(max_iter=12, global_batch_size=96, tol=0.0, checkpoint_dir=ckpt,
                   checkpoint_key="el").optimize(np.zeros(8), X, y, None,
                                                 losses.BINARY_LOGISTIC_LOSS)

    with port_config.use_device("cpu"):
        single = str(tmp_path / "single")
        with port_faults.inject("chunk", after=6):
            with pytest.raises(port_faults.InjectedFault):
                fit(single)
        single_coeff, _, single_epochs = fit(single)
        sharded = str(tmp_path / "sharded")
        with port_config.snapshot_hosts_mode(from_hosts):
            with port_faults.inject("chunk", after=6):
                with pytest.raises(port_faults.InjectedFault):
                    fit(sharded)
        assert port_coordinator.has_sharded(sharded, "el")
        with port_config.snapshot_hosts_mode(to_hosts):
            sharded_coeff, _, sharded_epochs = fit(sharded)
    assert single_epochs == sharded_epochs == 12
    np.testing.assert_array_equal(sharded_coeff, single_coeff)


# ---------------------------------------------------------------------------
# observability, the online loop
# ---------------------------------------------------------------------------

def test_sharded_counters(tmp_path, pkg):
    before_shards = pkg.metrics.get_counter("checkpoint.shard.count", 0)
    before_manifests = pkg.metrics.get_counter("checkpoint.manifest.count", 0)
    before_count = pkg.metrics.get_counter("checkpoint.count", 0)
    pkg.save(tmp_path, epoch=1)
    assert pkg.metrics.get_counter("checkpoint.shard.count", 0) == before_shards + 4
    assert pkg.metrics.get_counter("checkpoint.manifest.count", 0) == before_manifests + 1
    assert pkg.metrics.get_counter("checkpoint.count", 0) == before_count + 1
    assert pkg.metrics.get_counter("checkpoint.shard.bytes", 0) > 0


def test_online_unbounded_sharded_resume_and_completion_purge(tmp_path, pkg):
    d = str(tmp_path / "online")
    batches = [np.full(3, float(i), np.float32) for i in range(1, 6)]

    def run():
        return list(pkg.iteration.iterate_unbounded(
            iter(batches), lambda s, b: s + pkg.arr(b), pkg.arr(np.zeros(3, np.float32)),
            checkpoint_dir=d, job_key="ol"))

    expected = [np.asarray(s) for _, s in run()]
    assert pkg.coordinator.committed_cuts(d, "ol") == []
    with pkg.config.snapshot_hosts_mode(2):
        with pkg.faults.inject("batch", after=3):
            with pytest.raises(pkg.faults.InjectedFault):
                run()
        assert pkg.coordinator.committed_cuts(d, "ol") != []
        versions_states = run()
    assert versions_states[0][0] == 3
    np.testing.assert_array_equal(np.asarray(versions_states[-1][1]), expected[-1])
    assert versions_states[-1][0] == 5
    assert pkg.coordinator.committed_cuts(d, "ol") == []
    assert not any(n.startswith("snap-ol.") for n in os.listdir(d))
