"""The program bank (flink_ml_tpu_torch/compilebank.py) on the CPU.

The JAX package's bank tests (tests/test_compilebank.py) case for case
where the contract is the same:

- the refusal cases (`:123-199`): a flipped byte in an entry, an entry
  whose payload does not parse (with a valid digest), a fingerprint
  mismatch and a torn manifest are refused with a warning naming the
  reason and a `bank.refused` tick, never a crash, in both packages, and
  the call that follows still answers;
- the extras round trip (`:227`): a banked call's extras come back on the
  hit in a fresh bank scope;
- the warm load: a fresh bank scope records every banked fit signature
  ahead of the first fit (`jit.bankLoads`), so that fit counts no
  capture; a refused entry is captured at its first call as without a
  bank;
- static tokens equal the JAX package's where both define one, and each
  rebuilds its value.
"""

import hashlib
import json
import logging
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flink_ml_tpu import compilebank as jax_compilebank
from flink_ml_tpu import config as jax_config
from flink_ml_tpu.utils import lazyjit as jax_lazyjit
from flink_ml_tpu.utils import metrics as jax_metrics
from flink_ml_tpu_torch import Table, compilebank, config
from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression
from flink_ml_tpu_torch.ops import losses
from flink_ml_tpu_torch.utils import lazyjit, metrics

X = np.linspace(-2.0, 3.0, 32, dtype=np.float32)


def _affine(x, scale):
    return x * scale + 1.0


JAX_AFFINE = jax_lazyjit.lazy_jit(_affine, static_argnames=("scale",))
PORT_AFFINE = lazyjit.lazy_jit(_affine, static_argnames=("scale",))

PKGS = {
    "jax": (jax_compilebank, jax_config, jax_metrics,
            lambda: np.asarray(JAX_AFFINE(jnp.asarray(X), scale=5.0))),
    "port": (compilebank, config, metrics,
             lambda: PORT_AFFINE(torch.from_numpy(X), scale=5.0).numpy()),
}


def _populated_bank(tmp_path, pkg):
    bank_mod, cfg, _, call = PKGS[pkg]
    bank_dir = str(tmp_path / f"bank_{pkg}")
    with config.use_device("cpu"), cfg.program_bank_mode(bank_dir):
        call()
    return bank_dir


def _flip_byte(bank_dir, bank_mod):
    manifest = json.load(open(os.path.join(bank_dir, bank_mod.MANIFEST)))
    (record,) = manifest["entries"].values()
    path = os.path.join(bank_dir, record["file"])
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[:-4] + b"\x00\x00\x00\x00")


def _garbage_payload(bank_dir, bank_mod):
    manifest_path = os.path.join(bank_dir, bank_mod.MANIFEST)
    manifest = json.load(open(manifest_path))
    (sig,) = manifest["entries"]
    garbage = b'{"not": "an entry"}'
    with open(os.path.join(bank_dir, manifest["entries"][sig]["file"]), "wb") as f:
        f.write(garbage)
    manifest["entries"][sig]["sha256"] = hashlib.sha256(garbage).hexdigest()
    with open(manifest_path, "w") as f:
        json.dump(manifest, f)


def _stale_fingerprint(bank_dir, bank_mod):
    manifest_path = os.path.join(bank_dir, bank_mod.MANIFEST)
    manifest = json.load(open(manifest_path))
    manifest["fingerprint"]["formatVersion"] = -1
    with open(manifest_path, "w") as f:
        json.dump(manifest, f)


def _torn_manifest(bank_dir, bank_mod):
    with open(os.path.join(bank_dir, bank_mod.MANIFEST), "w") as f:
        f.write('{"fingerprint": {"formatVersion"')


REFUSALS = {
    "digest": (_flip_byte, "digest mismatch"),
    "payload": (_garbage_payload, "deserialize"),
    "fingerprint": (_stale_fingerprint, "fingerprint mismatch"),
    "manifest": (_torn_manifest, "unreadable manifest"),
}


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("kind", sorted(REFUSALS))
def test_refusals_warn_tick_and_never_crash(tmp_path, caplog, kind, pkg):
    bank_mod, cfg, registry, call = PKGS[pkg]
    bank_dir = _populated_bank(tmp_path, pkg)
    corrupt, reason = REFUSALS[kind]
    corrupt(bank_dir, bank_mod)
    with caplog.at_level(logging.WARNING, logger=bank_mod.__name__):
        with config.use_device("cpu"), cfg.program_bank_mode(bank_dir):
            refused = registry.get_counter("bank.refused")
            loads = registry.get_counter("jit.bankLoads")
            out = call()
            assert registry.get_counter("bank.refused") - refused >= 1
            assert registry.get_counter("jit.bankLoads") == loads
    assert any(reason in r.message for r in caplog.records)
    np.testing.assert_allclose(out, X * np.float32(5.0) + np.float32(1.0), rtol=1e-6)


def test_a_flipped_byte_refuses_that_entry_alone(tmp_path):
    bank_dir = str(tmp_path / "bank")
    with config.use_device("cpu"), config.program_bank_mode(bank_dir):
        PORT_AFFINE(torch.from_numpy(X), scale=11.0)
        PORT_AFFINE(torch.from_numpy(X[:8]), scale=11.0)
    manifest = json.load(open(os.path.join(bank_dir, compilebank.MANIFEST)))
    first = sorted(manifest["entries"].values(), key=lambda r: r["file"])[0]
    path = os.path.join(bank_dir, first["file"])
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0x01
    open(path, "wb").write(bytes(raw))
    with config.use_device("cpu"), config.program_bank_mode(bank_dir):
        refused = metrics.get_counter("bank.refused")
        bank = compilebank.active_bank()
        assert metrics.get_counter("bank.refused") - refused == 1
        assert bank.stats()["entries"] == 1.0


def test_extras_round_trip_across_a_fresh_bank(tmp_path):
    bank_dir = str(tmp_path / "bank")
    seen = []

    def run(x):
        return x + 1.0

    with config.use_device("cpu"), config.program_bank_mode(bank_dir):
        handled, _ = compilebank.banked_call(
            compilebank.active_bank(), "test.extras", run, (torch.from_numpy(X),), {},
            extras_fn=lambda: {"guards": ["g1", "g2"]}, on_extras=seen.append)
        assert handled
    with config.use_device("cpu"), config.program_bank_mode(bank_dir):
        handled, out = compilebank.banked_call(
            compilebank.active_bank(), "test.extras", run, (torch.from_numpy(X),), {},
            on_extras=seen.append)
        assert handled
    assert seen == [{"guards": ["g1", "g2"]}, {"guards": ["g1", "g2"]}]
    np.testing.assert_array_equal(out.numpy(), X + np.float32(1.0))


def test_unbankable_static_falls_through(tmp_path):
    class Opaque:
        pass

    wobbly = lazyjit.lazy_jit(lambda x, tag: x + 1.0, static_argnames=("tag",))
    with config.use_device("cpu"), config.program_bank_mode(str(tmp_path / "bank")):
        before = metrics.get_counter("bank.unbankable")
        out = wobbly(torch.from_numpy(X), tag=Opaque())
        assert metrics.get_counter("bank.unbankable") - before == 1
        assert compilebank.active_bank().stats()["entries"] == 0.0
    np.testing.assert_array_equal(out.numpy(), X + np.float32(1.0))


def _lr_table(n):
    rng = np.random.default_rng(n)
    feats = rng.standard_normal((n, 4))
    return Table({"features": feats, "label": (feats[:, 0] > 0).astype(np.float64)})


@pytest.mark.parametrize("sparse", [False, True])
def test_a_banked_fit_signature_is_warm_loaded(tmp_path, sparse):
    """A fresh bank scope records (on the card: captures) every banked fit
    signature at load time: the first fit after it counts no capture, is
    a bank hit, and equals the fit that filled the bank."""
    n = 211 if sparse else 203  # signatures no other test makes
    if sparse:
        from flink_ml_tpu_torch import SparseVector

        rng = np.random.default_rng(n)
        feats = [SparseVector(20, np.sort(rng.choice(20, 3, replace=False)), rng.random(3))
                 for _ in range(n)]
        table = Table({"features": feats, "label": (rng.random(n) > 0.5).astype(np.float64)})
    else:
        table = _lr_table(n)
    est = LogisticRegression().set_max_iter(4).set_global_batch_size(64)
    bank_dir = str(tmp_path / "bank")
    with config.use_device("cpu"), config.program_bank_mode(bank_dir):
        want = est.fit(table).coefficient
        assert compilebank.active_bank().stats()["entries"] >= 1.0
    lazyjit.registered(
        "flink_ml_tpu_torch.ops.optimizer._sgd_train_flat").cache.entries.clear()  # a fresh process
    with config.use_device("cpu"), config.program_bank_mode(bank_dir):
        loads = metrics.get_counter("jit.bankLoads")
        bank = compilebank.active_bank()
        assert metrics.get_counter("jit.bankLoads") - loads >= 1
        traces, hits = metrics.get_counter("jit.traces"), metrics.get_counter("bank.hits")
        got = est.fit(table).coefficient
        assert metrics.get_counter("jit.traces") == traces
        assert metrics.get_counter("bank.hits") - hits == 1
        assert bank.stats()["loadMs"] >= 0.0
    assert got.tobytes() == want.tobytes()


def test_manifest_is_the_jax_contract(tmp_path):
    bank_dir = _populated_bank(tmp_path, "port")
    manifest = json.load(open(os.path.join(bank_dir, compilebank.MANIFEST)))
    assert set(manifest) == {"fingerprint", "entries"}
    assert set(manifest["fingerprint"]) == {"formatVersion", "torch", "cuda", "device",
                                            "deviceCount", "kernelSources"}
    for sig, record in manifest["entries"].items():
        raw = open(os.path.join(bank_dir, record["file"]), "rb").read()
        assert record["file"] == sig + compilebank.ENTRY_SUFFIX
        assert record["sha256"] == hashlib.sha256(raw).hexdigest()
        assert json.loads(raw)["kernel"] == record["kernel"] == PORT_AFFINE.kernel.kernel_id


TOKENS = [None, True, 3, 2.5, "euclidean", (1, 2), [3, "a"], {"b": 1, "a": (2, 3)}]


@pytest.mark.parametrize("value", TOKENS, ids=repr)
def test_static_tokens_match_jax_and_rebuild(value):
    token = compilebank.static_token(value)
    assert token == jax_compilebank.static_token(value)
    rebuilt = compilebank.static_value(token)
    assert compilebank.static_token(rebuilt) == token


def test_named_singletons_rebuild_by_name():
    for loss in (losses.BINARY_LOGISTIC_LOSS, losses.sparse_variant("hinge"),
                 losses.fleet_loss("least_square", plain=True)):
        token = compilebank.static_token(loss)
        assert token == f"LossFunc:{loss.name}"
        assert compilebank.static_value(token) is loss
    impostor = losses.LossFunc("binary_logistic", lambda *a: a, None)
    assert compilebank.static_token(impostor) is None  # its name names another object
