"""flink_ml_tpu_torch/ops/optimizer.py SGD against the JAX package's SGD.

Both packages get the same seeded numpy inputs. The JAX side runs on a
one-device mesh (its single-device whole fit, `_sgd_train_flat`), the port
on the CPU. Held to: the same epoch count, coefficients allclose
(rtol 1e-4, atol 1e-6: float32 reductions in another order over up to ten
epochs), final loss relative difference < 1e-5.
"""

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu.ops import losses as jax_losses
from flink_ml_tpu.ops import optimizer as jax_optimizer
from flink_ml_tpu.parallel import mesh as mesh_lib
from flink_ml_tpu_torch import config
from flink_ml_tpu_torch.ops import losses, optimizer


@pytest.fixture
def both_on_one_device():
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            yield


def _dense(seed, n, d, weighted):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    y = (X @ rng.standard_normal(d) + 0.3 * rng.standard_normal(n) > 0).astype(np.float64)
    w = rng.random(n) + 0.5 if weighted else None
    return X, y, w


def _sparse(seed, n, d, nnz):
    rng = np.random.default_rng(seed)
    indices = rng.integers(0, d, size=(n, nnz)).astype(np.int32)
    indices[rng.random((n, nnz)) < 0.25] = -1
    indices[rng.random((n, nnz)) < 0.03] = d + 2  # out of range: clamped/dropped
    values = rng.random((n, nnz))
    truth = rng.standard_normal(d)
    dots = np.where(indices >= 0, values * truth[np.clip(indices, 0, d - 1)], 0).sum(1)
    y = (dots > 0).astype(np.float64)
    return (indices, values), y


def _assert_parity(port, ref):
    coeff, loss, epochs = port
    ref_coeff, ref_loss, ref_epochs = ref
    assert epochs == ref_epochs
    np.testing.assert_allclose(coeff, ref_coeff, rtol=1e-4, atol=1e-6)
    assert abs(loss - ref_loss) <= 1e-5 * max(abs(ref_loss), 1e-30)


def _run_both(X, y, w, d, loss_name, sparse, **hyper):
    jax_loss = jax_losses.SPARSE_VARIANTS[loss_name] if sparse else {
        "binary_logistic": jax_losses.BINARY_LOGISTIC_LOSS,
        "hinge": jax_losses.HINGE_LOSS,
        "least_square": jax_losses.LEAST_SQUARE_LOSS,
    }[loss_name]
    port_loss = losses.SPARSE_VARIANTS[loss_name] if sparse else {
        "binary_logistic": losses.BINARY_LOGISTIC_LOSS,
        "hinge": losses.HINGE_LOSS,
        "least_square": losses.LEAST_SQUARE_LOSS,
    }[loss_name]
    init = np.zeros(d)
    ref = jax_optimizer.SGD(**hyper).optimize(init, X, y, w, jax_loss)
    port = optimizer.SGD(**hyper).optimize(init, X, y, w, port_loss)
    return port, ref


DENSE_CASES = [
    # (loss, weighted, n, batch, hyper)
    ("binary_logistic", False, 203, 64, {}),
    ("binary_logistic", True, 256, 64, {"reg": 0.1, "elastic_net": 0.0}),
    ("binary_logistic", True, 190, 50, {"reg": 0.05, "elastic_net": 1.0}),
    ("binary_logistic", False, 240, 48, {"reg": 0.1, "elastic_net": 0.5}),
    ("hinge", True, 150, 40, {"reg": 0.01}),
    ("least_square", False, 128, 32, {"learning_rate": 0.05}),
]


@pytest.mark.parametrize("loss_name,weighted,n,batch,hyper", DENSE_CASES)
def test_dense_sgd_matches_jax(both_on_one_device, loss_name, weighted, n, batch, hyper):
    X, y, w = _dense(n, n, 12, weighted)
    hyper = dict(max_iter=10, global_batch_size=batch, tol=0.0, **hyper)
    port, ref = _run_both(X, y, w, 12, loss_name, False, **hyper)
    _assert_parity(port, ref)


SPARSE_CASES = [
    ("binary_logistic", 211, 64, {}),
    ("binary_logistic", 256, 32, {"reg": 0.1, "elastic_net": 0.5}),
    ("hinge", 180, 60, {"reg": 0.05, "elastic_net": 1.0}),
    ("least_square", 120, 40, {}),
]


@pytest.mark.parametrize("loss_name,n,batch,hyper", SPARSE_CASES)
def test_sparse_sgd_matches_jax(both_on_one_device, loss_name, n, batch, hyper):
    X, y = _sparse(n, n, 48, 6)
    hyper = dict(max_iter=10, global_batch_size=batch, tol=0.0, **hyper)
    port, ref = _run_both(X, y, None, 48, loss_name, True, **hyper)
    _assert_parity(port, ref)


@pytest.mark.parametrize("sparse", [False, True])
def test_tol_stop_gives_the_same_epoch_count(both_on_one_device, sparse):
    """A tol the loss crosses mid-fit: the port's device-side mask stops
    where the JAX while-loop stops."""
    if sparse:
        X, y = _sparse(3, 300, 32, 5)
        w, d, tol = None, 32, 0.682
    else:
        X, y, w = _dense(3, 300, 8, False)
        d, tol = 8, 0.55
    hyper = dict(max_iter=10, global_batch_size=50, learning_rate=0.5, tol=tol)
    port, ref = _run_both(X, y, w, d, "binary_logistic", sparse, **hyper)
    assert 1 < ref[2] < 10
    _assert_parity(port, ref)


@pytest.mark.parametrize("elastic_net", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("reg", [0.0, 0.2])
def test_regularize_matches_jax(reg, elastic_net):
    coeff = np.random.default_rng(1).standard_normal(16).astype(np.float32)
    ref_c, ref_loss = jax_optimizer.regularize(jax.numpy.asarray(coeff), reg, elastic_net, 0.1)
    c, loss = optimizer.regularize(torch.from_numpy(coeff), reg, elastic_net, 0.1)
    np.testing.assert_allclose(c.numpy(), np.asarray(ref_c), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5, atol=1e-7)


def test_label_flag_rides_the_packed_result(both_on_one_device):
    X, y, _ = _dense(4, 100, 4, False)
    sgd = optimizer.SGD(max_iter=3, global_batch_size=32)
    ok = optimizer.read_train_result(
        sgd.optimize_async(np.zeros(4), X, torch.from_numpy(y), None,
                           losses.BINARY_LOGISTIC_LOSS, validate_labels=True)
    )
    y[3] = 2.0
    bad = optimizer.read_train_result(
        sgd.optimize_async(np.zeros(4), X, torch.from_numpy(y), None,
                           losses.BINARY_LOGISTIC_LOSS, validate_labels=True)
    )
    assert ok[0] == 1.0 and bad[0] == 0.0


@pytest.mark.parametrize(
    "kwargs,mesh",
    [({"checkpoint_dir": "ckpt"}, None), ({"shard_features": True}, None),
     ({"collective_overlap": True}, None), ({}, "a mesh")],
)
def test_unported_options_raise(both_on_one_device, kwargs, mesh):
    X, y, _ = _dense(5, 40, 3, False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        optimizer.SGD(**kwargs).optimize(
            np.zeros(3), X, y, None, losses.BINARY_LOGISTIC_LOSS, mesh=mesh
        )
