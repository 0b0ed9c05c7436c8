"""flink_ml_tpu_torch/ops/optimizer.py SGD against the JAX package's SGD.

Both packages get the same seeded numpy inputs. The JAX side runs on a
one-device mesh (its single-device whole fit, `_sgd_train_flat`), the port
on the CPU. Held to: the same epoch count, coefficients allclose
(rtol 1e-4, atol 1e-6: float32 reductions in another order over up to ten
epochs), final loss relative difference < 1e-5.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu.ops import losses as jax_losses
from flink_ml_tpu.ops import optimizer as jax_optimizer
from flink_ml_tpu.parallel import mesh as mesh_lib
from flink_ml_tpu_torch import config
from flink_ml_tpu_torch.ops import losses, optimizer
from flink_ml_tpu_torch.parallel import launcher

#: the gloo world of the float64 mesh fits, and the job each rank runs
MESH_RANKS, MESH_JOB = 4, "torch_mesh_jobs:sgd_fit"


@pytest.fixture
def both_on_one_device():
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            yield


@pytest.fixture(scope="module")
def world():
    """A world of MESH_RANKS gloo ranks on the CPU, opened on first use."""
    opened = []

    def get():
        if not opened:
            opened.append(launcher.World(MESH_RANKS, device="cpu", timeout_s=120.0,
                                         collective_timeout_s=60.0))
        return opened[0]
    yield get
    for w in opened:
        w.close()


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
def test_unported_options_raise(both_on_one_device, kwargs, mesh, tmp_path):
    """Feature sharding raised naming A.10b until it was ported; on one
    rank it now takes the flat fit, bit for bit (the 2D layout on ranks is
    held in tests/test_torch_mesh2d.py). `checkpoint_dir` raised (A.13) until checkpoints were ported;
    it now checkpoints, and its fit equals the unchecked fit bit for bit.
    `collective_overlap` and a mesh raised until the data axis was ported
    (A.10a): on a mesh of one rank both take the flat fit, bit for bit
    (a mesh of ranks is held in tests/test_torch_mesh.py)."""
    from flink_ml_tpu_torch.parallel import mesh as port_mesh

    X, y, _ = _dense(5, 40, 3, False)
    plain = optimizer.SGD().optimize(np.zeros(3), X, y, None, losses.BINARY_LOGISTIC_LOSS)
    if "checkpoint_dir" in kwargs:
        ckpt = optimizer.SGD(checkpoint_dir=str(tmp_path), checkpoint_key="k").optimize(
            np.zeros(3), X, y, None, losses.BINARY_LOGISTIC_LOSS, mesh=mesh)
        np.testing.assert_array_equal(ckpt[0], plain[0])
        assert ckpt[1:] == plain[1:] and os.listdir(tmp_path) == ["snap-k.npz"]
        return
    if "shard_features" in kwargs:
        got = optimizer.SGD(**kwargs).optimize(
            np.zeros(3), X, y, None, losses.BINARY_LOGISTIC_LOSS, mesh=mesh)
        np.testing.assert_array_equal(got[0], plain[0])
        assert got[1:] == plain[1:]
        return
    if mesh == "a mesh":
        mesh = port_mesh.create_mesh()
    got = optimizer.SGD(**kwargs).optimize(np.zeros(3), X, y, None, losses.BINARY_LOGISTIC_LOSS,
                                           mesh=mesh)
    np.testing.assert_array_equal(got[0], plain[0])
    assert got[1:] == plain[1:]


# ---------------------------------------------------------------------------
# SGD.dtype and the four-field LossFunc (ROADMAP C.38)
# ---------------------------------------------------------------------------

def test_sgd_fields_follow_the_jax_order():
    """`dtype` comes after `elastic_net`, as in the JAX package: a
    positional seventh argument lands in `dtype`, not in `checkpoint_dir`."""
    import dataclasses

    port = [f.name for f in dataclasses.fields(optimizer.SGD)]
    ref = [f.name for f in dataclasses.fields(jax_optimizer.SGD)]
    assert port[:len(ref)] == ref
    assert optimizer.SGD().dtype == torch.float32
    sgd = optimizer.SGD(20, 0.1, 32, 1e-6, 0.0, 0.0, np.float64)
    assert sgd.dtype is np.float64 and sgd.checkpoint_dir is None


@pytest.mark.parametrize("dtype", [torch.float32, np.float32, "float32"])
@pytest.mark.parametrize("route", ["whole_fit", "eager", "checkpointed", "stream"])
def test_float32_dtype_is_the_default_bit_for_bit(both_on_one_device, dtype, route, tmp_path):
    X, y, w = _dense(6, 203, 7, True)
    hyper = dict(max_iter=9, global_batch_size=64, reg=0.1, elastic_net=0.5, tol=0.0)

    def fit(**extra):
        sgd = optimizer.SGD(**hyper, **extra)
        if route == "stream":
            chunks = [(X[i:i + 50], y[i:i + 50], w[i:i + 50]) for i in range(0, 203, 50)]
            return sgd.optimize_stream(None, chunks, losses.BINARY_LOGISTIC_LOSS)[:3]
        if route == "checkpointed":
            sgd.checkpoint_dir, sgd.checkpoint_key = str(tmp_path / str(len(extra))), "k"
        return sgd.optimize(np.zeros(7), X, y, w, losses.BINARY_LOGISTIC_LOSS)

    with config.whole_fit_mode("off") if route == "eager" else contextlib.nullcontext():
        want, got = fit(), fit(dtype=dtype)
    assert got[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def _replay64(X, y, w, batch, max_iter, lr, reg, elastic_net, pointwise):
    """The port's epoch loop in float64 numpy: batch e mod num_batches, each
    epoch first applies the previous gradient (not while the weight sum is
    0), the proximal step where reg > 0, one update after the loop."""
    n, d = X.shape
    nb = -(-n // batch)
    pad = nb * batch - n
    Xp = np.concatenate([X, np.zeros((pad, d))])
    yp = np.concatenate([y, np.zeros(pad)])
    wp = np.concatenate([w, np.zeros(pad)])
    coeff, grad, wsum = np.zeros(d), np.zeros(d), 0.0

    def update(coeff):
        coeff = coeff - (lr / max(wsum, 1e-30)) * grad
        if reg > 0:
            coeff = coeff - lr * (elastic_net * reg * np.sign(coeff)
                                  + (1.0 - elastic_net) * reg * coeff)
        return coeff

    for e in range(max_iter):
        if wsum > 0:
            coeff = update(coeff)
        k = slice((e % nb) * batch, (e % nb + 1) * batch)
        loss, mult = pointwise(Xp[k] @ coeff, yp[k], wp[k])
        grad, wsum = Xp[k].T @ mult, float(wp[k].sum())
    return update(coeff) if wsum > 0 else coeff


def _logistic64(dot, y, w):
    margin = dot * (2.0 * y - 1.0)
    return w * np.logaddexp(0.0, -margin), w * (-(2.0 * y - 1.0) / (np.exp(margin) + 1.0))


def _least_square64(dot, y, w):
    return w * 0.5 * (dot - y) ** 2, w * (dot - y)


@pytest.mark.parametrize("loss_name,pointwise,hyper", [
    ("binary_logistic", _logistic64, dict(reg=0.1, elastic_net=0.5)),
    ("least_square", _least_square64, dict(learning_rate=0.05)),
])
@pytest.mark.parametrize("route", ["whole_fit", "checkpointed", "stream", "mesh", "mesh_overlap"])
def test_float64_dense_fit_against_a_float64_replay(both_on_one_device, loss_name, pointwise,
                                                    hyper, route, tmp_path, world):
    """`SGD(dtype=float64)` trains a dense fit in float64 (the JAX package
    under x64): the coefficients agree with a float64 replay of the same
    loop to 1e-12, far below float32's 1e-7, and every one-device route
    gives the whole fit's bits. On a mesh of MESH_RANKS gloo ranks, plain
    and overlapped, the sums reduce in another order: the fit is held to
    the replay at 1e-12, with the whole fit's epochs, on every rank."""
    X, y, w = _dense(7, 203, 9, True)
    loss = {"binary_logistic": losses.BINARY_LOGISTIC_LOSS,
            "least_square": losses.LEAST_SQUARE_LOSS}[loss_name]
    hyper = dict(max_iter=12, global_batch_size=64, tol=0.0, **hyper)
    sgd = optimizer.SGD(dtype=torch.float64, **hyper)
    whole = sgd.optimize(np.zeros(9), X, y, w, loss)
    assert whole[0].dtype == np.float64 and whole[2] == 12
    want = _replay64(X, y, w, 64, 12, hyper.get("learning_rate", 0.1), hyper.get("reg", 0.0),
                     hyper.get("elastic_net", 0.0), pointwise)
    np.testing.assert_allclose(whole[0], want, rtol=1e-12, atol=1e-14)
    f32 = optimizer.SGD(**hyper).optimize(np.zeros(9), X, y, w, loss)[0]
    assert np.abs(f32 - want).max() > 1e-9  # the float32 fit does not reach it
    if route.startswith("mesh"):
        out = world().run(MESH_JOB, X, y, w, 9, loss_name,
                          dict(hyper, dtype="float64", collective_overlap=route == "mesh_overlap"))
        for coeff, loss_value, epochs, _, _ in out:
            assert coeff.dtype == np.float64 and epochs == whole[2]
            np.testing.assert_allclose(coeff, want, rtol=1e-12, atol=1e-14)
            assert abs(loss_value - whole[1]) <= 1e-12 * abs(whole[1])
        return
    if route == "stream":
        chunks = [(X[i:i + 50], y[i:i + 50], w[i:i + 50]) for i in range(0, 203, 50)]
        got = sgd.optimize_stream(None, chunks, loss)[:3]
    elif route == "checkpointed":
        ckpt = optimizer.SGD(dtype="float64", checkpoint_dir=str(tmp_path), checkpoint_key="k",
                             checkpoint_interval=5, **hyper)
        got = ckpt.optimize(np.zeros(9), X, y, w, loss)
        assert ckpt.optimize(np.zeros(9), X, y, w, loss)[2] == 12  # resumed from the last cut
    else:
        got = whole
    np.testing.assert_array_equal(got[0], whole[0])
    assert got[1:] == whole[1:]


@pytest.mark.parametrize("dtype", [torch.float64, np.float64, "float64", torch.float16])
def test_a_sparse_fit_off_float32_raises(both_on_one_device, dtype):
    """The sparse kernels take float32 values (ROADMAP C.40): a padded-CSR
    fit at another dtype raises naming that contract, on the plain
    versions too."""
    X, y = _sparse(8, 64, 16, 4)
    for loss in (losses.SPARSE_BINARY_LOGISTIC_LOSS,
                 losses.PLAIN_SPARSE_VARIANTS["binary_logistic"]):
        with pytest.raises(TypeError, match="take float32 values"):
            optimizer.SGD(dtype=dtype).optimize(np.zeros(16), X, y, None, loss)
    with pytest.raises(TypeError, match="floating dtype"):
        optimizer.SGD(dtype=np.int32).optimize(np.zeros(16), X, y, None,
                                               losses.SPARSE_BINARY_LOGISTIC_LOSS)


def test_loss_func_has_the_jax_fields_and_defaults():
    """`LossFunc` is the JAX NamedTuple's four fields with its defaults: a
    four-field construction works, the sparse losses are marked sparse,
    and the named sparse losses and `sigmoid` exist."""
    assert losses.LossFunc._fields == jax_losses.LossFunc._fields
    assert losses.LossFunc._field_defaults == jax_losses.LossFunc._field_defaults
    four = losses.LossFunc("mine", losses.BINARY_LOGISTIC_LOSS.fn,
                           losses.BINARY_LOGISTIC_LOSS.pointwise, True)
    assert four.sparse and losses.LossFunc("bare", four.fn).pointwise is None
    for name in ("binary_logistic", "hinge", "least_square"):
        assert losses.SPARSE_VARIANTS[name].sparse
        assert losses.PLAIN_SPARSE_VARIANTS[name].sparse
        assert losses.feature_sharded_variant(losses.SPARSE_VARIANTS[name]).sparse
        assert not losses.BY_NAME[name].sparse
        assert losses.SPARSE_VARIANTS[name].sparse == jax_losses.SPARSE_VARIANTS[name].sparse
    assert losses.SPARSE_HINGE_LOSS is losses.SPARSE_VARIANTS["hinge"]
    assert losses.SPARSE_LEAST_SQUARE_LOSS is losses.SPARSE_VARIANTS["least_square"]
    assert losses.SPARSE_HINGE_LOSS.name == jax_losses.SPARSE_HINGE_LOSS.name
    assert losses.SPARSE_LEAST_SQUARE_LOSS.name == jax_losses.SPARSE_LEAST_SQUARE_LOSS.name
    z = np.linspace(-30.0, 30.0, 61)
    np.testing.assert_allclose(losses.sigmoid(torch.from_numpy(z)).numpy(),
                               np.asarray(jax_losses.sigmoid(jax.numpy.asarray(z))), rtol=1e-6)
