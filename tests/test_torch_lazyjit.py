"""The program funnel (flink_ml_tpu_torch/utils/lazyjit.py) against the JAX
package's lazyjit, and the whole fits through it.

- the funnel's counters (`jit.kernels`, `jit.traces`, `jit.kernelCacheEvict`,
  `jit.kernelCacheSize`) equal the JAX package's on the same call
  sequences, the two keyed-LRU cases of tests/test_compilebank.py among
  them; on the CPU a new signature counts as a capture, and each capture
  is one `jit.compiles`;
- the hyperparameters as a float32 operand vector give the host-scalar
  form's bits (a copy of the host-scalar fit is the reference);
- a fit through the funnel equals the eager fit (`config.whole_fit="off"`)
  bit for bit and the JAX package's fit at the parity tolerances
  (test_torch_sgd.py's and test_torch_fleet.py's rtol 1e-4, atol 1e-6 on
  the coefficients, with the same epochs; test_torch_kmeans.py's rtol
  1e-5, atol 1e-5 on the centroids, the counts equal): dense and sparse
  SGD, a sweep (other learning rates, regs and tols add no signature),
  the dense, sparse and KMeans fleets, and KMeans;
- staging pads, casts and cuts to the touched rows, and hands an input
  that needs no copy back as itself (the funnel borrows it); `borrow`
  marks its arguments' leaves; the global eviction by bytes drops the
  least recently used graph of any cache.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flink_ml_tpu import SparseBatch as JaxSparseBatch
from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu import config as jax_config
from flink_ml_tpu import fleet as jax_fleet
from flink_ml_tpu.models.classification import logisticregression as jax_lr
from flink_ml_tpu.models.clustering import kmeans as jax_kmeans
from flink_ml_tpu.ops import losses as jax_losses
from flink_ml_tpu.ops import optimizer as jax_optimizer
from flink_ml_tpu.parallel import mesh as mesh_lib
from flink_ml_tpu.utils import lazyjit as jax_lazyjit
from flink_ml_tpu.utils import metrics as jax_metrics
from flink_ml_tpu_torch import SparseBatch, Table, config
from flink_ml_tpu_torch.fleet import FitFleet
from flink_ml_tpu_torch.models.classification import logisticregression as port_lr
from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression
from flink_ml_tpu_torch.models.clustering import kmeans as port_kmeans
from flink_ml_tpu_torch.models.clustering.kmeans import KMeans
from flink_ml_tpu_torch.ops import losses, optimizer
from flink_ml_tpu_torch.utils import lazyjit, metrics

COUNTERS = ("jit.kernels", "jit.traces", "jit.kernelCacheEvict")


def _delta(registry, before):
    return {k: registry.get_counter(k) - before[k] for k in COUNTERS}


def _snap(registry):
    return {k: registry.get_counter(k) for k in COUNTERS}


def _affine(x, scale):
    return x * scale + 1.0


JAX_AFFINE = jax_lazyjit.lazy_jit(_affine, static_argnames=("scale",))
PORT_AFFINE = lazyjit.lazy_jit(_affine, static_argnames=("scale",))

X = np.linspace(-2.0, 3.0, 32, dtype=np.float32)

#: call sequences: (rows, scale) per call
SEQUENCES = {
    "repeat": [(32, 2.0), (32, 2.0), (32, 2.0)],
    "shapes": [(32, 2.0), (8, 2.0), (32, 2.0), (8, 2.0), (16, 2.0)],
    "statics": [(32, 2.0), (32, 3.0), (32, 2.0), (32, 4.0)],
    "mixed": [(32, 5.0), (8, 5.0), (8, 6.0), (32, 5.0), (8, 6.0)],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_lazy_jit_counters_match_jax(name):
    jax_affine = jax_lazyjit.lazy_jit(_affine, static_argnames=("scale",))
    port_affine = lazyjit.lazy_jit(_affine, static_argnames=("scale",))
    jax_before, port_before = _snap(jax_metrics), _snap(metrics)
    compiles = metrics.get_counter("jit.compiles")
    with config.use_device("cpu"):
        for rows, scale in SEQUENCES[name]:
            want = np.asarray(jax_affine(jnp.asarray(X[:rows]), scale=scale))
            got = port_affine(torch.from_numpy(X[:rows]), scale=scale).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-6)  # XLA may fuse a multiply-add
    assert _delta(metrics, port_before) == _delta(jax_metrics, jax_before)
    assert metrics.get_counter("jit.compiles") - compiles == _delta(metrics, port_before)[
        "jit.traces"]


def _make_power(p):
    def power(x):
        return (x ** p).sum()

    return power


def _jax_power(p):
    def power(x):
        return jnp.sum(x ** p)

    return power


def _lru_evicts(keyed, registry, to_array, x):
    with (jax_config if registry is jax_metrics else config).kernel_cache_limit(2):
        before = _snap(registry)
        first = {p: to_array(keyed(p)(x)) for p in (1, 2, 3, 4)}
        size = registry.snapshot()["gauges"]["jit.kernelCacheSize"]
        again = {p: to_array(keyed(p)(x)) for p in (1, 2, 3, 4)}
    return _delta(registry, before), size, first, again


def _lru_touch(keyed, registry, x):
    with (jax_config if registry is jax_metrics else config).kernel_cache_limit(2):
        k5, k6 = keyed(5), keyed(6)
        keyed(5)  # touch 5: 6 is now least recent
        before = _snap(registry)
        keyed(7)  # evicts 6, not 5
        evicted = _delta(registry, before)["jit.kernelCacheEvict"]
        before = _snap(registry)
        kept = keyed(5) is k5
        rebuilt_none = _delta(registry, before)["jit.kernels"]
        return evicted, kept, rebuilt_none, keyed(6) is not k6


@pytest.mark.parametrize("case", ["evicts_and_reconstructs", "touch_refreshes_recency"])
def test_keyed_jit_lru_matches_jax(case):
    jax_keyed = jax_lazyjit.keyed_jit(_jax_power)
    port_keyed = lazyjit.keyed_jit(_make_power)
    with config.use_device("cpu"):
        if case == "evicts_and_reconstructs":
            want = _lru_evicts(jax_keyed, jax_metrics, np.asarray, jnp.asarray(X))
            got = _lru_evicts(port_keyed, metrics, lambda t: t.numpy(), torch.from_numpy(X))
            assert got[0] == want[0] and got[0]["jit.kernelCacheEvict"] >= 2
            assert got[1] == want[1] <= 2.0
            for p in (1, 2, 3, 4):
                assert got[2][p].tobytes() == got[3][p].tobytes()
                np.testing.assert_allclose(got[2][p], want[2][p], rtol=1e-6)
        else:
            want = _lru_touch(jax_keyed, jax_metrics, jnp.asarray(X))
            got = _lru_touch(port_keyed, metrics, torch.from_numpy(X))
            assert got == want == (1, True, 0, True)


def test_whole_fit_off_is_a_plain_call():
    before = _snap(metrics)
    with config.use_device("cpu"), config.whole_fit_mode("off"):
        out = PORT_AFFINE(torch.from_numpy(X), scale=2.0)
    assert _delta(metrics, before) == dict.fromkeys(COUNTERS, 0)
    np.testing.assert_array_equal(out.numpy(), X * np.float32(2.0) + np.float32(1.0))


# ---------------------------------------------------------------------------
# the hyperparameters as operands: the host-scalar form's bits
# ---------------------------------------------------------------------------

def _host_prox(coeff, reg, en, lr):
    if reg <= 0.0:
        return coeff
    return coeff - lr * (en * reg * torch.sign(coeff) + (1.0 - en) * reg * coeff)


def _host_update(coeff, grad, wsum, lr, reg, en):
    updated = coeff - (lr / torch.clamp(wsum, min=1e-30)) * grad
    updated = _host_prox(updated, reg, en, lr)
    return torch.where(wsum > 0, updated, coeff)


def _host_scalar_fit(X, y, w, init, loss, batch, n, max_iter, tol, lr, reg, en):
    """The fit with host-float hyperparameters, as the port computed it
    before they became operands."""
    state = optimizer._init_state(init)
    nb = y.shape[0] // batch
    for e in range(max_iter):
        begin = (e % nb) * batch
        Xk = optimizer._slice_rows(X, begin, batch)
        yk = y[begin:begin + batch]
        wk = w[begin:begin + batch] if w is not None else \
            (torch.arange(begin, begin + batch) < n).to(torch.float32)
        live = state[4] > tol
        coeff, grad, wsum, epoch = state[:4]
        coeff = _host_update(coeff, grad, wsum, lr, reg, en)
        lsum, grad, wsum = loss(Xk, yk, wk, coeff)
        crit = (lsum / torch.clamp(wsum, min=1e-30)).to(torch.float32)
        new = (coeff, grad, wsum, epoch + 1, crit)
        state = tuple(torch.where(live, a, b) for a, b in zip(new, state))
    coeff, grad, wsum, epochs, criteria = state
    coeff = _host_update(coeff, grad, wsum, lr, reg, en)
    return optimizer._pack_train_result(coeff, criteria, epochs)


HYPERS = [
    # (lr, reg, elastic_net, tol)
    (0.1, 0.0, 0.0, 1e-6),
    (0.5, 0.1, 0.0, 1e-6),
    (0.3, 0.05, 1.0, 1e-6),
    (0.7, 0.2, 0.5, 1e-6),
    (0.1, 0.3, 0.3, 0.6),  # the tol stop fires mid-fit
]


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("hyper", HYPERS)
def test_operand_hyper_gives_the_host_scalar_bits(hyper, sparse):
    lr, reg, en, tol = hyper
    rng = np.random.default_rng(7)
    n, d, batch = 90, 6, 32
    if sparse:
        idx = torch.as_tensor(rng.integers(-1, d, (n, 3)).astype(np.int32))
        X = (idx, torch.as_tensor(rng.random((n, 3)).astype(np.float32)))
        loss = losses.SPARSE_VARIANTS["binary_logistic"]
    else:
        X = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32))
        loss = losses.BINARY_LOGISTIC_LOSS
    y = torch.as_tensor((rng.random(n) > 0.5).astype(np.float32))
    with config.use_device("cpu"):
        X_f, y_f, w_f, n_true = lazyjit.materialize(optimizer.stage_flat(X, y, None, batch))
        init = torch.zeros(d)
        want = _host_scalar_fit(X_f, y_f, w_f, init, loss, batch, n_true, 8, tol, lr, reg, en)
        got = optimizer._sgd_train_flat(X_f, y_f, w_f, init,
                                        optimizer.sgd_hyper(lr, reg, en, tol, "cpu"), loss,
                                        batch, n_true, 8, False)
    assert got.numpy().tobytes() == want.numpy().tobytes()


# ---------------------------------------------------------------------------
# whole fits: funnel == eager bit for bit, and the JAX fit
# ---------------------------------------------------------------------------

#: the JAX parity tolerances of tests/test_torch_sgd.py and
#: tests/test_torch_fleet.py (coefficients), tests/test_torch_kmeans.py
#: (centroids; the counts equal)
COEFF_TOL = dict(rtol=1e-4, atol=1e-6)
CENTROID_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def both_on_one_device():
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            yield


def _dense_table(seed=3, n=300, d=5, weighted=False):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    y = (X @ rng.standard_normal(d) > 0).astype(np.float64)
    cols = {"features": X, "label": y}
    if weighted:
        cols["weight"] = rng.random(n) + 0.5
    return cols


def _sparse_rows(seed, n, d, nnz):
    rng = np.random.default_rng(seed)
    idx = rng.integers(-1, d, (n, nnz)).astype(np.int32)  # -1 is padding
    return idx, rng.random((n, nnz)), (rng.random(n) > 0.5).astype(np.float64)


def _both(fn):
    """fn() through the funnel and eagerly, on the CPU."""
    with config.use_device("cpu"):
        funnel = fn()
        with config.whole_fit_mode("off"):
            eager = fn()
    return funnel, eager


def _sgd(sparse, n, batch, max_iter, lr, reg, en, weighted=False):
    """One SGD fit through the funnel, eagerly and in the JAX package:
    [(funnel, eager, jax, tolerance)]."""
    if sparse:
        idx, vals, y = _sparse_rows(11, n, 40, 4)
        X, w, d, loss = (idx, vals), None, 40, "sparse"
    else:
        cols = _dense_table(n=n, weighted=weighted)
        X, y, w, d, loss = cols["features"], cols["label"], cols.get("weight"), 5, "dense"
    hyper = dict(max_iter=max_iter, learning_rate=lr, global_batch_size=batch, reg=reg,
                 elastic_net=en, tol=1e-9)
    port_loss = losses.SPARSE_VARIANTS["binary_logistic"] if sparse else \
        losses.BINARY_LOGISTIC_LOSS
    jax_loss = jax_losses.SPARSE_VARIANTS["binary_logistic"] if sparse else \
        jax_losses.BINARY_LOGISTIC_LOSS

    (c1, l1, e1), (c2, l2, e2) = _both(
        lambda: optimizer.SGD(**hyper).optimize(np.zeros(d), X, y, w, port_loss))
    ref_c, _, ref_e = jax_optimizer.SGD(**hyper).optimize(np.zeros(d), X, y, w, jax_loss)
    assert (l1, e1) == (l2, e2) and e1 == ref_e, loss
    return [(c1, c2, ref_c, COEFF_TOL)]


SWEEP = [(0.05, 0.0, 1e-3), (0.3, 0.2, 1e-4), (0.9, 0.01, 1e-3)]  # (lr, reg, tol)


def _sweep():
    """Other learning rates, regs and tols are operands: one signature, and
    each fit equals its own eager fit and the JAX fit."""
    cols = _dense_table(seed=5, n=333)  # a signature no other case makes
    table, jax_table = Table(cols), JaxTable(cols)

    def configured(est, lr, reg, tol):
        return est.set_max_iter(5).set_global_batch_size(64).set_learning_rate(lr) \
            .set_reg(reg).set_elastic_net(0.5).set_tol(tol)

    out = []
    LogisticRegression().set_max_iter(5).set_global_batch_size(64).fit(table)
    traces = metrics.get_counter("jit.traces")
    for lr, reg, tol in SWEEP:
        est = configured(LogisticRegression(), lr, reg, tol)
        got = est.fit(table).coefficient
        with config.whole_fit_mode("off"):
            want = est.fit(table).coefficient
        ref = configured(jax_lr.LogisticRegression(), lr, reg, tol).fit(jax_table).coefficient
        out.append((got, want, np.asarray(ref), COEFF_TOL))
    assert metrics.get_counter("jit.traces") == traces
    LogisticRegression().set_max_iter(6).set_global_batch_size(64).fit(table)
    assert metrics.get_counter("jit.traces") == traces + 1  # maxIter is static
    return out


def _fleet(kind):
    """A two-member fleet through the funnel, eagerly and in the JAX
    package (each member its own maxIter)."""
    rng = np.random.default_rng(13)
    if kind == "kmeans":
        cols = {"features": rng.standard_normal((120, 4))}
        members = [(module.KMeans().set_k(3).set_seed(s).set_max_iter(m)
                    for s, m in ((1, 4), (2, 7))) for module in (port_kmeans, jax_kmeans)]
    else:
        if kind == "dense":
            feats, jax_feats = (rng.standard_normal((150, 4)),) * 2
        else:
            idx, vals, _ = _sparse_rows(14, 150, 30, 3)
            feats, jax_feats = SparseBatch(30, idx, vals), JaxSparseBatch(30, idx, vals)
        label = (rng.random(150) > 0.5).astype(np.float64)
        cols = {"features": feats, "label": label}
        jax_cols = {"features": jax_feats, "label": label}
        members = [(module.LogisticRegression().set_max_iter(m).set_global_batch_size(50)
                    .set_learning_rate(lr).set_reg(0.01) for m, lr in ((4, 0.1), (6, 0.5)))
                   for module in (port_lr, jax_lr)]
    port_members, jax_members = (list(m) for m in members)
    funnel, eager = _both(lambda: FitFleet(port_members).fit(Table(cols)))
    refs = jax_fleet.FitFleet(jax_members).fit(JaxTable(cols if kind == "kmeans" else jax_cols))
    if kind == "kmeans":
        return [pair for a, b, r in zip(funnel, eager, refs) for pair in (
            (a.centroids, b.centroids, np.asarray(r.centroids), CENTROID_TOL),
            (a.weights, b.weights, np.asarray(r.weights), dict(rtol=0, atol=0)))]
    return [(a.coefficient, b.coefficient, np.asarray(r.coefficient), COEFF_TOL)
            for a, b, r in zip(funnel, eager, refs)]


def _kmeans():
    cols = {"features": np.random.default_rng(17).standard_normal((200, 3))}

    def configured(est):
        return est.set_k(4).set_seed(3).set_max_iter(6)

    a, b = _both(lambda: configured(KMeans()).fit(Table(cols)))
    r = configured(jax_kmeans.KMeans()).fit(JaxTable(cols))
    return [(a.centroids, b.centroids, np.asarray(r.centroids), CENTROID_TOL),
            (a.weights, b.weights, np.asarray(r.weights), dict(rtol=0, atol=0))]


FUNNEL_FITS = {
    # (sparse, n, batch, maxIter, lr, reg, en[, weighted])
    "dense": lambda: _sgd(False, 300, 64, 6, 0.1, 0.0, 0.0),
    "dense weighted": lambda: _sgd(False, 300, 64, 6, 0.2, 0.1, 0.5, weighted=True),
    "dense padded": lambda: _sgd(False, 250, 100, 12, 0.5, 0.05, 1.0),  # epochs > batches
    "dense touched rows": lambda: _sgd(False, 1000, 50, 4, 0.3, 0.0, 0.0),  # 4 of 20 batches
    "sparse 3": lambda: _sgd(True, 200, 64, 3, 0.4, 0.01, 0.5),
    "sparse 9": lambda: _sgd(True, 200, 64, 9, 0.4, 0.01, 0.5),
    "sweep": _sweep,
    "fleet dense": lambda: _fleet("dense"),
    "fleet sparse": lambda: _fleet("sparse"),
    "fleet kmeans": lambda: _fleet("kmeans"),
    "kmeans": _kmeans,
}


@pytest.mark.parametrize("name", list(FUNNEL_FITS))
def test_funnel_fit_equals_eager_and_jax(both_on_one_device, name):
    """Each fit through the funnel equals the eager fit bit for bit and the
    JAX package's fit at the parity tolerances."""
    for funnel, eager, ref, tol in FUNNEL_FITS[name]():
        assert np.asarray(funnel).tobytes() == np.asarray(eager).tobytes()
        np.testing.assert_allclose(funnel, ref, **tol)


# ---------------------------------------------------------------------------
# staging, the touched rows, eviction
# ---------------------------------------------------------------------------

STAGE_CASES = [
    # (rows, batch, sparse, host, float64)
    (100, 32, False, True, True),
    (96, 32, False, False, False),
    (100, 32, False, False, True),
    (70, 16, True, True, False),
    (64, 16, True, False, False),
]


def _padded(a, rows, dtype, fill):
    out = np.full((rows,) + a.shape[1:], fill, dtype=dtype)
    out[:a.shape[0]] = a[:rows]
    return out


@pytest.mark.parametrize("case", STAGE_CASES)
@pytest.mark.parametrize("cut", [None, 2])
def test_stage_flat_pads_casts_and_cuts(case, cut):
    """stage_flat's operands, made, are the inputs cast, padded to whole
    batches (sparse padding at index -1) and cut to the touched rows (y
    stays whole); an input that needs no copy comes back as itself."""
    n, batch, sparse, host, f64 = case
    rng = np.random.default_rng(n)
    if sparse:
        X = (rng.integers(-1, 9, (n, 3)).astype(np.int32), rng.random((n, 3)))
    else:
        X = rng.standard_normal((n, 4))
    X = X if f64 else (tuple(a.astype(np.float32) if a.dtype == np.float64 else a for a in X)
                       if sparse else X.astype(np.float32))
    X_np = X
    if not host:
        X = tuple(torch.from_numpy(a) for a in X) if sparse else torch.from_numpy(X)
    y, w = rng.random(n), rng.random(n)
    rows = None if cut is None else (lambda nb: optimizer._touched_rows(nb, batch, cut))
    with config.use_device("cpu"):
        X_f, y_f, w_f, n_true = optimizer.stage_flat(X, y, w, batch, rows=rows)
    n_pad = -(-n // batch) * batch
    keep = n_pad if cut is None else min(n_pad, cut * batch)
    if sparse:
        want = [_padded(X_np[0], keep, np.int32, -1), _padded(X_np[1], keep, np.float32, 0)]
        got, given = list(X_f), list(X)
    else:
        want, got, given = [_padded(X_np, keep, np.float32, 0)], [X_f], [X]
    want.append(_padded(w, keep, np.float32, 0))
    got.append(w_f)
    for a, b in zip(got, want):
        made = lazyjit.materialize(a)
        assert made.is_contiguous() and made.numpy().tobytes() == b.tobytes()
    assert lazyjit.materialize(y_f).numpy().tobytes() == _padded(y, n_pad, np.float32, 0).tobytes()
    assert n_true == n
    for a, b in zip(got, given):
        if isinstance(b, torch.Tensor) and n == n_pad:  # fed as it is: the funnel borrows it
            assert isinstance(a, torch.Tensor) and a.data_ptr() == b.data_ptr()
        else:
            assert isinstance(a, lazyjit.Feed)


def test_feed_writes_into_a_static_buffer():
    src = np.arange(10, dtype=np.float64).reshape(5, 2)
    feed = lazyjit.Feed(src, (8, 2), torch.float32, "cpu", fill=-1)
    buf = torch.empty(feed.shape)
    feed.write_to(buf)
    assert buf.numpy().tobytes() == feed.materialize().numpy().tobytes()
    np.testing.assert_array_equal(buf.numpy()[5:], -1)
    assert feed.nbytes == 64 and feed.stride() == (2, 1)


def test_make_room_evicts_the_oldest_graph_of_any_cache():
    """Eviction by bytes runs over every cache's graphs, least recently
    used first (a kept fit graph gives way to a later capture)."""
    a, b = lazyjit.GraphCache(), lazyjit.GraphCache()
    entries = {}
    for cache, sig in ((a, "a1"), (b, "b1"), (a, "a2")):
        entries[sig] = lazyjit.Captured(None, {})
        entries[sig].kept_bytes = 100
        cache.put(sig, entries[sig])
    a.get("a1").replay()  # a1 is now the most recently used
    evictions = metrics.get_counter("jit.kernelCacheEvict")
    b.make_room(free_bytes=250, incoming=50)
    assert list(a.entries) == ["a2", "a1"] and not b.entries
    a.make_room(free_bytes=150, incoming=50)
    assert list(a.entries) == ["a1"]
    assert metrics.get_counter("jit.kernelCacheEvict") - evictions == 2
    a.make_room(free_bytes=None)  # the CPU: count only
    assert list(a.entries) == ["a1"]


def test_signatures_hold_shapes_strides_and_statics():
    kernel = PORT_AFFINE.kernel
    t = torch.zeros(4, 6)
    sigs = set()
    for args in ((t, 1.0), (t.T, 1.0), (t, 2.0), (torch.zeros(4, 6, dtype=torch.float64), 1.0)):
        leaves, structure, statics, _ = kernel.split(args, {})
        sigs.add(kernel.signature(leaves, structure, statics))
    assert len(sigs) == 4
    leaves, structure, statics, _ = kernel.split((types.SimpleNamespace(),), {"scale": 1.0})
    assert leaves == []


def test_split_marks_the_borrowed_arguments_leaves():
    """`borrow` names the arguments whose tensors a graph reads in place:
    `split` marks their leaves, nested ones too, in flatten's order."""
    def body(x, data, scale, extra):
        return x

    kernel = lazyjit.lazy_jit(body, static_argnames=("scale",), borrow=("data",)).kernel
    a, b, c, d = (torch.zeros(i + 1) for i in range(4))
    leaves, _, statics, lendable = kernel.split((a, (b, {"k": c}), 2.0), {"extra": d})
    assert statics == {"scale": 2.0}
    assert [leaf.shape[0] for leaf in leaves] == [2, 3, 4, 1]  # data, extra, x
    assert lendable == [True, True, False, False]
