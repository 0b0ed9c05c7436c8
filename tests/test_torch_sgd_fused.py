"""The SGD engine's epoch kernels (ops/sgdkernels.py, csrc/sgd_epoch.cu)
and the single-card body that runs them (ops/optimizer.py `_masked_epoch`,
ops/losses.py `_layout`).

On the CPU: the plain versions against the op sequences they replace,
bit for bit (the update, the multiplier, the tail) and the sums to
rounding, over each pointwise form, elasticNet {0, 0.5, 1}, reg {0, 1e-3},
a weight sum of 0, live and dead epochs and the `row < n` weights of a
ragged last batch; whole fits through the body against the op sequence's
epochs, a tol-stopped fit's state unchanged after its stop; the kernels'
plans and constants.

On the card (marked `card`; each test skips without one, and the file
imports no JAX): each kernel against its plain version, one launch of each
an epoch counted at replay, a captured whole fit against its eager run,
and a fit against the op sequence's within the benchmark cells' limits.
From the repository's root, on a machine with the card:

    python -m pytest --noconftest tests/test_torch_sgd_fused.py -m card
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from flink_ml_tpu_torch import config
from flink_ml_tpu_torch.ops import losses, optimizer, sgdkernels, sparsekernels

FORMS = {"logistic": losses._logistic_pointwise, "hinge": losses._hinge_pointwise,
         "least_square": losses._least_square_pointwise}
LOSS_OF = {"logistic": "binary_logistic", "hinge": "hinge", "least_square": "least_square"}
SOURCE = Path(sgdkernels.__file__).resolve().parent.parent / "csrc" / "sgd_epoch.cu"
#: the benchmark cells' coefficient-gap limits (portbench/limits/)
COEFF_GAP = {"sparse": 4e-5, "dense": 8e-5}


@pytest.fixture
def need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device here: the test runs on the card")
    return torch.device("cuda", 0)


# -- the op sequences the kernels replace ---------------------------------


def old_update(coeff, grad, wsum, hyper):
    """`_update_model` as the op sequence it was."""
    updated = coeff - (torch.reciprocal(torch.clamp(wsum, min=1e-30)) * hyper[0]) * grad
    step = hyper[0] * (hyper[4] * torch.sign(updated) + hyper[5] * updated)
    updated = torch.where(hyper[1] > 0.0, updated - step, updated)
    return torch.where(wsum > 0, updated, coeff)


def old_loss(pointwise, layout):
    """The dense or sparse batched loss as the op sequence it was."""
    def fn(X, y, w, coeff):
        if layout == "dense":
            loss, mult = pointwise(losses.dense_dot(X, coeff), y, w)
            return torch.sum(loss), losses.dense_grad(X, mult), torch.sum(w)
        loss, mult = pointwise(sparsekernels.sparse_row_dots_plain(*X, coeff), y, w)
        return torch.sum(loss), sparsekernels.sparse_grad_plain(*X, mult, coeff), torch.sum(w)
    return fn


def old_masked_epoch(Xk, yk, wk, state, loss_fn, hyper):
    live = state[4] > hyper[3]
    coeff, grad, wsum, epoch = state[:4]
    coeff = old_update(coeff, grad, wsum, hyper)
    lsum, grad, wsum = loss_fn(Xk, yk, wk, coeff)
    criteria = (lsum / torch.clamp(wsum, min=1e-30)).to(torch.float32)
    new = (coeff, grad, wsum, epoch + 1, criteria)
    return tuple(torch.where(live, a, b) for a, b in zip(new, state))


def old_epochs(X, y, w, state, loss_fn, batch, n, max_iter, hyper):
    num_batches = y.shape[0] // batch
    for e in range(max_iter):
        begin = (e % num_batches) * batch
        Xk = optimizer._slice_rows(X, begin, batch)
        if w is not None:
            wk = w[begin:begin + batch]
        else:
            wk = (torch.arange(begin, begin + batch, device=y.device) < n).to(state[0].dtype)
        state = old_masked_epoch(Xk, y[begin:begin + batch], wk, state, loss_fn, hyper)
    return state


def ordered_sum(x):
    """The pointwise kernel's sum in its order: a thread adds its rows in
    turn, a block its threads by shuffle trees (lanes, then warps), and
    the last block the blocks' partials by the same trees."""
    threads = sgdkernels.POINT_THREADS
    grid, passes = sgdkernels._point_plan(x.shape[0])
    padded = x.new_zeros(passes * grid * threads)
    padded[:x.shape[0]] = x
    acc = x.new_zeros(grid, threads)
    for part in padded.view(passes, grid, threads):
        acc = acc + part
    last = x.new_zeros(1, threads)
    last[0, :grid] = _block_trees(acc)
    return _block_trees(last)[0]


def _block_trees(x):
    x = x.view(x.shape[0], -1, 32)
    for h in (16, 8, 4, 2, 1):
        x = x[..., :h] + x[..., h:2 * h]
    x = x[..., 0]
    h = x.shape[1] // 2
    while h:
        x = x[..., :h] + x[..., h:2 * h]
        h //= 2
    return x[..., 0]


# -- inputs ------------------------------------------------------------------


def _hyper(en, reg, tol=1e-6, lr=0.1, dtype=torch.float32, device="cpu"):
    return optimizer.sgd_hyper(lr, reg, en, tol, torch.device(device), dtype)


def _update_inputs(d, dtype, device, seed=0):
    g = np.random.default_rng(seed)
    coeff = g.standard_normal(d)
    coeff[:4] = [0.0, -0.0, 1e-4, -1e-4][:d]  # signs at and near zero
    grad = g.standard_normal(d)
    return (torch.as_tensor(coeff, dtype=dtype, device=device),
            torch.as_tensor(grad, dtype=dtype, device=device))


def _batch(form, rows, dtype, device, seed=1):
    g = np.random.default_rng(seed)
    dot = g.standard_normal(rows) * 3
    y = g.standard_normal(rows) if form == "least_square" else g.integers(0, 2, rows) * 1.0
    w = g.random(rows) + 0.5
    return tuple(torch.as_tensor(a, dtype=dtype, device=device) for a in (dot, y, w))


def _tail(wsum, criteria, dtype, device, hyper):
    return sgdkernels.EpochTail(hyper, torch.tensor(wsum, dtype=dtype, device=device),
                                torch.tensor(7, dtype=torch.int32, device=device),
                                torch.tensor(criteria, dtype=torch.float32, device=device))


def _fit_data(layout, form, rows, dim, seed=3, nnz=5):
    g = np.random.default_rng(seed)
    truth = g.standard_normal(dim)
    if layout == "dense":
        X = g.standard_normal((rows, dim))
        dots = X @ truth
        X = torch.as_tensor(X, dtype=torch.float32)
    else:
        idx = g.integers(0, dim, (rows, nnz)).astype(np.int32)
        idx[g.random((rows, nnz)) < 0.2] = -1
        vals = g.random((rows, nnz))
        dots = np.where(idx >= 0, vals * truth[np.clip(idx, 0, dim - 1)], 0).sum(1)
        X = (torch.as_tensor(idx), torch.as_tensor(vals, dtype=torch.float32))
    y = dots + 0.1 * g.standard_normal(rows) if form == "least_square" else (dots > 0) * 1.0
    return X, torch.as_tensor(y, dtype=torch.float32), torch.as_tensor(g.random(rows) + 0.5,
                                                                       dtype=torch.float32)


def _padded(X, y, w, batch):
    """The flat fit's layout: rows padded to whole batches (index -1, label
    and weight 0)."""
    n = y.shape[0]
    pad = -(-n // batch) * batch - n
    if isinstance(X, tuple):
        X = (torch.cat([X[0], torch.full((pad, X[0].shape[1]), -1, dtype=torch.int32)]),
             torch.cat([X[1], torch.zeros(pad, X[1].shape[1])]))
    else:
        X = torch.cat([X, torch.zeros(pad, X.shape[1])])
    return X, torch.cat([y, torch.zeros(pad)]), torch.cat([w, torch.zeros(pad)])


def _loss(layout, form):
    dense = losses.BY_NAME[LOSS_OF[form]]
    return dense if layout == "dense" else losses.SPARSE_VARIANTS[dense.name]


# -- on the CPU --------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("en", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("reg", [0.0, 1e-3])
@pytest.mark.parametrize("case", ["live", "dead", "wsum 0", "no mask"])
def test_update_plain_is_the_op_sequence(dtype, en, reg, case):
    """The plain update equals `_update_model`'s op sequence bit for bit,
    and with the body's criteria the masked select of it: a dead epoch
    keeps the coefficient."""
    hyper = _hyper(en, reg, dtype=dtype)
    coeff, grad = _update_inputs(257, dtype, "cpu")
    wsum = torch.tensor(0.0 if case == "wsum 0" else 37.25, dtype=dtype)
    criteria = None if case == "no mask" else torch.tensor(0.0 if case == "dead" else 0.5)
    got = sgdkernels.sgd_update_plain(coeff, grad, wsum, hyper, criteria)
    want = old_update(coeff, grad, wsum, hyper)
    if case == "dead":
        want = coeff
    assert torch.equal(got, want)
    assert torch.equal(optimizer._update_model(coeff, grad, wsum, hyper, criteria), want)
    assert got.dtype == dtype


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("weights", ["given", "ragged"])
@pytest.mark.parametrize("tail", ["none", "live", "dead"])
def test_pointwise_plain_is_the_op_sequence(form, weights, tail):
    """The plain pointwise pass: the multiplier of the form bit for bit,
    the loss and weight sums to rounding (`torch.sum`'s, and the kernel's
    order within float32 rounding), the weights `row < n` of a ragged last
    batch, and the epoch's tail under the mask as the body
    formed it."""
    rows, begin, n = 1000, 2000, 2613
    dot, y, w = _batch(form, rows, torch.float32, "cpu")
    if weights == "ragged":
        w = (torch.arange(begin, begin + rows) < n).to(torch.float32)
    hyper = _hyper(0.5, 1e-3)
    t = None if tail == "none" else _tail(11.5, 0.0 if tail == "dead" else 0.4, torch.float32,
                                          "cpu", hyper)
    out = sgdkernels.sgd_pointwise(form, FORMS[form], dot, y, w, t)
    loss, mult = FORMS[form](dot, y, w)
    assert torch.equal(out.mult, mult)
    torch.testing.assert_close(out.lsum, torch.sum(loss), rtol=1e-6, atol=0)
    torch.testing.assert_close(out.wsum, torch.sum(w), rtol=1e-6, atol=0)
    torch.testing.assert_close(ordered_sum(loss), torch.sum(loss), rtol=1e-5, atol=0)
    torch.testing.assert_close(ordered_sum(w), torch.sum(w), rtol=1e-5, atol=0)
    if weights == "ragged":
        assert float(out.wsum) == n - begin  # the ragged batch's real rows
    if t is None:
        assert out.tail is None
        return
    live = tail == "live"
    criteria = (out.lsum / torch.clamp(out.wsum, min=1e-30)).to(torch.float32)
    assert bool(out.tail.live) is live
    assert torch.equal(out.tail.wsum, out.wsum if live else t.wsum)
    assert int(out.tail.epoch) == (8 if live else 7)
    assert torch.equal(out.tail.criteria, criteria if live else t.criteria)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("weights", ["given", "row < n"])
@pytest.mark.parametrize("hp", [(0.0, 0.0), (0.5, 1e-3), (1.0, 1e-3)])
def test_fit_through_the_body_is_the_op_sequence(layout, form, weights, hp):
    """Whole fits through `_sgd_epochs` and `_finish` equal the op
    sequence's epochs bit for bit: each form and layout, elasticNet and
    reg, given weights and the `row < n` ones over a ragged last batch (n
    not a multiple of the batch)."""
    batch, max_iter, dim = 64, 9, 23
    X, y, w = _fit_data(layout, form, 203, dim)
    n = y.shape[0]
    X, y, w = _padded(X, y, w, batch)
    w = w if weights == "given" else None
    hyper = _hyper(*hp)
    loss = _loss(layout, form)
    init = torch.as_tensor(np.random.default_rng(5).standard_normal(dim) * 0.1,
                           dtype=torch.float32)
    got = optimizer._sgd_epochs(X, y, w, optimizer._init_state(init), loss, batch, n, 0,
                                max_iter, hyper)
    want = old_epochs(X, y, w, optimizer._init_state(init), old_loss(loss.pointwise, layout),
                      batch, n, max_iter, hyper)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(optimizer._finish(got, hyper),
                       optimizer._pack_train_result(old_update(*want[:3], hyper), want[4],
                                                    want[3]))


@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("form", list(FORMS))
def test_a_tol_stopped_fit_keeps_its_state(layout, form):
    """A fit whose criteria fall to tol stops there: its epoch count stays
    below maxIter, every later epoch leaves all five leaves of the state
    as they were, bit for bit, and the whole run equals the op sequence's."""
    batch, dim = 50, 17
    X, y, w = _fit_data(layout, form, 200, dim, seed=8)
    X, y, w = _padded(X, y, w, batch)
    loss = _loss(layout, form)
    init = optimizer._init_state(torch.zeros(dim))
    first = optimizer._sgd_epochs(X, y, w, init, loss, batch, 200, 0, 3, _hyper(0.0, 0.0))
    tol = float(first[4]) * 1.0001  # the third epoch's criteria stop the fit at the latest
    hyper = _hyper(0.0, 0.0, tol=tol)
    stopped = optimizer._sgd_epochs(X, y, w, init, loss, batch, 200, 0, 4, hyper)
    assert int(stopped[3]) <= 3 and float(stopped[4]) <= tol
    later = optimizer._sgd_epochs(X, y, w, stopped, loss, batch, 200, 4, 12, hyper)
    for a, b in zip(later, stopped):
        assert torch.equal(a, b)
    want = old_epochs(X, y, w, init, old_loss(loss.pointwise, layout), batch, 200, 12, hyper)
    for a, b in zip(later, want):
        assert torch.equal(a, b)


def test_a_loss_of_another_make_takes_the_selects():
    """A LossFunc without the epoch call (a custom one) gets the weights
    and its outputs selected in the body: the same fit bit for bit, with
    the `row < n` weights too."""
    batch, dim = 32, 9
    X, y, w = _fit_data("dense", "logistic", 100, dim)
    X, y, w = _padded(X, y, w, batch)
    hyper = _hyper(0.5, 1e-3)
    loss = losses.BINARY_LOGISTIC_LOSS
    custom = losses.LossFunc("mine", lambda *a: loss.fn(*a), loss.pointwise)
    assert losses.epoch_fn(custom) is None and losses.epoch_fn(loss) is not None
    for wk in (w, None):
        init = optimizer._init_state(torch.full((dim,), 0.01))
        got = optimizer._sgd_epochs(X, y, wk, init, custom, batch, 100, 0, 7, hyper)
        want = optimizer._sgd_epochs(X, y, wk, init, loss, batch, 100, 0, 7, hyper)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("weights", [True, False])
def test_every_epoch_of_a_fit_goes_through_the_epoch_step(weights, monkeypatch):
    """A fit's epochs each call `_epoch_step(Xk, yk, wk, state, loss_func,
    hyper)` with the batch's weights as a tensor, a fit without a weight
    column too: a step that keeps its state leaves the model at its init,
    and one that drops half the batch's weights changes the model."""
    X, y, w = _fit_data("sparse", "logistic", 300, 40)
    sgd = optimizer.SGD(6, 0.1, 64, 0.0, 0.0, 0.0)
    loss = losses.SPARSE_BINARY_LOGISTIC_LOSS
    fit = lambda: sgd.optimize(np.zeros(40), X, y, w if weights else None, loss)[0]  # noqa: E731
    trained = fit()
    step, seen = optimizer._epoch_step, []

    def half(Xk, yk, wk, state, loss_func, hyper):
        seen.append(wk.shape)
        wk = wk.clone()
        wk[1::2] = 0.0
        return step(Xk, yk, wk, state, loss_func, hyper)

    monkeypatch.setattr(optimizer, "_epoch_step", half)
    assert not np.array_equal(fit(), trained) and seen == [(64,)] * 6
    monkeypatch.setattr(optimizer, "_epoch_step",
                        lambda Xk, yk, wk, state, loss_func, hyper: (state, torch.ones(())))
    assert not fit().any()


@pytest.mark.parametrize("name", ["fleet", "2d"])
def test_the_fleet_and_2d_losses_keep_their_own_calls(name):
    """The fleet's and the 2D losses' shapes differ (a member axis,
    feature shards): they carry no epoch call."""
    other = (losses.fleet_loss(losses.BINARY_LOGISTIC_LOSS.name) if name == "fleet"
             else losses.feature_sharded_variant(losses.SPARSE_BINARY_LOGISTIC_LOSS))
    assert losses.epoch_fn(other) is None


@pytest.mark.parametrize("rows", [0, 1, 255, 256, 257, 65_536, 65_537, 100_000, 10_000_000])
def test_point_plan_covers_the_batch(rows):
    """The pointwise pass's plan: at most POINT_MAX_BLOCKS blocks (a partial
    a thread of the last block), passes that cover every row, no pass
    empty for every block."""
    grid, passes = sgdkernels._point_plan(rows)
    assert 1 <= grid <= sgdkernels.POINT_MAX_BLOCKS <= sgdkernels.POINT_THREADS
    assert grid * sgdkernels.POINT_THREADS * passes >= rows
    assert rows == 0 or grid * sgdkernels.POINT_THREADS * (passes - 1) < rows


@pytest.mark.parametrize("d,itemsize,ptrs,want", [
    (1_000_000, 4, (0, 512, 4096), (1, 977)), (100, 4, (0, 512, 1024), (1, 1)),
    (1_000_001, 8, (0, 512, 1024), (1, 1954)), (100, 4, (4, 512, 1024), (0, 1)),
    (10**9, 4, (0, 0, 0), (1, sgdkernels.UPDATE_MAX_BLOCKS)),
])
def test_update_plan(d, itemsize, ptrs, want):
    """16-byte packs only where coeff, grad and out are all 16-byte aligned;
    a thread a pack, at most UPDATE_MAX_BLOCKS blocks."""
    assert sgdkernels._update_plan(d, itemsize, *ptrs) == want


def test_ticket_slots_are_a_stream_each():
    assert sgdkernels._ticket_slot(11) == sgdkernels._ticket_slot(11)
    assert sgdkernels._ticket_slot(11) != sgdkernels._ticket_slot(12)
    assert 0 <= sgdkernels._ticket_slot(13) < sgdkernels.TICKET_SLOTS


@pytest.mark.parametrize("name,value", [
    ("kLr", optimizer.HYPER_LR), ("kReg", optimizer.HYPER_REG), ("kTol", optimizer.HYPER_TOL),
    ("kL1", optimizer.HYPER_L1), ("kL2", optimizer.HYPER_L2),
    ("kThreads", sgdkernels.POINT_THREADS), ("kSlots", sgdkernels.TICKET_SLOTS),
    *((f"k{''.join(p.title() for p in f.split('_'))}", i) for i, f in enumerate(sgdkernels.FORMS)),
])
def test_the_source_agrees_with_the_wrapper(name, value):
    """The kernel source's constants: the hyperparameter rows, the block,
    the ticket slots and the forms' order, as the wrapper passes them."""
    found = re.findall(rf"\b{name} = (\d+)", SOURCE.read_text())
    assert found == [str(value)]


# -- on the card -------------------------------------------------------------


def _ulps(a, b):
    def key(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((key(a) - key(b)).abs().max()) if a.numel() else 0


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("en", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("reg", [0.0, 1e-3])
@pytest.mark.parametrize("case", ["live", "dead", "wsum 0", "no mask"])
def test_update_kernel_is_its_plain_version(need_card, dtype, en, reg, case):
    """Bit for bit, in 16-byte packs with a ragged tail and, off 16-byte
    alignment, one coefficient a thread."""
    hyper = _hyper(en, reg, dtype=dtype, device=need_card)
    for d, offset in ((1, 0), (100, 0), (1_000_003, 0), (1_000_003, 1)):
        coeff, grad = (t[offset:] for t in _update_inputs(d + offset, dtype, need_card))
        wsum = torch.tensor(0.0 if case == "wsum 0" else 37.25, dtype=dtype, device=need_card)
        criteria = None if case == "no mask" else torch.tensor(
            0.0 if case == "dead" else 0.5, device=need_card)
        before = sgdkernels.sgd_update.launches
        got = sgdkernels.sgd_update(coeff, grad, wsum, hyper, criteria)
        assert sgdkernels.sgd_update.launches == before + 1
        assert torch.equal(got, sgdkernels.sgd_update_plain(coeff, grad, wsum, hyper, criteria))


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("weights", ["given", "ragged"])
@pytest.mark.parametrize("tail", ["none", "live", "dead"])
def test_pointwise_kernel_is_its_plain_version(need_card, dtype, form, weights, tail):
    """The multiplier within one ulp (exp and log1p compiled apart), exactly
    where the form has none; the sums exactly the kernel's order
    (`ordered_sum`) and to rounding torch.sum's; the tail as the plain
    version forms it from the kernel's sums."""
    hyper = _hyper(0.5, 1e-3, dtype=dtype, device=need_card)
    for rows in (1, 300, 100_000, 1_000_001):
        dot, y, w = _batch(form, rows, dtype, need_card)
        begin, n = 5 * rows, 5 * rows + rows // 3 + 1
        if weights == "ragged":
            w = (torch.arange(begin, begin + rows, device=need_card) < n).to(dtype)
        t = None if tail == "none" else _tail(11.5, 0.0 if tail == "dead" else 0.4, dtype,
                                              need_card, hyper)
        got = sgdkernels.sgd_pointwise(form, FORMS[form], dot, y, w, t)
        loss, mult = FORMS[form](dot, y, w)
        if form == "logistic" and dtype == torch.float32:
            assert _ulps(got.mult, mult) <= 1
        elif form == "logistic":
            torch.testing.assert_close(got.mult, mult, rtol=4e-16, atol=0)
        else:
            assert torch.equal(got.mult, mult)
        if form != "logistic":
            assert torch.equal(got.lsum, ordered_sum(loss))
        assert torch.equal(got.wsum, ordered_sum(w))
        eps = torch.finfo(dtype).eps
        torch.testing.assert_close(got.lsum, torch.sum(loss), rtol=64 * eps, atol=0)
        torch.testing.assert_close(got.wsum, torch.sum(w), rtol=64 * eps, atol=0)
        if t is not None:
            live = tail == "live"
            criteria = (got.lsum / torch.clamp(got.wsum, min=1e-30)).to(torch.float32)
            assert bool(got.tail.live) is live
            assert torch.equal(got.tail.wsum, got.wsum if live else t.wsum)
            assert int(got.tail.epoch) == (8 if live else 7)
            assert torch.equal(got.tail.criteria, criteria if live else t.criteria)


def _card_fit(layout, device, batch=1000, rows=20_000, dim=50_000, max_iter=12, w=False,
              reg=1e-3, en=0.5):
    """A LogisticRegression-shaped SGD fit on the card through
    `SGD.optimize`: its coefficient, criteria and epochs."""
    X, y, weights = _fit_data(layout, "logistic", rows, dim if layout == "sparse" else 40)
    X = tuple(t.to(device) for t in X) if isinstance(X, tuple) else X.to(device)
    sgd = optimizer.SGD(max_iter, 0.1, batch, 1e-9, reg, en)
    loss = _loss(layout, "logistic")
    init = np.zeros(dim if layout == "sparse" else 40)
    return sgd.optimize(init, X, y.to(device), weights.to(device) if w else None, loss)


@pytest.mark.card
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_one_launch_of_each_an_epoch_at_replay(need_card, layout):
    """A replayed whole fit counts one update and one pointwise launch an
    epoch (and the update after the loop), as the eager fit did."""
    counts = []
    for _ in range(3):  # eager and captured, then replays
        sgdkernels.reset_launch_counts()
        _card_fit(layout, need_card, max_iter=12)
        counts.append(sgdkernels.launch_counts())
    assert counts[-1] == counts[-2] == {"sgd_update": 13, "sgd_pointwise": 12}


@pytest.mark.card
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_a_captured_fit_equals_its_eager_run(need_card, layout):
    """The whole fit replayed as a graph against the same fit op by op
    (`config.whole_fit = "off"`): bit for bit dense; sparse within the
    gradient's atomics' rounding."""
    replayed = [_card_fit(layout, need_card, w=True) for _ in range(3)][-1]
    saved = config.whole_fit
    config.whole_fit = "off"
    try:
        eager = _card_fit(layout, need_card, w=True)
    finally:
        config.whole_fit = saved
    if layout == "dense":
        np.testing.assert_array_equal(replayed[0], eager[0])
        assert replayed[1:] == eager[1:]
    else:
        np.testing.assert_allclose(replayed[0], eager[0], rtol=1e-4, atol=1e-6)
        assert replayed[2] == eager[2]


@pytest.mark.card
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_a_fused_fit_is_within_the_cells_limits_of_the_ops_route(need_card, layout,
                                                                  monkeypatch):
    """A fit on the kernels against the same fit on the op sequences (the
    plain versions on the card), both op by op: the coefficient gap's norm
    over the ops route's within the benchmark cells' `coeff_gap` limits."""
    monkeypatch.setattr(config, "whole_fit", "off")
    fused = _card_fit(layout, need_card, max_iter=40)
    monkeypatch.setattr(sgdkernels, "sgd_update", sgdkernels.sgd_update_plain)
    monkeypatch.setattr(sgdkernels, "sgd_pointwise",
                        lambda form, fn, *args: sgdkernels.sgd_pointwise_plain(fn, *args))
    ops = _card_fit(layout, need_card, max_iter=40)
    gap = np.linalg.norm(fused[0] - ops[0]) / np.linalg.norm(ops[0])
    assert gap < COEFF_GAP[layout], gap
    assert fused[2] == ops[2]
