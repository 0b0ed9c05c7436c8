"""flink_ml_tpu_torch/ops/sparsekernels.py against the JAX package.

The plain PyTorch versions (the CPU route of each wrapper) are held against
the JAX Pallas kernels, run in interpret mode on the CPU as the JAX tests
run them, and against the lax path of the default fit (`losses.sparse_dot`
and the `mode="drop"` scatter). Inputs are made with seeded numpy and
include -1 padding and indices >= d, also at the edges of the kernels'
layout: rows of one pass of the row dot and one slot more, a wide row and
a batch sliced at an odd row offset. The CUDA kernels themselves run only
on the card (chip_smoke.py holds them against the plain versions there);
the launch plan that cuts a batch for them is pure Python and is checked
here: threads per block and blocks within the launch limits, every row and
slot covered once.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flink_ml_tpu.ops import losses as jax_losses
from flink_ml_tpu.ops import sparsekernels as jax_kernels
from flink_ml_tpu_torch.ops import sparsekernels

# float32 sums of up to nnz terms taken in another order
ATOL = RTOL = 1e-5


def _batch(seed, rows, nnz, d, out_of_range=True):
    rng = np.random.default_rng(seed)
    indices = rng.integers(0, d, size=(rows, nnz)).astype(np.int32)
    indices[rng.random((rows, nnz)) < 0.2] = -1
    if out_of_range:
        oor = rng.random((rows, nnz)) < 0.05
        indices[oor] = d + rng.integers(0, 7, size=int(oor.sum()))
    values = rng.standard_normal((rows, nnz)).astype(np.float32)
    coeff = rng.standard_normal(d).astype(np.float32)
    mult = rng.standard_normal(rows).astype(np.float32)
    return indices, values, coeff, mult


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _lax_grad(indices, values, mult, d):
    valid = indices >= 0
    safe = jnp.where(valid, indices, 0)
    vals = jnp.where(valid, values, 0.0)
    return jnp.zeros((d,), jnp.float32).at[safe].add(vals * mult[:, None], mode="drop")


# the last three: one full pass of the row dot (64 slots), one slot more, one slot
SHAPES = [(7, 64, 5, 24), (11, 200, 39, 64), (13, 1, 3, 4), (17, 33, 40, 50),
          (19, 20, 64, 100), (37, 20, 65, 100), (41, 30, 1, 7)]


@pytest.mark.parametrize("seed,rows,nnz,d", SHAPES)
def test_row_dots_plain_matches_pallas_and_lax(seed, rows, nnz, d):
    indices, values, coeff, _ = _batch(seed, rows, nnz, d)
    got = sparsekernels.sparse_row_dots_plain(*_t(indices, values, coeff)).numpy()
    pallas = np.asarray(
        jax_kernels.sparse_row_dots(jnp.asarray(indices), jnp.asarray(values), jnp.asarray(coeff))
    )
    lax, _, _ = jax_losses.sparse_dot(
        jnp.asarray(indices), jnp.asarray(values), jnp.asarray(coeff)
    )
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(lax), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed,rows,nnz,d", SHAPES)
def test_grad_plain_matches_pallas_and_lax(seed, rows, nnz, d):
    indices, values, _, mult = _batch(seed, rows, nnz, d)
    coeff = np.zeros(d, np.float32)
    got = sparsekernels.sparse_grad_plain(*_t(indices, values, mult, coeff)).numpy()
    pallas = np.asarray(
        jax_kernels.sparse_grad(
            jnp.asarray(indices), jnp.asarray(values), jnp.asarray(mult), jnp.asarray(coeff)
        )
    )
    lax = np.asarray(_lax_grad(jnp.asarray(indices), jnp.asarray(values), jnp.asarray(mult), d))
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, lax, rtol=RTOL, atol=ATOL)


def test_index_asymmetry_clamp_in_dot_drop_in_grad():
    """An index >= d reads coeff[d-1] in the dot but is dropped from the
    gradient: the JAX package's convention, kept by the port."""
    indices = np.array([[0, 5, -1], [7, 1, 2]], np.int32)
    values = np.ones((2, 3), np.float32)
    coeff = np.array([1.0, 10.0, 100.0, 1000.0], np.float32)
    mult = np.ones(2, np.float32)
    expected_dot = np.array([1001.0, 1110.0], np.float32)
    expected_grad = np.array([1.0, 1.0, 1.0, 0.0], np.float32)

    ti, tv, tc, tm = _t(indices, values, coeff, mult)
    np.testing.assert_array_equal(sparsekernels.sparse_row_dots(ti, tv, tc).numpy(), expected_dot)
    np.testing.assert_array_equal(sparsekernels.sparse_grad(ti, tv, tm, tc).numpy(), expected_grad)

    ji, jv, jc, jm = (jnp.asarray(a) for a in (indices, values, coeff, mult))
    np.testing.assert_array_equal(np.asarray(jax_kernels.sparse_row_dots(ji, jv, jc)), expected_dot)
    np.testing.assert_array_equal(np.asarray(jax_losses.sparse_dot(ji, jv, jc)[0]), expected_dot)
    np.testing.assert_array_equal(np.asarray(jax_kernels.sparse_grad(ji, jv, jm, jc)), expected_grad)


def test_cpu_tensors_take_the_plain_route_without_counting():
    indices, values, coeff, mult = _t(*_batch(3, 50, 6, 16))
    sparsekernels.reset_launch_counts()
    torch.testing.assert_close(
        sparsekernels.sparse_row_dots(indices, values, coeff),
        sparsekernels.sparse_row_dots_plain(indices, values, coeff),
        rtol=0, atol=0,
    )
    torch.testing.assert_close(
        sparsekernels.sparse_grad(indices, values, mult, coeff),
        sparsekernels.sparse_grad_plain(indices, values, mult, coeff),
        rtol=0, atol=0,
    )
    assert sparsekernels.launch_counts() == {"sparse_row_dots": 0, "sparse_grad": 0,
                                             "fleet_row_dots": 0, "fleet_grad": 0}


@pytest.mark.parametrize(
    "bad",
    ["int64_indices", "float64_values", "shape_mismatch", "short_multiplier", "non_contiguous"],
)
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    indices, values, coeff, mult = _t(*_batch(5, 20, 4, 8))
    if bad == "int64_indices":
        indices = indices.long()
    elif bad == "float64_values":
        values = values.double()
    elif bad == "shape_mismatch":
        values = values[:, :3].contiguous()
    elif bad == "short_multiplier":
        mult = mult[:-1]
    else:
        indices = indices.T.contiguous().T
    with pytest.raises((TypeError, ValueError)):
        if bad == "short_multiplier":
            sparsekernels.sparse_grad(indices, values, mult, coeff)
        else:
            sparsekernels.sparse_row_dots(indices, values, coeff)
            sparsekernels.sparse_grad(indices, values, mult, coeff)


# -- the launch plan: a pure function of the batch's shape ---------------

# gridDim.x's limit
MAX_GRID = 2**31 - 1


@pytest.mark.parametrize("grad", [False, True], ids=["row_dots", "grad"])
def test_launch_plan_stays_within_the_launch_limits(grad):
    for nnz in range(0, 10_001):
        plan = sparsekernels._launch_plan(100_000, nnz, grad)
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024, (nnz, plan)
        assert 0 <= plan.grid <= MAX_GRID
    assert sparsekernels._launch_plan(2**31, 39, grad).grid <= MAX_GRID


@pytest.mark.parametrize(
    "rows,nnz",
    [(1, 3), (7, 39), (8, 39), (9, 40), (1000, 39), (100_000, 39), (5_000, 1), (37, 5000),
     (16, 5000)],
)
def test_tiles_cover_every_row_exactly_once(rows, nnz):
    # the row dot: a warp per row, block b takes rows [b * per, (b + 1) * per)
    # the gradient: a thread per slot, block b takes slots [b * per, (b + 1) * per)
    for grad, items in ((False, rows), (True, rows * nnz)):
        plan = sparsekernels._launch_plan(rows, nnz, grad)
        per = plan.threads if grad else plan.threads // 32
        counts = np.zeros(plan.grid * per, np.int64)
        for b in range(plan.grid):
            counts[b * per:(b + 1) * per] += 1
        np.testing.assert_array_equal(counts[:items], 1)
        assert (plan.grid - 1) * per < items, "a block with nothing to do"


def test_a_fit_batch_at_an_odd_row_offset_is_not_aligned():
    """The fit slices batches as rows [start, start + batch); with an odd
    nnz and a batch size that is not a multiple of 4 the slice's base is
    not 16-byte aligned (chip_smoke.py holds the kernels on such a slice).
    The slice stays contiguous, so the wrappers take it as it is."""
    indices, values, coeff, mult = _t(*_batch(23, 103, 39, 50))
    sliced_i, sliced_v = indices[3:], values[3:]
    assert sliced_i.is_contiguous() and sliced_i.data_ptr() % 16 != 0
    torch.testing.assert_close(sparsekernels.sparse_row_dots(sliced_i, sliced_v, coeff),
                               sparsekernels.sparse_row_dots(indices, values, coeff)[3:])
    torch.testing.assert_close(
        sparsekernels.sparse_grad(sliced_i, sliced_v, mult[3:], coeff),
        sparsekernels.sparse_grad_plain(sliced_i.clone(), sliced_v.clone(), mult[3:], coeff))


# -- the plain versions against JAX at more edges ------------------------

def _edge_batch(case):
    if case == "wide_row":
        return _batch(29, 3, 600, 512)
    # a batch sliced at an odd row offset of a larger one
    indices, values, coeff, mult = _batch(31, 43, 39, 64)
    return indices[3:], values[3:], coeff, mult[3:]


@pytest.mark.parametrize("case", ["wide_row", "odd_offset_slice"])
def test_row_dots_plain_matches_pallas_and_lax_at_new_edges(case):
    indices, values, coeff, _ = _edge_batch(case)
    got = sparsekernels.sparse_row_dots_plain(*_t(indices, values, coeff)).numpy()
    ji, jv, jc = (jnp.asarray(np.ascontiguousarray(a)) for a in (indices, values, coeff))
    np.testing.assert_allclose(got, np.asarray(jax_kernels.sparse_row_dots(ji, jv, jc)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(jax_losses.sparse_dot(ji, jv, jc)[0]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["wide_row", "odd_offset_slice"])
def test_grad_plain_matches_pallas_and_lax_at_new_edges(case):
    indices, values, coeff, mult = _edge_batch(case)
    zeros = np.zeros_like(coeff)
    got = sparsekernels.sparse_grad_plain(*_t(indices, values, mult, zeros)).numpy()
    ji, jv, jm, jz = (jnp.asarray(np.ascontiguousarray(a)) for a in (indices, values, mult, zeros))
    np.testing.assert_allclose(got, np.asarray(jax_kernels.sparse_grad(ji, jv, jm, jz)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(_lax_grad(ji, jv, jm, coeff.shape[0])),
                               rtol=RTOL, atol=ATOL)


def test_quarter_grid_values_make_every_order_of_gradient_sums_exact():
    """chip_smoke.py holds the gradient on skewed indices to exact equality:
    with values and multipliers on a grid of quarters, each product is a
    multiple of 1/16 and every partial sum is exact in float32, so the
    order of the additions cannot change the result."""
    rng = np.random.default_rng(7)
    rows, nnz, d = 4000, 39, 50
    weights = np.arange(1, d + 1, dtype=np.float64) ** -1.1
    indices = rng.choice(d, size=(rows, nnz), p=weights / weights.sum()).astype(np.int32)
    values = (rng.integers(0, 5, size=(rows, nnz)) / 4).astype(np.float32)
    mult = (rng.integers(-4, 5, size=rows) / 4).astype(np.float32)
    zeros = np.zeros(d, np.float32)
    want = sparsekernels.sparse_grad_plain(*_t(indices, values, mult, zeros)).numpy()
    exact = np.zeros(d)
    np.add.at(exact, indices.reshape(-1), (values * mult[:, None]).astype(np.float64).reshape(-1))
    np.testing.assert_array_equal(want, exact)
    order = rng.permutation(rows * nnz)
    shuffled = np.zeros(d, np.float32)
    np.add.at(shuffled, indices.reshape(-1)[order], (values * mult[:, None]).reshape(-1)[order])
    np.testing.assert_array_equal(shuffled, want)


# -- the member-batched (fleet) forms ------------------------------------

# (seed, rows, nnz, d, members): one member, a tile of 8 and one more, an
# empty batch, an empty row width
FLEET_SHAPES = [(43, 50, 6, 16, 1), (47, 64, 39, 100, 8), (53, 33, 40, 50, 9),
                (59, 0, 5, 10, 3), (61, 7, 0, 10, 2)]


def _fleet_batch(seed, rows, nnz, d, members):
    indices, values, _, _ = _batch(seed, rows, nnz, d)
    rng = np.random.default_rng(seed + 1)
    coeff = rng.standard_normal((members, d)).astype(np.float32)
    mult = rng.standard_normal((members, rows)).astype(np.float32)
    return indices, values, coeff, mult


@pytest.mark.parametrize("seed,rows,nnz,d,members", FLEET_SHAPES)
def test_fleet_plain_versions_are_n_solo_plain_calls(seed, rows, nnz, d, members):
    """Row m of each fleet form equals the solo plain version on member m,
    bit for bit: the same masking (padding, the clamp in the dot, the drop
    in the gradient) and the same order of each member's additions."""
    ti, tv, tc, tm = _t(*_fleet_batch(seed, rows, nnz, d, members))
    dots = sparsekernels.fleet_row_dots_plain(ti, tv, tc)
    grad = sparsekernels.fleet_grad_plain(ti, tv, tm, tc)
    assert dots.shape == (members, rows) and grad.shape == (members, d)
    for m in range(members):
        torch.testing.assert_close(dots[m], sparsekernels.sparse_row_dots_plain(ti, tv, tc[m]),
                                   rtol=0, atol=0)
        torch.testing.assert_close(grad[m], sparsekernels.sparse_grad_plain(ti, tv, tm[m], tc[m]),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("seed,rows,nnz,d,members", FLEET_SHAPES[:3])
def test_fleet_plain_versions_match_pallas_under_vmap(seed, rows, nnz, d, members):
    """The JAX package reaches the Pallas kernels through jax.vmap over the
    member axis (coeff and multiplier batched, the batch not)."""
    indices, values, coeff, mult = _fleet_batch(seed, rows, nnz, d, members)
    ji, jv, jc, jm = (jnp.asarray(a) for a in (indices, values, coeff, mult))
    want_dots = jax.vmap(jax_kernels.sparse_row_dots, in_axes=(None, None, 0))(ji, jv, jc)
    want_grad = jax.vmap(jax_kernels.sparse_grad, in_axes=(None, None, 0, 0))(ji, jv, jm, jc)
    ti, tv, tc, tm = _t(indices, values, coeff, mult)
    np.testing.assert_allclose(sparsekernels.fleet_row_dots_plain(ti, tv, tc).numpy(),
                               np.asarray(want_dots), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sparsekernels.fleet_grad_plain(ti, tv, tm, tc).numpy(),
                               np.asarray(want_grad), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", ["member-major", "member-minor"])
def test_fleet_wrappers_take_both_layouts_on_the_cpu_without_counting(layout):
    indices, values, coeff, mult = _t(*_fleet_batch(67, 40, 7, 30, 4))
    if layout == "member-minor":
        coeff = coeff.T.contiguous().T
        assert not coeff.is_contiguous()
    sparsekernels.reset_launch_counts()
    dots = sparsekernels.fleet_row_dots(indices, values, coeff)
    grad = sparsekernels.fleet_grad(indices, values, mult, coeff)
    assert grad.is_contiguous() == coeff.is_contiguous()  # the gradient keeps coeff's layout
    torch.testing.assert_close(dots, sparsekernels.fleet_row_dots_plain(indices, values, coeff),
                               rtol=0, atol=0)
    torch.testing.assert_close(grad, sparsekernels.fleet_grad_plain(indices, values, mult, coeff),
                               rtol=0, atol=0)
    assert set(sparsekernels.launch_counts().values()) == {0}


def test_fleet_index_asymmetry_clamp_in_dot_drop_in_grad():
    indices = torch.tensor([[0, 5, -1], [7, 1, 2]], dtype=torch.int32)
    values = torch.ones((2, 3))
    coeff = torch.tensor([[1.0, 10.0, 100.0, 1000.0], [2.0, 20.0, 200.0, 2000.0]])
    mult = torch.tensor([[1.0, 1.0], [1.0, 2.0]])
    torch.testing.assert_close(sparsekernels.fleet_row_dots(indices, values, coeff),
                               torch.tensor([[1001.0, 1110.0], [2002.0, 2220.0]]), rtol=0, atol=0)
    torch.testing.assert_close(sparsekernels.fleet_grad(indices, values, mult, coeff),
                               torch.tensor([[1.0, 1.0, 1.0, 0.0], [1.0, 2.0, 2.0, 0.0]]),
                               rtol=0, atol=0)


@pytest.mark.parametrize(
    "bad",
    ["int64_indices", "float64_coeff", "vector_coeff", "no_members", "strided_coeff",
     "multiplier_shape", "multiplier_strided", "multiplier_float64"],
)
def test_fleet_wrappers_reject_what_the_kernels_do_not_take(bad):
    indices, values, coeff, mult = _t(*_fleet_batch(71, 20, 4, 8, 3))
    if bad == "int64_indices":
        indices = indices.long()
    elif bad == "float64_coeff":
        coeff = coeff.double()
    elif bad == "vector_coeff":
        coeff = coeff[0]
    elif bad == "no_members":
        coeff = coeff[:0]
    elif bad == "strided_coeff":
        coeff = coeff[:, ::2]
    elif bad == "multiplier_shape":
        mult = mult[:2]
    elif bad == "multiplier_strided":
        mult = mult.T.contiguous().T
    else:
        mult = mult.double()
    with pytest.raises((TypeError, ValueError)):
        if bad.startswith("multiplier"):
            sparsekernels.fleet_grad(indices, values, mult, coeff)
        else:
            sparsekernels.fleet_row_dots(indices, values, coeff)
