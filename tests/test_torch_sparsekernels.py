"""flink_ml_tpu_torch/ops/sparsekernels.py against the JAX package.

The plain PyTorch versions (the CPU route of each wrapper) are held against
the JAX Pallas kernels, run in interpret mode on the CPU as the JAX tests
run them, and against the lax path of the default fit (`losses.sparse_dot`
and the `mode="drop"` scatter). Inputs are made with seeded numpy and
include -1 padding and indices >= d, also at the edges of the kernels'
layout: rows of one pass of the row dot and one slot more, a wide row and
a batch sliced at an odd row offset. The CUDA kernels themselves run only
on the card (chip_smoke.py holds them against the plain versions there);
the launch plans that cut a batch for them are pure Python and are checked
here: threads per block and blocks within the launch limits, every row and
slot covered once; the gradient's persistent plan (chunks walked by each
block, its table, ring and shared memory) at several SM counts; the
reciprocal division and the running row of the gradient's chunks, in
numpy as the kernel computes them; and the fleet row dot's float4
predicate.
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


def test_grad_walk_counters_need_the_card():
    # the walk's counters are the CUDA kernel's; a CPU batch has no walk
    indices, values, coeff, mult = _t(*_batch(3, 50, 6, 16))
    with pytest.raises(ValueError, match="only in the CUDA kernel"):
        sparsekernels.sparse_grad_walk(indices, values, mult, coeff)
    assert sparsekernels.WALK_STATS == ("mid_walk_flushes", "overflows", "direct_chunks")


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


# -- the launch plans: pure functions of the batch's shape (and SM count)

# gridDim.x's limit
MAX_GRID = 2**31 - 1
# SM counts: the H100 SXM's, the H100 PCIe's, a smaller card's, one SM
SM_COUNTS = (132, 114, 78, 1)


# shared memory of an H100 SM, of one block, and what the card keeps back a block
SM_SHARED_BYTES, BLOCK_SHARED_BYTES, BLOCK_RESERVED_BYTES = 233_472, 232_448, 1024


def _grad_smem_bytes(plan):
    """The dynamic shared memory sparse_grad's entry lays out for a plan
    (csrc/sparse_kernels.cu `grad_smem_bytes`): keys and sums, two ring
    stages of idx and vals (chunk + 4 words each) and multipliers (row_cap
    + 4 words, whole 16 bytes), and 8 counters."""
    stage_words = 2 * (plan.chunk + 4) + -(-(plan.row_cap + 4) // 4) * 4
    return 4 * (2 * plan.table + 2 * stage_words + 8)


def _check_grad_plan(plan, rows, nnz, sms):
    """sparse_grad's plan against the limits of the card and the kernel."""
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024, plan
    assert 1 <= plan.grid <= min(MAX_GRID, sms * sparsekernels.TABLE_BLOCKS_PER_SM), plan
    assert plan.table & (plan.table - 1) == 0 and 32 <= plan.table <= 2**16, plan
    assert plan.chunk % 4 == 0 and 0 < plan.chunk <= 2**16, plan
    # a flush leaves room for one chunk of new columns: at most half full
    assert plan.flush_at + plan.chunk <= plan.table // 2, plan
    # the stage holds the multipliers of every row a chunk can span
    assert plan.row_cap >= (max(nnz, 1) - 1 + plan.chunk - 1) // max(nnz, 1) + 1, plan
    # within a block's 227 KB, and two blocks share an SM
    smem = _grad_smem_bytes(plan)
    assert smem <= BLOCK_SHARED_BYTES, plan
    blocks_per_sm = SM_SHARED_BYTES // (smem + BLOCK_RESERVED_BYTES)
    assert blocks_per_sm >= sparsekernels.TABLE_BLOCKS_PER_SM, plan


@pytest.mark.parametrize(
    "kind,sms",
    [pytest.param("row_dots", None, id="row_dots"), pytest.param("grad", None, id="grad")]
    + [pytest.param("table_grad", sms, id=f"table_grad-{sms}") for sms in SM_COUNTS],
)
def test_launch_plan_stays_within_the_launch_limits(kind, sms):
    if kind == "table_grad":
        for nnz in range(1, 10_001):
            _check_grad_plan(sparsekernels._grad_plan(100_000, nnz, sms), 100_000, nnz, sms)
        for rows, nnz in ((2**31, 39), (1, 1), (100_000, 2**20 + 1)):
            _check_grad_plan(sparsekernels._grad_plan(rows, nnz, sms), rows, nnz, sms)
        return
    grad = kind == "grad"
    for nnz in range(0, 10_001):
        plan = sparsekernels._launch_plan(100_000, nnz, grad)
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024, (nnz, plan)
        assert 0 <= plan.grid <= MAX_GRID
    assert sparsekernels._launch_plan(2**31, 39, grad).grid <= MAX_GRID


def _walks(plan, slots):
    """The chunks block b walks: b, b + grid, ... below the chunk count."""
    chunks = -(-slots // plan.chunk)
    return [list(range(b, chunks, plan.grid)) for b in range(plan.grid)], chunks


def _check_grad_walk(rows, nnz, sms):
    """The persistent blocks' chunks cover the slots once, every block
    walks at least one and they differ by at most one; a block's running
    row and remainder (advanced by grid * chunk slots a step, as the
    kernel advances them) give each chunk's first row and slot."""
    plan = sparsekernels._grad_plan(rows, nnz, sms)
    slots = rows * nnz
    walks, chunks = _walks(plan, slots)
    assert sorted(k for walk in walks for k in walk) == list(range(chunks))
    assert plan.chunk * (chunks - 1) < slots <= plan.chunk * chunks
    lengths = [len(walk) for walk in walks]
    assert min(lengths) >= 1 and max(lengths) - min(lengths) <= 1, (plan, lengths)
    step_rows, step_rem = divmod(plan.grid * plan.chunk, nnz)
    for walk in walks[:3] + walks[-2:]:
        row, rem = divmod(walk[0] * plan.chunk, nnz)
        for k in walk:
            assert (row, rem) == divmod(k * plan.chunk, nnz)
            first_slot = k * plan.chunk
            last_slot = min(first_slot + plan.chunk, slots) - 1
            assert last_slot // nnz - row + 1 <= plan.row_cap
            row, rem = row + step_rows, rem + step_rem
            if rem >= nnz:
                row, rem = row + 1, rem - nnz


@pytest.mark.parametrize(
    "rows,nnz",
    [(1, 3), (7, 39), (8, 39), (9, 40), (1000, 39), (100_000, 39), (5_000, 1), (37, 5000),
     (16, 5000), (100_003, 39), (100_000, 1), (300, 65), (64, 5)],
)
def test_tiles_cover_every_row_exactly_once(rows, nnz):
    # the row dot: a warp per row, block b takes rows [b * per, (b + 1) * per)
    # the thread-per-slot gradient: block b takes slots [b * per, (b + 1) * per)
    for grad, items in ((False, rows), (True, rows * nnz)):
        plan = sparsekernels._launch_plan(rows, nnz, grad)
        per = plan.threads if grad else plan.threads // 32
        counts = np.zeros(plan.grid * per, np.int64)
        for b in range(plan.grid):
            counts[b * per:(b + 1) * per] += 1
        np.testing.assert_array_equal(counts[:items], 1)
        assert (plan.grid - 1) * per < items, "a block with nothing to do"
    # sparse_grad: persistent blocks walking chunks
    for sms in SM_COUNTS:
        _check_grad_walk(rows, nnz, sms)


@pytest.mark.parametrize("rows,nnz", [(1_000_000, 39), (100_000, 100), (10_000_000, 39)])
@pytest.mark.parametrize("sms", SM_COUNTS)
def test_grad_chunks_cover_the_main_path_batches_exactly_once(rows, nnz, sms):
    _check_grad_plan(sparsekernels._grad_plan(rows, nnz, sms), rows, nnz, sms)
    _check_grad_walk(rows, nnz, sms)


def test_grad_plan_at_the_fit_batch_on_an_h100():
    """The fit batch (100,000 x 39) on 132 SMs: two blocks an SM, eight
    chunks of 1856 slots each (but ten blocks with seven), an 8192-entry
    table (64 KB) flushed at a quarter, two stages, 95,776 bytes a block."""
    plan = sparsekernels._grad_plan(100_000, 39, 132)
    assert plan == sparsekernels.GradPlan(threads=512, grid=264, chunk=1856, table=8192,
                                          flush_at=2048, row_cap=49)
    assert _grad_smem_bytes(plan) == 95_776
    lengths = [len(walk) for walk in _walks(plan, 100_000 * 39)[0]]
    assert lengths.count(8) == 254 and lengths.count(7) == 10


def _div_rows(n, d):
    """csrc/sparse_kernels.cu `div_rows` in numpy: float32 n times the
    float32 reciprocal of d, truncated, then one correction each way."""
    n = np.asarray(n, np.uint64)
    if d > 2**20:
        return (n >= d).astype(np.uint64)
    inv = np.float32(1.0) / np.float32(d)
    q = (n.astype(np.float32) * inv).astype(np.uint64)
    r = n.astype(np.int64) - (q * np.uint64(d)).astype(np.int64)
    return np.where(r < 0, q - 1, np.where(r >= d, q + 1, q))


@pytest.mark.parametrize("d", [1, 2, 3, 7, 39, 100, 1000, 4095, 5000, 65_535, 2**20 - 1, 2**20,
                               2**20 + 1, 2**31 - 1])
def test_reciprocal_row_division_is_exact_within_a_chunk(d):
    """The gradient finds a slot's row from its offset n < d + 2^16 past the
    chunk's first row start (the kernel's chunks are at most 2^16 slots)
    without a division instruction; it must equal n // d for every such n."""
    n = np.arange(0, d + 2**16, dtype=np.uint64) if d <= 2**20 else np.concatenate(
        [np.arange(0, 2**16, dtype=np.uint64), np.arange(d - 2**16, d + 2**16, dtype=np.uint64)])
    np.testing.assert_array_equal(_div_rows(n, d), n // np.uint64(d))


def _fleet_coeff(layout, members, d, aligned):
    """An (N, d) coeff in `layout`, its base 16-byte aligned or 4 bytes past."""
    start = 0 if aligned else 1
    buf = torch.zeros(members * d + 4)[start:start + members * d]
    if layout == "member-major":
        return buf.view(members, d)
    return buf.view(d, members).T


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("members", [1, 4, 8, 9])
@pytest.mark.parametrize("layout", ["member-major", "member-minor"])
def test_fleet_row_dots_loads_float4_members_only_where_whole_and_aligned(layout, members, aligned):
    """Where a column's members are whole, aligned float4s, fleet_row_dots
    loads them as float4s and fleet_grad's bulk reductions add into the
    gradient itself (else into a padded scratch copied out after)."""
    coeff = _fleet_coeff(layout, members, 10, aligned)
    assert (coeff.data_ptr() % 16 == 0) == aligned
    strides = sparsekernels._fleet_strides(coeff)
    want = layout == "member-minor" and members % 4 == 0 and aligned
    assert sparsekernels._float4_members(members, *strides, coeff.data_ptr()) == want
    # the wrappers take every layout (fleet_grad's gradient in coeff's);
    # on the CPU they are the plain versions
    indices, values, _, _ = _t(*_batch(73, 6, 5, 10))
    mult = torch.from_numpy(np.random.default_rng(73).standard_normal((members, 6)).astype(np.float32))
    torch.testing.assert_close(sparsekernels.fleet_row_dots(indices, values, coeff),
                               sparsekernels.fleet_row_dots_plain(indices, values, coeff),
                               rtol=0, atol=0)
    grad = sparsekernels.fleet_grad(indices, values, mult, coeff)
    assert grad.is_contiguous() == coeff.is_contiguous()
    torch.testing.assert_close(grad, sparsekernels.fleet_grad_plain(indices, values, mult, coeff),
                               rtol=0, atol=0)


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


# -- fleet_grad's one-pass plan and a numpy replica of its kernel --------

# (rows, nnz): the fit batch, the text path's, one slot, a wide row, the
# 1M-row transform, a slot count that leaves a partial block
FLEET_PLAN_BATCHES = [(100_000, 39), (100_000, 100), (1, 1), (16, 5000), (1_000_000, 39), (33, 40)]


def _check_fleet_plan(plan, rows, nnz, members):
    """fleet_grad's plan against the kernel's layout: a slot a thread, the
    blocks cover the slots with none empty, the padded row is whole float4s
    and its tiles of FLEET_TILE members cover it with none empty."""
    slots = rows * nnz
    assert plan.threads == sparsekernels.GRAD_THREADS and plan.threads % 32 == 0, plan
    assert plan.grid * plan.threads >= slots > (plan.grid - 1) * plan.threads, plan
    assert plan.grid <= MAX_GRID, plan
    assert plan.stride % 4 == 0 and members <= plan.stride < members + 4, plan
    tile = sparsekernels.FLEET_TILE
    assert plan.tiles * tile >= plan.stride > (plan.tiles - 1) * tile and plan.tiles <= 65_535, plan


@pytest.mark.parametrize("rows,nnz", FLEET_PLAN_BATCHES)
def test_fleet_grad_plan_covers_the_slots_and_the_members(rows, nnz):
    for members in range(1, 65):
        _check_fleet_plan(sparsekernels._fleet_grad_plan(rows, nnz, members), rows, nnz, members)


def _replica_fleet_grad(indices, values, mult, d, plan, layout):
    """fleet_grad's kernel in numpy on the plan's own numbers: a thread a
    slot, each valid slot adding its N products, padded to the plan's
    row of `stride` floats, to the column's row of a (d, stride) float32
    sum with one reduction, in some order; the sum's first N members are
    the (N, d) gradient, laid out as `layout`."""
    rows, nnz = indices.shape
    members = mult.shape[0]
    assert plan.grid * plan.threads >= rows * nnz and plan.threads % 32 == 0
    flat_idx = indices.reshape(-1).astype(np.int64)
    slot = np.flatnonzero((flat_idx >= 0) & (flat_idx < d))
    products = values.reshape(-1)[slot, None] * mult[:, slot // nnz].T  # float32, (valid, N)
    acc = np.zeros((d, plan.stride), np.float32)
    np.add.at(acc, flat_idx[slot], np.pad(products, ((0, 0), (0, plan.stride - members))))
    grad = acc[:, :members].T
    return np.ascontiguousarray(grad) if layout == "member-major" else np.ascontiguousarray(grad.T).T


def _fleet_case(case):
    """(indices, values, mult, d, exact): seeded numpy batches; `exact`
    where values and multipliers lie on the quarter grid."""
    rng = np.random.default_rng(89)
    if case == "uniform":
        indices, values, _, mult = _fleet_batch(97, 300, 39, 1000, 8)
        return indices, values, mult, 1000, False
    if case == "out_of_range":
        indices, values, _, mult = _fleet_batch(101, 200, 39, 64, 9)
        return indices, values, mult, 64, False
    if case == "padding":
        return (np.full((50, 6), -1, np.int32), rng.standard_normal((50, 6)).astype(np.float32),
                rng.standard_normal((4, 50)).astype(np.float32), 16, True)
    rows, nnz, d, members = {"zipf": (2000, 39, 1000, 8), "zipf_wide": (2000, 39, 10_000, 8),
                             "tiny_d": (2000, 39, 7, 3)}[case]
    if case.startswith("zipf"):  # ranks drawn by k^-1.1, scattered over the columns
        weights = np.arange(1, d + 1, dtype=np.float64) ** -1.1
        indices = rng.permutation(d)[rng.choice(d, size=(rows, nnz), p=weights / weights.sum())]
    else:
        indices = rng.integers(0, d, size=(rows, nnz))
    indices = np.where(rng.random((rows, nnz)) < 0.05, -1, indices).astype(np.int32)
    values = (rng.integers(0, 5, size=(rows, nnz)) / 4).astype(np.float32)
    mult = (rng.integers(-4, 5, size=(members, rows)) / 4).astype(np.float32)
    return indices, values, mult, d, True


@pytest.mark.parametrize("layout", ["member-major", "member-minor"])
@pytest.mark.parametrize("case", ["uniform", "zipf", "zipf_wide", "tiny_d", "out_of_range", "padding"])
def test_fleet_grad_replica_matches_plain_and_pallas_under_vmap(case, layout):
    """The kernel's arithmetic on the plan's numbers gives fleet_grad_plain's
    gradient (exactly on quarter-grid values) and the JAX package's Pallas
    gradient under jax.vmap, for N a multiple of 4 (summed in place) and
    not (3 and 9 members, summed in a padded scratch)."""
    indices, values, mult, d, exact = _fleet_case(case)
    members, rows = mult.shape
    coeff = np.zeros((members, d), np.float32)
    tc = torch.from_numpy(coeff) if layout == "member-major" else torch.from_numpy(coeff.T.copy()).T
    direct = sparsekernels._float4_members(members, *sparsekernels._fleet_strides(tc), tc.data_ptr())
    assert direct == (layout == "member-minor" and members % 4 == 0 and tc.data_ptr() % 16 == 0)
    plan = sparsekernels._fleet_grad_plan(rows, indices.shape[1], members)
    got = _replica_fleet_grad(indices, values, mult, d, plan, layout)
    assert got.flags.c_contiguous == (layout == "member-major")
    want = sparsekernels.fleet_grad_plain(*_t(indices, values, mult, coeff)).numpy()
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    ji, jv, jm, jc = (jnp.asarray(a) for a in (indices, values, mult, coeff))
    pallas = jax.vmap(jax_kernels.sparse_grad, in_axes=(None, None, 0, 0))(ji, jv, jm, jc)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=RTOL, atol=ATOL)
