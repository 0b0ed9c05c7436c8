"""flink_ml_tpu_torch/ops/sparsekernels.py against the JAX package.

The plain PyTorch versions (the CPU route of each wrapper) are held against
the JAX Pallas kernels, run in interpret mode on the CPU as the JAX tests
run them, and against the lax path of the default fit (`losses.sparse_dot`
and the `mode="drop"` scatter). Inputs are made with seeded numpy and
include -1 padding and indices >= d. The CUDA kernels themselves run only
on the card: chip_smoke.py holds them against the plain versions there.
"""

import numpy as np
import pytest
import torch

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


SHAPES = [(7, 64, 5, 24), (11, 200, 39, 64), (13, 1, 3, 4), (17, 33, 40, 50)]


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
    assert sparsekernels.launch_counts() == {"sparse_row_dots": 0, "sparse_grad": 0}


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
