"""Batched loss functions for linear-model training.

Port of flink_ml_tpu/ops/losses.py (the reference's common/lossfunc/
BinaryLogisticLoss.java, HingeLoss.java, LeastSquareLoss.java). A loss is
a function of (X, y, w, coeff) returning (loss_sum, grad_sum[d],
weight_sum), built from a pointwise form `(dot, y, w) -> (per-row loss,
per-row multiplier)` and a layout:

- dense: X is (B, d); the contractions keep the JAX package's reduce form,
  `sum(X * coeff, -1)` and `sum(X * mult[:, None], -2)`, which runs no
  matrix product, so TF32 never enters a training path;
- sparse: X is the padded-CSR pair (indices (B, nnz) int32, values
  (B, nnz)); the row dot and the gradient segment sum go through
  `sparsekernels`, which runs the CUDA kernels on CUDA tensors and the
  plain versions on CPU tensors. PLAIN_SPARSE_VARIANTS call the plain
  versions on any device: `chip_smoke.py` holds each kernel fit against one.

A fleet fit (fleet.py) trains N members on one shared batch: its losses
(`fleet_loss`) take coeff (N, d) and return (loss_sum [N], grad_sum
[N, d], weight_sum), the member axis leading as under the JAX package's
vmap. The batch is broadcast, never copied N times: dense, the reduce
forms over X[None] (`fleet_dense_dot`, `fleet_dense_grad`); sparse, the
member-batched kernels `fleet_row_dots` and `fleet_grad`, which read each
slot once for all members. The pointwise forms broadcast over the member
axis as they are.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from . import sparsekernels

LossOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class LossFunc(NamedTuple):
    """A batched loss: name + callable(X, y, w, coeff) -> (loss_sum,
    grad_sum, weight_sum); `pointwise` is its per-row form."""

    name: str
    fn: Callable[..., LossOut]
    pointwise: Callable

    def __call__(self, X, y, w, coeff) -> LossOut:
        return self.fn(X, y, w, coeff)


def _logistic_pointwise(dot, y, w):
    """-> (per-row loss, per-row multiplier); grad = X^T multiplier."""
    label_scaled = 2.0 * y - 1.0
    margin = dot * label_scaled
    # log(1 + exp(-margin)) computed stably
    loss = w * torch.logaddexp(margin.new_zeros(()), -margin)
    multiplier = w * (-label_scaled / (torch.exp(margin) + 1.0))
    return loss, multiplier


def _hinge_pointwise(dot, y, w):
    label_scaled = 2.0 * y - 1.0
    margin = 1.0 - label_scaled * dot
    loss = w * torch.clamp(margin, min=0.0)
    multiplier = torch.where(margin > 0.0, -label_scaled * w, 0.0)
    return loss, multiplier


def _least_square_pointwise(dot, y, w):
    diff = dot - y
    loss = w * 0.5 * diff * diff
    multiplier = w * diff
    return loss, multiplier


def dense_dot(X, coeff):
    """Per-row dots X[B,d] . coeff[d] -> [B], in reduce form."""
    return torch.sum(X * coeff, dim=-1)


def dense_grad(X, multiplier):
    """sum_B multiplier[B] * X[B,d] -> [d], the reduce-form twin of `dense_dot`."""
    return torch.sum(X * multiplier[..., None], dim=-2)


def _dense(pointwise):
    def fn(X, y, w, coeff) -> LossOut:
        loss, multiplier = pointwise(dense_dot(X, coeff), y, w)
        return torch.sum(loss), dense_grad(X, multiplier), torch.sum(w)

    return fn


#: masked padded-CSR row dots (-1 indices are padding, indices >= d are
#: clamped to d-1), shared by the training losses and inference
sparse_dot = sparsekernels.sparse_row_dots


def _sparse(pointwise, row_dots, grad):
    """Padded-CSR batched loss: X = (indices[B, k] int32 with -1 padding,
    values[B, k]); the per-row dot is `row_dots` and the gradient `grad`."""

    def fn(X, y, w, coeff) -> LossOut:
        indices, values = X
        loss, multiplier = pointwise(row_dots(indices, values, coeff), y, w)
        return torch.sum(loss), grad(indices, values, multiplier, coeff), torch.sum(w)

    return fn


BINARY_LOGISTIC_LOSS = LossFunc(
    "binary_logistic", _dense(_logistic_pointwise), _logistic_pointwise
)
HINGE_LOSS = LossFunc("hinge", _dense(_hinge_pointwise), _hinge_pointwise)
LEAST_SQUARE_LOSS = LossFunc(
    "least_square", _dense(_least_square_pointwise), _least_square_pointwise
)


def _sparse_variants(prefix, row_dots, grad):
    return {
        base.name: LossFunc(prefix + base.name, _sparse(base.pointwise, row_dots, grad),
                            base.pointwise)
        for base in (BINARY_LOGISTIC_LOSS, HINGE_LOSS, LEAST_SQUARE_LOSS)
    }


#: dense loss name -> its padded-CSR loss on the kernels (CPU: plain versions)
SPARSE_VARIANTS = _sparse_variants("sparse_", sparse_dot, sparsekernels.sparse_grad)
SPARSE_BINARY_LOGISTIC_LOSS = SPARSE_VARIANTS[BINARY_LOGISTIC_LOSS.name]
#: dense loss name -> its padded-CSR loss on the plain versions, on any device
PLAIN_SPARSE_VARIANTS = _sparse_variants(
    "plain_sparse_", sparsekernels.sparse_row_dots_plain, sparsekernels.sparse_grad_plain
)


def sparse_variant(name: str) -> LossFunc:
    """The padded-CSR LossFunc for the dense loss `name`."""
    return SPARSE_VARIANTS[name]


def fleet_dense_dot(X, coeff):
    """Per-member row dots X[B, d] . coeff[N, d] -> [N, B]: `dense_dot`'s
    reduce form with a leading member axis."""
    return torch.sum(X * coeff[:, None, :], dim=-1)


def fleet_dense_grad(X, multiplier):
    """sum_B multiplier[N, B] * X[B, d] -> [N, d]: `dense_grad` with a
    leading member axis."""
    return torch.sum(X * multiplier[:, :, None], dim=-2)


def _fleet(pointwise, row_dots, grad):
    """A fleet loss: (X, y, w, coeff [N, d]) -> (loss_sum [N], grad [N, d],
    weight_sum), X dense (B, d) or the padded-CSR pair."""

    def fn(X, y, w, coeff) -> LossOut:
        if isinstance(X, tuple):
            indices, values = X
            loss, multiplier = pointwise(row_dots(indices, values, coeff), y, w)
            return torch.sum(loss, dim=-1), grad(indices, values, multiplier, coeff), torch.sum(w)
        loss, multiplier = pointwise(fleet_dense_dot(X, coeff), y, w)
        return torch.sum(loss, dim=-1), fleet_dense_grad(X, multiplier), torch.sum(w)

    return fn


def _fleet_variants(prefix, row_dots, grad):
    return {
        base.name: LossFunc(prefix + base.name, _fleet(base.pointwise, row_dots, grad),
                            base.pointwise)
        for base in (BINARY_LOGISTIC_LOSS, HINGE_LOSS, LEAST_SQUARE_LOSS)
    }


#: dense loss name -> its fleet loss, dense or sparse on the fleet kernels
#: (CPU: their plain versions)
FLEET_VARIANTS = _fleet_variants("fleet_", sparsekernels.fleet_row_dots, sparsekernels.fleet_grad)
#: dense loss name -> its fleet loss on the plain versions, on any device
PLAIN_FLEET_VARIANTS = _fleet_variants(
    "plain_fleet_", sparsekernels.fleet_row_dots_plain, sparsekernels.fleet_grad_plain
)


def fleet_loss(name: str, plain: bool = False) -> LossFunc:
    """The fleet LossFunc for the dense loss `name`; `plain` runs sparse
    batches on the plain versions of the fleet kernels."""
    return (PLAIN_FLEET_VARIANTS if plain else FLEET_VARIANTS)[name]


def predict_raw(X, coeff):
    """Raw linear prediction X @ coeff, the inference matvec
    (LogisticRegressionModel.java:131). A float32 matmul on the card follows
    `torch.backends.cuda.matmul.allow_tf32`, which PyTorch leaves False."""
    return X @ coeff
