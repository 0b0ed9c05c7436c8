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
  plain versions on CPU tensors. PLAIN_SPARSE_BINARY_LOGISTIC_LOSS calls the
  plain versions on any device: `chip_smoke.py` holds a kernel fit against it.
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


#: dense loss name -> its padded-CSR loss on the kernels (CPU: plain versions)
SPARSE_VARIANTS = {
    base.name: LossFunc(
        "sparse_" + base.name,
        _sparse(base.pointwise, sparse_dot, sparsekernels.sparse_grad),
        base.pointwise,
    )
    for base in (BINARY_LOGISTIC_LOSS, HINGE_LOSS, LEAST_SQUARE_LOSS)
}
SPARSE_BINARY_LOGISTIC_LOSS = SPARSE_VARIANTS[BINARY_LOGISTIC_LOSS.name]
#: the sparse logistic loss on the plain versions, on any device
PLAIN_SPARSE_BINARY_LOGISTIC_LOSS = LossFunc(
    "plain_sparse_" + BINARY_LOGISTIC_LOSS.name,
    _sparse(
        _logistic_pointwise,
        sparsekernels.sparse_row_dots_plain,
        sparsekernels.sparse_grad_plain,
    ),
    _logistic_pointwise,
)


def sparse_variant(name: str) -> LossFunc:
    """The padded-CSR LossFunc for the dense loss `name`."""
    return SPARSE_VARIANTS[name]


def predict_raw(X, coeff):
    """Raw linear prediction X @ coeff, the inference matvec
    (LogisticRegressionModel.java:131). A float32 matmul on the card follows
    `torch.backends.cuda.matmul.allow_tf32`, which PyTorch leaves False."""
    return X @ coeff
