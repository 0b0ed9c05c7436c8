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

A feature-sharded (2D) fit (parallel/overlap.py `sgd2d_*`) trains on the
2D losses (`feature_sharded_variant`, JAX `:198-275`), called with the
mesh as a fifth argument: coeff is this rank's model-axis slice, the batch
its data-axis rows with global feature indices.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from . import sparsekernels

LossOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class LossFunc(NamedTuple):
    """A batched loss: name + callable(X, y, w, coeff) -> (loss_sum,
    grad_sum, weight_sum); `pointwise` is its per-row form. `sparse` marks
    the padded-CSR (indices, values) input layout, the JAX package's
    fourth field: the optimizer reads it where the JAX one does (the 2D
    route, `SGD._use_2d`); the fleet losses take either layout and decide
    by the batch's type, so they keep the default."""

    name: str
    fn: Callable[..., LossOut]
    pointwise: Callable = None
    sparse: bool = False

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
                            base.pointwise, True)
        for base in (BINARY_LOGISTIC_LOSS, HINGE_LOSS, LEAST_SQUARE_LOSS)
    }


#: dense loss name -> its padded-CSR loss on the kernels (CPU: plain versions)
SPARSE_VARIANTS = _sparse_variants("sparse_", sparse_dot, sparsekernels.sparse_grad)
SPARSE_BINARY_LOGISTIC_LOSS = SPARSE_VARIANTS[BINARY_LOGISTIC_LOSS.name]
SPARSE_HINGE_LOSS = SPARSE_VARIANTS[HINGE_LOSS.name]
SPARSE_LEAST_SQUARE_LOSS = SPARSE_VARIANTS[LEAST_SQUARE_LOSS.name]
#: dense loss name -> its padded-CSR loss on the plain versions, on any device
PLAIN_SPARSE_VARIANTS = _sparse_variants(
    "plain_sparse_", sparsekernels.sparse_row_dots_plain, sparsekernels.sparse_grad_plain
)


def sparse_variant(name: str) -> LossFunc:
    """The padded-CSR LossFunc for the dense loss `name`."""
    return SPARSE_VARIANTS[name]


def _feature_sharded(pointwise, grad):
    """Padded-CSR loss for the 2D `(data, model)` mesh: (X, y, w, coeff,
    mesh) -> (loss_sum, grad (d_local,), weight_sum), with coeff this
    rank's slice [lo, lo + d_local) (lo = model index * d_local) and X this
    rank's batch rows, global feature indices.

    Forward: each rank gathers the active coefficients it owns (0 for a
    slot it does not own or padding), and one `all_reduce_sum` over
    `model` of the (B, nnz) gathered values assembles every active
    coefficient, since exactly one rank owns each slot (0 + x == x
    exactly). Wire bytes over `model` are B * nnz * 4: the (d,) vector
    never crosses. This is a plain gather, as in the JAX body (no Pallas
    kernel runs there).

    Gradient: the local scatter into this rank's slice runs the gradient
    `grad` (the `sparse_grad` kernel, or its plain version) on local
    indices, `idx - lo` where owned and -1 elsewhere, which it drops as
    padding. The JAX body scatters +0.0 into slot 0 for every slot it does
    not own; the kernel adds nothing there (x + 0.0 differs from x only in
    the sign of a zero), so the two are held allclose. The sum then
    reduces over `data` alone: the SparCML pair exchange when
    `sparse_reduce_wins(rows * nnz, d_local)` (whose scatter adds in a
    fixed order, C.30), else the dense payload [grad | loss | weight] in
    one all-reduce, the reduce the 1D sharded fit runs, so a one-model-
    shard 2D fit equals it bit for bit at any rank count (the JAX package
    reduces the dense payload chunked, which XLA's replica-ordered psum
    makes the same bits; gloo's chunked reduce is not, ROADMAP C.26). The
    kernel is allowed there (C.30): the data-axis reduce that follows gives
    every rank of a model column one result."""

    def fn(X, y, w, coeff, mesh=None) -> LossOut:
        from ..parallel import collectives
        from ..parallel.mesh import DATA_AXIS, MODEL_AXIS

        indices, values = X
        d_local = coeff.shape[0]
        lo = collectives.axis_index(MODEL_AXIS, mesh) * d_local
        valid = indices >= 0
        vals = torch.where(valid, values.to(coeff.dtype), 0.0)
        owned = valid & (indices >= lo) & (indices < lo + d_local)
        local = torch.where(owned, indices - lo, -1).to(torch.int32)
        gathered = torch.where(owned, coeff[torch.clamp(local, min=0).long()], 0.0)
        active = collectives.all_reduce_sum(gathered, MODEL_AXIS, mesh)
        loss, multiplier = pointwise(torch.sum(vals * active, dim=1), y, w)
        lsum, wsum = torch.sum(loss), torch.sum(w).to(loss.dtype)
        rows, nnz = indices.shape
        if collectives.sparse_reduce_wins(rows * nnz, d_local, itemsize=vals.element_size()):
            g = collectives.sparse_all_reduce_sum(local, vals * multiplier[:, None], d_local,
                                                  DATA_AXIS, mesh)
            sums = collectives.all_reduce_sum(torch.stack([lsum, wsum]), DATA_AXIS, mesh)
            return sums[0], g, sums[1].to(w.dtype)
        g_local = grad(local, vals, multiplier, coeff)
        summed = collectives.all_reduce_sum(
            torch.cat([g_local, lsum.reshape(1).to(g_local.dtype),
                       wsum.reshape(1).to(g_local.dtype)]), DATA_AXIS, mesh)
        return summed[d_local], summed[:d_local], summed[d_local + 1].to(w.dtype)

    return fn


def _feature_sharded_variants(prefix, grad):
    return {
        base.name: LossFunc(prefix + base.name + "_2d", _feature_sharded(base.pointwise, grad),
                            base.pointwise, True)
        for base in (BINARY_LOGISTIC_LOSS, HINGE_LOSS, LEAST_SQUARE_LOSS)
    }


#: dense loss name -> its 2D loss: the local scatter on the `sparse_grad`
#: kernel (CPU: its plain version), and on the plain version on any device
_FEATURE_SHARDED = _feature_sharded_variants("sparse_", sparsekernels.sparse_grad)
_PLAIN_FEATURE_SHARDED = _feature_sharded_variants("plain_sparse_",
                                                   sparsekernels.sparse_grad_plain)
FEATURE_SHARDED_BINARY_LOGISTIC_LOSS = _FEATURE_SHARDED[BINARY_LOGISTIC_LOSS.name]
FEATURE_SHARDED_HINGE_LOSS = _FEATURE_SHARDED[HINGE_LOSS.name]
FEATURE_SHARDED_LEAST_SQUARE_LOSS = _FEATURE_SHARDED[LEAST_SQUARE_LOSS.name]
#: sparse (and plain sparse) loss name -> its 2D feature-sharded variant
FEATURE_SHARDED_VARIANTS = {
    **{SPARSE_VARIANTS[name].name: loss for name, loss in _FEATURE_SHARDED.items()},
    **{PLAIN_SPARSE_VARIANTS[name].name: loss for name, loss in _PLAIN_FEATURE_SHARDED.items()},
}


def feature_sharded_variant(loss_func: LossFunc) -> LossFunc:
    """The 2D `(data, model)` LossFunc of a sparse loss."""
    return FEATURE_SHARDED_VARIANTS[loss_func.name]


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


#: every LossFunc by its name (the program bank rebuilds a banked fit's
#: loss from its name: compilebank.static_value)
BY_NAME = {
    loss.name: loss
    for group in ((BINARY_LOGISTIC_LOSS, HINGE_LOSS, LEAST_SQUARE_LOSS),
                  SPARSE_VARIANTS.values(), PLAIN_SPARSE_VARIANTS.values(),
                  FEATURE_SHARDED_VARIANTS.values(),
                  FLEET_VARIANTS.values(), PLAIN_FLEET_VARIANTS.values())
    for loss in group
}


def by_name(name: str) -> LossFunc:
    return BY_NAME[name]


def _register_bank_types() -> None:
    from .. import compilebank

    compilebank.register_static_type("LossFunc", by_name)


_register_bank_types()


def predict_raw(X, coeff):
    """Raw linear prediction X @ coeff, the inference matvec
    (LogisticRegressionModel.java:131). A float32 matmul on the card follows
    `torch.backends.cuda.matmul.allow_tf32`, which PyTorch leaves False."""
    return X @ coeff


def sigmoid(z):
    return 1.0 / (1.0 + torch.exp(-z))
