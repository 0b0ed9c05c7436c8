"""The plain reference of a linear model's mini-batch SGD fit and its
scores, in float64 PyTorch (or in TF32 arithmetic, the control).

A frozen copy of the semantics of Flink ML's SGD (SGD.java:82-292,
TerminateOnMaxIterOrTol.java, RegularizationUtils.java) as the program
states them, written again from the description and importing nothing of
the program:

- rows are cut into batches of `globalBatchSize`; epoch e trains on batch
  e mod num_batches; a row past the table's end weighs 0, so the last
  batch's padding is left out;
- the first epoch computes a gradient before any update; every later
  epoch first applies the previous gradient, `coeff -= lr / wsum * grad`,
  then the proximal step where reg > 0,
  `coeff -= lr * (elasticNet * reg * sign(coeff) + (1 - elasticNet) * reg * coeff)`;
- the loop runs while `epoch < maxIter and loss > tol`, the loss being the
  batch's weighted loss sum over its weight sum; one more update lands
  after the loop.

`Arith` says in which arithmetic: "float64" (the reference) or "tf32" (the
control: float32 with every product's operands rounded to TF32's 10-bit
mantissa, as a tensor core rounds them, and float32 sums).

A layout (`DenseRows`, `SparseRows`) holds the table's raw columns as the
benchmark made them and gives a batch's row dots and gradient, and the
scores of any block of rows.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

PRECISIONS = ("float64", "tf32")


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 `t` rounded to the nearest TF32 value (10 mantissa bits,
    ties to even), still stored as float32."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


class Arith:
    """The arithmetic of one reference run."""

    def __init__(self, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        """`t` as an operand of a product."""
        t = t.to(self.dtype)
        return round_tf32(t) if self.precision == "tf32" else t

    def value(self, t: torch.Tensor) -> torch.Tensor:
        """`t` as a value that is summed or compared, not multiplied."""
        return t.to(self.dtype)


class DenseRows:
    """Dense rows X (n, d) with labels y and optional weights w."""

    def __init__(self, X, y, w=None):
        self.X, self.y, self.w = X, y, w
        self.n, self.d = int(X.shape[0]), int(X.shape[1])

    def dot(self, lo: int, hi: int, coeff, arith: Arith):
        with _no_tf32():
            return arith.operand(self.X[lo:hi]) @ arith.operand(coeff)

    def grad(self, lo: int, hi: int, mult, arith: Arith):
        with _no_tf32():
            return arith.operand(self.X[lo:hi]).T @ arith.operand(mult)


class SparseRows:
    """Padded-CSR rows: indices (n, nnz) int32 (-1 pads; an index >= d is
    read as d - 1 and never updated) and values (n, nnz), of `d` columns,
    with labels y and optional weights w."""

    def __init__(self, indices, values, d: int, y, w=None):
        self.indices, self.values, self.y, self.w = indices, values, y, w
        self.n, self.d = int(indices.shape[0]), int(d)

    def dot(self, lo: int, hi: int, coeff, arith: Arith):
        idx = self.indices[lo:hi].long()
        vals = torch.where(idx >= 0, arith.operand(self.values[lo:hi]), 0.0)
        return torch.sum(vals * arith.operand(coeff)[idx.clamp(0, self.d - 1)], dim=1)

    def grad(self, lo: int, hi: int, mult, arith: Arith):
        idx = self.indices[lo:hi].long()
        keep = (idx >= 0) & (idx < self.d)
        contrib = arith.operand(self.values[lo:hi]) * arith.operand(mult)[:, None]
        contrib = torch.where(keep, contrib, 0.0)
        out = torch.zeros(self.d, dtype=arith.dtype, device=idx.device)
        return out.index_add_(0, torch.where(keep, idx, 0).reshape(-1), contrib.reshape(-1))


class _no_tf32:
    """Matrix products in full float32 inside the block: the control's
    rounding is `round_tf32`'s, never the library's."""

    def __enter__(self):
        self.prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.prev


def logistic_pointwise(dot, y, w):
    """Per-row (loss, gradient multiplier) of the binary logistic loss
    (BinaryLogisticLoss.java) at labels y in {0, 1} and weights w."""
    sign = 2.0 * y - 1.0
    margin = dot * sign
    loss = w * torch.logaddexp(torch.zeros_like(margin), -margin)
    return loss, w * (-sign / (torch.exp(margin) + 1.0))


def sgd_fit(rows, params: Dict, arith: Arith, pointwise=logistic_pointwise) -> torch.Tensor:
    """The fitted coefficient (d,) in `arith`'s dtype. `params` holds the
    estimator's maxIter, globalBatchSize, learningRate, reg, elasticNet and
    tol, under those names."""
    max_iter, batch = int(params["maxIter"]), int(params["globalBatchSize"])
    lr, reg, en = float(params["learningRate"]), float(params["reg"]), float(params["elasticNet"])
    tol = float(params["tol"])
    num_batches = max(1, math.ceil(rows.n / batch))
    device = rows.y.device
    coeff = torch.zeros(rows.d, dtype=arith.dtype, device=device)
    grad = torch.zeros_like(coeff)
    wsum, loss, epoch = 0.0, math.inf, 0

    def update(coeff):
        coeff = coeff - (lr / wsum) * grad
        if reg > 0:
            coeff = coeff - lr * (en * reg * torch.sign(coeff) + (1.0 - en) * reg * coeff)
        return coeff

    while epoch < max_iter and loss > tol:
        lo = (epoch % num_batches) * batch
        hi = min(lo + batch, rows.n)
        if wsum > 0:
            coeff = update(coeff)
        y = arith.value(rows.y[lo:hi])
        w = torch.ones_like(y) if rows.w is None else arith.value(rows.w[lo:hi])
        row_loss, mult = pointwise(rows.dot(lo, hi, coeff, arith), y, w)
        grad = rows.grad(lo, hi, mult, arith)
        wsum = float(torch.sum(w))
        loss = float(torch.sum(row_loss)) / max(wsum, 1e-30)
        epoch += 1
    if wsum > 0:
        coeff = update(coeff)
    return coeff


def logistic_scores(rows, coeff, arith: Arith, lo: int, hi: int):
    """(dot, probability of label 1) of rows [lo, hi) under `coeff`
    (LogisticRegressionModel.java:165-168)."""
    dot = rows.dot(lo, hi, coeff, arith)
    return dot, 1.0 - 1.0 / (1.0 + torch.exp(dot))


def as_rows(tensors: Dict, data: Dict):
    """The layout of a table the benchmark made, by its columns: {"features",
    "label", "weight"?} dense, or {"indices", "values", "label"} padded-CSR
    of the data spec's numFeatures columns."""
    if "indices" in tensors:
        return SparseRows(tensors["indices"], tensors["values"], int(data["numFeatures"]),
                          tensors["label"], tensors.get("weight"))
    return DenseRows(tensors["features"], tensors["label"], tensors.get("weight"))
