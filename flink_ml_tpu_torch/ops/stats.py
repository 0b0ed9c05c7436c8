"""Statistical test cores: chi-square, ANOVA F, F-value (regression).

Port of flink_ml_tpu/ops/stats.py (the reference's
stats/chisqtest/ChiSqTest.java, stats/anovatest/ANOVATest.java:194-235
and stats/fvaluetest/FValueTest.java), shared by the stats stages and
UnivariateFeatureSelector. Each test keeps the JAX package's two
branches:

- a tensor X takes the device branch: class discovery by a sort on the
  card, the per-class sums, counts and total squares of the centred
  float32 matrix (or its centred moments against the label), then ONE
  packed readback of a few numbers a feature;
- a host X takes the float64 numpy branch, op for op the JAX host path
  (its uncentred ANOVA sums included).

The device branch centres in float32 as the JAX device program does (so
the float32 rounding of the data is the same) and accumulates the sums of
the centred values in float64, a chunk of rows at a time: the JAX
program's float32 sums of 10M terms carry an error the reference's double
sums do not, and the H100 has float64 (ROADMAP C.11). The float64 tail
that turns the sums into statistics and p-values (ops/special.py) is
numpy, shared by both branches. The chi-square test is host work in both
packages: a tensor column is read back.
"""

from __future__ import annotations

import collections
from typing import Iterator, Tuple

import numpy as np
import torch

from ..parallel.prefetch import to_device
from ..table import _to_numpy
from .special import betainc_reg, gammainc_p

#: how often the chi-square test ran on the host, and on a column read back
HOST_COUNTS: collections.Counter = collections.Counter()
#: rows of the centred matrix a device chunk converts to float64 (a
#: 100-wide chunk is 800 MB); the sums add up across chunks in float64
CHUNK_ROWS = 1 << 20


def chi2_sf(x, df):
    """P[Chi2(df) > x] = 1 - P(df/2, x/2) (regularized lower inc. gamma)."""
    return 1.0 - gammainc_p(np.asarray(df) / 2.0, np.asarray(x) / 2.0)


def f_sf(x, dfn, dfd):
    """P[F(dfn, dfd) > x] via the regularized incomplete beta function."""
    x = np.maximum(np.asarray(x, dtype=np.float64), 0.0)
    return betainc_reg(dfd / 2.0, dfn / 2.0, dfd / (dfd + dfn * x))


def contingency_tables(X, y) -> Iterator[np.ndarray]:
    """Each feature column's observed (categories, label classes) count
    table, int64, categories and classes in sorted order: one O(n)
    bincount a column (a dense one-hot matmul would be O(n*m*k))."""
    X = np.asarray(_to_numpy(X), dtype=np.float64)
    y_cats, y_idx = np.unique(_to_numpy(y), return_inverse=True)
    k = len(y_cats)
    for j in range(X.shape[1]):
        f_cats, f_idx = np.unique(X[:, j], return_inverse=True)
        m = len(f_cats)
        yield np.bincount(f_idx * k + y_idx, minlength=m * k).reshape(m, k)


def chi_square_test(X, y) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pearson chi-square independence test of each categorical feature
    column against a categorical label. Returns (p_values, dofs,
    statistics): ChiSqTest.java's contingency table, expected counts from
    the marginals, in float64 on the host (a tensor is read back)."""
    HOST_COUNTS["chi-square test on the host"] += 1
    if isinstance(X, torch.Tensor):
        HOST_COUNTS["chi-square test on a column read back from its device"] += 1
    n = int(np.shape(X)[0])
    p_values, dofs, stats = [], [], []
    for table in contingency_tables(X, y):
        observed = table.astype(np.float64)
        m, k = observed.shape
        row = observed.sum(axis=1, keepdims=True)
        col = observed.sum(axis=0, keepdims=True)
        expected = row * col / n
        with np.errstate(divide="ignore", invalid="ignore"):
            stat = float(
                np.sum(np.where(expected > 0, (observed - expected) ** 2 / expected, 0.0))
            )
        dof = (m - 1) * (k - 1)
        p = float(chi2_sf(stat, float(dof))) if dof > 0 else 1.0
        p_values.append(p)
        dofs.append(dof)
        stats.append(stat)
    return np.asarray(p_values), np.asarray(dofs, dtype=np.int64), np.asarray(stats)


def _device_label(y, X: torch.Tensor) -> torch.Tensor:
    """The label on X's device in X's dtype: a host label is staged there
    as the JAX device branch's `jnp.asarray` stages it (float32)."""
    if isinstance(y, torch.Tensor):
        return to_device(y, X.device, X.dtype)
    return to_device(np.asarray(y), X.device, X.dtype)


def _anova_device_sums(X: torch.Tensor, y: torch.Tensor):
    """(sums (k, d), counts (k,), total_sq (d,)) of the centred matrix by
    class, from one packed (k + 2, d + 1) readback, as the JAX kernel packs
    it: the classes by a sort on the card (torch.unique), the labels mapped
    by searchsorted there, exact integer counts, and the one-hot products
    of float32-centred chunks summed in float64."""
    n, d = X.shape
    classes = torch.unique(y)
    k = int(classes.numel())
    y_idx = torch.searchsorted(classes, y)
    mean = torch.mean(X, dim=0, keepdim=True)
    sums = torch.zeros((k, d), dtype=torch.float64, device=X.device)
    total_sq = torch.zeros(d, dtype=torch.float64, device=X.device)
    for s in range(0, n, CHUNK_ROWS):
        Xc = (X[s:s + CHUNK_ROWS] - mean).double()
        onehot = torch.nn.functional.one_hot(y_idx[s:s + CHUNK_ROWS], k).double()
        sums += onehot.T @ Xc
        total_sq += torch.sum(Xc * Xc, dim=0)
    counts = torch.bincount(y_idx, minlength=k).double()
    packed = torch.zeros((k + 2, d + 1), dtype=torch.float64, device=X.device)
    packed[:k, :d] = sums
    packed[:k, d] = counts
    packed[k, :d] = total_sq
    packed = packed.cpu().numpy()
    return packed[:k, :-1], packed[:k, -1], packed[k, :-1]


def anova_f_test(X, y) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One-way ANOVA F-test of each continuous feature against a categorical
    label. Returns (p_values, dofs, f_statistics) with the reference's
    reported dof = (k - 1) + (n - k) = n - 1 (ANOVATest.java:232)."""
    if isinstance(X, torch.Tensor):
        n, d = X.shape
        sums, counts, total_sq = _anova_device_sums(X, _device_label(y, X))
        k = counts.size
    else:
        y = np.asarray(y)
        y_cats, y_idx = np.unique(y, return_inverse=True)
        k = len(y_cats)
        X = np.asarray(X, dtype=np.float64)
        n, d = X.shape
        y_onehot = np.eye(k)[y_idx]
        counts = y_onehot.sum(axis=0)  # (k,)
        sums = y_onehot.T @ X  # (k, d)
        total_sq = (X * X).sum(axis=0)
    total_sum = sums.sum(axis=0)
    ss_tot = total_sq - total_sum**2 / n
    ss_between = (sums**2 / counts[:, None]).sum(axis=0) - total_sum**2 / n
    ss_within = ss_tot - ss_between
    dfn, dfd = k - 1, n - k
    with np.errstate(divide="ignore", invalid="ignore"):
        f_stat = (ss_between / dfn) / (ss_within / dfd)
    f_stat = np.nan_to_num(f_stat, nan=0.0, posinf=np.inf)
    p = f_sf(f_stat, float(dfn), float(dfd))
    return p, np.full(d, dfn + dfd, dtype=np.int64), f_stat


def _centered_moments(X: torch.Tensor, y: torch.Tensor) -> np.ndarray:
    """[[sum (x-xm)^2 ..., sum (y-ym)^2], [sum (x-xm)(y-ym) ..., 0]] from
    one readback, centred in float32 on both sides (the naive
    sum_x2 - n*xm^2 form cancels catastrophically when |mean| >> std),
    summed in float64 a chunk at a time."""
    n, d = X.shape
    xm = torch.mean(X, dim=0, keepdim=True)
    ym = torch.mean(y)
    packed = torch.zeros((2, d + 1), dtype=torch.float64, device=X.device)
    for s in range(0, n, CHUNK_ROWS):
        Xc = (X[s:s + CHUNK_ROWS] - xm).double()
        yc = (y[s:s + CHUNK_ROWS] - ym).double()
        packed[0, :d] += torch.sum(Xc * Xc, dim=0)
        packed[0, d] += torch.sum(yc * yc)
        packed[1, :d] += Xc.T @ yc
    return packed.cpu().numpy()


def f_value_test(X, y) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Univariate linear-regression F-test of each continuous feature against
    a continuous label (FValueTest.java). Returns (p_values, dofs, f_stats)
    with dof = n - 2."""
    if isinstance(X, torch.Tensor):
        n, d = X.shape
        m = _centered_moments(X, _device_label(y, X))
        ss_x, num = m[0][:-1], m[1][:-1]
        ss_y = m[0][-1]
        den = np.sqrt(ss_x * ss_y)
    else:
        y = np.asarray(y, dtype=np.float64)
        X = np.asarray(X, dtype=np.float64)
        n, d = X.shape
        xm = X.mean(axis=0)
        ym = y.mean()
        num = ((X - xm) * (y - ym)[:, None]).sum(axis=0)
        den = np.sqrt(((X - xm) ** 2).sum(axis=0) * ((y - ym) ** 2).sum())
    with np.errstate(divide="ignore", invalid="ignore"):
        corr = np.where(den > 0, num / den, 0.0)
    dfd = n - 2
    with np.errstate(divide="ignore", invalid="ignore"):
        f_stat = corr**2 / (1 - corr**2) * dfd
    f_stat = np.nan_to_num(f_stat, nan=0.0, posinf=np.inf)
    p = f_sf(f_stat, 1.0, float(dfd))
    return p, np.full(d, dfd, dtype=np.int64), f_stat
