"""float64 special functions for p-values: regularized incomplete gamma/beta.

Port of flink_ml_tpu/ops/special.py, copied as it stands so that both
packages give the same bits: the standard continued-fraction / series
evaluations of the regularized incomplete gamma P(a,x) and regularized
incomplete beta I_x(a,b) in numpy float64 (the reference uses
commons-math in double precision), vectorized over the last axis. Host
only: the statistical tests read back a few numbers a feature and finish
their p-values here.
"""

from __future__ import annotations

import numpy as np
from numpy import log, exp
from math import lgamma

_MAX_ITER = 300
_EPS = 3e-14
_FPMIN = 1e-300


def _gamma_series(a: float, x: float) -> float:
    """P(a,x) by series expansion (x < a+1)."""
    ap = a
    summ = 1.0 / a
    delta = summ
    for _ in range(_MAX_ITER):
        ap += 1.0
        delta *= x / ap
        summ += delta
        if abs(delta) < abs(summ) * _EPS:
            break
    return summ * exp(-x + a * log(x) - lgamma(a))


def _gamma_cf(a: float, x: float) -> float:
    """Q(a,x) by continued fraction (x >= a+1)."""
    b = x + 1.0 - a
    c = 1.0 / _FPMIN
    d = 1.0 / b
    h = d
    for i in range(1, _MAX_ITER + 1):
        an = -i * (i - a)
        b += 2.0
        d = an * d + b
        if abs(d) < _FPMIN:
            d = _FPMIN
        c = b + an / c
        if abs(c) < _FPMIN:
            c = _FPMIN
        d = 1.0 / d
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < _EPS:
            break
    return exp(-x + a * log(x) - lgamma(a)) * h


def gammainc_p(a, x):
    """Regularized lower incomplete gamma P(a, x), elementwise float64."""
    a = np.asarray(a, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    out = np.empty(np.broadcast(a, x).shape, dtype=np.float64)
    flat_a = np.broadcast_to(a, out.shape).ravel()
    flat_x = np.broadcast_to(x, out.shape).ravel()
    flat_out = out.ravel()
    for i, (ai, xi) in enumerate(zip(flat_a, flat_x)):
        if xi <= 0.0:
            flat_out[i] = 0.0
        elif xi < ai + 1.0:
            flat_out[i] = _gamma_series(ai, xi)
        else:
            flat_out[i] = 1.0 - _gamma_cf(ai, xi)
    return out if out.shape else float(out)


def _betacf(a: float, b: float, x: float) -> float:
    qab = a + b
    qap = a + 1.0
    qam = a - 1.0
    c = 1.0
    d = 1.0 - qab * x / qap
    if abs(d) < _FPMIN:
        d = _FPMIN
    d = 1.0 / d
    h = d
    for m in range(1, _MAX_ITER + 1):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        if abs(d) < _FPMIN:
            d = _FPMIN
        c = 1.0 + aa / c
        if abs(c) < _FPMIN:
            c = _FPMIN
        d = 1.0 / d
        h *= d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        if abs(d) < _FPMIN:
            d = _FPMIN
        c = 1.0 + aa / c
        if abs(c) < _FPMIN:
            c = _FPMIN
        d = 1.0 / d
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < _EPS:
            break
    return h


def betainc_reg(a, b, x):
    """Regularized incomplete beta I_x(a, b), elementwise float64."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    out = np.empty(np.broadcast(a, b, x).shape, dtype=np.float64)
    flat_a = np.broadcast_to(a, out.shape).ravel()
    flat_b = np.broadcast_to(b, out.shape).ravel()
    flat_x = np.broadcast_to(x, out.shape).ravel()
    flat_out = out.ravel()
    for i, (ai, bi, xi) in enumerate(zip(flat_a, flat_b, flat_x)):
        if xi <= 0.0:
            flat_out[i] = 0.0
        elif xi >= 1.0:
            flat_out[i] = 1.0
        else:
            front = exp(
                lgamma(ai + bi) - lgamma(ai) - lgamma(bi)
                + ai * log(xi) + bi * log(1.0 - xi)
            )
            if xi < (ai + 1.0) / (ai + bi + 2.0):
                flat_out[i] = front * _betacf(ai, bi, xi) / ai
            else:
                flat_out[i] = 1.0 - front * _betacf(bi, ai, 1.0 - xi) / bi
    return out if out.shape else float(out)
