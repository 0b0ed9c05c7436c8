"""BinaryClassificationEvaluator — AUC / AUPR / KS / Lorenz metrics.

Port of flink_ml_tpu/models/evaluation/binaryclassification.py (the
reference's BinaryClassificationEvaluator.java:79-401: the metrics
areaUnderROC, areaUnderPR, ks and areaUnderLorenz over (label,
rawPrediction[, weight])). The whole computation is one sorted pass on
the card (`binary_metrics_device`): a stable sort of the scores, prefix
sums, the previous tie group found by a running maximum, the tie-aware
average-rank AUC, and one packed readback of the four numbers.
`binary_metrics` is the float64 numpy oracle, the plain version.

Precision (ROADMAP C.11): the scores are sorted as float32, as the JAX
device path sorts them, so the tie groups are the same; every prefix sum
and sum then runs in float64 on the card, which matches the float64 oracle
(the reference's double precision) to ~1e-12 where the JAX package's
float32 pass drifts up to 1e-3 at 500k rows with heavy ties.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ... import config
from ...api import AlgoOperator
from ...common.param import HasLabelCol, HasRawPredictionCol, HasWeightCol
from ...parallel.prefetch import to_device
from ...param import ParamValidators, StringArrayParam
from ...table import Table

# numpy 2 renamed trapz -> trapezoid; support both
_trapezoid = getattr(np, "trapezoid", None) or np.trapz

AREA_UNDER_ROC = "areaUnderROC"
AREA_UNDER_PR = "areaUnderPR"
AREA_UNDER_LORENZ = "areaUnderLorenz"
KS = "ks"
#: the order of the packed readback
METRICS = (AREA_UNDER_ROC, AREA_UNDER_PR, AREA_UNDER_LORENZ, KS)


class BinaryClassificationEvaluatorParams(HasLabelCol, HasRawPredictionCol, HasWeightCol):
    METRICS_NAMES = StringArrayParam(
        "metricsNames",
        "Names of the output metrics.",
        [AREA_UNDER_ROC, AREA_UNDER_PR],
        ParamValidators.is_sub_set([AREA_UNDER_ROC, AREA_UNDER_PR, KS, AREA_UNDER_LORENZ]),
    )

    def get_metrics_names(self):
        return self.get(self.METRICS_NAMES)

    def set_metrics_names(self, *values: str):
        return self.set(self.METRICS_NAMES, list(values))


def binary_metrics(scores: np.ndarray, labels: np.ndarray, weights: np.ndarray):
    """All four metrics in one sorted pass, in float64 numpy.

    AUC uses the reference's weighted rank-sum (AccumulateMultiScoreOperator:
    integer sample ranks averaged per tied-score group, each group
    contributing avgRank * groupPositiveWeight; then
    (sum - P*(P+1)/2) / (P*N) with P/N = total positive/negative weight).
    The curve metrics accumulate weighted counts per unique score threshold
    (updateBinaryMetrics)."""
    order = np.argsort(-scores, kind="stable")
    s, y, w = scores[order], labels[order], weights[order]
    pos = w * (y == 1.0)
    neg = w * (y != 1.0)
    total_pos = pos.sum()
    total_neg = neg.sum()
    cum_pos = np.cumsum(pos)
    cum_neg = np.cumsum(neg)
    cum_all = cum_pos + cum_neg
    total = total_pos + total_neg

    tpr = cum_pos / total_pos if total_pos > 0 else np.ones_like(cum_pos)
    fpr = cum_neg / total_neg if total_neg > 0 else np.ones_like(cum_neg)
    rate = cum_all / total

    # Threshold points: only at the LAST row of each tied score group.
    n = s.shape[0]
    is_last = np.empty(n, dtype=bool)
    is_last[:-1] = s[:-1] != s[1:]
    is_last[-1] = True
    tpr_pts = np.concatenate([[0.0], tpr[is_last]])
    fpr_pts = np.concatenate([[0.0], fpr[is_last]])
    rate_pts = np.concatenate([[0.0], rate[is_last]])
    with np.errstate(invalid="ignore", divide="ignore"):
        prec_pts = np.where(
            (cum_pos + cum_neg) > 0, cum_pos / (cum_pos + cum_neg), 1.0
        )[is_last]
    prec_pts = np.concatenate([[1.0], prec_pts])

    # Weighted rank-sum AUC: ranks ascend from the lowest score (1..n).
    ranks = np.arange(n, 0, -1, dtype=np.float64)  # descending order -> rank
    group_id = np.concatenate([[0], np.cumsum(is_last[:-1])])
    num_groups = group_id[-1] + 1
    group_rank_sum = np.bincount(group_id, weights=ranks, minlength=num_groups)
    group_count = np.bincount(group_id, minlength=num_groups)
    group_pos_w = np.bincount(group_id, weights=pos, minlength=num_groups)
    rank_sum = float(np.sum(group_rank_sum / group_count * group_pos_w))
    if total_pos > 0 and total_neg > 0:
        auc = (rank_sum - total_pos * (total_pos + 1) / 2.0) / (total_pos * total_neg)
    else:
        auc = float("nan")

    aupr = float(_trapezoid(prec_pts, tpr_pts))
    lorenz = float(_trapezoid(tpr_pts, rate_pts))
    ks = float(np.max(np.abs(tpr_pts - fpr_pts)))
    return {
        AREA_UNDER_ROC: float(auc),
        AREA_UNDER_PR: aupr,
        AREA_UNDER_LORENZ: lorenz,
        KS: ks,
    }


def binary_metrics_device(scores: torch.Tensor, labels: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """The four metrics of `binary_metrics` as one pass on the scores'
    device, packed as float64 [auc, aupr, lorenz, ks] for one readback.

    The oracle compacts the threshold points with a boolean mask (a shape
    known only after a sync). Here every row carries its tie group's
    values and rows other than a group's last contribute zero: the
    previous threshold point of a row is the last row of the previous
    group, gathered at (start of group - 1), the start of group being a
    running maximum of the group starts. The scores are sorted and grouped
    as float32 (the JAX device path's ties); labels and weights are read in
    float64 and every sum is float64."""
    f = torch.float64
    n = scores.shape[0]
    order = torch.sort(-scores.to(torch.float32), stable=True).indices
    s = scores.to(torch.float32)[order]
    y = labels[order].to(f)
    w = weights[order].to(f)
    pos = w * (y == 1.0)
    neg = w * (y != 1.0)
    total_pos = pos.sum()
    total_neg = neg.sum()
    total = total_pos + total_neg
    cum_pos = torch.cumsum(pos, dim=0)
    cum_neg = torch.cumsum(neg, dim=0)
    cum_all = cum_pos + cum_neg

    one = torch.ones((), dtype=f, device=scores.device)
    tpr = torch.where(total_pos > 0, cum_pos / total_pos, one)
    fpr = torch.where(total_neg > 0, cum_neg / total_neg, one)
    rate = cum_all / total
    prec = torch.where(cum_all > 0, cum_pos / cum_all, one)

    idx = torch.arange(n, device=scores.device)
    change = s[:-1] != s[1:]
    true = torch.ones(1, dtype=torch.bool, device=scores.device)
    is_last = torch.cat([change, true])
    is_first = torch.cat([true, change])
    sog = torch.cummax(torch.where(is_first, idx, 0), dim=0).values  # start of group
    prev = torch.clamp(sog - 1, min=0)  # last row of the previous group
    first_group = sog == 0
    zero = torch.zeros((), dtype=f, device=scores.device)
    tpr_prev = torch.where(first_group, zero, tpr[prev])
    rate_prev = torch.where(first_group, zero, rate[prev])
    prec_prev = torch.where(first_group, one, prec[prev])

    lastf = is_last.to(f)
    aupr = torch.sum(lastf * (tpr - tpr_prev) * (prec + prec_prev) * 0.5)
    lorenz = torch.sum(lastf * (rate - rate_prev) * (tpr + tpr_prev) * 0.5)
    ks = torch.max(lastf * torch.abs(tpr - fpr))

    # weighted rank-sum AUC: per tied-score group, the average integer rank
    # (ranks ascend from the lowest score) times the group's positive
    # weight. A group's ranks are consecutive integers, so the average is
    # the arithmetic-series midpoint: no prefix sum of ranks
    avg_rank = ((n - sog).to(f) + (n - idx).to(f)) * 0.5
    cum_pos_prev = torch.where(first_group, zero, cum_pos[prev])
    group_pos_w = cum_pos - cum_pos_prev
    rank_sum = torch.sum(lastf * avg_rank * group_pos_w)
    auc = torch.where(
        (total_pos > 0) & (total_neg > 0),
        (rank_sum - total_pos * (total_pos + 1) / 2.0)
        / torch.clamp(total_pos * total_neg, min=1e-30),
        torch.full((), float("nan"), dtype=f, device=scores.device),
    )
    return torch.stack([auc, aupr, lorenz, ks])


def _on(col, device: torch.device) -> torch.Tensor:
    """A column of numbers on `device`: a tensor as it is, a host column
    in float64."""
    if isinstance(col, torch.Tensor):
        return to_device(col, device)
    return to_device(np.asarray(col, dtype=np.float64), device)


class BinaryClassificationEvaluator(AlgoOperator, BinaryClassificationEvaluatorParams):
    fusable = False
    fusable_reason = "aggregating evaluator: reduces the whole input to one metrics row — not a row-count-preserving record-wise transform"

    def transform(self, *inputs: Table) -> List[Table]:
        device = config.device()  # an entry point: no silent CPU without a request
        (table,) = inputs
        labels_col = table.column(self.get_label_col())
        raw = table.column(self.get_raw_prediction_col())
        if isinstance(raw, torch.Tensor) and raw.ndim == 2:
            if raw.shape[1] < 2:
                raise IndexError(f"rawPrediction needs >= 2 columns, got {raw.shape[1]}")
            scores = raw[:, 1]  # device predictions stay on their device
            device = scores.device
        else:
            if isinstance(raw, torch.Tensor):
                raw = raw.cpu().numpy()
            raw_arr = np.asarray(
                raw if not hasattr(raw, "to_dense") else raw.to_dense(),
                dtype=np.float64,
            )
            if raw_arr.ndim == 2:
                scores = raw_arr[:, 1]  # probability of class 1
            else:
                scores = raw_arr
        weight_col = self.get_weight_col()
        n = int(np.shape(scores)[0])
        weights = (torch.ones(n, dtype=torch.float64, device=device) if weight_col is None
                   else _on(table.column(weight_col), device))
        # tpulint: disable=host-sync-leak -- the evaluation's one readback
        packed = binary_metrics_device(_on(scores, device), _on(labels_col, device),
                                       weights).cpu().numpy()
        metrics = dict(zip(METRICS, (float(v) for v in packed)))
        names = self.get_metrics_names()
        return [Table({name: [metrics[name]] for name in names})]
