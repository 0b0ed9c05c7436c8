"""The comparison that decides `correct`: the sampled answers of the
window against the configuration's plain reference.

`Reference` runs the configuration's reference module
(`reference/<name>.py`, named by the configuration's `reference` key) over
the tables the benchmark made, in float64 ("float64") or in the control's
arithmetic ("tf32"); its fits are cached by their parameters, so every
answer of one grid point is judged against one reference fit. A check
(`checks/<name>.py`) reduces the answers and the reference to one number;
the cell's limits file (`limits/<cell>.json`) says which numbers are
compared and against what limit.

`control_answers` puts the reference in the program's place: the same
requests answered by the reference in the control's arithmetic, which
the same checks then judge.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from .load import Answer
from .plugins import plugin

#: rows of the table the reference scores at once
BLOCK_ROWS = 1 << 20


class Reference:
    """The configuration's reference over the benchmark's tables, in one
    arithmetic, its fits cached by their parameters."""

    def __init__(self, config: Dict, tensors: Dict, precision: str = "float64"):
        self.config = config
        self.module = plugin("reference", config["reference"])
        self.rows = self.module.as_rows(tensors, config["data"])
        self.arith = self.module.Arith(precision)
        self._fits: Dict = {}

    def params(self, point: Dict) -> Dict:
        return {**self.config["estimator"]["params"], **point}

    def fit(self, point: Dict) -> torch.Tensor:
        """The reference's coefficient for the estimator at `point`."""
        key = tuple(sorted(point.items()))
        if key not in self._fits:
            self._fits[key] = self.module.sgd_fit(self.rows, self.params(point), self.arith)
        return self._fits[key]

    def scores(self, point: Dict, lo: int, hi: int):
        """(lo, hi, dot, probability) blocks of rows [lo, hi) under the
        reference's fit at `point`."""
        coeff = self.fit(point)
        for b_lo in range(lo, hi, BLOCK_ROWS):
            b_hi = min(b_lo + BLOCK_ROWS, hi)
            dot, prob = self.module.logistic_scores(self.rows, coeff, self.arith, b_lo, b_hi)
            yield b_lo, b_hi, dot, prob


def output_names(config: Dict):
    """(prediction column, rawPrediction column) of the configuration's
    model."""
    p = config["estimator"]["params"]
    return p.get("predictionCol", "prediction"), p.get("rawPredictionCol", "rawPrediction")


def control_answers(answers: List[Answer], control: Reference) -> List[Answer]:
    """The answers the control gives to the same requests: its fitted
    coefficient, or its prediction and rawPrediction in float32."""
    pred_name, raw_name = output_names(control.config)
    out = []
    for a in answers:
        if a.request == "fit":
            value = control.fit(a.point).double().cpu().numpy()
        else:
            preds, raws = [], []
            for _, _, dot, prob in control.scores(a.point, a.lo, a.hi):
                preds.append((dot >= 0).to(torch.float32))
                raws.append(torch.stack([1.0 - prob, prob], dim=1).to(torch.float32))
            value = {pred_name: torch.cat(preds), raw_name: torch.cat(raws)}
        out.append(a._replace(value=value))
    return out


def measure(names, answers: List[Answer], reference: Reference) -> Dict[str, Optional[float]]:
    """Each check's number over the answers; None where it found none of
    its kind."""
    numbers = {}
    for name in names:
        value = plugin("checks", name).measure(answers, reference)
        numbers[name] = None if value is None else float(value)
    return numbers


def within(numbers: Dict[str, Optional[float]], limits: Dict[str, float]) -> bool:
    """Every number read, finite and at or under its limit: a number that
    cannot be read is within no limit."""
    return all(numbers[k] is not None and math.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in limits)
