"""The widest gap of a served score: over the rows of the sampled
transform answers, the largest of |raw[:, 1] - p_ref|,
|raw[:, 0] - (1 - p_ref)| and, where the served prediction is not the
reference's label (p_ref >= 1/2), |p_ref - 1/2|: how far the reference's
probability lies on the other side. raw is the served rawPrediction,
p_ref the float64 reference's probability of label 1."""

import torch

from portbench.compare import output_names


def measure(answers, reference):
    pred_name, raw_name = output_names(reference.config)
    worst = None
    for a in answers:
        if a.request != "transform":
            continue
        raw, pred = a.value[raw_name], a.value[pred_name]
        gap = 0.0
        for lo, hi, dot, prob in reference.scores(a.point, a.lo, a.hi):
            got = raw[lo - a.lo:hi - a.lo].to(device=prob.device, dtype=torch.float64)
            label = pred[lo - a.lo:hi - a.lo].to(device=prob.device, dtype=torch.float64)
            wrong = label != (dot >= 0).to(torch.float64)
            gap = max(gap, float((got[:, 1] - prob).abs().max()),
                      float((got[:, 0] - (1.0 - prob)).abs().max()),
                      float(torch.where(wrong, (prob - 0.5).abs(), 0.0).max()))
        worst = gap if worst is None else max(worst, gap)
    return worst
