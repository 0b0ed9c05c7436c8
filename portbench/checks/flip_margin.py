"""The widest margin of a wrong label: over the rows of the sampled
transform answers whose served prediction is not the reference's label
(dot >= 0), the largest |dot_ref| as a share of the largest |dot_ref| of
those rows; 0 where every label agrees.

A row whose reference dot lies within the arithmetic's error of 0 may
take either label; a label served wrong by more than that margin is
wrong."""

import torch

from portbench.compare import output_names


def measure(answers, reference):
    pred_name, _ = output_names(reference.config)
    worst = None
    for a in answers:
        if a.request != "transform":
            continue
        served = a.value[pred_name]
        scale, margin = 0.0, 0.0
        for lo, hi, dot, _ in reference.scores(a.point, a.lo, a.hi):
            got = served[lo - a.lo:hi - a.lo].to(dot.device)
            wrong = got != (dot >= 0).to(got.dtype)
            scale = max(scale, float(dot.abs().max()))
            if bool(wrong.any()):
                margin = max(margin, float(dot.abs()[wrong].max()))
        share = margin / scale if scale > 0 else (1.0 if margin > 0 else 0.0)
        worst = share if worst is None else max(worst, share)
    return worst
