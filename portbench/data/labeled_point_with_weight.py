"""Dense labeled points with weights, born on the device from the seed.

A copy of the device path of Flink ML's LabeledPointWithWeightGenerator
(flink-ml-benchmark's common/LabeledPointWithWeightGenerator.java) as the
port draws it: features uniform in [0, 1) (featureArity 0) or integers in
[0, featureArity) as floats; the label an integer in [0, labelArity) as a
float; the weight uniform in [0, 1). Each column comes from its own
generator on the device, in one call, in float32, the dtype the estimator
trains in.
"""

from __future__ import annotations

import torch

from ..seeds import generator


def make(spec, seed: int, device: torch.device):
    """{"features" (n, d), "label" (n,), "weight" (n,)} float32 tensors."""
    n, d = int(spec["numValues"]), int(spec["vectorDim"])
    arity = int(spec["featureArity"])
    if arity == 0:
        X = torch.rand((n, d), generator=generator(seed, "features", device), device=device)
    else:
        X = torch.randint(0, arity, (n, d), generator=generator(seed, "features", device),
                          device=device).to(torch.float32)
    y = torch.randint(0, int(spec["labelArity"]), (n,),
                      generator=generator(seed, "label", device), device=device).to(torch.float32)
    w = torch.rand((n,), generator=generator(seed, "weight", device), device=device)
    return {"features": X, "label": y, "weight": w}


def columns(tensors, spec, program):
    """The program's columns: the tensors as they are."""
    return dict(tensors)
