"""Criteo-style sparse rows in the padded-CSR layout, born on the device
from the seed.

Each row holds `nnz` slots (Criteo's 39 fields: 13 counts and 26
categories, each hashed into one column): int32 column indices drawn
uniformly from [0, numFeatures), values uniform in [0, 1), labels 0 or 1
with even odds and no weight column. No slot is padding (-1) and no index
is out of range. Each column of the table comes from its own generator
on the device, in one call.
"""

from __future__ import annotations

import torch

from ..seeds import generator


def make(spec, seed: int, device: torch.device):
    """{"indices" (n, nnz) int32, "values" (n, nnz) float32, "label" (n,)
    float32}."""
    n, nnz, d = int(spec["numValues"]), int(spec["nnz"]), int(spec["numFeatures"])
    idx = torch.randint(0, d, (n, nnz), generator=generator(seed, "indices", device),
                        device=device, dtype=torch.int32)
    vals = torch.rand((n, nnz), generator=generator(seed, "values", device), device=device)
    y = torch.randint(0, 2, (n,), generator=generator(seed, "label", device),
                      device=device).to(torch.float32)
    return {"indices": idx, "values": vals, "label": y}


def columns(tensors, spec, program):
    """The program's columns: the features as a SparseBatch of
    numFeatures columns."""
    return {"features": program.sparse_column(int(spec["numFeatures"]), tensors["indices"],
                                              tensors["values"]),
            "label": tensors["label"]}
