"""Device selection for the PyTorch port.

The port runs on the CUDA card unless the caller asks for the CPU. With no
card and no explicit request it raises: nothing falls back to the CPU
quietly. Host (numpy) columns are staged to `device()`; torch tensor
columns stay on the device they already live on.

The JAX package's TPU knobs (whole-fit, fleet, collectives, serving,
compile bank) have no counterpart here yet.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Optional, Union

import torch

_override: Optional[torch.device] = None


def device() -> torch.device:
    """The device host inputs are staged to: the scoped `use_device`
    choice, else the current CUDA device. Raises when neither exists."""
    if _override is not None:
        return _override
    if not torch.cuda.is_available():
        raise RuntimeError(
            "flink_ml_tpu_torch needs a CUDA device; none is available. "
            "Run under config.use_device('cpu') to compute on the CPU."
        )
    return torch.device("cuda", torch.cuda.current_device())


@contextmanager
def use_device(dev: Union[str, torch.device]) -> Iterator[torch.device]:
    """Scoped device choice, e.g. `with use_device("cpu"): ...`."""
    global _override
    dev = torch.device(dev)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("use_device('cuda') but no CUDA device is available")
    prev = _override
    _override = dev
    try:
        yield dev
    finally:
        _override = prev
