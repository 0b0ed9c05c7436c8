"""One-transfer readback of several tensors.

Port of flink_ml_tpu/utils/packing.py (`:25`). `packed_device_get`
flattens the tensors into one vector of their promoted dtype with one
`torch.cat`, copies it to the host with one `.cpu()` and splits it there,
so a fit that returns (coefficient, loss, epochs) or a transform's guards
pay one synchronization, not one each.

A tensor counts as device data on any device (as the fusion planner
counts it), so the accounting is the same on the CPU, where the tests
read it, as on the card. Values are packed in the promoted dtype: integers
above 2**24 packed beside float32 lose precision, as in the JAX package.

A readback is two phases (`tracing.timed`): `readback.wait`, from the
call to the end of a synchronize of the packed tensor's stream (the
host's wait for every kernel queued before it, near zero on the CPU),
then `readback.copy`, from there to the host arrays (the transfer, the
split and the per-tensor copies). The JAX-named `readback` timer and
span hold their sum. The synchronize blocks no longer than the copy
after it would, and lets the untraced timers tell the two apart.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..obs import tracing


def packed_device_get(*tensors, sync_kind: str = "readback") -> List[np.ndarray]:
    """Host numpy copies of `tensors` through at most one transfer.

    Host inputs pass through as numpy arrays; the tensors are restored to
    their shapes and dtypes on the host. A call with a tensor is one
    blocking host-device synchronization, accounted as
    `iteration.host_sync.<sync_kind>`."""
    device_idx = [i for i, t in enumerate(tensors) if isinstance(t, torch.Tensor)]
    out: List = [None if i in device_idx else np.asarray(t) for i, t in enumerate(tensors)]
    if not device_idx:
        return out
    tracing.account_host_sync(sync_kind)
    devs = [tensors[i] for i in device_idx]
    dtype = devs[0].dtype
    for t in devs[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    with tracing.timed("readback.wait") as wait:
        flat = torch.cat([t.reshape(-1).to(dtype) for t in devs])
        _wait_for(flat)
    tracing.poll_device_timers()
    with tracing.timed("readback.copy") as copy:
        host = flat.cpu().numpy()
        offset = 0
        for i, t in zip(device_idx, devs):
            numpy_dtype = torch.empty((), dtype=t.dtype).numpy().dtype
            out[i] = host[offset:offset + t.numel()].reshape(tuple(t.shape)).astype(numpy_dtype)
            offset += t.numel()
    tracing.account_readback(host.nbytes, wait.seconds + copy.seconds, arrays=len(devs))
    return out


def _wait_for(flat: torch.Tensor) -> None:
    """Block until the card has run everything queued on `flat`'s stream
    (nothing to wait for off the card)."""
    if flat.is_cuda:
        torch.cuda.current_stream(flat.device).synchronize()


def packed_bytes_get(*tensors, sync_kind: str = "readback") -> List[np.ndarray]:
    """Host numpy copies of `tensors`, bit for bit in their own dtypes,
    through one transfer: the tensors' bytes are concatenated on their
    device (one uint8 buffer, no dtype promotion) and copied into one
    page-locked host buffer when they live on a card. Host inputs pass
    through. Accounted as one `iteration.host_sync.<sync_kind>`."""
    device_idx = [i for i, t in enumerate(tensors) if isinstance(t, torch.Tensor)]
    out: List = [None if i in device_idx else np.asarray(t) for i, t in enumerate(tensors)]
    if not device_idx:
        return out
    tracing.account_host_sync(sync_kind)
    devs = [tensors[i] for i in device_idx]
    with tracing.timed("readback.wait") as wait:
        flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8) for t in devs])
        _wait_for(flat)
    tracing.poll_device_timers()
    with tracing.timed("readback.copy") as copy:
        if flat.is_cuda:
            host_t = torch.empty(flat.numel(), dtype=torch.uint8, pin_memory=True)
            host_t.copy_(flat, non_blocking=True)
            torch.cuda.current_stream(flat.device).synchronize()
        else:
            host_t = flat
        host = host_t.numpy()
        offset = 0
        for i, t in zip(device_idx, devs):
            numpy_dtype = torch.empty((), dtype=t.dtype).numpy().dtype
            nbytes = t.numel() * t.element_size()
            out[i] = host[offset:offset + nbytes].view(numpy_dtype).reshape(tuple(t.shape)).copy()
            offset += nbytes
    tracing.account_readback(host.nbytes, wait.seconds + copy.seconds, arrays=len(devs))
    return out
