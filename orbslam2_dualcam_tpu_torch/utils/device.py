"""The device rule of the port's entry points.

An entry point that takes a `device` runs on the card unless the caller
asks for another device: ``device=None`` means the current CUDA device and
raises where there is none.  It never falls back to the CPU; the CPU tests
pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device with its index filled in; None is the
    current CUDA device (RuntimeError without one)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "orbslam2_dualcam_tpu_torch: no CUDA device is available and no "
                "device was named; pass device=\"cpu\" to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def upload(a, device) -> torch.Tensor:
    """numpy array -> tensor on `device`; uint32 descriptor words keep
    their bits as int32 (torch has no arithmetic on uint32)."""
    import numpy as np

    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(a).to(device, non_blocking=True)


def to_host(tensors) -> list:
    """Tensors -> numpy arrays with ONE wait for the card: every leaf is
    copied into pinned host memory without blocking, then the stream is
    synchronized once (a `.cpu()` per leaf would wait once per leaf).  CPU
    tensors are returned as views."""
    tensors = [t.detach() for t in tensors]
    if not tensors or tensors[0].device.type != "cuda":
        return [t.numpy() for t in tensors]
    bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for b, t in zip(bufs, tensors):
        b.copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [b.numpy() for b in bufs]
