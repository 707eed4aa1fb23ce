"""The device rule of the port's entry points.

An entry point that takes a `device` runs on the card unless the caller
asks for another device: ``device=None`` means the current CUDA device and
raises where there is none.  It never falls back to the CPU; the CPU tests
pass ``device="cpu"``.
"""

from __future__ import annotations

import torch

from orbslam2_dualcam_tpu_torch.utils.profiling import span


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
    their bits as int32 (torch has no arithmetic on uint32).  A span
    `device.upload` with its `bytes`: from pageable memory the copy may
    block the host."""
    import numpy as np

    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    with span("device.upload", bytes=a.nbytes):
        return torch.as_tensor(a).to(device, non_blocking=True)


def to_host(tensors) -> list:
    """Tensors -> numpy arrays with ONE wait for the card (a `.cpu()` per
    leaf would wait once per leaf): `Readback(tensors).wait()`."""
    return Readback(tensors).wait()


class Readback:
    """A readback that waits for its own copies only.

    Made at dispatch time: every leaf is copied into pinned host memory
    without blocking, and a CUDA event is recorded after the copies.
    `wait()` synchronizes that event alone, so work queued on the stream
    after the readback (the next frame's dispatch) is not waited for, and
    returns numpy arrays.  On CPU tensors the copies are made at once and
    `wait()` returns them."""

    def __init__(self, tensors) -> None:
        tensors = [t.detach() for t in tensors]
        self._event = None
        if not tensors or tensors[0].device.type != "cuda":
            self._arrays = [t.numpy().copy() for t in tensors]
            return
        bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for b, t in zip(bufs, tensors):
            b.copy_(t, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(tensors[0].device))
        self._arrays = [b.numpy() for b in bufs]

    def wait(self) -> list:
        """A span `device.wait` of kind `readback`, on the CPU too (where
        it waits for nothing), so that a run counts its readbacks alike
        on either device."""
        with span("device.wait", kind="readback"):
            if self._event is not None:
                # releases the interpreter lock while it waits, so the
                # mapping thread runs meanwhile
                self._event.synchronize()
                self._event = None
        return self._arrays
