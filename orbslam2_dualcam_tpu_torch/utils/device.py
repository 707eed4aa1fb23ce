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
