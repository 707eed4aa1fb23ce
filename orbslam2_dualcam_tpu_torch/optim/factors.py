"""Robust-kernel weights of the reprojection factors.

Port of the part of orbslam2_dualcam_tpu/optim/factors.py the motion-only
pose optimizer uses.
"""

from __future__ import annotations

import torch


def huber_weight(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    """IRLS weight of the Huber kernel on squared error: w = 1 inside,
    delta/sqrt(chi2) outside (g2o RobustKernelHuber semantics)."""
    return torch.where(chi2 <= delta2, torch.ones_like(chi2),
                       torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))
