"""orbslam2_dualcam_tpu_torch — the PyTorch/CUDA port of orbslam2_dualcam_tpu.

The JAX package beside this one is the reference: every module here mirrors
its counterpart's layout and function names, and the tests hold the two
against each other on identical numpy inputs.  This package imports torch
and numpy, never jax.

What is ported so far is the fused per-frame dual-camera tracking step
(`pipeline.frontend.make_track_fn`) and its D-frame batched form
(`make_track_batch_fn`): ORB extraction on both cameras, BoW
quantization, motion-model projection matching with the widened retry,
motion-only pose optimization, the local-map rematch and the velocity
update.  The dense FAST + NMS stage runs as a hand-written CUDA kernel on
the card, one launch for a frame's whole pyramid (`ops.fast_nms`,
`csrc/fast_nms.cu`).  Entry points that take a `device` run on the current
CUDA device unless the caller names another (`utils.device`).
"""

__version__ = "0.2.0"

from orbslam2_dualcam_tpu_torch.utils.config import (  # noqa: F401
    BAConfig,
    CameraConfig,
    CapacityConfig,
    InitConfig,
    LoopConfig,
    MappingConfig,
    MatcherConfig,
    OrbConfig,
    SystemConfig,
    TrackerConfig,
    VocabConfig,
    dual_default,
)
