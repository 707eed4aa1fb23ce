"""orbslam2_dualcam_tpu_torch — the PyTorch/CUDA port of orbslam2_dualcam_tpu.

The JAX package beside this one is the reference: every module here mirrors
its counterpart's layout and function names, and the tests hold the two
against each other on identical numpy inputs.  This package imports torch
and numpy, never jax.

What is ported so far is the fused per-frame dual-camera tracking step
(`pipeline.frontend.make_track_fn`): ORB extraction on both cameras, BoW
quantization, motion-model projection matching with the widened retry,
motion-only pose optimization, the local-map rematch and the velocity
update.  The dense FAST + NMS stage runs as a hand-written CUDA kernel on
the card (`ops.fast_nms`, `csrc/fast_nms.cu`).
"""

__version__ = "0.1.0"

from orbslam2_dualcam_tpu.utils.config import (  # noqa: F401
    BAConfig,
    CameraConfig,
    MatcherConfig,
    OrbConfig,
    SystemConfig,
    TrackerConfig,
    VocabConfig,
    dual_default,
)
