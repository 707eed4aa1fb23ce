"""Shared helpers of the torch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages: the
JAX reference runs on JAX's CPU backend, the port on torch's CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam2_dualcam_tpu.utils import synthetic

# the suite runs 6 xdist workers on 8 cores: one torch thread each
torch.set_num_threads(1)


def small_K(H: int = 240, W: int = 320) -> np.ndarray:
    return np.array([[260.0 * W / 320, 0, W / 2], [0, 260.0 * H / 240, H / 2],
                     [0, 0, 1]])


def rendered_frame(seed: int = 0, H: int = 240, W: int = 320) -> np.ndarray:
    """A u8-valued float32 frame of the reference's textured box room."""
    world = synthetic.make_box_world(np.random.default_rng(seed), half=6.0,
                                     tex_size=256)
    img = synthetic.render(world, small_K(H, W), np.eye(4), H=H, W=W)
    return np.round(img).astype(np.float32)


def random_desc(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


def t(x, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype)
