"""Carry the reference's state into the port.

The tracking step has no weights: its state is the camera rig, the
vocabulary tree and the map store.  These converters take the reference's
NamedTuples with numpy leaves (``np.asarray`` of each jax leaf, done by the
caller) and place them on a torch device, so tests feed both packages the
same state.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam2_dualcam_tpu_torch.ops.camera import CameraRig
from orbslam2_dualcam_tpu_torch.vocab.bow import Vocabulary


def desc_to_torch(desc: np.ndarray, device="cpu") -> torch.Tensor:
    """uint32 [..., 8] descriptors -> int32 tensor with the same bits."""
    return torch.as_tensor(np.array(desc, np.uint32).view(np.int32),
                           device=device)


def desc_to_numpy(desc: torch.Tensor) -> np.ndarray:
    """int32 descriptor words -> uint32 numpy with the same bits."""
    return desc.detach().cpu().numpy().view(np.uint32)


def rig_from_numpy(rig, device) -> CameraRig:
    """Reference CameraRig whose leaves are numpy arrays -> port CameraRig
    of float32 tensors on `device`."""
    return CameraRig(*(torch.as_tensor(np.array(x, np.float32), device=device)
                       for x in rig))


def vocab_from_numpy(voc, device) -> Vocabulary:
    """Reference Vocabulary (centroids tuple of uint32 [k^(l+1), 8], idf,
    optional word_map, as numpy) -> port Vocabulary on `device`."""
    wm = voc.word_map
    return Vocabulary(
        branching=int(voc.branching), depth=int(voc.depth),
        centroids=tuple(desc_to_torch(np.asarray(c), device)
                        for c in voc.centroids),
        idf=torch.as_tensor(np.array(voc.idf, np.float32), device=device),
        direct_level=int(voc.direct_level),
        word_map=None if wm is None else torch.as_tensor(
            np.array(wm, np.int64), device=device),
        n_words_leaves=int(voc.n_words_leaves))
