"""Carry the reference's configuration and state into the port.

The tracking step has no weights: its state is the camera rig, the
vocabulary tree and the map store.  These converters take the reference's
NamedTuples with numpy leaves (``np.asarray`` of each jax leaf, done by the
caller) and place them on a torch device, so tests feed both packages the
same state.  `device=None` is the current CUDA device (utils/device.py).
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from orbslam2_dualcam_tpu_torch.ops.camera import CameraRig
from orbslam2_dualcam_tpu_torch.utils import config as _config
from orbslam2_dualcam_tpu_torch.utils.device import resolve_device
from orbslam2_dualcam_tpu_torch.vocab.bow import Vocabulary


def _dataclass_from_dict(cls, d: dict):
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    if names != set(d):
        raise ValueError(f"{cls.__name__}: fields differ from the port's: "
                         f"{sorted(names ^ set(d))}")
    kw = {}
    for name in names:
        t, v = hints[name], d[name]
        args = typing.get_args(t)
        if dataclasses.is_dataclass(t):
            v = _dataclass_from_dict(t, v)
        elif typing.get_origin(t) is tuple and dataclasses.is_dataclass(args[0]):
            v = tuple(_dataclass_from_dict(args[0], x) for x in v)
        kw[name] = v
    return cls(**kw)


def config_from_reference(cfg):
    """A config object of the JAX package (SystemConfig or any of its
    parts) -> the port's dataclass of the same name with the same field
    values.  The object is read through `dataclasses.asdict`; its module
    is never imported."""
    cls = getattr(_config, type(cfg).__name__, None)
    if cls is None or not dataclasses.is_dataclass(cls):
        raise TypeError(f"no config dataclass named {type(cfg).__name__}")
    return _dataclass_from_dict(cls, dataclasses.asdict(cfg))


def desc_to_torch(desc: np.ndarray, device=None) -> torch.Tensor:
    """uint32 [..., 8] descriptors -> int32 tensor with the same bits."""
    return torch.as_tensor(np.array(desc, np.uint32).view(np.int32),
                           device=resolve_device(device))


def desc_to_numpy(desc: torch.Tensor) -> np.ndarray:
    """int32 descriptor words -> uint32 numpy with the same bits."""
    return desc.detach().cpu().numpy().view(np.uint32)


def rig_from_numpy(rig, device=None) -> CameraRig:
    """Reference CameraRig whose leaves are numpy arrays -> port CameraRig
    of float32 tensors on `device`."""
    device = resolve_device(device)
    return CameraRig(*(torch.as_tensor(np.array(x, np.float32), device=device)
                       for x in rig))


def vocab_from_numpy(voc, device=None) -> Vocabulary:
    """Reference Vocabulary (centroids tuple of uint32 [k^(l+1), 8], idf,
    optional word_map, as numpy) -> port Vocabulary on `device`."""
    device = resolve_device(device)
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
