"""Carry the reference's configuration and state into the port.

The system has no weights: its state is the camera rig, the vocabulary
tree, the map (keyframes, points, observations) and, per call, a packed BA
problem.  These converters take the reference's
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
    optional word_map, as numpy) -> port Vocabulary on `device`.  The idf
    table is all `sparse_bow` needs of it; its host copy is made on first
    use (vocab/bow.py)."""
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


def map_from_reference(ref_map):
    """A Map of the JAX package (keyframes, points, observations,
    covisibility, counters; all numpy and plain Python) -> the port's Map
    with equal content.  Arrays and dicts are copied, so the two maps can
    then be driven independently; observers (`on_erase_keyframe`) are not
    carried over."""
    import copy

    from orbslam2_dualcam_tpu_torch.models.map import KeyFrame, Map, MapPoint

    def rebuild(cls, obj):
        return cls(**{f.name: copy.deepcopy(getattr(obj, f.name))
                      for f in dataclasses.fields(cls)})

    m = Map()
    m.keyframes = {k: rebuild(KeyFrame, kf) for k, kf in ref_map.keyframes.items()}
    m.points = {k: rebuild(MapPoint, mp) for k, mp in ref_map.points.items()}
    for name in ("next_kid", "next_mid", "origin_kid", "big_change_idx",
                 "map_scaled", "first_scale_kid", "geometry_epoch"):
        setattr(m, name, getattr(ref_map, name))
    m.culled_redirect = copy.deepcopy(ref_map.culled_redirect)
    return m


def kfdb_from_reference(ref_kfdb):
    """A KeyFrameDatabase of the JAX package -> the port's with equal
    postings and BoW vectors.  The reference must have been built with its
    pure-Python index (`use_native=False`): the C++ index cannot be read
    back.  The port's database is made with its Python postings too, which
    are written here directly."""
    from orbslam2_dualcam_tpu_torch.models.kfdb import KeyFrameDatabase
    from orbslam2_dualcam_tpu_torch.vocab.bow import SparseBow

    if getattr(ref_kfdb, "native", None) is not None:
        raise ValueError("kfdb_from_reference: the reference database uses "
                         "its C++ index; build it with use_native=False")
    db = KeyFrameDatabase(ref_kfdb.n_cameras, ref_kfdb.n_words,
                          use_native=False)
    for cam in range(ref_kfdb.n_cameras):
        for w, kids in ref_kfdb.inverted[cam].items():
            if kids:
                db.inverted[cam][int(w)] = set(kids)
        for kid, vec in ref_kfdb.bow[cam].items():
            db.bow[cam][kid] = SparseBow(np.array(vec.words),
                                         np.array(vec.weights))
    return db


def ba_problem_from_numpy(prob, device=None):
    """Reference BAProblem whose leaves are numpy arrays -> the port's, on
    `device` (indices as int64)."""
    from orbslam2_dualcam_tpu_torch.optim.ba import BAProblem
    from orbslam2_dualcam_tpu_torch.optim.factors import Edges

    device = resolve_device(device)

    def dev(a, dtype):
        return torch.as_tensor(np.array(a, dtype), device=device)

    e = prob.edges
    edges = Edges(kf=dev(e.kf, np.int64), mp=dev(e.mp, np.int64),
                  cam=dev(e.cam, np.int64), uv=dev(e.uv, np.float32),
                  inv_sigma2=dev(e.inv_sigma2, np.float32),
                  valid=dev(e.valid, bool))
    return BAProblem(poses=dev(prob.poses, np.float32),
                     points=dev(prob.points, np.float32), edges=edges,
                     pose_valid=dev(prob.pose_valid, bool),
                     pose_fixed=dev(prob.pose_fixed, bool),
                     point_valid=dev(prob.point_valid, bool))
