"""Map checkpoint / restore.

Port of orbslam2_dualcam_tpu/utils/checkpoint.py.  The archive format is
the reference's, key for key (the same arrays, the same ``__meta__``
JSON), so a map saved by either package loads in the other.

The original leaves SaveMap/LoadMap as an unimplemented TODO
(System.h:107-109); here the full SLAM state (keyframes with features and
graph topology, map points with observation records, counters, scale
flags) round-trips through a single compressed .npz archive, so a later
run can resume tracking/localization against a previously built map."""

from __future__ import annotations

import json

import numpy as np

from orbslam2_dualcam_tpu_torch.models.kfdb import KeyFrameDatabase
from orbslam2_dualcam_tpu_torch.models.map import KeyFrame, Map, MapPoint
from orbslam2_dualcam_tpu_torch.vocab import bow


def save_map(m: Map, path: str) -> None:
    kids = sorted(m.keyframes.keys())
    mids = sorted(m.points.keys())
    arrays = {}
    meta = {
        "next_kid": m.next_kid, "next_mid": m.next_mid,
        "origin_kid": m.origin_kid, "map_scaled": m.map_scaled,
        "first_scale_kid": m.first_scale_kid,
        "kids": kids, "mids": mids,
    }
    kf_json = {}
    for kid in kids:
        kf = m.keyframes[kid]
        arrays[f"kf{kid}_T"] = kf.T_cw
        arrays[f"kf{kid}_uv"] = kf.uv
        arrays[f"kf{kid}_cam"] = kf.kp_cam
        arrays[f"kf{kid}_level"] = kf.level
        arrays[f"kf{kid}_angle"] = kf.angle
        arrays[f"kf{kid}_desc"] = kf.desc
        arrays[f"kf{kid}_valid"] = kf.kp_valid
        arrays[f"kf{kid}_mp"] = kf.mp_idx
        if kf.word is not None:
            arrays[f"kf{kid}_word"] = kf.word
            arrays[f"kf{kid}_node"] = kf.node
        kf_json[str(kid)] = {
            "frame_id": kf.frame_id, "parent": kf.parent,
            "children": sorted(kf.children),
            "covis": kf.covis, "loop_edges": sorted(kf.loop_edges),
            "scaled": kf.scaled,
            "connected_to_second_map": kf.connected_to_second_map,
        }
    mp_json = {}
    for mid in mids:
        mp = m.points[mid]
        arrays[f"mp{mid}_pos"] = mp.pos
        arrays[f"mp{mid}_normal"] = mp.normal
        arrays[f"mp{mid}_desc"] = mp.desc
        mp_json[str(mid)] = {
            "obs": mp.obs, "obs_cam": mp.obs_cam,
            "first_view_cam": mp.first_view_cam,
            "min_dist": mp.min_dist, "max_dist": mp.max_dist,
            "n_visible": mp.n_visible, "n_found": mp.n_found,
            "ref_kid": mp.ref_kid, "first_kf_id": mp.first_kf_id,
        }

    def _py(o):
        if isinstance(o, (np.integer,)):
            return int(o)
        if isinstance(o, (np.floating,)):
            return float(o)
        if isinstance(o, (np.bool_,)):
            return bool(o)
        raise TypeError(f"unserializable {type(o)}")

    arrays["__meta__"] = np.frombuffer(
        json.dumps({"meta": meta, "kf": kf_json, "mp": mp_json},
                   default=_py).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_map(path: str) -> Map:
    z = np.load(path, allow_pickle=False)
    blob = json.loads(bytes(z["__meta__"]).decode())
    meta = blob["meta"]
    m = Map()
    m.next_kid = int(meta["next_kid"])
    m.next_mid = int(meta["next_mid"])
    m.origin_kid = int(meta["origin_kid"])
    m.map_scaled = bool(meta["map_scaled"])
    m.first_scale_kid = int(meta["first_scale_kid"])
    for kid in meta["kids"]:
        j = blob["kf"][str(kid)]
        kf = KeyFrame(
            kid=kid, frame_id=j["frame_id"], T_cw=z[f"kf{kid}_T"],
            uv=z[f"kf{kid}_uv"], kp_cam=z[f"kf{kid}_cam"],
            level=z[f"kf{kid}_level"], angle=z[f"kf{kid}_angle"],
            desc=z[f"kf{kid}_desc"], kp_valid=z[f"kf{kid}_valid"],
            mp_idx=z[f"kf{kid}_mp"].copy(),
            word=z[f"kf{kid}_word"] if f"kf{kid}_word" in z else None,
            node=z[f"kf{kid}_node"] if f"kf{kid}_node" in z else None,
            parent=j["parent"], children=set(j["children"]),
            covis={int(k): v for k, v in j["covis"].items()},
            loop_edges=set(j["loop_edges"]), scaled=j["scaled"],
            connected_to_second_map=j["connected_to_second_map"])
        m.keyframes[kid] = kf
    for mid in meta["mids"]:
        j = blob["mp"][str(mid)]
        mp = MapPoint(
            mid=mid, pos=z[f"mp{mid}_pos"],
            obs={int(k): v for k, v in j["obs"].items()},
            obs_cam={int(k): v for k, v in j["obs_cam"].items()},
            first_view_cam=j["first_view_cam"],
            normal=z[f"mp{mid}_normal"], min_dist=j["min_dist"],
            max_dist=j["max_dist"], desc=z[f"mp{mid}_desc"],
            n_visible=j["n_visible"], n_found=j["n_found"],
            ref_kid=j["ref_kid"], first_kf_id=j["first_kf_id"])
        m.points[mid] = mp
    return m


def rebuild_kfdb(m: Map, kfdb: KeyFrameDatabase, voc: bow.Vocabulary,
                 n_cameras: int) -> None:
    """Repopulate a KeyFrameDatabase from a restored map.  Host work only:
    the vocabulary's idf table is read back once (bow.sparse_bow)."""
    for kid, kf in m.keyframes.items():
        if kf.word is None:
            continue
        N = len(kf.word) // n_cameras
        for c in range(n_cameras):
            words = kf.word[c * N:(c + 1) * N]
            vvalid = kf.kp_valid[c * N:(c + 1) * N] & (words >= 0)
            vec = bow.sparse_bow(voc, words, vvalid)
            kfdb.add(kid, c, words[vvalid], vec)
