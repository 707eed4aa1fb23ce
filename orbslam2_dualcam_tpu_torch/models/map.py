"""Host-side map data model: keyframes, map points, covisibility graph.

The port's own copy of orbslam2_dualcam_tpu/models/map.py (numpy only): the
reference's pointer-graph map (src/{KeyFrame,MapPoint,Map}.cc) as SoA numpy
arrays per keyframe, with the irregular graph bookkeeping (covisibility
weights, spanning tree, observation dicts) in plain Python.

Device code never sees these classes: per call, the pipeline packs the
active window into dense tensors (poses/points/Edges) and scatters results
back.  Concurrency: pipeline/system.py guards map mutation with a lock (the
equivalent of Map.mMutexMapUpdate, Map.h:69); the packed tensors act as
immutable snapshots for the duration of each device call.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Set

import numpy as np

COVIS_MIN_WEIGHT = 15  # covisibility edge threshold (KeyFrame.cc:456)


@dataclass
class KeyFrame:
    """Persistent frame snapshot (reference: KeyFrame.cc:49-140).

    Feature arrays are the *global* concatenated per-camera layout the
    reference builds in Frame.cc:179-196: row i of `uv`/`desc` belongs to
    camera `kp_cam[i]`."""

    kid: int                      # keyframe id
    frame_id: int                 # source frame id
    T_cw: np.ndarray              # (4,4) rig pose, world -> capture(cam0)
    uv: np.ndarray                # (F,2) undistorted keypoints (all cams)
    kp_cam: np.ndarray            # (F,) camera index per keypoint
    level: np.ndarray             # (F,) pyramid level
    angle: np.ndarray             # (F,)
    desc: np.ndarray              # (F,8) uint32
    kp_valid: np.ndarray          # (F,) bool
    # mp_idx[i] = map-point id observed by keypoint i, or -1
    mp_idx: np.ndarray            # (F,) int64
    # BoW: word id per keypoint (-1 = unquantized) + node id at direct-index level
    word: np.ndarray | None = None
    node: np.ndarray | None = None
    # graph
    covis: Dict[int, int] = field(default_factory=dict)   # kid -> weight
    parent: int = -1
    children: Set[int] = field(default_factory=set)
    loop_edges: Set[int] = field(default_factory=set)
    # dual-camera bookkeeping (KeyFrame.h:144-147)
    scaled: bool = False
    connected_to_second_map: bool = False
    not_erase: bool = False
    to_be_erased: bool = False
    is_bad: bool = False

    @property
    def n_kp(self) -> int:
        return len(self.uv)

    def center(self) -> np.ndarray:
        R = self.T_cw[:3, :3]
        return -R.T @ self.T_cw[:3, 3]

    def cam_center(self, cam: int, T_sc: np.ndarray) -> np.ndarray:
        """Optical center of sibling camera `cam` in world frame
        (KeyFrame.cc:201-242)."""
        T_sw = T_sc @ self.T_cw
        R = T_sw[:3, :3]
        return -R.T @ T_sw[:3, 3]

    def set_scale(self, s: float) -> None:
        """Rescale translation (KeyFrame.cc:171-187)."""
        self.T_cw = self.T_cw.copy()
        self.T_cw[:3, 3] *= s
        self.scaled = True


@dataclass
class MapPoint:
    """Landmark (reference: MapPoint.cc). Observations map kid -> global
    keypoint row; per-camera observation bookkeeping enables the
    cross-camera logic (mObservedCameras / mbViewdByDifCams,
    MapPoint.cc:105-163)."""

    mid: int
    pos: np.ndarray                     # (3,)
    obs: Dict[int, int] = field(default_factory=dict)       # kid -> kp row
    obs_cam: Dict[int, int] = field(default_factory=dict)   # kid -> camera
    first_view_cam: int = 0
    normal: np.ndarray = field(default_factory=lambda: np.zeros(3))
    min_dist: float = 0.0
    max_dist: float = 0.0
    desc: np.ndarray = field(default_factory=lambda: np.zeros(8, np.uint32))
    n_visible: int = 1
    n_found: int = 1
    is_bad: bool = False
    replaced_by: int = -1
    ref_kid: int = -1
    first_kf_id: int = -1

    @property
    def n_obs(self) -> int:
        return len(self.obs)

    @property
    def seen_by_multiple_cams(self) -> bool:
        return len(set(self.obs_cam.values())) > 1

    def found_ratio(self) -> float:
        return self.n_found / max(self.n_visible, 1)

    def set_scale(self, s: float) -> None:
        self.pos = self.pos * s


def _popcount(x: np.ndarray) -> np.ndarray:
    return np.bitwise_count(x)


def update_point_stats(mp: MapPoint, m: "Map", T_sc: np.ndarray,
                       scale_factors: np.ndarray) -> None:
    """MapPoint::UpdateNormalAndDepth + ComputeDistinctiveDescriptors
    (MapPoint.cc:270-409): viewing normal averaged over PER-CAMERA observing
    centers, scale-invariance distance band from the reference KF's level,
    and the min-median-Hamming descriptor."""
    if not mp.obs:
        return
    normals = []
    descs = []
    for kid, row in mp.obs.items():
        kf = m.keyframes.get(kid)
        if kf is None:
            continue
        cam = mp.obs_cam.get(kid, 0)
        center = kf.cam_center(cam, T_sc[cam])
        v = mp.pos - center
        n = np.linalg.norm(v)
        if n > 1e-9:
            normals.append(v / n)
        descs.append(kf.desc[row])
    if normals:
        nsum = np.sum(normals, axis=0)
        mp.normal = nsum / max(np.linalg.norm(nsum), 1e-9)
    ref = m.keyframes.get(mp.ref_kid)
    if ref is not None and mp.ref_kid in mp.obs:
        row = mp.obs[mp.ref_kid]
        cam = mp.obs_cam.get(mp.ref_kid, 0)
        center = ref.cam_center(cam, T_sc[cam])
        dist = float(np.linalg.norm(mp.pos - center))
        level = int(ref.level[row])
        nl = len(scale_factors)
        mp.max_dist = dist * scale_factors[level]
        mp.min_dist = mp.max_dist / scale_factors[nl - 1]
    if descs:
        D = np.asarray(descs)
        H = _popcount(D[:, None, :] ^ D[None, :, :]).sum(-1)
        med = np.median(H, axis=1)
        mp.desc = D[int(np.argmin(med))]


class Map:
    """KF/MP registry + covisibility maintenance (reference: Map.cc plus the
    graph logic in KeyFrame.cc / MapPoint.cc)."""

    def __init__(self) -> None:
        self.keyframes: Dict[int, KeyFrame] = {}
        self.points: Dict[int, MapPoint] = {}
        self.next_kid = 0
        self.next_mid = 0
        self.origin_kid: int = -1
        self.big_change_idx = 0
        self.map_scaled = False          # tracks Tracking's mbIsMapScaled
        self.first_scale_kid: int = -1   # gauge anchor after scaling
        # observers notified when a keyframe is erased (the reference's
        # KeyFrame::SetBadFlag calls mpKeyFrameDB->erase, KeyFrame.cc:668)
        self.on_erase_keyframe: List = []
        # culled kid -> (parent kid, T_culled_cw @ inv(T_parent_cw)) frozen
        # at cull time, so trajectory entries anchored to a culled KF can
        # re-anchor through the parent chain exactly as the reference's
        # mTcp walk does (KeyFrame::SetBadFlag + System::SaveTrajectory)
        self.culled_redirect: Dict[int, tuple] = {}
        # bumped by every map-WIDE geometric transform (set_scale, Sim3
        # loop correction + essential-graph remap).  Consumers holding
        # results computed from a pre-transform snapshot (the async local
        # BA, which releases map_lock during device chunks) must discard
        # them when the epoch moved — writing back would mix coordinate
        # frames (the reference prevents this by stopping LocalMapping
        # before such transforms, LocalMapping::RequestStop)
        self.geometry_epoch = 0

    # -- creation ---------------------------------------------------------
    def add_keyframe(self, kf: KeyFrame) -> KeyFrame:
        self.keyframes[kf.kid] = kf
        if self.origin_kid < 0:
            self.origin_kid = kf.kid
        return kf

    def new_kid(self) -> int:
        k = self.next_kid
        self.next_kid += 1
        return k

    def new_point(self, pos: np.ndarray, ref_kid: int,
                  first_cam: int) -> MapPoint:
        mp = MapPoint(mid=self.next_mid, pos=np.asarray(pos, np.float64),
                      ref_kid=ref_kid, first_view_cam=first_cam,
                      first_kf_id=ref_kid)
        self.next_mid += 1
        self.points[mp.mid] = mp
        return mp

    # -- observations -----------------------------------------------------
    def add_observation(self, mp: MapPoint, kf: KeyFrame, kp_row: int,
                        cam: int) -> None:
        mp.obs[kf.kid] = kp_row
        mp.obs_cam[kf.kid] = cam
        kf.mp_idx[kp_row] = mp.mid

    def erase_observation(self, mp: MapPoint, kid: int) -> None:
        row = mp.obs.pop(kid, None)
        mp.obs_cam.pop(kid, None)
        kf = self.keyframes.get(kid)
        if kf is not None and row is not None and kf.mp_idx[row] == mp.mid:
            kf.mp_idx[row] = -1
        if mp.ref_kid == kid and mp.obs:
            mp.ref_kid = next(iter(mp.obs))
        # reference kills points falling under 3 observations once any
        # observer is erased (MapPoint.cc:135-150 erases at <=2)
        if len(mp.obs) <= 2 and not mp.is_bad:
            self.erase_point(mp)

    def erase_point(self, mp: MapPoint) -> None:
        mp.is_bad = True
        for kid, row in list(mp.obs.items()):
            kf = self.keyframes.get(kid)
            if kf is not None and kf.mp_idx[row] == mp.mid:
                kf.mp_idx[row] = -1
        mp.obs.clear()
        mp.obs_cam.clear()
        self.points.pop(mp.mid, None)

    def replace_point(self, old: MapPoint, new: MapPoint) -> None:
        """MapPoint::Replace (MapPoint.cc:205-243): move observations."""
        if old.mid == new.mid:
            return
        for kid, row in list(old.obs.items()):
            kf = self.keyframes.get(kid)
            if kf is None:
                continue
            if kid not in new.obs:
                new.obs[kid] = row
                new.obs_cam[kid] = old.obs_cam.get(kid, 0)
                kf.mp_idx[row] = new.mid
            else:
                kf.mp_idx[row] = -1
        new.n_visible += old.n_visible
        new.n_found += old.n_found
        old.obs.clear()
        old.obs_cam.clear()
        old.is_bad = True
        old.replaced_by = new.mid
        self.points.pop(old.mid, None)

    # -- covisibility (KeyFrame.cc:419-505) -------------------------------
    def update_connections(self, kf: KeyFrame) -> None:
        counter: Dict[int, int] = {}
        for mid in kf.mp_idx:
            if mid < 0:
                continue
            mp = self.points.get(int(mid))
            if mp is None or mp.is_bad:
                continue
            for other in mp.obs:
                if other != kf.kid:
                    counter[other] = counter.get(other, 0) + 1
        if not counter:
            return
        wmax = max(counter.values())
        kept = {k: w for k, w in counter.items() if w >= COVIS_MIN_WEIGHT}
        if not kept:  # keep at least the strongest link
            kmax = max(counter, key=counter.get)
            kept = {kmax: counter[kmax]}
        kf.covis = kept
        for other, w in kept.items():
            okf = self.keyframes.get(other)
            if okf is not None:
                okf.covis[kf.kid] = w
        # spanning tree: parent = strongest covisible older KF
        if kf.parent < 0 and kf.kid != self.origin_kid:
            older = [k for k in kept if k < kf.kid]
            if older:
                p = max(older, key=lambda k: kept[k])
                kf.parent = p
                self.keyframes[p].children.add(kf.kid)

    def covisible_kfs(self, kf: KeyFrame, n: int = 0) -> List[int]:
        """Best covisible keyframes by weight (GetBestCovisibilityKeyFrames)."""
        items = sorted(kf.covis.items(), key=lambda kv: -kv[1])
        kids = [k for k, _ in items if k in self.keyframes]
        return kids[:n] if n else kids

    def erase_keyframe(self, kf: KeyFrame) -> None:
        """KeyFrame::SetBadFlag (KeyFrame.cc:579-705): detach observations,
        reconnect children to new parents."""
        if kf.kid == self.origin_kid or kf.not_erase:
            kf.to_be_erased = kf.not_erase
            if kf.not_erase:
                return
        for row, mid in enumerate(kf.mp_idx):
            if mid >= 0:
                mp = self.points.get(int(mid))
                if mp is not None:
                    mp.obs.pop(kf.kid, None)
                    mp.obs_cam.pop(kf.kid, None)
                    if mp.ref_kid == kf.kid and mp.obs:
                        mp.ref_kid = next(iter(mp.obs))
                    if len(mp.obs) <= 2:
                        self.erase_point(mp)
        for other in kf.covis:
            okf = self.keyframes.get(other)
            if okf is not None:
                okf.covis.pop(kf.kid, None)
        # re-parent children to candidates in the parent chain
        parent = self.keyframes.get(kf.parent)
        for child_id in list(kf.children):
            child = self.keyframes.get(child_id)
            if child is None:
                continue
            # strongest covisible among ancestors, else kf's parent
            best, bw = (kf.parent, -1)
            for cand, w in child.covis.items():
                if cand != kf.kid and cand in self.keyframes and w > bw:
                    best, bw = cand, w
            child.parent = best
            if best in self.keyframes:
                self.keyframes[best].children.add(child_id)
        if parent is not None:
            parent.children.discard(kf.kid)
            self.culled_redirect[kf.kid] = (
                kf.parent, kf.T_cw @ np.linalg.inv(parent.T_cw))
        kf.is_bad = True
        self.keyframes.pop(kf.kid, None)
        for cb in self.on_erase_keyframe:
            cb(kf.kid)

    # -- dual-camera scaling (Tracking.cc:512-775 support) ----------------
    def set_scale(self, s: float) -> None:
        """Rescale every KF translation and MP position (the global metric
        re-scale applied when the second map is created)."""
        for kf in self.keyframes.values():
            kf.set_scale(s)
        for mp in self.points.values():
            mp.set_scale(s)
        self.map_scaled = True
        self.geometry_epoch += 1

    # -- stats ------------------------------------------------------------
    @property
    def n_keyframes(self) -> int:
        return len(self.keyframes)

    @property
    def n_points(self) -> int:
        return len(self.points)

    def clear(self) -> None:
        self.keyframes.clear()
        self.points.clear()
        self.culled_redirect.clear()
        self.geometry_epoch += 1
        self.next_kid = 0
        self.next_mid = 0
        self.origin_kid = -1
        self.map_scaled = False
        self.first_scale_kid = -1
