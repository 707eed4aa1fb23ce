"""Local mapping: point creation, fusion, local BA, culling.

Port of orbslam2_dualcam_tpu/pipeline/local_mapping.py (src/LocalMapping.cc
in the original).  The original runs this as a separate thread consuming a
keyframe queue; here it is a service the tracker calls per keyframe
(synchronous by default for determinism; an async wrapper lives in
pipeline/system.py).  The per-KF numeric work (epipolar triangulation, fuse
matching, local BA) runs on the device the rig's tensors lie on; the map
and every decision stay on the host.

Pipeline per keyframe (LocalMapping::Run, :65-135):
  ProcessNewKeyFrame -> MapPointCulling -> CreateNewMapPoints ->
  SearchInNeighbors (fuse) -> SearchCrossCameras -> LocalBundleAdjustment
  -> KeyFrameCulling.
"""

from __future__ import annotations

from typing import List, Set

import numpy as np
import torch

from orbslam2_dualcam_tpu_torch.models.map import (KeyFrame, Map,
                                                   update_point_stats)
from orbslam2_dualcam_tpu_torch.ops import ransac
from orbslam2_dualcam_tpu_torch.ops.camera import CameraRig
from orbslam2_dualcam_tpu_torch.optim import ba
from orbslam2_dualcam_tpu_torch.pipeline import ba_pack, frontend
from orbslam2_dualcam_tpu_torch.utils.config import SystemConfig
from orbslam2_dualcam_tpu_torch.utils.device import to_host, upload
from orbslam2_dualcam_tpu_torch.utils.profiling import StageTimer, span
from orbslam2_dualcam_tpu_torch.vocab import bow


class LocalMapper:
    def __init__(self, cfg: SystemConfig, rig: CameraRig, slam_map: Map,
                 loop_closer=None, kfdb=None, voc=None) -> None:
        self.cfg = cfg
        self.rig = rig
        self.map = slam_map
        self.loop_closer = loop_closer
        self.kfdb = kfdb
        self.voc = voc
        self.scale_factors = np.asarray(cfg.orb.scale_factors, np.float32)
        self.device = rig.K.device
        self._level_scales = torch.as_tensor(self.scale_factors,
                                             device=self.device)
        # host copies, read once: every later read would wait for the card
        self._T_sc_np = rig.T_sc.cpu().numpy()
        self.timer = StageTimer("mapper")
        self.recent_mids: List[int] = []     # candidates for culling
        self.n_triangulated = 0
        self.n_fused = 0
        self.n_culled_kf = 0
        self.n_capacity_skipped = 0   # triangulations refused at MP cap
        self.n_cross_harvested = 0           # SearchCrossCameras adds+merges
        self.last_cross_kid = -10**9         # last successful harvest KF
        # PnP minimal sets of the cross-camera harvest are drawn on the
        # CPU from the mapper's own generator; `pnp_sampler` may be
        # replaced by a callable (n_hyp, valid) -> (idx6, idx4)
        self.gen = torch.Generator().manual_seed(11)
        self.pnp_sampler = (
            lambda n_hyp, valid: ransac.pnp_samples(self.gen, n_hyp, valid))
        self.events: List[str] = []          # debug trail (cross harvest &c)
        self.ba_log: List[tuple] = []        # (kid, n_kf, n_mp, n_edge, cost)
        # async-pipeline hooks (set by pipeline/system.py): interrupt_check
        # aborts local BA between chunks when a new KF is queued; map_lock
        # is released during each chunk's device solve (LocalMapping.cc:
        # 97-108 InterruptBA semantics)
        self.interrupt_check = None
        self.map_lock = None
        # called once a keyframe's new points are in the map, before its
        # local BA (the tracker's store waits for them, not for the BA)
        self.extended = None
        # (K, M, E) padded sizes of each local-BA solve, and the last
        # solve's (problem, result); the solves' times are `ba.solve` spans
        self.ba_shapes: List[tuple] = []
        self.last_ba = None

    # ------------------------------------------------------------------
    def on_new_keyframe(self, kf: KeyFrame, run_ba: bool = True) -> None:
        """LocalMapping::Run's body for one keyframe; the root span
        `mapper.keyframe` on the mapping thread, inside `tracker.keyframe`
        otherwise."""
        with span("mapper.keyframe", frame=kf.frame_id):
            m = self.map
            t0, f0, c0 = self.n_triangulated, self.n_fused, self.n_culled_kf
            with span("mapper.connections"):
                m.update_connections(kf)
            with span("mapper.cull"):
                self._cull_recent_points(kf)
            with self.timer("triangulate"):
                self._create_new_points(kf)
            with self.timer("fuse"):
                self._fuse_neighbors(kf)
            with self.timer("cross_cam"):
                self._search_cross_cameras(kf)
            with span("mapper.connections"):
                for mid in kf.mp_idx[kf.mp_idx >= 0]:
                    mp = m.points.get(int(mid))
                    if mp is not None:
                        update_point_stats(mp, m, self._T_sc_np,
                                           self.scale_factors)
                m.update_connections(kf)
            if self.extended is not None:
                self.extended()
            if run_ba and m.n_keyframes > 2:
                with self.timer("local_ba"):
                    self._local_ba(kf)
            with span("mapper.cull"):
                self._cull_keyframes(kf)
            self.kf_log = getattr(self, "kf_log", [])
            self.kf_log.append((kf.kid, self.n_triangulated - t0,
                                self.n_fused - f0, self.n_culled_kf - c0,
                                len(self.map.covisible_kfs(kf))))
            if self.loop_closer is not None:
                self.loop_closer.on_new_keyframe(kf)

    # ------------------------------------------------------------------
    def _cull_recent_points(self, kf: KeyFrame) -> None:
        """MapPointCulling (LocalMapping.cc:203-242): drop points with poor
        found/visible ratio or too few observations soon after creation."""
        m = self.map
        keep: List[int] = []
        for mid in self.recent_mids:
            mp = m.points.get(mid)
            if mp is None or mp.is_bad:
                continue
            age = kf.kid - mp.first_kf_id
            if mp.found_ratio() < self.cfg.mapping.cull_found_ratio:
                m.erase_point(mp)
            elif age >= 2 and mp.n_obs <= 2:
                m.erase_point(mp)
            elif age >= 3:
                pass          # graduated
            else:
                keep.append(mid)
        self.recent_mids = keep

    # ------------------------------------------------------------------
    def _create_new_points(self, kf: KeyFrame) -> None:
        """CreateNewMapPoints (LocalMapping.cc:275-490): per covisible KF,
        per camera, epipolar-matched triangulation.  Non-primary cameras
        only triangulate once the map is metrically scaled
        (LocalMapping.cc:309-311)."""
        m = self.map
        neighbors = m.covisible_kfs(kf, 10)
        ncam = self.cfg.n_cameras
        N = len(kf.kp_valid) // ncam
        cams = range(ncam) if m.map_scaled else [0]
        # gather every (neighbour, camera) pair passing the host gates,
        # then triangulate ALL pairs in one batched device dispatch
        pairs: List[tuple] = []          # (nkf, c)
        for nkid in neighbors:
            nkf = m.keyframes.get(nkid)
            if nkf is None:
                continue
            # baseline / median-depth gate (LocalMapping.cc:320-338)
            b = np.linalg.norm(kf.center() - nkf.center())
            med = self._median_depth(nkf)
            if med <= 0 or b / med < 0.01:
                continue
            for c in cams:
                g = c * N
                free1 = (kf.kp_valid[g:g + N] & (kf.mp_idx[g:g + N] < 0))
                free2 = (nkf.kp_valid[g:g + N] & (nkf.mp_idx[g:g + N] < 0))
                if free1.sum() < 10 or free2.sum() < 10:
                    continue
                pairs.append((nkf, c, free1, free2))
        if not pairs:
            return
        # the reference pads the batch to a x4 bucket; the truncation at
        # the largest bucket is kept, the padding (repeats of the last
        # pair, never read) is not
        pairs = pairs[:_FUSE_BUCKETS[-1]]

        def stack(fn, dtype=None):
            a = np.stack([fn(nkf, c, f1, f2) for nkf, c, f1, f2 in pairs])
            return upload(a if dtype is None else a.astype(dtype), self.device)

        sl = lambda arr, c: arr[c * N:(c + 1) * N]
        idx_b, X_b, good_b = frontend.triangulate_pairs_batch(
            stack(lambda nkf, c, f1, f2: kf.T_cw, np.float32),
            stack(lambda nkf, c, f1, f2: nkf.T_cw, np.float32),
            [c for _, c, _, _ in pairs],
            stack(lambda nkf, c, f1, f2: sl(kf.uv, c), np.float32),
            stack(lambda nkf, c, f1, f2: sl(kf.desc, c), np.uint32),
            stack(lambda nkf, c, f1, f2: sl(kf.level, c), np.int64),
            stack(lambda nkf, c, f1, f2: f1),
            stack(lambda nkf, c, f1, f2: sl(nkf.uv, c), np.float32),
            stack(lambda nkf, c, f1, f2: sl(nkf.desc, c), np.uint32),
            stack(lambda nkf, c, f1, f2: sl(nkf.level, c), np.int64),
            stack(lambda nkf, c, f1, f2: f2),
            self.rig, self._level_scales, float(self.cfg.matcher.th_low))
        idx_b, X_b, good_b = to_host((idx_b, X_b, good_b))
        X_b = X_b.astype(np.float64)
        T_sc_np = self._T_sc_np
        for i, (nkf, c, _, _) in enumerate(pairs):
            g = c * N
            idx, X, good = idx_b[i], X_b[i], good_b[i]
            for r1 in np.nonzero(good)[0]:
                if m.n_points >= self.cfg.capacity.max_mappoints:
                    # hard map-point capacity: culling frees slots; count
                    # refusals so capacity pressure is never silent
                    self.n_capacity_skipped += 1
                    break
                r2 = int(idx[r1])
                g1 = g + int(r1)
                g2 = g + r2
                if kf.mp_idx[g1] >= 0 or nkf.mp_idx[g2] >= 0:
                    continue
                mp = m.new_point(X[r1], kf.kid, c)
                mp.first_kf_id = kf.kid
                m.add_observation(mp, kf, g1, c)
                m.add_observation(mp, nkf, g2, c)
                update_point_stats(mp, m, T_sc_np, self.scale_factors)
                self.recent_mids.append(mp.mid)
                self.n_triangulated += 1

    def _cam_enabled(self) -> np.ndarray:
        ncam = self.cfg.n_cameras
        en = np.zeros(ncam, bool)
        en[0] = True
        if self.map.map_scaled or ncam == 1:
            en[:] = True
        return en

    def _median_depth(self, kf: KeyFrame) -> float:
        m = self.map
        ds = []
        for mid in kf.mp_idx[kf.mp_idx >= 0][:500]:
            mp = m.points.get(int(mid))
            if mp is not None:
                ds.append(kf.T_cw[2, :3] @ mp.pos + kf.T_cw[2, 3])
        return float(np.median(ds)) if ds else -1.0

    # ------------------------------------------------------------------
    def _fuse_neighbors(self, kf: KeyFrame) -> None:
        """SearchInNeighbors (LocalMapping.cc:492-570): project this KF's
        points into neighbours and merge duplicates, then the reverse."""
        m = self.map
        # one-hop neighbourhood, extended to two hops per the reference
        # (LocalMapping.cc:500-516).  Round-1 measured the second hop
        # over-merging on repetitive texture; the fix is the per-merge
        # reprojection gate in _fuse_into (fuse_chi2), not dropping the
        # hop — distant-duplicate merging is what keeps long runs compact.
        targets: List[int] = []
        seen: Set[int] = {kf.kid}
        one_hop = m.covisible_kfs(kf, 10)
        for nkid in one_hop:
            if nkid not in seen:
                seen.add(nkid)
                targets.append(nkid)
        if self.cfg.mapping.two_hop_fuse:
            for nkid in one_hop:
                nkf = m.keyframes.get(nkid)
                if nkf is None:
                    continue
                for nnkid in m.covisible_kfs(nkf, 5):
                    if nnkid not in seen:
                        seen.add(nnkid)
                        targets.append(nnkid)
        # forward: kf's points into every target in ONE batched dispatch
        mids = [int(x) for x in kf.mp_idx[kf.mp_idx >= 0]]
        tkfs = [m.keyframes[nkid] for nkid in targets
                if nkid in m.keyframes]
        self.n_fused += fuse_into_batch(
            m, self.rig, self.cfg, self.scale_factors, self._level_scales,
            tkfs, mids, cam_enabled=self._cam_enabled())
        # reverse: targets' points into kf
        nmids: Set[int] = set()
        for nkid in targets:
            nkf = m.keyframes.get(nkid)
            if nkf is None:
                continue
            nmids.update(int(x) for x in nkf.mp_idx[nkf.mp_idx >= 0])
        self.n_fused += self._fuse_into(kf, sorted(nmids))

    def _pack_points(self, mids: List[int]):
        """Pack map points into padded device-shape arrays (slot i = mids[i]).
        Returns (mids, pos, desc, valid, dmax, dmin, normal) or None."""
        return pack_points(self.map, self.cfg.capacity.max_local_mp, mids)

    def _fuse_into(self, target: KeyFrame, mids: List[int]) -> int:
        """Fuse (ORBmatcher.cc:1431-1558): project points into `target`;
        matched keypoints either gain an observation or trigger a merge."""
        return fuse_into(self.map, self.rig, self.cfg, self.scale_factors,
                         self._level_scales, target, mids,
                         cam_enabled=self._cam_enabled())

    # ------------------------------------------------------------------
    def _search_cross_cameras(self, kf: KeyFrame) -> None:
        """LocalMapping::SearchCrossCameras (LocalMapping.cc:573-810): once
        the map is metric, relocalize this keyframe's PRIMARY-camera features
        against the SECONDARY-camera observations of covisible keyframes
        (BoW query cam0 -> cam1 index), PnP-verify, widen by projection, and
        attach/merge the matched points as camera-0 observations.

        Points harvested here become cross-camera-observed
        (mbViewdByDifCams): the only observations through which BA's
        extrinsic-adjoint factor can pin metric scale, so densifying them
        is what makes the dual rig actually metric."""
        m = self.map
        cfg = self.cfg
        mc = cfg.mapping
        if (not m.map_scaled or self.kfdb is None or self.voc is None or
                cfg.n_cameras < 2 or kf.word is None):
            return
        if kf.kid <= self.last_cross_kid + mc.cross_kf_gap:
            return
        with self.timer("search_cross"):
            self._harvest_cross_cameras(kf)

    def _harvest_cross_cameras(self, kf: KeyFrame) -> None:
        """The body of SearchCrossCameras once its gates have passed."""
        m = self.map
        cfg = self.cfg
        mc = cfg.mapping
        dev = self.device
        ncam = cfg.n_cameras
        N = len(kf.kp_valid) // ncam
        words = kf.word[:N]
        vvalid = kf.kp_valid[:N] & (words >= 0)
        if int(vvalid.sum()) < 20:
            return
        vec = bow.sparse_bow(self.voc, words, vvalid)
        cands = self.kfdb.detect_reloc_candidates(
            np.where(vvalid, words, -1), vec, 0, 1, m)
        # candidates must already be covisibility-connected (:592-597)
        connected = set(m.covisible_kfs(kf))
        kept = [kid for kid in cands if kid in connected]
        if cands:
            self.events.append(
                f"XC@{kf.kid} cands={cands[:6]} conn={kept[:6]}")
        cands = kept
        g1 = 1 * N
        for kid in cands[:5]:
            ckf = m.keyframes.get(kid)
            if ckf is None or ckf.is_bad:
                continue
            sl = slice(g1, g1 + N)
            res = frontend.match_bow_frame_kf(
                upload(kf.desc[:N].astype(np.uint32), dev),
                upload(kf.node[:N], dev), upload(kf.angle[:N], dev),
                upload(kf.kp_valid[:N], dev),
                upload(ckf.desc[sl].astype(np.uint32), dev),
                upload(ckf.node[sl], dev), upload(ckf.angle[sl], dev),
                upload(ckf.kp_valid[sl] & (ckf.mp_idx[sl] >= 0), dev),
                float(cfg.matcher.th_low), float(cfg.matcher.nn_ratio_bow))
            idx = to_host((res.idx,))[0]
            rows = np.nonzero(idx >= 0)[0]
            if len(rows) < mc.cross_min_bow:
                self.events.append(f"XCBOW@{kf.kid} cand={kid} n={len(rows)}")
                continue
            X, uv = [], []
            for r in rows:
                mid = int(ckf.mp_idx[g1 + idx[r]])
                mp = m.points.get(mid)
                if mp is None or mp.is_bad:
                    continue
                X.append(mp.pos)
                uv.append(kf.uv[r])
            if len(X) < mc.cross_min_bow:
                continue
            pvalid = torch.ones(len(X), dtype=torch.bool, device=dev)
            idx6, idx4 = self.pnp_sampler(256, pvalid)
            T_0w, _inl, cnt, ok = ransac.pnp_solve(
                idx6.to(dev), idx4.to(dev),
                upload(np.asarray(X, np.float32), dev),
                upload(np.asarray(uv, np.float32), dev), pvalid,
                self.rig.K[0])
            T_0w, cnt, ok = to_host((T_0w, cnt, ok))
            if not bool(ok) or int(cnt) < mc.cross_min_pose_inliers:
                self.events.append(
                    f"XCPNP@{kf.kid} cand={kid} inl={int(cnt)}")
                continue
            # guided-projection widening + pose opt against the candidate's
            # map-point set, camera 0 only (the reference's inner frame with
            # identity extrinsic, :644-700).  Two passes: wide then narrow
            # (SearchByProjectionOnCam th=10 then th=3, :710-737).
            pmids = sorted({int(x) for x in ckf.mp_idx[ckf.mp_idx >= 0]})
            packed = self._pack_points(pmids)
            pmids, pos, desc, valid, dmax, dmin, normal = packed
            if valid.sum() < mc.cross_min_pose_inliers:
                continue
            cam_en = np.zeros(ncam, bool)
            cam_en[0] = True
            T_cur = np.asarray(T_0w, np.float64)  # T_sc[0] = I: rig pose
            r2 = None
            fdev = (upload(kf.uv.reshape(ncam, N, 2).astype(np.float32), dev),
                    upload(kf.desc.reshape(ncam, N, 8).astype(np.uint32), dev),
                    upload(kf.level.reshape(ncam, N), dev),
                    upload(kf.angle.reshape(ncam, N), dev),
                    upload(kf.kp_valid.reshape(ncam, N), dev))
            pdev = (upload(pos, dev), upload(desc, dev), upload(valid, dev),
                    upload(dmax, dev), upload(dmin, dev), upload(normal, dev))
            for radius in (mc.cross_widen_radius, mc.cross_widen_radius2):
                r2 = frontend.TrackResult(*to_host(
                    frontend.match_projection_pose(
                        upload(T_cur.astype(np.float32), dev), *fdev, *pdev,
                        self.rig, float(radius), self._level_scales,
                        float(cfg.matcher.th_high), 0.5,
                        upload(cam_en, dev), ba=cfg.ba)))
                T_cur = np.asarray(r2.T_cw, np.float64)
            n_good = int(r2.n_inliers)
            if n_good < mc.cross_min_good:
                self.events.append(
                    f"XCGOOD@{kf.kid} cand={kid} good={n_good}")
                continue
            # harvest (:752-775): attach as cam-0 observations or merge
            slots = np.asarray(r2.mp_ids)[0]
            n_add = n_rep = 0
            for row in np.nonzero(slots >= 0)[0]:
                mid1 = pmids[int(slots[row])]
                mp1 = m.points.get(mid1)
                if mp1 is None or mp1.is_bad:
                    continue
                cur = int(kf.mp_idx[row])
                if cur < 0:
                    if kf.kid not in mp1.obs:
                        m.add_observation(mp1, kf, int(row), 0)
                        n_add += 1
                elif cur != mid1:
                    mp2 = m.points.get(cur)
                    if mp2 is not None and not mp2.is_bad:
                        m.replace_point(mp2, mp1)
                        n_rep += 1
            m.update_connections(kf)
            self.n_cross_harvested += n_add + n_rep
            self.last_cross_kid = kf.kid
            kf.connected_to_second_map = True
            ckf.connected_to_second_map = True
            self.cross_log = getattr(self, "cross_log", [])
            self.cross_log.append((kf.kid, kid, n_good, n_add, n_rep))
            self.events.append(
                f"XCROSS@{kf.kid} cand={kid} good={n_good} "
                f"add={n_add} rep={n_rep}")
            return

    # ------------------------------------------------------------------
    def _local_ba(self, kf: KeyFrame) -> None:
        """LocalBundleAdjustment (Optimizer.cc:407-696): window = current KF
        + covisible KFs; gauge anchored at the scale anchor (first-scale KF
        once the dual map is scaled, LocalMapping.cc:97-108) or the oldest
        window KF."""
        m = self.map
        window = [kf.kid] + m.covisible_kfs(kf, 20)
        fixed: Set[int] = set()
        if m.first_scale_kid >= 0 and m.first_scale_kid in m.keyframes:
            fixed.add(m.first_scale_kid)
        if m.origin_kid in window:
            fixed.add(m.origin_kid)
        cfg = self.cfg
        prob, all_kids, mids, meta = ba_pack.pack_problem(
            m, window, fixed_kids=fixed,
            level_sigma2=self.scale_factors ** 2, ncam=cfg.n_cameras,
            max_points=cfg.capacity.max_local_mp, device=self.device)
        # Abortable, lock-releasing BA (LocalMapping.cc:97-108): the chunked
        # solver drops `map_lock` while each LM chunk executes on-device so
        # the tracking thread keeps the map, and stops early when a new
        # keyframe is waiting (the reference's InterruptBA -> mbAbortBA).
        epoch0 = m.geometry_epoch
        res = ba.solve_ba_chunked(
            prob, self.rig.T_sc, self.rig.adj_sc, self.rig.K,
            iters=cfg.ba.local_iters_a + cfg.ba.local_iters_b,
            chunk=cfg.ba.abort_chunk,
            should_abort=self.interrupt_check,
            unlock=self.map_lock.release if self.map_lock else None,
            relock=self.map_lock.acquire if self.map_lock else None)
        if m.geometry_epoch != epoch0:
            # a map-wide transform (metric rescale, Sim3 loop correction)
            # landed while the lock was released: this solve's snapshot is
            # in the OLD coordinate frame — writing it back would rescale
            # only the window and leave the map mixed-frame.  Discard; the
            # next keyframe re-runs local BA on fresh coordinates.
            self.ba_log.append((kf.kid, len(all_kids), len(mids), len(meta),
                                float("nan"), -1))
            return
        n_erased = ba_pack.unpack_result(m, res, all_kids, mids, meta,
                                         chi2_th=cfg.ba.chi2_mono)
        self.ba_log.append((kf.kid, len(all_kids), len(mids), len(meta),
                            float(res.cost), n_erased))
        self.last_ba = (prob, res)
        self.ba_shapes.append(ba.padded_shape(prob))

    # ------------------------------------------------------------------
    def _cull_keyframes(self, kf: KeyFrame) -> None:
        """KeyFrameCulling (LocalMapping.cc:955-1008): erase local KFs whose
        points are >=90% observed by >=3 other KFs at same-or-finer scale.
        KFs connected to the second map are protected."""
        m = self.map
        for kid in m.covisible_kfs(kf):
            ckf = m.keyframes.get(kid)
            if (ckf is None or ckf.kid == m.origin_kid or
                    ckf.connected_to_second_map or ckf.not_erase or
                    ckf.kid == m.first_scale_kid):
                continue
            mids = ckf.mp_idx[ckf.mp_idx >= 0]
            if len(mids) == 0:
                continue
            n_redundant = 0
            for g, mid in zip(np.nonzero(ckf.mp_idx >= 0)[0], mids):
                mp = m.points.get(int(mid))
                if mp is None:
                    continue
                level = int(ckf.level[g])
                n_better = 0
                for okid, orow in mp.obs.items():
                    if okid == ckf.kid:
                        continue
                    okf = m.keyframes.get(okid)
                    if okf is not None and int(okf.level[orow]) <= level + 1:
                        n_better += 1
                if n_better >= 3:
                    n_redundant += 1
            if n_redundant > 0.9 * len(mids):
                m.erase_keyframe(ckf)
                self.n_culled_kf += 1


# ----------------------------------------------------------------------
# Module-level fuse primitives, shared by LocalMapper (SearchInNeighbors)
# and the loop closer's SearchAndFuse (LoopClosing.cc:703-733).

def pack_points(m: Map, cap: int, mids: List[int]):
    """Pack map points into padded device-shape arrays (slot i = mids[i]).

    The padded size is the smallest power-of-FOUR bucket >= len(mids)
    (min 256, max `cap`), the reference's shape buckets (ba_pack._bucket);
    the truncation to `cap` is semantics, the padding only masked work."""
    mids = [mid for mid in mids if mid in m.points][:cap]
    cap = min(cap, max(256, 4 ** int(np.ceil(
        np.log2(max(len(mids), 1)) / 2))))
    pos = np.zeros((cap, 3), np.float32)
    desc = np.zeros((cap, 8), np.uint32)
    normal = np.zeros((cap, 3), np.float32)
    dmin = np.zeros(cap, np.float32)
    dmax = np.full(cap, 1e9, np.float32)
    valid = np.zeros(cap, bool)
    for i, mid in enumerate(mids):
        mp = m.points[mid]
        if mp.is_bad:
            continue
        pos[i] = mp.pos
        desc[i] = mp.desc
        normal[i] = mp.normal
        dmin[i] = mp.min_dist
        dmax[i] = mp.max_dist if mp.max_dist > 0 else 1e9
        valid[i] = True
    return mids, pos, desc, valid, dmax, dmin, normal


def fuse_into(m: Map, rig: CameraRig, cfg: SystemConfig,
              scale_factors: np.ndarray, level_scales, target: KeyFrame,
              mids: List[int], radius: float = 3.0,
              cam_enabled=None) -> int:
    """Fuse (ORBmatcher.cc:1431-1558): project points into `target`;
    matched keypoints either gain an observation or trigger a merge."""
    mids, pos, desc, valid, dmax, dmin, normal = pack_points(
        m, cfg.capacity.max_local_mp, mids)
    if len(mids) < 5 or valid.sum() < 5:
        return 0
    ncam = cfg.n_cameras
    N = len(target.kp_valid) // ncam
    device = rig.K.device
    if cam_enabled is None:
        cam_enabled = np.ones(ncam, bool)
    mp_of_kp, _ = frontend.project_and_match(
        upload(target.T_cw.astype(np.float32), device),
        upload(target.uv.reshape(ncam, N, 2).astype(np.float32), device),
        upload(target.desc.reshape(ncam, N, 8).astype(np.uint32), device),
        upload(target.level.reshape(ncam, N).astype(np.int64), device),
        upload(target.kp_valid.reshape(ncam, N), device),
        upload(pos, device), upload(desc, device), upload(valid, device),
        upload(dmax, device), upload(dmin, device), upload(normal, device),
        rig, float(radius), level_scales,
        float(cfg.matcher.th_low), 0.5, upload(cam_enabled, device))
    return _apply_fuse_matches(m, rig, cfg, scale_factors, target, mids,
                               to_host((mp_of_kp,))[0])


_FUSE_BUCKETS = (4, 16, 64)   # the reference's batch buckets; see ba_pack._bucket


def fuse_into_batch(m: Map, rig: CameraRig, cfg: SystemConfig,
                    scale_factors: np.ndarray, level_scales,
                    targets: List[KeyFrame], mids: List[int],
                    radius: float = 3.0, cam_enabled=None) -> int:
    """Fuse one point set into MANY target keyframes with a single device
    dispatch (the SearchInNeighbors fan-out, LocalMapping.cc:492-570).

    The batch is padded to a small set of compile-size buckets so the
    vmapped program compiles a handful of times total.  The host-side
    merge (observation add / MapPoint::Replace) stays sequential per
    target, preserving the single-target semantics."""
    if not targets:
        return 0
    if len(targets) == 1:
        return fuse_into(m, rig, cfg, scale_factors, level_scales,
                         targets[0], mids, radius, cam_enabled)
    mids, pos, desc, valid, dmax, dmin, normal = pack_points(
        m, cfg.capacity.max_local_mp, mids)
    if len(mids) < 5 or valid.sum() < 5:
        return 0
    ncam = cfg.n_cameras
    N = len(targets[0].kp_valid) // ncam
    device = rig.K.device
    if cam_enabled is None:
        cam_enabled = np.ones(ncam, bool)
    # truncated at the largest bucket as in the reference; its padding
    # (repeats of the last target, never read) is left out
    targets = targets[:_FUSE_BUCKETS[-1]]
    T = np.stack([t.T_cw for t in targets]).astype(np.float32)
    uv = np.stack([t.uv.reshape(ncam, N, 2) for t in targets]).astype(
        np.float32)
    dsc = np.stack([t.desc.reshape(ncam, N, 8) for t in targets]).astype(
        np.uint32)
    lvl = np.stack([t.level.reshape(ncam, N) for t in targets]).astype(
        np.int64)
    val = np.stack([t.kp_valid.reshape(ncam, N) for t in targets])
    mp_of_kp, _ = frontend.project_and_match_batch(
        upload(T, device), upload(uv, device), upload(dsc, device),
        upload(lvl, device), upload(val, device),
        upload(pos, device), upload(desc, device), upload(valid, device),
        upload(dmax, device), upload(dmin, device), upload(normal, device),
        rig, float(radius), level_scales,
        float(cfg.matcher.th_low), 0.5, upload(cam_enabled, device))
    mp_of_kp = to_host((mp_of_kp,))[0]
    n = 0
    for i, t in enumerate(targets):
        n += _apply_fuse_matches(m, rig, cfg, scale_factors, t, mids,
                                 mp_of_kp[i])
    return n


def _apply_fuse_matches(m: Map, rig: CameraRig, cfg: SystemConfig,
                        scale_factors: np.ndarray, target: KeyFrame,
                        mids: List[int], mp_of_kp: np.ndarray) -> int:
    """Host half of Fuse: walk the device matches, add observations or
    merge duplicate points under the reprojection chi2 gate
    (ORBmatcher.cc:1490-1558)."""
    ncam = cfg.n_cameras
    N = len(target.kp_valid) // ncam
    T_sc, Ks = to_host((rig.T_sc, rig.K))
    sig2 = scale_factors ** 2
    chi2_th = cfg.mapping.fuse_chi2

    def reproj_chi2(p: np.ndarray, c: int, g: int) -> float:
        """Reprojection chi2 of world point p at target keypoint g."""
        T = T_sc[c] @ target.T_cw
        x = T[:3, :3] @ p + T[:3, 3]
        if x[2] < 1e-6:
            return np.inf
        u = Ks[c][0, 0] * x[0] / x[2] + Ks[c][0, 2]
        v = Ks[c][1, 1] * x[1] / x[2] + Ks[c][1, 2]
        e2 = (u - target.uv[g][0]) ** 2 + (v - target.uv[g][1]) ** 2
        return float(e2 / sig2[int(target.level[g])])

    n = 0
    for c in range(ncam):
        for row in np.nonzero(mp_of_kp[c] >= 0)[0]:
            mid = mids[int(mp_of_kp[c][row])]
            mp = m.points.get(mid)
            if mp is None or mp.is_bad:
                continue
            g = c * N + int(row)
            # the reference's Fuse accepts a candidate only under the
            # chi2 reprojection gate (ORBmatcher.cc:1490-1505) — the
            # descriptor window alone admits aliased matches
            if reproj_chi2(mp.pos, c, g) > chi2_th:
                continue
            cur = int(target.mp_idx[g])
            if cur < 0:
                if target.kid not in mp.obs:
                    m.add_observation(mp, target, g, c)
                    n += 1
            elif cur != mid:
                other = m.points.get(cur)
                if other is None or other.is_bad:
                    continue
                # merging collapses two 3D points into one — require the
                # incumbent to ALSO reproject within the gate, else the
                # match is aliasing distinct structure (repetitive
                # texture) and merging would drag geometry (the round-1
                # two-hop instability)
                if reproj_chi2(other.pos, c, g) > chi2_th:
                    continue
                # keep the more-observed point (MapPoint::Replace)
                if other.n_obs >= mp.n_obs:
                    m.replace_point(mp, other)
                else:
                    m.replace_point(other, mp)
                n += 1
    return n
