"""Loop closing: detection, Sim3 computation, correction, pose graph.

Port of orbslam2_dualcam_tpu/pipeline/loop_closing.py (src/LoopClosing.cc
in the original).  Detection uses the keyframe database's camera-0 index
with covisibility-consistency grouping (DetectLoop, :116-257); Sim3
computation runs the batched Horn RANSAC and the two-stage Sim3 optimizer,
widens the match by Sim3-guided projection and verifies by projecting the
loop region; correction carries the covisible window along, corrects its
map points per observing camera, fuses the loop region into it
(SearchAndFuse), solves the essential graph and finishes with a 10-step
global BA.

The bookkeeping is host numpy over the map, as in the reference; the
matchers, the solvers and BA run on the device the rig's tensors lie on.
`apply_sim3_correction` is shared with the tracker's cross-camera
anchoring.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from orbslam2_dualcam_tpu_torch.models.kfdb import KeyFrameDatabase
from orbslam2_dualcam_tpu_torch.models.map import (KeyFrame, Map,
                                                   update_point_stats)
from orbslam2_dualcam_tpu_torch.ops import matching, ransac
from orbslam2_dualcam_tpu_torch.ops.camera import CameraRig
from orbslam2_dualcam_tpu_torch.optim import pose_graph, sim3_opt
from orbslam2_dualcam_tpu_torch.parallel import runtime
from orbslam2_dualcam_tpu_torch.pipeline import ba_pack, frontend, local_mapping
from orbslam2_dualcam_tpu_torch.utils.config import SystemConfig
from orbslam2_dualcam_tpu_torch.utils.device import to_host, upload
from orbslam2_dualcam_tpu_torch.utils.profiling import StageTimer
from orbslam2_dualcam_tpu_torch.vocab import bow


class LoopCloser:
    """QUERY/RESP cameras are both cam0, as in the reference
    (LoopClosing.h:89-90); scale is free (7-DoF, LoopClosing.h:91).

    The Sim3 RANSAC's minimal sets are drawn on the CPU from the closer's
    own generator (seeded 7, where the reference splits `PRNGKey(7)` once
    per candidate that reaches RANSAC); `sim3_sampler` may be replaced by a
    callable (n_hyp, valid) -> idx [n_hyp, 3]."""

    def __init__(self, cfg: SystemConfig, rig: CameraRig, slam_map: Map,
                 kfdb: KeyFrameDatabase, voc: bow.Vocabulary,
                 mesh=None) -> None:
        """`mesh`: an optional parallel.runtime.Mesh for the global BA."""
        self.cfg = cfg
        self.mesh = mesh
        self.rig = rig
        self.map = slam_map
        self.kfdb = kfdb
        self.voc = voc
        self.device = rig.K.device
        self.last_loop_kid = -1
        self.consistent_groups: List[Tuple[Set[int], int, int]] = []
        self.gen = torch.Generator().manual_seed(7)
        self.sim3_sampler = (
            lambda n_hyp, valid: ransac.sim3_samples(self.gen, n_hyp, valid))
        self.n_loops_closed = 0
        self.n_loop_fused = 0
        self._scale_factors = np.asarray(cfg.orb.scale_factors, np.float32)
        self._level_scales = torch.as_tensor(self._scale_factors,
                                             device=self.device)
        # host copies, read once: every later read would wait for the card
        self._K_np = to_host((rig.K,))[0].astype(np.float64)
        self.debug_log: List[str] = []
        self.timer = StageTimer("loop")

    # ------------------------------------------------------------------
    def on_new_keyframe(self, kf: KeyFrame) -> None:
        with self.timer("detect"):
            cands = self._detect(kf)
        if not cands:
            return
        with self.timer("sim3"):
            ok, Scw, loop_kf, matched_mids = self._compute_sim3(kf, cands)
        if not ok:
            return
        self._correct_loop(kf, loop_kf, Scw, matched_mids)

    # ------------------------------------------------------------------
    def _detect(self, kf: KeyFrame) -> List[int]:
        """DetectLoop (LoopClosing.cc:116-257)."""
        m = self.map
        cfg = self.cfg.loop
        if kf.kid < self.last_loop_kid + cfg.loop_kf_gap or \
                m.n_keyframes < cfg.loop_kf_gap:
            return []
        ncam = self.cfg.n_cameras
        N = len(kf.word) // ncam
        words = kf.word[:N]
        vvalid = kf.kp_valid[:N] & (words >= 0)
        vec = bow.sparse_bow(self.voc, words, vvalid)
        # min score vs covisible neighbours (LoopClosing.cc:130-151)
        min_score = 1.0
        for nkid in m.covisible_kfs(kf):
            nb = self.kfdb.bow[0].get(nkid)
            if nb is not None:
                min_score = min(min_score, bow.score_sparse(vec, nb))
        cands = self.kfdb.detect_loop_candidates(
            kf, np.where(vvalid, words, -1), vec, 0, 0, m, min_score)
        self.debug_log.append(
            f"kid={kf.kid} min_score={min_score:.3f} cands={cands[:6]}")
        if not cands:
            # age surviving groups through the miss budget instead of
            # clearing (see consistency note below)
            self.consistent_groups = [
                (g, c, mi + 1) for g, c, mi in self.consistent_groups
                if mi < 1 and c > 0]
            return []
        # covisibility-consistency accumulation (LoopClosing.cc:180-250),
        # with a one-detection miss budget: the reference requires strictly
        # consecutive detections, but its keyframes are ~3x sparser than
        # ours — a literal transcription breaks chains on a single
        # retrieval gap that the reference's cadence would never see
        enough: List[int] = []
        new_groups: List[Tuple[Set[int], int, int]] = []
        extended_prev: Set[int] = set()
        for kid in cands:
            ckf = m.keyframes.get(kid)
            if ckf is None:
                continue
            group = set(m.covisible_kfs(ckf)) | {kid}
            best = 0
            for gi, (prev_group, count, _misses) in enumerate(
                    self.consistent_groups):
                if group & prev_group:
                    best = max(best, count + 1)
                    extended_prev.add(gi)
            new_groups.append((group, best, 0))
            if best >= self.cfg.loop.covisibility_consistency_th:
                enough.append(kid)
        # carry over groups that missed this round (miss budget 1)
        for gi, (prev_group, count, misses) in enumerate(
                self.consistent_groups):
            if gi not in extended_prev and misses < 1 and count > 0:
                new_groups.append((prev_group, count, misses + 1))
        self.consistent_groups = new_groups
        if enough:
            self.debug_log.append(f"kid={kf.kid} consistent={enough}")
        return enough

    # ------------------------------------------------------------------
    def _match(self, kf: KeyFrame, lkf: KeyFrame, N: int, with_nodes: bool):
        """Camera-0 descriptor match of kf's mapped features against lkf's,
        within vocabulary nodes or not.  Returns idx [N] (host)."""
        dev = self.device
        res = matching.match_masked(
            upload(kf.desc[:N].astype(np.uint32), dev),
            upload(lkf.desc[:N].astype(np.uint32), dev),
            allow=(matching.node_mask(upload(kf.node[:N], dev),
                                      upload(lkf.node[:N], dev))
                   if with_nodes else None),
            valid_a=upload(kf.kp_valid[:N] & (kf.mp_idx[:N] >= 0), dev),
            valid_b=upload(lkf.kp_valid[:N] & (lkf.mp_idx[:N] >= 0), dev),
            max_dist=float(self.cfg.matcher.th_low),
            ratio=self.cfg.matcher.nn_ratio_bow)
        return to_host((res.idx,))[0]

    def _compute_sim3(self, kf: KeyFrame, cands: List[int]):
        """ComputeSim3 (LoopClosing.cc:260-466): BoW match map points of the
        candidate against kf's cam0 features, Horn Sim3 RANSAC in the two
        camera frames, then guided projection widening."""
        m = self.map
        ncam = self.cfg.n_cameras
        N = len(kf.kp_valid) // ncam
        dev = self.device
        K0 = self.rig.K[0]
        fix_scale = self.cfg.loop.fix_scale
        min_inl = self.cfg.loop.min_sim3_inliers
        for kid in cands[:5]:
            lkf = m.keyframes.get(kid)
            if lkf is None:
                continue
            idx = self._match(kf, lkf, N, with_nodes=True)
            rows = np.nonzero(idx >= 0)[0]
            if len(rows) < 2 * min_inl:
                # descriptor-only retry: with a coarse trained vocabulary
                # the FeatureVector node mask drops true pairs the
                # reference's 1e6-word ORBvoc would keep — the mutual +
                # ratio tests carry the rejection instead (the same
                # fallback the cross-camera reloc uses)
                idx2 = self._match(kf, lkf, N, with_nodes=False)
                rows2 = np.nonzero(idx2 >= 0)[0]
                if len(rows2) > len(rows):
                    idx, rows = idx2, rows2
            self.debug_log.append(
                f"sim3 kid={kf.kid} cand={kid} bow={len(rows)}")
            if len(rows) < self.cfg.loop.min_bow_matches:
                continue
            # matched MP positions in each KF's cam0 frame
            pairs = [(int(kf.mp_idx[r]), int(lkf.mp_idx[idx[r]])) for r in rows]
            P1, P2, uv1, uv2, s1, s2, pair_mids = self._pair_arrays(
                kf, lkf, pairs, N, rows=list(zip(rows, idx[rows])))
            if len(P1) < self.cfg.loop.min_bow_matches:
                continue
            n = len(P1)
            sets = self.sim3_sampler(128, torch.ones(n, dtype=torch.bool))
            P1_d, P2_d, uv1_d, uv2_d, s1_d, s2_d = (
                upload(a, dev) for a in (P1, P2, uv1, uv2, s1, s2))
            valid_d = torch.ones(n, dtype=torch.bool, device=dev)
            R, t, s, inl, cnt, ok = ransac.sim3_solve(
                sets.to(dev), P1_d, P2_d, valid_d, uv1_d, uv2_d, K0, K0,
                s1_d, s2_d, fix_scale=fix_scale)
            R, t, s, cnt, ok = to_host((R, t, s, cnt, ok))
            if not bool(ok) or int(cnt) < min_inl:
                continue
            # refine with the two-stage Sim3 optimization
            # (OptimizeSim3, Optimizer.cc:976-1178)
            S12_0 = np.eye(4, dtype=np.float32)
            S12_0[:3, :3] = s * R
            S12_0[:3, 3] = t
            S12_r, inl2, cnt2 = sim3_opt.optimize_sim3(
                upload(S12_0, dev), P1_d, P2_d, uv1_d, uv2_d, 1.0 / s1_d,
                1.0 / s2_d, inl, K0, K0, fix_scale=fix_scale)
            S12_r, inl2, cnt2 = to_host((S12_r, inl2, cnt2))
            if int(cnt2) < min_inl:
                continue
            # S_cw = S_c1_c2 * T_c2_w  (cam0 frames; LoopClosing.cc:377-387
            # composes through the extrinsic when query cam != 0 — here both
            # are cam0 as in the reference config)
            S12 = S12_r.astype(np.float64)
            sim3_pairs = [pm for pm, keep in zip(pair_mids, inl2) if keep]
            # --- SearchBySim3CrossCam widening (LoopClosing.cc:362,
            # ORBmatcher.cc:1713): mutual Sim3-guided projection re-match
            # between the two keyframes' cam0 features, then re-optimize
            # the Sim3 on the widened pair set.
            widened = self._sim3_widen(kf, lkf, S12, N)
            all_pairs = dict(sim3_pairs)
            for m1, m2 in widened:
                all_pairs.setdefault(m1, m2)
            if len(all_pairs) > len(sim3_pairs):
                P1b, P2b, uv1b, uv2b, s1b, s2b, pairs_b = \
                    self._pair_arrays(kf, lkf, list(all_pairs.items()), N)
                if len(P1b) >= min_inl:
                    S12_r2, inl3, cnt3 = sim3_opt.optimize_sim3(
                        upload(S12.astype(np.float32), dev),
                        upload(P1b, dev), upload(P2b, dev),
                        upload(uv1b, dev), upload(uv2b, dev),
                        1.0 / upload(s1b, dev), 1.0 / upload(s2b, dev),
                        torch.ones(len(P1b), dtype=torch.bool, device=dev),
                        K0, K0, fix_scale=fix_scale)
                    S12_r2, inl3, cnt3 = to_host((S12_r2, inl3, cnt3))
                    if int(cnt3) >= min_inl:
                        S12 = S12_r2.astype(np.float64)
                        sim3_pairs = [pm for pm, keep in
                                      zip(pairs_b, inl3) if keep]
            Scw = S12 @ lkf.T_cw
            # --- guided-projection acceptance (LoopClosing.cc:417-466):
            # project the loop keyframe's NEIGHBORHOOD map points through
            # Scw into kf and demand >= min_total_matches total matches
            # before accepting the loop.
            loop_mids = self._loop_region_mids(lkf)
            proj_pairs, proj_adds, n_proj = self._match_loop_points(
                kf, Scw, loop_mids, N)
            matched = dict(sim3_pairs)
            for m1, m2 in proj_pairs:
                matched.setdefault(m1, m2)
            total = len(matched) + len(proj_adds)
            self.debug_log.append(
                f"sim3 kid={kf.kid} cand={kid} widened={len(all_pairs)} "
                f"proj={n_proj} total={total}")
            if total < self.cfg.loop.min_total_matches:
                continue
            return True, Scw, lkf, (list(matched.items()), proj_adds,
                                    loop_mids)
        return False, None, None, None

    # ------------------------------------------------------------------
    def _pair_arrays(self, kf: KeyFrame, lkf: KeyFrame, pairs, N: int,
                     rows=None):
        """Build the per-pair arrays optimize_sim3 consumes from
        (mid1, mid2) map-point pairs (positions in each KF's cam0 frame).
        `rows`, when given, are the pairs' (row in kf, row in lkf); else
        each point's camera-0 row in its keyframe."""
        m = self.map
        if rows is None:
            row1 = {int(kf.mp_idx[r]): r for r in range(N)
                    if kf.mp_idx[r] >= 0}
            row2 = {int(lkf.mp_idx[r]): r for r in range(N)
                    if lkf.mp_idx[r] >= 0}
            rows = [(row1.get(m1), row2.get(m2)) for m1, m2 in pairs]
        sf = self.cfg.orb.scale_factors
        P1, P2, uv1, uv2, s1, s2, keep = [], [], [], [], [], [], []
        for (m1, m2), (r1, r2) in zip(pairs, rows):
            mp1, mp2 = m.points.get(m1), m.points.get(m2)
            if mp1 is None or mp2 is None or r1 is None or r2 is None:
                continue
            P1.append(kf.T_cw[:3, :3] @ mp1.pos + kf.T_cw[:3, 3])
            P2.append(lkf.T_cw[:3, :3] @ mp2.pos + lkf.T_cw[:3, 3])
            uv1.append(kf.uv[r1])
            uv2.append(lkf.uv[r2])
            s1.append(sf[int(kf.level[r1])] ** 2)
            s2.append(sf[int(lkf.level[r2])] ** 2)
            keep.append((m1, m2))
        return (np.asarray(P1, np.float32).reshape(-1, 3),
                np.asarray(P2, np.float32).reshape(-1, 3),
                np.asarray(uv1, np.float32).reshape(-1, 2),
                np.asarray(uv2, np.float32).reshape(-1, 2),
                np.asarray(s1, np.float32), np.asarray(s2, np.float32), keep)

    def _sim3_widen(self, kf: KeyFrame, lkf: KeyFrame, S12: np.ndarray,
                    N: int, radius: float = 7.5):
        """ORBmatcher::SearchBySim3CrossCam (ORBmatcher.cc:1713-1831):
        allow a feature pair (i in kf, j in lkf) when each one's map point
        projects near the other feature under the Sim3 (mutual gate), then
        Hamming-match within that allowance.  Returns (mid1, mid2) pairs."""
        m = self.map
        K = self._K_np[0]
        sf = np.asarray(self.cfg.orb.scale_factors)
        R12, t12, s12 = _sim3_parts(S12)
        S21 = np.eye(4)
        S21[:3, :3] = (1.0 / s12) * R12.T
        S21[:3, 3] = -(1.0 / s12) * (R12.T @ t12)

        # world positions of each side's map points (cam0 rows)
        def side(kfx):
            mids = np.full(N, -1, np.int64)
            X = np.zeros((N, 3))
            ok = np.zeros(N, bool)
            for r in range(N):
                mid = int(kfx.mp_idx[r])
                if mid < 0:
                    continue
                mp = m.points.get(mid)
                if mp is None or mp.is_bad:
                    continue
                mids[r] = mid
                X[r] = mp.pos
                ok[r] = True
            return mids, X, ok
        mids1, X1, ok1 = side(kf)
        mids2, X2, ok2 = side(lkf)
        if ok1.sum() < 5 or ok2.sum() < 5:
            return []
        # lkf's points into kf's image through Scw=S12*T2w (as SE3 [R,t/s])
        uv2in1, front2 = _project_host(K, _se3_of_sim3(S12 @ lkf.T_cw), X2)
        # kf's points into lkf's image through S21*T1w
        uv1in2, front1 = _project_host(K, _se3_of_sim3(S21 @ kf.T_cw), X1)
        r2 = radius * sf[np.clip(kf.level[:N], 0, len(sf) - 1)]
        r1 = radius * sf[np.clip(lkf.level[:N], 0, len(sf) - 1)]
        # mutual window gate: allow[i, j]
        d_a = np.linalg.norm(kf.uv[:N, None, :] - uv2in1[None, :, :], axis=2)
        d_b = np.linalg.norm(lkf.uv[None, :N, :] - uv1in2[:, None, :], axis=2)
        allow = ((d_a < r2[:, None]) & front2[None, :] &
                 (d_b < r1[None, :]) & front1[:, None])
        dev = self.device
        res = matching.match_masked(
            upload(kf.desc[:N].astype(np.uint32), dev),
            upload(lkf.desc[:N].astype(np.uint32), dev),
            allow=upload(allow, dev),
            valid_a=upload(kf.kp_valid[:N] & ok1, dev),
            valid_b=upload(lkf.kp_valid[:N] & ok2, dev),
            max_dist=float(self.cfg.matcher.th_high), ratio=1.0)
        idx = to_host((res.idx,))[0]
        return [(int(mids1[r]), int(mids2[idx[r]]))
                for r in np.nonzero(idx >= 0)[0]]

    def _loop_region_mids(self, lkf: KeyFrame) -> List[int]:
        """Map points of the loop keyframe and its covisible neighbours
        (mvpLoopMapPoints, LoopClosing.cc:417-438)."""
        m = self.map
        mids: Set[int] = set()
        for kid in [lkf.kid] + m.covisible_kfs(lkf, 10):
            okf = m.keyframes.get(kid)
            if okf is None:
                continue
            mids.update(int(x) for x in okf.mp_idx[okf.mp_idx >= 0])
        return sorted(mids)

    def _match_loop_points(self, kf: KeyFrame, Scw: np.ndarray,
                           loop_mids: List[int], N: int,
                           radius: float = 10.0):
        """SearchByProjection with a Sim3 pose (ORBmatcher.cc:1565-1650):
        match loop-region points into kf's cam0 features.  Returns
        (replace_pairs, add_rows, n_matched): (cur_mid, loop_mid) pairs
        where kf already has a point, (row, loop_mid) where it doesn't."""
        m = self.map
        mids, pos, desc, valid, dmax, dmin, normal = \
            local_mapping.pack_points(m, self.cfg.capacity.max_local_mp,
                                      loop_mids)
        if len(mids) < 5:
            return [], [], 0
        ncam = self.cfg.n_cameras
        cam_en = np.zeros(ncam, bool)
        cam_en[0] = True
        dev = self.device
        mp_of_kp, _ = frontend.project_and_match(
            upload(_se3_of_sim3(Scw).astype(np.float32), dev),
            upload(kf.uv.reshape(ncam, -1, 2)[:, :N].astype(np.float32), dev),
            upload(kf.desc.reshape(ncam, -1, 8)[:, :N].astype(np.uint32), dev),
            upload(kf.level.reshape(ncam, -1)[:, :N].astype(np.int64), dev),
            upload(kf.kp_valid.reshape(ncam, -1)[:, :N], dev),
            upload(pos, dev), upload(desc, dev), upload(valid, dev),
            # the frustum gate measures |X - cc| with cc the WORLD-frame
            # center of [R, t/s] (= the Sim3 camera's center), so it is
            # already in map units like the stored dmin/dmax — do NOT
            # rescale by s (the reference's SearchByProjection(Scw) gates
            # with unscaled min/max distance for the same reason,
            # ORBmatcher.cc:1560-1650)
            upload(dmax, dev), upload(dmin, dev), upload(normal, dev),
            self.rig, float(radius), self._level_scales,
            float(self.cfg.matcher.th_low), 0.5, upload(cam_en, dev))
        slots = to_host((mp_of_kp,))[0][0]
        replace_pairs, add_rows = [], []
        n_matched = 0
        for row in np.nonzero(slots >= 0)[0]:
            loop_mid = mids[int(slots[row])]
            n_matched += 1
            cur = int(kf.mp_idx[row])
            if cur >= 0 and cur != loop_mid:
                replace_pairs.append((cur, loop_mid))
            elif cur < 0:
                add_rows.append((int(row), loop_mid))
        return replace_pairs, add_rows, n_matched

    # ------------------------------------------------------------------
    def _correct_loop(self, kf: KeyFrame, loop_kf: KeyFrame,
                      Scw: np.ndarray, matched) -> None:
        """CorrectLoop (LoopClosing.cc:469-701): Sim3-propagate corrections
        to the covisible window, correct their map points per observing
        camera, fuse duplicates, then pose-graph + global BA."""
        matched_pairs, proj_adds, loop_mids = matched
        m = self.map
        ncam = self.cfg.n_cameras

        def fuse_fn():
            # attach loop points matched to currently-unassociated rows
            # (LoopClosing.cc:558-565): they become direct observations
            for row, lmid in proj_adds:
                mp = m.points.get(lmid)
                if (mp is not None and not mp.is_bad and
                        kf.kid not in mp.obs and int(kf.mp_idx[row]) < 0):
                    m.add_observation(mp, kf, row, 0)
            # SearchAndFuse (LoopClosing.cc:703-733): project the loop
            # region's points into every corrected window KF (Scw th=4)
            # and merge duplicates — this is what welds the two ends of
            # the loop into one map instead of two overlapping sheets
            n_f = 0
            # sibling cameras only consume map points once the map is
            # metric (bMapScaled gating, ORBmatcher.cc:128-144) — before
            # that their meters-valued extrinsic projects garbage into an
            # arbitrary-scale map
            cam_en = np.zeros(ncam, bool)
            cam_en[0] = True
            if m.map_scaled or ncam == 1:
                cam_en[:] = True
            for kid in [kf.kid] + m.covisible_kfs(kf):
                wkf = m.keyframes.get(kid)
                if wkf is None:
                    continue
                n_f += local_mapping.fuse_into(
                    m, self.rig, self.cfg, self._scale_factors,
                    self._level_scales, wkf, loop_mids, radius=4.0,
                    cam_enabled=cam_en)
            self.n_loop_fused += n_f
            self.debug_log.append(
                f"fuse kid={kf.kid} adds={len(proj_adds)} fused={n_f}")

        with self.timer("correct"):
            apply_sim3_correction(
                self.map, self.rig, kf, loop_kf, Scw, matched_pairs,
                fix_scale=self.cfg.loop.fix_scale,
                pose_graph_iters=self.cfg.ba.pose_graph_iters,
                fuse_fn=fuse_fn, scale_factors=self._scale_factors,
                timer=self.timer)
        self.last_loop_kid = kf.kid
        self.n_loops_closed += 1
        with self.timer("global_ba"):
            self._global_ba()

    def _global_ba(self) -> None:
        """Global BA over every keyframe, 10 LM steps of 24 PCG iterations
        with the default BA settings, sharded over the closer's mesh when it
        is large enough."""
        m = self.map
        kids = sorted(m.keyframes.keys())
        fixed = {m.origin_kid}
        if m.first_scale_kid >= 0:
            fixed.add(m.first_scale_kid)
        prob, all_kids, mids, meta = ba_pack.pack_problem(
            m, kids, fixed_kids=fixed,
            level_sigma2=np.asarray(self.cfg.orb.level_sigma2, np.float32),
            ncam=self.cfg.n_cameras, device=self.device)
        res = runtime.solve_ba_auto(prob, self.rig.T_sc, self.rig.adj_sc,
                                    self.rig.K, iters=10, mesh=self.mesh)
        ba_pack.unpack_result(m, res, all_kids, mids, meta,
                              chi2_th=self.cfg.ba.chi2_mono)
        # full-map writeback: invalidate stale concurrent local-BA
        # snapshots (see Map.geometry_epoch)
        m.geometry_epoch += 1


def _sim3_parts(S: np.ndarray):
    sR = S[:3, :3]
    s = float(np.cbrt(np.linalg.det(sR)))
    return sR / s, S[:3, 3].copy(), s


def _se3_of_sim3(S: np.ndarray) -> np.ndarray:
    """[R, t/s]: the SE3 whose pinhole projections equal the Sim3's
    (projection is invariant to scaling camera coordinates)."""
    R, t, s = _sim3_parts(S)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t / s
    return T


def _project_host(K: np.ndarray, T: np.ndarray, X: np.ndarray):
    """Project world points X [M,3] through pose T into pixels.  Returns
    (uv [M,2], in_front [M])."""
    x = X @ T[:3, :3].T + T[:3, 3]
    z = np.maximum(x[:, 2], 1e-9)
    u = x[:, 0] / z * K[0, 0] + K[0, 2]
    v = x[:, 1] / z * K[1, 1] + K[1, 2]
    return np.stack([u, v], 1), x[:, 2] > 1e-6


def apply_sim3_correction(m: Map, rig, kf: KeyFrame, loop_kf: KeyFrame,
                          Scw: np.ndarray, matched_mids,
                          fix_scale: bool = False,
                          pose_graph_iters: int = 40,
                          fuse_fn=None,
                          scale_factors: Optional[np.ndarray] = None,
                          timer: Optional[StageTimer] = None) -> None:
    """Sim3 window correction + essential-graph propagation, shared by
    loop closing and the dual pipeline's cross-camera anchoring.

    `Scw` is the corrected Sim3 pose of `kf` (world -> kf camera-0 frame,
    scale included); `kf`'s covisible window is rigidly carried along, its
    map points are transformed per observing keyframe
    (LoopClosing.cc:503-610), a loop edge kf<->loop_kf is added, and the
    7-DoF essential graph redistributes the remaining discrepancy
    (Optimizer::OptimizeEssentialGraph).  With `timer`, the fuse, the
    pose graph and the two passes of `update_point_stats` are timed as its
    stages "fuse", "pose_graph", "point_stats_window" and
    "point_stats_map"."""
    def stage(name):
        return timer(name) if timer is not None else contextlib.nullcontext()

    # snapshot pre-correction poses: the pose graph needs odometry-
    # consistent measurements (NonCorrectedSim3, LoopClosing.cc:520-540)
    old_poses = {kid: okf.T_cw.copy() for kid, okf in m.keyframes.items()}
    window = [kf.kid] + m.covisible_kfs(kf)
    corrections: Dict[int, np.ndarray] = {}
    T_kw = kf.T_cw
    for kid in window:
        okf = m.keyframes.get(kid)
        if okf is None:
            continue
        T_ik = okf.T_cw @ np.linalg.inv(T_kw)     # relative (SE3)
        S_iw = T_ik @ Scw                          # corrected Sim3
        corrections[kid] = S_iw
    # correct map points observed in the window through their
    # per-camera observer (LoopClosing.cc:574-593); remember which window
    # keyframe corrected each point (mnCorrectedByKF/mnCorrectedReference,
    # LoopClosing.cc:566-570) so the essential-graph remap moves it
    # exactly once
    corrected_mids: Dict[int, int] = {}
    for kid in window:
        okf = m.keyframes.get(kid)
        if okf is None:
            continue
        S_iw = corrections[kid]
        Ri, ti, si = _sim3_parts(S_iw)
        T_old = okf.T_cw
        for mid in okf.mp_idx[okf.mp_idx >= 0]:
            mid = int(mid)
            if mid in corrected_mids:
                continue
            mp = m.points.get(mid)
            if mp is None:
                continue
            corrected_mids[mid] = kid
            # x_cam(old) -> world(corrected): inv(S_iw) * T_old
            x_c = T_old[:3, :3] @ mp.pos + T_old[:3, 3]
            mp.pos = (Ri.T @ (x_c - ti)) / si
        # corrected SE3 pose: [R, t/s] (Optimizer.cc:962-967 convention)
        okf.T_cw = np.eye(4)
        okf.T_cw[:3, :3] = Ri
        okf.T_cw[:3, 3] = ti / si
    # merge matched loop points: current-KF point replaced by loop point.
    # The surviving loop-side point lives in old (loop) coordinates with a
    # loop-side reference KF, so it must NOT inherit the window's
    # corrected-by tag
    for mid_cur, mid_loop in matched_mids:
        a = m.points.get(mid_cur)
        b = m.points.get(mid_loop)
        if a is None or b is None or a.mid == b.mid:
            continue
        m.replace_point(a, b)
        corrected_mids.pop(a.mid, None)
    # refresh normals + scale-invariance distance bands of the corrected
    # points: their positions just scaled by 1/si, and the fuse below
    # gates on dmin/dmax (the reference calls UpdateNormalAndDepth per
    # corrected point, LoopClosing.cc:575-593)
    T_sc_np = to_host((rig.T_sc,))[0]
    sf = np.asarray(scale_factors) if scale_factors is not None else None
    if sf is not None:
        with stage("point_stats_window"):
            for mid in corrected_mids:
                mp = m.points.get(mid)
                if mp is not None:
                    update_point_stats(mp, m, T_sc_np, sf)
    # caller-provided fusion over the now-corrected window (SearchAndFuse,
    # LoopClosing.cc:703-733) — runs between correction and the pose graph
    # exactly as in the reference (CorrectLoop:616 before :641)
    if fuse_fn is not None:
        with stage("fuse"):
            fuse_fn()
    kf.loop_edges.add(loop_kf.kid)
    loop_kf.loop_edges.add(kf.kid)
    # pose graph over the essential graph, seeded with the full corrected
    # Sim3 of the window (vScw) so scale information survives
    with stage("pose_graph"):
        pose_graph.optimize_essential_graph(
            m, rig, loop_kid=loop_kf.kid, cur_kid=kf.kid,
            old_poses=old_poses, fix_scale=fix_scale,
            iters=pose_graph_iters, corrected_sim=corrections,
            corrected_mids=corrected_mids)
    # the essential-graph remap moved EVERY point (and every pose): bring
    # all stats back in sync before tracking resumes against this map
    if sf is not None:
        with stage("point_stats_map"):
            for mp in m.points.values():
                if not mp.is_bad:
                    update_point_stats(mp, m, T_sc_np, sf)
    m.geometry_epoch += 1
