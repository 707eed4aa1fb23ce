"""Relocalization by vocabulary and the cross-camera relocalization of the
port's tracker against the reference's, on one map and one keyframe
database: both are built once by the reference over a short mono run of a
small dual rig (2 x 320x240, 400 features, 4 levels, vocabulary 8^3 trained
on the scene's own descriptors) and carried across by `map_from_reference`
and `kfdb_from_reference`.  The query frames are the reference's extracted
features, copied as numpy, and the port's PnP is fed the minimal sets the
reference draws from its key stream.

Tolerances: candidate lists equal, accepted keyframe equal, pose within
2e-3, matched map-point ids >= 95% equal, scale estimate within 1%.

The last tests carry the bootstrap on from there, on both sides: three
cross-camera relocalizations anchored, the second map (scale solve,
attach, the 1-DoF scale refinement, the Sim3 window correction, metric
global BA), a relocalization after scaling, the mapper's cross-camera
harvest, the FULL state and the metric refresh.  Every event equal (names
and counts exactly, printed scales within 2e-4 relative), keyframe poses
within 1e-3 m, >= 98% of the map points within 1e-3 m and all within
1e-2 m, >= 99% of the observations equal."""

import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu.models import kfdb as ref_kfdb_mod
from orbslam2_dualcam_tpu.ops import orb as ref_orb
from orbslam2_dualcam_tpu.pipeline import system as ref_system
from orbslam2_dualcam_tpu.utils import config as ref_config
from orbslam2_dualcam_tpu.utils import synthetic as ref_synthetic
from orbslam2_dualcam_tpu.vocab import bow as ref_bow
from orbslam2_dualcam_tpu_torch.models import kfdb as port_kfdb_mod
from orbslam2_dualcam_tpu_torch.ops import camera
from orbslam2_dualcam_tpu_torch.pipeline import local_mapping, tracking
from orbslam2_dualcam_tpu_torch.utils.convert import (config_from_reference,
                                                      kfdb_from_reference,
                                                      map_from_reference,
                                                      vocab_from_numpy)

from test_torch_pnp import reference_sets
from torch_parity import map_snapshot

N_FRAMES = 22


def _ref_cfg():
    C = ref_config
    cam = dict(width=320, height=240, fx=260, fy=260, cx=160, cy=120)
    return C.SystemConfig(
        cameras=(C.CameraConfig(**cam),
                 C.CameraConfig(**cam, q_sc=(0.0, 0.0, 1.0, 0.0),
                                t_sc=(0.0, 0.0, 0.50))),
        orb=C.OrbConfig(n_features=400, n_levels=4),
        mapping=C.MappingConfig(cull_found_ratio=0.1),
        vocab=C.VocabConfig(branching=8, depth=3),
        tracker=C.TrackerConfig(reloc_gap_try=4, reloc_gap_fail=4,
                                num_frame_in_secondmap=3),
        capacity=C.CapacityConfig(max_local_mp=2048))


class RefKeyStream:
    """The port's `pnp_sampler`, drawing what the reference draws: each
    call splits the key as `Tracker._next_key` does."""

    def __init__(self, key):
        self.key = key
        self.calls = 0

    def __call__(self, n_hyp, valid):
        self.key, k = jax.random.split(self.key)
        self.calls += 1
        idx6, idx4 = reference_sets(k, n_hyp, valid.cpu().numpy())
        return torch.as_tensor(np.array(idx6)), torch.as_tensor(np.array(idx4))


def build_world_and_map():
    """The reference's system after N_FRAMES of the walk, and what the port
    needs to stand on the same state."""
    import jax.numpy as jnp
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    # the pure-Python postings on both sides: their dict order breaks
    # score ties, and the C++ index cannot be read back
    mp.setattr(ref_kfdb_mod, "NativeInvertedFile", None)
    mp.setattr(port_kfdb_mod, "NativeInvertedFile", None)
    rcfg = _ref_cfg()
    world = ref_synthetic.make_box_world(np.random.default_rng(3), half=6.0)
    K = np.array([[260.0, 0, 160], [0, 260, 120], [0, 0, 1]])
    descs = []
    for T in ref_synthetic.orbit_trajectory(10, radius=1.0):
        img = ref_synthetic.render(world, K, T, H=240, W=320)
        f = ref_orb.extract_orb(jnp.asarray(img), rcfg.orb, 400)
        descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
    rvoc = ref_bow.train_vocabulary(np.concatenate(descs), branching=8,
                                    depth=3, seed=9, weight_docs=descs)
    rsys = ref_system.System(rcfg, voc=rvoc, enable_loop_closing=False)
    mp.undo()
    assert rsys.kfdb.native is None
    poses = ref_synthetic.out_and_back_trajectory(n_out=26, n_turn=30,
                                                  n_back=26)
    Ks, T_sc = np.asarray(rsys.rig.K), np.asarray(rsys.rig.T_sc)
    for k in range(N_FRAMES):
        imgs = ref_synthetic.render_rig(world, Ks, T_sc, poses[k], H=240, W=320)
        rsys.track(imgs, k / 30.0)
    assert rsys.tracker.state == "OK" and rsys.map.n_keyframes >= 5, \
        rsys.tracker.events

    cfg = config_from_reference(rcfg)
    rig = camera.make_rig(cfg, device="cpu")
    voc = vocab_from_numpy(
        rvoc._replace(centroids=tuple(np.asarray(c) for c in rvoc.centroids),
                      idf=np.asarray(rvoc.idf)), device="cpu")
    return dict(world=world, poses=poses, rsys=rsys, cfg=cfg, rig=rig, voc=voc,
                Ks=Ks, T_sc=T_sc)


@pytest.fixture(scope="module")
def world_and_map():
    return build_world_and_map()


def _port_tracker(s):
    """A port tracker on copies of the reference's map and database as they
    are now."""
    return tracking.Tracker(s["cfg"], s["rig"], s["voc"],
                            map_from_reference(s["rsys"].map),
                            kfdb_from_reference(s["rsys"].kfdb))


def _frames(s, T_world, T_track=None, frame_id=900):
    """The reference's HostFrame of the rig rendered at world pose
    `T_world`, and its copy for the port."""
    rt = s["rsys"].tracker
    imgs = ref_synthetic.render_rig(s["world"], s["Ks"], s["T_sc"], T_world,
                                    H=240, W=320)
    fr = rt._pull(rt.extract(rt._stage_images(imgs)), 9.0, frame_id=frame_id)
    fp = tracking.HostFrame(
        frame_id=frame_id, timestamp=9.0, uv=np.array(fr.uv), level=np.array(fr.level),
        angle=np.array(fr.angle), desc=np.array(fr.desc), valid=np.array(fr.valid),
        words=np.array(fr.words).astype(np.int64),
        nodes=np.array(fr.nodes).astype(np.int64),
        mp_ids=np.full(fr.valid.shape, -1, np.int64),
        response=np.array(fr.response))
    if T_track is not None:
        fr.T_cw = T_track.copy()
        fp.T_cw = T_track.copy()
    return fr, fp


def _copy_frame(f):
    """A reference HostFrame with a pose, as the port's."""
    return tracking.HostFrame(
        frame_id=f.frame_id, timestamp=f.timestamp, uv=np.array(f.uv),
        level=np.array(f.level), angle=np.array(f.angle),
        desc=np.array(f.desc), valid=np.array(f.valid),
        words=np.array(f.words), nodes=np.array(f.nodes),
        T_cw=f.T_cw.copy(), mp_ids=np.array(f.mp_ids))


def _same_ids(a, b):
    both = (a >= 0) | (b >= 0)
    return (a[both] == b[both]).mean(), int(both.sum())


def test_state_is_carried_across(world_and_map):
    s = world_and_map
    pt = _port_tracker(s)
    rdb, pdb = s["rsys"].kfdb, pt.kfdb
    assert set(pdb.bow[0]) == set(rdb.bow[0]) == set(s["rsys"].map.keyframes)
    kf_r = s["rsys"].map.keyframes[max(s["rsys"].map.keyframes)]
    kf_p = pt.map.keyframes[kf_r.kid]
    np.testing.assert_array_equal(kf_p.word, kf_r.word)
    np.testing.assert_array_equal(kf_p.node, kf_r.node)
    assert (kf_p.word[:400] >= 0).any()
    assert (kf_p.connected_to_second_map, kf_p.not_erase, kf_p.scaled,
            kf_p.loop_edges) == (kf_r.connected_to_second_map, kf_r.not_erase,
                                 kf_r.scaled, kf_r.loop_edges)
    mp_r = next(iter(s["rsys"].map.points.values()))
    mp_p = pt.map.points[mp_r.mid]
    assert (mp_p.first_view_cam, mp_p.obs_cam) == (mp_r.first_view_cam,
                                                   mp_r.obs_cam)
    assert (pt.map.map_scaled, pt.map.first_scale_kid) == \
        (s["rsys"].map.map_scaled, s["rsys"].map.first_scale_kid)


def test_relocalize_by_vocabulary_equals_reference(world_and_map):
    """A frame two thirds along the mapped stretch, after a forced loss."""
    s = world_and_map
    rt = s["rsys"].tracker
    pt = _port_tracker(s)
    fr, fp = _frames(s, s["poses"][14])
    # the reference, recording which keyframe it accepts
    accepted = []
    orig = rt._reloc_against_kf
    rt._reloc_against_kf = lambda f, kf, **kw: (
        accepted.append(kf.kid) if orig(f, kf, **kw) else None) is None and \
        bool(accepted)
    stream = RefKeyStream(rt.key)
    try:
        ok_ref = rt._relocalize(fr)
    finally:
        rt._reloc_against_kf = orig
    pt.pnp_sampler = stream
    # the port, recording its candidates and the keyframe it accepts
    got_cands, got_accepted = [], []
    detect, against = pt.kfdb.detect_reloc_candidates, pt._reloc_against_kf
    pt.kfdb.detect_reloc_candidates = lambda *a: (
        got_cands.append(detect(*a)), got_cands[-1])[1]
    pt._reloc_against_kf = lambda f, kf, **kw: (
        got_accepted.append(kf.kid) if against(f, kf, **kw) else None) \
        is None and bool(got_accepted)
    ok = pt._relocalize(fp)
    assert ok and ok_ref
    words = fr.words[0]
    vvalid = fr.valid[0] & (words >= 0)
    want_cands = rt.kfdb.detect_reloc_candidates(
        np.where(vvalid, words, -1), ref_bow.sparse_bow(rt.voc, words, vvalid),
        0, 0, rt.map)
    assert got_cands == [want_cands] and want_cands
    assert got_accepted == accepted[:1]
    np.testing.assert_allclose(fp.T_cw, fr.T_cw, atol=2e-3)
    same, n = _same_ids(fp.mp_ids, fr.mp_ids)
    assert n >= 30 and same >= 0.95, (same, n)
    assert pt.velocity is None
    # the keys the port's sampler consumed are the ones the reference did
    np.testing.assert_array_equal(np.asarray(stream.key), np.asarray(rt.key))


def test_force_lost_relocalizes_through_process(world_and_map):
    """`force_lost` on a tracking port tracker: the next frame is LOST at
    once and found again by vocabulary in the same call."""
    s = world_and_map
    pt = _port_tracker(s)
    rt = s["rsys"].tracker
    # a tracker in the state the reference's is in
    pt.state = pt.OK
    pt.frame_id = rt.frame_id
    pt.ref_kid = rt.ref_kid
    pt.last_kf_frame_id = rt.last_kf_frame_id
    pt.last = _copy_frame(rt.last)
    pt.localization_only = True      # the map is the fixture's: extend nothing
    pt.force_lost()
    imgs = ref_synthetic.render_rig(s["world"], s["Ks"], s["T_sc"],
                                    s["poses"][N_FRAMES], H=240, W=320)
    state = pt.process(imgs, N_FRAMES / 30.0)
    assert state == "OK", pt.events
    assert pt.events[-2:] == [f"FORCED_LOST@{rt.frame_id}",
                              f"RELOC@{rt.frame_id}"]
    assert "relocalize" in pt.timer.samples
    T_true_rel = s["poses"][N_FRAMES] @ np.linalg.inv(s["poses"][N_FRAMES - 1])
    T_rel = pt.last.T_cw @ np.linalg.inv(rt.last.T_cw)
    np.testing.assert_allclose(T_rel[:3, :3], T_true_rel[:3, :3], atol=0.02)


def test_cross_camera_reloc_equals_reference(world_and_map):
    """The rig turned 180 degrees in place at a mapped keyframe: camera 1
    now sees what camera 0 mapped."""
    s = world_and_map
    rt = s["rsys"].tracker
    pt = _port_tracker(s)
    kid = sorted(s["rsys"].map.keyframes)[len(s["rsys"].map.keyframes) // 2]
    kf = s["rsys"].map.keyframes[kid]
    R180 = np.diag([-1.0, 1.0, -1.0, 1.0])
    fr, fp = _frames(s, R180 @ s["poses"][kf.frame_id], T_track=R180 @ kf.T_cw)
    n_ev_r, n_ev_p = len(rt.events), len(pt.events)
    stream = RefKeyStream(rt.key)
    pt.pnp_sampler = stream
    ok_ref = rt._try_cross_camera_reloc(fr)
    ok = pt._try_cross_camera_reloc(fp)
    ev_r, ev_p = rt.events[n_ev_r:], pt.events[n_ev_p:]
    assert ok_ref and ok, (ev_r, ev_p)
    # XTRY carries the candidate list: equal, letter for letter
    assert ev_p[0] == ev_r[0] and ev_r[0].startswith("XTRY@900 cands=[")
    assert [e.split()[0:2] for e in ev_p] == [e.split()[0:2] for e in ev_r]
    kid_r, pairs_r, T_r, s_r = rt._last_xreloc
    kid_p, pairs_p, T_p, s_p = pt._last_xreloc
    assert kid_p == kid_r
    np.testing.assert_allclose(T_p, T_r, atol=2e-3)
    assert s_p == pytest.approx(s_r, rel=0.01)
    assert pt.cross_reloc_scales == pytest.approx(rt.cross_reloc_scales[-1:],
                                                  rel=0.01)
    common = set(pairs_p) & set(pairs_r)
    assert len(pairs_r) >= 25
    assert len(common) >= 0.95 * max(len(pairs_p), len(pairs_r))
    np.testing.assert_array_equal(np.asarray(stream.key), np.asarray(rt.key))
    # the anchor that follows: the frame becomes a protected keyframe
    pt.last_kf_frame_id = -1
    n_kf = pt.map.n_keyframes
    pt._anchor_cross_reloc(fp)
    assert pt.map.n_keyframes == n_kf + 1
    akid, apairs, _, _ = pt.pending_cross[-1]
    assert pt.map.keyframes[akid].not_erase and apairs == pairs_p
    assert pt.events[-1].startswith("XANCHOR@900")
    assert set(pt.kfdb.bow[1]) >= {akid}
    pt._clear_pending_cross()
    assert not pt.map.keyframes[akid].not_erase and not pt.pending_cross


# ---------------------------------------------------------------------------
# the bootstrap after the cross-camera relocalization.  These tests come
# last: the fixture carries the reference's own map through the bootstrap.
# ---------------------------------------------------------------------------

TAIL_YAWS = (-12.0, 0.0, 12.0)     # degrees off the half turn, per anchor
POST_YAW, POST_DRIFT = 20.0, 0.08  # the frame after scaling: 8 cm off


def _yaw(deg):
    a = np.deg2rad(deg)
    R = np.eye(4)
    R[0, 0] = R[2, 2] = np.cos(a)
    R[0, 2], R[2, 0] = np.sin(a), -np.sin(a)
    return R


@pytest.fixture(scope="module")
def tail(world_and_map):
    """Both trackers, without a mapper behind them, taken through the rest
    of the bootstrap on the same frames; the port's PnP sets are the
    reference's.  Returns per stage (reference snapshot, port snapshot,
    reference events, port events)."""
    s = world_and_map
    rsys = s["rsys"]
    rt = rsys.tracker
    mapper_r = rt.local_mapper
    rt.local_mapper = None
    rt.cross_reloc_scales.clear()
    rt.pending_cross, rt._last_xreloc = [], None
    pt = _port_tracker(s)
    pt.state, pt.frame_id, pt.ref_kid = rt.state, rt.frame_id, rt.ref_kid
    pt.last_kf_frame_id = rt.last_kf_frame_id
    pt.last = _copy_frame(rt.last)
    pt.velocity = None if rt.velocity is None else rt.velocity.copy()
    pt.pnp_sampler = RefKeyStream(rt.key)
    kids = sorted(rsys.map.keyframes)
    pick = [kids[1], kids[len(kids) // 2], kids[-2]]
    out = {}
    marks = [len(rt.events), len(pt.events)]

    def stage(name, ev_r=rt.events, ev_p=pt.events, extra=None):
        out[name] = (map_snapshot(rsys.map), map_snapshot(pt.map),
                     ev_r[marks[0]:], ev_p[marks[1]:], extra)
        marks[:] = [len(ev_r), len(ev_p)]

    def turned(kid, yaw, frame_id, drift=0.0):
        kf = rsys.map.keyframes[kid]
        R = _yaw(180.0 + yaw)
        T_track = R @ kf.T_cw
        T_track[2, 3] += drift
        return _frames(s, R @ s["poses"][kf.frame_id], T_track=T_track,
                       frame_id=frame_id)

    # the block of _track_tail before the map is metric
    for j, (kid, yaw) in enumerate(zip(pick, TAIL_YAWS)):
        fr, fp = turned(kid, yaw, 900 + j)
        for tr, f in ((rt, fr), (pt, fp)):
            assert tr._try_cross_camera_reloc(f), tr.events[-4:]
            tr._anchor_cross_reloc(f)
            if len(tr.cross_reloc_scales) >= \
                    s["cfg"].tracker.num_frame_in_secondmap:
                tr._create_second_map(f)
    stage("second_map", extra=(fr.T_cw.copy(), fp.T_cw.copy(),
                               rt.last.T_cw.copy(), pt.last.T_cw.copy()))

    # ... and after: camera 1 has tracked every second matched point, and
    # the tracked pose has drifted off the relocalized one
    fr, fp = turned(pick[0], POST_YAW, 910, drift=POST_DRIFT)
    for tr, f in ((rt, fr), (pt, fp)):
        assert tr._try_cross_camera_reloc(f), tr.events[-4:]
        for rf, mid in tr._last_xreloc[1][::2]:
            f.mp_ids[1][rf] = mid
        tr._adjust_second_map(f)
    stage("post_scale", extra=(fr.T_cw.copy(), fp.T_cw.copy()))

    # the mapper's harvest, camera 0 of a mapped keyframe against the
    # camera-1 index
    mapper_p = local_mapping.LocalMapper(s["cfg"], s["rig"], pt.map,
                                         kfdb=pt.kfdb, voc=s["voc"])
    mapper_p.pnp_sampler = RefKeyStream(mapper_r.key)
    marks[:] = [len(mapper_r.events), 0]
    for q in pick:
        mapper_r.last_cross_kid = mapper_p.last_cross_kid = -10**9
        mapper_r._search_cross_cameras(rsys.map.keyframes[q])
        mapper_p._search_cross_cameras(pt.map.keyframes[q])
    stage("search_cross", mapper_r.events, mapper_p.events,
          extra=(mapper_r.n_cross_harvested, mapper_p.n_cross_harvested))

    marks[:] = [len(rt.events), len(pt.events)]
    for tr, f in ((rt, fr), (pt, fp)):
        tr._update_full_state(f)
    stage("full", extra=(rt.state, pt.state))

    # in FULL the same call looks for a refresh: let one be due
    for tr, f in ((rt, fr), (pt, fp)):
        tr._xedges_at_gba = tr._count_cross_edges() // 2
        tr._update_full_state(f)
    stage("refresh")
    rt.local_mapper = mapper_r
    out["trackers"] = (rt, pt)
    return out


_NUM = re.compile(r"(?<==)-?[0-9]+\.[0-9]+")


def _assert_events_equal(ev_r, ev_p):
    """Names, ids and counts letter for letter; printed decimals within
    2e-4 relative plus one unit of the last printed digit."""
    assert [_NUM.sub("#", e) for e in ev_p] == [_NUM.sub("#", e) for e in ev_r]
    for e_r, e_p in zip(ev_r, ev_p):
        for a, b in zip(_NUM.findall(e_r), _NUM.findall(e_p)):
            digit = 10.0 ** -len(a.split(".")[1])
            assert abs(float(a) - float(b)) <= 2e-4 * abs(float(a)) + digit, \
                (e_r, e_p)


def _assert_maps_close(a, b, atol=1e-3):
    """Same keyframes and points; poses within `atol`; >= 98% of the
    positions within `atol` and every one within 10 `atol` (a few points
    6 m away with little parallax, 9 of 784, stand up to 5.4e-3 apart after the 10-iteration
    float32 global BA and come together in the later, longer ones);
    >= 99% of the keyframe rows and of the points' observations equal."""
    ka, kb = a["keyframes"], b["keyframes"]
    assert sorted(ka) == sorted(kb)
    rows = []
    for kid in ka:
        np.testing.assert_allclose(kb[kid]["T_cw"], ka[kid]["T_cw"], rtol=0,
                                   atol=atol, err_msg=f"kf {kid}")
        rows.append(ka[kid]["mp_idx"] == kb[kid]["mp_idx"])
        assert ka[kid]["scaled"] == kb[kid]["scaled"]
    assert np.concatenate(rows).mean() >= 0.99
    pa, pb = a["points"], b["points"]
    common = sorted(set(pa) & set(pb))
    assert len(common) >= 0.99 * max(len(pa), len(pb)) and len(common) > 300
    err = np.abs(np.stack([pb[m]["pos"] for m in common]) -
                 np.stack([pa[m]["pos"] for m in common])).max(axis=1)
    assert (err <= atol).mean() >= 0.98 and err.max() <= 10 * atol, \
        ((err > atol).sum(), err.max())
    same = [pa[m]["obs"] == pb[m]["obs"] and
            pa[m]["obs_cam"] == pb[m]["obs_cam"] for m in common]
    assert np.mean(same) >= 0.99
    assert (a["map_scaled"], a["geometry_epoch"]) == \
        (b["map_scaled"], b["geometry_epoch"])


def _n_cross_obs(snap):
    return sum(c != 0 for p in snap["points"].values()
               for c in p["obs_cam"].values())


def test_second_map_equals_reference(tail):
    """_anchor_cross_reloc x3, then _create_second_map: bootstrap_scale,
    _apply_scale, the anchors' attach, _refine_scale, _adjust_second_map
    with the Sim3 correction, the metric global BA."""
    snap_r, snap_p, ev_r, ev_p, (T_r, T_p, Tl_r, Tl_p) = tail["second_map"]
    names = [e.split("@")[0] for e in ev_r]
    for name in ("XRELOC", "XANCHOR", "XLS", "SCALED", "XATTACH", "ALPHA",
                 "XGAP", "XWARP", "XKF"):
        assert name in names, ev_r
    _assert_events_equal(ev_r, ev_p)
    assert snap_r["map_scaled"] and _n_cross_obs(snap_r) > 300
    _assert_maps_close(snap_r, snap_p)
    # the frame in hand and the last frame were rescaled with the map
    np.testing.assert_allclose(T_p, T_r, rtol=0, atol=1e-3)
    np.testing.assert_allclose(Tl_p, Tl_r, rtol=0, atol=1e-3)


def test_cross_reloc_after_scaling_equals_reference(tail):
    """_adjust_second_map on a drifted frame: the tracked points go into a
    new keyframe, the window is warped onto the relocalized pose, the rest
    of the matches attach as camera-1 observations, the scale is refined."""
    snap_r, snap_p, ev_r, ev_p, (T_r, T_p) = tail["post_scale"]
    names = [e.split("@")[0] for e in ev_r]
    assert names[:2] == ["XTRY", "XRELOC"] and "XWARP" in names, ev_r
    xkf = next(e for e in ev_r if e.startswith("XKF@910"))
    assert int(xkf.split("att=")[1]) > 20, ev_r
    _assert_events_equal(ev_r, ev_p)
    _assert_maps_close(snap_r, snap_p)
    np.testing.assert_allclose(T_p, T_r, rtol=0, atol=1e-3)
    assert _n_cross_obs(snap_p) > _n_cross_obs(tail["second_map"][1])


def test_search_cross_cameras_equals_reference(tail):
    """LocalMapper._search_cross_cameras on three mapped keyframes of the
    metric map: candidates, PnP, widening and harvest."""
    snap_r, snap_p, ev_r, ev_p, (n_r, n_p) = tail["search_cross"]
    assert sum(e.startswith("XCROSS@") for e in ev_r) >= 2, ev_r
    _assert_events_equal(ev_r, ev_p)
    assert n_p == n_r > 0
    _assert_maps_close(snap_r, snap_p)


def test_full_state_and_metric_gba_equal_reference(tail):
    snap_r, snap_p, ev_r, ev_p, (state_r, state_p) = tail["full"]
    assert state_r == state_p == "FULL"
    assert len(ev_r) == 1 and ev_r[0].startswith("FULL@910")
    _assert_events_equal(ev_r, ev_p)
    _assert_maps_close(snap_r, snap_p)
    # the 25-iteration global BA moved the map, on both sides alike
    before = tail["search_cross"][0]
    moved = max(np.abs(snap_r["keyframes"][k]["T_cw"] -
                       before["keyframes"][k]["T_cw"]).max()
                for k in snap_r["keyframes"])
    assert moved > 1e-4


def test_metric_refresh_equals_reference(tail):
    snap_r, snap_p, ev_r, ev_p, _ = tail["refresh"]
    assert len(ev_r) == 1 and ev_r[0].startswith("MGBA@910 xedges=")
    _assert_events_equal(ev_r, ev_p)
    _assert_maps_close(snap_r, snap_p)


def test_loop_correction_on_the_metric_map_equals_reference(tail, world_and_map):
    """After FULL: `_match_loop_points` and `_correct_loop` (fuse through
    every camera, the map being scaled, the per-camera point correction,
    the essential graph, the global BA) for the newest keyframe of the walk
    out against the second, whose region its camera 0 faces, at its pose
    perturbed by a Sim3 (scale 1.02, 3 cm, 0.5 degrees), on both sides.
    The port starts from the reference's map carried across: the two
    tails' maps agree only to the tolerance above, and the global BA
    would carry that past it."""
    from orbslam2_dualcam_tpu.ops import lie as ref_lie
    from orbslam2_dualcam_tpu.pipeline import loop_closing as ref_lc
    from orbslam2_dualcam_tpu_torch.pipeline import loop_closing

    import jax.numpy as jnp
    s = world_and_map
    rt, pt = tail["trackers"]
    assert rt.map.map_scaled and pt.state == rt.state == "FULL"
    pmap = map_from_reference(rt.map)
    rl = ref_lc.LoopCloser(rt.cfg, rt.rig, rt.map, rt.kfdb, rt.voc)
    pl = loop_closing.LoopCloser(s["cfg"], s["rig"], pmap, pt.kfdb, s["voc"])
    kids = sorted(rt.map.keyframes)
    kid = max(k for k in kids if rt.map.keyframes[k].frame_id < N_FRAMES)
    lkid = kids[1]
    P = np.eye(4)
    P[:3, :3] = 1.02 * np.asarray(ref_lie.so3_exp(jnp.asarray(
        [0.0, np.deg2rad(0.5), 0.0], jnp.float32)), np.float64)
    P[:3, 3] = [0.03, 0.0, 0.0]
    Scw = P @ rt.map.keyframes[kid].T_cw
    N = len(rt.map.keyframes[kid].kp_valid) // 2
    found = []
    for lc, m in ((rl, rt.map), (pl, pmap)):
        mids = lc._loop_region_mids(m.keyframes[lkid])
        pairs, adds, n = lc._match_loop_points(m.keyframes[kid], Scw, mids, N)
        found.append((mids, pairs, adds, n))
        lc._correct_loop(m.keyframes[kid], m.keyframes[lkid], Scw,
                         (pairs, adds, mids))
    (mids_r, pairs_r, adds_r, n_r), (mids_p, pairs_p, adds_p, n_p) = found
    assert mids_p == mids_r and n_r > 20 and abs(n_p - n_r) <= 0.02 * n_r
    for a, b in ((pairs_r, pairs_p), (adds_r, adds_p)):
        assert len(set(a) & set(b)) >= 0.98 * max(len(a), len(b))
    assert pl.n_loop_fused == rl.n_loop_fused > 0
    assert pl.debug_log == rl.debug_log
    snap_r, snap_p = map_snapshot(rt.map), map_snapshot(pmap)
    _assert_maps_close(snap_r, snap_p)
    for k in snap_r["keyframes"]:
        assert snap_p["keyframes"][k]["loop_edges"] == \
            snap_r["keyframes"][k]["loop_edges"]
    assert snap_p["keyframes"][kid]["loop_edges"] == [lkid]
    assert snap_p["first_scale_kid"] == snap_r["first_scale_kid"] >= 0
    # the fuse ran through camera 1 as well: observations by camera 1 grew
    assert _n_cross_obs(snap_p) >= _n_cross_obs(tail["refresh"][1])
