"""The port's loop closer against the reference's, on one scripted loop
(`torch_parity.scripted_loop_map`: 8 keyframes walking out, 5 coming back
over the start through new map points in a frame drifted by a Sim3 of
scale 1.05, 5 cm and 1 degree), built by the reference and carried across
by `map_from_reference` / `kfdb_from_reference`.  The port's Sim3 RANSAC
is fed the minimal sets the reference draws from its key stream.

Compared: the `_detect` sequence over the revisit keyframes (debug log,
candidates and consistency groups equal); `_compute_sim3` (same answer,
same loop keyframe, Scw within 1e-4, matched / added / region ids >= 98%
equal); `_correct_loop` with its global BA (keyframes within 1e-3 m, >= 98%
of the points within 1e-3 m and all within 1e-2 m, loop edges and the
fused count equal).  Then the system: it builds with loop closing, resets
the closer's state, and with `async_mapping=True` runs the closer on the
mapper thread under the map lock.  Two tests are `slow`: the 72-frame
orbit of tests/test_loop_closing.py through the port alone, and the
closing call of the reference's own run of chip_smoke.py's loop scenario
(at 320x240) repeated by the port from the reference's state."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu.ops import camera as ref_camera
from orbslam2_dualcam_tpu.ops import ransac as ref_ransac
from orbslam2_dualcam_tpu.pipeline import loop_closing as ref_lc
from orbslam2_dualcam_tpu.utils import config as ref_config
from orbslam2_dualcam_tpu_torch.models import kfdb as port_kfdb
from orbslam2_dualcam_tpu_torch.ops import camera
from orbslam2_dualcam_tpu_torch.pipeline import loop_closing
from orbslam2_dualcam_tpu_torch.pipeline.system import System
from orbslam2_dualcam_tpu_torch.utils.convert import (config_from_reference,
                                                      kfdb_from_reference,
                                                      map_from_reference,
                                                      vocab_from_numpy)

from torch_parity import map_snapshot, scripted_cfg, scripted_loop_map

torch.set_num_threads(1)


class RefSim3Stream:
    """The port's `sim3_sampler`, drawing what the reference's closer
    draws: one split of its key per candidate that reaches RANSAC."""

    def __init__(self, key):
        self.key = key
        self.calls = 0

    def __call__(self, n_hyp, valid):
        self.key, k = jax.random.split(self.key)
        self.calls += 1
        w = jnp.asarray(valid.cpu().numpy(), jnp.float32)
        return torch.as_tensor(np.array(
            ref_ransac._sample_indices(k, n_hyp, 3, len(w), w)))


def _port_state(rmap, rdb, rvoc, rcfg):
    cfg = config_from_reference(rcfg)
    voc = vocab_from_numpy(
        rvoc._replace(centroids=tuple(np.asarray(c) for c in rvoc.centroids),
                      idf=np.asarray(rvoc.idf)), device="cpu")
    return (cfg, camera.make_rig(cfg, device="cpu"), map_from_reference(rmap),
            kfdb_from_reference(rdb), voc)


@pytest.fixture(scope="module")
def loop():
    """Both closers over the revisit keyframes: detection on each, then the
    Sim3 and the correction on the last."""
    rmap, rdb, rvoc, back = scripted_loop_map()
    rcfg = scripted_cfg(ref_config)
    cfg, rig, pmap, pdb, voc = _port_state(rmap, rdb, rvoc, rcfg)
    rl = ref_lc.LoopCloser(rcfg, ref_camera.make_rig(rcfg), rmap, rdb, rvoc)
    pl = loop_closing.LoopCloser(cfg, rig, pmap, pdb, voc)
    pl.sim3_sampler = stream = RefSim3Stream(rl.key)
    out = dict(back=back, rl=rl, pl=pl, stream=stream, detect=[])
    for kid in back:
        out["detect"].append((rl._detect(rmap.keyframes[kid]),
                              pl._detect(pmap.keyframes[kid]),
                              [(sorted(g), c, mi) for g, c, mi in rl.consistent_groups],
                              [(sorted(g), c, mi) for g, c, mi in pl.consistent_groups]))
    cands = out["detect"][-1][0]
    kf_r, kf_p = rmap.keyframes[back[-1]], pmap.keyframes[back[-1]]
    out["sim3"] = (rl._compute_sim3(kf_r, cands), pl._compute_sim3(kf_p, cands))
    out["log_sim3"] = (list(rl.debug_log), list(pl.debug_log))
    (ok_r, S_r, l_r, m_r), (ok_p, S_p, l_p, m_p) = out["sim3"]
    if ok_r and ok_p:
        out["before"] = map_snapshot(pmap)
        rl._correct_loop(kf_r, l_r, S_r, m_r)
        pl._correct_loop(kf_p, l_p, S_p, m_p)
    out["snap"] = (map_snapshot(rmap), map_snapshot(pmap))
    return out


def test_detect_sequence_equals_reference(loop):
    for want, got, groups_r, groups_p in loop["detect"]:
        assert got == want
        assert groups_p == groups_r
    assert loop["detect"][-1][0], loop["rl"].debug_log
    log_r, log_p = loop["log_sim3"]
    n_detect = sum(1 for e in log_r if not e.startswith("sim3"))
    assert log_p[:n_detect] == log_r[:n_detect]
    assert any("consistent=" in e for e in log_r)


def _share_equal(a, b):
    a, b = set(a), set(b)
    return len(a & b) / max(len(a | b), 1)


def test_compute_sim3_equals_reference(loop):
    (ok_r, S_r, l_r, m_r), (ok_p, S_p, l_p, m_p) = loop["sim3"]
    assert ok_r and ok_p, loop["log_sim3"]
    assert l_p.kid == l_r.kid
    np.testing.assert_allclose(S_p, S_r, rtol=0, atol=1e-4)
    for a, b in zip(m_r, m_p):          # matched pairs, adds, region ids
        assert len(a) > 20 and _share_equal(a, b) >= 0.98, (len(a), len(b))
    # the log lines name the same candidates and counts
    log_r, log_p = loop["log_sim3"]
    assert [e for e in log_p if e.startswith("sim3")] == \
        [e for e in log_r if e.startswith("sim3")]
    # the port drew exactly the sets the reference drew
    assert loop["stream"].calls >= 1
    np.testing.assert_array_equal(np.asarray(loop["stream"].key),
                                  np.asarray(loop["rl"].key))
    # the revisit keyframe sits 5% off the loop keyframe's scale
    s = np.cbrt(np.linalg.det(S_p[:3, :3]))
    assert 1.0 < s < 1.12


def test_correct_loop_and_global_ba_equal_reference(loop):
    snap_r, snap_p = loop["snap"]
    rl, pl, back = loop["rl"], loop["pl"], loop["back"]
    assert (pl.n_loops_closed, pl.last_loop_kid) == (rl.n_loops_closed,
                                                     rl.last_loop_kid) == (1, back[-1])
    assert pl.n_loop_fused == rl.n_loop_fused > 0
    assert pl.debug_log[-1] == rl.debug_log[-1]
    ka, kb = snap_r["keyframes"], snap_p["keyframes"]
    assert sorted(ka) == sorted(kb)
    for kid in ka:
        np.testing.assert_allclose(kb[kid]["T_cw"], ka[kid]["T_cw"], rtol=0,
                                   atol=1e-3, err_msg=f"kf {kid}")
        assert kb[kid]["loop_edges"] == ka[kid]["loop_edges"]
    assert kb[back[-1]]["loop_edges"] and any(
        kb[kid]["loop_edges"] == [back[-1]] for kid in kb)
    pa, pb = snap_r["points"], snap_p["points"]
    common = sorted(set(pa) & set(pb))
    assert len(common) >= 0.98 * max(len(pa), len(pb)) and len(common) > 300
    err = np.abs(np.stack([pb[m]["pos"] for m in common]) -
                 np.stack([pa[m]["pos"] for m in common])).max(axis=1)
    assert (err <= 1e-3).mean() >= 0.98 and err.max() <= 1e-2, \
        ((err > 1e-3).sum(), err.max())
    for key in ("geometry_epoch", "first_scale_kid", "origin_kid"):
        assert snap_p[key] == snap_r[key]
    # the revisit keyframes came back onto the truth (0.1 .. 0.7 m along x)
    before = loop["before"]["keyframes"]
    for j, kid in enumerate(back):
        c = -kb[kid]["T_cw"][:3, :3].T @ kb[kid]["T_cw"][:3, 3]
        c0 = -before[kid]["T_cw"][:3, :3].T @ before[kid]["T_cw"][:3, 3]
        assert abs(c[0] - (0.1 + 0.15 * j)) < 0.03 < abs(c0[0] - (0.1 + 0.15 * j))


def _port_system(async_mapping=False):
    rmap, rdb, rvoc, back = scripted_loop_map()
    cfg, rig, pmap, pdb, voc = _port_state(rmap, rdb, rvoc,
                                           scripted_cfg(ref_config))
    # the scripted database's postings are carried into the system's
    # database, so that one is made with the Python postings
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_kfdb, "NativeInvertedFile", None)
        sys_ = System(cfg, voc, enable_loop_closing=True,
                      async_mapping=async_mapping, device="cpu")
    # the scripted map and its database stand in for a tracked run
    for name in ("keyframes", "points", "next_kid", "next_mid", "origin_kid",
                 "first_scale_kid", "geometry_epoch"):
        setattr(sys_.map, name, getattr(pmap, name))
    sys_.kfdb.inverted, sys_.kfdb.bow = pdb.inverted, pdb.bow
    return sys_, back


def test_system_with_loop_closing_builds_and_resets():
    sys_, back = _port_system()
    lc = sys_.loop_closer
    assert isinstance(lc, loop_closing.LoopCloser)
    assert sys_.mapper.loop_closer is lc and lc.map is sys_.map
    assert lc.kfdb is sys_.kfdb and lc.device.type == "cpu"
    for kid in back:
        lc._detect(sys_.map.keyframes[kid])
    assert lc.consistent_groups
    lc.last_loop_kid = back[-1]
    sys_.reset()
    assert lc.consistent_groups == [] and lc.last_loop_kid == -1
    assert sys_.map.n_keyframes == 0 and not sys_.kfdb.bow[0]


def test_async_mapping_runs_the_closer_on_the_mapper_thread():
    sys_, back = _port_system(async_mapping=True)
    lc = sys_.loop_closer
    seen = []
    orig = lc.on_new_keyframe

    def spy(kf):
        seen.append((kf.kid, threading.current_thread() is sys_._mapper_thread,
                     sys_.map_lock.locked()))
        orig(kf)

    lc.on_new_keyframe = spy
    for kid in back[:3]:
        sys_._kf_queue.put((sys_.map.keyframes[kid], False))
    t0 = time.monotonic()
    while len(seen) < 3 and time.monotonic() - t0 < 120:
        time.sleep(0.05)
    sys_.shutdown()
    assert seen == [(kid, True, True) for kid in back[:3]]
    assert not sys_._mapper_thread.is_alive()
    assert any(e.startswith(f"kid={back[1]}") for e in lc.debug_log)


@pytest.mark.slow
def test_loop_closes_on_the_orbit():
    """tests/test_loop_closing.py's scenario through the port alone: a
    72-frame full circle (radius 1.5 m) in the box room, 320x240, 400
    features, a vocabulary (8^4) trained on the port's own descriptors of
    16 orbit views; the loop closes, tracking ends OK and the Sim3-aligned
    ATE is under 0.8 m."""
    from orbslam2_dualcam_tpu_torch.ops import orb
    from orbslam2_dualcam_tpu_torch.utils import metrics, synthetic
    from orbslam2_dualcam_tpu_torch.utils.config import (CameraConfig,
                                                         CapacityConfig,
                                                         MappingConfig,
                                                         OrbConfig,
                                                         SystemConfig,
                                                         VocabConfig)
    from orbslam2_dualcam_tpu_torch.vocab import bow
    cfg = SystemConfig(
        cameras=(CameraConfig(width=320, height=240, fx=260, fy=260, cx=160,
                              cy=120),),
        orb=OrbConfig(n_features=400, n_levels=4),
        mapping=MappingConfig(cull_found_ratio=0.1),
        vocab=VocabConfig(branching=8, depth=4),
        capacity=CapacityConfig(max_local_mp=2048))
    world = synthetic.make_box_world(np.random.default_rng(7), half=6.0)
    K = np.array([[260.0, 0, 160], [0, 260, 120], [0, 0, 1]])
    descs = []
    for T in synthetic.orbit_trajectory(16, radius=1.5):
        img = synthetic.render(world, K, T, H=240, W=320)
        f = orb.extract_orb(torch.as_tensor(img), cfg.orb, 400)
        descs.append(f.desc.numpy().view(np.uint32)[f.valid.numpy()])
    voc = bow.train_vocabulary(np.concatenate(descs), branching=8, depth=4,
                               seed=5, weight_docs=descs, device="cpu")
    sys_ = System(cfg, voc=voc, enable_loop_closing=True, device="cpu")
    poses = synthetic.orbit_trajectory(72, radius=1.5, total_angle=2.0 * np.pi)
    Ks, T_sc = sys_.rig.K.numpy(), sys_.rig.T_sc.numpy()
    states = [sys_.track(synthetic.render_rig(world, Ks, T_sc, T, H=240, W=320),
                         k / 30.0) for k, T in enumerate(poses)]
    ev = sys_.tracker.events
    assert sys_.loop_closer.n_loops_closed >= 1, (ev, sys_.loop_closer.debug_log)
    assert states[-1] in ("OK", "FULL"), ev
    traj = sys_.tracker.composed_trajectory()
    est = metrics.trajectory_positions(traj)
    gt = np.asarray([-poses[f][:3, :3].T @ poses[f][:3, 3] for f, _, _ in traj])
    assert metrics.ate_rmse(est, gt, with_scale=True) < 0.8, ev


@pytest.mark.slow
def test_closing_on_the_reference_orbit_equals_reference(monkeypatch):
    """chip_smoke.py's loop scenario at 320x240 / 400 features (110 frames
    over 2.2 pi, radius 1.5 m, box room seed 7, vocabulary 8^4 seed 5)
    through the reference's System; at its closing call the reference's map
    and database are carried to the port, and both closers compute the Sim3
    (the port fed the reference's sets) and correct the loop: same answer,
    Scw within 1e-4, keyframes within 1e-3 m, and the same keyframe ATE
    before and after (within 1e-3 m)."""
    from orbslam2_dualcam_tpu.models import kfdb as ref_kfdb
    from orbslam2_dualcam_tpu.ops import orb as ref_orb
    from orbslam2_dualcam_tpu.pipeline.system import System as RefSystem
    from orbslam2_dualcam_tpu.utils import metrics as ref_metrics
    from orbslam2_dualcam_tpu.utils import synthetic as ref_synthetic
    from orbslam2_dualcam_tpu.vocab import bow as ref_bow
    monkeypatch.setattr(ref_kfdb, "NativeInvertedFile", None)
    monkeypatch.setattr(port_kfdb, "NativeInvertedFile", None)
    rcfg = ref_config.SystemConfig(
        cameras=(ref_config.CameraConfig(width=320, height=240, fx=260, fy=260,
                                         cx=160, cy=120),),
        orb=ref_config.OrbConfig(n_features=400, n_levels=4),
        mapping=ref_config.MappingConfig(cull_found_ratio=0.1),
        vocab=ref_config.VocabConfig(branching=8, depth=4),
        capacity=ref_config.CapacityConfig(max_local_mp=2048))
    world = ref_synthetic.make_box_world(np.random.default_rng(7), half=6.0)
    K = np.array([[260.0, 0, 160], [0, 260, 120], [0, 0, 1]])
    descs = []
    for T in ref_synthetic.orbit_trajectory(16, radius=1.5):
        f = ref_orb.extract_orb(jnp.asarray(ref_synthetic.render(world, K, T, H=240,
                                                                 W=320)), rcfg.orb, 400)
        descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
    rvoc = ref_bow.train_vocabulary(np.concatenate(descs), branching=8, depth=4,
                                    seed=5, weight_docs=descs)
    rsys = RefSystem(rcfg, voc=rvoc, enable_loop_closing=True)
    poses = ref_synthetic.orbit_trajectory(110, radius=1.5, total_angle=2.2 * np.pi)

    def kf_ate(m):
        kfs = [m.keyframes[k] for k in sorted(m.keyframes)]
        est = np.asarray([kf.center() for kf in kfs])
        gt = np.asarray([-poses[kf.frame_id][:3, :3].T @ poses[kf.frame_id][:3, 3]
                         for kf in kfs])
        return ref_metrics.ate_rmse(est, gt, with_scale=True)

    rl = rsys.loop_closer
    compute = rl._compute_sim3
    found = []

    def both(kf, cands):
        cfg, rig, pmap, pdb, voc = _port_state(rsys.map, rsys.kfdb, rvoc, rcfg)
        pl = loop_closing.LoopCloser(cfg, rig, pmap, pdb, voc)
        pl.sim3_sampler = RefSim3Stream(rl.key)
        res_p = pl._compute_sim3(pmap.keyframes[kf.kid], cands)
        res_r = compute(kf, cands)
        assert res_p[0] == res_r[0], (rl.debug_log[-3:], pl.debug_log)
        if res_r[0] and not found:
            found.append((kf_ate(rsys.map), kf_ate(pmap)))
            pl._correct_loop(pmap.keyframes[kf.kid], pmap.keyframes[res_p[2].kid],
                             res_p[1], res_p[3])
            found.append((res_r, res_p, pmap, pl))
        return res_r

    rl._compute_sim3 = both
    Ks, T_sc = np.asarray(rsys.rig.K), np.asarray(rsys.rig.T_sc)
    for k, T in enumerate(poses):
        rsys.track(ref_synthetic.render_rig(world, Ks, T_sc, T, H=240, W=320), k / 30.0)
        if len(found) == 2:
            break
    assert found, rl.debug_log[-10:]
    (ate_r0, ate_p0), (res_r, res_p, pmap, pl) = found
    assert res_p[2].kid == res_r[2].kid and ate_p0 == pytest.approx(ate_r0, abs=1e-9)
    np.testing.assert_allclose(res_p[1], res_r[1], rtol=0, atol=1e-4)
    assert pl.debug_log[-1] == rl.debug_log[-1]
    for kid, kf in rsys.map.keyframes.items():
        np.testing.assert_allclose(pmap.keyframes[kid].T_cw, kf.T_cw, rtol=0, atol=1e-3)
    assert kf_ate(pmap) == pytest.approx(kf_ate(rsys.map), abs=1e-3)
    assert kf_ate(rsys.map) < ate_r0
