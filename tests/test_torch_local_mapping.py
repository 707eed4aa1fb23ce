"""pipeline/ba_pack.py, the triangulation and fusion programs of
pipeline/frontend.py, DeviceMapStore and LocalMapper of the port against
the JAX reference, both started from one scripted map
(`torch_parity.scripted_map`, converted with `map_from_reference`).
CPU, float32; tolerances per assert."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu.models import map as ref_map
from orbslam2_dualcam_tpu.ops import camera as ref_camera
from orbslam2_dualcam_tpu.pipeline import ba_pack as ref_ba_pack
from orbslam2_dualcam_tpu.pipeline import frontend as ref_frontend
from orbslam2_dualcam_tpu.pipeline import local_mapping as ref_lm
from orbslam2_dualcam_tpu.pipeline import tracking as ref_tracking
from orbslam2_dualcam_tpu.utils import config as ref_config
from orbslam2_dualcam_tpu_torch.ops import camera
from orbslam2_dualcam_tpu_torch.pipeline import (ba_pack, frontend,
                                                 local_mapping, tracking)
from orbslam2_dualcam_tpu_torch.utils.convert import (config_from_reference,
                                                      desc_to_numpy,
                                                      map_from_reference)
from orbslam2_dualcam_tpu_torch.utils.device import upload

from torch_parity import (assert_snapshots_equal, map_snapshot, random_desc,
                          rendered_frame,
                          scripted_cfg, scripted_map, t)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    rcfg = scripted_cfg(ref_config)
    cfg = config_from_reference(rcfg)
    return rcfg, cfg, ref_camera.make_rig(rcfg), camera.make_rig(cfg, device="cpu")


def _maps(seed=0):
    rm, newest, sf = scripted_map(ref_map, seed)
    pm = map_from_reference(rm)
    return rm, pm, newest, pm.keyframes[newest.kid], sf


def test_pack_problem_and_unpack_result_exact():
    rm, pm, rkf, pkf, sf = _maps()
    window = [rkf.kid] + rm.covisible_kfs(rkf, 20)
    kw = dict(fixed_kids={0}, level_sigma2=sf ** 2, ncam=1, max_points=300)
    want, w_kids, w_mids, w_meta = ref_ba_pack.pack_problem(rm, window[:3], **kw)
    got, g_kids, g_mids, g_meta = ba_pack.pack_problem(pm, window[:3],
                                                       device="cpu", **kw)
    assert (g_kids, g_mids, g_meta) == (w_kids, w_mids, w_meta)
    assert len(g_kids) > 3            # spectators joined as fixed poses
    for g, w in zip(list(got[:2]) + list(got.edges) + list(got[3:]),
                    list(want[:2]) + list(want.edges) + list(want[3:])):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.edges.kf.dtype == torch.int64
    assert int(got.pose_fixed.sum()) == len(g_kids) - 3   # {0} | spectators
    # unpack: perturbed result written back to both maps, outliers erased
    rng = np.random.default_rng(0)
    poses = np.asarray(want.poses) + rng.normal(0, 1e-3, want.poses.shape).astype(np.float32)
    points = np.asarray(want.points) + rng.normal(0, 1e-2, want.points.shape).astype(np.float32)
    chi2 = rng.uniform(0, 8, want.edges.kf.shape).astype(np.float32)
    w_res = ref_ba_pack.ba.BAResult(jnp.asarray(poses), jnp.asarray(points),
                                    jnp.asarray(chi2), jnp.float32(1.0))
    g_res = ba_pack.ba.BAResult(t(poses), t(points), t(chi2), t(np.float32(1.0)))
    n_w = ref_ba_pack.unpack_result(rm, w_res, w_kids, w_mids, w_meta)
    n_g = ba_pack.unpack_result(pm, g_res, g_kids, g_mids, g_meta)
    assert n_g == n_w > 10
    assert_snapshots_equal(map_snapshot(pm), map_snapshot(rm))


def test_bucket_and_pack_points_equal_reference():
    for n in (0, 1, 255, 256, 257, 1024, 1025, 5000):
        for lo in (8, 256, 1024):
            assert ba_pack._bucket(n, lo) == ref_ba_pack._bucket(n, lo)
    rm, pm, *_ = _maps(1)
    for cap, mids in ((2048, sorted(rm.points)[:300]), (256, sorted(rm.points)),
                      (2048, [5, 10 ** 6, 7] + sorted(rm.points)[10:20])):
        want = ref_lm.pack_points(rm, cap, list(mids))
        got = local_mapping.pack_points(pm, cap, list(mids))
        assert got[0] == want[0]
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g, w)


def _pair_args(kf1, kf2, rig_like, dev):
    N = len(kf1.kp_valid)
    free1 = kf1.kp_valid & (kf1.mp_idx < 0)
    free2 = kf2.kp_valid & (kf2.mp_idx < 0)
    return [dev(kf1.T_cw.astype(np.float32)), dev(kf2.T_cw.astype(np.float32)),
            None, dev(kf1.uv.astype(np.float32)), dev(kf1.desc),
            dev(kf1.level), dev(free1), dev(kf2.uv.astype(np.float32)),
            dev(kf2.desc), dev(kf2.level), dev(free2)]


def test_triangulate_pair_and_batch(setup):
    """Match indices exact, points within 1e-4 relative to the depth, the
    good flags equal; the batch equals the pair calls exactly."""
    rcfg, cfg, rrig, rig = setup
    rm, pm, rkf, pkf, sf = _maps()
    ls = jnp.asarray(sf)
    outs = []
    for nkid in (3, 4):
        a = _pair_args(rkf, rm.keyframes[nkid], rrig, jnp.asarray)
        a[2] = jnp.int32(0)
        want = ref_frontend.triangulate_pair(*a, rrig, ls, jnp.float32(50.0))
        b = _pair_args(pkf, pm.keyframes[nkid], rig,
                       lambda x: upload(np.asarray(x), "cpu"))
        b[5], b[9] = b[5].long(), b[9].long()
        b[2] = 0
        got = frontend.triangulate_pair(*b, rig, t(sf), 50.0)
        w_idx, w_X, w_good = (np.asarray(x) for x in want)
        np.testing.assert_array_equal(got[0].numpy(), w_idx)
        np.testing.assert_array_equal(got[2].numpy(), w_good)
        assert w_good.sum() > 40
        err = np.abs(got[1].numpy() - w_X)[w_good]
        assert err.max() <= 1e-4 * np.abs(w_X[w_good]).max()
        outs.append((b, got))
    stacked = [torch.stack([o[0][i] for o in outs]) if i != 2 else [0, 0]
               for i in range(11)]
    bi, bX, bg = frontend.triangulate_pairs_batch(*stacked, rig, t(sf), 50.0)
    for j, (_, got) in enumerate(outs):
        assert torch.equal(bi[j], got[0]) and torch.equal(bX[j], got[1])
        assert torch.equal(bg[j], got[2])


def test_project_and_match_batch_equals_per_target(setup):
    rcfg, cfg, rrig, rig = setup
    rm, pm, rkf, pkf, sf = _maps()
    mids = [int(x) for x in pkf.mp_idx[pkf.mp_idx >= 0]]
    mids, pos, desc, valid, dmax, dmin, normal = local_mapping.pack_points(
        pm, 2048, mids)
    targets = [pm.keyframes[k] for k in (2, 3, 4)]
    dev = lambda x: upload(np.asarray(x), "cpu")
    N = 400
    per = [dev(np.stack([f(k) for k in targets])) for f in (
        lambda k: k.T_cw.astype(np.float32),
        lambda k: k.uv.reshape(1, N, 2).astype(np.float32),
        lambda k: k.desc.reshape(1, N, 8),
        lambda k: k.level.reshape(1, N).astype(np.int64),
        lambda k: k.kp_valid.reshape(1, N))]
    shared = [dev(x) for x in (pos, desc, valid, dmax, dmin, normal)]
    tail = (rig, 3.0, t(sf), 50.0, 0.5, dev(np.ones(1, bool)))
    got, vis = frontend.project_and_match_batch(*per, *shared, *tail)
    assert got.shape == (3, 1, N) and vis.shape == (3, len(pos))
    for i in range(3):
        one, v = frontend.project_and_match(*(p[i] for p in per), *shared, *tail)
        assert torch.equal(got[i], one) and torch.equal(vis[i], v)
        # and the reference's single-target call gives the same matches
        want, _ = ref_frontend.project_and_match(
            *(jnp.asarray(p[i].numpy()) for p in per[:2]),
            jnp.asarray(desc_to_numpy(per[2][i])),
            jnp.asarray(per[3][i].numpy().astype(np.int32)),
            jnp.asarray(per[4][i].numpy()),
            jnp.asarray(pos), jnp.asarray(desc), jnp.asarray(valid),
            jnp.asarray(dmax), jnp.asarray(dmin), jnp.asarray(normal),
            rrig, jnp.float32(3.0), jnp.asarray(sf), jnp.float32(50.0),
            jnp.float32(0.5), jnp.ones(1, bool))
        np.testing.assert_array_equal(one.numpy(), np.asarray(want))
        assert int((one >= 0).sum()) > 30


def test_device_map_store_equals_reference():
    """refresh (plain and sticky), slots_of_mids and slots_to_mids: exact."""
    rm, pm, *_ = _maps(1)
    want, got = ref_tracking.DeviceMapStore(512), tracking.DeviceMapStore(512, "cpu")
    live = np.asarray(sorted(rm.points), np.int64)
    rng = np.random.default_rng(0)

    def check():
        np.testing.assert_array_equal(got.slot_mids, want.slot_mids)
        assert got.n_valid == want.n_valid
        for i, (g, w) in enumerate(zip(got.arrays, want.arrays)):
            g = desc_to_numpy(g) if i == 1 else g.numpy()
            np.testing.assert_array_equal(g, np.asarray(w))
        q = np.concatenate([live[::7], [-1, 10 ** 7]]).reshape(2, -1)
        np.testing.assert_array_equal(got.slots_of_mids(q), want.slots_of_mids(q))
        s = rng.integers(-1, 512, (2, 50))
        np.testing.assert_array_equal(got.slots_to_mids(s), want.slots_to_mids(s))

    first = np.concatenate([live[:200], [10 ** 6]])        # one unknown mid
    for st, m in ((want, rm), (got, pm)):
        st.refresh(m, first)
    check()
    assert got.n_valid == 200
    # sticky: half of the old set survives in place, new mids fill the holes
    second = np.concatenate([live[100:200], live[250:]])
    for st, m in ((want, rm), (got, pm)):
        st.refresh(m, second, sticky=True)
    check()
    np.testing.assert_array_equal(got.slot_mids[100:200], live[100:200])
    # over capacity and plain again
    for st, m in ((want, rm), (got, pm)):
        st.refresh(m, np.concatenate([live, live + 10 ** 5, live + 10 ** 6]))
    check()
    assert got.arrays[0].shape == (512, 3) and got.arrays[1].dtype == torch.int32


def test_on_new_keyframe_equals_reference(setup):
    """One keyframe through the whole local-mapping pipeline on both sides:
    the same triangulated / fused / culled counts, the same local-BA window
    (keyframes, points, edges, erased), cost within 1e-3 relative, and the
    same map afterwards (structure exact, geometry within 1e-3)."""
    rcfg, cfg, rrig, rig = setup
    rm, pm, rkf, pkf, sf = _maps()
    want = ref_lm.LocalMapper(rcfg, rrig, rm)
    got = local_mapping.LocalMapper(cfg, rig, pm)
    recent = sorted(rm.points)[-60:]
    want.recent_mids, got.recent_mids = list(recent), list(recent)
    for mid in recent[::3]:                    # poor found ratio: culled
        rm.points[mid].n_visible = pm.points[mid].n_visible = 40
    want.on_new_keyframe(rkf)
    got.on_new_keyframe(pkf)
    assert got.kf_log == want.kf_log
    assert want.n_triangulated > 50 and want.n_fused > 20
    assert (got.n_triangulated, got.n_fused, got.n_culled_kf) == \
        (want.n_triangulated, want.n_fused, want.n_culled_kf)
    assert got.recent_mids == want.recent_mids
    (gk, g_nkf, g_nmp, g_ne, g_cost, g_er), = got.ba_log
    (wk, w_nkf, w_nmp, w_ne, w_cost, w_er), = want.ba_log
    assert (gk, g_nkf, g_nmp, g_ne, g_er) == (wk, w_nkf, w_nmp, w_ne, w_er)
    np.testing.assert_allclose(g_cost, w_cost, rtol=1e-3)
    assert got.ba_shapes[0] == (ba_pack._bucket(g_nkf, 8), ba_pack._bucket(g_nmp, 256),
                                ba_pack._bucket(g_ne, 1024))
    a, b = map_snapshot(pm), map_snapshot(rm)
    assert a["keyframes"].keys() == b["keyframes"].keys()
    assert a["points"].keys() == b["points"].keys()
    for kid in a["keyframes"]:
        np.testing.assert_array_equal(a["keyframes"][kid]["mp_idx"],
                                      b["keyframes"][kid]["mp_idx"])
        np.testing.assert_allclose(a["keyframes"][kid]["T_cw"],
                                   b["keyframes"][kid]["T_cw"], atol=1e-3)
    for mid in a["points"]:
        assert a["points"][mid]["obs"] == b["points"][mid]["obs"]
        np.testing.assert_allclose(a["points"][mid]["pos"],
                                   b["points"][mid]["pos"], atol=1e-3)


def test_search_cross_cameras_guard_and_stub(setup):
    rcfg, cfg, rrig, rig = setup
    _, pm, _, pkf, _ = _maps()
    mapper = local_mapping.LocalMapper(cfg, rig, pm)
    assert mapper._search_cross_cameras(pkf) is None      # no vocabulary
    import dataclasses
    dual = dataclasses.replace(cfg, cameras=cfg.cameras * 2)
    from orbslam2_dualcam_tpu_torch.models.kfdb import KeyFrameDatabase
    from orbslam2_dualcam_tpu_torch.vocab import bow
    voc = bow.train_vocabulary(random_desc(np.random.default_rng(0), 200),
                               branching=4, depth=2, device="cpu")
    mapper = local_mapping.LocalMapper(dual, rig, pm,
                                       kfdb=KeyFrameDatabase(2, voc.n_words),
                                       voc=voc)
    assert mapper._search_cross_cameras(pkf) is None      # map not metric
    assert "search_cross" not in mapper.timer.samples
    pm.map_scaled = True
    # a metric map and an empty database: the harvest runs, finds no
    # candidate and changes nothing (it raised before it was ported)
    before = map_snapshot(pm)
    assert mapper._search_cross_cameras(pkf) is None
    assert len(mapper.timer.samples["search_cross"]) == 1
    assert mapper.n_cross_harvested == 0
    assert_snapshots_equal(before, map_snapshot(pm))


def test_make_extract_fn_equals_reference(setup):
    """The extraction program at two feature counts against the reference's:
    keypoints within 1e-3 px on >= 97% of slots and >= 99% of the
    descriptor bits equal on those (the bands tests/test_torch_orb.py
    states for the extractor)."""
    rcfg, cfg, rrig, rig = setup
    img = rendered_frame(3)[None]
    for n in (cfg.orb.n_track, cfg.orb.n_init):
        want = ref_frontend.make_extract_fn(rcfg, n, None, rrig)(jnp.asarray(img))
        got = frontend.make_extract_fn(cfg, n, None, rig, device="cpu")(t(img))
        assert got.feats.uv.shape == (1, n, 2)
        same = np.abs(got.feats.uv.numpy() - np.asarray(want.feats.uv)).max(-1) < 1e-3
        assert same.mean() >= 0.97
        diff = np.unpackbits((desc_to_numpy(got.feats.desc) ^
                              np.asarray(want.feats.desc))[same].view(np.uint8))
        assert 1.0 - diff.mean() >= 0.99
        assert (got.words.numpy() == -1).all() and (got.nodes.numpy() == -1).all()
    with pytest.raises(ValueError, match="images on"):
        frontend.make_extract_fn(cfg, 100, None, rig, device="cpu")(
            t(img).to("meta"))
