"""Shared helpers of the torch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages: the
JAX reference runs on JAX's CPU backend, the port on torch's CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam2_dualcam_tpu.utils import synthetic

# the suite runs 6 xdist workers on 8 cores: one torch thread each
torch.set_num_threads(1)


def small_K(H: int = 240, W: int = 320) -> np.ndarray:
    return np.array([[260.0 * W / 320, 0, W / 2], [0, 260.0 * H / 240, H / 2],
                     [0, 0, 1]])


def rendered_frame(seed: int = 0, H: int = 240, W: int = 320) -> np.ndarray:
    """A u8-valued float32 frame of the reference's textured box room."""
    world = synthetic.make_box_world(np.random.default_rng(seed), half=6.0,
                                     tex_size=256)
    img = synthetic.render(world, small_K(H, W), np.eye(4), H=H, W=W)
    return np.round(img).astype(np.float32)


def random_desc(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


def t(x, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype)


def scripted_cfg(ref_config):
    """The small mono configuration of the system tests (one 320x240
    camera, 400 features, 4 levels), as the reference's dataclasses."""
    return ref_config.SystemConfig(
        cameras=(ref_config.CameraConfig(width=320, height=240, fx=260, fy=260,
                                         cx=160, cy=120),),
        orb=ref_config.OrbConfig(n_features=400, n_levels=4),
        mapping=ref_config.MappingConfig(cull_found_ratio=0.1),
        capacity=ref_config.CapacityConfig(max_local_mp=2048))


def scripted_map(map_mod, seed: int = 0, n_kf: int = 6, n_feat: int = 400,
                 n_pts: int = 700):
    """A small mono map built through the public operations of `map_mod`
    (the reference's models.map or the port's): n_kf keyframes crab-walking
    along x in front of a cloud of n_pts points, each point with its own
    256-bit descriptor (a few bits flipped per view).

    60% of the points are map points observed by most keyframes that see
    them (a fifth of the observations are left out, so fusion has work), a
    few of them doubled (two map points on one 3D point, observed by
    different keyframes, so fusion merges), and the rest appear only as
    unmapped keypoints (so triangulation has work).  The newest keyframe
    observes 70% of the map points it sees, like a keyframe the tracker has
    just made.  Returns (map, newest keyframe, scale_factors)."""
    rng = np.random.default_rng(seed)
    K = small_K()
    scale_factors = (1.2 ** np.arange(4)).astype(np.float32)
    X = np.stack([rng.uniform(-4, 5.5, n_pts), rng.uniform(-2, 2, n_pts),
                  rng.uniform(4, 8, n_pts)], 1)
    base_desc = rng.integers(0, 2 ** 32, (n_pts, 8), dtype=np.uint32)
    base_angle = rng.uniform(0, 2 * np.pi, n_pts)
    base_level = rng.integers(0, 2, n_pts)
    mapped = rng.random(n_pts) < 0.6
    T_sc = np.eye(4)[None]
    m = map_mod.Map()
    kfs, rows_of = [], []
    for k in range(n_kf):
        T = np.eye(4)
        T[:3, 3] = [-0.3 * k, 0.0, 0.0]
        x = X @ T[:3, :3].T + T[:3, 3]
        uv = (x[:, :2] / x[:, 2:]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
        vis = np.nonzero((uv[:, 0] > 8) & (uv[:, 0] < 312) & (uv[:, 1] > 8) &
                         (uv[:, 1] < 232))[0][:n_feat]
        n = len(vis)
        kuv = np.zeros((n_feat, 2))
        kuv[:n] = uv[vis] + rng.normal(0, 0.3, (n, 2))
        desc = np.zeros((n_feat, 8), np.uint32)
        flips = np.zeros((n, 8), np.uint32)
        for _ in range(4):
            flips[np.arange(n), rng.integers(0, 8, n)] ^= (
                np.uint32(1) << rng.integers(0, 32, n).astype(np.uint32))
        desc[:n] = base_desc[vis] ^ flips
        level = np.zeros(n_feat, np.int32)
        level[:n] = base_level[vis]
        angle = np.zeros(n_feat, np.float32)
        angle[:n] = base_angle[vis] + rng.normal(0, 0.02, n)
        valid = np.arange(n_feat) < n
        kf = map_mod.KeyFrame(
            kid=m.new_kid(), frame_id=3 * k, T_cw=T.copy(), uv=kuv,
            kp_cam=np.zeros(n_feat, np.int64), level=level, angle=angle,
            desc=desc, kp_valid=valid, mp_idx=np.full(n_feat, -1, np.int64),
            word=np.full(n_feat, -1, np.int64),
            node=np.full(n_feat, -1, np.int64))
        m.add_keyframe(kf)
        kfs.append(kf)
        rows_of.append({int(p): r for r, p in enumerate(vis)})
    doubled = set(np.nonzero(mapped)[0][::17].tolist())
    for p in np.nonzero(mapped)[0]:
        p = int(p)
        seen = [k for k in range(n_kf) if p in rows_of[k]]
        if len(seen) < 2:
            continue
        groups = ([seen[:len(seen) // 2], seen[len(seen) // 2:]]
                  if p in doubled and len(seen) >= 4 else [seen])
        for g in groups:
            mp = m.new_point(X[p] + rng.normal(0, 0.01, 3), g[0], 0)
            for k in g:
                newest = k == n_kf - 1
                if rng.random() < (0.3 if newest else 0.2) and len(mp.obs) >= 2:
                    continue
                m.add_observation(mp, kfs[k], rows_of[k][p], 0)
            if len(mp.obs) < 2:
                m.erase_point(mp)
    for mp in list(m.points.values()):
        map_mod.update_point_stats(mp, m, T_sc, scale_factors)
    for kf in kfs:
        m.update_connections(kf)
    return m, kfs[-1], scale_factors


def scripted_loop_map(seed: int = 0, n_out: int = 8, n_back: int = 5,
                      n_feat: int = 400, n_pts: int = 700,
                      drift=(1.05, (0.05, 0.0, 0.0), 1.0)):
    """A small mono map of the reference with a loop to close, its keyframe
    database (the pure-Python postings) and the vocabulary its words come
    from.

    n_out keyframes crab-walk along x (0.3 m apart) in front of a cloud of
    n_pts points, as in `scripted_map`.  Then n_back revisit keyframes come
    back over the start (true centres 0.1 ... 0.7 m along x): they see the
    same 3D points, but through NEW map points, and their stored poses and
    points lie in a frame drifted by the Sim3 `drift` = (scale, translation,
    degrees about y), as a monocular map drifts around a loop.  Every
    keyframe's descriptor rows are quantized by a vocabulary (8^3) trained
    on the points' descriptors, so BoW matching and the database work.
    Returns (map, kfdb, vocabulary, revisit kids)."""
    import jax.numpy as jnp

    from orbslam2_dualcam_tpu.models import kfdb as ref_kfdb
    from orbslam2_dualcam_tpu.models import map as ref_map
    from orbslam2_dualcam_tpu.ops import lie as ref_lie
    from orbslam2_dualcam_tpu.vocab import bow as ref_bow

    rng = np.random.default_rng(seed)
    K = small_K()
    scale_factors = (1.2 ** np.arange(4)).astype(np.float32)
    X = np.stack([rng.uniform(-4, 5.5, n_pts), rng.uniform(-2, 2, n_pts),
                  rng.uniform(4, 8, n_pts)], 1)
    base_desc = rng.integers(0, 2 ** 32, (n_pts, 8), dtype=np.uint32)
    base_angle = rng.uniform(0, 2 * np.pi, n_pts)
    base_level = rng.integers(0, 2, n_pts)
    voc = ref_bow.train_vocabulary(base_desc, branching=8, depth=3, seed=seed)
    s_d, t_d, deg = drift
    D = np.eye(4)
    D[:3, :3] = s_d * np.asarray(ref_lie.so3_exp(jnp.asarray(
        [0.0, np.deg2rad(deg), 0.0], jnp.float32)), np.float64)
    D[:3, 3] = t_d
    D_inv = np.linalg.inv(D)
    m = ref_map.Map()
    T_sc = np.eye(4)[None]

    def se3_of_sim3(S):
        s = np.cbrt(np.linalg.det(S[:3, :3]))
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = S[:3, :3] / s, S[:3, 3] / s
        return T

    def view(T_true, T_store, frame_id):
        """A keyframe at true pose T_true, stored at T_store; returns it and
        the row of each point it sees."""
        x = X @ T_true[:3, :3].T + T_true[:3, 3]
        uv = (x[:, :2] / x[:, 2:]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
        vis = np.nonzero((uv[:, 0] > 8) & (uv[:, 0] < 312) & (uv[:, 1] > 8) &
                         (uv[:, 1] < 232))[0][:n_feat]
        n = len(vis)
        kuv = np.zeros((n_feat, 2))
        kuv[:n] = uv[vis] + rng.normal(0, 0.3, (n, 2))
        desc = np.zeros((n_feat, 8), np.uint32)
        flips = np.zeros((n, 8), np.uint32)
        for _ in range(4):
            flips[np.arange(n), rng.integers(0, 8, n)] ^= (
                np.uint32(1) << rng.integers(0, 32, n).astype(np.uint32))
        desc[:n] = base_desc[vis] ^ flips
        level = np.zeros(n_feat, np.int32)
        level[:n] = base_level[vis]
        angle = np.zeros(n_feat, np.float32)
        angle[:n] = base_angle[vis] + rng.normal(0, 0.02, n)
        valid = np.arange(n_feat) < n
        w, nd = ref_bow.quantize(voc, jnp.asarray(desc))
        word = np.where(valid, np.asarray(w), -1).astype(np.int64)
        node = np.where(valid, np.asarray(nd), -1).astype(np.int64)
        kf = ref_map.KeyFrame(
            kid=m.new_kid(), frame_id=frame_id, T_cw=T_store.copy(), uv=kuv,
            kp_cam=np.zeros(n_feat, np.int64), level=level, angle=angle,
            desc=desc, kp_valid=valid, mp_idx=np.full(n_feat, -1, np.int64),
            word=word, node=node)
        m.add_keyframe(kf)
        return kf, {int(p): r for r, p in enumerate(vis)}

    def observe(kfs, rows_of, where):
        """Map 60% of the points, at `where(X)`, observed by most of the
        keyframes that see them (a fifth of the observations left out)."""
        mapped = rng.random(n_pts) < 0.6
        for p in np.nonzero(mapped)[0]:
            p = int(p)
            seen = [k for k in range(len(kfs)) if p in rows_of[k]]
            if len(seen) < 2:
                continue
            mp = m.new_point(where(X[p]) + rng.normal(0, 0.01, 3),
                             kfs[seen[0]].kid, 0)
            for k in seen:
                if rng.random() < 0.2 and len(mp.obs) >= 2:
                    continue
                m.add_observation(mp, kfs[k], rows_of[k][p], 0)
            if len(mp.obs) < 2:
                m.erase_point(mp)

    out, rows_out = [], []
    for k in range(n_out):
        T = np.eye(4)
        T[:3, 3] = [-0.3 * k, 0.0, 0.0]
        kf, rows = view(T, T, 3 * k)
        out.append(kf)
        rows_out.append(rows)
    observe(out, rows_out, lambda x: x)
    back, rows_back = [], []
    for j in range(n_back):
        T = np.eye(4)
        T[:3, 3] = [-(0.1 + 0.15 * j), 0.0, 0.0]
        kf, rows = view(T, se3_of_sim3(T @ D_inv), 3 * (n_out + j))
        back.append(kf)
        rows_back.append(rows)
    observe(back, rows_back, lambda x: D[:3, :3] @ x + D[:3, 3])
    for mp in list(m.points.values()):
        ref_map.update_point_stats(mp, m, T_sc, scale_factors)
    db = ref_kfdb.KeyFrameDatabase(1, voc.n_words, use_native=False)
    for kf in out + back:
        m.update_connections(kf)
        v = kf.kp_valid & (kf.word >= 0)
        db.add(kf.kid, 0, kf.word[v], ref_bow.sparse_bow(voc, kf.word, v))
    return m, db, voc, [kf.kid for kf in back]


def map_snapshot(m) -> dict:
    """Everything a Map holds, as plain comparable Python/numpy values."""
    kfs = {}
    for kid, kf in m.keyframes.items():
        kfs[kid] = dict(
            frame_id=kf.frame_id, T_cw=kf.T_cw.copy(), mp_idx=kf.mp_idx.copy(),
            covis=dict(kf.covis), parent=kf.parent,
            children=sorted(kf.children), is_bad=kf.is_bad,
            scaled=kf.scaled, loop_edges=sorted(kf.loop_edges))
    pts = {}
    for mid, mp in m.points.items():
        pts[mid] = dict(
            pos=mp.pos.copy(), obs=dict(mp.obs), obs_cam=dict(mp.obs_cam),
            normal=np.asarray(mp.normal).copy(), min_dist=float(mp.min_dist),
            max_dist=float(mp.max_dist), desc=np.asarray(mp.desc).copy(),
            n_visible=mp.n_visible, n_found=mp.n_found, ref_kid=mp.ref_kid,
            first_kf_id=mp.first_kf_id, replaced_by=mp.replaced_by)
    return dict(keyframes=kfs, points=pts, next_kid=m.next_kid,
                next_mid=m.next_mid, origin_kid=m.origin_kid,
                map_scaled=m.map_scaled, first_scale_kid=m.first_scale_kid,
                geometry_epoch=m.geometry_epoch,
                culled_redirect={k: (v[0], v[1].copy())
                                 for k, v in m.culled_redirect.items()})


def assert_snapshots_equal(a, b, path="map"):
    """Exact equality of two `map_snapshot`s (arrays to the bit)."""
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), path
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_snapshots_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_snapshots_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)
