"""Tests of the port that need a CUDA card (marker `gpu`; they skip
elsewhere).  This file imports neither jax nor the JAX package, so it runs
on a machine that has only torch:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu_torch import CameraConfig, OrbConfig, SystemConfig
from orbslam2_dualcam_tpu_torch.ops import fast_nms as k1
from orbslam2_dualcam_tpu_torch.ops.camera import make_rig
from orbslam2_dualcam_tpu_torch.ops.orb import extract_orb_rig, level_shapes
from orbslam2_dualcam_tpu_torch.pipeline import frontend
from orbslam2_dualcam_tpu_torch.utils import synthetic
from orbslam2_dualcam_tpu_torch.utils.convert import desc_to_numpy, desc_to_torch
from orbslam2_dualcam_tpu_torch.vocab import bow

torch.set_num_threads(1)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rendered(H, W, seed=0):
    world = synthetic.make_box_world(np.random.default_rng(seed), half=6.0,
                                     tex_size=256)
    K = np.array([[500.0 * W / 640, 0, W / 2], [0, 500.0 * H / 480, H / 2], [0, 0, 1]])
    img = synthetic.render_rig(world, np.stack([K, K]),
                               np.stack([np.eye(4), np.diag([-1.0, 1, -1, 1])]),
                               np.eye(4), H=H, W=W)
    return np.round(img).astype(np.float32)


@pytest.mark.gpu
def test_fast_nms_kernel_matches_plain_on_card():
    """K1 against its plain version on the card, at every main-path level
    shape for two cameras and a non-tile-aligned one: exact, on u8-valued
    and on random float input (the sums run in the same order)."""
    _card()
    rng = np.random.default_rng(2)
    shapes = level_shapes(480, 640, 8, 1.2) + [(100, 150)]
    for H, W in shapes:
        for img in (_rendered(H, W), rng.uniform(0, 255, (2, H, W)).astype(np.float32)):
            x = torch.as_tensor(img, device="cuda")
            n0 = k1.fast_nms.launches
            s, sad = k1.fast_nms(x, 20.0, 7.0)
            torch.cuda.synchronize()
            assert k1.fast_nms.launches == n0 + 1
            rs, rsad = k1.fast_nms_reference(x, 20.0, 7.0)
            assert torch.equal(s, rs), (H, W)
            assert torch.equal(sad, rsad), (H, W)
    s2, _ = k1.fast_nms(x[0].contiguous(), 20.0, 7.0)      # (H, W) input
    assert torch.equal(s2, rs[0])


@pytest.mark.gpu
@pytest.mark.parametrize("ncam", [1, 3])
def test_fast_nms_levels_ragged_shapes_on_card(ncam):
    """One launch over levels of odd sizes, one smaller than a tile, one a
    single row of tiles plus one pixel, one an (H, W) image: bit-exact
    against the plain version level by level, on u8-valued and on random
    float input, for 1 and 3 cameras."""
    _card()
    rng = np.random.default_rng(5 + ncam)
    shapes = [(479, 641), (241, 319), (31, 63), (7, 9), (30, 62), (61, 125), (1, 1)]
    for valued in ("u8", "float"):
        levels = []
        for h, w in shapes:
            x = rng.uniform(0, 255, (ncam, h, w)).astype(np.float32)
            if valued == "u8":
                # smooth enough for arcs at both thresholds, integer-valued
                x = np.round(np.cumsum(np.cumsum(x - 127.5, 1), 2) % 256)
            levels.append(torch.as_tensor(x.astype(np.float32), device="cuda"))
        levels.append(levels[1][0].contiguous())            # an (H, W) level
        n0 = k1.fast_nms.launches
        outs = k1.fast_nms_levels(levels, 20.0, 7.0)
        torch.cuda.synchronize()
        assert k1.fast_nms.launches == n0 + 1
        for x, (s, sad) in zip(levels, outs):
            rs, rsad = k1.fast_nms_reference(x, 20.0, 7.0)
            assert s.shape == x.shape and sad.shape == x.shape
            assert torch.equal(s, rs), (valued, tuple(x.shape))
            assert torch.equal(sad, rsad), (valued, tuple(x.shape))
    # equal thresholds are allowed
    s, sad = k1.fast_nms(levels[0], 9.0, 9.0)
    rs, rsad = k1.fast_nms_reference(levels[0], 9.0, 9.0)
    assert torch.equal(s, rs) and torch.equal(sad, rsad)


@pytest.mark.gpu
def test_fast_nms_rejects_what_the_kernel_does_not_take():
    _card()
    x = torch.zeros(2, 64, 64, device="cuda")
    n0 = k1.fast_nms.launches
    with pytest.raises(TypeError):
        k1.fast_nms(x.double(), 20.0, 7.0)
    with pytest.raises(ValueError):
        k1.fast_nms(x.transpose(1, 2), 20.0, 7.0)
    with pytest.raises(ValueError):
        k1.fast_nms(x[None], 20.0, 7.0)
    with pytest.raises(ValueError, match="th_hi >= th_lo >= 0"):
        k1.fast_nms(x, 7.0, 20.0)
    with pytest.raises(ValueError, match="th_hi >= th_lo >= 0"):
        k1.fast_nms(x, 7.0, -1.0)
    with pytest.raises(ValueError, match="at most"):
        k1.fast_nms_levels([x] * 17, 20.0, 7.0)
    with pytest.raises(ValueError, match="levels on"):
        k1.fast_nms_levels([x, x.cpu()], 20.0, 7.0)
    # the unfused FAST path is not offered on the card
    with pytest.raises(ValueError):
        extract_orb_rig(x, OrbConfig(n_levels=2, pallas_fast=False), 100)
    assert k1.fast_nms.launches == n0


@pytest.mark.gpu
def test_track_chain_on_card_matches_cpu():
    """The fused step on the card against the port on the CPU, over a
    4-frame rendered chain at 2 x 240 x 320: K1 launches once per frame
    (the whole pyramid in one launch), the entry points built with no
    `device` argument land on the card, poses agree to 1e-3, n_final within max(3, 3%), >= 95% of
    matched slots equal (the CPU run's own agreement with the reference,
    tests/test_torch_track.py)."""
    _card()
    H, W, NF, CAP = 240, 320, 400, 256
    cam = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=W, height=H)
    cfg = SystemConfig(cameras=(CameraConfig(**cam), CameraConfig(
        **cam, q_sc=(0.0, 0.0, 1.0, 0.0), t_sc=(0.0, 0.0, 0.10))),
        orb=OrbConfig(n_levels=4))
    world = synthetic.make_box_world(np.random.default_rng(1), half=6.0,
                                     tex_size=256)
    poses = synthetic.orbit_trajectory(5, radius=1.5, total_angle=0.3)
    rig_cpu = make_rig(cfg, "cpu")
    K, T_sc = rig_cpu.K.numpy(), rig_cpu.T_sc.numpy()
    frames = [np.round(synthetic.render_rig(world, K, T_sc, T, H, W)).astype(np.uint8)
              for T in poses]
    voc_np = np.random.default_rng(0).integers(0, 2 ** 32, (2000, 8), dtype=np.uint32)
    f = frontend._extract_frame_body(
        torch.as_tensor(frames[0]), cfg, NF,
        bow.train_vocabulary(voc_np, branching=4, depth=2, seed=1, direct_level=1,
                             device="cpu"),
        rig_cpu).feats
    st = synthetic.seed_store(world, K, T_sc, poses[0], f.uv.numpy(),
                              f.level.numpy(), desc_to_numpy(f.desc),
                              f.valid.numpy(), cfg.orb.scale_factors, CAP)

    def run(device):
        voc = bow.train_vocabulary(voc_np, branching=4, depth=2, seed=1,
                                   direct_level=1, device=device)
        # device=None is the current CUDA device
        on_card = device == "cuda"
        step = frontend.make_track_fn(cfg, NF, voc, make_rig(cfg, device),
                                      *(() if on_card else (device,)))
        mp = [torch.as_tensor(x, device=device) for x in st[:6]]
        mp[1] = desc_to_torch(st.desc, device)
        T = torch.as_tensor(poses[0], dtype=torch.float32, device=device)
        V = torch.eye(4, device=device)
        s = torch.as_tensor(st.slots, device=device)
        on = torch.ones(2, dtype=torch.bool, device=device)
        outs = []
        for img in frames[1:]:
            _, o = step(torch.as_tensor(img, device=device), T, V, s, on, *mp)
            T, V, s = o.T_cw, o.V_new, o.mp_slots
            assert o.T_cw.device.type == device
            outs.append([x.cpu().numpy() for x in o])
        return outs

    cpu = run("cpu")
    n0 = k1.fast_nms.launches
    card = run("cuda")
    assert k1.fast_nms.launches - n0 == len(frames) - 1
    for c, g in zip(cpu, card):
        np.testing.assert_allclose(g[0], c[0], rtol=0, atol=1e-3)
        assert abs(int(g[4]) - int(c[4])) <= max(3, 0.03 * int(c[4]))
        assert (g[2] == c[2]).mean() >= 0.95


@pytest.mark.gpu
def test_default_device_is_the_card():
    """With no `device` argument the rig, the converters, the step and the
    batched step lie on the current CUDA device, and a batch of frames
    equals the same frames run one by one there."""
    _card()
    H, W, NF, CAP, D = 120, 160, 150, 64, 3
    cam = dict(fx=125.0, fy=125.0, cx=80.0, cy=60.0, width=W, height=H)
    cfg = SystemConfig(cameras=(CameraConfig(**cam), CameraConfig(
        **cam, q_sc=(0.0, 0.0, 1.0, 0.0), t_sc=(0.0, 0.0, 0.10))),
        orb=OrbConfig(n_levels=3))
    here = torch.device("cuda", torch.cuda.current_device())
    rig = make_rig(cfg)
    assert all(t.device == here for t in rig)
    assert desc_to_torch(np.zeros((2, 8), np.uint32)).device == here
    rng = np.random.default_rng(0)
    imgs = torch.as_tensor(rng.integers(0, 256, (D, 2, H, W), dtype=np.uint8),
                           device=here)
    state = (torch.eye(4, device=here), torch.eye(4, device=here),
             torch.full((2, NF), -1, device=here),
             torch.ones(2, dtype=torch.bool, device=here),
             torch.as_tensor(rng.normal(size=(CAP, 3)).astype(np.float32), device=here),
             desc_to_torch(rng.integers(0, 2 ** 32, (CAP, 8), dtype=np.uint32)),
             torch.ones(CAP, dtype=torch.bool, device=here),
             torch.full((CAP,), 10.0, device=here), torch.full((CAP,), 0.1, device=here),
             torch.as_tensor(rng.normal(size=(CAP, 3)).astype(np.float32), device=here))
    step = frontend.make_track_fn(cfg, NF, None, rig)
    batch = frontend.make_track_batch_fn(cfg, NF, None, rig, D)
    n0 = k1.fast_nms.launches
    carry, fds, outs = batch(imgs, *state)
    assert k1.fast_nms.launches == n0 + D
    assert all(x.device == here and x.shape[0] == D for x in outs)
    assert fds.feats.desc.shape == (D, 2, NF, 8)
    T, V, s = state[:3]
    for k in range(D):
        _, o = step(imgs[k], T, V, s, *state[3:])
        T, V, s = o.T_cw, o.V_new, o.mp_slots
        for a, b in zip(outs, o):
            assert torch.equal(a[k], b)
    assert torch.equal(carry[0], T) and torch.equal(carry[2], s)


def _small_system_cfg():
    import dataclasses

    from orbslam2_dualcam_tpu_torch import CapacityConfig, MappingConfig
    cfg = SystemConfig(
        cameras=(CameraConfig(width=320, height=240, fx=260, fy=260, cx=160,
                              cy=120),),
        orb=OrbConfig(n_features=400, n_levels=4),
        mapping=MappingConfig(cull_found_ratio=0.1),
        capacity=CapacityConfig(max_local_mp=2048))
    return dataclasses.replace(cfg, vocab=dataclasses.replace(cfg.vocab, seed=0))


@pytest.mark.gpu
def test_system_runs_on_the_card_by_default():
    """System(cfg) with no device lands on the card, initializes, tracks,
    inserts keyframes and bundle-adjusts a small rendered orbit there, with
    one K1 launch per track call; a run on the host CPU of the same frames
    initializes at the same frame with a map-point count within 5% (the
    RANSAC sets are drawn on the CPU, so both runs draw the same)."""
    _card()
    from orbslam2_dualcam_tpu_torch.pipeline.system import System
    from orbslam2_dualcam_tpu_torch.utils import metrics
    cfg = _small_system_cfg()
    world = synthetic.make_box_world(np.random.default_rng(42), half=6.0)
    poses = synthetic.orbit_trajectory(45, radius=1.5, total_angle=0.8 * np.pi)[:25]
    runs = {}
    for device in (None, "cpu"):
        sys_ = System(cfg, voc=None, enable_loop_closing=False, device=device)
        assert sys_.rig.K.device.type == ("cuda" if device is None else "cpu")
        K, T_sc = sys_.rig.K.cpu().numpy(), sys_.rig.T_sc.cpu().numpy()
        states = []
        for k, T in enumerate(poses[:25 if device is None else 6]):
            img = synthetic.render_rig(world, K, T_sc, T, H=240, W=320)
            n0 = k1.fast_nms.launches
            states.append(sys_.track(img, k / 30.0))
            if device is None:
                assert k1.fast_nms.launches == n0 + 1
        runs[device] = (sys_, states)
    card, states = runs[None]
    assert states[-1] == "OK" and "OK" in states[:12] and states.count("LOST") <= 3
    assert card.map.n_keyframes >= 4 and card.map.n_points > 150
    assert card.mapper.n_triangulated > 50 and card.mapper.ba_log
    assert card.tracker.n_fused_frames >= 1
    assert card.tracker._store.arrays[0].is_cuda
    traj = card.tracker.composed_trajectory()
    est = metrics.trajectory_positions(traj)
    gt = np.asarray([-poses[f][:3, :3].T @ poses[f][:3, 3] for f, _, _ in traj])
    assert metrics.ate_rmse(est, gt) < 0.30
    init = [next(e for e in runs[d][0].tracker.events if e.startswith("INIT@"))
            for d in (None, "cpu")]
    assert init[0].split()[0] == init[1].split()[0], init
    n = [int(e.split("pts=")[1]) for e in init]
    assert abs(n[0] - n[1]) <= 0.05 * n[1], init


@pytest.mark.gpu
def test_solve_ba_chunk_never_synchronizes_and_matches_cpu():
    """One solve_ba chunk on the card under sync debug mode "error", and
    against the same chunk on the host CPU: cost within 1e-3 relative,
    poses within 1e-4 (the card's sums are float atomics)."""
    _card()
    from orbslam2_dualcam_tpu_torch.optim import ba
    from orbslam2_dualcam_tpu_torch.optim.factors import Edges
    rng = np.random.default_rng(0)
    cfg = _small_system_cfg()
    n_kf, n_pt, K_PAD, M_PAD, E_PAD = 8, 120, 8, 256, 1024
    Kc = np.array([[260.0, 0, 160], [0, 260.0, 120], [0, 0, 1]])
    X = np.stack([rng.uniform(-3, 3, n_pt), rng.uniform(-2, 2, n_pt),
                  rng.uniform(4, 9, n_pt)], 1)
    poses = np.tile(np.eye(4, dtype=np.float32), (K_PAD, 1, 1))
    ekf, emp, euv = [], [], []
    for k in range(n_kf):
        T = np.eye(4)
        T[:3, 3] = [-0.25 * k, 0, 0]
        x = X + T[:3, 3]
        uv = x[:, :2] / x[:, 2:] * 260.0 + [160, 120]
        vis = np.nonzero((uv[:, 0] > 0) & (uv[:, 0] < 320) & (uv[:, 1] > 0) &
                         (uv[:, 1] < 240))[0]
        ekf += [k] * len(vis)
        emp += vis.tolist()
        euv += (uv[vis] + rng.normal(0, 0.5, (len(vis), 2))).tolist()
        if k >= 2:
            T[:3, 3] += rng.normal(0, 0.01, 3)
        poses[k] = T
    E = len(ekf)
    assert 200 < E <= E_PAD
    pad = E_PAD - E
    points = np.zeros((M_PAD, 3), np.float32)
    points[:n_pt] = X + rng.normal(0, 0.05, X.shape)

    def build(device):
        dev = lambda a: torch.as_tensor(a, device=device)
        edges = Edges(kf=dev(np.asarray(ekf + [0] * pad)), mp=dev(np.asarray(emp + [0] * pad)),
                      cam=dev(np.zeros(E_PAD, np.int64)),
                      uv=dev(np.asarray(euv + [[0.0, 0.0]] * pad, np.float32)),
                      inv_sigma2=dev(np.asarray([1.0] * E + [0.0] * pad, np.float32)),
                      valid=dev(np.arange(E_PAD) < E))
        prob = ba.BAProblem(dev(poses), dev(points), edges,
                            dev(np.arange(K_PAD) < n_kf), dev(np.arange(K_PAD) < 2),
                            dev(np.arange(M_PAD) < n_pt))
        rig = make_rig(cfg, device)
        return prob, (rig.T_sc, rig.adj_sc, rig.K)

    prob, args = build("cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ba.solve_ba(prob, *args, iters=cfg.ba.abort_chunk)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cprob, cargs = build("cpu")
    want = ba.solve_ba(cprob, *cargs, iters=cfg.ba.abort_chunk)
    c0 = float(ba.solve_ba(cprob, *cargs, iters=0).cost)
    assert float(want.cost) < 0.5 * c0
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-3)
    assert (got.poses.cpu() - want.poses).abs().max().item() < 1e-4
    assert torch.equal(got.poses[0].cpu(), cprob.poses[0])


def _pnp_scene(rng, n=150, n_out=40):
    """The general scene of tests/test_torch_pnp.py, made with numpy."""
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)
    X = rng.uniform([-3, -2, 4], [3, 2, 10], size=(n, 3))
    a = 0.1
    T = np.eye(4)
    T[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    T[:3, 3] = [0.2, -0.1, 0.05]
    xc = X @ T[:3, :3].T + T[:3, 3]
    uv = xc[:, :2] / xc[:, 2:] * 500.0 + [320, 240] + rng.normal(0, 0.5, (n, 2))
    out = rng.choice(n, n_out, replace=False)
    uv[out] += rng.uniform(25, 100, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    return X.astype(np.float32), uv.astype(np.float32), K, T


@pytest.mark.gpu
def test_pnp_solve_on_card_matches_cpu():
    """The same 512 + 512 minimal sets on the card and on the CPU: the
    batched SVDs differ (cuSOLVER against LAPACK), so the card is held to
    bands: inlier counts within 2, rotation within 0.05 degrees,
    translation within 1e-3 of the depth, and both at the scene's pose."""
    _card()
    from orbslam2_dualcam_tpu_torch.ops import ransac
    X, uv, K, T_true = _pnp_scene(np.random.default_rng(7))
    valid = torch.ones(len(X), dtype=torch.bool)
    idx6, idx4 = ransac.pnp_samples(torch.Generator().manual_seed(3), 512, valid)
    args = [torch.as_tensor(a) for a in (X, uv)] + [valid, torch.as_tensor(K)]
    T_c, inl_c, n_c, ok_c = ransac.pnp_solve(idx6, idx4, *args)
    T_g, inl_g, n_g, ok_g = ransac.pnp_solve(
        idx6.cuda(), idx4.cuda(), *(a.cuda() for a in args))
    assert T_g.device.type == "cuda" and bool(ok_c) and bool(ok_g)
    assert abs(int(n_c) - int(n_g)) <= 2
    assert (inl_g.cpu() == inl_c).float().mean() >= 0.98
    T_g = T_g.cpu().numpy().astype(np.float64)
    for other in (T_c.numpy().astype(np.float64), T_true):
        tol_r, tol_t = (0.05, 7e-3) if other is not T_true else (1.5, 0.2)
        c = (np.trace(T_g[:3, :3] @ other[:3, :3].T) - 1) / 2
        assert np.degrees(np.arccos(np.clip(c, -1, 1))) < tol_r
        assert np.abs(T_g[:3, 3] - other[:3, 3]).max() < tol_t


@pytest.mark.gpu
def test_pose_graph_on_card_matches_cpu():
    """A 12-node ring with one loop edge, 20 LM steps: the final cost on
    the card within 1% of the CPU's (the per-node sums are float atomics on
    the card), node poses within 1e-3, and the loop closed (cost at least
    10x under the initial)."""
    _card()
    from orbslam2_dualcam_tpu_torch.ops import lie
    from orbslam2_dualcam_tpu_torch.optim import pose_graph
    rng = np.random.default_rng(0)
    K = 12
    xi = np.zeros((K, 7), np.float32)
    ang = 2 * np.pi * np.arange(K) / K
    xi[:, 0], xi[:, 2], xi[:, 4] = 2 * np.cos(ang), 2 * np.sin(ang), ang
    xi[:, 1], xi[:, 6] = 0.1 * np.arange(K), 0.02 * np.arange(K)
    S_true = lie.sim3_exp(torch.as_tensor(xi)).numpy().astype(np.float64)
    noise = lie.sim3_exp(torch.as_tensor(
        rng.normal(0, 0.02, (K, 7)).astype(np.float32))).numpy().astype(np.float64)
    S0 = [S_true[0]]
    for k in range(1, K):
        S0.append(noise[k] @ S_true[k] @ np.linalg.inv(S_true[k - 1]) @ S0[-1])
    e_i = np.asarray(list(range(1, K)) + [K - 1])
    e_j = np.asarray(list(range(0, K - 1)) + [0])
    S_meas = [S0[i] @ np.linalg.inv(S0[j]) for i, j in zip(e_i[:-1], e_j[:-1])]
    S_meas.append(S_true[K - 1] @ np.linalg.inv(S_true[0]))
    fixed = np.zeros(K, bool)
    fixed[0] = True
    args = [torch.as_tensor(np.stack(S0).astype(np.float32)), torch.as_tensor(e_i),
            torch.as_tensor(e_j), torch.as_tensor(np.stack(S_meas).astype(np.float32)),
            torch.ones(K, dtype=torch.bool), torch.as_tensor(fixed)]
    S_c, c_c = pose_graph.optimize_pose_graph(*args, iters=20)
    _, c_0 = pose_graph.optimize_pose_graph(*args, iters=0)
    on_card = [a.cuda() for a in args]
    torch.cuda.synchronize()
    # the whole solve queues on the stream: a host synchronization is an error
    torch.cuda.set_sync_debug_mode("error")
    try:
        S_g, c_g = pose_graph.optimize_pose_graph(*on_card, iters=20)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert S_g.device.type == "cuda"
    assert float(c_g) == pytest.approx(float(c_c), rel=0.01)
    assert float(c_g) < 0.1 * float(c_0)
    np.testing.assert_allclose(S_g.cpu().numpy(), S_c.numpy(), atol=1e-3)


@pytest.mark.gpu
def test_optimal_map_scale_on_card_matches_cpu():
    """A two-keyframe map whose 400 cross-camera edges are strained by 1.6:
    alpha on the card within 1e-3 of the CPU's, and both near 1.6."""
    _card()
    from orbslam2_dualcam_tpu_torch.models.map import KeyFrame, Map
    from orbslam2_dualcam_tpu_torch.optim import scale_opt
    cam = dict(width=640, height=480, fx=500, fy=500, cx=320, cy=240)
    cfg = SystemConfig(cameras=(CameraConfig(**cam),
                                CameraConfig(**cam, t_sc=(-0.5, 0.0, 0.0))))
    rng = np.random.default_rng(1)
    n = 400
    X = rng.uniform([-2, -1.5, 4], [2, 1.5, 8], (n, 3))
    T_sc1 = np.eye(4)
    T_sc1[:3, 3] = [-0.5, 0, 0]
    m = Map()
    kfs = []
    for k in range(2):
        T = np.eye(4)
        T[0, 3] = -0.3 * k
        uv = np.zeros((2 * n, 2))
        for c, Tc in enumerate((np.eye(4), T_sc1)):
            x = X @ (Tc @ T)[:3, :3].T + (Tc @ T)[:3, 3]
            uv[c * n:(c + 1) * n] = x[:, :2] / x[:, 2:] * 500 + [320, 240]
        uv += rng.normal(0, 0.5, uv.shape)
        kf = KeyFrame(kid=m.new_kid(), frame_id=k, T_cw=T, uv=uv,
                      kp_cam=np.repeat([0, 1], n),
                      level=np.zeros(2 * n, np.int32),
                      angle=np.zeros(2 * n, np.float32),
                      desc=np.zeros((2 * n, 8), np.uint32),
                      kp_valid=np.ones(2 * n, bool),
                      mp_idx=np.full(2 * n, -1, np.int64),
                      word=np.full(2 * n, -1, np.int64),
                      node=np.full(2 * n, -1, np.int64))
        m.add_keyframe(kf)
        kfs.append(kf)
    for i in range(n):
        mp = m.new_point(X[i], 0, 0)
        m.add_observation(mp, kfs[0], i, 0)
        m.add_observation(mp, kfs[1], n + i, 1)
    for kf in kfs:
        kf.T_cw[:3, 3] /= 1.6
    for mp in m.points.values():
        mp.pos = mp.pos / 1.6
    sigma2 = np.asarray(cfg.orb.scale_factors, np.float32) ** 2
    a_c, e_c = scale_opt.optimal_map_scale(m, make_rig(cfg, device="cpu"), sigma2)
    a_g, e_g = scale_opt.optimal_map_scale(m, make_rig(cfg), sigma2)
    assert e_c == e_g == n
    assert a_g == pytest.approx(a_c, abs=1e-3)
    assert a_g == pytest.approx(1.6, rel=0.02)


def _sim3_scene(rng, n=100, outlier_share=0.3, s=1.3):
    """The pairs of tests/test_torch_sim3.py (P1 = s R P2 + t, pixels with
    0.3 px of noise, a share of the pairs corrupted, per-pair level
    sigma2), made with numpy."""
    from orbslam2_dualcam_tpu_torch.ops import lie
    K = np.array([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]], np.float32)
    R = lie.so3_exp(torch.tensor([0.1, -0.2, 0.05])).numpy().astype(np.float64)
    t = np.array([0.3, -0.1, 0.4])
    P2 = rng.uniform([-2, -2, 4], [2, 2, 9], (n, 3))
    P1 = s * P2 @ R.T + t

    def proj(X):
        return X[:, :2] / X[:, 2:] * 300.0 + [160, 120] + rng.normal(0, 0.3, (n, 2))

    uv1, uv2 = proj(P1), proj(P2)
    bad = rng.choice(n, int(outlier_share * n), replace=False)
    P2[bad] += rng.uniform(0.5, 1.5, (len(bad), 3))
    sig2 = (1.2 ** (2 * rng.integers(0, 3, (2, n)))).astype(np.float32)
    S = np.eye(4)
    S[:3, :3], S[:3, 3] = s * R, t
    return ([torch.as_tensor(a.astype(np.float32)) for a in (P1, P2, uv1, uv2)]
            + [torch.as_tensor(sig2[0]), torch.as_tensor(sig2[1]),
               torch.as_tensor(K)], S)


def _rot_deg(Ra, Rb) -> float:
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(np.degrees(2.0 * np.arcsin(min(d / (2.0 * np.sqrt(2.0)), 1.0))))


@pytest.mark.gpu
def test_sim3_solve_and_optimize_sim3_on_card_match_cpu():
    """The same 128 minimal sets, then the two-stage optimizer, on the card
    and on the CPU: the batched eigh differs (cuSOLVER against LAPACK), so
    the card is held to bands: inlier masks within 2 points, rotation
    within 0.05 degrees, scale within 1e-3."""
    _card()
    from orbslam2_dualcam_tpu_torch.ops import lie, ransac
    from orbslam2_dualcam_tpu_torch.optim import sim3_opt
    (P1, P2, uv1, uv2, s1, s2, K), S_true = _sim3_scene(np.random.default_rng(5))
    valid = torch.ones(len(P1), dtype=torch.bool)
    idx = ransac.sim3_samples(torch.Generator().manual_seed(11), 128, valid)
    args = (P1, P2, valid, uv1, uv2, K, K, s1, s2)
    R_c, t_c, s_c, inl_c, n_c, ok_c = ransac.sim3_solve(idx, *args)
    R_g, t_g, s_g, inl_g, n_g, ok_g = ransac.sim3_solve(
        idx.cuda(), *(a.cuda() for a in args))
    assert R_g.device.type == "cuda" and bool(ok_c) and bool(ok_g)
    assert (inl_g.cpu() != inl_c).sum() <= 2
    assert _rot_deg(R_g.cpu(), R_c) < 0.05
    assert abs(float(s_g) - float(s_c)) < 1e-3
    S0 = lie.sim3(R_c, t_c, s_c)
    opt = (P1, P2, uv1, uv2, 1.0 / s1, 1.0 / s2, inl_c, K, K)
    S_oc, io_c, no_c = sim3_opt.optimize_sim3(S0, *opt)
    S_og, io_g, no_g = sim3_opt.optimize_sim3(S0.cuda(), *(a.cuda() for a in opt))
    assert S_og.device.type == "cuda"
    assert (io_g.cpu() != io_c).sum() <= 2 and int(no_g) >= 60
    S_og, S_oc = S_og.cpu().numpy().astype(np.float64), S_oc.numpy().astype(np.float64)
    for other, tol in ((S_oc, 0.05), (S_true, 0.5)):
        sg, so = np.cbrt(np.linalg.det(S_og[:3, :3])), np.cbrt(np.linalg.det(other[:3, :3]))
        assert _rot_deg(S_og[:3, :3] / sg, other[:3, :3] / so) < tol
        assert abs(sg - so) < (1e-3 if tol == 0.05 else 0.02)


@pytest.mark.gpu
def test_optimize_sim3_never_synchronizes():
    """Both LM stages, the outlier pass and the inlier count queue on the
    stream: with host synchronization made an error the call completes."""
    _card()
    from orbslam2_dualcam_tpu_torch.optim import sim3_opt
    (P1, P2, uv1, uv2, s1, s2, K), S_true = _sim3_scene(np.random.default_rng(6))
    args = [torch.as_tensor(S_true.astype(np.float32))] + [
        a.cuda() for a in (P1, P2, uv1, uv2, 1.0 / s1, 1.0 / s2)]
    args[0] = args[0].cuda()
    valid, Kc = torch.ones(len(P1), dtype=torch.bool, device="cuda"), K.cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        S, inl, n = sim3_opt.optimize_sim3(*args, valid, Kc, Kc)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(n) >= 60 and torch.isfinite(S).all()


@pytest.mark.gpu
def test_readback_waits_on_its_own_event():
    """utils.device.Readback, made behind a short sleep kernel, returns from
    wait() while a long sleep kernel queued after it still runs (it waits on
    its own event, not on the stream), with the values of its leaves; a
    Python thread keeps counting during the wait (the event wait releases
    the interpreter lock, so the mapping thread runs meanwhile)."""
    import threading

    from orbslam2_dualcam_tpu_torch.utils.device import Readback

    _card()
    x = torch.arange(4096, dtype=torch.float32, device="cuda")
    want = [(x * 3).cpu().numpy(), (x > 100).cpu().numpy()]
    torch.cuda._sleep(int(2e8))
    rb = Readback([x * 3, x > 100])
    torch.cuda._sleep(int(1e9))
    count, stop = [0], [False]

    def spin():
        while not stop[0]:
            count[0] += 1

    th = threading.Thread(target=spin, daemon=True)
    th.start()
    c0 = count[0]
    got = rb.wait()
    c1 = count[0]
    busy = not torch.cuda.current_stream().query()
    stop[0] = True
    th.join()
    torch.cuda.synchronize()
    assert busy, "wait() waited for the sleep queued after the readback"
    assert c1 - c0 > 1000
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert rb.wait() is got
