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
