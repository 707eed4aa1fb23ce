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
    # the unfused FAST path is not offered on the card
    with pytest.raises(ValueError):
        extract_orb_rig(x, OrbConfig(n_levels=2, pallas_fast=False), 100)
    assert k1.fast_nms.launches == n0


@pytest.mark.gpu
def test_track_chain_on_card_matches_cpu():
    """The fused step on the card against the port on the CPU, over a
    4-frame rendered chain at 2 x 240 x 320: K1 launches once per level
    per frame, poses agree to 1e-3, n_final within max(3, 3%), >= 95% of
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
        bow.train_vocabulary(voc_np, branching=4, depth=2, seed=1, direct_level=1),
        rig_cpu).feats
    st = synthetic.seed_store(world, K, T_sc, poses[0], f.uv.numpy(),
                              f.level.numpy(), desc_to_numpy(f.desc),
                              f.valid.numpy(), cfg.orb.scale_factors, CAP)

    def run(device):
        voc = bow.train_vocabulary(voc_np, branching=4, depth=2, seed=1,
                                   direct_level=1, device=device)
        step = frontend.make_track_fn(cfg, NF, voc, make_rig(cfg, device), device)
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
            outs.append([x.cpu().numpy() for x in o])
        return outs

    cpu = run("cpu")
    n0 = k1.fast_nms.launches
    card = run("cuda")
    assert k1.fast_nms.launches - n0 == cfg.orb.n_levels * (len(frames) - 1)
    for c, g in zip(cpu, card):
        np.testing.assert_allclose(g[0], c[0], rtol=0, atol=1e-3)
        assert abs(int(g[4]) - int(c[4])) <= max(3, 0.03 * int(c[4]))
        assert (g[2] == c[2]).mean() >= 0.95
