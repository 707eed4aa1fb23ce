"""The fused dual-camera tracking step as a whole: a chain of frames through
the port's make_track_fn against the JAX reference's, each side chaining
its own pose, velocity and matched slots."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu.ops import camera as jcam
from orbslam2_dualcam_tpu.pipeline import frontend as jfe
from orbslam2_dualcam_tpu.utils import synthetic as jsyn
from orbslam2_dualcam_tpu.utils.config import (CameraConfig, OrbConfig,
                                               SystemConfig)
from orbslam2_dualcam_tpu.vocab import bow as jbow
from orbslam2_dualcam_tpu_torch.pipeline import frontend as tfe
from orbslam2_dualcam_tpu_torch.utils import synthetic as tsyn
from orbslam2_dualcam_tpu_torch.utils.convert import (desc_to_numpy,
                                                      desc_to_torch,
                                                      rig_from_numpy,
                                                      vocab_from_numpy)

import torch_parity  # noqa: F401  (one torch thread per worker)

torch.set_num_threads(1)

H, W, N_FEATS, CAP, N_FRAMES = 240, 320, 400, 256, 4
_CAM = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=W, height=H)
CFG = SystemConfig(
    cameras=(CameraConfig(**_CAM),
             CameraConfig(**_CAM, q_sc=(0.0, 0.0, 1.0, 0.0), t_sc=(0.0, 0.0, 0.10))),
    orb=OrbConfig(n_levels=4))
# frame 1 sees only this many stage-1 candidates, fewer than
# min_matches_motion (20): the widened 30 px retry decides that frame
N_PREV = 10


def _setup():
    """Rig, vocabulary, frames and a store seeded from frame 0's port
    extraction (on the CPU): the state both packages get."""
    jrig = jcam.make_rig(CFG)
    rng = np.random.default_rng(0)
    jvoc = jbow.train_vocabulary(
        rng.integers(0, 2 ** 32, (2000, 8), dtype=np.uint32), branching=4,
        depth=2, seed=1, direct_level=1)
    world = jsyn.make_box_world(np.random.default_rng(1), half=6.0, tex_size=256)
    poses = jsyn.orbit_trajectory(N_FRAMES + 1, radius=1.5,
                                  total_angle=0.06 * (N_FRAMES + 1))
    K, T_sc = np.asarray(jrig.K), np.asarray(jrig.T_sc)
    frames = [np.clip(np.round(jsyn.render_rig(world, K, T_sc, T, H=H, W=W)),
                      0, 255).astype(np.uint8) for T in poses]
    f = tfe._extract_frame_body(torch.as_tensor(frames[0]), CFG, N_FEATS,
                                vocab_from_numpy(jvoc, "cpu"),
                                rig_from_numpy(jrig, "cpu")).feats
    store = tsyn.seed_store(world, K, T_sc, poses[0], f.uv.cpu().numpy(),
                            f.level.cpu().numpy(), desc_to_numpy(f.desc),
                            f.valid.cpu().numpy(), CFG.orb.scale_factors, CAP)
    slots = store.slots.copy()
    slots[:, N_PREV:] = -1
    return jrig, jvoc, poses, frames, store, slots


def _run_port(device, jrig, jvoc, poses, frames, store, slots):
    step = tfe.make_track_fn(CFG, N_FEATS, vocab_from_numpy(jvoc, device),
                             rig_from_numpy(jrig, device), device)
    mp = (torch.as_tensor(store.pos, device=device),
          desc_to_torch(store.desc, device),
          torch.as_tensor(store.valid, device=device),
          torch.as_tensor(store.max_dist, device=device),
          torch.as_tensor(store.min_dist, device=device),
          torch.as_tensor(store.normal, device=device))
    T = torch.as_tensor(poses[0], dtype=torch.float32, device=device)
    V = torch.eye(4, device=device)
    s = torch.as_tensor(slots, device=device)
    on = torch.ones(2, dtype=torch.bool, device=device)
    outs = []
    for img in frames[1:]:
        _, o = step(torch.as_tensor(img, device=device), T, V, s, on, *mp)
        T, V, s = o.T_cw, o.V_new, o.mp_slots
        outs.append(type(o)(*(x.cpu().numpy() for x in o)))
    return outs


@pytest.fixture(scope="module")
def chains():
    jrig, jvoc, poses, frames, store, slots = _setup()
    step = jfe.make_track_fn(CFG, N_FEATS, jvoc, jrig)
    mp = [jnp.asarray(x) for x in store[:6]]
    T, V = jnp.asarray(poses[0], jnp.float32), jnp.eye(4)
    s = jnp.asarray(slots.astype(np.int32))
    ref = []
    for img in frames[1:]:
        _, o = step(jnp.asarray(img), T, V, s, jnp.ones(2, bool), *mp)
        T, V, s = o.T_cw, o.V_new, o.mp_slots
        ref.append(type(o)(*(np.asarray(x) for x in jax.device_get(o))))
    return ref, _run_port("cpu", jrig, jvoc, poses, frames, store, slots), poses


def test_chain_takes_both_stage1_branches(chains):
    """Frame 1 has fewer stage-1 inliers than min_matches_motion, so the
    reference takes its widened-retry branch; later frames do not."""
    ref, ours, _ = chains
    assert int(ref[0].n_stage1) < CFG.tracker.min_matches_motion
    assert all(int(r.n_stage1) >= CFG.tracker.min_matches_motion for r in ref[1:])
    for r, o in zip(ref, ours):
        assert abs(int(r.n_stage1) - int(o.n_stage1)) <= max(3, 0.03 * int(r.n_stage1))


def test_chain_pose_matches_reference(chains):
    """T_cw to 1e-3 per frame (measured <= 4.5e-4 on this chain: a few
    keypoints of the upper pyramid levels differ by float rounding, which
    moves the optimum slightly); both stay near ground truth."""
    ref, ours, poses = chains
    for k, (r, o) in enumerate(zip(ref, ours), start=1):
        np.testing.assert_allclose(o.T_cw, r.T_cw, rtol=0, atol=1e-3,
                                   err_msg=f"frame {k}")
        assert np.abs(o.T_cw - poses[k]).max() < 1e-2
        np.testing.assert_allclose(o.V_new, r.V_new, rtol=0, atol=2e-3)


def test_chain_matches_agree(chains):
    """n_final within max(3, 3%) and >= 95% of mp_slots equal per frame
    (measured: n_final within 2, slots >= 99.75% equal)."""
    ref, ours, _ = chains
    for k, (r, o) in enumerate(zip(ref, ours), start=1):
        n = int(r.n_final)
        assert n > 100, (k, n)
        assert abs(int(o.n_final) - n) <= max(3, 0.03 * n), (k, n, int(o.n_final))
        assert (o.mp_slots == r.mp_slots).mean() >= 0.95, k

