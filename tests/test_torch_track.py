"""The fused dual-camera tracking step as a whole: a chain of frames through
the port's make_track_fn against the JAX reference's, each side chaining
its own pose, velocity and matched slots; and the batched entry point
make_track_batch_fn against the reference's and against the port's own
one-by-one run.  Both packages run from one config: the port's is the
reference's through config_from_reference."""

import functools

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
from orbslam2_dualcam_tpu_torch.utils.convert import (config_from_reference,
                                                      desc_to_numpy,
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
TCFG = config_from_reference(CFG)
DEPTH = 3
# frame 1 sees only this many stage-1 candidates, fewer than
# min_matches_motion (20): the widened 30 px retry decides that frame
N_PREV = 10


@functools.lru_cache(maxsize=1)
def _setup():
    """Rig, vocabulary, frames and a store seeded from frame 0's port
    extraction (on the CPU): the state both packages get (made once per
    worker; no test writes into it)."""
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
    f = tfe._extract_frame_body(torch.as_tensor(frames[0]), TCFG, N_FEATS,
                                vocab_from_numpy(jvoc, "cpu"),
                                rig_from_numpy(jrig, "cpu")).feats
    store = tsyn.seed_store(world, K, T_sc, poses[0], f.uv.cpu().numpy(),
                            f.level.cpu().numpy(), desc_to_numpy(f.desc),
                            f.valid.cpu().numpy(), CFG.orb.scale_factors, CAP)
    slots = store.slots.copy()
    slots[:, N_PREV:] = -1
    return jrig, jvoc, poses, frames, store, slots


def _port_state(device, poses, store, slots):
    """(T, V, slots, cam_enabled, *map store) as the port's step takes them."""
    return (torch.as_tensor(poses[0], dtype=torch.float32, device=device),
            torch.eye(4, device=device),
            torch.as_tensor(slots, device=device),
            torch.ones(2, dtype=torch.bool, device=device),
            torch.as_tensor(store.pos, device=device),
            desc_to_torch(store.desc, device),
            torch.as_tensor(store.valid, device=device),
            torch.as_tensor(store.max_dist, device=device),
            torch.as_tensor(store.min_dist, device=device),
            torch.as_tensor(store.normal, device=device))


def _run_port(device, jrig, jvoc, poses, frames, store, slots):
    step = tfe.make_track_fn(TCFG, N_FEATS, vocab_from_numpy(jvoc, device),
                             rig_from_numpy(jrig, device), device)
    T, V, s, on, *mp = _port_state(device, poses, store, slots)
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


@pytest.fixture(scope="module")
def batches():
    """Frames 1..DEPTH through both packages' make_track_batch_fn."""
    jrig, jvoc, poses, frames, store, slots = _setup()
    stack = np.stack(frames[1:1 + DEPTH])
    jbatch = jfe.make_track_batch_fn(CFG, N_FEATS, jvoc, jrig, DEPTH)
    ref = jax.device_get(jbatch(
        jnp.asarray(stack), jnp.asarray(poses[0], jnp.float32), jnp.eye(4),
        jnp.asarray(slots.astype(np.int32)), jnp.ones(2, bool),
        *(jnp.asarray(x) for x in store[:6])))
    tbatch = tfe.make_track_batch_fn(TCFG, N_FEATS, vocab_from_numpy(jvoc, "cpu"),
                                     rig_from_numpy(jrig, "cpu"), DEPTH, "cpu")
    ours = tbatch(torch.as_tensor(stack), *_port_state("cpu", poses, store, slots))
    one_by_one = _run_port("cpu", jrig, jvoc, poses, frames[:1 + DEPTH], store, slots)
    return ref, ours, one_by_one, poses


def test_batch_has_leading_axis_on_every_leaf(batches):
    """(carry, fds, outs) with the reference's structure: every leaf of fds
    and outs has the reference's shape, leading axis DEPTH included, and
    the carry is the last frame's (T_cw, V_new, mp_slots)."""
    ref, (carry, fds, outs), _, _ = batches
    rcarry, rfds, routs = ref
    assert type(fds).__name__ == "FrameData" and type(outs).__name__ == "FusedTrackOut"
    for o, r in zip(list(fds.feats) + [fds.words, fds.nodes] + list(outs),
                    list(rfds.feats) + [rfds.words, rfds.nodes] + list(routs)):
        assert tuple(o.shape) == np.asarray(r).shape and o.shape[0] == DEPTH
    for c, last, r in zip(carry, (outs.T_cw, outs.V_new, outs.mp_slots), rcarry):
        assert torch.equal(c, last[-1]) and tuple(c.shape) == np.asarray(r).shape


def test_batch_equals_one_by_one(batches):
    """The batch chains the same step on the same carries: every output of
    every frame equals the one-by-one run exactly."""
    _, (_, _, outs), one_by_one, _ = batches
    assert len(one_by_one) == DEPTH
    for k, single in enumerate(one_by_one):
        for name, stacked, leaf in zip(outs._fields, outs, single):
            np.testing.assert_array_equal(stacked[k].numpy(), leaf,
                                          err_msg=f"frame {k + 1} {name}")


def test_batch_matches_reference(batches):
    """Against the reference's lax.scan batch at the chain test's
    tolerances: T_cw to 1e-3, V_new to 2e-3, n_final within max(3, 3%),
    >= 95% of mp_slots equal, per frame; the final carry likewise."""
    (rcarry, _, routs), (carry, _, outs), _, poses = batches
    for k in range(DEPTH):
        np.testing.assert_allclose(outs.T_cw[k].numpy(), routs.T_cw[k], rtol=0,
                                   atol=1e-3, err_msg=f"frame {k + 1}")
        assert np.abs(outs.T_cw[k].numpy() - poses[k + 1]).max() < 1e-2
        np.testing.assert_allclose(outs.V_new[k].numpy(), routs.V_new[k],
                                   rtol=0, atol=2e-3)
        n = int(routs.n_final[k])
        assert n > 100 and abs(int(outs.n_final[k]) - n) <= max(3, 0.03 * n)
        assert (outs.mp_slots[k].numpy() == routs.mp_slots[k]).mean() >= 0.95
    np.testing.assert_allclose(carry[0].numpy(), rcarry[0], rtol=0, atol=1e-3)
    np.testing.assert_allclose(carry[1].numpy(), rcarry[1], rtol=0, atol=2e-3)
    assert (carry[2].numpy() == rcarry[2]).mean() >= 0.95


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for t in tree for x in _leaves(t)]


def test_step_on_the_cpu_is_its_body():
    """On the CPU the GraphedStep runs its body: the one-frame step and a
    depth-2 batch return exactly the unwrapped bodies' outputs, in the same
    structure; every call counts as eager, and nothing is captured or
    replayed."""
    jrig, jvoc, poses, frames, store, slots = _setup()
    args = (TCFG, N_FEATS, vocab_from_numpy(jvoc, "cpu"),
            rig_from_numpy(jrig, "cpu"))
    state = _port_state("cpu", poses, store, slots)
    step = tfe.make_track_fn(*args, "cpu")
    batch = tfe.make_track_batch_fn(*args, 2, "cpu")
    assert isinstance(step, tfe.GraphedStep) and isinstance(batch, tfe.GraphedStep)
    for fn, body, images in (
            (step, step.body, frames[1]),
            (batch, batch.body, np.stack(frames[1:3]))):
        x = torch.as_tensor(images)
        got, want = fn(x, *state), body(x, *state)
        assert [type(t) for t in got] == [type(t) for t in want]
        assert len(_leaves(got)) == len(_leaves(want))
        for a, b in zip(_leaves(got), _leaves(want)):
            assert torch.equal(a, b)
        assert (fn.eager, fn.captures, fn.replays) == (1, 0, 0)
        assert fn.failures == []


def test_batch_checks_depth_and_device():
    """Another number of frames than the batch was built for raises; with
    no device named and no card, building an entry point raises instead of
    falling back to the CPU."""
    jrig = jcam.make_rig(CFG)
    rig = rig_from_numpy(jrig, "cpu")
    with pytest.raises(ValueError, match="depth"):
        tfe.make_track_batch_fn(TCFG, N_FEATS, None, rig, 0, "cpu")
    batch = tfe.make_track_batch_fn(TCFG, N_FEATS, None, rig, 2, "cpu")
    with pytest.raises(ValueError, match="built for depth 2"):
        batch(torch.zeros(3, 2, H, W), *([None] * 10))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfe.make_track_fn(TCFG, N_FEATS, None, rig)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfe.make_track_batch_fn(TCFG, N_FEATS, None, rig, 2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rig_from_numpy(jrig)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            desc_to_torch(np.zeros((4, 8), np.uint32))
