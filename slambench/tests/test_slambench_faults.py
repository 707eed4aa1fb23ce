"""The comparison that decides `correct`, driven through a whole run of a
cell cut to CPU size with the card check skipped: a sound run is correct,
the bfloat16 control reads over every limit, and each fault planted in the
timed path makes `correct` false through the number that should catch it.

Faults: the tracking step returns its state unchanged (the last pose);
local BA returns its state unchanged; half of each frame's keypoints left
out; an answer altered where it is produced (one descriptor bit, the
published pose)."""

import pytest
import torch

from orbslam2_dualcam_tpu_torch.ops import lie, orb
from orbslam2_dualcam_tpu_torch.optim import ba
from orbslam2_dualcam_tpu_torch.pipeline import frontend
from slambench.tests.small import run_small

SEED = 2**31 + 12345
SECONDS = 20.0


def failed_on(out, name):
    c = out["checks"][name]
    return (not out["correct"]) and c["value"] is not None and c["value"] > c["limit"]


@pytest.fixture(scope="module")
def sound():
    return run_small("mono_tum1.orbit", SEED, SECONDS, control=True)


def test_sound_run_is_correct(sound):
    assert sound["correct"], sound["checks"]


def test_control_reads_over_every_limit(sound):
    ctl = sound["readings"]["control"]
    for name, c in sound["checks"].items():
        assert ctl[name] > c["limit"], (name, ctl[name], c["limit"])


def _wrap_fused(monkeypatch, change):
    """make_track_fn's step with `change(out, args)` applied to its output."""
    real = frontend.make_track_fn

    def make(*a, **k):
        fn = real(*a, **k)

        def step(*args):
            fd, out = fn(*args)
            return fd, change(out, args)
        return step
    monkeypatch.setattr(frontend, "make_track_fn", make)


def test_step_returning_its_state_unchanged(monkeypatch):
    _wrap_fused(monkeypatch, lambda out, args: out._replace(T_cw=args[1]))
    out = run_small("mono_tum1.orbit", SEED, SECONDS)
    assert failed_on(out, "pose_cost_excess"), out["checks"]


def test_local_ba_returning_its_state_unchanged(monkeypatch):
    def unchanged(prob, T_sc, adj_sc, Ks, iters, **kw):
        return ba.solve_ba(prob, T_sc, adj_sc, Ks, iters=0)
    monkeypatch.setattr(ba, "solve_ba_chunked", unchanged)
    out = run_small("mono_tum1.orbit", SEED, SECONDS)
    assert failed_on(out, "ba_shortfall"), out["checks"]


def _wrap_extract(monkeypatch, change):
    real = orb.extract_orb_rig

    def extract(*a, **k):
        return change(real(*a, **k))
    monkeypatch.setattr(orb, "extract_orb_rig", extract)


def test_half_of_the_keypoints_left_out(monkeypatch):
    def half(f):
        valid = f.valid.clone()
        valid[..., 1::2] = False
        return f._replace(valid=valid)
    _wrap_extract(monkeypatch, half)
    out = run_small("mono_tum1.orbit", SEED, SECONDS)
    assert failed_on(out, "kp_mismatch"), out["checks"]


def test_descriptor_bit_altered(monkeypatch):
    def flip(f):
        desc = f.desc.clone()
        desc[..., 3] ^= 1 << 7
        return f._replace(desc=desc)
    _wrap_extract(monkeypatch, flip)
    out = run_small("mono_tum1.orbit", SEED, SECONDS)
    assert failed_on(out, "desc_bits"), out["checks"]


def test_published_pose_altered(monkeypatch):
    nudge = lie.se3_exp(torch.tensor([0.0, 0.0, 0.0, 0.0, 0.002, 0.0]))
    _wrap_fused(monkeypatch, lambda out, args: out._replace(T_cw=nudge @ out.T_cw))
    out = run_small("mono_tum1.orbit", SEED, SECONDS)
    assert failed_on(out, "pose_cost_excess"), out["checks"]


def test_localize_sound_and_batched_step_unchanged(monkeypatch):
    out = run_small("mono_tum1.localize", SEED, SECONDS, control=True)
    assert out["correct"], out["checks"]
    for name, c in out["checks"].items():
        assert out["readings"]["control"][name] > c["limit"], name
    real = frontend.make_track_batch_fn

    def make(*a, **k):
        fn = real(*a, **k)

        def step(images, T_cw, V, slots, *rest):
            carry, fds, outs = fn(images, T_cw, V, slots, *rest)
            T_in = T_cw.expand_as(outs.T_cw)
            return carry, fds, outs._replace(T_cw=T_in)
        return step
    monkeypatch.setattr(frontend, "make_track_batch_fn", make)
    out = run_small("mono_tum1.localize", SEED, SECONDS)
    assert failed_on(out, "pose_cost_excess"), out["checks"]
