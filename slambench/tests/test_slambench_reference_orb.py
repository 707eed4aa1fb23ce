"""The plain extractor of the benchmark gives what the port's extractor
gives on the CPU, slot by slot, and the bfloat16 control does not."""

import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu_torch.ops import camera, orb
from orbslam2_dualcam_tpu_torch.utils.config import OrbConfig
from slambench import generator
from slambench.reference import orb as ref_orb

K = np.array([[258.65, 0, 159.32], [0, 258.23, 127.66], [0, 0, 1.0]])
DIST = np.array([0.262383, -0.953104, -0.005358, 0.002628, 1.163314])


@pytest.fixture(scope="module")
def frames():
    gen = torch.Generator().manual_seed(11)
    room = generator.make_room(gen, "cpu", tex_size=256)
    rig = generator.Rig(np.stack([K, K]), np.stack([DIST, np.zeros(5)]),
                        np.stack([np.eye(4), np.eye(4)]), 240, 320, "cpu")
    return rig.render_u8(room, [generator.orbit_pose(1.5, 0.7)])[0]


def port_keypoints(img_u8, n):
    cfg = OrbConfig(n_features=400)
    f = orb.extract_orb_rig(torch.as_tensor(img_u8).to(torch.float32), cfg, n)
    Kt = torch.as_tensor(np.stack([K, K]), dtype=torch.float32)
    d = torch.as_tensor(np.stack([DIST, np.zeros(5)]), dtype=torch.float32)
    Kinv = torch.linalg.inv(Kt)
    xn = f.uv @ Kinv[:, :2, :2].transpose(-1, -2) + Kinv[:, None, :2, 2]
    xu = camera.undistort(xn, d[:, None, :])
    uv = xu @ Kt[:, :2, :2].transpose(-1, -2) + Kt[:, None, :2, 2]
    return ref_orb.Keypoints(uv=uv.numpy().astype(np.float64), level=f.level.numpy(),
                             desc=f.desc.numpy().view(np.uint32), valid=f.valid.numpy())


def test_reference_matches_port(frames):
    img = torch.as_tensor(frames)
    prog = port_keypoints(frames, 520)
    ref = ref_orb.extract(img, ref_orb.OrbParams(), 520, np.stack([K, K]),
                          np.stack([DIST, np.zeros(5)]))
    assert prog.valid.sum() > 500
    mismatch, bits = ref_orb.compare(prog, ref)
    assert mismatch == 0.0 and bits == 0.0


def test_bfloat16_control_fails(frames):
    img = torch.as_tensor(frames)
    Ks, ds = np.stack([K, K]), np.stack([DIST, np.zeros(5)])
    ref = ref_orb.extract(img, ref_orb.OrbParams(), 520, Ks, ds)
    ctl = ref_orb.extract(img, ref_orb.OrbParams(), 520, Ks, ds, dtype=torch.bfloat16)
    mismatch, _ = ref_orb.compare(ctl, ref)
    assert mismatch > 0.3


def test_compare_counts_slots_and_bits():
    uv = np.zeros((1, 4, 2))
    a = ref_orb.Keypoints(uv=uv, level=np.zeros((1, 4), np.int64),
                          desc=np.zeros((1, 4, 8), np.uint32), valid=np.ones((1, 4), bool))
    b = a._replace(uv=uv + np.array([0, 0, 0, 1.0])[None, :, None],
                   desc=a.desc.copy())
    b.desc[0, 0, 0] = 3
    mismatch, bits = ref_orb.compare(a, b)
    assert mismatch == pytest.approx(0.25)
    assert bits == pytest.approx(2 / (3 * 256))
