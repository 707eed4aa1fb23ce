"""The benchmark's device renderer renders what the port's numpy renderer
(utils/synthetic.py) renders, on the same room and pose."""

import numpy as np
import torch

from orbslam2_dualcam_tpu_torch.utils import synthetic
from slambench import generator


def _room(seed=5, tex=64):
    gen = torch.Generator().manual_seed(seed)
    return generator.make_room(gen, "cpu", half=6.0, height=3.0, tex_size=tex)


def _world(room):
    e1, e2 = room.e1.numpy(), room.e2.numpy()
    T = room.textures.shape[-1]
    return synthetic.World(
        half=room.half, height=room.height, origins=room.origins.numpy(), e1=e1, e2=e2,
        normals=room.normals.numpy(), offsets=room.offsets.numpy(),
        textures=[t.numpy() for t in room.textures],
        tex_scale=np.stack([[T / np.linalg.norm(e1[i]), T / np.linalg.norm(e2[i])]
                            for i in range(6)]))


def test_render_matches_port_renderer():
    room = _room()
    K = np.array([[100.0, 0, 40.0], [0, 100.0, 30.0], [0, 0, 1]])
    T_sc = np.stack([np.eye(4), np.eye(4)])
    T_sc[1, :3, :3] = np.diag([-1.0, 1.0, -1.0])
    T_sc[1, 2, 3] = 0.1
    rig = generator.Rig(np.stack([K, K]), np.zeros((2, 5)), T_sc, 60, 80, "cpu")
    for a in (0.3, 2.0):
        T = generator.orbit_pose(1.5, a)
        ours = rig.render(room, T).numpy()
        theirs = synthetic.render_rig(_world(room), np.stack([K, K]), T_sc, T, H=60, W=80)
        assert np.abs(ours - theirs).max() < 1e-3


def test_orbit_matches_port_orbit():
    ours = generator.orbit_path(1.5, 0.0, 2 * np.pi / 12, 12)
    theirs = synthetic.orbit_trajectory(12, radius=1.5)
    assert np.allclose(np.stack(ours), np.stack(theirs), atol=1e-12)


def test_ray_table_inverts_distortion():
    K = np.array([[517.3, 0, 318.6], [0, 516.5, 255.3], [0, 0, 1]])
    dist = (0.262383, -0.953104, -0.005358, 0.002628, 1.163314)
    rays = generator.ray_table(K, dist, 48, 64, "cpu").numpy()
    x, y = rays[:, 0], rays[:, 1]
    k1, k2, p1, p2, k3 = dist
    r2 = x * x + y * y
    rad = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    v, u = np.mgrid[0:48, 0:64]
    assert np.abs(K[0, 0] * xd + K[0, 2] - u.ravel()).max() < 1e-6
    assert np.abs(K[1, 1] * yd + K[1, 2] - v.ravel()).max() < 1e-6


def test_textures_are_seeded():
    a, b, c = _room(1).textures, _room(1).textures, _room(2).textures
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert 24.9 <= float(a.min()) and float(a.max()) <= 230.1
    assert float(a.std()) > 10.0


def test_back_and_forth_turns_at_the_ends():
    poses = generator.back_and_forth(1.4, 0.0, 1.0, 0.25, 9, 0.0)
    centres = [np.linalg.inv(T)[:3, 3] for T in poses]
    angles = [np.arctan2(c[0], -c[2]) for c in centres]
    assert np.allclose(angles, [0, .25, .5, .75, 1, .75, .5, .25, 0], atol=1e-9)
