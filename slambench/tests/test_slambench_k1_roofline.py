"""The benchmark's copy of K1's roofline arithmetic gives chip_smoke.py's
bound on the same pyramid."""

import numpy as np
import torch

import chip_smoke
from orbslam2_dualcam_tpu_torch.ops import orb
from orbslam2_dualcam_tpu_torch.utils.config import OrbConfig
from slambench import generator
from slambench.reference import k1_roofline
from slambench.reference import orb as ref_orb


def test_bound_matches_chip_smoke():
    gen = torch.Generator().manual_seed(3)
    room = generator.make_room(gen, "cpu", tex_size=128)
    K = np.array([[125.0, 0, 80.0], [0, 125.0, 60.0], [0, 0, 1]])
    rig = generator.Rig(K[None], np.zeros((1, 5)), np.eye(4)[None], 120, 160, "cpu")
    img = torch.as_tensor(rig.render_u8(room, [generator.orbit_pose(1.5, 1.0)])[0])
    cfg = OrbConfig()
    tb = orb._tables(120, 160, cfg, torch.device("cpu"))
    pyr = orb.build_pyramid(img.to(torch.float32), tb.resize)
    ours_levels = k1_roofline.frame_levels(img, ref_orb.OrbParams(), cfg.n_track)
    assert len(ours_levels) == len(pyr)
    for a, b in zip(ours_levels, pyr):
        assert torch.equal(a, b)
    ms, by, share = chip_smoke.k1_bound_ms(pyr)
    n_px, n_arc = k1_roofline.counts(ours_levels, 20.0, 7.0)
    s, by2 = k1_roofline.bound_s(n_px, n_arc)
    assert by == by2
    assert abs(s * 1e3 - ms) <= 1e-12 * ms
    assert n_arc / n_px == share
    assert k1_roofline.OPS_PER_PIXEL == chip_smoke.K1_OPS_PER_PIXEL
    assert k1_roofline.OPS_PER_ARC == chip_smoke.K1_OPS_PER_ARC
    assert k1_roofline.BYTES_PER_PIXEL == chip_smoke.K1_BYTES_PER_PIXEL
