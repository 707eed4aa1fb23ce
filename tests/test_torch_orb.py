"""ORB extraction: the port's tables and extract_orb_rig against the JAX
reference on identical frames."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu.ops import orb as jorb
from orbslam2_dualcam_tpu.utils.config import OrbConfig
from orbslam2_dualcam_tpu_torch.ops import orb as torb
from orbslam2_dualcam_tpu_torch.ops import orb_tables

from torch_parity import rendered_frame

torch.set_num_threads(1)

CFG = OrbConfig(n_levels=4)
N_FEATS = 400


@pytest.mark.parametrize("name,args", [
    ("FAST_OFFSETS", None),
    ("brief_pattern", (OrbConfig().brief_seed,)),
    ("brief_pattern", (-1,)),
    ("ic_angle_masks", (15,)),
    ("_blur_kernel", ()),
    ("_blur_matrix", (133,)),
    ("_resize_matrix", (480, 400)),
    ("_resize_matrix", (309, 257)),
    ("_steered_sampling_indices", (OrbConfig().brief_seed, 31)),
    ("_level_budget", (1300, 8, 1.2)),
])
def test_tables_equal_reference(name, args):
    ours, ref = getattr(orb_tables, name), getattr(jorb, name)
    if args is not None:
        ours, ref = ours(*args), ref(*args)
    if not isinstance(ref, tuple):
        ours, ref = (ours,), (ref,)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def both():
    imgs = np.stack([rendered_frame(0), rendered_frame(1)])   # u8-valued
    jf = jax.jit(lambda im: jorb.extract_orb_rig(im, CFG, N_FEATS))(
        jnp.asarray(imgs))
    tf = torb.extract_orb_rig(torch.as_tensor(imgs), CFG, N_FEATS)
    jf = type(jf)(*(np.asarray(x) for x in jf))
    tf = type(tf)(*(x.numpy() for x in tf))
    return imgs, jf, tf


def test_pyramid_matches_reference(both):
    """The port resizes with the host-built _resize_matrix.  Against the
    same product on the reference side the levels agree to 1e-3.  The
    reference's jitted pyramid builds its matrices on the device
    (_resize_matrix_dev), whose weights differ from the host table's by up
    to 2.2e-5 (measured at 320 -> 267), so against it the levels agree to
    1e-2 (measured 3.4e-3) on [0, 255] images."""
    imgs = both[0]
    ours = torb.build_pyramid(
        torch.as_tensor(imgs),
        torb._tables(*imgs.shape[1:], CFG, torch.device("cpu")).resize)
    shapes = torb.level_shapes(*imgs.shape[1:], 4, 1.2)
    host = [imgs]
    for (hp, wp), (h, w) in zip(shapes[:-1], shapes[1:]):
        host.append(jorb._resize_matrix(hp, h) @ host[-1]
                    @ jorb._resize_matrix(wp, w).T)
    dev = jax.vmap(lambda im: jorb.build_pyramid(im, 4, 1.2))(jnp.asarray(imgs))
    for o, h, d in zip(ours, host, dev):
        np.testing.assert_allclose(o.numpy(), h, rtol=0, atol=1e-3)
        np.testing.assert_allclose(o.numpy(), np.asarray(d), rtol=0, atol=1e-2)


def test_level0_keypoints_exact(both):
    """Level 0 on u8-valued frames: integer FAST scores, so the keypoint
    choice, order and response are exact."""
    _, jf, tf = both
    assert np.array_equal(jf.level, tf.level)
    m = jf.level == 0
    assert m.sum() > 200
    np.testing.assert_array_equal(tf.response[m], jf.response[m])
    np.testing.assert_allclose(tf.uv[m], jf.uv[m], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tf.valid, jf.valid)


def test_all_levels_agreement(both):
    """Over all levels >= 97% of keypoints agree (same level, position
    within 1e-3 px, response within 0.02: upper-level scores carry the
    +1e4 blend bonus, whose f32 ulp is ~1e-3).  Measured: 100% on this
    pair.  On agreeing keypoints the angle agrees to 1e-4 (measured 1.0e-5)
    and >= 99% of descriptor bits are equal (measured 99.97%: the blurred
    intensities differ by float rounding, which flips the comparison of
    near-equal sample pairs)."""
    _, jf, tf = both
    agree = ((jf.level == tf.level) &
             (np.abs(jf.uv - tf.uv).max(-1) < 1e-3) &
             (np.abs(jf.response - tf.response) < 0.02))
    assert agree.mean() >= 0.97, agree.mean()
    np.testing.assert_allclose(tf.angle[agree], jf.angle[agree], rtol=0,
                               atol=1e-4)
    diff = np.unpackbits((jf.desc ^ tf.desc.view(np.uint32)).view(np.uint8),
                         axis=-1).sum(-1)
    assert 1.0 - diff[agree].sum() / (agree.sum() * 256) >= 0.99


def test_extract_orb_single_image_is_rig_camera(both):
    """extract_orb on one (H, W) image is extract_orb_rig's camera, up to
    the order of the CPU's vectorized sums (measured: 1 ulp on 6 of 400
    angles)."""
    imgs, _, tf = both
    one = torb.extract_orb(torch.as_tensor(imgs[1]), CFG, N_FEATS)
    for name, x in zip(one._fields, one):
        np.testing.assert_allclose(x.numpy(), getattr(tf, name)[1], rtol=0,
                                   atol=1e-6, err_msg=name)
