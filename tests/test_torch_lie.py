"""ops/lie.py: every function the port gained against the JAX reference
on the same float32 numpy inputs, at angles 0, 1e-8, pi - 1e-4 and random.

Tolerance: 1e-5 absolute on float32 values of order 1 (the two packages
call different sin/cos/acos/log implementations, a few ulp apart); near pi
so3_log amplifies one ulp of the trace by 1/sin(theta) = 1e4, so there the
bound is 2e-3 on the angle-axis vector, and the rotation it maps back to
is held to 1e-5."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu.ops import lie as jl
from orbslam2_dualcam_tpu_torch.ops import lie as tl

torch.set_num_threads(1)

ATOL = 1e-5
ANGLES = {"zero": 0.0, "tiny": 1e-8, "near_pi": math.pi - 1e-4,
          "random_a": 0.7316, "random_b": 2.413}


def _axis(seed):
    a = np.random.default_rng(seed).normal(size=3)
    return a / np.linalg.norm(a)


def _rot(angle, seed=0):
    """Rodrigues in float64, rounded to float32."""
    n = _axis(seed)
    K = np.array([[0, -n[2], n[1]], [n[2], 0, -n[0]], [-n[1], n[0], 0]])
    R = np.eye(3) + math.sin(angle) * K + (1 - math.cos(angle)) * (K @ K)
    return R.astype(np.float32)


def _both(name, *args):
    """(port result, reference result) as numpy (tuples flattened)."""
    t = getattr(tl, name)(*(torch.as_tensor(np.array(a)) for a in args))
    j = getattr(jl, name)(*(jnp.asarray(a) for a in args))
    if isinstance(t, tuple):
        return [x.numpy() for x in t], [np.asarray(x) for x in j]
    return [t.numpy()], [np.asarray(j)]


def _assert_close(ours, ref, atol=ATOL):
    for o, r in zip(ours, ref):
        assert o.dtype == np.float32 and np.isfinite(o).all()
        np.testing.assert_allclose(o, r, rtol=0, atol=atol)


@pytest.mark.parametrize("which", list(ANGLES))
def test_so3_log(which):
    angle = ANGLES[which]
    R = _rot(angle, seed=3)
    ours, ref = _both("so3_log", R)
    _assert_close(ours, ref, atol=2e-3 if which == "near_pi" else ATOL)
    # the principal-branch vector has the rotation's angle and maps back
    assert abs(np.linalg.norm(ours[0]) - angle) < 2e-3
    # (near pi the reference's diagonal-based axis is good to ~5e-4)
    back = tl.so3_exp(torch.as_tensor(ours[0])).numpy()
    np.testing.assert_allclose(back, R, rtol=0,
                               atol=1e-3 if which == "near_pi" else ATOL)


@pytest.mark.parametrize("which", list(ANGLES))
def test_quaternions(which):
    R = _rot(ANGLES[which], seed=4)
    q_ours, q_ref = _both("rot_to_quat", R)
    # near pi qw ~ 5e-5 is a square root of a clipped difference: 1e-4 there
    _assert_close(q_ours, q_ref, atol=1e-4 if which == "near_pi" else ATOL)
    _assert_close(*_both("quat_to_rot", q_ref[0]))
    # back to R: the reference clips each squared component at 1e-8, so a
    # zero component reads 5e-5 and the matrix is off by up to 2e-4
    np.testing.assert_allclose(
        tl.quat_to_rot(torch.as_tensor(q_ours[0])).numpy(), R, rtol=0, atol=3e-4)
    # an unnormalized quaternion is normalized first
    _assert_close(*_both("quat_to_rot", (3.0 * q_ref[0]).astype(np.float32)))


@pytest.mark.parametrize("which", list(ANGLES))
def test_se3_log_and_round_trip(which):
    rng = np.random.default_rng(5)
    phi = (ANGLES[which] * _axis(6)).astype(np.float32)
    xi = np.concatenate([rng.normal(size=3), phi]).astype(np.float32)
    T = np.array(jl.se3_exp(jnp.asarray(xi)))
    near_pi = which == "near_pi"
    _assert_close(*_both("se3_log", T), atol=5e-3 if near_pi else ATOL)
    # exp(log(T)) == T in the port alone, and log(exp(xi)) == xi away
    # from pi (there the reference's sign anchor may return the opposite
    # axis, a rotation 2e-4 away)
    again = tl.se3_exp(tl.se3_log(torch.as_tensor(T))).numpy()
    np.testing.assert_allclose(again, T, rtol=0, atol=1e-3 if near_pi else 2e-5)
    if not near_pi:
        back = tl.se3_log(tl.se3_exp(torch.as_tensor(xi)))
        np.testing.assert_allclose(back.numpy(), xi, rtol=0, atol=2e-5)


def test_apply_points():
    rng = np.random.default_rng(7)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = _rot(1.1, seed=8), rng.normal(size=3)
    x = rng.normal(size=(5, 7, 3)).astype(np.float32)
    _assert_close(*_both("se3_apply", T, x))
    S = T.copy()
    S[:3, :3] *= 1.7
    _assert_close(*_both("sim3_apply", S, x))


@pytest.mark.parametrize("scale", [0.4, 1.0, 2.5])
def test_sim3_pack_parts_inv(scale):
    rng = np.random.default_rng(9)
    R, t = _rot(0.9, seed=10), rng.normal(size=3).astype(np.float32)
    s = np.float32(scale)
    S_ours, S_ref = _both("sim3", R, t, s)
    _assert_close(S_ours, S_ref)
    _assert_close(*_both("sim3_parts", S_ref[0]))
    _assert_close(*_both("sim3_inv", S_ref[0]))
    both = tl.sim3_inv(torch.as_tensor(S_ref[0])).numpy() @ S_ref[0]
    np.testing.assert_allclose(both, np.eye(4), rtol=0, atol=2e-5)


# every branch of sim3_exp: series and closed form in sigma and in theta
_SIGMAS = {"sigma_zero": 0.0, "sigma_tiny": 5e-5, "sigma_neg": -0.6,
           "sigma_pos": 0.8}


@pytest.mark.parametrize("which_sigma", list(_SIGMAS))
@pytest.mark.parametrize("which", list(ANGLES))
def test_sim3_exp_log(which, which_sigma):
    rng = np.random.default_rng(11)
    phi = ANGLES[which] * _axis(12)
    xi = np.concatenate([rng.normal(size=3), phi,
                         [_SIGMAS[which_sigma]]]).astype(np.float32)
    S_ours, S_ref = _both("sim3_exp", xi)
    _assert_close(S_ours, S_ref, atol=2e-5)
    near_pi = which == "near_pi"
    _assert_close(*_both("sim3_log", S_ref[0]), atol=5e-3 if near_pi else 2e-5)
    if not near_pi:
        back = tl.sim3_log(torch.as_tensor(S_ours[0])).numpy()
        np.testing.assert_allclose(back, xi, rtol=0, atol=5e-5)


@pytest.mark.parametrize("name,arg", [
    ("so3_log", np.eye(3, dtype=np.float32)),
    ("so3_log", np.diag([1.0, -1.0, -1.0]).astype(np.float32)),
    ("so3_log", np.diag([-1.0, -1.0, 1.0]).astype(np.float32)),
    ("se3_log", np.eye(4, dtype=np.float32)),
    ("sim3_log", np.eye(4, dtype=np.float32)),
    ("sim3_exp", np.zeros(7, np.float32)),
    ("sim3_exp", np.array([1, 2, 3, 1e-8, 0, 0, 0], np.float32)),
    ("sim3_exp", np.array([1, 2, 3, 0, 0, 0, 1e-5], np.float32)),
    ("rot_to_quat", np.diag([-1.0, 1.0, -1.0]).astype(np.float32)),
])
def test_branch_points_are_finite_and_equal(name, arg):
    """Exactly at the identity, at a rotation by pi and at zero tangents,
    where one side of a select divides by ~0, the result is finite and the
    reference's."""
    _assert_close(*_both(name, arg.copy()))
