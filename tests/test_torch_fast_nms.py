"""Kernel K1 (fused FAST + blend + 3x3 NMS): the port's plain torch version
against the reference's Pallas kernel (interpret mode) and its XLA
composition.  The CUDA kernel's own test is in test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu.ops import orb as jorb
from orbslam2_dualcam_tpu.ops.pallas_kernels import fast_nms_pallas
from orbslam2_dualcam_tpu_torch.ops import fast_nms as k1

from torch_parity import rendered_frame

torch.set_num_threads(1)


def _inputs(kind):
    if kind == "rendered":
        return rendered_frame(0, 240, 320), 20.0, 7.0
    rng = np.random.default_rng(1)
    return rng.uniform(0, 255, (100, 150)).astype(np.float32), 12.0, 5.0


@pytest.mark.parametrize("kind", ["rendered", "random_non_aligned"])
def test_fast_nms_reference_matches_jax(kind):
    """Exact on the u8-valued rendered frame (every sum is of small
    integers); atol 1e-3 on random floats, where the XLA composition sums
    the 16 circle terms in another order."""
    img, th_hi, th_lo = _inputs(kind)
    s, sad = (x.numpy() for x in k1.fast_nms_reference(torch.as_tensor(img),
                                                        th_hi, th_lo))
    ps, psad = (np.asarray(x) for x in fast_nms_pallas(jnp.asarray(img), th_hi,
                                                       th_lo, interpret=True))
    s_hi, s_lo, xsad = jorb.fast_scores2(jnp.asarray(img), th_hi, th_lo)
    xs = np.asarray(jorb.nms3x3(jnp.where(s_hi > 0, s_hi + 1e4, s_lo)))
    atol = 0.0 if kind == "rendered" else 1e-3
    for ref_s, ref_sad in ((ps, psad), (xs, np.asarray(xsad))):
        np.testing.assert_allclose(s, ref_s, rtol=0, atol=atol)
        np.testing.assert_allclose(sad, ref_sad, rtol=0, atol=atol)
    assert (s > 1e4).sum() > 0 and (s > 0).sum() > 100


def test_fast_nms_cpu_wrapper_batches_cameras():
    """On a CPU tensor the wrapper is the plain version, and a [ncam, H, W]
    batch equals the cameras run one by one; no kernel launch is counted."""
    a = rendered_frame(0, 96, 128)
    b = np.ascontiguousarray(a[::-1])
    before = k1.fast_nms.launches
    s, sad = k1.fast_nms(torch.as_tensor(np.stack([a, b])), 20.0, 7.0)
    assert k1.fast_nms.launches == before
    for c, img in enumerate((a, b)):
        s1, sad1 = k1.fast_nms_reference(torch.as_tensor(img), 20.0, 7.0)
        assert torch.equal(s[c], s1) and torch.equal(sad[c], sad1)



def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor that is not on the CPU launches the kernel or raises: on a
    device the kernel does not serve, the wrapper raises."""
    with pytest.raises(ValueError, match="unsupported device"):
        k1.fast_nms(torch.empty(2, 16, 16, device="meta"), 20.0, 7.0)


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    """With no library built and no nvcc anywhere, building the kernels
    raises with a message that names the missing compiler."""
    from orbslam2_dualcam_tpu_torch import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.os.path, "isfile", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
