"""The port's examples/eval_tum.py `evaluate` beside the reference's, on one
TUM-layout sequence written to disk here (rgb/*.png, rgb.txt and
groundtruth.txt, read back through cv2 as a downloaded sequence would be),
at the gates of the reference's tests/test_eval_tum.py.  The photograph of
the textured room is a smoothed noise image written here (the reference's
is not in the repository)."""

import os

import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu_torch.examples.eval_tum import evaluate
from orbslam2_dualcam_tpu_torch.utils import datasets, synthetic

pytestmark = pytest.mark.slow

torch.set_num_threads(1)

INTR = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0)


def _write_tum_dir(root, n=45):
    import cv2
    photo = str(root / "photo.png")
    noise = np.random.default_rng(6).normal(0, 1, (480, 640)).astype(np.float32)
    noise = cv2.GaussianBlur(noise, (0, 0), 2.0)
    noise = (noise - noise.min()) / (noise.max() - noise.min()) * 255
    cv2.imwrite(photo, noise.astype(np.uint8))
    K = np.array([[260.0, 0, 160], [0, 260, 120], [0, 0, 1]])
    planes = datasets.photo_room_planes(photo, half=3.0, height=1.8, seed=5,
                                        tex=512)
    poses = synthetic.orbit_trajectory(n, radius=1.2,
                                       total_angle=0.9 * np.pi)
    os.makedirs(root / "rgb", exist_ok=True)
    rgb_lines, gt_lines = [], []
    for i, (img, T) in enumerate(
            datasets.planar_photo_sequence(poses, K, H=240, W=320,
                                           planes=planes)):
        ts = 1305031100.0 + i / 30.0
        name = f"rgb/{ts:.6f}.png"
        cv2.imwrite(str(root / name), img.astype(np.uint8))
        rgb_lines.append(f"{ts:.6f} {name}")
        c = np.linalg.inv(T)[:3, 3]
        gt_lines.append(f"{ts:.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} "
                        f"0 0 0 1")
    (root / "rgb.txt").write_text(
        "# color images\n" + "\n".join(rgb_lines) + "\n")
    (root / "groundtruth.txt").write_text(
        "# ground truth\n" + "\n".join(gt_lines) + "\n")
    return poses


def test_evaluate_on_disk_sequence_beside_reference(tmp_path):
    from examples.eval_tum import evaluate as ref_evaluate

    poses = _write_tum_dir(tmp_path)
    for out in (evaluate(str(tmp_path), intr=INTR, device="cpu"),
                ref_evaluate(str(tmp_path), intr=INTR)):
        assert out["n_frames"] == len(poses)
        assert out["n_tracked"] >= len(poses) - 8, out
        assert out["n_kf"] >= 5, out
        # mono Sim3-aligned ATE on a ~2.4 m-diameter circuit
        assert out["ate_sim3_m"] < 0.25, out
