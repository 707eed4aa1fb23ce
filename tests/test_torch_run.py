"""The port's video CLI, `python -m orbslam2_dualcam_tpu_torch.run`, on the
CPU: tests/test_cli.py's synthetic MJPG video of the box room through
`run.main` in-process (the artifacts, a line per tracked frame, a Sim3 ATE
band against the orbit), the same with a tiny DBoW2 .bin vocabulary, the
frame loop's split of joint frames, and the device rule: without a CUDA
device and without --cpu the CLI exits non-zero and tracks nothing.

The ATE band is 10% of the orbit's 1.53 m path: the reference's CLI ends at
0.122 m on this video, the port's at about 0.125 m (CPU runs)."""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu_torch import run
from orbslam2_dualcam_tpu_torch.utils import checkpoint, metrics, synthetic

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 16
PATH_LEN = 1.53       # metres of the 16-frame orbit, 0.4 pi at 1.5 m

RIG_YAML = """%YAML:1.0
nCameras: 1
Camera0.fx: 130.0
Camera0.fy: 130.0
Camera0.cx: 80.0
Camera0.cy: 60.0
Camera.width: 160
Camera.height: 120
Camera.fps: 30.0
Camera.RGB: 1
ORBextractor.nFeatures: 200
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 3
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def _poses():
    return synthetic.orbit_trajectory(N_FRAMES, radius=1.5,
                                      total_angle=0.4 * np.pi)


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """A 16-frame 160x120 MJPG video of the box room (tests/test_cli.py's)
    and its settings file."""
    import cv2

    d = tmp_path_factory.mktemp("video")
    world = synthetic.make_box_world(np.random.default_rng(0), half=6.0,
                                     tex_size=256)
    K = np.array([[130.0, 0, 80], [0, 130, 60], [0, 0, 1]])
    vid = str(d / "seq.avi")
    wr = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"MJPG"), 30, (160, 120))
    for T in _poses():
        img = synthetic.render(world, K, T, H=120, W=160).astype(np.uint8)
        wr.write(cv2.cvtColor(img, cv2.COLOR_GRAY2BGR))
    wr.release()
    yaml = d / "rig.yaml"
    yaml.write_text(RIG_YAML)
    return vid, str(yaml)


def _frame_ate(out):
    """(lines, Sim3-aligned ATE in metres) of out/FramePoseTcw.txt against
    the orbit, by the frame ids the saver writes."""
    rows = [ln.split() for ln in (out / "FramePoseTcw.txt").read_text()
            .strip().splitlines()]
    est = np.asarray([[float(x) for x in r[:3]] for r in rows])
    poses = _poses()
    gt = np.asarray([-poses[int(r[7])][:3, :3].T @ poses[int(r[7])][:3, 3]
                     for r in rows])
    return rows, metrics.ate_rmse(est, gt, with_scale=True)


def _check_artifacts(out, min_lines):
    for name in ("FramePoseTcw.txt", "KeyFramePoseTcw.txt", "MapPoint.txt",
                 "map.npz"):
        assert (out / name).exists(), name
    rows, ate = _frame_ate(out)
    assert len(rows) >= min_lines
    assert all(len(r) == 8 for r in rows)
    m = checkpoint.load_map(str(out / "map.npz"))
    klines = (out / "KeyFramePoseTcw.txt").read_text().strip().splitlines()
    mlines = (out / "MapPoint.txt").read_text().strip().splitlines()
    assert len(klines) == m.n_keyframes >= 2
    assert len(mlines) == m.n_points > 50
    return rows, ate


def test_cli_mono_video_on_the_cpu(video, tmp_path, capsys):
    """In-process, --mono --no-loop --cpu: the four artifacts, one frame
    line per tracked frame (the first frames initialize), the progress
    line, and the trajectory within the ATE band."""
    vid, yaml = video
    out = tmp_path / "out"
    rc = run.main(["--settings", yaml, "--video", vid, "--out", str(out),
                   "--mono", "--no-loop", "--cpu"])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "frame     0 state=NOT_INITIALIZED" in printed
    assert f"{N_FRAMES} frames; artifacts in {out}" in printed
    rows, ate = _check_artifacts(out, min_lines=12)
    assert ate < 0.10 * PATH_LEN, f"ATE {ate:.4f} m"


def _tiny_orbvoc_bin(path):
    """A DBoW2 .bin vocabulary (saveToBinaryFile layout), k=3, L=2, as in
    tests/test_cli.py."""
    rng = np.random.default_rng(11)
    rows = []
    frontier, next_id, k, L = [0], 1, 3, 2
    for level in range(L):
        new_frontier = []
        for p in frontier:
            for _ in range(k):
                leaf = level == L - 1
                desc = rng.integers(0, 256, 32).astype(np.uint8)
                rows.append((p, leaf, desc,
                             float(rng.uniform(0.1, 1.0)) if leaf else 0.0))
                if not leaf:
                    new_frontier.append(next_id)
                next_id += 1
        frontier = new_frontier
    with open(path, "wb") as f:
        f.write(struct.pack("<IIiiii", len(rows), 4 + 32 + 4 + 1, k, L, 0, 0))
        for p, leaf, d, w in rows:
            f.write(struct.pack("<i", p) + bytes(d.tolist()) +
                    struct.pack("<f", w) + struct.pack("<?", leaf))


def test_cli_with_an_orbvoc_bin(video, tmp_path):
    """--vocab takes the original's DBoW2 binary; --max-frames stops the
    loop; the keyframes carry words, and the map archive keeps them."""
    vid, yaml = video
    voc_bin = str(tmp_path / "voc.bin")
    _tiny_orbvoc_bin(voc_bin)
    out = tmp_path / "out"
    rc = run.main(["--settings", yaml, "--video", vid, "--out", str(out),
                   "--vocab", voc_bin, "--max-frames", "10", "--mono",
                   "--no-loop", "--cpu"])
    assert rc == 0
    rows, _ = _check_artifacts(out, min_lines=6)
    assert max(int(r[7]) for r in rows) <= 9
    m = checkpoint.load_map(str(out / "map.npz"))
    assert all(kf.word is not None and (kf.word >= 0).any()
               for kf in m.keyframes.values())


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is here")
def test_cli_without_cpu_and_without_a_card_exits(video, tmp_path, capsys,
                                                  monkeypatch):
    """No --cpu and no CUDA device: exit code 1 with the device rule's
    message; no system is built, nothing is tracked or written."""
    from orbslam2_dualcam_tpu_torch.pipeline import system

    def refuse(*a, **k):
        raise AssertionError("the CLI built a system on the CPU")

    monkeypatch.setattr(system.System, "__init__", refuse)
    vid, yaml = video
    out = tmp_path / "out"
    rc = run.main(["--settings", yaml, "--video", vid, "--out", str(out),
                   "--mono", "--no-loop"])
    assert rc == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not out.exists()


class _RecordingSystem:
    """Stands in for System: records what the frame loop hands it."""

    class _Map:
        n_keyframes = 0
        n_points = 0

    def __init__(self):
        self.calls = []
        self.map = self._Map()

    def track(self, images, timestamp):
        self.calls.append((images, timestamp))
        return "OK"


@pytest.mark.parametrize("n_cameras", [1, 2, 3])
def test_track_stream_splits_joint_frames(n_cameras):
    """Equal horizontal slices per camera, timestamps n / fps, --max-frames
    honoured, the count returned."""
    rng = np.random.default_rng(n_cameras)
    frames = [rng.uniform(0, 255, (12, 10 * n_cameras)).astype(np.float32)
              for _ in range(5)]
    sys_ = _RecordingSystem()
    n = run.track_stream(sys_, iter(frames), n_cameras, fps=25.0,
                         max_frames=4)
    assert n == 4 and len(sys_.calls) == 4
    for k, (imgs, ts) in enumerate(sys_.calls):
        assert imgs.shape == (n_cameras, 12, 10) and ts == k / 25.0
        np.testing.assert_array_equal(np.concatenate(list(imgs), axis=1),
                                      frames[k])
    assert run.track_stream(_RecordingSystem(), iter(frames), n_cameras,
                            25.0) == 5


@pytest.mark.slow
def test_both_clis_on_one_video(video, tmp_path):
    """The reference's CLI (a subprocess, on the CPU) and the port's on the
    same video: both initialize, both write a line for each tracked frame,
    keyframe counts within 3 of each other, both trajectories in the ATE
    band."""
    vid, yaml = video
    ref_out, out = tmp_path / "ref", tmp_path / "port"
    r = subprocess.run(
        [sys.executable, "-m", "orbslam2_dualcam_tpu.run", "--settings", yaml,
         "--video", vid, "--out", str(ref_out), "--mono", "--no-loop",
         "--cpu"], capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert run.main(["--settings", yaml, "--video", vid, "--out", str(out),
                     "--mono", "--no-loop", "--cpu"]) == 0
    ref_rows, ref_ate = _check_artifacts(ref_out, min_lines=12)
    rows, ate = _check_artifacts(out, min_lines=12)
    assert abs(len(rows) - len(ref_rows)) <= 2
    n_kf = len((out / "KeyFramePoseTcw.txt").read_text().splitlines())
    ref_kf = len((ref_out / "KeyFramePoseTcw.txt").read_text().splitlines())
    assert abs(n_kf - ref_kf) <= 3, (n_kf, ref_kf)
    assert max(ate, ref_ate) < 0.10 * PATH_LEN, (ate, ref_ate)
