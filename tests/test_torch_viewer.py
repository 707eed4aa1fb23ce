"""The port's live viewer (viz/live.py) and its renderers (viz/viewer.py)
against the JAX package's, on tests/test_live_viewer.py's inputs: the page,
both PNG panels and the same status line over HTTP, the same pictures, and
`System(viewer=True)` tracking a few frames on the CPU, then closing."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu.models.map import KeyFrame as RefKeyFrame
from orbslam2_dualcam_tpu.models.map import Map as RefMap
from orbslam2_dualcam_tpu.viz import live as ref_live
from orbslam2_dualcam_tpu.viz import viewer as ref_viewer
from orbslam2_dualcam_tpu_torch.pipeline.tracking import HostFrame
from orbslam2_dualcam_tpu_torch.utils.convert import map_from_reference
from orbslam2_dualcam_tpu_torch.viz import live, viewer

from test_live_viewer import _get
from test_live_viewer import _host_frame as ref_host_frame

torch.set_num_threads(1)

PNG = b"\x89PNG\r\n\x1a\n"


def _maps(rng):
    """tests/test_live_viewer.py's map (5 keyframes, 30 points), as the
    reference's and as the port's."""
    m = RefMap()
    for i in range(5):
        m.add_keyframe(RefKeyFrame(
            kid=m.new_kid(), frame_id=i, T_cw=np.eye(4),
            uv=np.zeros((16, 2), np.float32), kp_cam=np.zeros(16, np.int32),
            level=np.zeros(16, np.int32), angle=np.zeros(16, np.float32),
            desc=np.zeros((16, 8), np.uint32), kp_valid=np.ones(16, bool),
            mp_idx=np.full(16, -1, np.int64)))
    for i in range(30):
        m.new_point(rng.normal(size=3), ref_kid=0, first_cam=0)
    return m, map_from_reference(m)


def _port_frame(ref_frame):
    f = HostFrame(**{k: getattr(ref_frame, k) for k in (
        "frame_id", "timestamp", "uv", "level", "angle", "desc", "valid",
        "words", "nodes", "mp_ids")})
    f.T_cw = ref_frame.T_cw
    return f


def _fetch(port, path):
    """(status code, body), a 404 included."""
    try:
        return _get(port, path)
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _decode(png):
    import cv2
    return cv2.imdecode(np.frombuffer(png, np.uint8), cv2.IMREAD_UNCHANGED)


@pytest.mark.parametrize("case", ["serves_panels", "throttles"])
def test_live_viewer_equals_reference(case):
    """Both viewers fed the same frame and map: the page, two PNGs with the
    same pictures, and the same status.json; inside the throttle window the
    status still moves."""
    rng = np.random.default_rng(0)
    ref_map, port_map = _maps(rng)
    images = rng.uniform(0, 255, (2, 120, 160)).astype(np.float32)
    ref_frame = ref_host_frame(rng)
    frame = _port_frame(ref_frame)
    T_sc = np.stack([np.eye(4), np.eye(4)])
    interval = 0.0 if case == "serves_panels" else 3600.0
    ours = live.LiveViewer(port=0, min_interval_s=interval)
    ref = ref_live.LiveViewer(port=0, min_interval_s=interval)
    try:
        for v, m, f in ((ours, port_map, frame), (ref, ref_map, ref_frame)):
            v.update(images, f, "OK", m, T_sc)
            if case == "throttles":
                v.update(images, f, "LOST", m, T_sc)
        got = {p: _fetch(ours.port, p) for p in ("/", "/frame.png",
                                                  "/map.png", "/status.json")}
        want = {p: _fetch(ref.port, p) for p in got}
        assert got["/"][0] == 200 and b"frame.png" in got["/"][1]
        for p in ("/frame.png", "/map.png"):
            # a panel is served once drawn (404 before: the throttle window
            # may open before the first draw)
            assert got[p][0] == want[p][0]
            if case == "serves_panels":
                assert got[p][0] == 200 and got[p][1][:8] == PNG
            if got[p][0] == 200:
                np.testing.assert_array_equal(_decode(got[p][1]),
                                              _decode(want[p][1]))
        status = json.loads(got["/status.json"][1])
        assert status == json.loads(want["/status.json"][1])
        assert status["state"] == ("OK" if case == "serves_panels" else "LOST")
        assert (status["n_keyframes"], status["n_points"]) == (5, 30)
        assert status["tracked"] > 0
    finally:
        ours.close()
        ref.close()


def test_renderers_draw_the_reference_pictures(tmp_path):
    """draw_frame and plot_map (with the current and relocalization
    cameras) write the reference's pictures."""
    rng = np.random.default_rng(1)
    ref_map, port_map = _maps(rng)
    images = rng.uniform(0, 255, (2, 60, 80)).astype(np.float32)
    uv = rng.uniform(0, 80, (2, 40, 2))
    valid = rng.random((2, 40)) < 0.9
    tracked = rng.random((2, 40)) < 0.5
    T = np.eye(4)
    T[:3, 3] = [0.2, 0.0, -1.0]
    out = {}
    for name, draw, m in (("port", viewer, port_map), ("ref", ref_viewer,
                                                       ref_map)):
        a, b = str(tmp_path / f"{name}_f.png"), str(tmp_path / f"{name}_m.png")
        draw.draw_frame(images, uv, valid, tracked, "OK", a)
        draw.plot_map(m, np.stack([np.eye(4), np.eye(4)]), b,
                      current_T_cw=np.eye(4), reloc_T_cw=T)
        out[name] = (open(a, "rb").read(), open(b, "rb").read())
    for got, want in zip(out["port"], out["ref"]):
        assert got[:8] == PNG
        np.testing.assert_array_equal(_decode(got), _decode(want))


def test_system_with_the_viewer_on_the_cpu():
    """System(cfg, voc=None, viewer=True, device="cpu") tracks five frames
    of the mono orbit; the viewer shows its state, map counts and both
    panels; shutdown closes the server."""
    from orbslam2_dualcam_tpu_torch import CameraConfig, OrbConfig, SystemConfig
    from orbslam2_dualcam_tpu_torch.pipeline.system import System
    from orbslam2_dualcam_tpu_torch.utils import synthetic

    cfg = SystemConfig(cameras=(CameraConfig(width=320, height=240, fx=260,
                                             fy=260, cx=160, cy=120),),
                       orb=OrbConfig(n_features=400, n_levels=4))
    sys_ = System(cfg, voc=None, enable_loop_closing=False, viewer=True,
                  device="cpu")
    port = sys_.viewer.port
    sys_.viewer.min_interval_s = 0.0
    world = synthetic.make_box_world(np.random.default_rng(42), half=6.0,
                                     tex_size=256)
    poses = synthetic.orbit_trajectory(45, radius=1.5, total_angle=0.8 * np.pi)
    K, T_sc = sys_.rig.K.numpy(), sys_.rig.T_sc.numpy()
    try:
        states = [sys_.track(synthetic.render_rig(world, K, T_sc, T, H=240,
                                                  W=320), k / 30.0)
                  for k, T in enumerate(poses[:5])]
        assert states[-1] == "OK", sys_.tracker.events
        status = json.loads(_get(port, "/status.json")[1])
        assert status["state"] == sys_.tracker.state == "OK"
        assert status["n_keyframes"] == sys_.map.n_keyframes >= 2
        assert status["n_points"] == sys_.map.n_points
        assert status["tracked"] == int((sys_.tracker.last.mp_ids >= 0).sum())
        for p in ("/frame.png", "/map.png"):
            code, png = _get(port, p)
            assert code == 200 and png[:8] == PNG
        assert _decode(_get(port, "/frame.png")[1]).shape[1] > 320
    finally:
        sys_.shutdown()
    assert sys_.viewer is None
    with pytest.raises((urllib.error.URLError, ConnectionError)):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/status.json",
                               timeout=5)
