"""The port's user surface against the JAX package's, module by module, on
the same numpy inputs: the rig YAML parser, map checkpoints (a map saved
by either package loads in the other), `rebuild_kfdb`, the TUM and KITTI
loaders, the photo renderers, the cloud tools and `fit_planes`.

`REF_YAML` of tests/test_cli.py is not in the repository, so the parser is
held to the reference's on a settings file written here; the same goes for
the photograph of the photo renderers (a noise image written here)."""

import dataclasses

import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu import tools as ref_tools
from orbslam2_dualcam_tpu.models import kfdb as ref_kfdb_mod
from orbslam2_dualcam_tpu.utils import checkpoint as ref_ckpt
from orbslam2_dualcam_tpu.utils import datasets as ref_datasets
from orbslam2_dualcam_tpu.utils import yaml_config as ref_yaml
from orbslam2_dualcam_tpu.vocab import bow as ref_bow
from orbslam2_dualcam_tpu_torch import tools
from orbslam2_dualcam_tpu_torch.models.kfdb import KeyFrameDatabase
from orbslam2_dualcam_tpu_torch.utils import checkpoint, datasets, yaml_config
from orbslam2_dualcam_tpu_torch.utils.convert import (config_from_reference,
                                                      map_from_reference,
                                                      vocab_from_numpy)

from test_checkpoint import make_small_map
from test_tools import _room_cloud
from torch_parity import random_desc

torch.set_num_threads(1)

DUAL_YAML = """%YAML:1.0
# two cameras, backs to each other (Dual-LenaCV.yaml layout)
nCameras: 2
Camera0.fx: 558.47
Camera0.fy: 559.12
Camera0.cx: 321.5
Camera0.cy: 243.25
Camera0.k1: -0.2812
Camera0.k2: 0.0913
Camera0.p1: 0.00012
Camera0.p2: -0.00035
Camera0.k3: -0.0125
Camera0.qw: 1.0
Camera0.qx: 0.0
Camera0.qy: 0.0
Camera0.qz: 0.0
Camera1.fx: 546.60   # a comment after a value
Camera1.fy: 547.02
Camera1.cx: 318.9
Camera1.cy: 239.4
Camera1.k1: -0.275
Camera1.k2: 0.088
Camera1.p1: -0.0002
Camera1.p2: 0.00041
Camera1.qw: 0.5712
Camera1.qx: -0.0131
Camera1.qy: 0.8206
Camera1.qz: 0.0107
Camera1.tx: 0.0913
Camera1.ty: -0.0021
Camera1.tz: -0.0398
Camera.width: 640
Camera.height: 480
Camera.fps: 25.0
Camera.RGB: 0
ORBextractor.nFeatures: 1300
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
Viewer.KeyFrameSize: 0.05
"""

MONO_YAML = """%YAML:1.0
nCameras: 1
Camera0.fx: 130.0
Camera0.fy: 130.0
Camera0.cx: 80.0
Camera0.cy: 60.0
"""


# ---------------------------------------------------------------------------
# rig YAML
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", [DUAL_YAML, MONO_YAML], ids=["dual", "mono"])
def test_load_rig_yaml_equals_reference(tmp_path, text):
    """Field for field: intrinsics, distortion (k3 too), quaternion and
    translation extrinsics, ORB settings, fps, RGB; defaults where a key is
    missing."""
    p = tmp_path / "rig.yaml"
    p.write_text(text)
    got = yaml_config.load_rig_yaml(str(p))
    want = config_from_reference(ref_yaml.load_rig_yaml(str(p)))
    assert got == want
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if text is DUAL_YAML:
        assert got.cameras[0].dist[4] == -0.0125 and not got.rgb
        assert got.cameras[1].t_sc == (0.0913, -0.0021, -0.0398)
        assert got.orb.n_features == 1300 and got.fps == 25.0


# ---------------------------------------------------------------------------
# map checkpoints
# ---------------------------------------------------------------------------

def assert_maps_equal(a, b):
    """Everything the archive carries: counters, flags, keyframe arrays and
    graph, point arrays and observation records (values and dtypes)."""
    for name in ("next_kid", "next_mid", "origin_kid", "map_scaled",
                 "first_scale_kid"):
        assert getattr(a, name) == getattr(b, name), name
    assert sorted(a.keyframes) == sorted(b.keyframes)
    assert sorted(a.points) == sorted(b.points)
    for kid, ka in a.keyframes.items():
        kb = b.keyframes[kid]
        for f in ("T_cw", "uv", "kp_cam", "level", "angle", "desc",
                  "kp_valid", "mp_idx", "word", "node"):
            x, y = getattr(ka, f), getattr(kb, f)
            if x is None or y is None:
                assert x is None and y is None, (kid, f)
                continue
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, (kid, f, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=f"kf {kid} {f}")
        for f in ("frame_id", "parent", "children", "covis", "loop_edges",
                  "scaled", "connected_to_second_map"):
            assert getattr(ka, f) == getattr(kb, f), (kid, f)
    for mid, pa in a.points.items():
        pb = b.points[mid]
        for f in ("pos", "normal", "desc"):
            x, y = np.asarray(getattr(pa, f)), np.asarray(getattr(pb, f))
            assert x.dtype == y.dtype, (mid, f)
            np.testing.assert_array_equal(x, y, err_msg=f"mp {mid} {f}")
        for f in ("obs", "obs_cam", "first_view_cam", "min_dist", "max_dist",
                  "n_visible", "n_found", "ref_kid", "first_kf_id"):
            assert getattr(pa, f) == getattr(pb, f), (mid, f)
        assert pa.seen_by_multiple_cams == pb.seen_by_multiple_cams


@pytest.fixture(scope="module")
def system_run():
    """A short run of the port's System on the CPU, with a vocabulary, so
    its map carries words and nodes: 8 frames of the mono orbit (about 6
    keyframes and 300 points)."""
    from orbslam2_dualcam_tpu_torch import CameraConfig, OrbConfig, SystemConfig
    from orbslam2_dualcam_tpu_torch.ops import orb
    from orbslam2_dualcam_tpu_torch.pipeline.system import System
    from orbslam2_dualcam_tpu_torch.utils import synthetic
    from orbslam2_dualcam_tpu_torch.utils.config import VocabConfig
    from orbslam2_dualcam_tpu_torch.vocab import bow

    cam = dict(width=320, height=240, fx=260, fy=260, cx=160, cy=120)
    cfg = SystemConfig(cameras=(CameraConfig(**cam),),
                       orb=OrbConfig(n_features=400, n_levels=4),
                       vocab=VocabConfig(branching=6, depth=2))
    world = synthetic.make_box_world(np.random.default_rng(42), half=6.0,
                                     tex_size=256)
    poses = synthetic.orbit_trajectory(45, radius=1.5, total_angle=0.8 * np.pi)
    K = np.array([[260.0, 0, 160], [0, 260, 120], [0, 0, 1]])
    descs = []
    for T in poses[::15]:
        f = orb.extract_orb(torch.as_tensor(
            synthetic.render(world, K, T, H=240, W=320)), cfg.orb, 400)
        descs.append(f.desc.numpy().view(np.uint32)[f.valid.numpy()])
    voc = bow.train_vocabulary(np.concatenate(descs), branching=6, depth=2,
                               seed=1, weight_docs=descs, device="cpu")
    sys_ = System(cfg, voc=voc, enable_loop_closing=False, device="cpu")
    Kr, T_sc = sys_.rig.K.numpy(), sys_.rig.T_sc.numpy()
    for k, T in enumerate(poses[:8]):
        sys_.track(synthetic.render_rig(world, Kr, T_sc, T, H=240, W=320),
                   k / 30.0)
    sys_.shutdown()
    assert sys_.map.n_keyframes >= 4 and sys_.map.n_points > 150
    return sys_


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_small_map_loads_across_packages(tmp_path, direction):
    """tests/test_checkpoint.py's map, saved by one package and loaded by
    the other, equals the saved map; the loaded map keeps working
    (erase bookkeeping on a restored point)."""
    ref_map = make_small_map(np.random.default_rng(0))
    port_map = map_from_reference(ref_map)
    p = str(tmp_path / "map.npz")
    if direction == "reference_to_port":
        ref_ckpt.save_map(ref_map, p)
        loaded = checkpoint.load_map(p)
    else:
        checkpoint.save_map(port_map, p)
        loaded = ref_ckpt.load_map(p)
    assert_maps_equal(loaded, ref_map)
    assert_maps_equal(loaded, port_map)
    mp = next(iter(loaded.points.values()))
    kid = next(iter(mp.obs))
    loaded.erase_observation(mp, kid)
    assert kid not in mp.obs


def test_system_map_loads_across_packages(system_run, tmp_path):
    """The map of a port System run (whatever types its fields hold) is
    saved by the port, loaded by the reference, saved again by the
    reference and loaded by the port: equal at each step, and the two
    archives hold the same keys."""
    m = system_run.map
    p1, p2 = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    checkpoint.save_map(m, p1)
    ref_loaded = ref_ckpt.load_map(p1)
    assert_maps_equal(ref_loaded, m)
    ref_ckpt.save_map(ref_loaded, p2)
    port_loaded = checkpoint.load_map(p2)
    assert_maps_equal(port_loaded, m)
    z1, z2 = np.load(p1), np.load(p2)
    assert sorted(z1.files) == sorted(z2.files)
    assert bytes(z1["__meta__"]) == bytes(z2["__meta__"])


# ---------------------------------------------------------------------------
# rebuild_kfdb
# ---------------------------------------------------------------------------

def _assert_dbs_equal(port_db, ref_db, m, ref_m, n_cameras):
    """Postings and sparse vectors equal; every keyframe camera's own query
    gives the same candidates with the same scores in both."""
    from orbslam2_dualcam_tpu_torch.vocab.bow import score_sparse

    for cam in range(n_cameras):
        want = {int(w): set(k) for w, k in ref_db.inverted[cam].items() if k}
        got = {int(w): set(k) for w, k in port_db.inverted[cam].items() if k}
        assert got == want, cam
        assert set(port_db.bow[cam]) == set(ref_db.bow[cam])
        for kid, vec in ref_db.bow[cam].items():
            np.testing.assert_array_equal(port_db.bow[cam][kid].words, vec.words)
            np.testing.assert_array_equal(port_db.bow[cam][kid].weights,
                                          vec.weights)
    for kid in sorted(m.keyframes):
        for cam in range(n_cameras):
            q = port_db.bow[cam].get(kid)
            if q is None:
                continue
            words = q.words.astype(np.int64)
            got = port_db.detect_reloc_candidates(words, q, cam, cam, m)
            want = ref_db.detect_reloc_candidates(
                words, ref_db.bow[cam][kid], cam, cam, ref_m)
            assert got == want, (kid, cam)
            assert kid in got, (kid, cam, got)
            assert [score_sparse(q, port_db.bow[cam][c]) for c in got] == \
                [score_sparse(ref_db.bow[cam][kid], ref_db.bow[cam][c])
                 for c in want]


def _ref_voc(n_words_min: int):
    rng = np.random.default_rng(4)
    docs = [random_desc(rng, 150) for _ in range(6)]
    ref = ref_bow.train_vocabulary(np.concatenate(docs), branching=10,
                                   depth=2, seed=2, weight_docs=docs)
    assert ref.n_words >= n_words_min
    as_np = ref._replace(centroids=tuple(np.asarray(c) for c in ref.centroids),
                         idf=np.asarray(ref.idf))
    return ref, vocab_from_numpy(as_np, device="cpu")


def test_rebuild_kfdb_equals_reference_on_the_small_map():
    """tests/test_checkpoint.py's map (words in [0, 100)) as two cameras of
    20 rows each, on a 10^2 vocabulary of the reference: equal postings,
    vectors and query scores; the reference's database is its
    pure-Python index."""
    ref_map = make_small_map(np.random.default_rng(0))
    ref_voc, voc = _ref_voc(100)
    rdb = ref_kfdb_mod.KeyFrameDatabase(2, ref_voc.n_words, use_native=False)
    ref_ckpt.rebuild_kfdb(ref_map, rdb, ref_voc, 2)
    m = map_from_reference(ref_map)
    db = KeyFrameDatabase(2, voc.n_words, use_native=False)
    checkpoint.rebuild_kfdb(m, db, voc, 2)
    _assert_dbs_equal(db, rdb, m, ref_map, 2)


def test_rebuild_kfdb_on_a_restored_system_map(system_run, tmp_path):
    """The port System's map, saved and restored: the rebuilt database
    equals the one the system built while tracking, and the reference's
    rebuild from the same archive and vocabulary."""
    from orbslam2_dualcam_tpu_torch.vocab.bow import save_vocabulary

    sys_ = system_run
    p = str(tmp_path / "map.npz")
    checkpoint.save_map(sys_.map, p)
    m = checkpoint.load_map(p)
    db = KeyFrameDatabase(1, sys_.voc.n_words, use_native=False)
    checkpoint.rebuild_kfdb(m, db, sys_.voc, 1)
    # the system's database is the C++ index, read word by word; its erase
    # of a culled keyframe drops every posting the keyframe added
    assert sys_.kfdb.native is not None
    for w in range(sys_.voc.n_words):
        kids = set(sys_.kfdb._shared_word_counts(np.array([w]), 0, set()))
        assert db.inverted[0].get(w, set()) == kids, w
    assert set(db.bow[0]) == set(sys_.kfdb.bow[0]) == set(m.keyframes)
    for kid, vec in sys_.kfdb.bow[0].items():
        np.testing.assert_array_equal(db.bow[0][kid].words, vec.words)
        np.testing.assert_array_equal(db.bow[0][kid].weights, vec.weights)
    vp = str(tmp_path / "voc.npz")
    save_vocabulary(sys_.voc, vp)
    ref_voc = ref_bow.load_vocabulary(vp)
    ref_m = ref_ckpt.load_map(p)
    rdb = ref_kfdb_mod.KeyFrameDatabase(1, ref_voc.n_words, use_native=False)
    ref_ckpt.rebuild_kfdb(ref_m, rdb, ref_voc, 1)
    _assert_dbs_equal(db, rdb, m, ref_m, 1)


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

def _write_tum(root, rng, n=4, H=24, W=32):
    import cv2

    (root / "rgb").mkdir(parents=True)
    lines = ["# color images", "# timestamp filename"]
    for i in range(n):
        ts = 1305031102.175304 + i / 30.0
        cv2.imwrite(str(root / f"rgb/{ts:.6f}.png"),
                    rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
        lines.append(f"{ts:.6f} rgb/{ts:.6f}.png")
    (root / "rgb.txt").write_text("\n".join(lines) + "\n")
    gt = ["# ground truth trajectory", "# timestamp tx ty tz qx qy qz qw"]
    for i in range(3 * n):
        ts = 1305031102.17 + i / 90.0
        v = rng.normal(size=7)
        gt.append(f"{ts:.4f} " + " ".join(f"{x:.4f}" for x in v))
    (root / "groundtruth.txt").write_text("\n".join(gt) + "\n")


def _write_kitti(root, rng, n=4, H=24, W=32):
    import cv2

    (root / "image_0").mkdir(parents=True)
    for i in range(n):
        cv2.imwrite(str(root / f"image_0/{i:06d}.png"),
                    rng.integers(0, 256, (H, W), dtype=np.uint8))
    (root / "times.txt").write_text(
        "".join(f"{0.103 * i:.6e}\n" for i in range(n)))
    (root / f"{root.name}.txt").write_text("".join(
        " ".join(f"{x:.6e}" for x in rng.normal(size=12)) + "\n"
        for _ in range(n - 1)))


@pytest.mark.parametrize("fmt", ["tum", "kitti"])
def test_dataset_loaders_equal_reference(tmp_path, fmt):
    """The same index, ground truth, images and ground-truth lookups from
    a small sequence written here."""
    rng = np.random.default_rng(5)
    root = tmp_path / "00"
    if fmt == "tum":
        _write_tum(root, rng)
        got = datasets.TumRgbDataset.load(str(root))
        want = ref_datasets.TumRgbDataset.load(str(root))
        assert got.frames == want.frames and len(got.frames) == 4
        for f in ("gt_t", "gt_pos", "gt_quat"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        for ts, _ in got.frames + [(0.0, None)]:
            a, b = got.gt_center_at(ts), want.gt_center_at(ts)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    else:
        _write_kitti(root, rng)
        got = datasets.KittiOdometryDataset.load(str(root))
        want = ref_datasets.KittiOdometryDataset.load(str(root))
        assert got.frames == want.frames and len(got.frames) == 4
        np.testing.assert_array_equal(got.times, want.times)
        np.testing.assert_array_equal(got.gt_T_wc, want.gt_T_wc)
        for i in range(4):
            a, b = got.gt_center(i), want.gt_center(i)
            assert (a is None) == (b is None) and (i < 3) == (a is not None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    for i in range(len(got.frames)):
        img = got.read(i)
        assert img.dtype == np.float32
        np.testing.assert_array_equal(img, want.read(i))


def test_planar_photo_renderers_equal_reference(tmp_path):
    """On a noise photograph written here: the same wall textures, the same
    rig images and the same mono images (with sensor noise)."""
    import cv2

    from orbslam2_dualcam_tpu_torch.utils import synthetic

    photo = str(tmp_path / "photo.png")
    cv2.imwrite(photo, np.random.default_rng(6).integers(
        0, 256, (90, 120), dtype=np.uint8))
    planes = datasets.photo_room_planes(photo, tex=64, seed=3)
    ref_planes = ref_datasets.photo_room_planes(photo, tex=64, seed=3)
    assert len(planes) == len(ref_planes) == 6
    for a, b in zip(planes, ref_planes):
        np.testing.assert_array_equal(a.tex, b.tex)
    poses = synthetic.orbit_trajectory(3, radius=1.5, total_angle=0.2)
    K = np.array([[52.0, 0, 40], [0, 52, 30], [0, 0, 1]])
    rig_K = np.stack([K, K])
    T1 = np.eye(4)
    T1[:3, :3] = np.diag([-1.0, 1.0, -1.0])
    T1[2, 3] = 0.5
    rig_T_sc = np.stack([np.eye(4), T1])
    got = list(datasets.planar_photo_rig_sequence(
        poses, rig_K, rig_T_sc, H=60, W=80, planes=planes))
    want = list(ref_datasets.planar_photo_rig_sequence(
        poses, rig_K, rig_T_sc, H=60, W=80, planes=ref_planes))
    assert len(got) == len(want) == 3
    for (ia, Ta), (ib, Tb) in zip(got, want):
        assert ia.shape == (2, 60, 80) and ia.std() > 1.0
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(Ta, Tb)
    got = list(datasets.planar_photo_sequence(poses, K, H=60, W=80,
                                              planes=planes, noise=2.0, seed=3))
    want = list(ref_datasets.planar_photo_sequence(poses, K, H=60, W=80,
                                                   planes=ref_planes,
                                                   noise=2.0, seed=3))
    for (ia, _), (ib, _) in zip(got, want):
        np.testing.assert_array_equal(ia, ib)


# ---------------------------------------------------------------------------
# tools
# ---------------------------------------------------------------------------

def _write_points(path, pts):
    with open(path, "w") as f:
        for i, p in enumerate(pts):
            f.write(f"{p[0]:.7f} {p[1]:.7f} {p[2]:.7f} {i}\n")


@pytest.mark.parametrize("cmd", ["convert", "view"])
def test_tools_main_equals_reference(tmp_path, cmd):
    """`convert` writes the same PLY text (voxel filter and outlier removal
    on); `view` renders the same PNG picture."""
    import cv2

    pts = _room_cloud(np.random.default_rng(0), n=240)
    src = tmp_path / "map_points.txt"
    _write_points(src, pts)
    if cmd == "convert":
        a, b = tmp_path / "port.ply", tmp_path / "ref.ply"
        args = ["--voxel", "0.1", "--denoise"]
        tools.main(["convert", str(src), str(a)] + args)
        ref_tools.main(["convert", str(src), str(b)] + args)
        assert a.read_text() == b.read_text()
        assert a.read_text().startswith("ply\n")
        return
    kf = tmp_path / "keyframes.txt"
    kf.write_text("".join(f"{i * 0.1:.7f} 0.0 0.0 0.0 0.0 0.0 1.0 {i}\n"
                          for i in range(8)))
    a, b = tmp_path / "port.png", tmp_path / "ref.png"
    tools.main(["view", str(src), str(a), "--keyframes", str(kf)])
    ref_tools.main(["view", str(src), str(b), "--keyframes", str(kf)])
    assert a.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(cv2.imread(str(a)), cv2.imread(str(b)))


def _planes_agree(got, want):
    assert len(got) == len(want)
    for (n1, d1, i1), (n2, d2, i2) in zip(got, want):
        s = np.sign(n1 @ n2)
        assert np.abs(n1 - s * n2).max() < 1e-3, (n1, n2)
        assert abs(d1 - s * d2) < 1e-3, (d1, d2)
        assert abs(len(i1) - len(i2)) <= 1, (len(i1), len(i2))


@pytest.mark.parametrize("seed", [0, 3])
def test_fit_planes_equals_reference(seed):
    """tests/test_tools.py's room cloud: the same planes from the same
    hypotheses (normals and offsets within 1e-3, inlier counts within 1:
    float32 distances at the threshold may differ between the two
    matrix products), and the walls are found."""
    pts = _room_cloud(np.random.default_rng(1), noise=0.005)
    got = tools.fit_planes(pts, n_planes=3, dist_th=0.04, seed=seed,
                           device="cpu")
    want = ref_tools.fit_planes(pts, n_planes=3, dist_th=0.04, seed=seed)
    _planes_agree(got, want)
    assert {int(np.argmax(np.abs(n))) for n, _, _ in got} == {0, 1, 2}


def test_fit_planes_cli_on_the_cpu(tmp_path, capsys):
    """`fit-planes --cpu` prints the reference's plane lines."""
    pts = _room_cloud(np.random.default_rng(1), noise=0.005)
    src = tmp_path / "map_points.txt"
    _write_points(src, pts)
    tools.main(["fit-planes", str(src), "--n", "3", "--dist", "0.04", "--cpu"])
    got = capsys.readouterr().out.strip().splitlines()
    ref_tools.main(["fit-planes", str(src), "--n", "3", "--dist", "0.04"])
    want = capsys.readouterr().out.strip().splitlines()
    assert len(got) == len(want) == 3
    assert [ln.split(" n=")[0] for ln in got] == \
        [ln.split(" n=")[0] for ln in want]
