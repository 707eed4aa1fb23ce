"""The loop scenario of chip_smoke.py's phase 9 at 320x240 / 400 features,
run by each package alone over three RANSAC seeds (cfg.vocab.seed 0, 1,
2): camera 0 of a 320x240 rig in the box room of seed 7, a vocabulary of
8^4 words (seed 5) trained by the package on its own descriptors of 16
orbit frames, and 110 frames over 2.2 pi of an orbit of radius 1.5 m,
System(cfg, voc, enable_loop_closing=True) with each package's defaults
(both on their C++ postings index).

Each run is a child process (`python tests/test_torch_loop_bands.py
reference|port SEED` prints its result as one JSON line), six at a time.
The test prints each run (composed-trajectory Sim3 ATE, loops closed and
the frame of the first, LOST frames, the closer's Sim3 attempts and the
widened / projected / total counts of the accepted one) and the two ATE
bands, and fails if the port's band lies wholly above the reference's.

`slow`: the six runs take several minutes of CPU each."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
SEEDS = (0, 1, 2)
N_FRAMES = 110
LOOP_MAX_ATE_M = 0.8        # tests/test_loop_closing.py's gate


def run(package: str, seed: int) -> dict:
    """One run of the scenario by `package` alone."""
    cam = dict(width=320, height=240, fx=260, fy=260, cx=160, cy=120)
    if package == "reference":
        import jax.numpy as jnp

        from orbslam2_dualcam_tpu.ops import orb
        from orbslam2_dualcam_tpu.pipeline.system import System
        from orbslam2_dualcam_tpu.utils import config as C
        from orbslam2_dualcam_tpu.utils import metrics, synthetic
        from orbslam2_dualcam_tpu.vocab import bow

        def descs_of(img, cfg):
            f = orb.extract_orb(jnp.asarray(img), cfg.orb, 400)
            return np.asarray(f.desc)[np.asarray(f.valid)]
        kw, voc_kw = {}, {}
    else:
        import torch

        from orbslam2_dualcam_tpu_torch.ops import orb
        from orbslam2_dualcam_tpu_torch.pipeline.system import System
        from orbslam2_dualcam_tpu_torch.utils import config as C
        from orbslam2_dualcam_tpu_torch.utils import metrics, synthetic
        from orbslam2_dualcam_tpu_torch.vocab import bow

        torch.set_num_threads(1)

        def descs_of(img, cfg):
            f = orb.extract_orb(torch.as_tensor(img), cfg.orb, 400)
            return f.desc.numpy().view(np.uint32)[f.valid.numpy()]
        kw, voc_kw = dict(device="cpu"), dict(device="cpu")
    cfg = C.SystemConfig(
        cameras=(C.CameraConfig(**cam),),
        orb=C.OrbConfig(n_features=400, n_levels=4),
        mapping=C.MappingConfig(cull_found_ratio=0.1),
        vocab=C.VocabConfig(branching=8, depth=4, seed=seed),
        capacity=C.CapacityConfig(max_local_mp=2048))
    world = synthetic.make_box_world(np.random.default_rng(7), half=6.0)
    K = np.array([[260.0, 0, 160], [0, 260, 120], [0, 0, 1]])
    docs = [descs_of(synthetic.render(world, K, T, H=240, W=320), cfg)
            for T in synthetic.orbit_trajectory(16, radius=1.5)]
    voc = bow.train_vocabulary(np.concatenate(docs), branching=8, depth=4,
                               seed=5, weight_docs=docs, **voc_kw)
    sys_ = System(cfg, voc=voc, enable_loop_closing=True, **kw)
    poses = synthetic.orbit_trajectory(N_FRAMES, radius=1.5,
                                       total_angle=2.2 * np.pi)
    Ks, T_sc = np.asarray(sys_.rig.K), np.asarray(sys_.rig.T_sc)
    lc, first_loop, states = sys_.loop_closer, None, []
    for k, T in enumerate(poses):
        states.append(sys_.track(synthetic.render_rig(world, Ks, T_sc, T, H=240,
                                                      W=320), k / 30.0))
        if first_loop is None and lc.n_loops_closed:
            first_loop = k
    sys_.shutdown()
    traj = sys_.tracker.composed_trajectory()
    est = metrics.trajectory_positions(traj)
    gt = np.asarray([-poses[f][:3, :3].T @ poses[f][:3, 3] for f, _, _ in traj])
    ate = float(metrics.ate_rmse(est, gt, with_scale=True))
    sim3 = [e for e in lc.debug_log if e.startswith("sim3 ")]
    return {"package": package, "seed": seed, "ate": ate, "n_traj": len(traj),
            "loops": lc.n_loops_closed, "first_loop_frame": first_loop,
            "lost": states.count("LOST"), "last_state": states[-1],
            "sim3_attempts": sum(" bow=" in e for e in sim3),
            "sim3_widened": [e for e in sim3 if " widened=" in e][-3:]}


@pytest.mark.slow
def test_loop_ate_bands_of_both_packages():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    procs = {(pkg, seed): subprocess.Popen(
        [sys.executable, __file__, pkg, str(seed)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pkg in ("reference", "port") for seed in SEEDS}
    results = {}
    for key, p in procs.items():
        out, err = p.communicate(timeout=3600)
        assert p.returncode == 0, (key, err[-3000:])
        results[key] = json.loads(out.strip().splitlines()[-1])
    bands = {}
    for pkg in ("reference", "port"):
        ates = [results[pkg, s]["ate"] for s in SEEDS]
        bands[pkg] = (min(ates), max(ates))
        for s in SEEDS:
            print(json.dumps(results[pkg, s]))
        print(f"{pkg}: composed Sim3 ATE band {bands[pkg][0]:.4f}-"
              f"{bands[pkg][1]:.4f} m over seeds {SEEDS} (gate "
              f"{LOOP_MAX_ATE_M} m)")
    for r in results.values():
        assert r["n_traj"] > N_FRAMES // 2 and np.isfinite(r["ate"]), r
    assert bands["port"][0] <= bands["reference"][1], bands


if __name__ == "__main__":
    print(json.dumps(run(sys.argv[1], int(sys.argv[2]))), flush=True)
