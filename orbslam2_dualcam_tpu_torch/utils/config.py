"""Typed configuration for the whole engine.

The port's own copy of orbslam2_dualcam_tpu/utils/config.py: every
dataclass, field name, default and preset is the JAX package's, so a
config converts one to one (utils/convert.config_from_reference) and a
test pins the two equal field by field.  This package never imports the
JAX package's module.

ORB-SLAM2-DualCam scatters its constants between a YAML file
(Dual-LenaCV.yaml, parsed at Tracking.cc:86-217) and magic numbers in code
(Tracking.h:102-103, ORBmatcher.cc:57-59, KeyFrame.cc:456,
LoopClosing.cc:56, Optimizer.cc chi-square thresholds, ...).  Here every
constant is an explicit, documented field of a frozen, hashable dataclass.

Static-shape capacities (``max_*`` fields) have no equivalent in the C++
code, which grows std::vectors dynamically; fixed shapes with validity
masks are the data model of both packages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class CameraConfig:
    """One pinhole camera of the rig (reference: Dual-LenaCV.yaml:10-46).

    ``q_sc``/``t_sc`` give T_sc, the transform taking points from the rig
    capture frame (camera 0) to this sibling camera's frame, as parsed from
    the YAML quaternion at Tracking.cc:147-170.
    """

    fx: float = 500.0
    fy: float = 500.0
    cx: float = 320.0
    cy: float = 240.0
    # radial/tangential distortion k1 k2 p1 p2 k3 (Dual-LenaCV.yaml:17-21)
    dist: Tuple[float, float, float, float, float] = (0.0, 0.0, 0.0, 0.0, 0.0)
    # extrinsics: unit quaternion (w, x, y, z) and translation of T_sc
    q_sc: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)
    t_sc: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    width: int = 640
    height: int = 480


@dataclass(frozen=True)
class OrbConfig:
    """ORB extraction parameters (reference: Dual-LenaCV.yaml:71-84,
    Tracking.cc:204-207, ORBextractor.cc)."""

    n_features: int = 1000           # base budget (ORBextractor.nFeatures)
    track_factor: float = 1.3        # tracking budget multiplier (Tracking.cc:204)
    init_factor: float = 2.0         # init budget multiplier (Tracking.cc:206)
    scale_factor: float = 1.2        # pyramid scale (ORBextractor.cc ctor)
    n_levels: int = 8
    ini_th_fast: int = 20            # cell FAST threshold (ORBextractor.cc:787)
    min_th_fast: int = 7             # fallback threshold (ORBextractor.cc:791)
    fast_radius: int = 3             # Bresenham circle radius (FAST-16)
    fast_arc: int = 9                # contiguous arc length for FAST-N
    cell_size: int = 30              # FAST search cell (ORBextractor.cc:765-829)
    patch_size: int = 31             # orientation/BRIEF patch (ORBextractor.h)
    edge_threshold: int = 19         # border margin (ORBextractor.h)
    brief_seed: int = 0x12345678     # our BRIEF pattern is procedurally
    # generated from this seed (the reference embeds a learned 256-pair
    # table, bit_pattern_31_ at ORBextractor.cc:150; we train-free sample
    # the classic BRIEF gaussian pattern instead — see ops/orb.py)
    brief_bf16: bool = False         # the JAX package's option to run its
    # BRIEF sampling matmul in bf16; the port gathers samples directly and
    # does not read it
    brief_learned: bool = False      # use the PUBLISHED learned ORB pattern
    # (ops/orb_pattern.py) so descriptors are distributed like OpenCV-ORB's
    # — required for sensible quantization against a pretrained ORBvoc
    # (vocab/orbvoc.py); self-trained vocabularies work with either
    pallas_fast: bool = True         # fused FAST+NMS kernel (the name is
    # the JAX package's, for its Pallas kernel).  In the port the kernel is
    # ops/fast_nms.py; on CUDA tensors it always runs, and False raises there

    @property
    def n_track(self) -> int:
        return int(self.n_features * self.track_factor)

    @property
    def n_init(self) -> int:
        return int(self.n_features * self.init_factor)

    @property
    def scale_factors(self) -> np.ndarray:
        return self.scale_factor ** np.arange(self.n_levels)

    @property
    def level_sigma2(self) -> np.ndarray:
        return self.scale_factors ** 2


@dataclass(frozen=True)
class MatcherConfig:
    """Descriptor matching thresholds (reference: ORBmatcher.cc:57-59)."""

    th_low: int = 50                 # strict Hamming threshold
    th_high: int = 100               # loose Hamming threshold
    histo_length: int = 30           # rotation-consistency histogram bins
    nn_ratio_bow: float = 0.75       # Lowe ratio for BoW search (Tracking.cc:1300)
    nn_ratio_proj: float = 0.9       # ratio for projection search (Tracking.cc:1390)
    check_orientation: bool = True


@dataclass(frozen=True)
class InitConfig:
    """Two-view monocular initializer (reference: Initializer.cc)."""

    sigma: float = 1.0               # measurement noise (Initializer ctor, Tracking.cc:1966)
    ransac_iters: int = 200          # fixed hypothesis budget (Tracking.cc:1966)
    min_matches: int = 100           # Tracking.cc:1953
    rh_threshold: float = 0.40       # H-vs-F model select score ratio (Initializer.cc:135)
    min_parallax_deg: float = 1.0    # ReconstructF/H parallax gate (Initializer.cc:488+)
    min_triangulated: int = 50


@dataclass(frozen=True)
class BAConfig:
    """Bundle-adjustment iteration budgets and robust thresholds
    (reference: Optimizer.cc:250-405, 407-696, 62-248)."""

    chi2_mono: float = 5.991         # 2-DoF 95% chi-square gate
    chi2_sim3: float = 9.210         # Sim3 gate (Sim3Solver.cc:105)
    huber_delta: float = 5.991 ** 0.5
    # PoseOptimization: the reference runs 4 rounds x 10 g2o-LM iterations
    # (Optimizer.cc:352-354).  The JAX package measured 4x5 MORE accurate
    # than 4x10 on its noisy-outlier pose fixture (the between-round
    # chi-square re-classification with a fresh lambda restart does more
    # work than deep LM convergence against a stale inlier set), so the
    # default halves the serial depth instead of copying g2o's.
    pose_rounds: int = 4
    pose_iters: int = 5
    local_iters_a: int = 5           # LocalBA first pass (Optimizer.cc:587)
    local_iters_b: int = 10          # LocalBA second pass (Optimizer.cc:619)
    global_iters: int = 20           # GBA (Tracking.cc:2058 uses 20; loop GBA 10)
    pose_graph_iters: int = 40       # OptimizeEssentialGraph (Optimizer.cc:917)
    sim3_iters: int = 10             # OptimizeSim3 stages (Optimizer.cc:976+)
    lm_lambda_init: float = 1e-4
    lm_lambda_factor: float = 10.0
    # local BA runs in chunks of this many LM iterations, checking
    # the mapper's interrupt between chunks (InterruptBA semantics,
    # LocalMapping.cc:97-108) and releasing the map lock during the solve
    abort_chunk: int = 5


@dataclass(frozen=True)
class TrackerConfig:
    """Tracking-thread policy constants (reference: Tracking.cc)."""

    num_secondmap: int = 8           # KFs to fully scale the map (Tracking.h:102)
    num_frame_in_secondmap: int = 5  # cross-cam relocs before 2nd map (Tracking.h:103)
    reloc_gap_try: int = 30          # frames between cross-cam attempts (Tracking.cc:452)
    reloc_gap_fail: int = 50         # backoff after a failure (Tracking.cc:453)
    min_frames_between_kf: int = 0   # KF policy (Tracking.cc:1523-1596)
    max_frames_between_kf: int = 30  # = fps
    min_matches_track: int = 15      # accept tracking if >=15 inliers
    min_matches_motion: int = 20
    local_kf_limit: int = 80         # local-map KF cap (Tracking.cc:1806)
    kf_ref_ratio: float = 0.9        # thRefRatio for mono KF decision
    # dual-scale bootstrap (CreateSecondMapMultical analog).  Once the
    # first cross-reloc succeeds, retry every `reloc_gap_bootstrap` frames
    # to collect orientation-diverse scale anchors quickly; commit the
    # scale when the unbiased pair-LS estimate (scale_opt.bootstrap_scale)
    # reaches relative sigma `scale_rel_sigma`, or unconditionally at
    # `scale_max_anchors` anchors.
    reloc_gap_bootstrap: int = 2
    scale_rel_sigma: float = 0.15
    scale_max_anchors: int = 8
    # fused one-dispatch tracking (frontend.make_track_fn): run the whole
    # per-frame hot path (extract + BoW + motion-model match + widened
    # retry + pose opt + local-map rematch + re-opt) as ONE device
    # program with ONE batched readback.  fused_cap is the fixed padded
    # size of the device-resident local-map store — one size, one compile.
    fused_tracking: bool = True
    fused_cap: int = 2048
    # upload frames as uint8 (4x fewer bytes — decisive on a
    # bandwidth-bound remote transport; quantization measurably thins
    # two-view init on small/low-texture fixtures, so float stays the
    # default and the deployment/bench config opts in)
    images_u8: bool = False
    # deferred-mode pipeline depth: frames per batched dispatch/readback
    # (lax.scan over the fused body).  Depth D divides the per-frame
    # round-trip + dispatch overhead by D at the price of bookkeeping
    # lagging up to 2D-1 frames.  1 = plain lag-1 pipelining.
    pipeline_depth: int = 3


@dataclass(frozen=True)
class MappingConfig:
    """Local-mapping policy (reference: LocalMapping.cc).

    The cross-camera harvest gates default to the reference's constants,
    which assume its 1300-features/camera budget (LocalMapping.cc:622,703,
    745); configs with smaller feature budgets should scale them down
    proportionally."""

    cross_kf_gap: int = 5            # KFs between harvests (LocalMapping.cc:578)
    cross_min_bow: int = 50          # BoW match entry gate (:622)
    cross_min_pose_inliers: int = 10 # first pose-opt gate (:703)
    cross_min_good: int = 70         # acceptance threshold (:745)
    cross_widen_radius: float = 10.0 # first widening window px (:710)
    cross_widen_radius2: float = 3.0 # second, narrower widening (:728)
    two_hop_fuse: bool = True        # SearchInNeighbors 2nd hop (:500-516)
    fuse_chi2: float = 5.991         # reprojection gate for fuse merges
    # MapPointCulling found/visible gate (LocalMapping.cc:221).  The
    # reference's 0.25 assumes its feature budget (1300/cam) comfortably
    # exceeds the visible local-map density; when the budget is smaller
    # than the typically-visible point count, good points structurally sit
    # below 0.25 (only ~n_features of the visible points CAN be found each
    # frame) — scale this gate down accordingly.
    cull_found_ratio: float = 0.25


@dataclass(frozen=True)
class LoopConfig:
    """Loop closing policy (reference: LoopClosing.cc, KeyFrameDatabase.cc)."""

    covisibility_consistency_th: int = 3   # LoopClosing.cc:56
    min_bow_matches: int = 20              # ComputeSim3 entry gate
    min_sim3_inliers: int = 20
    min_total_matches: int = 40            # gate of the projection search
    fix_scale: bool = False                # 7-DoF Sim3 (LoopClosing.h:91)
    loop_kf_gap: int = 10                  # ignore loops w/ recent KFs (LoopClosing.cc:122)


@dataclass(frozen=True)
class VocabConfig:
    """BoW vocabulary tree (reference: DBoW2 TemplatedVocabulary, ORBvoc uses
    branching k=10, depth L=6; we default to a smaller train-on-the-fly tree)."""

    branching: int = 10
    depth: int = 4
    seed: int = 42
    direct_index_level: int = 2      # levels up for FeatureVector (Frame.cc:404 levelsup=4 of 6)


@dataclass(frozen=True)
class CapacityConfig:
    """Static-shape capacities for device stores (no reference equivalent —
    replaces unbounded std::vector growth with rings + masks)."""

    max_keyframes: int = 512
    max_mappoints: int = 16384
    max_obs_per_kf: int = 2048       # padded CSR row width
    max_local_kf: int = 96
    max_local_mp: int = 4096


@dataclass(frozen=True)
class SystemConfig:
    """Top-level engine configuration."""

    cameras: Tuple[CameraConfig, ...] = (CameraConfig(),)
    fps: float = 30.0
    rgb: bool = True
    orb: OrbConfig = field(default_factory=OrbConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    init: InitConfig = field(default_factory=InitConfig)
    ba: BAConfig = field(default_factory=BAConfig)
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    vocab: VocabConfig = field(default_factory=VocabConfig)
    capacity: CapacityConfig = field(default_factory=CapacityConfig)

    @property
    def n_cameras(self) -> int:
        return len(self.cameras)

    def replace(self, **kw) -> "SystemConfig":
        return dataclasses.replace(self, **kw)


def dual_default() -> SystemConfig:
    """A dual-camera rig in the spirit of Dual-LenaCV.yaml: two 640x480
    cameras mounted back-to-back (no shared field of view)."""
    cam0 = CameraConfig()
    # back camera: rotated 180 deg about the y axis, offset 10 cm along z.
    cam1 = CameraConfig(q_sc=(0.0, 0.0, 1.0, 0.0), t_sc=(0.0, 0.0, 0.10))
    return SystemConfig(cameras=(cam0, cam1))
