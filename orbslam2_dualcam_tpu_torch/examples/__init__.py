"""Measurement and evaluation scripts of the port, run as modules:
``python -m orbslam2_dualcam_tpu_torch.examples.bench_dist_ba`` and
``python -m orbslam2_dualcam_tpu_torch.examples.eval_tum``."""
