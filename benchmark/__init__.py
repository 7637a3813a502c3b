"""The benchmark of obvi_slam_tpu_torch on the GPU (see benchmark/README in PERF.md)."""
