from obvi_slam_tpu_torch.frontend.visual_features import VisualFeatureFrontend  # noqa: F401
