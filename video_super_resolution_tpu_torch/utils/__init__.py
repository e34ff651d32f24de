from video_super_resolution_tpu_torch.utils.logging import MetricsLogger  # noqa: F401
