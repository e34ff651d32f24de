from video_super_resolution_tpu_torch.data.dataset import (  # noqa: F401
    ClipDataset,
    sliding_window_indices,
)
from video_super_resolution_tpu_torch.data.synthetic import (  # noqa: F401
    moving_gradient_clip,
    synthetic_clip_pair,
)
