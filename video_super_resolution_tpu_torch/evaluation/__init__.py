from video_super_resolution_tpu_torch.evaluation.evaluate import (  # noqa: F401
    evaluate_all,
    evaluate_clip,
)
from video_super_resolution_tpu_torch.evaluation.metrics import (  # noqa: F401
    psnr,
    rgb_to_y,
    ssim,
)
