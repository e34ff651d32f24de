"""PyTorch/CUDA port of the video super-resolution framework.

The serving forward (every model option), training, data pipeline,
evaluation and CLI of the JAX package (``video_super_resolution_tpu``), on
NVIDIA Hopper with hand-written CUDA kernels for the fused 3x3 conv, the
cost-volume correlation and the backward warp (``csrc/``), each
differentiable through an autograd Function. NHWC activations and
(B, T, H, W, 3) windows, as in the JAX package. Entry points are in
``api``, ``training`` and ``cli``; they run on the GPU unless
``device="cpu"`` is passed.
"""

from video_super_resolution_tpu_torch.config import (
    ModelConfig,
    VSRConfig,
    serving_config,
)

__all__ = ["ModelConfig", "VSRConfig", "serving_config"]
