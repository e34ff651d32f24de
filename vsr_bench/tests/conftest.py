"""Shared tiny sizes of the benchmark's CPU tests: the cells' widths cut
to a few channels, frames of a few dozen pixels."""

import pytest
import torch

TINY_MODEL = dict(pyramid_channels=[8, 16], flow_estimator_channels=[16, 16],
                  context_channels=[16, 16], depth_channels=8, depth_levels=2,
                  fusion_channels=16, sr_channels=16, sr_blocks=2)
TINY = {"model": TINY_MODEL, "train": {"compute_dtype": "float32"}}
SMALL = {
    "clip": dict(lr_h=32, lr_w=48, clip_frames=[3, 5], pool_clips=3,
                 warm_clips=1, warm_frames=3, check_frames=3),
    "live": dict(lr_h=32, lr_w=48, rate_fps=20, pool_clips=2, clip_frames=6,
                 warm_frames=2, check_frames=3),
    "train_step": dict(batch=2, crop=16, pool_batches=4, source_clips=2,
                       source_hw=[96, 128], checked_steps=3, warm_steps=1),
}


class EmptyProfile:
    """A ``torch.profiler.profile`` that traced nothing, for building a
    ``run.Traced`` to read its ``work()`` alone."""

    def events(self):
        return iter(())

    class profiler:
        class kineto_results:
            @staticmethod
            def events():
                return []

            @staticmethod
            def trace_start_ns():
                return 0


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
