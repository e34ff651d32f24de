"""What the benchmark's tests share: an empty profile and the card
fixture. The tiny sizes of the CPU runs are files under ``sizes/``
(``bodies.py``)."""

import pytest
import torch


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
