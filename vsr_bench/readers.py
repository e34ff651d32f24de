"""What several per-layer metrics read alike, from a ``run.Traced``:
shares of the device's time and of its peak."""

from __future__ import annotations

import re
from typing import Optional

from vsr_bench import roofline, trace

# device kernels that compute a convolution, whatever implements it: the
# port's conv3x3 kernels (csrc/conv3x3.cu) and library convolutions and
# GEMMs (cuDNN, CUTLASS, cuBLAS; the model's few-output-channel 3x3 convs
# run as a matmul plus shifted adds)
CONV_KERNEL = re.compile(r"conv3x3|cudnn|xmma|cutlass|gemm|conv2d|fprop|"
                         r"implicit|dgrad|wgrad", re.IGNORECASE)


def memcpy_ms(t) -> Optional[float]:
    """ms a unit of the device's host-to-device and device-to-host copies."""
    if not t.on_card or not t.units:
        return None
    return sum(e.dur for e in t.events if trace.COPY.search(e.name)) / 1e3 / t.units


def conv_roofline(t) -> Optional[float]:
    """% of their roofline the convolutions reach: the least time of every
    3x3 conv of the reference's forward a unit over the device time of the
    trace's convolution kernels (``CONV_KERNEL``) a unit."""
    if not t.on_card or not t.units:
        return None
    us = sum(e.dur for e in t.events if CONV_KERNEL.search(e.name))
    if us <= 0:
        return None
    return 100.0 * t.work()["conv_floor_ms"] * t.units / (us / 1e3)


def idle_share(t) -> Optional[float]:
    """% of the traced window in which no kernel or copy ran."""
    if not t.on_card or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us() / 1e6 / t.window_s)


def mfu(t) -> Optional[float]:
    """% of the H100's bf16 dense peak: the reference's operations a unit
    of work (FlopCounterMode, meta device) times the units the traced
    window did a second."""
    if not t.on_card or t.window_s <= 0 or not t.units:
        return None
    rate = t.units / t.window_s
    return 100.0 * t.work()["flops"] * rate / roofline.H100["bf16_flops"]


def mfu_busy(t) -> Optional[float]:
    """% of the H100's bf16 dense peak while the device is busy: the
    reference's operations a unit over the device's busy time a unit."""
    ms = busy_ms(t)
    if not ms:
        return None
    return 100.0 * t.work()["flops"] / (ms / 1e3) / roofline.H100["bf16_flops"]


def busy_ms(t) -> Optional[float]:
    """ms of device busy time (the union of kernels and copies) a unit."""
    if not t.on_card or not t.units:
        return None
    return t.busy_us() / 1e3 / t.units


def span_ms(t, names) -> Optional[float]:
    """ms a unit of the device timeline under the program's named ranges;
    nothing where the trace holds none of them."""
    if not t.on_card or not t.units:
        return None
    us = t.spans_us(names)
    return us / 1e3 / t.units if us > 0 else None
