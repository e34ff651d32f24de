"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``) into
an object, all files at once in parallel, and the objects are linked into
one shared library with a plain C interface, loaded with ``ctypes``. The
library lives in ``_build/<hash>/`` inside the package, keyed by a hash of
the sources and flags, so an edited kernel is rebuilt and an unchanged one
is loaded as it is. Nothing here runs at import time: the first wrapper
call on a CUDA tensor builds and loads the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libvsr_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every kernel entry returns cudaGetLastError() after its
# launch, the capture probe its CUDA error code
_SIGNATURES = {
    # x, w (prepared), bias (f32), res, out, split-K workspace, staging
    # scratch, fold, B, H, W, Cin, Cx, Cout, Npad, bn, kc, tw, splits,
    # dilation, slope, res_repeat, res_is_f32, is_bf16, stream
    "vsr_conv3x3": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                    _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    # f1, f2, out, B, H, W, C, d, is_bf16, slope, has_slope, out_bf16,
    # stream
    "vsr_correlation": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    # img, flow (f32), out, B, H, W, C, zeros_padding, is_bf16, stream
    "vsr_warp": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # stream, out: nodes captured so far into the graph it is capturing
    "vsr_captured_nodes": [_P, ctypes.POINTER(ctypes.c_ulonglong)],
}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def build() -> Path:
    """Compile the sources (if this hash is not built yet); return the path
    of the shared library. Raises with nvcc's output on a failed build."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        objs = []
        for src in [p for p in sources() if p.suffix == ".cu"]:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = {}
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs[src.name] = out
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            msg = "\n".join(f"--- {n}\n{logs[n]}" for n in failed)
            raise RuntimeError(f"nvcc failed for {failed}:\n{msg}")
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)       # atomic: concurrent builds agree
    (out_dir / "ptxas.log").write_text(
        "\n".join(f"--- {n}\n{t}" for n, t in logs.items()))
    build_info.update(path=str(lib_path), cached=False,
                      seconds=time.perf_counter() - t0,
                      ptxas={n: t for n, t in logs.items()})
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            cdll = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(cdll, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = cdll
    return _lib


def check_launch(name: str, rc: int) -> None:
    """Raise if a kernel's C entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def captured_nodes(stream) -> int:
    """Nodes captured so far into the CUDA graph that ``stream`` (a
    ``torch.cuda.Stream``) is capturing; 0 when it captures nothing."""
    count = ctypes.c_ulonglong(0)
    check_launch("captured_nodes", lib().vsr_captured_nodes(
        stream.cuda_stream, ctypes.byref(count)))
    return count.value


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: tensors must share one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
