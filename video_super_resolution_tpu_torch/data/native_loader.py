"""ctypes bindings for the native C++ data path (``native/vsr_dataio.cc``),
with the JAX package's ``data/native_loader.py`` API: libpng decode,
MATLAB-bicubic degradation, crop/flip/window assembly and a pthread
prefetch pool feeding bounded batches.

The C++ source is the repository's own, unchanged. At first use it is
compiled with ``g++`` and the flags of ``native/Makefile`` into
``_build/dataio-<hash>/libvsr_dataio.so`` inside this package
(git-ignored), keyed
by a hash of the source and the flags, as ``ops/_build.py`` builds the
CUDA kernels. ``missing()`` names what the build needs and the machine
lacks (``g++``, ``png.h``); ``available()`` is True when nothing is
missing. With the tools present, a failed compile or link raises with
g++'s output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "vsr_dataio.cc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libvsr_dataio.so"
# native/Makefile's CXXFLAGS and LDFLAGS
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]
LDFLAGS = ["-shared", "-lpng", "-lz", "-lpthread"]

_FP = ctypes.POINTER(ctypes.c_float)
_lock = threading.Lock()
_lib = None


@functools.lru_cache(maxsize=1)
def missing() -> Tuple[str, ...]:
    """What building the library needs and this machine lacks: ``g++``,
    or ``png.h`` (libpng's header, looked up by g++'s preprocessor)."""
    gxx = shutil.which("g++")
    if gxx is None:
        return ("g++",)
    probe = subprocess.run([gxx, "-E", "-x", "c++", "-", "-o", os.devnull],
                           input="#include <png.h>\n", capture_output=True,
                           text=True)
    return () if probe.returncode == 0 else ("png.h",)


def available() -> bool:
    return not missing()


def build() -> Path:
    """Compile the library if this source and these flags are not built
    yet; return its path. Raises with g++'s output on failure."""
    if missing():
        raise RuntimeError(f"cannot build {SOURCE.name}: missing "
                           f"{', '.join(missing())}")
    h = hashlib.sha256(" ".join(CXXFLAGS + LDFLAGS).encode())
    h.update(SOURCE.read_bytes())
    out_dir = BUILD_ROOT / ("dataio-" + h.hexdigest()[:16])
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_lib = Path(tmp) / LIB_NAME
        proc = subprocess.run(
            ["g++", *CXXFLAGS, "-o", str(tmp_lib), str(SOURCE), *LDFLAGS],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n"
                               f"{proc.stdout}")
        os.replace(tmp_lib, lib_path)       # atomic: concurrent builds agree
    return lib_path


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.vsr_decode_png.restype = _FP
            lib.vsr_decode_png.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int)]
            lib.vsr_free.restype = None
            lib.vsr_free.argtypes = [ctypes.c_void_p]
            lib.vsr_resize_bicubic_aa.restype = None
            lib.vsr_resize_bicubic_aa.argtypes = [
                _FP, ctypes.c_int, ctypes.c_int, _FP, ctypes.c_int,
                ctypes.c_int]
            lib.vsr_loader_create.restype = ctypes.c_void_p
            lib.vsr_loader_create.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64]
            lib.vsr_loader_next.restype = ctypes.c_int
            lib.vsr_loader_next.argtypes = [ctypes.c_void_p, _FP, _FP]
            lib.vsr_loader_destroy.restype = None
            lib.vsr_loader_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


def decode_png(path: str) -> np.ndarray:
    """One PNG as float32 RGB in [0, 1], (H, W, 3)."""
    lib = _load()
    h, w = ctypes.c_int(), ctypes.c_int()
    ptr = lib.vsr_decode_png(os.fsencode(path), ctypes.byref(h),
                             ctypes.byref(w))
    if not ptr:
        raise IOError(f"native PNG decode failed: {path}")
    try:
        return np.ctypeslib.as_array(ptr, shape=(h.value, w.value, 3)).copy()
    finally:
        lib.vsr_free(ptr)


def resize_bicubic_aa(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """MATLAB-preset antialias bicubic downscale of (H, W, 3) float32,
    clamped to [0, 1]."""
    lib = _load()
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"resize_bicubic_aa: img {img.shape} must be (H, W, 3)")
    h, w, _ = img.shape
    out = np.empty((oh, ow, 3), np.float32)
    lib.vsr_resize_bicubic_aa(img.ctypes.data_as(_FP), h, w,
                              out.ctypes.data_as(_FP), oh, ow)
    return out


class NativeClipLoader:
    """Threaded sliding-window training loader over PNG clip directories
    (HR frames; LR degraded on the fly). Iterates {"lr": (B, T, c, c, 3),
    "hr": (B, c*s, c*s, 3)} float32 batches; ``close`` stops its threads."""

    def __init__(self, clips: Dict[str, List[str]], window: int = 3,
                 scale: int = 4, crop_size: int = 64, batch_size: int = 4,
                 augment: bool = True, num_workers: int = 4, seed: int = 0):
        lib = _load()
        paths: List[bytes] = []
        sizes: List[int] = []
        for name in sorted(clips):
            sizes.append(len(clips[name]))
            paths.extend(os.fsencode(p) for p in clips[name])
        # the C++ copies the paths at create; these arrays need not outlive it
        arr = (ctypes.c_char_p * len(paths))(*paths)
        szs = (ctypes.c_int * len(sizes))(*sizes)
        self._lib = lib
        self._handle = lib.vsr_loader_create(
            arr, szs, len(sizes), window, scale, crop_size, batch_size,
            int(augment), num_workers, seed)
        self.window = window
        self.scale = scale
        self.crop = crop_size
        self.batch = batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if not self._handle:
            raise StopIteration
        c, s, t, b = self.crop, self.scale, self.window, self.batch
        lr = np.empty((b, t, c, c, 3), np.float32)
        hr = np.empty((b, c * s, c * s, 3), np.float32)
        n = self._lib.vsr_loader_next(self._handle, lr.ctypes.data_as(_FP),
                                      hr.ctypes.data_as(_FP))
        if n == 0:
            raise StopIteration
        return {"lr": lr, "hr": hr}

    def close(self) -> None:
        if self._handle:
            self._lib.vsr_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()
