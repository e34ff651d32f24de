"""Host memory for the serving entry's returned clip, recycled.

A 4K f32 frame is 99.5 MB. Written into fresh pages from ``np.empty``,
each page faults on first touch, and the write costs about five times the
copy into pages already touched. ``empty`` allocates through a numpy
memory handler (NEP 49, ``csrc/vsr_hostmem.cc``) that keeps one idle
block: the largest block freed so far of at least ``vsr_hostmem_floor``
(64 MiB). A request that fits in it takes it, pages already faulted; any
other goes to numpy's default handler, as ``np.empty`` would. numpy frees
an array's data only when no view or export of it is alive, so a block is
reused only after its array is gone. A caller that keeps every clip gets
a fresh block each time.

The handler is set only around ``empty``'s one ``np.empty``, in the
current context (numpy keeps it in a context variable), and restored
after it: every other array keeps numpy's default handler. It is
installed with ``ctypes`` alone, through numpy's C API table
(``_ARRAY_API``); the library is built with ``g++`` at first use
(``runtime/gxx.py``). The idle block costs at most the largest clip
served, until ``release`` gives it back.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

try:                                            # numpy >= 2
    from numpy._core import _multiarray_umath as _npcore
except ImportError:                             # numpy 1.22 - 1.26
    from numpy.core import _multiarray_umath as _npcore

from video_super_resolution_tpu_torch.runtime import gxx

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "vsr_hostmem.cc"
BUILD_ROOT = _PKG / "_build"
CXXFLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall"]
LDFLAGS = ["-shared"]
# numpy's C API table (numpy/__multiarray_api.h, numpy >= 1.22)
_SET_HANDLER, _DEFAULT_HANDLER = 304, 306

_lock = threading.Lock()
_lib = None
_capsule = None                 # the handler, as numpy's "mem_handler" capsule
_set_handler = None             # PyDataMem_SetHandler


def load() -> ctypes.CDLL:
    """Build and load the library; make its handler's capsule."""
    global _lib, _capsule, _set_handler
    with _lock:
        if _lib is None:
            py, obj, vp = ctypes.pythonapi, ctypes.py_object, ctypes.c_void_p
            lib = ctypes.CDLL(str(gxx.build(BUILD_ROOT, "hostmem", SOURCE, [],
                                            CXXFLAGS, LDFLAGS)))
            lib.vsr_hostmem_init.restype = vp
            lib.vsr_hostmem_init.argtypes = [vp, ctypes.POINTER(vp)]
            lib.vsr_hostmem_stats.restype = None
            lib.vsr_hostmem_stats.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
            lib.vsr_hostmem_release.restype = None
            lib.vsr_hostmem_release.argtypes = []
            get_pointer = ctypes.PYFUNCTYPE(vp, obj, ctypes.c_char_p)(
                ("PyCapsule_GetPointer", py))
            new_capsule = ctypes.PYFUNCTYPE(obj, vp, vp, vp)(
                ("PyCapsule_New", py))
            table = ctypes.cast(get_pointer(_npcore._ARRAY_API, None),
                                ctypes.POINTER(vp))
            default = ctypes.cast(table[_DEFAULT_HANDLER],
                                  ctypes.POINTER(obj)).contents.value
            name = vp()
            handler = lib.vsr_hostmem_init(
                get_pointer(default, b"mem_handler"), ctypes.byref(name))
            # the name and the handler are static in the library, which is
            # never unloaded: they outlive every array the capsule frees
            _capsule = new_capsule(handler, name, None)
            _set_handler = ctypes.PYFUNCTYPE(obj, obj)(table[_SET_HANDLER])
            _lib = lib
    return _lib


def empty(shape: Tuple[int, ...], dtype=np.float32) -> Tuple[np.ndarray, bool]:
    """``np.empty(shape, dtype)`` through the recycler, and whether its
    block was the idle one (pages already faulted)."""
    hits = stats()[2]
    previous = _set_handler(_capsule)
    try:
        out = np.empty(shape, dtype)
    finally:
        _set_handler(previous)
    return out, stats()[2] > hits


def stats() -> Tuple[int, int, int]:
    """(bytes of the idle block, 0 for none; blocks lent to live arrays;
    requests the idle block has served)."""
    out = (ctypes.c_ulonglong * 3)()
    load().vsr_hostmem_stats(out)
    return tuple(out)


def release() -> None:
    """Give the idle block back to numpy's default handler."""
    load().vsr_hostmem_release()
