"""The port's PNG decoder against PIL, and against any library with the
native data path's C ABI, on full-HD frames, on the host CPU.

    python -m video_super_resolution_tpu_torch.tools.bench_png \\
        [--frames 4] [--h 1080 --w 1920] [--reps 3] [--against LIB] \\
        [--root DIR] [--out FILE]

Writes ``--frames`` PNGs of ``detail_clip`` content (seeded) with PIL at
its default compression, then decodes each frame once a rep with:

- ``port``: ``data/native_loader.decode_png``, the self-contained decoder
  of ``csrc/png_decode.h``, to float32 [0, 1];
- ``pil``: PIL's decode to the same float32, the bytes times
  float32(1/255);
- ``against`` (with ``--against``): ``vsr_decode_png`` of the shared
  library at LIB, e.g. ``native/libvsr_dataio.so`` (``make -C native``),
  the JAX package's libpng build of the same C ABI.

``ms_per_frame``: each decoder's best rep, over the frames; every decode
is held bit-equal to the port's (``equal``). ``host``: the host's
architecture, CPU model and count, since these are host times. One JSON
line, also written to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import platform
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from video_super_resolution_tpu_torch.data import native_loader
from video_super_resolution_tpu_torch.data.synthetic import detail_clip

INV255 = np.float32(1.0 / 255.0)       # the C code's byte * (1/255.f)
DEFAULT_ROOT = os.path.join(tempfile.gettempdir(), "vsr_png_bench")


def write_frames(root: str, frames: int, h: int, w: int) -> List[str]:
    """``frames`` PNGs of ``detail_clip(seed=0)`` under ``root``, written
    by PIL at its default settings; files already there are kept."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    paths = [os.path.join(root, f"{h}x{w}_{i:04d}.png") for i in range(frames)]
    if not all(os.path.exists(p) for p in paths):
        clip = detail_clip(frames, h, w, seed=0)
        for p, f in zip(paths, clip):
            Image.fromarray((f * 255.0 + 0.5).astype(np.uint8)).save(p)
    return paths


def pil_decode(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB")) * INV255


def library_decoder(lib_path: str) -> Callable[[str], np.ndarray]:
    """``vsr_decode_png`` of the library at ``lib_path`` (the native data
    path's C ABI): path -> float32 (H, W, 3)."""
    lib = ctypes.CDLL(os.path.abspath(lib_path))
    fp = ctypes.POINTER(ctypes.c_float)
    lib.vsr_decode_png.restype = fp
    lib.vsr_decode_png.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int)]
    lib.vsr_free.restype = None
    lib.vsr_free.argtypes = [ctypes.c_void_p]

    def decode(path: str) -> np.ndarray:
        h, w = ctypes.c_int(), ctypes.c_int()
        ptr = lib.vsr_decode_png(os.fsencode(path), ctypes.byref(h),
                                 ctypes.byref(w))
        if not ptr:
            raise IOError(f"{lib_path}: decode failed: {path}")
        try:
            return np.ctypeslib.as_array(ptr, shape=(h.value, w.value, 3)).copy()
        finally:
            lib.vsr_free(ptr)

    return decode


def host_label() -> str:
    """The host's architecture, CPU model where /proc/cpuinfo names one,
    and CPU count."""
    label = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            names = [ln.split(":", 1)[1].strip() for ln in f
                     if ln.startswith("model name")]
        if names:
            label += f" {names[0]}"
    except OSError:
        pass
    return f"{label} x {os.cpu_count()}"


def run(frames: int = 4, h: int = 1080, w: int = 1920, reps: int = 3,
        against: Optional[str] = None, root: str = DEFAULT_ROOT,
        out: Optional[str] = None,
        emit: Callable[[str], None] = print) -> dict:
    paths = write_frames(root, frames, h, w)
    decoders: Dict[str, Callable[[str], np.ndarray]] = {
        "port": native_loader.decode_png, "pil": pil_decode}
    if against:
        decoders["against"] = library_decoder(against)
    ref = [native_loader.decode_png(p) for p in paths]
    best = {name: float("inf") for name in decoders}
    equal = True
    for _ in range(reps):
        for name, decode in decoders.items():
            t0 = time.perf_counter()
            got = [decode(p) for p in paths]
            best[name] = min(best[name], (time.perf_counter() - t0) / frames)
            equal &= all(np.array_equal(a, b) for a, b in zip(got, ref))
    rec = {"frames": frames, "h": h, "w": w, "reps": reps,
           "bytes_per_frame": int(np.mean([os.path.getsize(p) for p in paths])),
           "ms_per_frame": {k: v * 1e3 for k, v in best.items()},
           "against": against, "equal": bool(equal), "host": host_label()}
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(rec, f, indent=2)
    emit(json.dumps(rec))
    return rec


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--h", type=int, default=1080)
    ap.add_argument("--w", type=int, default=1920)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--against", help="a library with vsr_decode_png")
    ap.add_argument("--root", default=DEFAULT_ROOT, help="PNG frames")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    rec = run(args.frames, args.h, args.w, args.reps, args.against, args.root,
              args.out)
    return 0 if rec["equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
