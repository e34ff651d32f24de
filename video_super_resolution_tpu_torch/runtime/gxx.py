"""Build the port's host-side C++ libraries with ``g++``.

A library is one C++ source, and the headers it includes, with a plain C
interface, loaded with ``ctypes`` (no ``Python.h``). It is compiled into
``<build_root>/<name>-<hash>/lib<source stem>.so``, keyed by a hash of the
flags and the sources, as ``ops/_build.py`` builds the CUDA kernels, so an
edited source is rebuilt and an unchanged one loaded as it is. A missing
``g++``, or a failed compile or link, raises with what went wrong.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence


def build(build_root: Path, name: str, source: Path, headers: Sequence[Path],
          cxxflags: Sequence[str], ldflags: Sequence[str]) -> Path:
    """Compile ``source`` if these sources and flags are not built yet;
    return the library's path."""
    if not shutil.which("g++"):
        raise RuntimeError(f"cannot build {source.name}: missing g++")
    h = hashlib.sha256(" ".join([*cxxflags, *ldflags]).encode())
    for p in (source, *headers):
        h.update(p.read_bytes())
    lib_name = f"lib{source.stem}.so"
    out_dir = build_root / f"{name}-{h.hexdigest()[:16]}"
    lib_path = out_dir / lib_name
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_lib = Path(tmp) / lib_name
        proc = subprocess.run(
            ["g++", *cxxflags, "-o", str(tmp_lib), str(source), *ldflags],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {source.name}:\n"
                               f"{proc.stdout}")
        os.replace(tmp_lib, lib_path)       # atomic: concurrent builds agree
    return lib_path
