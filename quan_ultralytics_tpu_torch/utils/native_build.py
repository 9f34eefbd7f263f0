"""Build a shared library at first use, once, under a file lock.

The port's native code (the CUDA kernels in ``csrc/``, the image reader and
the augmentations' pixel work in ``data/native/``) is compiled when first called into ``build/`` at the
repository root. A hash of the sources and flags, stored beside the library,
decides whether it is rebuilt; a file lock keeps concurrent processes from
building at once; the library is written to a temporary file of this process
and moved into place, so no process loads a half-written one.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Sequence

BUILD_DIR = Path(__file__).resolve().parents[2] / "build"


def locked_build(build_dir: Path, lib_name: str, digest: str,
                 compile_to: Callable[[Path], None]) -> Path:
    """``build_dir / lib_name``, compiled by ``compile_to(tmp_path)`` unless the
    library there was built from sources with this ``digest``."""
    build_dir.mkdir(parents=True, exist_ok=True)
    lib_path = build_dir / lib_name
    stamp = build_dir / (lib_name + ".sha256")
    with open(build_dir / (lib_name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
            return lib_path
        tmp = build_dir / (lib_name + f".{os.getpid()}.tmp")
        compile_to(tmp)
        os.replace(tmp, lib_path)
        stamp.write_text(digest)
    return lib_path


def build_cxx(source: Path, lib_name: str, flags: Sequence[str], build_dir: Path = BUILD_DIR,
              depends: Sequence[Path] = ()) -> Path:
    """``build_dir / lib_name`` compiled from the one C++ file ``source`` by
    ``g++ flags``, rebuilt when the source, the files it includes
    (``depends``) or the flags change. A missing compiler raises."""

    def compile_to(lib_path: Path) -> None:
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError(f"g++ not found: {source.name} is C++ built at first use")
        cmd = [cxx, *flags, str(source), "-o", str(lib_path)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")

    digest = hashlib.sha256(" ".join(flags).encode() + b"".join(
        p.read_bytes() for p in (source, *depends))).hexdigest()
    return locked_build(build_dir, lib_name, digest, compile_to)
