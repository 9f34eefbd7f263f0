"""Build ``csrc/*.cu`` with ``nvcc`` at first use and load the library with ctypes.

Each source compiles to an object in its own ``nvcc`` process, all started
together; one more ``nvcc`` links them into ``build/libquan_torch_kernels.so``
beside the package (`utils.native_build.locked_build`: once, keyed by a hash
of the sources and flags, under a file lock). The library has a plain C
interface, so no PyTorch header is compiled.

The launchers that `torch.export` must capture are registered as operators of
the ``quan_torch`` namespace (`register_op`): a CUDA implementation (the
launcher, which calls the library) and a fake one that gives the output's
shape and dtype, so that tracing with fake tensors needs no card. Each
kernel's Python wrapper checks and lays out the inputs once (`check_device`
and the module's own checks) and calls the operator, whose CUDA
implementation only launches; the call costs one pass through PyTorch's
dispatcher, with no ``custom_op`` wrapper around it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Optional

import torch

from quan_ultralytics_tpu_torch.utils.native_build import BUILD_DIR, locked_build

CSRC = Path(__file__).resolve().parents[2] / "csrc"
LIB_NAME = "libquan_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

NAMESPACE = "quan_torch"  # the operators' namespace: torch.ops.quan_torch.<name>
_ops = torch.library.Library(NAMESPACE, "FRAGMENT")

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of the last build in this process
build_log = ""  # nvcc's output of that build (register and shared-memory use)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _run(procs):
    global build_log
    for cmd, proc in procs:
        out, _ = proc.communicate()
        build_log += out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")


def _compile_to(lib_path: Path) -> None:
    global build_seconds, build_log
    t0 = time.perf_counter()
    build_log = ""
    nvcc = _nvcc()
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
        objs.append(str(obj))
    _run(procs)
    cmd = [nvcc, "-shared", "-o", str(lib_path), *objs]
    _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))])
    build_seconds = time.perf_counter() - t0


def build() -> Path:
    """Compile the kernels if the sources changed since the last build; return the library path."""
    return locked_build(BUILD_DIR, LIB_NAME, _digest(), _compile_to)


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    for fn in (lib.qattn_fwd_bf16, lib.qattn_fwd_f32):
        fn.argtypes = [vp] * 5 + [i32, i32, i32, i32, f32, i32, vp]
    lib.qattn_bwd_bf16.argtypes = [vp] * 10 + [i32, i32, i32, i32, f32, f32, i32, vp]
    lib.qattn_bwd_f32.argtypes = [vp] * 9 + [i32, i32, i32, i32, f32, f32, i32, vp]
    for fn in (lib.qconv1x1_mma_bf16, lib.qconv1x1_simt_f32):
        fn.argtypes = [vp] * 5 + [i64, i32, i32, i32, i32, vp]
    for fn in (lib.qattn_fwd_bf16, lib.qattn_fwd_f32, lib.qattn_bwd_bf16, lib.qattn_bwd_f32,
               lib.qconv1x1_mma_bf16, lib.qconv1x1_simt_f32):
        fn.restype = i32
    lib.quan_error_string.argtypes = [i32]
    lib.quan_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        _declare(lib)
        _lib = lib
    return _lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        msg = library().quan_error_string(status).decode()
        raise RuntimeError(f"{what} failed: CUDA error {status} ({msg})")


def check_device(what: str, *ts: torch.Tensor) -> None:
    """Raise unless ``ts`` lie on one device that the operators take: a CUDA
    device, or the meta device (shapes only, as `torch.export` may trace)."""
    dev = ts[0].device
    if dev.type not in ("cuda", "meta") or any(t.device != dev for t in ts):
        raise ValueError(f"{what} must lie on one CUDA device, got {', '.join(str(t.device) for t in ts)}")


def register_op(schema: str, cuda_impl: Callable, fake_impl: Callable):
    """Define ``quan_torch::<name>`` by ``schema`` with ``cuda_impl`` for CUDA
    tensors and ``fake_impl`` for fake and meta ones; returns the operator's
    overload (``torch.ops.quan_torch.<name>.default``)."""
    name = schema.split("(", 1)[0]
    _ops.define(schema)
    _ops.impl(name, cuda_impl, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake_impl, lib=_ops)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
