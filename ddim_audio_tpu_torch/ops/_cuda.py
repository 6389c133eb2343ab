"""Build and load the hand-written CUDA kernels (``ddim_audio_tpu_torch/csrc``).

The kernels are compiled with ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with ``ctypes``. The build
runs at first use, from the package's own sources, into
``ddim_audio_tpu_torch/build/`` (ignored by git); the library's file name
carries a hash of the sources, so an edited kernel is rebuilt and a stale
library is never loaded. Nothing here runs at import time: the CPU tests
import every module of the port on machines with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ddim_conv3x3_tiles": (_I,) * 4,
    "ddim_conv_down_tiles": (_I,) * 5,
    "ddim_conv_up_tiles": (_I,) * 5,
    # x, res, pre_scale, pre_shift, w, add, out, stats,
    # B, T, F, C, pre_silu, post_silu, bf16, stream
    "ddim_conv3x3": (_P,) * 8 + (_I,) * 7 + (_P,),
    # x, w, bias, out, stats, B, T, F, Cin, Cout, bf16, stream
    "ddim_conv_down": (_P,) * 5 + (_I,) * 6 + (_P,),
    # x, w, bias, res, out, stats, B, T, F, Cin, Cout, bf16, stream
    "ddim_conv_up": (_P,) * 6 + (_I,) * 6 + (_P,),
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "cannot be built")


def build() -> tuple[Path, float, str]:
    """Compile the kernels if the library for the current sources is absent.
    Returns (library path, build seconds (0.0 when cached), nvcc output)."""
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib = BUILD_DIR / f"libddim_kernels_{digest.hexdigest()[:12]}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, lib)
    return lib, seconds, log


@functools.lru_cache(maxsize=1)
def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    return lib


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def stream_ptr(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def require_cuda_dtype(t: torch.Tensor, name: str) -> int:
    """1 for bf16, 0 for fp32; raises for any other dtype."""
    if t.dtype == torch.bfloat16:
        return 1
    if t.dtype == torch.float32:
        return 0
    raise TypeError(f"{name}: the CUDA kernel takes float32 or bfloat16, "
                    f"got {t.dtype}")


def check_operand(t: torch.Tensor | None, name: str, *, device, dtype=None,
                  shape=None) -> None:
    if t is None:
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (the "
                         "kernels move 16 bytes per access)")

