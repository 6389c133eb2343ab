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

import contextlib
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ddim_conv3x3_tiles": (_I,) * 4,
    "ddim_conv3x3_variant": (_I,) * 4,
    # T, F, C, bf16, B, out[8] (ops/tile_plan.py)
    "ddim_conv3x3_plan": (_I,) * 5 + (_P,),
    "ddim_conv_down_tiles": (_I,) * 5,
    "ddim_conv_down_variant": (_I,) * 5,
    # T, F, Cin, Cout, bf16, B, out[8]
    "ddim_conv_down_plan": (_I,) * 6 + (_P,),
    "ddim_conv_up_tiles": (_I,) * 5,
    "ddim_conv_up_variant": (_I,) * 5,
    # T, F, Cin, Cout, bf16, B, out[8]
    "ddim_conv_up_plan": (_I,) * 6 + (_P,),
    "ddim_conv3x3_int8_tiles": (_I,) * 2,
    "ddim_conv3x3_int8_geometry": (_I,),
    # T, F, C, bf16, B, out[8]
    "ddim_conv3x3_int8_plan": (_I,) * 5 + (_P,),
    # T, F, Cin, C0, bf16, B, out[8]
    "ddim_conv_head_plan": (_I,) * 6 + (_P,),
    "ddim_conv_head_variant": (_I,) * 5,
    # T, F, C0, Cout, bf16, B, out[8]
    "ddim_conv_tail_plan": (_I,) * 6 + (_P,),
    "ddim_conv_tail_variant": (_I,) * 5,
    # mode, B, T, F, Cin, Cout, bf16
    "ddim_conv_dw_splits": (_I,) * 7,
    # x, g, part, mode, B, T, F, Cin, Cout, bf16, stream
    "ddim_conv_dw": (_P,) * 3 + (_I,) * 7 + (_P,),
    # x, res, pre_scale, pre_shift, w, add, out, stats,
    # B, T, F, C, pre_silu, post_silu, bf16, stream
    "ddim_conv3x3": (_P,) * 8 + (_I,) * 7 + (_P,),
    # x, res, pre_scale, pre_shift, wq_t, w_scale, add, out, stats,
    # B, T, F, C, pre_silu, post_silu, bf16, stream
    "ddim_conv3x3_int8": (_P,) * 9 + (_I,) * 7 + (_P,),
    # x, w, bias, out, stats, B, T, F, Cin, C0, bf16, stream
    "ddim_conv_head": (_P,) * 5 + (_I,) * 6 + (_P,),
    # h, res, w, bias, out, B, T, F, C0, Cout, bf16, stream
    "ddim_conv_tail": (_P,) * 5 + (_I,) * 6 + (_P,),
    # x, w, bias, out, stats, B, T, F, Cin, Cout, bf16, stream
    "ddim_conv_down": (_P,) * 5 + (_I,) * 6 + (_P,),
    # x, w, bias, res, out, stats, B, T, F, Cin, Cout, bf16, stream
    "ddim_conv_up": (_P,) * 6 + (_I,) * 6 + (_P,),
    "ddim_store_geometry": (_I,),
    # T, F, C, bf16, B, int8 operands (x, residual), out[8]
    "ddim_conv3x3_store_plan": (_I,) * 6 + (_P,),
    # T, F, C, x kind, s kind, B, out[8]
    "ddim_residual_affine_plan": (_I,) * 6 + (_P,),
    # x, x_scales, res, res_scales, pre_scale, pre_shift, w, add, out,
    # out_scales, stats, B, T, F, C, x_q, res_q, pre_silu, post_silu, bf16,
    # stream
    "ddim_conv3x3_store": (_P,) * 11 + (_I,) * 9 + (_P,),
    # x, x_scales, s, s_scales, scale, shift, out, out_scales, stats,
    # B, T, F, C, x_kind, s_kind, out_kind (0 fp32, 1 bf16, 2 int8), stream
    "ddim_residual_affine": (_P,) * 9 + (_I,) * 7 + (_P,),
    "ddim_strided_int8_geometry": (_I,),
    # x, wq, wq_t, w_scale, bias, out, stats, B, T, F, Cin, Cout, bf16,
    # stream
    "ddim_conv_down_int8": (_P,) * 7 + (_I,) * 6 + (_P,),
    # T, F, Cin, Cout, bf16, B, out[8]
    "ddim_conv_down_int8_plan": (_I,) * 6 + (_P,),
    # x's T, F, Cin, Cout, bf16, B, out[8]
    "ddim_conv3x3_dw_plan": (_I,) * 6 + (_P,),
    "ddim_conv_down_dw_plan": (_I,) * 6 + (_P,),
    "ddim_conv_up_dw_plan": (_I,) * 6 + (_P,),
    "ddim_dw_tf32_threads": (_I,),
    # x, wq_t, w_scale, bias, res, out, stats, B, T, F, Cin, Cout, bf16,
    # stream
    "ddim_conv_up_int8": (_P,) * 7 + (_I,) * 6 + (_P,),
    # T, F, Cin, Cout, bf16, B, out[8]
    "ddim_conv_up_int8_plan": (_I,) * 6 + (_P,),
    # x, out, B, N, K, squares, bf16, rows, stream
    "ddim_batch_sums": (_P,) * 2 + (_I,) * 6 + (_P,),
    # out[5]: leaves a tree, elements a chunk, groups, clip groups,
    # sizeof(Config)
    "ddim_train_update_limits": (_P,),
    # grads, leaves, chunks, chunks, config, partials, stream
    "ddim_train_update_norm": (_P, _I, _P, _I, _P, _P, _P),
    # partials, chunks, leaf meta, chunks, config, norms, stream
    "ddim_train_update_norm_finish": (_P,) * 3 + (_I,) + (_P,) * 3,
    # pointers [5, leaves], leaves, chunks, chunks, leaf meta, config, p, m,
    # v, ema out, norms, partials, stream
    "ddim_train_update_apply": (_P, _I, _P, _I) + (_P,) * 9,
    # partials, leaf meta, leaves, config, leaf norms, update norms, stream
    "ddim_train_update_finish": (_P, _P, _I) + (_P,) * 4,
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
    tag = f"{lib.stem}.{os.getpid()}"
    tmp = lib.with_name(f"{tag}.tmp")
    units = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in units]
    t0 = time.perf_counter()
    # one nvcc per source, all started together, then one link
    procs = [subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(units, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    log = "".join(f"== {src.name}\n{out}" for src, out in zip(units, logs))
    failed = [src.name for src, proc in zip(units, procs) if proc.returncode]
    if not failed:
        link = subprocess.run(
            [_nvcc(), "-shared", "-o", str(tmp), *[str(o) for o in objs]],
            capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode:
            failed = ["link"]
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
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


_twin_route = {"forced": False, "int8_group": None, "shadow": None}


@contextlib.contextmanager
def twin_route(force: bool = True, int8_group=None, shadow=None):
    """The reference route, for checks and probes. Within the block every
    kernel wrapper runs its plain twin whatever the device of its tensors
    (``force``), and the int8 twins quantise over the groups that
    ``int8_group`` sets instead of the CUDA kernels' own groups: a dict with
    any of the keys ``"taps"`` (the int8 conv taps: ``(q_tile, q_halo)``),
    ``"store"`` (int8 activation storage: ``(rows, cols)``) and
    ``"strided"`` (the int8 taps of the strided convs: ``(out_tile,
    in_halo)``), each as the twin of that kernel takes it; a bare tuple sets
    ``"taps"`` alone. A ``None`` extent means the whole axis; the TPU
    kernels' groups, which the parity tests use, are ``((tile_t, None),
    (2, 0))`` for the taps, ``(tile_t, "lane")`` for storage and
    ``((tile_t, None), (2, 0))`` for the strided taps. With ``shadow``, a callable
    ``shadow(name, kernel_result, twin_result)``, each wrapper also launches
    its kernel on the same CUDA operands and hands both results over, then
    goes on with the twin's: every kernel of a whole forward is so held
    against its twin on the activations the model really gives it. This is
    the only way a CUDA tensor reaches a twin; the package never enters it."""
    old = dict(_twin_route)
    _twin_route.update(forced=force, int8_group=int8_group, shadow=shadow)
    try:
        yield
    finally:
        _twin_route.update(old)


def use_twin(t: torch.Tensor) -> bool:
    """Whether a wrapper runs its plain twin on t: a CPU tensor, or any
    tensor inside ``twin_route``."""
    return t.device.type == "cpu" or _twin_route["forced"]


def twin_int8_group(kind: str = "taps"):
    """The quantisation group of one int8 kind (``"taps"``, ``"store"``,
    ``"strided"``) set by ``twin_route``, or None."""
    group = _twin_route["int8_group"]
    if isinstance(group, dict):
        return group.get(kind)
    return group if kind == "taps" else None


def twin_result(name: str, ref, t: torch.Tensor, launch):
    """The twin's result ``ref``, after ``twin_route``'s shadow (if any) has
    seen it beside the kernel's: ``launch()`` calls the wrapper again, which
    outside the forced route launches the kernel."""
    shadow = _twin_route["shadow"]
    if shadow is not None and t.device.type == "cuda":
        with twin_route(force=False):
            shadow(name, launch(), ref)
    return ref


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

