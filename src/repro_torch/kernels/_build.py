"""Builds the hand-written CUDA kernels at first use and binds them.

``csrc/spartus_kernels.cu`` has a plain C interface.  On the first launch
it is compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/repro_torch/`` (named by a hash of the source and flags, so an
edit rebuilds) and loaded with ``ctypes``.  Nothing is compiled or loaded
at import time: the CPU tests import every module on machines without
``nvcc`` or a card.

Every C entry point takes the CUDA device index first and the stream
last, launches on PyTorch's current stream, allocates nothing, and
returns ``cudaGetLastError()``; ``Kernel.launch`` raises if it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
SOURCES = ("spartus_kernels.cu",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SPMV_ARGS = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P]
SIGNATURES = {
    # device, x, h, s_hat, active, delta, s_hat_out, nnz, B, D, H, theta,
    # quantize, scale, qmin, qmax, stream
    "spartus_delta_encode_step": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                  _I, _F, _I, _F, _F, _F, _P],
    # device, dm, y, c, active, h_out, dm_out, c_out, h_state, B, H,
    # marks, n_marks, union counter, stream (marks and the counter: a
    # layer's launch counters, ``kernels/counters.py``, or null)
    "spartus_lstm_pointwise_step": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                    _I, _P, _I, _P, _P],
    # device, val, lidx, idx, ds, y, B, K, Q, M, BLEN, S, counts, marks,
    # stream
    "spartus_stsp_spmv_f32_i32": _SPMV_ARGS,
    "spartus_stsp_spmv_f32_i8": _SPMV_ARGS,
    "spartus_stsp_spmv_i8_i32": _SPMV_ARGS,
    "spartus_stsp_spmv_i8_i8": _SPMV_ARGS,
    # device, ds, wt, scale, y, B, Q, N, counts, marks, stream
    "spartus_dense_mirror_f32": [_I, _P, _P, _P, _P, _I, _I, _I, _P, _P,
                                 _P],
    "spartus_dense_mirror_i8": [_I, _P, _P, _P, _P, _I, _I, _I, _P, _P,
                                _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_fns: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    path = shutil.which("nvcc")
    if path is None and CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if path is None or not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH / CUDA_HOME): the CUDA "
                           "kernels are compiled at first use")
    return path


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        digest.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libspartus_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel library unless this source is already built.
    The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside the library as ``.log``."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC_DIR / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, path)            # atomic against concurrent builders
    return path


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.spartus_error_string.argtypes = [_I]
            lib.spartus_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _function(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(library(), symbol)
        fn.argtypes = SIGNATURES[symbol]
        fn.restype = _I
        _fns[symbol] = fn
    return fn


def check_cuda(name: str, dtypes: Dict[str, torch.dtype],
               **tensors: Optional[torch.Tensor]) -> torch.device:
    """Raise unless every tensor given (None stands for an absent optional
    argument) is a contiguous CUDA tensor of its expected dtype, all on
    one device; returns that device.  Runs once per launch, so it builds
    nothing per tensor."""
    first = None
    index = -1
    for arg, t in tensors.items():
        if t is None:
            continue
        if first is None:
            first, index = t, t.get_device()
        if index < 0 or not t.is_cuda or t.get_device() != index:
            devices = {str(v.device) for v in tensors.values()
                       if v is not None}
            raise ValueError(f"{name}: tensors must share one CUDA device, "
                             f"got {sorted(devices)}")
        want = dtypes.get(arg)
        if want is not None and t.dtype != want:
            raise TypeError(f"{name}: {arg} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    return first.device


# PyTorch's current stream on a device as a raw handle, without building
# a torch.cuda.Stream per launch (CPU-only builds lack the binding; they
# never launch)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


class Kernel:
    """A kernel wrapper's launch counter.  ``launches`` grows by one per
    launch of the wrapper's kernel and nowhere else, so a run can show
    that the main path went through the kernel."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def launch(self, symbol: str, device: torch.device, *args) -> None:
        """Call C entry point ``symbol`` on ``device``'s current stream.
        Tensors pass as their data pointers, None as a null pointer."""
        fn = _function(symbol)
        index = device.index
        stream = (_raw_stream(index) if _raw_stream is not None
                  else torch.cuda.current_stream(device).cuda_stream)
        err = fn(index, *[a.data_ptr() if isinstance(a, torch.Tensor) else a
                          for a in args], stream)
        if err != 0:
            msg = library().spartus_error_string(err).decode()
            raise RuntimeError(f"{self.name} ({symbol}): CUDA error {err}: "
                               f"{msg}")
        self.launches += 1
