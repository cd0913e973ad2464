"""Load and launch the CUDA flash-attention forward.

The source ``csrc/flash_fwd.cu`` is compiled at first use by
``repro_torch.kernels._build`` (``nvcc`` into ``build/``, loaded with
``ctypes``).
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"
HEAD_DIMS = (32, 64, 80, 128)     # multiples of 16 that a ported config has
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib: Optional[ctypes.CDLL] = None


def build(verbose: bool = False) -> Path:
    """Compile the kernel if its library is not there yet; return its path."""
    return _build.build(SOURCE, verbose)


def load() -> ctypes.CDLL:
    """The loaded library, built first if need be."""
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fa_fwd.argtypes = ([ptr] * 4 + [i32] * 6 + [i64] * 12
                               + [i32, i32, ctypes.c_float, i32, ptr])
        lib.fa_fwd.restype = i32
        lib.fa_error_string.argtypes = [i32]
        lib.fa_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _aligned16(x: torch.Tensor) -> bool:
    vec = 16 // x.element_size()
    return (all(s % vec == 0 for s in x.stride()[:-1])
            and x.data_ptr() % 16 == 0)


def flash_attention_fwd(
    q: torch.Tensor,            # [B, Hq, Sq, D]
    k: torch.Tensor,            # [B, Hkv, Skv, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors.  Raises on anything it does not take."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.ndim != 4:
            raise ValueError(f"{name} must be [B, H, S, D], got {tuple(x.shape)}")
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError("q, k and v must share device and dtype")
        if x.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dimension")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported {HEAD_DIMS}")
    if k.shape != (B, Hkv, Skv, D) or v.shape != k.shape:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    if min(B, Sq, Skv) < 1 or Hq > 65535 or B > 65535:
        raise ValueError(f"unsupported sizes B={B} Hq={Hq} Sq={Sq} Skv={Skv}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    if q.dtype == torch.bfloat16 and not all(map(_aligned16, (q, k, v))):
        # the bf16 path copies 16 bytes at a time
        raise ValueError("bfloat16 q, k and v must start, and have every row "
                         "start, on a 16-byte boundary")
    if not q.is_cuda:
        raise ValueError(f"q, k and v must be CUDA tensors, got {q.device}")
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    lib = load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fa_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, Sq, Skv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            int(causal), window or 0, math.log2(math.e) / math.sqrt(D),
            DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err} "
                           f"({lib.fa_error_string(err).decode()})")
    return out
