"""Load and launch the CUDA SSD-scan forward.

The source ``csrc/ssd_fwd.cu`` is compiled at first use by
``repro_torch.kernels._build`` (``nvcc`` into ``build/``, loaded with
``ctypes``).  It holds two kernels behind one C function: bf16 at the
serving shape (P 64, N 128, chunk 64 and up) runs on the tensor cores,
everything else on the fp32 pipes.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_fwd.cu"
# The sizes the kernel was built for: the chunks of the tests, the JAX
# kernel's default (128) and ModelConfig.ssm_chunk (256); head dims P and
# state sizes N are multiples of 4 up to 64 and 128 (shared-memory tiles).
CHUNKS = (32, 64, 128, 256)
MAX_HEAD_DIM = 64
MAX_STATE = 128
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
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ssd_fwd.argtypes = [ptr] * 8 + [i32] * 8 + [ptr]
        lib.ssd_fwd.restype = i32
        lib.ssd_error_string.argtypes = [i32]
        lib.ssd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def takes(head_dim: int, state: int, chunk: int) -> bool:
    """Whether the kernel was built for this (P, N, chunk)."""
    return (chunk in CHUNKS and 0 < head_dim <= MAX_HEAD_DIM
            and head_dim % 4 == 0 and 0 < state <= MAX_STATE and state % 4 == 0)


def ssd_scan_fwd(
    x: torch.Tensor,            # [B, S, H, P]  fp32 or bf16
    dt: torch.Tensor,           # [B, S, H]     fp32
    A: torch.Tensor,            # [H]           fp32
    B_: torch.Tensor,           # [B, S, G, N]  the type of x
    C: torch.Tensor,            # [B, S, G, N]  the type of x
    *,
    chunk: int,
    init_state: Optional[torch.Tensor] = None,   # [B, H, P, N] fp32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors: (y [B,S,H,P] in x's type, final
    state [B,H,P,N] fp32).  Raises on anything it does not take."""
    if x.ndim != 4 or dt.ndim != 3 or A.ndim != 1 or B_.ndim != 4 or C.ndim != 4:
        raise ValueError("expected x [B,S,H,P], dt [B,S,H], A [H], "
                         "B and C [B,S,G,N]")
    Bsz, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"dtype {x.dtype} not supported (float32, bfloat16)")
    if B_.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError("B and C must have the dtype of x")
    tensors = [x, dt, A, B_, C]
    f32 = [dt, A] + ([] if init_state is None else [init_state])
    if any(t.dtype != torch.float32 for t in f32):
        raise ValueError("dt, A and init_state must be float32")
    if (dt.shape != (Bsz, S, H) or A.shape != (H,) or B_.shape != (Bsz, S, G, N)
            or C.shape != B_.shape):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B_.shape)}, C {tuple(C.shape)}")
    if init_state is not None:
        if init_state.shape != (Bsz, H, P, N):
            raise ValueError(f"init_state must be {(Bsz, H, P, N)}, got "
                             f"{tuple(init_state.shape)}")
        tensors.append(init_state)
    if G == 0 or H % G:
        raise ValueError(f"H={H} must be a multiple of G={G}")
    if not takes(P, N, chunk):
        raise ValueError(
            f"(P={P}, N={N}, chunk={chunk}) not built: chunk in {CHUNKS}, P and "
            f"N multiples of 4 up to {MAX_HEAD_DIM} and {MAX_STATE}")
    if min(Bsz, S) < 1 or Bsz > 65535:
        raise ValueError(f"unsupported sizes B={Bsz} S={S}")
    if any(t.device != x.device for t in tensors):
        raise ValueError("all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("x, dt, A, B, C and init_state must be contiguous")
    if not x.is_cuda:
        raise ValueError(f"tensors must be CUDA tensors, got {x.device}")
    y = torch.empty_like(x)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    lib = load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
            C.data_ptr(), None if init_state is None else init_state.data_ptr(),
            y.data_ptr(), state.data_ptr(),
            Bsz, S, H, G, P, N, chunk, DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd_fwd launch failed: CUDA error {err} "
                           f"({lib.ssd_error_string(err).decode()})")
    return y, state
