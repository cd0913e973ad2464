"""Load and launch the CUDA flash-attention forward and backward.

The sources ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` are compiled at
first use by ``repro_torch.kernels._build`` (``nvcc`` into ``build/``, loaded
with ``ctypes``), one library each.  The forward holds three kernels behind
one C function, the backward three variants of two or three kernels behind
another; which runs is fixed by the dtype and the head dim alone:
``variant`` and ``variant_bwd`` are that rule, and the wrappers pass their
choice to the C functions, which launch what they are told.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"
SOURCE_BWD = SOURCE.with_name("flash_bwd.cu")
HEAD_DIMS = (32, 64, 80, 128)     # multiples of 16 that a ported config has
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# bf16 head dims of the wgmma + TMA kernel: rows of 128 or 256 bytes, whole
# 64-column atoms of the 128-byte swizzle (80 is not)
WGMMA_HEAD_DIMS = (64, 128)
# the variants, by the code the C function takes (FaVariant in the source)
VARIANT_CODES = {"fa_fwd_simt": 0, "fa_fwd_bf16_mma": 1, "fa_fwd_wgmma": 2}
# the CUDA kernels one call launches, by variant
VARIANT_KERNELS = {v: (v,) for v in VARIANT_CODES}
# the backward's variants (FaBwdVariant in flash_bwd.cu) and their kernels
VARIANT_CODES_BWD = {"fa_bwd_simt": 0, "fa_bwd_bf16_mma": 1, "fa_bwd_wgmma": 2}
VARIANT_KERNELS_BWD = {
    "fa_bwd_simt": ("fa_bwd_delta", "fa_bwd_dkdv_simt", "fa_bwd_dq_simt"),
    "fa_bwd_bf16_mma": ("fa_bwd_delta", "fa_bwd_dkdv_mma", "fa_bwd_dq_mma"),
    "fa_bwd_wgmma": ("fa_bwd_dq_wgmma", "fa_bwd_dkdv_wgmma"),
}
# rows of the wgmma backward's items: its row-statistics scratch covers Sq
# rounded up to a whole item
_WGMMA_BWD_ROWS = 128

_lib: Optional[ctypes.CDLL] = None
_lib_bwd: Optional[ctypes.CDLL] = None


def build(verbose: bool = False) -> Tuple[Path, Path]:
    """Compile the forward's and the backward's libraries where they are not
    there yet; return their paths."""
    return _build.build(SOURCE, verbose), _build.build(SOURCE_BWD, verbose)


def load() -> ctypes.CDLL:
    """The loaded forward library, built first if need be."""
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fa_fwd.argtypes = ([ptr] * 5 + [i32] * 6 + [i64] * 12
                               + [i32, i32, ctypes.c_float, i32, ptr])
        lib.fa_fwd.restype = i32
        lib.fa_error_string.argtypes = [i32]
        lib.fa_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def load_bwd() -> ctypes.CDLL:
    """The loaded backward library, built first if need be."""
    global _lib_bwd
    if _lib_bwd is None:
        lib = _build.load(SOURCE_BWD)
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fa_bwd.argtypes = ([ptr] * 10 + [i32] * 6 + [i64] * 15
                               + [i32, i32, ctypes.c_float, i32, ptr])
        lib.fa_bwd.restype = i32
        lib.fa_bwd_error_string.argtypes = [i32]
        lib.fa_bwd_error_string.restype = ctypes.c_char_p
        _lib_bwd = lib
    return _lib_bwd


def launch_counts() -> Dict[str, int]:
    """Launches of each CUDA kernel of both libraries since they were loaded,
    as the C functions count them where a launch succeeds: which kernels a
    call really ran is the difference of two readings."""
    return {**_build.launch_counts(load(), "fa"),
            **_build.launch_counts(load_bwd(), "fa_bwd")}


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that runs for this dtype and head dim: ``fa_fwd_wgmma`` (bf16 at head dims 64 and 128: wgmma, TMA),
    ``fa_fwd_bf16_mma`` (bf16 at 32 and 80: mma.sync) or ``fa_fwd_simt``
    (float32, on the fp32 pipes)."""
    if dtype not in DTYPE_CODES or head_dim not in HEAD_DIMS:
        raise ValueError(f"no kernel for {dtype} at head dim {head_dim}")
    if dtype == torch.float32:
        return "fa_fwd_simt"
    return "fa_fwd_wgmma" if head_dim in WGMMA_HEAD_DIMS else "fa_fwd_bf16_mma"


def variant_bwd(dtype: torch.dtype, head_dim: int) -> str:
    """The backward that runs for this dtype and head dim: ``fa_bwd_wgmma``
    (bf16 at head dims 64 and 128: wgmma, TMA), ``fa_bwd_bf16_mma`` (bf16 at
    32 and 80: mma.sync) or ``fa_bwd_simt`` (float32, on the fp32 pipes)."""
    if dtype not in DTYPE_CODES or head_dim not in HEAD_DIMS:
        raise ValueError(f"no kernel for {dtype} at head dim {head_dim}")
    if dtype == torch.float32:
        return "fa_bwd_simt"
    return "fa_bwd_wgmma" if head_dim in WGMMA_HEAD_DIMS else "fa_bwd_bf16_mma"


def _bwd_takes(name: str, dtype: torch.dtype, head_dim: int) -> bool:
    """Whether the backward variant ``name`` has a kernel for this dtype and
    head dim: the wgmma one only at its head dims, the mma.sync one at every
    bf16 head dim, the fp32-pipe one for float32."""
    if name == "fa_bwd_simt":
        return dtype == torch.float32
    if name == "fa_bwd_bf16_mma":
        return dtype == torch.bfloat16
    return dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS


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
    return_lse: bool = False,
):
    """Launch the kernel on CUDA tensors.  Raises on anything it does not take.

    With ``return_lse`` also returns each row's log-sum-exp ``[B, Hq, Sq]``
    fp32 (natural-log units of the scaled logits; ``-0.7 * float32 max`` for a
    row that sees no key), which the backward needs."""
    _check(q, k, v, window)
    _check_cuda(q)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fa_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, Hq, Hkv, Sq, Skv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            int(causal), window or 0, math.log2(math.e) / math.sqrt(D),
            VARIANT_CODES[variant(q.dtype, D)], stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err} "
                           f"({lib.fa_error_string(err).decode()})")
    return (out, lse) if return_lse else out


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    """Raise on what the kernels do not take, the device apart."""
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
        # the bf16 kernels copy 16 bytes at a time, and TMA takes only bases
        # and strides that are multiples of 16 bytes
        raise ValueError("bfloat16 q, k and v must start, and have every row "
                         "start, on a 16-byte boundary (TMA, cp.async)")


def _check_cuda(q: torch.Tensor) -> None:
    if not q.is_cuda:
        raise ValueError(f"q, k and v must be CUDA tensors, got {q.device}")


def flash_attention_bwd(
    q: torch.Tensor,            # [B, Hq, Sq, D]
    k: torch.Tensor,            # [B, Hkv, Skv, D]
    v: torch.Tensor,
    out: torch.Tensor,          # [B, Hq, Sq, D], the forward's
    lse: torch.Tensor,          # [B, Hq, Sq] fp32, the forward's
    do: torch.Tensor,           # [B, Hq, Sq, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    variant: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward on CUDA tensors: (dq, dk, dv) in q's type, dk and
    dv summed over each KV head's query heads.  Raises on anything it does
    not take.

    ``variant`` names the kernels to run instead of ``variant_bwd``'s choice,
    so that two of them can be timed on the same inputs; one that does not
    take the dtype and head dim raises.  ``flash_attention_bwd.copies``
    counts the calls that had to copy ``out`` or ``do`` (rows off a 16-byte
    boundary, or a last dimension that is not contiguous)."""
    _check(q, k, v, window)
    if out.shape != q.shape or do.shape != q.shape or \
            out.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} and do "
                         f"{tuple(do.shape)} {do.dtype} must have q's shape and "
                         f"type, {tuple(q.shape)} {q.dtype}")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be [B, Hq, Sq] float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if variant is None:
        variant = variant_bwd(q.dtype, D)
    elif variant not in VARIANT_CODES_BWD or not _bwd_takes(variant, q.dtype, D):
        raise ValueError(f"backward variant {variant!r} has no kernel for "
                         f"{q.dtype} at head dim {D}")
    _check_cuda(q)
    # out and dO only need rows with a unit last stride (and, for bf16, on
    # 16-byte boundaries, which TMA and 16-byte loads take): anything else is
    # copied once here
    fit = [x.stride(-1) == 1 and (x.dtype != torch.bfloat16 or _aligned16(x))
           for x in (out, do)]
    if not all(fit):
        flash_attention_bwd.copies += 1
    out, do = (x if ok else x.contiguous() for x, ok in zip((out, do), fit))
    lse = lse.contiguous()
    # scratch: delta [B, Hq, Sq]; for the wgmma variant the row statistics
    # (lse in base 2 and delta) of Sq rounded up to a whole item
    rows = (-(-Sq // _WGMMA_BWD_ROWS) * _WGMMA_BWD_ROWS * 2
            if variant == "fa_bwd_wgmma" else Sq)
    delta = torch.empty((B, Hq, rows), dtype=torch.float32, device=q.device)
    dq = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Hkv, Skv, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    lib = load_bwd()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fa_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Hq, Hkv, Sq, Skv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], *do.stride()[:3],
            int(causal), window or 0, 1.0 / math.sqrt(D),
            VARIANT_CODES_BWD[variant], stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd launch failed: CUDA error {err} "
                           f"({lib.fa_bwd_error_string(err).decode()})")
    return dq, dk, dv


flash_attention_bwd.copies = 0
