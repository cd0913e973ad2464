"""Load and launch the CUDA flash-attention forward and backward.

The sources ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` are compiled at
first use by ``repro_torch.kernels._build`` (``nvcc`` into ``build/``, loaded
with ``ctypes``), one library each.  The forward holds three kernels behind
one C function, the backward three variants of two or three kernels behind
another; which runs is fixed by the dtype alone (bf16: wgmma + TMA, float32:
the fp32 pipes, at every pair of head dims): ``variant`` and ``variant_bwd``
are that rule, and the wrappers pass their choice to the C functions, which
launch what they are told.  The earlier bf16 design, ``mma.sync``, runs only
when a caller names it (``variant=``), to be timed against the rule's, and
only where q, k and v share one head dim.

q and k have head dim D, v and the output Dv: the pairs of
``HEAD_DIM_PAIRS``, each of ``HEAD_DIMS`` with itself and MLA's (192, 128)
(deepseek-v2-lite-16b: a nope part of 128 and a rope part of 64 against
values of 128).  The scale is 1 / sqrt(D).
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch import spans
from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"
SOURCE_BWD = SOURCE.with_name("flash_bwd.cu")
HEAD_DIMS = (32, 64, 80, 128)     # multiples of 16 that a ported config has
# (D, Dv) of q·k and of v that the kernels take
HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
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
        lib.fa_fwd.argtypes = ([ptr] * 5 + [i32] * 7 + [i64] * 12
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
        lib.fa_bwd.argtypes = ([ptr] * 10 + [i32] * 7 + [i64] * 15
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


def _dims(head_dim: int, v_head_dim: Optional[int]) -> str:
    return (f"head dim {head_dim}" if v_head_dim in (None, head_dim)
            else f"head dims ({head_dim}, {v_head_dim})")


def variant(dtype: torch.dtype, head_dim: int,
            v_head_dim: Optional[int] = None) -> str:
    """The kernel that runs for this dtype and head dims (q·k's, and v's,
    ``head_dim`` where None): ``fa_fwd_wgmma`` (bf16: wgmma, TMA) or
    ``fa_fwd_simt`` (float32, on the fp32 pipes)."""
    pair = (head_dim, head_dim if v_head_dim is None else v_head_dim)
    if dtype not in DTYPE_CODES or pair not in HEAD_DIM_PAIRS:
        raise ValueError(f"no kernel for {dtype} at {_dims(*pair)}")
    return "fa_fwd_simt" if dtype == torch.float32 else "fa_fwd_wgmma"


def variant_bwd(dtype: torch.dtype, head_dim: int,
                v_head_dim: Optional[int] = None) -> str:
    """The backward that runs for this dtype and head dims (q·k's, and v's,
    ``head_dim`` where None): ``fa_bwd_wgmma`` (bf16: wgmma, TMA) or
    ``fa_bwd_simt`` (float32, on the fp32 pipes)."""
    pair = (head_dim, head_dim if v_head_dim is None else v_head_dim)
    if dtype not in DTYPE_CODES or pair not in HEAD_DIM_PAIRS:
        raise ValueError(f"no kernel for {dtype} at {_dims(*pair)}")
    return "fa_bwd_simt" if dtype == torch.float32 else "fa_bwd_wgmma"


def _takes(name: str, dtype: torch.dtype, head_dim: int, v_head_dim: int) -> bool:
    """Whether the forward or backward variant ``name`` has a kernel for this
    dtype and pair of HEAD_DIM_PAIRS: the fp32-pipe ones for float32 and the
    wgmma ones for bf16 at every pair, the mma.sync ones for bf16 where q, k
    and v share one head dim."""
    if "_mma" in name and head_dim != v_head_dim:
        return False
    return dtype == (torch.float32 if name.endswith("_simt") else torch.bfloat16)


def _chosen(name: Optional[str], codes: Dict[str, int], dtype: torch.dtype,
            head_dim: int, v_head_dim: int) -> str:
    """``name``, or the rule's variant (of the forward's ``codes`` or the
    backward's) where it is None; raises where the named variant has no
    kernel for this dtype and these head dims."""
    if name is None:
        rule = variant if codes is VARIANT_CODES else variant_bwd
        return rule(dtype, head_dim, v_head_dim)
    if name not in codes or not _takes(name, dtype, head_dim, v_head_dim):
        raise ValueError(f"variant {name!r} has no kernel for {dtype} at "
                         f"{_dims(head_dim, v_head_dim)}")
    return name


def _aligned16(x: torch.Tensor) -> bool:
    vec = 16 // x.element_size()
    return (all(s % vec == 0 for s in x.stride()[:-1])
            and x.data_ptr() % 16 == 0)


def flash_attention_fwd(
    q: torch.Tensor,            # [B, Hq, Sq, D]
    k: torch.Tensor,            # [B, Hkv, Skv, D]
    v: torch.Tensor,            # [B, Hkv, Skv, Dv]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    return_lse: bool = False,
    variant: Optional[str] = None,
):
    """Launch the kernel on CUDA tensors: the output ``[B, Hq, Sq, Dv]`` in
    q's type.  Raises on anything it does not take.

    With ``return_lse`` also returns each row's log-sum-exp ``[B, Hq, Sq]``
    fp32 (natural-log units of the scaled logits; ``-0.7 * float32 max`` for a
    row that sees no key), which the backward needs.  ``variant`` names the
    kernel to run instead of ``variant()``'s choice, so that two of them can
    be timed on the same inputs; one that does not take the dtype and head
    dims raises."""
    _check(q, k, v, window)
    B, Hq, Sq, D = q.shape
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    variant = _chosen(variant, VARIANT_CODES, q.dtype, D, Dv)
    _check_cuda(q)
    out = torch.empty((B, Hq, Sq, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = load()
    with spans.span("kernel.fa_fwd", q, k, v, causal=causal, window=window or 0), \
            torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fa_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, Hq, Hkv, Sq, Skv, D, Dv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            int(causal), window or 0, math.log2(math.e) / math.sqrt(D),
            VARIANT_CODES[variant], stream)
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
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if k.shape != (B, Hkv, Skv, D) or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if (D, Dv) not in HEAD_DIM_PAIRS:
        raise ValueError(f"{_dims(D, Dv)} not supported: (q·k, v) pairs "
                         f"{HEAD_DIM_PAIRS}")
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
    v: torch.Tensor,            # [B, Hkv, Skv, Dv]
    out: torch.Tensor,          # [B, Hq, Sq, Dv], the forward's
    lse: torch.Tensor,          # [B, Hq, Sq] fp32, the forward's
    do: torch.Tensor,           # [B, Hq, Sq, Dv]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    variant: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward on CUDA tensors: (dq, dk, dv) in q's type, dq and
    dk at q's head dim, dv at v's, dk and dv summed over each KV head's query
    heads.  Raises on anything it does not take.

    ``variant`` names the kernels to run instead of ``variant_bwd``'s choice,
    so that two of them can be timed on the same inputs; one that does not
    take the dtype and head dims raises.  ``flash_attention_bwd.copies``
    counts the calls that had to copy ``out`` or ``do`` (rows off a 16-byte
    boundary, or a last dimension that is not contiguous)."""
    _check(q, k, v, window)
    B, Hq, Sq, D = q.shape
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    want = (B, Hq, Sq, Dv)
    if out.shape != want or do.shape != want or \
            out.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} and do "
                         f"{tuple(do.shape)} {do.dtype} must have q's shape at "
                         f"v's head dim and q's type, {want} {q.dtype}")
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be [B, Hq, Sq] float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    variant = _chosen(variant, VARIANT_CODES_BWD, q.dtype, D, Dv)
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
    dv = torch.empty((B, Hkv, Skv, Dv), dtype=q.dtype, device=q.device)
    lib = load_bwd()
    with spans.span("kernel.fa_bwd", q, k, v, causal=causal, window=window or 0), \
            torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fa_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Hq, Hkv, Sq, Skv, D, Dv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], *do.stride()[:3],
            int(causal), window or 0, 1.0 / math.sqrt(D),
            VARIANT_CODES_BWD[variant], stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd launch failed: CUDA error {err} "
                           f"({lib.fa_bwd_error_string(err).decode()})")
    return dq, dk, dv


flash_attention_bwd.copies = 0
