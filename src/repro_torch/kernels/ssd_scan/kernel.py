"""Load and launch the CUDA SSD-scan forward (K2) and backward (K2b).

The sources ``csrc/ssd_fwd.cu`` and ``csrc/ssd_bwd.cu`` are compiled at first
use by ``repro_torch.kernels._build`` (``nvcc`` into ``build/``, loaded with
``ctypes``), one library each.  Which kernels run is fixed by (dtype, P, N,
chunk) alone (``variant`` and ``variant_bwd``, which the wrappers pass to the
C functions): bf16 at the serving and training shapes (P 64, N 64 or 128,
chunk 64 and up) runs on wgmma + TMA, the forward in two kernels (the state
pass, then the outputs), the backward in five (the two state recurrences,
the column and the row owners of the chunk pairs, then two short passes);
everything else runs on the fp32 pipes, the forward in one kernel, the
backward in five.  The fp32-pipe variants also run where a caller names them
(``variant=``), to be timed against the rule's.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch import spans
from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_fwd.cu"
SOURCE_BWD = SOURCE.with_name("ssd_bwd.cu")
# The sizes the kernel was built for: the chunks of the tests, the JAX
# kernel's default (128) and ModelConfig.ssm_chunk (256); head dims P and
# state sizes N are multiples of 4 up to 64 and 128 (shared-memory tiles).
CHUNKS = (32, 64, 128, 256)
MAX_HEAD_DIM = 64
MAX_STATE = 128
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the variants, by the code the C function takes (SsdVariant in the source)
VARIANT_CODES = {"ssd_fwd_kernel": 0, "ssd_wgmma": 1}
# the CUDA kernels one call launches, by variant
VARIANT_KERNELS = {"ssd_wgmma": ("ssd_state_wgmma", "ssd_out_wgmma"),
                   "ssd_fwd_kernel": ("ssd_fwd_kernel",)}
# the backward's variants (SsdBwdVariant in ssd_bwd.cu) and their kernels
VARIANT_CODES_BWD = {"ssd_bwd_simt": 0, "ssd_bwd_wgmma": 1}
VARIANT_KERNELS_BWD = {
    "ssd_bwd_simt": ("ssd_bwd_chunk_state", "ssd_bwd_state_scan",
                     "ssd_bwd_chunk_grads", "ssd_bwd_dt", "ssd_bwd_reduce"),
    "ssd_bwd_wgmma": ("ssd_bwd_states_wgmma", "ssd_bwd_dxdb_wgmma",
                      "ssd_bwd_dc_wgmma", "ssd_bwd_dt", "ssd_bwd_reduce"),
}

_lib: Optional[ctypes.CDLL] = None
_lib_bwd: Optional[ctypes.CDLL] = None


def build(verbose: bool = False) -> Tuple[Path, Path]:
    """Compile the forward's and the backward's libraries where they are not
    there yet; return their paths."""
    return _build.build(SOURCE, verbose), _build.build(SOURCE_BWD, verbose)


def load() -> ctypes.CDLL:
    """The loaded library, built first if need be."""
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ssd_fwd.argtypes = [ptr] * 10 + [i32] * 9 + [ptr]
        lib.ssd_fwd.restype = i32
        lib.ssd_error_string.argtypes = [i32]
        lib.ssd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def load_bwd() -> ctypes.CDLL:
    """The loaded backward library, built first if need be."""
    global _lib_bwd
    if _lib_bwd is None:
        lib = _build.load(SOURCE_BWD)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ssd_bwd.argtypes = [ptr] * 15 + [i32] * 9 + [ptr]
        lib.ssd_bwd.restype = i32
        lib.ssd_bwd_scratch_floats.argtypes = [i32] * 8
        lib.ssd_bwd_scratch_floats.restype = ctypes.c_longlong
        lib.ssd_bwd_error_string.argtypes = [i32]
        lib.ssd_bwd_error_string.restype = ctypes.c_char_p
        _lib_bwd = lib
    return _lib_bwd


def launch_counts() -> Dict[str, int]:
    """Launches of each CUDA kernel of both libraries since they were loaded,
    as the C functions count them where a launch succeeds: which kernels a
    call really ran is the difference of two readings."""
    return {**_build.launch_counts(load(), "ssd"),
            **_build.launch_counts(load_bwd(), "ssd_bwd")}


def takes(head_dim: int, state: int, chunk: int) -> bool:
    """Whether the kernel was built for this (P, N, chunk)."""
    return (chunk in CHUNKS and 0 < head_dim <= MAX_HEAD_DIM
            and head_dim % 4 == 0 and 0 < state <= MAX_STATE and state % 4 == 0)


def _tensor_cores(dtype: torch.dtype, head_dim: int, state: int, chunk: int) -> bool:
    """The domain of the wgmma + TMA variants, forward and backward: bf16 at
    P 64, N 64 or 128 (one or two 64-column atoms of the state), chunk 64,
    128 or 256."""
    return (dtype == torch.bfloat16 and head_dim == 64 and state in (64, 128)
            and chunk >= 64)


def variant(dtype: torch.dtype, head_dim: int, state: int, chunk: int) -> str:
    """The kernels that run for this dtype and (P, N, chunk): ``ssd_wgmma``
    (bf16 at P 64, N 64 or 128, chunk 64, 128 or 256: two kernels,
    ``VARIANT_KERNELS``) or ``ssd_fwd_kernel`` (everything else, and every
    float32 input: the fp32 pipes)."""
    if dtype not in DTYPE_CODES or not takes(head_dim, state, chunk):
        raise ValueError(f"no kernel for {dtype} at (P={head_dim}, N={state}, "
                         f"chunk={chunk})")
    if _tensor_cores(dtype, head_dim, state, chunk):
        return "ssd_wgmma"
    return "ssd_fwd_kernel"


def variant_bwd(dtype: torch.dtype, head_dim: int, state: int, chunk: int) -> str:
    """The backward that runs for this dtype and (P, N, chunk), by the
    forward's rule: ``ssd_bwd_wgmma`` (bf16 at P 64, N 64 or 128, chunk 64,
    128 or 256: wgmma + TMA) or ``ssd_bwd_simt`` (everything else, and every
    float32 input: the fp32 pipes); five CUDA kernels each
    (``VARIANT_KERNELS_BWD``)."""
    if dtype not in DTYPE_CODES or not takes(head_dim, state, chunk):
        raise ValueError(f"no kernel for {dtype} at (P={head_dim}, N={state}, "
                         f"chunk={chunk})")
    if _tensor_cores(dtype, head_dim, state, chunk):
        return "ssd_bwd_wgmma"
    return "ssd_bwd_simt"


# the fp32-pipe variants, forward and backward: they take every input the
# rules take, in both types
FP32_PIPES = ("ssd_fwd_kernel", "ssd_bwd_simt")


def _chosen(name: Optional[str], backward: bool, dtype: torch.dtype,
            head_dim: int, state: int, chunk: int) -> str:
    """``name``, or the rule's choice (``variant`` or, for the backward,
    ``variant_bwd``) where it is None; raises where the named variant has no
    kernel for these inputs (the fp32-pipe variant takes every input its rule
    takes, the wgmma one only its own domain)."""
    rule = (variant_bwd if backward else variant)(dtype, head_dim, state, chunk)
    if name is None:
        return rule
    codes = VARIANT_CODES_BWD if backward else VARIANT_CODES
    if name not in codes or (name not in FP32_PIPES and name != rule):
        raise ValueError(f"variant {name!r} has no kernel for {dtype} at "
                         f"(P={head_dim}, N={state}, chunk={chunk})")
    return name


def _check(x, dt, A, B_, C, init_state, chunk) -> Tuple[int, ...]:
    """(B, S, H, P, G, N) of the scan's inputs; raises on anything the
    kernels do not take, the device last."""
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
    return Bsz, S, H, P, G, N


def ssd_scan_fwd(
    x: torch.Tensor,            # [B, S, H, P]  fp32 or bf16
    dt: torch.Tensor,           # [B, S, H]     fp32
    A: torch.Tensor,            # [H]           fp32
    B_: torch.Tensor,           # [B, S, G, N]  the type of x
    C: torch.Tensor,            # [B, S, G, N]  the type of x
    *,
    chunk: int,
    init_state: Optional[torch.Tensor] = None,   # [B, H, P, N] fp32
    variant: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors: (y [B,S,H,P] in x's type, final
    state [B,H,P,N] fp32).  ``variant`` names the kernels to run instead of
    the rule's choice (``ssd_fwd_kernel`` where the rule picks ``ssd_wgmma``,
    to time the two).  Raises on anything it does not take."""
    Bsz, S, H, P, G, N = _check(x, dt, A, B_, C, init_state, chunk)
    kind = _chosen(variant, False, x.dtype, P, N, chunk)
    if kind == "ssd_wgmma" and any(t.data_ptr() % 16 for t in (x, B_, C)):
        # TMA takes only 16-byte aligned bases (the rows of x are 128 bytes,
        # of B and C 128 or 256)
        raise ValueError("bfloat16 x, B and C must start on a 16-byte boundary "
                         "(TMA)")
    if not x.is_cuda:
        raise ValueError(f"tensors must be CUDA tensors, got {x.device}")
    y = torch.empty_like(x)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    cdt = hb = None
    if kind == "ssd_wgmma":     # what the state pass hands the output pass
        nc = -(-S // chunk)     # cum and dt of each chunk; the state before it
        cdt = torch.empty((Bsz, nc, H, 2, chunk), dtype=torch.float32, device=x.device)
        hb = torch.empty((Bsz, nc, H, P, N), dtype=torch.bfloat16, device=x.device)
    lib = load()
    with spans.span("kernel.ssd_fwd", x, dt, A, B_, C, chunk=chunk), \
            torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
            C.data_ptr(), None if init_state is None else init_state.data_ptr(),
            y.data_ptr(), state.data_ptr(),
            None if cdt is None else cdt.data_ptr(),
            None if hb is None else hb.data_ptr(),
            Bsz, S, H, G, P, N, chunk, DTYPE_CODES[x.dtype],
            VARIANT_CODES[kind], stream)
    if err != 0:
        raise RuntimeError(f"ssd_fwd launch failed: CUDA error {err} "
                           f"({lib.ssd_error_string(err).decode()})")
    return y, state


def ssd_scan_bwd(
    x: torch.Tensor,            # [B, S, H, P]  fp32 or bf16
    dt: torch.Tensor,           # [B, S, H]     fp32
    A: torch.Tensor,            # [H]           fp32
    B_: torch.Tensor,           # [B, S, G, N]  the type of x
    C: torch.Tensor,            # [B, S, G, N]  the type of x
    dy: torch.Tensor,           # [B, S, H, P]  the type of x: the gradient of y
    *,
    chunk: int,
    init_state: Optional[torch.Tensor] = None,      # [B, H, P, N] fp32
    d_final_state: Optional[torch.Tensor] = None,   # [B, H, P, N] fp32
    variant: Optional[str] = None,
) -> Tuple[torch.Tensor, ...]:
    """Launch the backward on CUDA tensors: (dx, ddt, dA, dB, dC,
    d_init_state), dx, dB and dC in x's type, the rest fp32;
    ``d_init_state`` is the gradient of the initial state (of a zero one
    when ``init_state`` is None).  ``variant`` names the kernels to run
    instead of ``variant_bwd``'s choice (``ssd_bwd_simt`` where the rule
    picks ``ssd_bwd_wgmma``, to time the two).  Raises on anything it does
    not take."""
    Bsz, S, H, P, G, N = _check(x, dt, A, B_, C, init_state, chunk)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} must have x's shape "
                         "and dtype")
    if d_final_state is not None and (
            d_final_state.shape != (Bsz, H, P, N)
            or d_final_state.dtype != torch.float32):
        raise ValueError(f"d_final_state must be {(Bsz, H, P, N)} float32, got "
                         f"{tuple(d_final_state.shape)} {d_final_state.dtype}")
    extra = [dy] + ([] if d_final_state is None else [d_final_state])
    if any(t.device != x.device for t in extra):
        raise ValueError("all tensors must be on one device")
    if not all(t.is_contiguous() for t in extra):
        raise ValueError("dy and d_final_state must be contiguous")
    kind = _chosen(variant, True, x.dtype, P, N, chunk)
    if kind == "ssd_bwd_wgmma" and any(t.data_ptr() % 16 for t in (x, B_, C, dy)):
        # TMA takes only 16-byte aligned bases (the rows of x and dy are 128
        # bytes, of B and C 128 or 256)
        raise ValueError("bfloat16 x, dy, B and C must start on a 16-byte "
                         "boundary (TMA)")
    if not x.is_cuda:
        raise ValueError(f"tensors must be CUDA tensors, got {x.device}")
    lib = load_bwd()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, dB, dC = torch.empty_like(x), torch.empty_like(B_), torch.empty_like(C)
    ddt, dA = torch.empty((Bsz, S, H), **f32), torch.empty((H,), **f32)
    d_init = torch.empty((Bsz, H, P, N), **f32)
    scratch = torch.empty(
        (lib.ssd_bwd_scratch_floats(Bsz, S, H, G, P, N, chunk,
                                    VARIANT_CODES_BWD[kind]),), **f32)
    with spans.span("kernel.ssd_bwd", x, dt, A, B_, C, dy, chunk=chunk), \
            torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
            C.data_ptr(), None if init_state is None else init_state.data_ptr(),
            dy.data_ptr(),
            None if d_final_state is None else d_final_state.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), d_init.data_ptr(), scratch.data_ptr(),
            Bsz, S, H, G, P, N, chunk, DTYPE_CODES[x.dtype],
            VARIANT_CODES_BWD[kind], stream)
    if err != 0:
        raise RuntimeError(f"ssd_bwd launch failed: CUDA error {err} "
                           f"({lib.ssd_bwd_error_string(err).decode()})")
    return dx, ddt, dA, dB, dC, d_init
