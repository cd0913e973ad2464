"""Load and launch AdamW's CUDA kernels (K4).

The source ``csrc/adamw.cu`` is compiled at first use by
``repro_torch.kernels._build`` (``nvcc`` into ``build/``, without fused
multiply-adds, loaded with ``ctypes``).  ``adamw_sumsq`` sums the squares of
every gradient leaf; ``adamw_update`` makes one pass over every leaf.  Both
walk the leaves in chunks of ``CHUNK`` elements over a persistent grid, up to
``MAX_LEAVES`` leaves a launch (``plan``), each leaf with its own (param,
grad) types (``kind``).  The kernels allocate nothing: the wrapper makes
the norm's partials with ``torch.empty`` a call (the caching allocator hands
back a free block, so they are not live at a train step's peak) and keeps
its counter, which a launch leaves at 0, for each device and stream.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "adamw.cu"
#: elements a chunk (kChunk in the source): a multiple of 8, so every chunk of
#: an aligned leaf starts 16-byte aligned
CHUNK = 1 << 16
#: leaves a launch (kMaxLeaves in the source)
MAX_LEAVES = 128
#: the types a param or a gradient may have
DTYPES = (torch.float32, torch.bfloat16)
#: the CUDA kernels of each entry point
KERNELS = ("adamw_sumsq", "adamw_update")

_lib: Optional[ctypes.CDLL] = None
# (device, stream) -> the norm's counter of finished blocks
_counters: Dict[Tuple[torch.device, int], torch.Tensor] = {}


class Launch(NamedTuple):
    """One launch: the indices of its leaves, each one's first chunk, and the
    launch's chunks."""
    leaves: Tuple[int, ...]
    chunk0: Tuple[int, ...]
    chunks: int


def build(verbose: bool = False) -> Path:
    """Compile the library where it is not there yet; return its path."""
    return _build.build(SOURCE, verbose)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of the source) with its C functions' argument types."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.adamw_sumsq.argtypes = [ptr] * 4 + [i32, i32] + [ptr] * 3 + [i32, ptr]
    lib.adamw_sumsq.restype = i32
    lib.adamw_update.argtypes = [ptr] * 7 + [i32, i32] + [ptr] * 4 + [f32] * 6 + [ptr]
    lib.adamw_update.restype = i32
    lib.adamw_error_string.argtypes = [i32]
    lib.adamw_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built first if need be."""
    global _lib
    if _lib is None:
        _lib = bind(_build.load(SOURCE))
    return _lib


def launch_counts() -> Dict[str, int]:
    """Launches of each CUDA kernel since the library was loaded, as the C
    functions count them where a launch succeeds."""
    return _build.launch_counts(load(), "adamw")


def kind(param_dtype: torch.dtype, grad_dtype: torch.dtype) -> int:
    """A leaf's code in the C functions: 1 for a bf16 gradient, plus 2 for a
    bf16 param."""
    return int(grad_dtype == torch.bfloat16) | 2 * int(param_dtype == torch.bfloat16)


def plan(numels: Sequence[int]) -> List[Launch]:
    """The launches over leaves of these sizes, in order: up to MAX_LEAVES
    leaves each, a leaf's chunks following the leaf before's.  A leaf with no
    elements is left out."""
    launches, cur = [], []
    for i, n in enumerate(numels):
        if n > 0:
            cur.append(i)
        if cur and (len(cur) == MAX_LEAVES or i == len(numels) - 1):
            chunk0, c = [], 0
            for j in cur:
                chunk0.append(c)
                c += -(-numels[j] // CHUNK)
            launches.append(Launch(tuple(cur), tuple(chunk0), c))
            cur = []
    return launches


def check_grads(grads: Sequence[torch.Tensor]) -> None:
    """Raise on gradient leaves the norm does not take."""
    if not grads:
        raise ValueError("no leaves")
    device = grads[0].device
    for i, g in enumerate(grads):
        if g.device != device:
            raise ValueError(f"leaf {i} is on {g.device}, leaf 0 on {device}")
        if g.dtype not in DTYPES:
            raise ValueError(f"leaf {i} is {g.dtype}: float32 or bfloat16")
        if not g.is_contiguous():
            raise ValueError(f"leaf {i} is not contiguous")


def check_update(params, grads, ms, vs, scalars: Sequence[torch.Tensor]) -> None:
    """Raise on leaves or scalars the update does not take."""
    if not (len(params) == len(grads) == len(ms) == len(vs)):
        raise ValueError(f"{len(params)} params, {len(grads)} grads, {len(ms)} "
                         f"and {len(vs)} moments")
    check_grads(grads)
    device = grads[0].device
    for i, (p, g, m, v) in enumerate(zip(params, grads, ms, vs)):
        if not (p.shape == g.shape == m.shape == v.shape):
            raise ValueError(f"leaf {i}: param {tuple(p.shape)}, grad {tuple(g.shape)}, "
                             f"moments {tuple(m.shape)} {tuple(v.shape)}")
        if p.dtype not in DTYPES or m.dtype != torch.float32 or v.dtype != torch.float32:
            raise ValueError(f"leaf {i}: param {p.dtype} (float32 or bfloat16), moments "
                             f"{m.dtype} {v.dtype} (float32)")
        for x in (p, m, v):
            if x.device != device:
                raise ValueError(f"leaf {i} is on {x.device} and {device}")
            if not x.is_contiguous():
                raise ValueError(f"leaf {i} is not contiguous")
    for s in scalars:
        if s.device != device or s.dtype != torch.float32 or s.numel() != 1:
            raise ValueError(f"scalars must be one float32 each on {device}, got "
                             f"{s.dtype} {tuple(s.shape)} on {s.device}")


def check_written_once(params, ms, vs) -> None:
    """Raise where a param or moment appears twice: one launch updates every
    leaf at once, where the plain version updates them one after another."""
    written = [x.data_ptr() for xs in (params, ms, vs) for x in xs if x.numel()]
    if len(set(written)) != len(written):
        raise ValueError("a param or moment appears twice among the leaves")


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({load().adamw_error_string(err).decode()})")


def sum_of_squares_cuda(grads: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the sum of the squares of every element of ``grads``, its square
    root), fp32 0-dim tensors on the card, by ``adamw_sumsq``: one launch a
    plan's launch."""
    check_grads(grads)
    if not grads[0].is_cuda:
        raise ValueError(f"tensors must be CUDA tensors, got {grads[0].device}")
    numels = [g.numel() for g in grads]
    launches = plan(numels)
    dev = grads[0].device
    out = torch.empty(2, dtype=torch.float32, device=dev)
    if not launches:
        return out.zero_()[0], out[1]
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        partials = torch.empty(max(l.chunks for l in launches), dtype=torch.float32,
                               device=dev)
        done = _counters.get((dev, stream))
        if done is None:
            done = _counters[(dev, stream)] = torch.zeros(1, dtype=torch.int32, device=dev)
        for i, launch in enumerate(launches):
            sel = [grads[j] for j in launch.leaves]
            L = len(sel)
            err = lib.adamw_sumsq(
                _pointers(sel), (ctypes.c_longlong * L)(*[numels[j] for j in launch.leaves]),
                (ctypes.c_int * L)(*launch.chunk0),
                (ctypes.c_int * L)(*[kind(torch.float32, g.dtype) for g in sel]),
                L, launch.chunks, partials.data_ptr(), done.data_ptr(), out.data_ptr(),
                int(i > 0), stream)
            _raise_on(err, "adamw_sumsq")
    return out[0], out[1]


def adamw_update_cuda(params, grads, ms, vs, *, scale: torch.Tensor, lr: torch.Tensor,
                      b1t: torch.Tensor, b2t: torch.Tensor, b1: float, b2: float,
                      eps: float, weight_decay: float) -> None:
    """One AdamW step of every leaf in place by ``adamw_update`` (one launch a
    plan's launch), with the plain version's arithmetic: ``ref.adamw_update_ref``."""
    check_update(params, grads, ms, vs, (scale, lr, b1t, b2t))
    if not grads[0].is_cuda:
        raise ValueError(f"tensors must be CUDA tensors, got {grads[0].device}")
    check_written_once(params, ms, vs)
    numels = [g.numel() for g in grads]
    lib = load()
    with torch.cuda.device(grads[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        for launch in plan(numels):
            L = len(launch.leaves)
            pick = lambda xs: [xs[j] for j in launch.leaves]   # noqa: E731
            err = lib.adamw_update(
                _pointers(pick(grads)), _pointers(pick(params)), _pointers(pick(ms)),
                _pointers(pick(vs)), (ctypes.c_longlong * L)(*pick(numels)),
                (ctypes.c_int * L)(*launch.chunk0),
                (ctypes.c_int * L)(*[kind(params[j].dtype, grads[j].dtype)
                                     for j in launch.leaves]),
                L, launch.chunks, scale.data_ptr(), lr.data_ptr(), b1t.data_ptr(),
                b2t.data_ptr(), b1, 1 - b1, b2, 1 - b2, eps, weight_decay, stream)
            _raise_on(err, "adamw_update")
