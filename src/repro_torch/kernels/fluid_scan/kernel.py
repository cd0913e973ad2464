"""Load and launch the CUDA fluid scan (K3).

The source ``csrc/fluid_scan.cu`` is compiled at first use by
``repro_torch.kernels._build`` (``nvcc`` into ``build/``, without fused
multiply-adds, loaded with ``ctypes``).  One launch integrates every cell of
one (jobs, steps) bucket, each cell for the whole horizon, by one of two
CUDA kernels that ``variant`` picks from the padded jobs alone:
``fluid_scan_warp`` (up to 128 padded jobs: one warp a cell, every sum by
shuffles, no block barrier in a step) or ``fluid_scan_block`` (above: one
block a cell, a thread a job, sums through shared memory).  The four rings
live in shared memory up to 128 padded jobs and in a global scratch buffer
that this wrapper allocates above that.  A caller may name either variant
(``variant=``) where it takes the bucket, to time one against the other.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fluid_scan.ref import (DIAG_FIELDS, JOB_FIELDS, RING,
                                                SCALAR_FIELDS, FluidPhysics)

SOURCE = Path(__file__).resolve().parent / "csrc" / "fluid_scan.cu"
#: the padded job counts the kernel takes: powers of two in this range
MIN_JOBS, MAX_JOBS = 8, 2048
#: above this bucket the rings live in global scratch, not shared memory
SMEM_RING_JOBS = 128
#: the largest bucket of the warp variant (its rings in shared memory)
WARP_MAX_JOBS = 128
#: the variants, by the code the C function takes (FluidVariant in the source)
VARIANT_CODES = {"fluid_scan_block": 0, "fluid_scan_warp": 1}
#: the CUDA kernels one call launches, by variant
VARIANT_KERNELS = {"fluid_scan_block": ("fluid_scan_block",),
                   "fluid_scan_warp": ("fluid_scan_warp",)}

_lib: Optional[ctypes.CDLL] = None


def build(verbose: bool = False) -> Path:
    """Compile the library where it is not there yet; return its path."""
    return _build.build(SOURCE, verbose)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of the source) with its C functions' argument types."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fluid_scan.argtypes = [ptr] * 4 + [i32] + [ptr] * 9 + [i32] * 4 + [ptr]
    lib.fluid_scan.restype = i32
    lib.fluid_error_string.argtypes = [i32]
    lib.fluid_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built first if need be."""
    global _lib
    if _lib is None:
        _lib = bind(_build.load(SOURCE))
    return _lib


def launch_counts() -> Dict[str, int]:
    """Launches of each CUDA kernel since the library was loaded, as the C
    function counts them where a launch succeeds: which kernel a call really
    ran is the difference of two readings."""
    return _build.launch_counts(load(), "fluid")


def takes(padded_jobs: int) -> bool:
    """Whether the kernel takes this bucket: a power of two in
    [MIN_JOBS, MAX_JOBS]."""
    return (MIN_JOBS <= padded_jobs <= MAX_JOBS
            and padded_jobs & (padded_jobs - 1) == 0)


def variant(padded_jobs: int) -> str:
    """The CUDA kernel that runs for this bucket: ``fluid_scan_warp`` up to
    ``WARP_MAX_JOBS`` padded jobs, ``fluid_scan_block`` above."""
    if not takes(padded_jobs):
        raise ValueError(f"no kernel for {padded_jobs} padded jobs: a power of "
                         f"two from {MIN_JOBS} to {MAX_JOBS}")
    return "fluid_scan_warp" if padded_jobs <= WARP_MAX_JOBS else "fluid_scan_block"


def _chosen(name: Optional[str], padded_jobs: int) -> str:
    """``name``, or the rule's choice where it is None; raises where the named
    variant does not take the bucket (the block variant takes every bucket,
    the warp variant those up to ``WARP_MAX_JOBS``)."""
    rule = variant(padded_jobs)
    if name is None:
        return rule
    if name not in VARIANT_CODES or (name == "fluid_scan_warp"
                                     and padded_jobs > WARP_MAX_JOBS):
        raise ValueError(f"variant {name!r} has no kernel for {padded_jobs} "
                         f"padded jobs")
    return name


def check_inputs(jobs: torch.Tensor, order: torch.Tensor, scalars: torch.Tensor,
                 n_steps: int) -> None:
    """Raise on anything the kernel does not take (the device is the
    caller's to check)."""
    if jobs.ndim != 3 or order.ndim != 2 or scalars.ndim != 2:
        raise ValueError("expected jobs [C, 10, Jp], order [C, Jp], scalars [C, 11]")
    C, F, Jp = jobs.shape
    if F != len(JOB_FIELDS) or tuple(order.shape) != (C, Jp) \
            or tuple(scalars.shape) != (C, len(SCALAR_FIELDS)):
        raise ValueError(f"shapes disagree: jobs {tuple(jobs.shape)}, order "
                         f"{tuple(order.shape)}, scalars {tuple(scalars.shape)}")
    if jobs.dtype != torch.float32 or scalars.dtype != torch.float32:
        raise ValueError("jobs and scalars must be float32")
    if order.dtype != torch.int32:
        raise ValueError("order must be int32")
    if C < 1 or not takes(Jp):
        raise ValueError(f"unsupported sizes C={C} Jp={Jp}: the padded jobs must "
                         f"be a power of two from {MIN_JOBS} to {MAX_JOBS}")
    if n_steps < 1:
        raise ValueError(f"n_steps must be positive, got {n_steps}")
    if not (jobs.device == order.device == scalars.device):
        raise ValueError("jobs, order and scalars must be on one device")
    if not (jobs.is_contiguous() and order.is_contiguous() and scalars.is_contiguous()):
        raise ValueError("jobs, order and scalars must be contiguous")


def fluid_scan_cuda(
    jobs: torch.Tensor,        # [C, 10, Jp] float32
    order: torch.Tensor,       # [C, Jp] int32
    scalars: torch.Tensor,     # [C, 11] float32
    phys: FluidPhysics,
    *,
    n_steps: int,
    diag: bool = False,
    variant: Optional[str] = None,
) -> Dict[str, torch.Tensor]:
    """Launch the kernel on CUDA tensors; the outputs of
    ``ref.fluid_scan_ref``.  ``variant`` names the CUDA kernel (the rule's,
    ``variant(Jp)``, where None).  Raises on anything it does not take."""
    check_inputs(jobs, order, scalars, n_steps)
    C, _, Jp = jobs.shape
    kind = _chosen(variant, Jp)
    if not jobs.is_cuda:
        raise ValueError(f"tensors must be CUDA tensors, got {jobs.device}")
    dev = jobs.device
    f32 = dict(dtype=torch.float32, device=dev)
    out = {k: torch.empty((C, Jp), **f32)
           for k in ("finish", "local", "remote", "map_rem", "red_rem")}
    out["latched_steps"] = torch.empty(C, **f32)
    out["steps"] = torch.empty(C, dtype=torch.int32, device=dev)
    trajectory = torch.empty((C, n_steps, len(DIAG_FIELDS)), **f32) if diag else None
    rings = torch.empty((C, 4, RING, Jp), **f32) if Jp > SMEM_RING_JOBS else None
    physics = (ctypes.c_float * 14)(*[float(x) for x in phys[:14]])
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fluid_scan(
            jobs.data_ptr(), order.data_ptr(), scalars.data_ptr(), physics,
            int(phys.fair_iters), out["finish"].data_ptr(), out["local"].data_ptr(),
            out["remote"].data_ptr(), out["map_rem"].data_ptr(),
            out["red_rem"].data_ptr(), out["latched_steps"].data_ptr(),
            out["steps"].data_ptr(),
            None if trajectory is None else trajectory.data_ptr(),
            None if rings is None else rings.data_ptr(), C, Jp, n_steps,
            VARIANT_CODES[kind], stream)
    if err != 0:
        raise RuntimeError(f"fluid_scan launch failed: CUDA error {err} "
                           f"({lib.fluid_error_string(err).decode()})")
    if diag:
        out["diag"] = trajectory
    return out
