"""Public wrapper for the fluid scan: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import spans
from repro_torch.kernels.fluid_scan.kernel import check_inputs, fluid_scan_cuda
from repro_torch.kernels.fluid_scan.ref import FluidPhysics, fluid_scan_ref


def fluid_scan(
    jobs: torch.Tensor,        # [C, 10, Jp] float32
    order: torch.Tensor,       # [C, Jp] int32
    scalars: torch.Tensor,     # [C, 11] float32
    phys: FluidPhysics,
    *,
    n_steps: int,
    diag: bool = False,
) -> Dict[str, torch.Tensor]:
    """Integrate the cells of one (jobs, steps) bucket (``ref.fluid_scan_ref``
    says what comes back).  A CUDA tensor goes to the CUDA kernel, which
    launches or raises; a CPU tensor goes to the plain version.
    The counter ``kernel.fluid_scan`` of ``repro_torch.spans`` counts the
    calls that launched the kernel."""
    check_inputs(jobs, order, scalars, n_steps)
    if jobs.device.type == "cpu":
        return fluid_scan_ref(jobs, order, scalars, phys, n_steps=n_steps, diag=diag)
    out = fluid_scan_cuda(jobs, order, scalars, phys, n_steps=n_steps, diag=diag)
    spans.count("kernel.fluid_scan")
    return out
