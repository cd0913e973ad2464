"""Build and load the port's CUDA kernels: the one place that calls ``nvcc``.

Each kernel is one ``.cu`` source with a plain C interface (no PyTorch
headers, so a build takes seconds), compiled for ``sm_90a`` into a shared
library and loaded with ``ctypes``.  The sources share the device helpers in
``csrc/*.cuh`` beside this module.  The library lands in ``build/`` at the
root of the checkout, named by the source's stem and a hash of the source,
the shared headers and the flags, so an edit to any of them rebuilds; the
finished file is moved into place atomically, so two processes building at
once cannot tear it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
HEADER_DIR = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _find_nvcc(source: Path) -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(cuda_home) / "bin" / "nvcc"
        if candidate.exists():
            nvcc = str(candidate)
    if nvcc is None:
        raise RuntimeError(f"nvcc not found: {source.name} is built from "
                           "source and needs the CUDA toolkit")
    return nvcc


# flags that one source adds to NVCC_FLAGS, by its stem: the fluid scan and
# AdamW round every product before the sum it feeds, as PyTorch's separate
# operations do, so they are built without fused multiply-adds
SOURCE_FLAGS: Dict[str, tuple] = {"fluid_scan": ("-fmad=false",),
                                  "adamw": ("-fmad=false",)}


def _flags(source: Path) -> tuple:
    return NVCC_FLAGS + SOURCE_FLAGS.get(source.stem, ())


def library_path(source: Path) -> Path:
    """Where the library of ``source`` is, or will be, built."""
    headers = b"".join(h.read_bytes() for h in sorted(HEADER_DIR.glob("*.cuh")))
    digest = hashlib.sha256(source.read_bytes() + headers
                            + " ".join(_flags(source)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def build(source: Path, verbose: bool = False) -> Path:
    """Compile ``source`` if its library is not there yet; return its path.
    ``verbose`` prints what ``ptxas -v`` says (registers, spills)."""
    lib_path = library_path(source)
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp_path = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_find_nvcc(source), *_flags(source)]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp_path), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stderr)
    os.replace(tmp_path, lib_path)
    return lib_path


def load(source: Path) -> ctypes.CDLL:
    """The library of ``source``, built first if need be."""
    return ctypes.CDLL(str(build(source)))


def launch_counts(lib: ctypes.CDLL, prefix: str) -> Dict[str, int]:
    """What a loaded library's ``<prefix>_kernel_name(i)`` and
    ``<prefix>_kernel_launches(i)`` report: the launches of each of its CUDA
    kernels since it was loaded, counted in C where a launch succeeded."""
    name_of = getattr(lib, f"{prefix}_kernel_name")
    launches_of = getattr(lib, f"{prefix}_kernel_launches")
    name_of.argtypes = launches_of.argtypes = [ctypes.c_int]
    name_of.restype, launches_of.restype = ctypes.c_char_p, ctypes.c_longlong
    counts, i = {}, 0
    while (name := name_of(i)) is not None:
        counts[name.decode()] = launches_of(i)
        i += 1
    return counts
