"""The port's SSD scan on the CPU (its plain versions) against the JAX
package's Pallas kernel in interpret mode, its sequential oracle and the
model's chunked function; the kernel wrapper's checks; the shared build
helper.

Inputs are made with numpy from a seed and handed to both sides.  Tolerances
are those of tests/test_kernels.py, relative to max|ref|: 2e-5 in float32
(sums in another order: chunked against sequential, einsum against
dot_general) and 2e-2 in bfloat16 (one bf16 rounding of y is 2^-8 = 4e-3
relative).  The final state is fp32 on both sides whatever the input type, so
it is held at 2e-5 (it is never rounded to bf16).  The CUDA kernel itself
runs only on the card and is held against the same plain version by
chip_smoke.py.
"""
import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd as jax_ssd
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref
from repro.models.mamba2 import ssd_chunked as jax_chunked
from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_fwd
from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref, ssd_ref
from repro_torch.models import mamba2
from repro_torch.testing import rel_err, to_torch

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
STATE_TOL = 2e-5
REPO = Path(__file__).resolve().parents[1]
# (B, S, H, P, G, N, chunk): the sweep of tests/test_kernels.py
SHAPES = [
    (1, 64, 2, 16, 1, 8, 32),
    (2, 100, 4, 16, 2, 8, 32),     # ragged + groups
    (1, 256, 8, 32, 8, 16, 64),
]


def _inputs(B, S, H, P, G, N, dtype, seed=1):
    """The distributions of tests/test_kernels.py, drawn with numpy; x, B and
    C rounded to the working type once, in JAX, so both sides hold equal
    values.  dt and A are fp32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32) * 0.5
    dt = np.asarray(jax.nn.softplus(
        rng.standard_normal((B, S, H)).astype(np.float32)))
    A = -np.exp(rng.standard_normal(H).astype(np.float32) * 0.3)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32) * 0.3
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32) * 0.3
    jdt = jnp.dtype(dtype)
    x, Bm, Cm = (np.asarray(jnp.asarray(a).astype(jdt)) for a in (x, Bm, Cm))
    return x, dt, A.astype(np.float32), Bm, Cm


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_ssd_matches_jax_kernel_and_oracle(dtype, shape):
    B, S, H, P, G, N, chunk = shape
    arrs = _inputs(B, S, H, P, G, N, dtype)
    D = np.ones((H,), np.float32)
    pt = [to_torch(a) for a in arrs]
    jx = [jnp.asarray(a) for a in arrs]

    y = ssd(*pt, to_torch(D), chunk=chunk)
    assert y.dtype == getattr(torch, dtype) and y.shape == (B, S, H, P)
    pallas = jax_ssd(*jx, jnp.asarray(D), chunk=chunk, interpret=True)
    jy, jh = jax_ssd_ref(*jx, jnp.asarray(D))
    assert rel_err(y, _f32(pallas)) < TOL[dtype]
    assert rel_err(y, _f32(jy)) < TOL[dtype]

    # the port's sequential oracle against the JAX one: y and the final state
    ry, rh = ssd_ref(*pt, to_torch(D))
    assert ry.dtype == y.dtype and rh.dtype == torch.float32
    assert rel_err(ry, _f32(jy)) < TOL[dtype]
    assert rel_err(rh, np.asarray(jh)) < STATE_TOL
    # and the chunked form's final state against the sequential one
    _, ch = ssd(*pt, chunk=chunk, return_state=True)
    assert rel_err(ch, np.asarray(jh)) < STATE_TOL


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [SHAPES[1], (2, 300, 2, 64, 1, 128, 256)])
def test_ssd_chunked_ref_matches_the_model_chunked_path(shape, dtype, with_init):
    """y and the final state, with and without an initial state, against the
    JAX model's ssd_chunked; the second shape is the serving path's class
    (P 64, N 128, chunk 256) with a ragged last chunk."""
    B, S, H, P, G, N, chunk = shape
    arrs = _inputs(B, S, H, P, G, N, dtype, seed=3)
    h0 = (np.random.default_rng(4).standard_normal((B, H, P, N)).astype(np.float32)
          if with_init else None)
    y, hT = ssd_chunked_ref(*(to_torch(a) for a in arrs), chunk=chunk,
                            init_state=None if h0 is None else to_torch(h0))
    jy, jh = jax_chunked(*(jnp.asarray(a) for a in arrs), chunk=chunk,
                         init_state=None if h0 is None else jnp.asarray(h0))
    assert y.dtype == getattr(torch, dtype) and hT.dtype == torch.float32
    assert hT.shape == (B, H, P, N)
    assert rel_err(y, _f32(jy)) < TOL[dtype]
    assert rel_err(hT, np.asarray(jh)) < STATE_TOL
    # the wrapper hands init_state and the state through
    y2, h2 = ssd(*(to_torch(a) for a in arrs), chunk=chunk, return_state=True,
                 init_state=None if h0 is None else to_torch(h0))
    assert torch.equal(y2, y) and torch.equal(h2, hT)


def test_ssd_kernel_matches_model_chunked_path():
    """The port's ssd == its model's chunked function == the JAX model's (same
    algorithm, different implementations); the inputs of the JAX test."""
    B, S, H, P, G, N = 1, 96, 4, 16, 1, 8
    arrs = _inputs(B, S, H, P, G, N, "float32", seed=2)
    y_kernel = ssd(*(to_torch(a) for a in arrs), None, chunk=32)
    y_model, _ = mamba2.ssd_chunked(*(to_torch(a) for a in arrs), chunk=32)
    j_model, _ = jax_chunked(*(jnp.asarray(a) for a in arrs), chunk=32)
    np.testing.assert_allclose(y_kernel.numpy(), y_model.numpy(),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(y_kernel.numpy(), np.asarray(j_model),
                               rtol=2e-5, atol=2e-5)


def test_chunk_size_does_not_change_the_function():
    """Any chunk gives the recurrence: 32, 64, 128 and 256 agree."""
    arrs = [to_torch(a) for a in _inputs(1, 200, 2, 16, 1, 8, "float32", seed=5)]
    outs = [ssd(*arrs, chunk=c, return_state=True) for c in (32, 64, 128, 256)]
    for y, h in outs[1:]:
        assert rel_err(y, outs[0][0]) < 2e-5 and rel_err(h, outs[0][1]) < 2e-5


def test_cpu_path_counts_no_launch():
    arrs = [to_torch(a) for a in _inputs(*SHAPES[0][:6], "float32")]
    before = ssd.launches
    ssd(*arrs, chunk=32)
    assert ssd.launches == before


@pytest.mark.parametrize("which", [0, 1, 3, 5])
def test_ssd_refuses_autograd_without_a_backward(which):
    """The scan has no backward kernel: with grad mode on and an input that
    requires grad (x, dt, B or D here) it raises instead of returning a
    result that autograd would give no gradient; without grad mode, or under
    no_grad, it serves as before."""
    arrs = [to_torch(a) for a in _inputs(*SHAPES[0][:6], "float32")]
    D = torch.ones(arrs[0].shape[2])
    args = arrs + [D]
    plain = ssd(*args, chunk=32)
    args[which] = args[which].clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="no backward"):
        ssd(*args, chunk=32)
    with torch.no_grad():
        assert torch.equal(ssd(*args, chunk=32), plain)


@pytest.mark.parametrize("bad,message", [
    ("cpu_tensor", "CUDA tensors"), ("float16", "dtype"),
    ("dt_bf16", "float32"), ("mixed_bc", "dtype of x"),
    ("groups", "multiple of G"), ("chunk", "not built"),
    ("head_dim", "not built"), ("state", "not built"),
    ("dt_shape", "shapes disagree"), ("init_shape", "init_state must be"),
    ("strided", "contiguous"), ("rank", "expected x")])
def test_kernel_wrapper_raises_on_what_it_does_not_take(bad, message):
    """The launcher checks its arguments before it touches the library, so
    these raise here as they do on the card (tensors on the meta device stand
    in for CUDA tensors: the device is the last thing checked); nothing falls
    to the plain version."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")
    B, S, H, P, G, N = 2, 40, 4, 16, 2, 8
    x, dt, A = z(B, S, H, P), z(B, S, H), z(H)
    Bm, Cm, kw = z(B, S, G, N), z(B, S, G, N), {"chunk": 32}
    if bad == "cpu_tensor":
        x, dt, A, Bm, Cm = (torch.zeros(t.shape) for t in (x, dt, A, Bm, Cm))
    elif bad == "float16":
        x, Bm, Cm = (t.to(torch.float16) for t in (x, Bm, Cm))
    elif bad == "dt_bf16":
        dt = dt.to(torch.bfloat16)
    elif bad == "mixed_bc":
        Bm = Bm.to(torch.bfloat16)
    elif bad == "groups":
        Bm, Cm = z(B, S, 3, N), z(B, S, 3, N)
    elif bad == "chunk":
        kw["chunk"] = 48
    elif bad == "head_dim":
        x = z(B, S, H, 66)
    elif bad == "state":
        Bm, Cm = z(B, S, G, 256), z(B, S, G, 256)
    elif bad == "dt_shape":
        dt = z(B, S + 1, H)
    elif bad == "init_shape":
        kw["init_state"] = z(B, H, N, P)
    elif bad == "strided":
        x = z(B, S, H, 2 * P)[..., ::2]
    elif bad == "rank":
        x = z(B * S, H, P)
    with pytest.raises(ValueError, match=message):
        ssd_scan_fwd(x, dt, A, Bm, Cm, **kw)


# -- the shared build helper ------------------------------------------------------

@pytest.mark.parametrize("module", ["repro_torch.kernels.flash_attention.kernel",
                                    "repro_torch.kernels.ssd_scan.kernel"])
def test_kernel_modules_import_without_nvcc_and_name_their_sources(module):
    """Importing a kernel module builds nothing (there is no nvcc here); each
    names an existing .cu source, whose library goes to build/ under a name
    made of the source's stem and a hash of the source and the flags."""
    mod = importlib.import_module(module)
    assert mod.SOURCE.suffix == ".cu" and mod.SOURCE.is_file()
    assert mod._lib is None or torch.cuda.is_available()
    lib = _build.library_path(mod.SOURCE)
    assert lib.parent == REPO / "build"
    assert re.fullmatch(rf"lib{mod.SOURCE.stem}_[0-9a-f]{{16}}\.so", lib.name)


def test_a_shared_header_is_part_of_every_library_name(tmp_path, monkeypatch):
    """Both sources include the shared device helpers (mma.sync and cp.async;
    wgmma, mbarrier and TMA), so an edit to either header must rebuild both
    libraries."""
    headers = sorted(_build.HEADER_DIR.glob("*.cuh"))
    assert [h.name for h in headers] == ["hopper_mma.cuh", "hopper_sm90.cuh"]
    for module in ("repro_torch.kernels.flash_attention.kernel",
                   "repro_torch.kernels.ssd_scan.kernel"):
        source = importlib.import_module(module).SOURCE
        for header in headers:
            assert f'#include "../../csrc/{header.name}"' in source.read_text()
            before = _build.library_path(source)
            for h in headers:
                (tmp_path / h.name).write_text(
                    h.read_text() + ("\n" if h == header else ""))
            monkeypatch.setattr(_build, "HEADER_DIR", tmp_path)
            assert _build.library_path(source) != before
            monkeypatch.undo()


def test_the_build_helper_is_the_only_caller_of_nvcc():
    kernels = REPO / "src" / "repro_torch" / "kernels"
    callers = sorted(p.relative_to(kernels).as_posix() for p in kernels.rglob("*.py")
                     if re.search(r"^import subprocess", p.read_text(), re.M))
    assert callers == ["_build.py"]
    libs = {_build.library_path(importlib.import_module(m).SOURCE).name
            for m in ("repro_torch.kernels.flash_attention.kernel",
                      "repro_torch.kernels.ssd_scan.kernel")}
    assert len(libs) == 2
