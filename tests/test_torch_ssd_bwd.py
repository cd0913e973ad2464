"""The backward of the port's SSD scan (K2b) on the CPU: its plain version
``ssd_chunked_bwd_ref`` against ``jax.grad`` through the JAX model's
``ssd_chunked`` and against torch autograd through the port's own chunked
scan; ``ops.ssd`` under autograd; the backward wrapper's checks, variants and
source; and the Mamba-2 training slice (loss and gradients under remat, a
train step) against the JAX package.  The two train steps against JAX's and
the launcher are in tests/test_torch_train.py.

Inputs are made with numpy from a seed and handed to both sides; everything
is float32.  Gradients are held at 1e-4 relative to max|ref| (sums in another
order through a chunked scan of up to 256 rows, and through two layers).
The CUDA kernels themselves run only on the card, where chip_smoke.py holds
them against the same plain version; here the plain version's
``round_operands`` (what the wgmma variant rounds to bf16) is held against
float64 at the bf16 tolerance, before any run on the card.
"""
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models.common import get_model as jax_model
from repro.models.mamba2 import ssd_chunked as jax_chunked
from repro_torch import spans
from repro_torch.configs import PORTED_ARCHS, get_config, get_smoke_config
from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import kernel as kssd
from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_bwd_ref, ssd_chunked_ref
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models.common import get_model, tree_leaves, tree_unflatten
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.testing import from_jax_params, rel_err, to_jax_layout, to_torch
from test_torch_train import _np_params

GRAD_TOL = 1e-4
ARCH = "mamba2-1.3b"
# (B, S, H, P, G, N, chunk): tests/test_torch_ssd.py's sweep (ragged, groups)
SHAPES = [
    (1, 64, 2, 16, 1, 8, 32),
    (2, 100, 4, 16, 2, 8, 32),
    (1, 256, 8, 32, 8, 16, 64),
]
# zamba2-1.2b's scan geometry (P 64, N 64, chunk 256), ragged, four heads in
# a group: what the card holds the N 64 wgmma backward to
ZAMBA2_SHAPE = (1, 300, 4, 64, 1, 64, 256)


def _scan_inputs(B, S, H, P, G, N, seed):
    """x, dt, A, B, C with the distributions of tests/test_kernels.py; an
    initial state, dy and a final-state gradient; all numpy float32."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((B, S, H, P)).astype(f) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(f)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(f)
    Bm = rng.standard_normal((B, S, G, N)).astype(f) * 0.3
    Cm = rng.standard_normal((B, S, G, N)).astype(f) * 0.3
    h0 = rng.standard_normal((B, H, P, N)).astype(f)
    dy = rng.standard_normal((B, S, H, P)).astype(f)
    dT = rng.standard_normal((B, H, P, N)).astype(f)
    return [x, dt, A, Bm, Cm], h0, dy, dT


def _jax_grads(arrs, h0, dy, dT, chunk):
    """jax.grad of sum(y * dy) + sum(hT * dT) through the JAX model's
    ssd_chunked, for x, dt, A, B, C (and the initial state when given)."""
    def f(*args):
        init = args[5] if len(args) > 5 else None
        y, hT = jax_chunked(*args[:5], chunk=chunk, init_state=init)
        out = jnp.sum(y * dy)
        return out if dT is None else out + jnp.sum(hT * dT)
    ins = [jnp.asarray(a) for a in arrs] + ([] if h0 is None else [jnp.asarray(h0)])
    return jax.grad(f, argnums=tuple(range(len(ins))))(*ins)


@pytest.mark.parametrize("final_grad", [False, True])
@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("shape", SHAPES + [ZAMBA2_SHAPE])
def test_bwd_ref_matches_jax_grad_and_torch_autograd(shape, with_init, final_grad):
    """Every input's gradient, with and without an initial state and a
    final-state gradient, against jax.grad through the JAX model's chunked
    scan and against autograd through the port's ssd_chunked_ref."""
    B, S, H, P, G, N, chunk = shape
    arrs, h0, dy, dT = _scan_inputs(B, S, H, P, G, N, seed=sum(shape))
    h0 = h0 if with_init else None
    dT = dT if final_grad else None
    got = ssd_chunked_bwd_ref(*(to_torch(a) for a in arrs),
                              None if h0 is None else to_torch(h0), to_torch(dy),
                              None if dT is None else to_torch(dT), chunk=chunk)
    assert [g.dtype for g in got] == [torch.float32] * 6
    assert got[5].shape == (B, H, P, N)

    ref_jax = _jax_grads(arrs, h0, dy, dT, chunk)
    ins = [to_torch(a).requires_grad_() for a in arrs]
    init = None if h0 is None else to_torch(h0).requires_grad_()
    y, hT = ssd_chunked_ref(*ins, chunk=chunk, init_state=init)
    out = (y * to_torch(dy)).sum() + (0 if dT is None else (hT * to_torch(dT)).sum())
    ref_torch = torch.autograd.grad(out, ins + ([] if init is None else [init]))
    for name, g, rj, rt in zip(("dx", "ddt", "dA", "dB", "dC", "d_init"),
                               got, ref_jax, ref_torch):
        assert g.shape == rt.shape, name
        assert rel_err(g, np.asarray(rj)) < GRAD_TOL, name
        assert rel_err(g, rt) < GRAD_TOL, name


def test_bwd_ref_dA_holds_float64_at_chunk_256():
    """dA is a sum over every row with much cancelling, and cum reaches some
    -200 within a chunk of 256: taken as sum_m dcum_m cum_m, the rounding of
    the cancelling sums in dcum comes back multiplied by that, and the fp32
    dA drifts from float64's by about the 1e-4 the backward kernel is held
    to.  Taken term by term (each pair's dS_ij with cum_i - cum_j), it holds
    float64's well inside it, as do the other gradients."""
    arrs, _, dy, _ = _scan_inputs(1, 700, 4, 64, 1, 128, seed=21)
    got = ssd_chunked_bwd_ref(*(to_torch(a) for a in arrs), None, to_torch(dy),
                              None, chunk=256)
    ref = ssd_chunked_bwd_ref(*(to_torch(a).double() for a in arrs), None,
                              to_torch(dy).double(), None, chunk=256)
    assert all(r.dtype == torch.float64 for r in ref)
    for name, g, r in zip(("dx", "ddt", "dA", "dB", "dC"), got, ref):
        assert rel_err(g, r.float()) < GRAD_TOL / 4, name


@pytest.mark.parametrize("shape,with_init", [
    ((1, 700, 4, 64, 1, 128, 256), True),     # ragged, an initial state
    ((2, 512, 4, 64, 2, 128, 256), False),    # two groups
    ((1, 384, 8, 64, 1, 128, 128), True)])
def test_bwd_rounded_operands_hold_float64(shape, with_init):
    """What ssd_bwd_wgmma rounds to bf16 (M, G, h_c and dh_{c+1} as product
    operands; round_operands of the plain version) keeps every gradient, the
    initial state's with a final-state gradient included, within the bf16
    tolerance of 2e-2 of float64 on the same bf16 inputs, at mamba2-1.3b's
    P, N and chunk; dA, taken term by term, too.  The rounding is real: dx,
    ddt, dB and dC move from the unrounded fp32 ones by more than 5e-4."""
    B, S, H, P, G, N, chunk = shape
    arrs, h0, dy, dT = _scan_inputs(B, S, H, P, G, N, seed=sum(shape))
    ins = [to_torch(a) for a in arrs]
    for i in (0, 3, 4):          # x, B, C in bf16, as the kernel reads them
        ins[i] = ins[i].to(torch.bfloat16).float()
    dy_t = to_torch(dy).to(torch.bfloat16).float()
    h0_t = to_torch(h0) if with_init else None
    dT_t = to_torch(dT) if with_init else None
    got = ssd_chunked_bwd_ref(*ins, h0_t, dy_t, dT_t, chunk=chunk, round_operands=True)
    plain = ssd_chunked_bwd_ref(*ins, h0_t, dy_t, dT_t, chunk=chunk)
    ref = ssd_chunked_bwd_ref(*(t.double() for t in ins),
                              None if h0_t is None else h0_t.double(), dy_t.double(),
                              None if dT_t is None else dT_t.double(), chunk=chunk)
    names = ("dx", "ddt", "dA", "dB", "dC", "d_init")[:6 if with_init else 5]
    for name, g, q, r in zip(names, got, plain, ref):
        assert rel_err(g, r.float()) < 2e-2, name
        assert rel_err(q, r.float()) < GRAD_TOL, name
    assert all(rel_err(got[i], plain[i]) > 5e-4 for i in (0, 1, 3, 4))   # dx, ddt, dB, dC


def test_bwd_ref_keeps_the_input_types():
    """bf16 inputs: dx, dB and dC come back in bf16 (the kernel's output
    types), ddt, dA and the state gradient in fp32, each within one bf16
    rounding of the fp32 computation on the same values."""
    arrs, h0, dy, dT = _scan_inputs(*SHAPES[1][:6], seed=7)
    f32 = [to_torch(a) for a in arrs]
    bf = list(f32)
    for i in (0, 3, 4):
        bf[i] = f32[i].to(torch.bfloat16)
        f32[i] = bf[i].float()
    dy_b = to_torch(dy).to(torch.bfloat16)
    chunk = SHAPES[1][6]
    got = ssd_chunked_bwd_ref(*bf, to_torch(h0), dy_b, to_torch(dT), chunk=chunk)
    ref = ssd_chunked_bwd_ref(*f32, to_torch(h0), dy_b.float(), to_torch(dT),
                              chunk=chunk)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32, torch.float32,
                                      torch.bfloat16, torch.bfloat16, torch.float32]
    for g, r in zip(got, ref):
        assert rel_err(g, r) <= 2.0 ** -8


@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_under_autograd_gives_every_gradient(with_init):
    """ops.ssd through SsdScan on CPU tensors: every input's gradient,
    D's (which autograd takes through the skip term outside the Function)
    and, with an initial state, its gradient; the final state's gradient
    flows back too.  No kernel launch is counted on the CPU."""
    B, S, H, P, G, N, chunk = SHAPES[1]
    arrs, h0, dy, dT = _scan_inputs(B, S, H, P, G, N, seed=11)
    D = np.linspace(0.5, 1.5, H).astype(np.float32)

    def run(fn):
        ins = [to_torch(a).requires_grad_() for a in arrs + [D]]
        init = to_torch(h0).requires_grad_() if with_init else None
        y, hT = fn(ins, init)
        out = (y * to_torch(dy)).sum() + (hT * to_torch(dT)).sum()
        return torch.autograd.grad(out, ins + ([init] if with_init else []))

    names = ("kernel.ssd_fwd", "kernel.ssd_bwd")
    launches = [spans.counters()[k] for k in names]
    got = run(lambda ins, init: ssd(*ins, chunk=chunk, init_state=init,
                                    return_state=True))
    assert [spans.counters()[k] for k in names] == launches

    def plain(ins, init):
        y, hT = ssd_chunked_ref(*ins[:5], chunk=chunk, init_state=init)
        return y + ins[0] * ins[5][None, None, :, None], hT
    ref = run(plain)
    assert len(got) == 6 + with_init
    for g, r in zip(got, ref):
        assert rel_err(g, r) < GRAD_TOL


def test_ssd_backward_when_only_the_final_state_is_read():
    """A gradient for the final state alone (y unread): the Function's
    backward takes the missing dy as zeros."""
    B, S, H, P, G, N, chunk = SHAPES[0]
    arrs, h0, _, dT = _scan_inputs(B, S, H, P, G, N, seed=12)
    ins = [to_torch(a).requires_grad_() for a in arrs]
    _, hT = ssd(*ins, chunk=chunk, return_state=True)
    got = torch.autograd.grad((hT * to_torch(dT)).sum(), ins)
    ins2 = [to_torch(a).requires_grad_() for a in arrs]
    _, hT2 = ssd_chunked_ref(*ins2, chunk=chunk)
    ref = torch.autograd.grad((hT2 * to_torch(dT)).sum(), ins2, allow_unused=True)
    assert ref[4] is None                      # the final state never reads C
    assert float(got[4].abs().max()) == 0.0
    for g, r in zip(got[:4], ref[:4]):
        assert rel_err(g, r) < GRAD_TOL


# -- the backward kernel's wrapper, variants and source ------------------------------

@pytest.mark.parametrize("bad,message", [
    ("cpu_tensor", "CUDA tensors"), ("dy_dtype", "x's shape and dtype"),
    ("dy_shape", "x's shape and dtype"), ("final_shape", "d_final_state must be"),
    ("final_dtype", "d_final_state must be"), ("dy_strided", "contiguous"),
    ("chunk", "not built"), ("groups", "multiple of G")])
def test_bwd_wrapper_raises_on_what_it_does_not_take(bad, message):
    """The backward's launcher checks its arguments before it touches the
    library (tensors on the meta device stand in for CUDA tensors: the
    device is the last thing checked); nothing falls to the plain version."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")
    B, S, H, P, G, N = 2, 40, 4, 16, 2, 8
    x, dt, A, Bm, Cm = z(B, S, H, P), z(B, S, H), z(H), z(B, S, G, N), z(B, S, G, N)
    dy, kw = z(B, S, H, P), {"chunk": 32}
    if bad == "cpu_tensor":
        x, dt, A, Bm, Cm, dy = (torch.zeros(t.shape) for t in (x, dt, A, Bm, Cm, dy))
    elif bad == "dy_dtype":
        dy = dy.to(torch.bfloat16)
    elif bad == "dy_shape":
        dy = z(B, S, H, P + 4)
    elif bad == "final_shape":
        kw["d_final_state"] = z(B, H, N, P)
    elif bad == "final_dtype":
        kw["d_final_state"] = z(B, H, P, N, dtype=torch.bfloat16)
    elif bad == "dy_strided":
        dy = z(B, S, H, 2 * P)[..., ::2]
    elif bad == "chunk":
        kw["chunk"] = 48
    elif bad == "groups":
        Bm, Cm = z(B, S, 3, N), z(B, S, 3, N)
    with pytest.raises(ValueError, match=message):
        kssd.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, **kw)


def test_bwd_variant_codes_and_kernels_are_the_c_functions():
    """The backward's rule lives in variant_bwd() alone: its codes are the
    source's enum, and the CUDA kernels the C function counts under their
    names (kKernelNames) are the ones VARIANT_KERNELS_BWD gives."""
    source = kssd.SOURCE_BWD.read_text()
    codes = {name: int(code) for code, name in re.findall(
        r"k\w+ = (\d+),\s*// (\w+)", source)}
    assert codes == kssd.VARIANT_CODES_BWD
    table = re.search(r"kKernelNames\[kNumKernels\] = \{([^}]*)\}", source).group(1)
    names = re.findall(r'"(\w+)"', table)
    assert len(names) == len(set(names))
    assert set(names) == {k for ks in kssd.VARIANT_KERNELS_BWD.values() for k in ks}
    assert set(kssd.VARIANT_CODES_BWD) == set(kssd.VARIANT_KERNELS_BWD)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_variant_takes_what_the_forward_takes(dtype):
    """The backward's rule is the forward's: where the forward runs on
    wgmma (bf16 at P 64, N 64 or 128, chunk 64 and up) so does the backward,
    and every other input the forward takes runs on the fp32 pipes."""
    by_forward = {"ssd_wgmma": "ssd_bwd_wgmma", "ssd_fwd_kernel": "ssd_bwd_simt"}
    for arch in PORTED_ARCHS:
        cfg = get_config(arch)
        if cfg.family not in ("ssm", "hybrid"):
            continue
        shape = (cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk)
        assert kssd.variant_bwd(dtype, *shape) == (
            "ssd_bwd_wgmma" if dtype == torch.bfloat16 else "ssd_bwd_simt")
    for shape in ((16, 8, 32), (64, 128, 64), (4, 4, 256), (64, 128, 32),
                  (64, 64, 256), (32, 128, 128), (64, 64, 64), (64, 64, 32)):
        assert kssd.variant_bwd(dtype, *shape) == by_forward[kssd.variant(dtype, *shape)]
        assert kssd.variant_bwd(dtype, *shape) in kssd.VARIANT_CODES_BWD
    for shape in ((64, 128, 48), (66, 128, 256), (64, 132, 256)):
        with pytest.raises(ValueError, match="no kernel"):
            kssd.variant_bwd(dtype, *shape)
    with pytest.raises(ValueError, match="no kernel"):
        kssd.variant_bwd(torch.float16, 64, 128, 256)


@pytest.mark.parametrize("P,N,chunk,expected", [
    (64, 128, 64, "ssd_bwd_wgmma"), (64, 128, 128, "ssd_bwd_wgmma"),
    (64, 128, 256, "ssd_bwd_wgmma"), (64, 128, 32, "ssd_bwd_simt"),
    (32, 128, 256, "ssd_bwd_simt"), (64, 64, 256, "ssd_bwd_wgmma"),
    (64, 124, 256, "ssd_bwd_simt"), (16, 8, 32, "ssd_bwd_simt"),
    (64, 64, 64, "ssd_bwd_wgmma"), (64, 64, 128, "ssd_bwd_wgmma"),
    (64, 64, 32, "ssd_bwd_simt"), (64, 96, 256, "ssd_bwd_simt")])
def test_bwd_variant_by_shape(P, N, chunk, expected):
    """ssd_bwd_wgmma exactly on bf16 at P 64, N 64 or 128 (zamba2-1.2b's and
    mamba2-1.3b's), chunk 64 and up; float32 always on the fp32 pipes; five
    CUDA kernels each, the last two shared."""
    assert kssd.variant_bwd(torch.bfloat16, P, N, chunk) == expected
    assert kssd.variant_bwd(torch.float32, P, N, chunk) == "ssd_bwd_simt"
    assert kssd.VARIANT_KERNELS_BWD["ssd_bwd_wgmma"] == (
        "ssd_bwd_states_wgmma", "ssd_bwd_dxdb_wgmma", "ssd_bwd_dc_wgmma",
        "ssd_bwd_dt", "ssd_bwd_reduce")
    assert kssd.VARIANT_KERNELS_BWD["ssd_bwd_simt"][-2:] == ("ssd_bwd_dt", "ssd_bwd_reduce")


def _bwd_args(dtype, P=64, N=128, chunk=64):
    """CPU tensors the backward's wrapper checks; the device check comes last."""
    B, S, H, G = 1, 64, 2, 1
    x, dy = torch.zeros((B, S, H, P), dtype=dtype), torch.zeros((B, S, H, P), dtype=dtype)
    Bm, Cm = torch.zeros((B, S, G, N), dtype=dtype), torch.zeros((B, S, G, N), dtype=dtype)
    return (x, torch.zeros((B, S, H)), torch.zeros((H,)), Bm, Cm, dy), {"chunk": chunk}


@pytest.mark.parametrize("name,dtype,shape", [
    ("ssd_bwd_simt", torch.bfloat16, (64, 128, 256)),
    ("ssd_bwd_simt", torch.bfloat16, (64, 128, 64)),
    ("ssd_bwd_wgmma", torch.bfloat16, (64, 128, 128)),
    ("ssd_bwd_simt", torch.float32, (16, 8, 32)),
    ("ssd_bwd_wgmma", torch.bfloat16, (64, 64, 256)),
    ("ssd_bwd_simt", torch.bfloat16, (64, 64, 256))])
def test_bwd_named_variant_that_takes_reaches_the_device_check(name, dtype, shape):
    """``variant=`` overrides variant_bwd with a kernel that takes the input:
    the fp32-pipe variant takes what the rule gives wgmma (to time the two)."""
    args, kw = _bwd_args(dtype, *shape)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kssd.ssd_scan_bwd(*args, variant=name, **kw)


@pytest.mark.parametrize("name,dtype,shape", [
    ("ssd_bwd_wgmma", torch.float32, (64, 128, 256)),
    ("ssd_bwd_wgmma", torch.bfloat16, (64, 128, 32)),
    ("ssd_bwd_wgmma", torch.bfloat16, (64, 96, 256)),
    ("ssd_bwd_none", torch.bfloat16, (64, 128, 256)),
    ("ssd_bwd_wgmma", torch.bfloat16, (64, 64, 32))])
def test_bwd_named_variant_that_does_not_take_raises(name, dtype, shape):
    args, kw = _bwd_args(dtype, *shape)
    with pytest.raises(ValueError, match="has no kernel"):
        kssd.ssd_scan_bwd(*args, variant=name, **kw)


def test_bwd_source_is_its_own_library():
    """ssd_bwd.cu is a source of its own, built by the shared helper into a
    library of its own under build/; it names what it replaces."""
    source = kssd.SOURCE_BWD
    assert source.is_file() and source.parent == kssd.SOURCE.parent
    assert kssd._lib_bwd is None or torch.cuda.is_available()
    lib = _build.library_path(source)
    assert re.fullmatch(r"libssd_bwd_[0-9a-f]{16}\.so", lib.name)
    assert lib != _build.library_path(kssd.SOURCE)
    text = source.read_text()
    assert "src/repro/models/mamba2.py:42" in text and "jax.grad" in text
    assert 'extern "C" int ssd_bwd(' in text


# -- Mamba-2 training against the JAX package ----------------------------------------

def _batch(vocab, seed=1, B=4, S=48):
    """numpy tokens and next-token labels (a ragged last chunk at chunk 32),
    a few labels masked (-100)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (B, S)).astype(np.int32)
    lab = np.concatenate([tok[:, 1:], tok[:, :1]], axis=1)
    lab[0, :5] = -100
    return ({"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)},
            {"tokens": torch.from_numpy(tok).long(),
             "labels": torch.from_numpy(lab).long()})


def _leaf_errs(port_grads, jax_grads):
    flat, _ = jax.tree_util.tree_flatten_with_path(port_grads)
    ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jax_grads))
    return {jax.tree_util.keystr(p): rel_err(a, b) for (p, a), b in zip(flat, ref)}


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("impl", ["kernel", "dense"])
def test_mamba2_loss_and_grads_match_jax_value_and_grad(impl, remat):
    """Mamba2LM.loss and every gradient leaf against
    jax.value_and_grad(repro Mamba2LM.loss) on the same weights and batch,
    through the scan's backward (kernel path: SsdScan, the plain K2b on the
    CPU) or autograd through the plain chunked scan (dense path)."""
    jcfg = jax_smoke(ARCH).replace(remat=remat)
    cfg = get_smoke_config(ARCH).replace(attn_impl=impl, remat=remat)
    P = _np_params(jcfg, 0)
    jb, tb = _batch(cfg.vocab_size)
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jax_model(jcfg).loss(jcfg, p, jb), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, P))
    params = from_jax_params(cfg, P, "cpu")
    loss, grads = loss_and_grads(cfg, params, tb)
    aux = get_model(cfg).loss(cfg, params, tb)[1]
    assert abs(float(loss) - float(jl)) / abs(float(jl)) < GRAD_TOL
    assert abs(float(aux["loss"]) - float(jaux["loss"])) / abs(float(jl)) < GRAD_TOL
    errs = _leaf_errs(to_jax_layout(cfg, tree_unflatten(params, grads)), jg)
    assert len(errs) == len(jax.tree_util.tree_leaves(jg)) == 17
    assert max(errs.values()) < GRAD_TOL, errs
    assert all(float(g.abs().max()) > 0 for g in grads)


@pytest.mark.parametrize("policy", ["full", "dots", "comm", "comm_lite"])
def test_mamba2_remat_leaves_loss_and_grads_unchanged(policy):
    cfg = get_smoke_config(ARCH)
    params = get_model(cfg).init(cfg, torch.Generator().manual_seed(4), "cpu")
    _, tb = _batch(cfg.vocab_size, seed=5)
    loss0, grads0 = loss_and_grads(cfg.replace(remat="none"), params, tb)
    loss, grads = loss_and_grads(cfg.replace(remat=policy), params, tb)
    assert float(loss) == float(loss0)
    for g, g0 in zip(grads, grads0):
        assert rel_err(g, g0) < 1e-6


def test_mamba2_inference_forward_matches_the_loss_path():
    """forward (no grad) and the grad-enabled _forward give the same hidden
    states; forward builds no graph; the kernel path and the dense path
    agree."""
    cfg = get_smoke_config(ARCH).replace(remat="full")
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator().manual_seed(6), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(7))
    hidden = model.forward(cfg, params, tokens)
    assert hidden.grad_fn is None
    assert torch.equal(hidden, model._forward(cfg, params, tokens))
    dense = model.forward(cfg.replace(attn_impl="dense"), params, tokens)
    assert rel_err(hidden, dense) < 2e-5


def test_mamba2_smoke_train_step():
    """Port of tests/test_models_smoke.py::test_smoke_train_step for mamba2:
    two steps with gradient accumulation 2 from the port's own init; finite
    losses, the optimizer's step, and the params moved."""
    cfg = get_smoke_config(ARCH)
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator().manual_seed(0), "cpu")
    before = [p.clone() for p in tree_leaves(params)]
    opt = adamw_init(params)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=0), grad_accum=2)
    _, tb = _batch(cfg.vocab_size, seed=2)
    params, opt, m1 = step(params, opt, tb)
    params, opt, m2 = step(params, opt, tb)
    assert math.isfinite(float(m1["loss"])) and math.isfinite(float(m2["loss"]))
    assert int(opt["step"]) == 2
    moved = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(tree_leaves(params), before))
    assert moved > 0
