"""Which CUDA kernel runs is fixed by dtype and shape alone, and the wrappers
refuse, before any launch, what the tensor-memory-accelerator (TMA) kernels
cannot take.

The kernels run only on the card (chip_smoke.py names the variant of every
case it holds against the plain version); here the rule itself is checked,
for every shape that a ported config gives the kernels, and the wrappers'
checks on CPU tensors, which they reach before the device check.
"""
import re

import pytest
import torch

from repro_torch.configs import PORTED_ARCHS, get_config
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.ssd_scan import kernel as ssd

# every ported config whose attention can take the kernel: not Mamba-2, and
# not DeepSeek's MLA, whose q/k head dim (nope + rope: 192) is not the
# config's d_model / n_heads and which passes explicit positions, so it runs
# the dense path (tests/test_torch_moe.py holds that rule)
ATTENTION_ARCHS = [a for a in PORTED_ARCHS
                   if get_config(a).family != "ssm" and not get_config(a).kv_lora_rank]
# every ported config that runs the scan: Mamba-2 (ssm) and Zamba2 (hybrid)
SSM_ARCHS = [a for a in PORTED_ARCHS if get_config(a).family in ("ssm", "hybrid")]


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_attention_variant_of_every_ported_config(arch):
    """bf16 at every ported config's head dim (64: tinyllama-1.1b; 80:
    stablelm-3b; 128: llama3.2-3b, nemotron-4-15b, mixtral-8x22b) runs the
    wgmma kernel forward and backward; float32 always the fp32-pipe one."""
    d = get_config(arch).resolved_head_dim
    assert fa.variant(torch.bfloat16, d) == "fa_fwd_wgmma"
    assert fa.variant_bwd(torch.bfloat16, d) == "fa_bwd_wgmma"
    assert fa.variant(torch.float32, d) == "fa_fwd_simt"


@pytest.mark.parametrize("d,bf16,f32", [
    (32, "fa_fwd_wgmma", "fa_fwd_simt"), (64, "fa_fwd_wgmma", "fa_fwd_simt"),
    (80, "fa_fwd_wgmma", "fa_fwd_simt"), (128, "fa_fwd_wgmma", "fa_fwd_simt")])
def test_attention_variant_by_head_dim(d, bf16, f32):
    assert d in fa.HEAD_DIMS
    assert fa.variant(torch.bfloat16, d) == bf16
    assert fa.variant(torch.float32, d) == f32


@pytest.mark.parametrize("d,bf16,f32", [
    (32, "fa_bwd_wgmma", "fa_bwd_simt"), (64, "fa_bwd_wgmma", "fa_bwd_simt"),
    (80, "fa_bwd_wgmma", "fa_bwd_simt"), (128, "fa_bwd_wgmma", "fa_bwd_simt")])
def test_attention_backward_variant_by_head_dim(d, bf16, f32):
    """The backward follows the forward's rule: bf16 at every head dim on
    wgmma + TMA (two CUDA kernels, dQ first; at 32 and 80 the last 64-column
    atom zero-filled past D), float32 on the fp32 pipes.  The mma.sync
    variant (three CUDA kernels) is never the rule's."""
    assert d in fa.HEAD_DIMS
    assert fa.variant_bwd(torch.bfloat16, d) == bf16
    assert fa.variant_bwd(torch.float32, d) == f32
    assert fa.VARIANT_KERNELS_BWD[bf16] == ("fa_bwd_dq_wgmma", "fa_bwd_dkdv_wgmma")
    assert fa.VARIANT_KERNELS_BWD["fa_bwd_bf16_mma"] == (
        "fa_bwd_delta", "fa_bwd_dkdv_mma", "fa_bwd_dq_mma")
    assert "fa_fwd_bf16_mma" not in {fa.variant(t, d) for t in fa.DTYPE_CODES}


def test_attention_variant_refuses_what_no_kernel_takes():
    for dtype, d in ((torch.float16, 64), (torch.bfloat16, 48), (torch.float32, 256)):
        with pytest.raises(ValueError, match="no kernel"):
            fa.variant(dtype, d)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssd_variant_of_every_ported_config(arch):
    """mamba2-1.3b's (P 64, N 128, chunk 256) and zamba2-1.2b's (P 64, N 64,
    chunk 256) in bf16 run the two wgmma kernels forward and the wgmma
    backward; in float32 the fp32-pipe ones."""
    cfg = get_config(arch)
    shape = (cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk)
    assert ssd.variant(torch.bfloat16, *shape) == "ssd_wgmma"
    assert ssd.variant(torch.float32, *shape) == "ssd_fwd_kernel"
    assert ssd.variant_bwd(torch.bfloat16, *shape) == "ssd_bwd_wgmma"
    assert ssd.variant_bwd(torch.float32, *shape) == "ssd_bwd_simt"
    assert ssd.VARIANT_KERNELS["ssd_wgmma"] == ("ssd_state_wgmma", "ssd_out_wgmma")
    assert ssd.VARIANT_KERNELS["ssd_fwd_kernel"] == ("ssd_fwd_kernel",)


@pytest.mark.parametrize("P,N,chunk,expected", [
    (64, 128, 64, "ssd_wgmma"), (64, 128, 128, "ssd_wgmma"),
    (64, 128, 256, "ssd_wgmma"), (64, 128, 32, "ssd_fwd_kernel"),
    (32, 128, 256, "ssd_fwd_kernel"), (64, 64, 256, "ssd_wgmma"),
    (16, 8, 32, "ssd_fwd_kernel"), (64, 64, 64, "ssd_wgmma"),
    (64, 64, 128, "ssd_wgmma"), (64, 64, 32, "ssd_fwd_kernel"),
    (64, 96, 256, "ssd_fwd_kernel"), (32, 64, 256, "ssd_fwd_kernel")])
def test_ssd_variant_by_shape(P, N, chunk, expected):
    """bf16 at P 64, N 64 or 128 (one or two 64-column atoms of the state),
    chunk 64 and up runs on wgmma, forward and backward; the rest, and every
    float32 input, on the fp32 pipes."""
    assert ssd.variant(torch.bfloat16, P, N, chunk) == expected
    assert ssd.variant(torch.float32, P, N, chunk) == "ssd_fwd_kernel"
    backward = {"ssd_wgmma": "ssd_bwd_wgmma", "ssd_fwd_kernel": "ssd_bwd_simt"}
    assert ssd.variant_bwd(torch.bfloat16, P, N, chunk) == backward[expected]
    assert ssd.variant_bwd(torch.float32, P, N, chunk) == "ssd_bwd_simt"


def test_ssd_variant_refuses_what_no_kernel_takes():
    for dtype, shape in ((torch.float16, (64, 128, 256)),
                         (torch.bfloat16, (64, 128, 48)),
                         (torch.bfloat16, (66, 128, 256))):
        with pytest.raises(ValueError, match="no kernel"):
            ssd.variant(dtype, *shape)


@pytest.mark.parametrize("module", [fa, ssd], ids=["flash_attention", "ssd_scan"])
def test_variant_codes_are_the_c_functions(module):
    """The rule lives in variant() alone: the wrapper passes the C function
    the code of the variant it names, and the source's enum gives each code
    the same kernel."""
    in_source = {name: int(code) for code, name in re.findall(
        r"k\w+ = (\d+),\s*// (\w+)", module.SOURCE.read_text())}
    assert in_source == module.VARIANT_CODES
    assert set(module.VARIANT_CODES) == set(module.VARIANT_KERNELS)


@pytest.mark.parametrize("module", [fa, ssd], ids=["flash_attention", "ssd_scan"])
def test_launch_counters_name_every_variants_kernels(module):
    """The C function counts each launch under the kernel's name
    (kKernelNames, read through kernel.launch_counts()); those names are the
    CUDA kernels that VARIANT_KERNELS gives the variants, once each, so a
    reading of the counts around one call names the variant that ran."""
    table = re.search(r"kKernelNames\[kNumKernels\] = \{([^}]*)\}",
                      module.SOURCE.read_text()).group(1)
    in_source = re.findall(r'"(\w+)"', table)
    assert len(in_source) == len(set(in_source))
    assert set(in_source) == {k for ks in module.VARIANT_KERNELS.values() for k in ks}


@pytest.mark.parametrize("module,args", [
    (fa, (torch.bfloat16, 64)), (fa, (torch.bfloat16, 80)),
    (fa, (torch.float32, 128)), (ssd, (torch.bfloat16, 64, 128, 256)),
    (ssd, (torch.bfloat16, 64, 128, 32)), (ssd, (torch.float32, 64, 128, 256)),
    (ssd, (torch.bfloat16, 64, 64, 256))])
def test_every_variant_named_has_a_code(module, args):
    name = module.variant(*args)
    assert name in module.VARIANT_CODES and name in module.VARIANT_KERNELS


def _offset(shape, dtype, elements=1):
    """A CPU tensor of `shape` whose data starts `elements` past an
    allocation's start: off any 16-byte boundary."""
    flat = torch.zeros(elements + torch.Size(shape).numel(), dtype=dtype)
    return flat[elements:].view(shape)


@pytest.mark.parametrize("bad", ["base", "rows"])
@pytest.mark.parametrize("d", [32, 64, 80, 128])
def test_attention_wrapper_refuses_what_tma_cannot_take(bad, d):
    """bf16 at every head dim reaches TMA (rows of 64, 128, 160, 256 bytes):
    a base or a row stride off a 16-byte boundary raises, on CPU tensors,
    before the device check."""
    def ok(h):
        return torch.zeros((1, h, 16, d), dtype=torch.bfloat16)
    q, k, v = ok(4), ok(2), ok(2)
    if bad == "base":
        q = _offset((1, 4, 16, d), torch.bfloat16)
    else:   # rows d + 4 elements apart
        q = torch.zeros((1, 4, 16, d + 4), dtype=torch.bfloat16)[..., :d]
    assert fa.variant(q.dtype, d) == "fa_fwd_wgmma"
    with pytest.raises(ValueError, match="16-byte boundary"):
        fa.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensors"):   # aligned: next check
        fa.flash_attention_fwd(ok(4), k, v)


@pytest.mark.parametrize("name,dtype,d", [
    ("fa_fwd_wgmma", torch.float32, 80), ("fa_fwd_bf16_mma", torch.float32, 32),
    ("fa_fwd_simt", torch.bfloat16, 64), ("fa_fwd_none", torch.bfloat16, 128)])
def test_explicit_forward_variant_that_does_not_take_raises(name, dtype, d):
    """``variant=`` overrides the forward's rule only with a kernel that takes
    the dtype and head dim: anything else raises before the device check."""
    q = torch.zeros((1, 4, 16, d), dtype=dtype)
    kv = torch.zeros((1, 2, 16, d), dtype=dtype)
    with pytest.raises(ValueError, match="has no kernel"):
        fa.flash_attention_fwd(q, kv, kv, variant=name)


@pytest.mark.parametrize("name,dtype,d", [
    ("fa_fwd_wgmma", torch.bfloat16, 32), ("fa_fwd_wgmma", torch.bfloat16, 80),
    ("fa_fwd_bf16_mma", torch.bfloat16, 80), ("fa_fwd_simt", torch.float32, 80)])
def test_explicit_forward_variant_that_takes_reaches_the_device_check(name, dtype, d):
    q = torch.zeros((1, 4, 16, d), dtype=dtype)
    kv = torch.zeros((1, 2, 16, d), dtype=dtype)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_fwd(q, kv, kv, variant=name, return_lse=True)


@pytest.mark.parametrize("which", ["x", "B", "C"])
def test_ssd_wrapper_refuses_what_tma_cannot_take(which):
    """The wgmma variant loads x, B and C by TMA: at N 64 and 128 (rows of B
    and C of 128 and 256 bytes) a base off a 16-byte boundary raises, on CPU
    tensors, before the device check; named instead, the fp32-pipe variant
    reads element by element and takes it."""
    Bsz, S, H, P, G = 1, 64, 2, 64, 1
    bf = torch.bfloat16
    for N in (64, 128):
        t = {"x": torch.zeros((Bsz, S, H, P), dtype=bf),
             "B": torch.zeros((Bsz, S, G, N), dtype=bf),
             "C": torch.zeros((Bsz, S, G, N), dtype=bf)}
        dt, A = torch.zeros((Bsz, S, H)), torch.zeros((H,))
        assert ssd.variant(bf, P, N, 64) == "ssd_wgmma"
        with pytest.raises(ValueError, match="CUDA tensors"):   # aligned: next check
            ssd.ssd_scan_fwd(t["x"], dt, A, t["B"], t["C"], chunk=64)
        t[which] = _offset(tuple(t[which].shape), bf)
        with pytest.raises(ValueError, match="16-byte boundary"):
            ssd.ssd_scan_fwd(t["x"], dt, A, t["B"], t["C"], chunk=64)
        with pytest.raises(ValueError, match="CUDA tensors"):
            ssd.ssd_scan_fwd(t["x"], dt, A, t["B"], t["C"], chunk=64,
                             variant="ssd_fwd_kernel")


@pytest.mark.parametrize("which", ["x", "dy", "B", "C"])
def test_ssd_backward_refuses_what_tma_cannot_take(which):
    """The backward's wgmma variant loads x, dy, B and C by TMA: at N 64 and
    128 a base off a 16-byte boundary raises, on CPU tensors, before the
    device check; named instead, the fp32-pipe variant reads element by
    element and takes it."""
    Bsz, S, H, P, G = 1, 64, 2, 64, 1
    bf = torch.bfloat16
    for N in (64, 128):
        t = {"x": torch.zeros((Bsz, S, H, P), dtype=bf),
             "dy": torch.zeros((Bsz, S, H, P), dtype=bf),
             "B": torch.zeros((Bsz, S, G, N), dtype=bf),
             "C": torch.zeros((Bsz, S, G, N), dtype=bf)}
        dt, A = torch.zeros((Bsz, S, H)), torch.zeros((H,))

        def call(**kw):
            return ssd.ssd_scan_bwd(t["x"], dt, A, t["B"], t["C"], t["dy"], chunk=64,
                                    **kw)
        assert ssd.variant_bwd(bf, P, N, 64) == "ssd_bwd_wgmma"
        with pytest.raises(ValueError, match="CUDA tensors"):   # aligned: next check
            call()
        t[which] = _offset(tuple(t[which].shape), bf)
        with pytest.raises(ValueError, match="16-byte boundary"):
            call()
        with pytest.raises(ValueError, match="CUDA tensors"):
            call(variant="ssd_bwd_simt")


def _ssd_args(dtype, P, N, chunk):
    """CPU tensors the forward's wrapper checks; the device check comes last."""
    B, S, H, G = 1, 64, 2, 1
    return (torch.zeros((B, S, H, P), dtype=dtype), torch.zeros((B, S, H)),
            torch.zeros((H,)), torch.zeros((B, S, G, N), dtype=dtype),
            torch.zeros((B, S, G, N), dtype=dtype)), {"chunk": chunk}


@pytest.mark.parametrize("name,dtype,shape", [
    ("ssd_wgmma", torch.float32, (64, 128, 256)),
    ("ssd_wgmma", torch.float32, (64, 64, 256)),
    ("ssd_wgmma", torch.bfloat16, (64, 64, 32)),
    ("ssd_wgmma", torch.bfloat16, (64, 96, 256)),
    ("ssd_wgmma", torch.bfloat16, (32, 64, 256)),
    ("ssd_none", torch.bfloat16, (64, 64, 256))])
def test_ssd_explicit_forward_variant_that_does_not_take_raises(name, dtype, shape):
    """``variant=`` overrides the scan forward's rule only with a kernel that
    takes the dtype and (P, N, chunk): anything else raises before the device
    check."""
    args, kw = _ssd_args(dtype, *shape)
    with pytest.raises(ValueError, match="has no kernel"):
        ssd.ssd_scan_fwd(*args, variant=name, **kw)


@pytest.mark.parametrize("name,dtype,shape", [
    ("ssd_fwd_kernel", torch.bfloat16, (64, 64, 256)),
    ("ssd_fwd_kernel", torch.bfloat16, (64, 128, 64)),
    ("ssd_wgmma", torch.bfloat16, (64, 64, 64)),
    ("ssd_wgmma", torch.bfloat16, (64, 128, 128)),
    ("ssd_fwd_kernel", torch.float32, (16, 8, 32))])
def test_ssd_explicit_forward_variant_that_takes_reaches_the_device_check(
        name, dtype, shape):
    """The fp32-pipe variant takes what the rule gives wgmma (to time the
    two); the wgmma variant takes its own domain."""
    args, kw = _ssd_args(dtype, *shape)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd.ssd_scan_fwd(*args, variant=name, **kw)


def test_fp32_pipes_need_no_tma_alignment():
    """The fp32-pipe SSD kernel reads element by element: an offset base is
    no reason to refuse it (the device check is what stops it here)."""
    x = _offset((1, 64, 2, 64), torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd.ssd_scan_fwd(x, torch.zeros((1, 64, 2)), torch.zeros((2,)),
                         torch.zeros((1, 64, 1, 128)), torch.zeros((1, 64, 1, 128)),
                         chunk=64)
