"""AdamW's global norm and update on K4 (``repro_torch.kernels.adamw``).

On the CPU: the optimizer's CPU leaves take the plain version and give the
bits the leaf-by-leaf update gave before K4 (``_leaf_by_leaf`` keeps it);
the launch plan covers every element of every leaf once; the wrapper refuses
leaves on two devices, non-contiguous leaves and mismatched shapes, its
kernel path a param or moment given twice, and a leaf off the CPU never
takes the plain version; the source's constants and C signatures agree with
the binding.

On the card (marker ``cuda``; skipped without one): the update kernel against
the plain version at DeepSeek-V2-Lite's leaf shapes, an odd size and an offset
view that is not 16-byte aligned, in every (param, grad) type, with the clip
engaged and not, three steps in a row: params and moments bit-equal, given
the same scalars (the kernel computes the plain version's fp32 expression in
its order, without fused multiply-adds).  The norm within 1e-6 of a float64
sum (it sums in its own order) and bit-equal run to run.  One optimizer step
over DeepSeek's 6-layer leaf set (3.42 B parameters) launches each K4 kernel
once and no kernel a leaf.
"""
import ctypes
import re

import pytest
import torch

from repro_torch import spans
from repro_torch.kernels import _build
from repro_torch.kernels.adamw import kernel as k4
from repro_torch.kernels.adamw import ops
from repro_torch.kernels.adamw.ref import adamw_update_ref, sum_of_squares_ref
from repro_torch.models.common import tree_leaves
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_lr

BF16, F32 = torch.bfloat16, torch.float32
NORM_TOL = 1e-6
# DeepSeek-V2-Lite's leaf shapes (6 layers): a norm scale, a router (fp32
# params), an expert stack, the embedding; then an odd size
SHAPES = {"scale": (2048,), "router": (2048, 64), "experts": (64, 2048, 1408),
          "embedding": (102400, 2048), "odd": (1_000_003,)}
CARD_SHAPES = list(SHAPES) + ["offset_view"]


def _leaf_by_leaf(cfg, params, grads, state):
    """The optimizer's update as it was written before K4, leaf by leaf."""
    step = state["step"] + 1
    lr = cosine_lr(cfg, step)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(x.float()))
                           for x in tree_leaves(grads)))
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    b1t = 1.0 - cfg.b1 ** step.float()
    b2t = 1.0 - cfg.b2 ** step.float()
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        g = g.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        mh = m / b1t
        vh = v / b2t
        p32 = p.float()
        p32 = p32 - lr * (mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p32)
        p.copy_(p32.to(p.dtype))
    return params, {"m": state["m"], "v": state["v"], "step": step}


def _tree(gen, dtype, device="cpu", scale=1.0):
    shapes = {"w": (33, 17), "b": (17,), "layers": [{"k": (5, 8)}, {"k": (5, 8)}]}

    def make(s):
        return (scale * torch.randn(s, generator=gen)).to(dtype).to(device)
    return {"w": make(shapes["w"]), "b": make(shapes["b"]),
            "layers": [{"k": make(l["k"])} for l in shapes["layers"]]}


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


# -- CPU ------------------------------------------------------------------------

@pytest.mark.parametrize("param_dtype", [F32, BF16])
@pytest.mark.parametrize("grad_dtype", [F32, BF16])
@pytest.mark.parametrize("clip", [1.0, 1e-2])
def test_cpu_update_equals_the_leaf_by_leaf_update(param_dtype, grad_dtype, clip):
    """Three steps of the optimizer on CPU leaves: params, moments and step
    bit-equal to the update as it was written before K4."""
    gen = torch.Generator().manual_seed(7)
    cfg = AdamWConfig(lr=3e-2, warmup_steps=2, total_steps=10, clip_norm=clip)
    mine = _tree(gen, param_dtype)
    ref = {"w": mine["w"].clone(), "b": mine["b"].clone(),
           "layers": [{"k": l["k"].clone()} for l in mine["layers"]]}
    s_mine, s_ref = adamw_init(mine), adamw_init(ref)
    for _ in range(3):
        grads = _tree(gen, grad_dtype, scale=0.5)
        mine, s_mine = adamw_update(cfg, mine, grads, s_mine)
        ref, s_ref = _leaf_by_leaf(cfg, ref, grads, s_ref)
        for a, b in zip(tree_leaves((mine, s_mine["m"], s_mine["v"])),
                        tree_leaves((ref, s_ref["m"], s_ref["v"]))):
            assert _same_bits(a, b)
        assert int(s_mine["step"]) == int(s_ref["step"])


def test_cpu_norm_is_the_plain_sum():
    gen = torch.Generator().manual_seed(3)
    grads = tree_leaves(_tree(gen, F32)) + tree_leaves(_tree(gen, BF16))
    total, root = ops.sum_of_squares(grads)
    want = sum(torch.sum(torch.square(g.float())) for g in grads)
    assert _same_bits(total, want) and _same_bits(root, torch.sqrt(want))


def _deepseek_numels():
    from repro_torch.configs import get_config
    from repro_torch.models.common import get_model
    cfg = get_config("deepseek-v2-lite-16b").replace(num_layers=6)
    return [x.numel() for x in tree_leaves(get_model(cfg).init(cfg, torch.Generator(), "meta"))]


def _chunk_span(launch, numels, c):
    """(leaf, first element, end) of the launch's chunk ``c``, found as the
    kernels find it (``leaf_of`` in the source): the last leaf whose first
    chunk is at most ``c``."""
    lo, hi = 0, len(launch.leaves) - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if launch.chunk0[mid] <= c:
            lo = mid
        else:
            hi = mid - 1
    leaf = launch.leaves[lo]
    start = (c - launch.chunk0[lo]) * k4.CHUNK
    return leaf, start, min(numels[leaf], start + k4.CHUNK)


@pytest.mark.parametrize("numels", [
    [1], [k4.CHUNK], [k4.CHUNK + 1, 7, 0, 3 * k4.CHUNK - 5, 0],
    [1000 + 37 * i for i in range(2 * k4.MAX_LEAVES + 9)],
    [0] * 5 + [k4.CHUNK * 2] * (k4.MAX_LEAVES + 1) + [0],
    "deepseek"])
def test_plan_covers_every_element_of_every_leaf_once(numels):
    if numels == "deepseek":
        numels = _deepseek_numels()
        assert len(numels) == 83 and sum(numels) == 3_424_675_840
    launches = k4.plan(numels)
    covered = {i: [] for i, n in enumerate(numels) if n}
    for launch in launches:
        assert 1 <= len(launch.leaves) <= k4.MAX_LEAVES
        assert list(launch.leaves) == sorted(launch.leaves)
        for c in range(launch.chunks):
            leaf, lo, hi = _chunk_span(launch, numels, c)
            assert leaf in launch.leaves and 0 <= lo < hi <= numels[leaf]
            assert lo % 8 == 0                      # 16-byte aligned in a vector leaf
            covered[leaf].append((lo, hi))
    assert [i for l in launches for i in l.leaves] == sorted(covered)
    for leaf, spans_ in covered.items():
        spans_.sort()
        assert spans_[0][0] == 0 and spans_[-1][1] == numels[leaf]
        assert all(a[1] == b[0] for a, b in zip(spans_, spans_[1:]))
    if len(numels) == 83:                            # DeepSeek: one launch each
        assert len(launches) == 1


def test_kind_codes_each_type_pair():
    assert {(p, g): k4.kind(p, g) for p in k4.DTYPES for g in k4.DTYPES} == {
        (F32, F32): 0, (F32, BF16): 1, (BF16, F32): 2, (BF16, BF16): 3}


def _update_args(device="cpu"):
    leaf = lambda dtype=F32, shape=(4, 3), dev=device: torch.zeros(shape, dtype=dtype, device=dev)  # noqa: E731
    p, g, m, v = [leaf(BF16)], [leaf()], [leaf()], [leaf()]
    scalars = {k: torch.ones((), device=device) for k in ("scale", "lr", "b1t", "b2t")}
    return p, g, m, v, scalars, leaf


@pytest.mark.parametrize("fault", ["mixed_devices", "scalar_on_another_device",
                                   "non_contiguous_grad", "non_contiguous_param",
                                   "shape", "moment_dtype", "grad_dtype", "lengths"])
def test_update_wrapper_raises(fault):
    p, g, m, v, scalars, leaf = _update_args()
    if fault == "mixed_devices":
        p, g, m, v = p + [leaf(BF16, dev="meta")], g + [leaf(dev="meta")], \
            m + [leaf(dev="meta")], v + [leaf(dev="meta")]
    elif fault == "scalar_on_another_device":
        scalars["lr"] = torch.ones((), device="meta")
    elif fault == "non_contiguous_grad":
        g = [leaf(shape=(3, 4)).t()]
    elif fault == "non_contiguous_param":
        p = [leaf(BF16, shape=(3, 4)).t()]
    elif fault == "shape":
        v = [leaf(shape=(3, 4))]
    elif fault == "moment_dtype":
        m = [leaf(BF16)]
    elif fault == "grad_dtype":
        g = [leaf(torch.float16)]
    else:
        g = g + g
    with pytest.raises(ValueError):
        ops.adamw_update(p, g, m, v, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                         **scalars)


@pytest.mark.parametrize("twice", ["param", "moment", "param_as_moment"])
def test_the_kernel_path_refuses_a_leaf_written_twice(twice):
    """One launch updates every leaf at once, so a param or moment given twice
    would race there (the plain version updates one leaf after another)."""
    p, g, m, v, _, leaf = _update_args()
    p, m, v = p + [leaf(BF16)], m + [leaf()], v + [leaf()]
    if twice == "param":
        p[1] = p[0]
    elif twice == "moment":
        v[1] = v[0]
    else:
        p[1] = m[0]
    with pytest.raises(ValueError, match="twice"):
        k4.check_written_once(p, m, v)
    k4.check_written_once(p[:1], m[:1], v[:1])


@pytest.mark.parametrize("fault", ["mixed_devices", "non_contiguous", "empty"])
def test_norm_wrapper_raises(fault):
    x = torch.ones(4, 3)
    grads = {"mixed_devices": [x, torch.ones(3, device="meta")],
             "non_contiguous": [x.t()], "empty": []}[fault]
    with pytest.raises(ValueError):
        ops.sum_of_squares(grads)


def test_leaves_off_the_cpu_never_take_the_plain_version():
    """A leaf on any device but the CPU goes to the kernels, which take CUDA
    tensors alone: on the meta device the wrapper raises, it does not fall
    back."""
    p, g, m, v, scalars, _ = _update_args("meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.adamw_update(p, g, m, v, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                         **scalars)
    with pytest.raises(ValueError, match="CUDA"):
        ops.sum_of_squares(g)


def test_source_agrees_with_the_binding():
    """The chunk and the leaves a launch in the source are the wrapper's; each
    C function takes as many arguments as its binding gives; the source is
    built without fused multiply-adds."""
    src = k4.SOURCE.read_text()
    assert int(re.search(r"kChunk = 1 << (\d+);", src).group(1)) == k4.CHUNK.bit_length() - 1
    assert int(re.search(r"kMaxLeaves = (\d+);", src).group(1)) == k4.MAX_LEAVES
    assert "-fmad=false" in _build.SOURCE_FLAGS[k4.SOURCE.stem]

    class Fn:
        argtypes = restype = None

    class Lib:
        adamw_sumsq, adamw_update, adamw_error_string = Fn(), Fn(), Fn()
    lib = k4.bind(Lib())
    for name in ("adamw_sumsq", "adamw_update"):
        sig = re.search(r'extern "C" int ' + name + r"\((.*?)\)", src, re.S).group(1)
        assert len(sig.split(",")) == len(getattr(lib, name).argtypes)
        assert ctypes.c_void_p in getattr(lib, name).argtypes
    for name in k4.KERNELS:
        assert f'"{name}"' in src


# -- the card -------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4 runs only there")


def _leaves_on_card(name, param_dtype, grad_dtype, gen):
    """(p, g, m, v) of one leaf on the card; ``offset_view`` is a view one
    element into a buffer, so no pointer of it is 16-byte aligned."""
    n = 4096 * 3 + 5
    shape = (n,) if name == "offset_view" else SHAPES[name]

    def make(dtype, scale, positive=False):
        x = torch.randn(shape, generator=gen, device="cuda") * scale
        x = x.abs() if positive else x
        if name == "offset_view":
            buf = torch.empty(n + 1, dtype=dtype, device="cuda")
            buf[1:] = x
            return buf[1:]
        return x.to(dtype)
    return (make(param_dtype, 1.0), make(grad_dtype, 0.3), make(F32, 0.05),
            make(F32, 0.01, positive=True))


def _scalars(cfg, step, gnorm):
    t = torch.tensor(float(step), device="cuda")
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    return dict(scale=scale, lr=cosine_lr(cfg, t), b1t=1.0 - cfg.b1 ** t,
                b2t=1.0 - cfg.b2 ** t)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_SHAPES)
@pytest.mark.parametrize("param_dtype", [F32, BF16])
@pytest.mark.parametrize("grad_dtype", [F32, BF16])
@pytest.mark.parametrize("clip", [1e9, 1e-3])
def test_update_is_bit_equal_to_the_plain_version(card, name, param_dtype, grad_dtype,
                                                  clip):
    gen = torch.Generator(device="cuda").manual_seed(11)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10, clip_norm=clip)
    p, g, m, v = _leaves_on_card(name, param_dtype, grad_dtype, gen)
    mine = [p, m, v]
    ref = [x.clone() for x in mine]
    hyper = dict(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps, weight_decay=cfg.weight_decay)
    before = k4.launch_counts()["adamw_update"]
    for step in (1, 2, 3):
        g = g * 1.1 if step > 1 else g
        gnorm = sum_of_squares_ref([g])[1]
        assert (float(gnorm) > clip) == (clip < 1.0)   # the clip engaged or not
        sc = _scalars(cfg, step, gnorm)
        ops.adamw_update([mine[0]], [g], [mine[1]], [mine[2]], **sc, **hyper)
        adamw_update_ref([ref[0]], [g], [ref[1]], [ref[2]], **sc, **hyper)
        torch.cuda.synchronize()
        for a, b in zip(mine, ref):
            assert _same_bits(a, b), (name, step)
    assert k4.launch_counts()["adamw_update"] == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("grad_dtype", [F32, BF16])
def test_norm_on_card(card, grad_dtype):
    """The sum of squares of every card shape at once, and of 300 leaves (three
    launches, summed in order), within 1e-6 of float64; two runs bit-equal."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    sets = [[_leaves_on_card(n, F32, grad_dtype, gen)[1] for n in CARD_SHAPES],
            [torch.randn(1000 + 7 * i, generator=gen, device="cuda").to(grad_dtype)
             for i in range(300)]]
    for grads in sets:
        launches = len(k4.plan([x.numel() for x in grads]))
        before = k4.launch_counts()["adamw_sumsq"]
        total, root = ops.sum_of_squares(grads)
        again, _ = ops.sum_of_squares(grads)
        want = sum(float(torch.sum(x.double() ** 2)) for x in grads)
        assert abs(float(total) - want) <= NORM_TOL * want
        assert float(root) == pytest.approx(want ** 0.5, rel=NORM_TOL)
        assert _same_bits(total, again)
        assert k4.launch_counts()["adamw_sumsq"] == before + 2 * launches


@pytest.mark.cuda
def test_a_deepseek_step_launches_k4_and_no_kernel_a_leaf(card):
    """One optimizer step over DeepSeek-V2-Lite's 6-layer leaf set (83 leaves,
    bf16 params and fp32 routers, fp32 grads): each K4 kernel launches once,
    the counter counts one call, and the step launches as many device
    kernels as a step over two leaves: K4's two and the schedule's scalar
    operations."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import get_model, tree_map
    cfg = get_config("deepseek-v2-lite-16b").replace(num_layers=6)
    meta = get_model(cfg).init(cfg, torch.Generator(), "meta")
    kernels = {}
    for name, tree in (("two_leaves", {"a": meta["embed"], "b": meta["final_norm"]}),
                       ("deepseek", meta)):
        params = tree_map(lambda x: torch.full(x.shape, 0.01, dtype=x.dtype, device="cuda"),
                          tree)
        grads = tree_map(lambda x: torch.full(x.shape, 1e-4, dtype=F32, device="cuda"), tree)
        state = adamw_init(params)
        params, state = adamw_update(AdamWConfig(), params, grads, state)   # warm
        torch.cuda.synchronize()
        before, calls = k4.launch_counts(), spans.counters()["kernel.adamw"]
        adamw_update(AdamWConfig(), params, grads, state)
        after = k4.launch_counts()
        assert {k: after[k] - before[k] for k in after} == {"adamw_sumsq": 1, "adamw_update": 1}
        assert spans.counters()["kernel.adamw"] == calls + 1
        kernels[name] = _kernels_of(lambda: adamw_update(AdamWConfig(), params, grads, state))
        assert sum("adamw" in k for k in kernels[name]) == 2, kernels[name]
        del params, grads, state
    assert len(tree_leaves(meta)) == 83
    assert len(kernels["deepseek"]) == len(kernels["two_leaves"]), kernels["deepseek"]


def _kernels_of(fn, burn: int = 1000, tries: int = 5):
    """The names of the device kernels of one call of ``fn``, by
    torch.profiler.  The profiler can lose the first records of a session in
    a process that has run a while, so small throwaway kernels open it, only
    kernels that start after their synchronize count, and the session runs
    again, up to ``tries`` times, while it read neither K4 kernel."""
    x = torch.zeros(1, device="cuda")
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(burn):
                x.add_(1)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        opened = min(e.time_range.end for e in events if e.name == "cudaDeviceSynchronize")
        names = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.time_range.start >= opened]
        if any("adamw" in n for n in names):
            break
    return names
