"""The port's checkpoints against the JAX package's, on the CPU: the same
directory layout, manifest and npz members, so that a checkpoint either
package writes the other reads bit for bit; the port's own save, restore,
``latest_step`` and ``AsyncCheckpointer``; and the training launcher's
``--ckpt-dir`` / ``--ckpt-every``, saving and resuming.

Trees are made with numpy from a seed and handed to both sides; restored
leaves are compared bit for bit (``torch.equal`` on the same dtype)."""
import json
import os
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_smoke_config as jax_smoke
from repro.models.common import get_model as jax_model
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.checkpoint import (AsyncCheckpointer, from_jax_train_state,
                                   latest_step, restore_checkpoint, save_checkpoint,
                                   to_jax_train_state)
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train
from repro_torch.models.common import get_model, tree_leaves, tree_map
from repro_torch.optim import adamw_init
from repro_torch.testing import from_jax_opt_state, from_jax_params, to_jax_layout

# a family each: both layer lists of whisper, zamba2's per-application LoRAs
ARCHS = ["tinyllama-1.1b", "mamba2-1.3b", "zamba2-1.2b", "whisper-large-v3",
         "qwen2-vl-2b"]


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _meta(tree):
    return tree_map(lambda t: t.to("meta"), tree)


def _jax_state(arch, seed):
    """The JAX package's {"params", "opt"} of ``arch``'s smoke config, from
    ``model.init`` and ``adamw_init``, as numpy; random moments and step, so
    that nothing restored is zero by chance."""
    jcfg = jax_smoke(arch)
    params = jax_model(jcfg).init(jcfg, jax.random.PRNGKey(seed))
    opt = jax_adamw_init(params)
    rng = np.random.default_rng(seed)
    rand = lambda x: rng.standard_normal(np.shape(x)).astype(np.float32)  # noqa: E731
    np_params = jax.tree_util.tree_map(np.asarray, params)
    np_opt = {"m": jax.tree_util.tree_map(rand, opt["m"]),
              "v": jax.tree_util.tree_map(lambda x: np.abs(rand(x)), opt["v"]),
              "step": np.asarray(5, np.int32)}
    return {"params": np_params, "opt": np_opt}


def _port_state(arch, seed):
    """The port's params and AdamW state of ``arch``'s smoke config, with
    random moments and step."""
    cfg = get_smoke_config(arch)
    gen = torch.Generator().manual_seed(seed)
    params = get_model(cfg).init(cfg, gen, "cpu")
    opt = adamw_init(params)
    for m, v in zip(tree_leaves(opt["m"]), tree_leaves(opt["v"])):
        m.normal_(generator=gen)
        v.uniform_(generator=gen)
    opt["step"] = torch.tensor(3, dtype=torch.int32)
    return cfg, params, opt


# -- the port's own save, restore and latest ----------------------------------------

def test_checkpoint_roundtrip_and_latest():
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.ones(4, dtype=torch.int32)},
            "layers": [{"w": torch.full((2,), 2.5)}, {"w": torch.full((2,), -1.0)}]}
    with tempfile.TemporaryDirectory() as d:
        assert latest_step(d) is None
        save_checkpoint(d, 3, tree)
        save_checkpoint(d, 7, tree)
        assert latest_step(d) == 7
        manifest = json.loads((Path(d) / "step_7" / "manifest.json").read_text())
        assert manifest == {"step": 7, "keys": {
            "a": [[2, 3], "float32"], "layers/0/w": [[2], "float32"],
            "layers/1/w": [[2], "float32"], "nested/b": [[4], "int32"]}}
        out = restore_checkpoint(d, 7, tree, device="cpu")
        assert all(_equal(a, b) for a, b in zip(tree_leaves(out), tree_leaves(tree)))
        assert isinstance(out["layers"], list)
        # async path
        ck = AsyncCheckpointer(d)
        ck.save(9, tree)
        ck.wait()
        assert latest_step(d) == 9


def test_checkpoint_incomplete_ignored():
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, {"x": torch.zeros(2)})
        os.makedirs(os.path.join(d, "step_5"))      # torn checkpoint, no manifest
        os.makedirs(os.path.join(d, ".tmp_step_6"))  # a save cut before its rename
        assert latest_step(d) == 1


def test_async_save_copies_before_the_caller_moves_on():
    """``save`` copies on the calling thread: an in-place update right after
    it does not reach the checkpoint."""
    w = torch.zeros(1000)
    with tempfile.TemporaryDirectory() as d:
        ck = AsyncCheckpointer(d)
        ck.save(1, {"w": w})
        w.add_(1.0)
        ck.wait()
        assert torch.equal(restore_checkpoint(d, 1, {"w": w}, device="cpu")["w"],
                           torch.zeros(1000))


def test_async_checkpointer_error_surfaces_on_wait():
    with tempfile.TemporaryDirectory() as d:
        blocker = Path(d) / "a_file"
        blocker.write_text("not a directory")
        ck = AsyncCheckpointer(blocker / "ckpt")
        ck.save(1, {"x": torch.zeros(2)})
        with pytest.raises(OSError):
            ck.wait()
        ck.wait()                                    # the error is raised once
        with pytest.raises(OSError):                 # and a later save's too
            ck.save(2, {"x": torch.zeros(2)})
            ck.wait()


def test_restore_checks_every_leaf_against_the_manifest():
    tree = {"a": torch.zeros(2, 3), "b": torch.zeros(4, dtype=torch.int32)}
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, tree)
        with pytest.raises(ValueError, match=r"a: the checkpoint holds \[2, 3\] float32"):
            restore_checkpoint(d, 1, {**tree, "a": torch.zeros(3, 2)}, device="cpu")
        with pytest.raises(ValueError, match="b: the checkpoint holds .* int32, "
                                             "the template .* int64"):
            restore_checkpoint(d, 1, {**tree, "b": torch.zeros(4, dtype=torch.int64)},
                               device="cpu")
        with pytest.raises(KeyError, match="'c' is not in the checkpoint"):
            restore_checkpoint(d, 1, {**tree, "c": torch.zeros(1)}, device="cpu")
        if not torch.cuda.is_available():           # the default device is the card
            with pytest.raises(RuntimeError, match="no CUDA device"):
                restore_checkpoint(d, 1, tree)


# -- across the two packages ------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_port_restores_the_jax_package_s_train_state(arch):
    """The JAX package's save of a smoke model's {"params", "opt"}, restored
    by the port into its own (meta) template and un-stacked, equals the
    bridge's conversion of the same arrays, bit for bit."""
    state = _jax_state(arch, 1)
    cfg, params, opt = _port_state(arch, 2)
    template = to_jax_train_state(cfg, *_meta((params, opt)))
    with tempfile.TemporaryDirectory() as d:
        jax_save(d, 4, state)
        got_params, got_opt = from_jax_train_state(
            cfg, restore_checkpoint(d, 4, template, device="cpu"))
    want_params = from_jax_params(cfg, state["params"], "cpu")
    want_opt = from_jax_opt_state(cfg, state["opt"], "cpu")
    assert int(got_opt["step"]) == 5 and got_opt["step"].dtype == torch.int32
    for got, want in ((got_params, want_params), (got_opt["m"], want_opt["m"]),
                      (got_opt["v"], want_opt["v"])):
        assert len(tree_leaves(got)) == len(tree_leaves(want)) > 0
        assert all(_equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_package_restores_the_port_s_train_state(arch):
    """The port's save, restored by the JAX package's ``restore_checkpoint``
    with a template from its own ``model.init`` and ``adamw_init``, equals
    the port's state leaf by leaf."""
    cfg, params, opt = _port_state(arch, 3)
    jcfg = jax_smoke(arch)
    jparams = jax_model(jcfg).init(jcfg, jax.random.PRNGKey(0))
    jtemplate = {"params": jparams, "opt": jax_adamw_init(jparams)}
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 3, to_jax_train_state(cfg, params, opt))
        got = jax_restore(d, 3, jtemplate)
    assert int(np.asarray(got["opt"]["step"])) == 3
    for tree, key in ((params, "params"), (opt["m"], "m"), (opt["v"], "v")):
        want = to_jax_layout(cfg, tree)
        got_tree = got["params"] if key == "params" else got["opt"][key]
        pairs = list(zip(jax.tree_util.tree_leaves(got_tree),
                         jax.tree_util.tree_leaves(want)))
        assert len(pairs) == len(jax.tree_util.tree_leaves(want)) > 0
        assert jax.tree_util.tree_structure(got_tree) == jax.tree_util.tree_structure(want)
        for a, b in pairs:
            assert np.asarray(a).shape == b.shape and np.array_equal(np.asarray(a), b)


def _bf16_trees(seed):
    """One tree in each package's types: bf16 leaves (values exact in bf16),
    an fp32 leaf and an int32 step."""
    gen = torch.Generator().manual_seed(seed)
    port = {"embed": torch.randn((5, 3), generator=gen).to(torch.bfloat16),
            "layers": {"w": torch.randn((2, 4, 6), generator=gen).to(torch.bfloat16)},
            "m": torch.randn(7, generator=gen),
            "step": torch.tensor(11, dtype=torch.int32)}
    jax_tree = {"embed": jnp.asarray(port["embed"].float().numpy(), jnp.bfloat16),
                "layers": {"w": jnp.asarray(port["layers"]["w"].float().numpy(),
                                            jnp.bfloat16)},
                "m": jnp.asarray(port["m"].numpy()),
                "step": jnp.asarray(11, jnp.int32)}
    return port, jax_tree


def test_bf16_checkpoints_are_the_same_bytes_in_both_packages():
    """Both packages write each bf16 leaf as the same ``|V2`` npz member,
    byte for byte, under equal manifests; the port restores the JAX
    package's checkpoint and its own."""
    port, jax_tree = _bf16_trees(4)
    with tempfile.TemporaryDirectory() as dj, tempfile.TemporaryDirectory() as dp:
        jax_save(dj, 2, jax_tree)
        save_checkpoint(dp, 2, port)
        read = lambda d, f: (Path(d) / "step_2" / f)  # noqa: E731
        assert json.loads(read(dj, "manifest.json").read_text()) == \
            json.loads(read(dp, "manifest.json").read_text())
        with np.load(read(dj, "arrays.npz")) as a, np.load(read(dp, "arrays.npz")) as b:
            assert sorted(a.files) == sorted(b.files) == ["embed", "layers/w", "m", "step"]
            for key in a.files:
                assert a[key].dtype.str == b[key].dtype.str, key
                assert a[key].shape == b[key].shape and a[key].tobytes() == b[key].tobytes()
            assert a["embed"].dtype.str == "|V2"
        for d in (dj, dp):
            out = restore_checkpoint(d, 2, _meta(port), device="cpu")
            assert all(_equal(x, y) for x, y in zip(tree_leaves(out), tree_leaves(port)))


def test_jax_package_cannot_restore_its_own_bf16_checkpoint():
    """Recorded here, the reference's behaviour: its restore casts the
    ``|V2`` member to bfloat16 and raises, so its launcher's ``--ckpt-dir``
    resume of a bf16 config fails.  The port reads the same checkpoint
    (test above)."""
    _, jax_tree = _bf16_trees(5)
    with tempfile.TemporaryDirectory() as d:
        jax_save(d, 1, jax_tree)
        with np.load(Path(d) / "step_1" / "arrays.npz") as npz:
            assert npz["embed"].dtype != ml_dtypes.bfloat16
        with pytest.raises(ValueError, match="No cast function available"):
            jax_restore(d, 1, jax_tree)


# -- the training launcher ----------------------------------------------------------------

def test_train_launcher_saves_and_resumes(capsys):
    """4 smoke steps saving every 2 leave step_2 and step_4; a second run to
    step 6 restores step 4, whose state equals the first run's end bit for
    bit, and takes steps 4 and 5 from AdamW step 4.  The JAX package reads
    the launcher's checkpoint."""
    cfg = get_smoke_config("tinyllama-1.1b")
    kw = dict(seq=16, batch=4, lr=3e-3, ckpt_every=2, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        first = train.train(cfg, steps=4, ckpt_dir=d, **kw)
        assert sorted(p.name for p in Path(d).iterdir()) == ["step_2", "step_4"]
        assert first["start"] == 0 and int(first["opt"]["step"]) == 4
        capsys.readouterr()
        template = to_jax_train_state(cfg, *_meta((first["params"], first["opt"])))
        saved_params, saved_opt = from_jax_train_state(
            cfg, restore_checkpoint(d, 4, template, device="cpu"))
        assert int(saved_opt["step"]) == 4
        for a, b in zip(tree_leaves((saved_params, saved_opt)),
                        tree_leaves((first["params"], first["opt"]))):
            assert _equal(a, b)

        second = train.train(cfg, steps=6, ckpt_dir=d, **kw)
        assert "[train] restored step 4" in capsys.readouterr().out
        assert second["start"] == 4 and len(second["losses"]) == 2
        assert int(second["opt"]["step"]) == 6
        assert latest_step(d) == 6

        jcfg = jax_smoke("tinyllama-1.1b")
        jparams = jax_model(jcfg).init(jcfg, jax.random.PRNGKey(0))
        got = jax_restore(d, 6, {"params": jparams, "opt": jax_adamw_init(jparams)})
        want = to_jax_layout(cfg, second["params"])
        for a, b in zip(jax.tree_util.tree_leaves(got["params"]),
                        jax.tree_util.tree_leaves(want)):
            assert np.array_equal(np.asarray(a), b)


def test_train_launcher_takes_the_checkpoint_flags(capsys):
    with tempfile.TemporaryDirectory() as d:
        args = ["--device", "cpu", "--preset", "smoke", "--seq", "16", "--batch", "2",
                "--ckpt-dir", d, "--ckpt-every", "1"]
        train.main(args + ["--steps", "2"])
        assert "restored" not in capsys.readouterr().out
        assert sorted(p.name for p in Path(d).iterdir()) == ["step_1", "step_2"]
        train.main(args + ["--steps", "3"])
        out = capsys.readouterr().out
        assert "[train] restored step 2" in out and "step    2 loss" in out
        assert latest_step(d) == 3
