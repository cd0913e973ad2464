"""Checkpoints in the JAX package's format (``repro/checkpoint/ckpt.py``), so
that a checkpoint one package writes the other reads.

Layout: ``<ckpt_dir>/step_<n>/arrays.npz`` holds one member per leaf, named
by the leaf's path: its dict keys and list indices joined by "/", dict keys
in sorted order (as ``jax.tree_util`` flattens a tree).  ``manifest.json``
holds ``{"step": n, "keys": {key: [shape, dtype name]}}``.

Fault tolerance: a save writes into ``.tmp_step_<n>``, fsyncs the manifest,
then renames the directory in one step; ``latest_step`` ignores a directory
that has no manifest, so a crash mid-save leaves the previous checkpoint the
latest.  ``AsyncCheckpointer`` copies to the host on the calling thread and
writes on a worker thread.

bfloat16: numpy has no such type without ``ml_dtypes``, which this package
does not use.  A bf16 leaf is written as its two raw bytes an element, the
``|V2`` member that ``np.savez`` writes for the JAX package's
``ml_dtypes.bfloat16`` arrays, under the manifest dtype ``bfloat16``; reading
views those bytes as ``torch.bfloat16`` again.  (The JAX package's own
restore cannot read such a member: its cast from ``|V2`` raises.)
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.common import resolve_device

# the torch types a checkpoint holds, by their manifest names
_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
          torch.int32: "int32", torch.int64: "int64", torch.bool: "bool"}


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) of every tensor or array of a tree of dicts and lists, in
    ``jax.tree_util``'s order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        children = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        children = ((str(i), v) for i, v in enumerate(tree))
    else:
        yield prefix, tree
        return
    for name, child in children:
        yield from _leaves(child, f"{prefix}/{name}" if prefix else name)


def _rebuild(tree, leaves: Dict[str, Any], prefix: str = ""):
    """A tree of ``tree``'s structure holding ``leaves[key]`` at each key."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return leaves[prefix]


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype not in _NAMES:
            raise ValueError(f"no checkpoint dtype for {leaf.dtype}")
        return _NAMES[leaf.dtype]
    return str(np.asarray(leaf).dtype)


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the array ``np.savez`` writes: a tensor's bytes (bf16 as
    ``|V2``), a numpy array as it is."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _to_tensor(key: str, arr: np.ndarray, shape: list, name: str,
               device) -> torch.Tensor:
    """An npz member as a tensor of the manifest's type on ``device``."""
    if list(arr.shape) != shape:
        raise ValueError(f"{key}: member of shape {list(arr.shape)}, manifest {shape}")
    if name == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"{key}: bfloat16 in the manifest, {arr.dtype} in the npz")
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    elif str(arr.dtype) == name:
        t = torch.from_numpy(arr)
    else:
        raise ValueError(f"{key}: {name} in the manifest, {arr.dtype} in the npz")
    return t.to(device)


def save_checkpoint(ckpt_dir: str | Path, step: int, tree: Any) -> Path:
    """Write ``tree`` (dicts and lists of tensors or numpy arrays) as
    ``<ckpt_dir>/step_<step>``, atomically; returns that directory."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f".tmp_step_{step}"
    final = ckpt_dir / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    flat = dict(_leaves(tree))
    arrays = {k: _to_numpy(v) for k, v in flat.items()}
    np.savez(tmp / "arrays.npz", **arrays)
    manifest = {"step": step,
                "keys": {k: [list(arrays[k].shape), _dtype_name(v)]
                         for k, v in flat.items()}}
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                 # atomic publish
    return final


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    """The largest ``n`` of a complete ``step_<n>`` (one with a manifest), or
    None."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for p in ckpt_dir.iterdir():
        if p.name.startswith("step_") and (p / "manifest.json").exists():
            try:
                steps.append(int(p.name.split("_")[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str | Path, step: int, template: Any,
                       device="cuda") -> Any:
    """``step_<step>`` as a tree of ``template``'s structure (dicts and lists
    of tensors; on the ``meta`` device they cost nothing) with a tensor on
    ``device`` at each leaf.  Each leaf's shape and type must be the
    template's and the manifest's; a key missing from the checkpoint, or a
    mismatch, raises and names the key.  ``device`` is ``cuda`` unless the
    caller names another; with no card that raises."""
    device = resolve_device(device)
    path = Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((path / "manifest.json").read_text())["keys"]
    leaves = {}
    with np.load(path / "arrays.npz") as npz:
        for key, leaf in _leaves(template):
            if key not in manifest:
                raise KeyError(f"{key!r} is not in the checkpoint {path}")
            shape, name = manifest[key]
            want = [list(leaf.shape), _dtype_name(leaf)]
            if [shape, name] != want:
                raise ValueError(f"{key}: the checkpoint holds {shape} {name}, "
                                 f"the template {want[0]} {want[1]}")
            leaves[key] = _to_tensor(key, npz[key], shape, name, device)
    return _rebuild(template, leaves)


class AsyncCheckpointer:
    """Saves on a worker thread, one save at a time: ``save`` copies every
    tensor to the host on the calling thread, so the caller may go on
    updating its tensors in place at once; ``wait`` joins the worker and
    re-raises its error."""

    def __init__(self, ckpt_dir: str | Path):
        self.ckpt_dir = Path(ckpt_dir)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        host = _rebuild(tree, {
            k: v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in _leaves(tree)})

        def work():
            try:
                save_checkpoint(self.ckpt_dir, step, host)
            except BaseException as e:   # noqa: BLE001 — re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
