"""Checkpoints of parameter trees: npz + manifest, written atomically,
optionally on a background thread (the reference's
``checkpoint/checkpointer.py``).

Layout:  ``<dir>/step_<N>/manifest.json`` + ``arrays.npz``, the same as
the reference's, so a checkpoint written by either package restores in the
other with numpy alone.  Leaf keys are the tree path joined with ``/``
(dict keys in sorted order, list items by index: JAX's leaf order); a
bf16 leaf is stored as its raw 16 bits under ``"dtype": "bfloat16"``; a
Python int leaf (the port's optimizer ``step``) is stored as a 0-d int32,
which is what the reference keeps there, and restores as an int.

Writes go to ``<dir>/.tmp_step_<N>`` and are renamed into place, so a crash
mid-write never leaves a partial ``step_<N>``.  :class:`Checkpointer` keeps
the last ``keep`` checkpoints and copies every tensor to the host before
its writer thread starts.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.trees import tree_flatten, tree_unflatten

Tree = Any


def _flatten_with_paths(tree: Tree) -> List[Tuple[str, Any]]:
    """``(key, leaf)`` pairs in leaf order, keys as the reference joins
    them (``checkpointer.py:_flatten_with_paths``)."""
    out: List[Tuple[str, Any]] = []

    def rec(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                rec(t[k], path + (str(k),))
        elif isinstance(t, list):
            for i, x in enumerate(t):
                rec(x, path + (str(i),))
        else:
            out.append(("/".join(path), t))

    rec(tree, ())
    return out


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the numpy array the npz stores (bf16 as its raw bits),
    and the dtype name the manifest records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    elif isinstance(leaf, int):
        arr = np.asarray(leaf, dtype=np.int32)
    else:
        arr = np.array(leaf)
    if arr.dtype.name == "bfloat16":  # a JAX (ml_dtypes) bf16 array
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _host_tree(tree: Tree) -> List[Tuple[str, np.ndarray, str]]:
    """``(key, host array, dtype name)`` for every leaf, copied now."""
    return [(key,) + _to_host(leaf)
            for key, leaf in _flatten_with_paths(tree)]


def _write(flat: List[Tuple[str, np.ndarray, str]], directory: str,
           step: int, extra: Optional[Dict[str, Any]]) -> str:
    tmp = os.path.join(directory, f".tmp_step_{step}")
    final = os.path.join(directory, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    arrays = {}
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (key, arr, dtype_name) in enumerate(flat):
        arrays[f"a{i}"] = arr
        manifest["leaves"].append(
            {"key": key, "idx": i, "shape": list(arr.shape),
             "dtype": dtype_name})
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_tree(tree: Tree, directory: str, step: int, *,
              extra: Optional[Dict[str, Any]] = None) -> str:
    """Blocking save.  Returns the checkpoint path."""
    return _write(_host_tree(tree), directory, step, extra)


def _leaf(arr: np.ndarray, dtype_name: str, template, device):
    """One restored leaf in the template leaf's kind: an int for an int,
    else a tensor on ``device`` (default: the template tensor's)."""
    if isinstance(template, int):
        return int(arr)
    if dtype_name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if device is None:
        device = template.device if isinstance(template, torch.Tensor) \
            else "cpu"
    return t.to(device)


def restore_tree(template: Tree, directory: str, step: Optional[int] = None,
                 *, device=None) -> Tuple[Tree, int]:
    """Restore into the structure of ``template`` (values replaced), each
    tensor on ``device`` (default: where the template's leaf is).  Returns
    ``(tree, step)``; ``step=None`` takes the latest checkpoint."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {m["key"]: m for m in manifest["leaves"]}
    _, treedef = tree_flatten(template)
    leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, tmpl in _flatten_with_paths(template):
            m = by_key[key]
            leaves.append(_leaf(data[f"a{m['idx']}"], m["dtype"], tmpl,
                                device))
    return tree_unflatten(treedef, leaves), step


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


class Checkpointer:
    """Async checkpoint manager with retention."""

    def __init__(self, directory: str, *, keep: int = 3,
                 async_write: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, tree: Tree, step: int, *, extra: Optional[Dict] = None):
        # on the host before the writer thread sees it: the caller may go
        # on updating its tensors
        flat = _host_tree(tree)
        self.wait()

        def work():
            _write(flat, self.directory, step, extra)
            self._gc()

        if self.async_write:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def restore(self, template: Tree, *, step: Optional[int] = None,
                device=None) -> Tuple[Tree, int]:
        self.wait()
        return restore_tree(template, self.directory, step, device=device)

    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)
