"""Checkpointing: parameter / optimizer-state trees <-> disk.

Port of ``repro.checkpoint.io`` in the reference's format: a flat-key
``arrays.npz`` (keys are the tree paths joined by ``/``) and a JSON
``manifest.json`` (step, keys, extra); an async variant snapshots to host
memory and writes on a background thread, so the train loop never blocks.
A tree is nested dicts / lists / tuples whose leaves are tensors or numpy
arrays; ``restore`` verifies structure and shapes leaf by leaf, so a
checkpoint the reference wrote restores into a tree of the reference's
layout (which ``repro_torch.bridge.from_jax_params`` then loads).
"""
from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_SEP = "/"


def _items(tree, prefix: str = ""):
    """(key path, leaf) pairs in the tree's order."""
    if isinstance(tree, dict):
        children = tree.items()
    elif isinstance(tree, (list, tuple)):
        children = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in children:
        yield from _items(v, f"{prefix}{_SEP}{k}" if prefix else str(k))


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {k: _host(leaf) for k, leaf in _items(tree)}


def save(path: str | Path, tree, *, step: int = 0,
         extra: Optional[dict] = None) -> Path:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)
    np.savez(path / "arrays.npz", **flat)
    manifest = {"step": step, "keys": sorted(flat), "extra": extra or {}}
    (path / "manifest.json").write_text(json.dumps(manifest, indent=1))
    return path


def save_async(path, tree, *, step: int = 0, extra=None) -> threading.Thread:
    """Snapshot to host memory synchronously, write on a worker thread;
    returns the (started) thread, which the caller joins."""
    flat = _flatten(tree)
    t = threading.Thread(target=save, args=(path, flat),
                         kwargs=dict(step=step, extra=extra), daemon=True)
    t.start()
    return t


def _rebuild(like, arrays: Dict[str, np.ndarray], prefix: str = ""):
    if isinstance(like, dict):
        return {k: _rebuild(v, arrays, f"{prefix}{_SEP}{k}" if prefix
                            else str(k)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        out = [_rebuild(v, arrays, f"{prefix}{_SEP}{i}" if prefix else str(i))
               for i, v in enumerate(like)]
        return type(like)(out)
    if prefix not in arrays:
        raise KeyError(f"checkpoint missing {prefix}")
    arr = arrays[prefix]
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{prefix}: shape {arr.shape} != {tuple(like.shape)}")
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)
    return arr.astype(np.asarray(like).dtype)


def restore(path: str | Path, like) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (shape-checked); leaves take
    the type, dtype and device of ``like``'s."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    with np.load(path / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return _rebuild(like, arrays), manifest["step"]


def latest_step_dir(root: str | Path) -> Optional[Path]:
    root = Path(root)
    if not root.exists():
        return None
    steps = [p for p in root.iterdir() if p.name.startswith("step_")]
    return max(steps, key=lambda p: int(p.name.split("_")[1]), default=None)
