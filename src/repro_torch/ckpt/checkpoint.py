"""Atomic, async checkpoints in the JAX package's file format
(``ckpt/checkpoint.py``):

  * ``arrays.npz`` holds leaf ``i`` of the tree's flatten order (JAX's:
    sorted dict keys) as ``leaf_i``; ``meta.json`` holds the leaves'
    ``keystr`` paths, their dtype tags and the caller's extras.  A 16-bit
    leaf without a numpy dtype (bf16) is stored as its ``uint16`` view, an
    8-bit one (fp8) as ``uint8``, tagged with its dtype's name, so either
    package restores the other's checkpoints,
  * atomicity: write to ``<path>.tmp``, then ``os.replace`` (a crashed
    save never shadows the last complete one),
  * keep-N retention over ``step_%08d`` directories,
  * async save: the tensors are copied to the host BEFORE the writer
    thread starts, so training may go on and rebind or overwrite them;
    the next save (or a restore) joins the thread.

numpy and torch only: bf16 leaves are read back through an integer view,
without ``ml_dtypes``.  A checkpoint holds whole leaves whatever mesh
wrote it (``train.loop`` gathers its shards first); ``restore_pytree(...,
shardings=)`` cuts them for any other mesh."""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from ..core.tree import flatten_with_paths, leaves, unflatten

#: dtype tag -> (integer container, torch dtype) of the leaves numpy has
#: no dtype for
_VIEWS = {"bfloat16": (np.int16, torch.bfloat16),
          "float8_e5m2": (np.int8, torch.float8_e5m2),
          "float8_e4m3fn": (np.int8, torch.float8_e4m3fn)}
_STORED = {2: np.uint16, 1: np.uint8}


@dataclasses.dataclass(frozen=True)
class HostLeaf:
    """A leaf copied to the host: the array as stored and its dtype tag."""
    array: np.ndarray
    tag: str


def to_host(x) -> HostLeaf:
    """One leaf (tensor, numpy array or scalar) as a host copy."""
    if isinstance(x, HostLeaf):
        return x
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        tag = str(t.dtype).replace("torch.", "")
        if tag in _VIEWS:
            raw = t.view(torch.int16 if t.element_size() == 2 else torch.int8)
            return HostLeaf(raw.numpy().view(_STORED[t.element_size()]), tag)
        return HostLeaf(t.numpy(), tag)
    a = np.array(x)
    return HostLeaf(a, str(a.dtype))


def _from_host(a: np.ndarray, tag: str, device) -> torch.Tensor:
    if tag in _VIEWS:
        raw, dt = _VIEWS[tag]
        t = torch.from_numpy(np.ascontiguousarray(a).view(raw)).view(dt)
    else:
        t = torch.from_numpy(np.array(a, dtype=np.dtype(tag)))
    return t.to(device)


def save_pytree(path: str, tree, extra: Optional[dict] = None):
    """Synchronous atomic save of one pytree + json-able extras."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    flat = flatten_with_paths(tree)
    host = [to_host(leaf) for _, leaf in flat]
    arrays = {f"leaf_{i}": h.array for i, h in enumerate(host)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    meta = {"paths": [p for p, _ in flat],
            "dtypes": {f"leaf_{i}": h.tag for i, h in enumerate(host)},
            "extra": extra or {}}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def restore_pytree(path: str, like, shardings=None):
    """Restore into the structure of ``like`` (whose leaf paths must be the
    checkpoint's); each leaf lands on the device of ``like``'s leaf (the
    host for non-tensors).  Returns ``(tree, extra)``.

    ``shardings`` (mesh-elastic restore): ``(specs, mesh)``, a spec tree
    mirroring ``like`` and a ``launch.mesh.Mesh``; each rank keeps its
    ``models.sharding.local_shard`` of every whole leaf, whatever mesh
    wrote it, and a block whose shape is not ``like``'s raises (an error
    feedback buffer of another data-parallel size, as JAX's shapes
    would)."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    flat = flatten_with_paths(like)
    paths = [p for p, _ in flat]
    if paths != meta["paths"]:
        raise ValueError(
            f"checkpoint {path} holds leaves {meta['paths'][:4]}... "
            f"({len(meta['paths'])}); the target structure expects "
            f"{paths[:4]}... ({len(paths)})")
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, (_, ref) in enumerate(flat):
            dev = ref.device if isinstance(ref, torch.Tensor) else "cpu"
            out.append(_from_host(data[f"leaf_{i}"],
                                  meta["dtypes"][f"leaf_{i}"], dev))
    tree = unflatten(like, out)
    if shardings is not None:
        from ..models.sharding import local_shard, map_specs
        specs, mesh = shardings
        tree = map_specs(lambda x, s: local_shard(x, s, mesh), tree, specs)
        for p, got, (_, ref) in zip(paths, leaves(tree), flat):
            if isinstance(ref, torch.Tensor) and got.shape != ref.shape:
                raise ValueError(
                    f"checkpoint {path}: leaf {p} restores as "
                    f"{tuple(got.shape)} on this rank of {mesh!r}; the "
                    f"target expects {tuple(ref.shape)}")
    return tree, meta["extra"]


class CheckpointManager:
    """keep-N retention + async saves + latest-step discovery."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    def _step_dirs(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_"):
                try:
                    out.append((int(d.split("_")[1]), d))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        dirs = self._step_dirs()
        return dirs[-1][0] if dirs else None

    def path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree, extra: Optional[dict] = None,
             sync: bool = False):
        self.wait()
        # on the host before returning: training may mutate device
        # buffers freely
        host_tree = unflatten(tree, [to_host(leaf) for _, leaf in
                                     flatten_with_paths(tree)])

        def work():
            save_pytree(self.path(step), host_tree,
                        {**(extra or {}), "step": step})
            for s, d in self._step_dirs()[:-self.keep]:
                shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

        if sync:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def restore_latest(self, like, shardings=None):
        self.wait()
        step = self.latest_step()
        if step is None:
            return None, None, None
        tree, extra = restore_pytree(self.path(step), like, shardings)
        return step, tree, extra
