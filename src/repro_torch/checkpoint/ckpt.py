"""Checkpointing: atomic, versioned, restart-safe.

The counterpart of the JAX package's ``checkpoint/ckpt.py``, with its
directory format.  One directory per step (``step_00000123/``) holding

* ``leaf_XXXXX.npy``: one file per tensor of the tree, a nested dict of
  tensors (the train state ``{"params": {name: tensor}, "opt": {"m": ...,
  "v": ..., "step": ...}}``), its leaves ordered by their path of sorted
  keys, as the reference flattens a dict; bfloat16 is stored as its
  16-bit pattern (``uint16``), since numpy has no bfloat16;
* ``tree.json``: the step, the leaves' paths (``treedef``) and each
  leaf's shape and logical dtype;
* ``DONE``: the commit marker; restore considers committed steps only.

A step is written into ``step_XXXXXXXX.tmp`` and renamed, so a torn write
never corrupts the latest checkpoint.  :class:`AsyncCheckpointer` writes
in a background thread (the train loop never waits on the disk) and keeps
the newest ``keep`` steps.

On a mesh, a tree of local slices comes with a matching tree of
:class:`~repro_torch.distributed.sharding.Sharding` s: saving gathers each
full tensor (every rank takes part) and rank 0 alone writes, in the same
format; :func:`restore` with ``shardings`` slices each full leaf onto the
current mesh, so a checkpoint written under one mesh restores on another.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as S


def _flatten(tree: dict, prefix: str = "") -> list:
    """[(path, leaf)] in the order of sorted keys, depth first."""
    out = []
    for key in sorted(tree):
        path = f"{prefix}{key}"
        if isinstance(tree[key], dict):
            out += _flatten(tree[key], path + "/")
        else:
            out.append((path, tree[key]))
    return out


def _unflatten(pairs: list) -> dict:
    tree: dict = {}
    for path, leaf in pairs:
        *parents, last = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def is_writer() -> bool:
    """Whether this rank writes checkpoints (rank 0, or the only one)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def to_host(tree: dict, shardings: dict | None = None) -> dict:
    """A copy of the tree's tensors on the host as numpy arrays (bfloat16
    as its ``uint16`` bit pattern, the tree recording ``"bfloat16"``):
    ``{path: (array, logical dtype)}``.  A copy even of CPU tensors, so
    that a step updating them in place afterwards does not reach it.  With
    ``shardings`` (a matching tree) each leaf is gathered in full first, a
    collective; a rank that does not write returns {}."""
    out = {}
    shard_of = dict(_flatten(shardings)) if shardings is not None else {}
    keep = is_writer()
    for path, leaf in _flatten(tree):
        if path in shard_of:
            leaf = S.gather_full(leaf, shard_of[path])
        if not keep:
            continue
        t = leaf.detach().to("cpu", copy=True)
        logical = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            arr = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arr = t.numpy()
        out[path] = (arr, logical)
    return out


def save(path: str, step: int, tree: dict,
         shardings: dict | None = None) -> str | None:
    """Synchronous atomic save of a tree of tensors (of local slices under
    ``shardings``: every rank calls it, rank 0 writes).  Returns the
    committed directory (None on a rank that does not write)."""
    host = to_host(tree, shardings)
    return write_host(path, step, host) if is_writer() else None


def write_host(path: str, step: int, host: dict) -> str:
    """Atomic save of :func:`to_host`'s copy of a tree."""
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    meta = {"step": step, "treedef": list(host), "leaves": []}
    for i, (arr, logical) in enumerate(host.values()):
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
        meta["leaves"].append({"shape": list(arr.shape), "dtype": logical})
    with open(os.path.join(tmp, "tree.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(tmp, "DONE"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(path: str) -> Optional[int]:
    """The newest committed step under ``path``, None without one."""
    if not os.path.isdir(path):
        return None
    steps = []
    for d in os.listdir(path):
        if d.startswith("step_") and not d.endswith(".tmp") and \
                os.path.exists(os.path.join(path, d, "DONE")):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def restore(path: str, step: int, like: dict,
            shardings: dict | None = None) -> dict:
    """The committed step's tree, shaped as ``like`` (a tree of tensors):
    each leaf a new tensor with ``like``'s leaf's dtype, on its device;
    with ``shardings`` (a matching tree) this rank's slice of it."""
    d = os.path.join(path, f"step_{step:08d}")
    if not os.path.exists(os.path.join(d, "DONE")):
        raise FileNotFoundError(f"uncommitted checkpoint {d}")
    with open(os.path.join(d, "tree.json")) as f:
        meta = json.load(f)
    pairs = _flatten(like)
    if [p for p, _ in pairs] != meta["treedef"]:
        raise ValueError(f"{d}: the checkpoint's leaves {meta['treedef']} "
                         f"are not the tree's {[p for p, _ in pairs]}")
    out = []
    shard_of = dict(_flatten(shardings)) if shardings is not None else {}
    for i, (name, leaf) in enumerate(pairs):
        arr = np.load(os.path.join(d, f"leaf_{i:05d}.npy"))
        t = torch.from_numpy(arr)
        if meta["leaves"][i]["dtype"] == "bfloat16":
            t = t.view(torch.int16).view(torch.bfloat16)
        if name in shard_of:
            t = S.local_slice(t, shard_of[name])
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"leaf {name}: checkpoint {arr.shape} (here "
                             f"{tuple(t.shape)}) vs model "
                             f"{tuple(leaf.shape)}")
        out.append((name, t.to(device=leaf.device, dtype=leaf.dtype)))
    return _unflatten(out)


class AsyncCheckpointer:
    """Background-thread checkpoint writer with a bounded queue (on a
    mesh, rank 0's writes; the others take part in the gathers)."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._err: Optional[BaseException] = None
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, host = item
            try:
                write_host(self.path, step, host)
                self._gc()
            except Exception as e:      # surfaced on the next submit / wait
                self._err = e
            finally:
                self._q.task_done()

    def _gc(self):
        all_steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.path)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in all_steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"),
                          ignore_errors=True)

    def submit(self, step: int, tree: Any, shardings: dict | None = None):
        """Queue a save of ``tree`` at ``step``; its tensors are copied to
        the host (gathered in full under ``shardings``, every rank taking
        part) before this returns (the train step updates them in
        place)."""
        if self._err:
            raise self._err
        host = to_host(tree, shardings)
        if is_writer():
            self._q.put((step, host))

    def wait(self):
        self._q.join()
        if self._err:
            raise self._err

    def close(self):
        self.wait()
        self._q.put(None)
        self._t.join(timeout=10)
