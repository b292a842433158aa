"""Checkpointing: atomic npz snapshots, async writer, restore by example.

The port of ``repro/checkpoint/manager.py``:

* **atomic** — write to ``<dir>/tmp-<step>`` then rename, so a mid-write
  failure never corrupts the latest checkpoint;
* **async** — ``save(..., blocking=False)`` snapshots to host memory
  synchronously and writes on a background thread;
* **restore by example** — ``restore(target)`` rebuilds ``target``'s
  structure (nested dicts, lists, tuples and NamedTuples such as the
  optimizer's ``AdamWState``, of tensors, arrays or placed
  :class:`~repro_torch.parallel.ShardedTensor` s) with every leaf on the
  target leaf's device, or in its sharding, and in its dtype;
* **retention** — keeps the newest ``keep`` checkpoints.

Each leaf's dtype is recorded beside the arrays: ``bfloat16``, which npz
cannot store, is written as its exact float32 upcast and cast back on
restore, so a round trip is the identity.  A placed leaf is saved as its
gathered global array (the reference's ``np.asarray`` of a sharded
array), so a checkpoint does not depend on the mesh it was taken on.

>>> import tempfile, torch
>>> d = tempfile.mkdtemp()
>>> m = CheckpointManager(d, keep=2)
>>> m.save(3, {"T": torch.arange(4.0, dtype=torch.bfloat16)})
>>> tree, step, _ = m.restore({"T": torch.zeros(4, dtype=torch.bfloat16)})
>>> step, tree["T"].dtype, tree["T"].tolist()
(3, torch.bfloat16, [0.0, 1.0, 2.0, 3.0])
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.parallel.sharding import ShardedTensor, place

SEP = "/"


def _leaves(tree, prefix=()):
    """``(path, leaf)`` pairs of a nest of dicts, lists and tuples, in a
    fixed order (dict keys as given, sequences by index)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield SEP.join(prefix), tree


def _rebuild(tree, values, prefix=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_rebuild(v, values, prefix + (str(i),))
                 for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):        # a NamedTuple takes its fields
            return type(tree)(*items)
        return type(tree)(items)
    return values[SEP.join(prefix)]


def _dtype_name(leaf) -> str:
    if isinstance(leaf, (torch.Tensor, ShardedTensor)):
        return str(leaf.dtype).removeprefix("torch.")
    return np.asarray(leaf).dtype.name


def _flatten(tree) -> tuple:
    """(arrays, dtypes): npz-safe host arrays + the *original* dtype name
    per key (a bfloat16 leaf is stored as its exact float32 upcast)."""
    flat, dtypes = {}, {}
    for key, leaf in _leaves(tree):
        dtypes[key] = _dtype_name(leaf)
        if isinstance(leaf, ShardedTensor):
            leaf = leaf.gather("cpu")
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            if t.dtype == torch.bfloat16:
                t = t.float()  # exact: fp32 ⊃ bf16
            arr = t.cpu().numpy().copy()
        else:
            arr = np.array(leaf)
        flat[key] = arr
    return flat, dtypes


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, *, blocking: bool = True,
             extra: Optional[dict] = None) -> None:
        self.wait()
        flat, dtypes = _flatten(tree)  # host snapshot (synchronous)
        meta = {"step": int(step), "extra": extra or {}, "dtypes": dtypes}

        def write():
            tmp = os.path.join(self.dir, f"tmp-{step}")
            final = os.path.join(self.dir, f"step-{step:09d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step-{s:09d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step-"):
                out.append(int(name.split("-")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, target: Any, step: Optional[int] = None):
        """Restore into the structure of ``target``; returns ``(tree, step,
        extra)``.

        Each array is first cast back to the dtype it was *saved* with,
        then to the target leaf's dtype, and put on the target leaf's
        device (a tensor leaf), placed in its sharding (a
        :class:`~repro_torch.parallel.ShardedTensor`) or left on the host
        (an array leaf).
        """
        self.wait()  # before listing: an async writer may still be renaming
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step-{step:09d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        saved_dtypes = meta.get("dtypes", {})
        values = {}
        with np.load(os.path.join(d, "arrays.npz")) as arrays:
            for key, leaf in _leaves(target):
                t = torch.from_numpy(arrays[key].copy())
                saved = saved_dtypes.get(key)
                if saved is not None and _dtype_name(t) != saved:
                    t = t.to(getattr(torch, saved))
                if isinstance(leaf, ShardedTensor):
                    values[key] = place(t.to(leaf.dtype), leaf.mesh,
                                        leaf.spec)
                elif isinstance(leaf, torch.Tensor):
                    values[key] = t.to(device=leaf.device, dtype=leaf.dtype)
                else:
                    values[key] = t.numpy().astype(np.asarray(leaf).dtype,
                                                   copy=False)
        return _rebuild(target, values), meta["step"], meta["extra"]
