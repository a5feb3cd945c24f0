"""Fault-tolerant checkpointing on numpy ``.npz`` — port of
``repro/training/checkpoint.py``.

  * atomic: write to ``<dir>/tmp.<step>.<pid>.<proc>`` then
    ``os.replace`` — a crash mid-write never corrupts the latest
    checkpoint;
  * per-process files (``proc{i}.npz``, ``meta{i}.json``);
  * async (``async_save=True``, as the trainer asks): saves run on one
    background thread, the loop only blocks if a previous save is still
    in flight; ``wait()`` drains it;
  * retention: keep the newest ``keep_last`` committed checkpoints plus
    every multiple of ``keep_period``;
  * only committed steps (a ``COMMIT`` marker written last) are offered
    on restore, which is what makes kill -9 / preemption recovery safe.

The on-disk layout is the reference's: ``step_<n>/{proc0.npz,
meta0.json, COMMIT}``.  Trees are nested dicts, lists and tuples of
tensors and numpy arrays, flattened to ``"/"``-joined path keys by
`flatten_tree` (the reference uses ``jax.tree_util``).  Saves default to
synchronous here, where the reference defaults to async: the serving
snapshots construct a manager per save and expect the write to have
landed when ``save`` returns.
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import _tree


def flatten_tree(tree: Any) -> Dict[str, np.ndarray]:
    """Flatten nested dicts/lists/tuples of tensors and arrays to
    path-keyed host copies (``"/"``-joined keys): later writes to the
    tree's tensors never reach them.  A flat ``Dict[str, np.ndarray]``
    maps to itself."""
    return {path: (leaf.detach().to("cpu", copy=True).numpy()
                   if isinstance(leaf, torch.Tensor)
                   else np.array(leaf, copy=True))
            for path, leaf in _tree.leaves_with_path(tree)}


def unflatten_into(tree: Any, arrays: Dict[str, np.ndarray]) -> Any:
    """``tree`` with every leaf replaced by ``arrays[its path]``: a tensor
    of the template leaf's dtype and device where the template holds a
    tensor, else the array.  Raises on a missing leaf or a shape
    mismatch."""
    def leaf_from(key, leaf):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = arrays[key]
        if hasattr(leaf, "shape") and tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {arr.shape} != template "
                             f"{tuple(leaf.shape)}")
        if isinstance(leaf, torch.Tensor):
            return torch.from_numpy(np.array(arr, copy=True)).to(
                device=leaf.device, dtype=leaf.dtype)
        return arr

    return _tree.map_with_path(leaf_from, tree)


class CheckpointManager:
    STEP_RE = re.compile(r"^step_(\d+)$")

    def __init__(self, directory: str, keep_last: int = 3,
                 keep_period: Optional[int] = None, process_index: int = 0,
                 async_save: bool = False):
        self.dir = directory
        self.keep_last = keep_last
        self.keep_period = keep_period
        self.process_index = process_index
        os.makedirs(directory, exist_ok=True)
        self._pool = cf.ThreadPoolExecutor(max_workers=1) if async_save else None
        self._inflight: Optional[cf.Future] = None
        self._lock = threading.Lock()

    # -- save -----------------------------------------------------------------

    def save(self, step: int, tree,
             metadata: Optional[Dict[str, Any]] = None):
        """Snapshot ``tree`` now (host copies: safe to mutate it after) and
        write it as committed step ``step``, in the background when
        async; returns the in-flight future then, else None."""
        arrays = flatten_tree(tree)
        meta = dict(metadata or {})
        if self._pool is None:
            self._write(step, arrays, meta)
            return None
        self.wait()                     # bound in-flight saves to 1
        self._inflight = self._pool.submit(self._write, step, arrays, meta)
        return self._inflight

    def wait(self) -> None:
        """Block until the in-flight save (if any) has committed; re-raises
        its error."""
        if self._inflight is not None:
            self._inflight.result()
            self._inflight = None

    def _write(self, step: int, arrays: Dict[str, np.ndarray],
               meta: Dict[str, Any]) -> None:
        final = os.path.join(self.dir, f"step_{step:09d}")
        tmp = os.path.join(
            self.dir, f"tmp.{step}.{os.getpid()}.{self.process_index}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"proc{self.process_index}.npz"), **arrays)
        with open(os.path.join(tmp, f"meta{self.process_index}.json"),
                  "w") as f:
            json.dump({"step": step, **meta}, f)
        # single-controller commit: proc 0 marks completeness
        if self.process_index == 0:
            with open(os.path.join(tmp, "COMMIT"), "w") as f:
                f.write(str(step))
        with self._lock:
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()

    def _gc(self):
        steps = self.all_steps()
        keep = set(steps[-self.keep_last:]) if self.keep_last else set(steps)
        if self.keep_period:
            keep |= {s for s in steps if s % self.keep_period == 0}
        for s in steps:
            if s not in keep:
                shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                              ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = self.STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.dir, name, "COMMIT")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_arrays(
        self, step: int
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        """Raw ``(arrays, meta)`` of one committed step — no template (the
        serving pool checkpoint stores a variable number of sessions)."""
        path = os.path.join(self.dir, f"step_{step:09d}")
        with np.load(os.path.join(
                path, f"proc{self.process_index}.npz")) as npz:
            arrays = {k: npz[k] for k in npz.files}
        with open(os.path.join(path, f"meta{self.process_index}.json")) as f:
            meta = json.load(f)
        return arrays, meta

    def restore(self, step: int, template) -> Tuple[Any, Dict[str, Any]]:
        arrays, meta = self.restore_arrays(step)
        return unflatten_into(template, arrays), meta

    def restore_latest(self, template):
        """(tree, meta, step) or (template, {}, None) if no checkpoint."""
        step = self.latest_step()
        if step is None:
            return template, {}, None
        tree, meta = self.restore(step, template)
        return tree, meta, step
