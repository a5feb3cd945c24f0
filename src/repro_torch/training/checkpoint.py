"""Fault-tolerant checkpointing on numpy ``.npz`` — port of the part of
``repro/training/checkpoint.py`` that the serving checkpoints ride.

  * atomic: write to ``<dir>/tmp.<step>.<pid>`` then ``os.replace`` — a
    crash mid-write never corrupts the latest checkpoint;
  * retention: keep the newest ``keep_last`` committed checkpoints;
  * only committed steps (a ``COMMIT`` marker written last) are offered
    on restore, which is what makes kill -9 / preemption recovery safe.

The on-disk layout is the reference's with one process:
``step_<n>/{proc0.npz, meta0.json, COMMIT}``.  Trees are nested dicts,
lists and tuples of tensors and numpy arrays, flattened to
``"/"``-joined path keys by `flatten_tree` (the reference uses
``jax.tree_util``).  The reference's asynchronous saves, periodic
retention and template restore serve its trainer, which is not ported
(ROADMAP.md queue 1 item 12).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def flatten_tree(tree: Any) -> Dict[str, np.ndarray]:
    """Flatten nested dicts/lists/tuples of tensors and arrays to
    path-keyed host arrays (``"/"``-joined keys).  A flat
    ``Dict[str, np.ndarray]`` maps to itself."""
    out: Dict[str, np.ndarray] = {}

    def walk(node: Any, prefix: str) -> None:
        if isinstance(node, dict):
            items = [(str(k), v) for k, v in node.items()]
        elif isinstance(node, (list, tuple)):
            items = [(str(i), v) for i, v in enumerate(node)]
        else:
            out[prefix] = (node.detach().cpu().numpy()
                           if isinstance(node, torch.Tensor)
                           else np.asarray(node))
            return
        for key, child in items:
            walk(child, f"{prefix}/{key}" if prefix else key)

    walk(tree, "")
    return out


class CheckpointManager:
    STEP_RE = re.compile(r"^step_(\d+)$")

    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()

    def save(self, step: int, tree,
             metadata: Optional[Dict[str, Any]] = None) -> None:
        """Write ``tree`` (host copies) and ``metadata`` as committed step
        ``step``, then drop the steps past retention."""
        arrays = flatten_tree(tree)
        final = os.path.join(self.dir, f"step_{step:09d}")
        tmp = os.path.join(self.dir, f"tmp.{step}.{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "proc0.npz"), **arrays)
        with open(os.path.join(tmp, "meta0.json"), "w") as f:
            json.dump({"step": step, **(metadata or {})}, f)
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
        for s in steps:
            if s not in keep:
                shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                              ignore_errors=True)

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
        """Raw ``(arrays, meta)`` of one committed step — no template."""
        path = os.path.join(self.dir, f"step_{step:09d}")
        with np.load(os.path.join(path, "proc0.npz")) as npz:
            arrays = {k: npz[k] for k in npz.files}
        with open(os.path.join(path, "meta0.json")) as f:
            meta = json.load(f)
        return arrays, meta
