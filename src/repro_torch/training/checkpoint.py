"""Manifest-driven checkpointing with async write, atomic commit,
integrity hashes and keep-last-k retention: port of
``repro/training/checkpoint.py`` in its on-disk format, so a checkpoint
written by either package restores in the other, leaf for leaf.

Layout:
  <dir>/step_000000123/
      manifest.json      step, tree structure, mesh shape, and per leaf
                         its shape, dtype, logical spec and crc32
      arrays/00000.npy ... one file per leaf, numbered in JAX's flatten
                         order (dict keys sorted, lists in order)
  <dir>/step_000000123.tmp -> renamed to step_000000123 on commit

The port runs on one device: ``specs`` is optional, and without it each
leaf records ``[]`` (a replicated spec); the mesh shape is ``{}``.
``restore`` puts each leaf on the device of the corresponding leaf of
``tree_like``. Leaves are float32 or integer tensors (numpy has no
bfloat16).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.training.tree import leaves, treedef_str, unflatten


@dataclasses.dataclass
class SaveResult:
    path: str
    step: int
    n_leaves: int
    bytes: int


def _host(t) -> np.ndarray:
    """A leaf as a host numpy array (a copy)."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            raise ValueError("checkpoint: bfloat16 leaves are not "
                             "supported (numpy has no bfloat16)")
        return t.detach().cpu().numpy().copy()
    return np.array(t, copy=True)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------ save
    def save(self, step: int, tree: Any, specs: Any = None,
             async_: bool = False) -> Optional[SaveResult]:
        """Snapshot to host memory synchronously, write to disk
        (optionally on a background thread), commit atomically.
        ``specs``: ``tree``'s structure with a tuple of logical axis
        names (or None) at each leaf, or None (every leaf replicated,
        recorded as [])."""
        self.wait()
        host = [_host(x) for x in leaves(tree)]
        spec_leaves = ([[]] * len(host) if specs is None else
                       [list(s) for s in _spec_leaves(specs)])
        if len(spec_leaves) != len(host):
            raise ValueError("specs/tree mismatch")
        treedef = treedef_str(tree)

        def work() -> SaveResult:
            tmp = os.path.join(self.dir, f"step_{step:09d}.tmp")
            final = os.path.join(self.dir, f"step_{step:09d}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(os.path.join(tmp, "arrays"))
            manifest = {"step": step, "treedef": treedef, "mesh_shape": {},
                        "leaves": []}
            total = 0
            for i, (arr, spec) in enumerate(zip(host, spec_leaves)):
                np.save(os.path.join(tmp, "arrays", f"{i:05d}.npy"), arr)
                manifest["leaves"].append({
                    "shape": list(arr.shape),
                    "dtype": str(arr.dtype),
                    "spec": spec,
                    "crc32": zlib.crc32(arr.tobytes()) & 0xFFFFFFFF,
                })
                total += arr.nbytes
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)            # atomic commit
            self._retain()
            return SaveResult(final, step, len(host), total)

        if async_:
            def run():
                try:
                    work()
                except BaseException as e:   # surfaced on next wait()
                    self._error = e

            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
            return None
        return work()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _retain(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------ load
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: Any, step: Optional[int] = None,
                verify: bool = True) -> Tuple[Any, int]:
        """Restore into the structure of ``tree_like``: each leaf a new
        tensor on the device of ``tree_like``'s leaf, its saved dtype
        and bits. Raises IOError on a crc mismatch, ValueError on a leaf
        count or shape that differs."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        like = leaves(tree_like)
        if len(like) != len(manifest["leaves"]):
            raise ValueError(f"checkpoint has {len(manifest['leaves'])} "
                             f"leaves, model expects {len(like)}")
        out = []
        for i, (meta, ref) in enumerate(zip(manifest["leaves"], like)):
            arr = np.load(os.path.join(path, "arrays", f"{i:05d}.npy"))
            if verify:
                crc = zlib.crc32(arr.tobytes()) & 0xFFFFFFFF
                if crc != meta["crc32"]:
                    raise IOError(f"corrupt leaf {i} in {path}")
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {i}: saved shape {arr.shape}, "
                                 f"expected {tuple(ref.shape)}")
            dev = ref.device if isinstance(ref, torch.Tensor) else "cpu"
            out.append(torch.from_numpy(arr).to(dev))
        return unflatten(tree_like, out), step


def _spec_leaves(specs) -> list:
    """A spec tree's leaves in JAX's flatten order: dicts and lists are
    nodes, each tuple a leaf."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [x for s in specs for x in _spec_leaves(s)]
    return [specs]
