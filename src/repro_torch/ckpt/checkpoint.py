"""Async checkpointing of the port's trees, in the reference's layout.

The port of ``repro.ckpt.checkpoint``.  Layout:  <dir>/step_<k>/manifest.json
+ <leaf-path>.npy per tree leaf, the leaf path joined by "/" as the
reference joins dict keys (and "__" in the file name).  A checkpoint written
by either package restores in the other.
 - async: the device->host copy happens on the caller thread, the files
   are written on a background thread; ``wait()`` joins it.  A step is
   published by an atomic rename; the oldest beyond ``keep_last`` go.
 - restore: whole arrays are read, then go to ``device``, or onto a mesh
   by target ``shardings`` (``models.api.to_shardings``), as the
   reference takes shardings: a checkpoint written at one mesh shape
   restores at another or on one device.  The manifest's dtypes are kept,
   and shapes are validated against ``like`` before use.
 - a sharded state (``DTensor`` leaves) is saved whole: every rank
   gathers each leaf on the caller thread, rank 0 writes, and the others
   wait for it at a barrier in ``wait()``, so the files are the same as
   from one device.
 - bfloat16: numpy has no bfloat16 without ``ml_dtypes``, so a bfloat16
   leaf is stored as its 16-bit patterns (uint16), with "bfloat16" in the
   manifest; restore reads any 2-byte array under that name as bfloat16
   bits, the reference's own files (2-byte voids) included.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.core.tables import resolve_device


def _items(tree, prefix=()):
    """(path, leaf) pairs, dict keys in sorted order as JAX flattens."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    elif tree is not None:
        yield prefix, tree


def _flatten(tree) -> dict:
    return {"/".join(path): leaf for path, leaf in _items(tree)}


def _treedef(tree) -> str:
    """The tree's structure as JAX prints a treedef."""
    def s(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"'{k}': {s(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, (tuple, list)):
            inner = ", ".join(s(v) for v in node)
            return f"({inner})" if isinstance(node, tuple) else f"[{inner}]"
        return "None" if node is None else "*"
    return f"PyTreeDef({s(tree)})"


def _dtype_name(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_host(t) -> np.ndarray:
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().cpu() if torch.is_tensor(t) else torch.as_tensor(t)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.asarray(arr, order="C")
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self._barrier = False      # a sharded save: ranks meet in wait()

    # ---- save --------------------------------------------------------------
    def save(self, step: int, state: Any, blocking: bool = False,
             extra: Optional[dict] = None):
        self.wait()
        flat = _flatten(state)
        # device -> host while still on the caller thread (a DTensor leaf
        # gathered whole: a collective, so every rank saves)
        host = {k: _to_host(v) for k, v in flat.items()}
        self._barrier = any(isinstance(v, DTensor) for v in flat.values())
        if self._barrier and dist.get_rank() != 0:
            if blocking:
                self.wait()
            return
        manifest = {
            "step": step,
            "time": time.time(),
            "treedef": _treedef(state),
            "leaves": {k: {"shape": list(host[k].shape),
                           "dtype": _dtype_name(v)}
                       for k, v in flat.items()},
            "extra": extra or {},
        }

        def _write():
            try:
                tmp = os.path.join(self.dir, f".tmp_step_{step}")
                os.makedirs(tmp, exist_ok=True)
                for k, v in host.items():
                    p = os.path.join(tmp, k.replace("/", "__") + ".npy")
                    np.save(p, v)
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f, indent=1)
                final = os.path.join(self.dir, f"step_{step}")
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)          # atomic publish
                self._gc()
            except Exception as e:             # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        """Join the writer (after a sharded save, every rank then waits for
        rank 0's at a barrier); raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ---- restore ------------------------------------------------------------
    def steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_"):
                out.append(int(d.split("_", 1)[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, like: Any, step: Optional[int] = None,
                device=None, shardings=None) -> tuple[Any, int]:
        """Restore into the structure of ``like`` (a tree of tensors, or of
        anything with a ``shape``), its leaves on ``device`` (``None``: the
        CUDA card), or, with ``shardings`` (a tree of ``NamedSharding``s of
        ``like``'s structure), placed on their mesh as ``DTensor``s."""
        dev = torch.device("cpu") if shardings is not None \
            else resolve_device(device)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        restored = {}
        for k, leaf in _flatten(like).items():
            meta = manifest["leaves"].get(k)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {k}")
            arr = np.load(os.path.join(d, k.replace("/", "__") + ".npy"))
            want_shape = tuple(getattr(leaf, "shape", arr.shape))
            if tuple(arr.shape) != want_shape:
                raise ValueError(f"{k}: ckpt shape {arr.shape} != "
                                 f"{want_shape}")
            restored[k] = _from_host(arr, meta["dtype"]).to(dev)
        tree = _rebuild(like, restored)
        if shardings is not None:
            from repro_torch.models.api import distribute
            tree = distribute(tree, shardings)
        return tree, step


def _rebuild(like, restored, prefix=()):
    """``like``'s structure, each leaf replaced by ``restored[<its path>]``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, restored, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, restored, prefix + (str(i),))
                          for i, v in enumerate(like))
    if like is None:
        return None
    return restored["/".join(prefix)]
