"""Carry state from the reference package into the port.

``from_numpy_container(obj, device)`` turns a numpy-leafed container — what
``repro.core.tables.host_copy`` yields, or any container built from numpy
arrays — into the port's container of the same kind on ``device``.  The
reference's persisted state (``monitor.json``, ``monitor.calib.json``,
``monitor.plans.json``) needs no conversion: the port reads those files as
they are.

``params_from_numpy(tree, device, dtype)`` turns the reference's LM
parameter tree with numpy leaves (``jax.tree.map(np.asarray, params)``)
into the port's parameters: the port keeps the reference's names and
layouts, so the map is name for name.  ``train_state_from_numpy(tree,
device)`` does the same for a whole train state (``master``, ``opt.m``,
``opt.v``, ``opt.count``, ``step`` and, with int8 error feedback, ``ef``),
so that both packages can train on from one state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import tables


def from_numpy_container(obj, device):
    """The port's container of ``obj``'s kind, its leaves on ``device``.
    ``obj`` is matched by its ``kind`` attribute, so containers of either
    package convert."""
    kind = getattr(obj, "kind", None)
    dev = tables.resolve_device(device)
    if kind == "dense":
        return tables.DenseTensor(tables.to_device(np.asarray(obj.data), dev),
                                  valid_count=int(obj.valid_count),
                                  fill=float(obj.fill))
    if kind == "columnar":
        return tables.ColumnarTable(
            {c: tables.to_device(np.asarray(v), dev)
             for c, v in obj.columns.items()},
            valid=tables.to_device(np.asarray(obj.valid), dev))
    if kind == "coo":
        return tables.COOMatrix(tables.to_device(np.asarray(obj.rows), dev),
                                tables.to_device(np.asarray(obj.cols), dev),
                                tables.to_device(np.asarray(obj.vals), dev),
                                (int(obj.shape[0]), int(obj.shape[1])))
    if kind == "stream":
        return tables.StreamBuffer(tables.to_device(np.asarray(obj.data), dev),
                                   t0=int(obj.t0))
    raise TypeError(f"not a polystore container: {type(obj).__name__}")


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)                     # a writable copy
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _tree(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree(v, dev) for k, v in tree.items()}
    return _tensor(tree).to(dev)


def params_from_numpy(tree, device, dtype=None):
    """The port's parameter dict of a numpy-leafed reference parameter tree
    (nested dicts), on ``device``.  With ``dtype``, floating leaves are cast
    to it except the float32-sensitive ones (``models.api.F32_SENSITIVE``),
    as ``cast_params`` does."""
    from repro_torch.models.api import cast_params
    params = _tree(tree, tables.resolve_device(device))
    return params if dtype is None else cast_params(params, dtype)


def train_state_from_numpy(tree, device):
    """The port's train state of a numpy-leafed reference train state
    (``jax.tree.map(np.asarray, state)``), name for name and dtype for
    dtype, on ``device``."""
    return _tree(tree, tables.resolve_device(device))
