"""Carry state from the reference package into the port.

``from_numpy_container(obj, device)`` turns a numpy-leafed container — what
``repro.core.tables.host_copy`` yields, or any container built from numpy
arrays — into the port's container of the same kind on ``device``.  The
reference's persisted state (``monitor.json``, ``monitor.calib.json``,
``monitor.plans.json``) needs no conversion: the port reads those files as
they are.
"""
from __future__ import annotations

import numpy as np

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
