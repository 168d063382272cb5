"""Casts — data migration between engine formats (paper §III-C: "the Cast
operation sends information about the translation between data models and
moves the data as needed").

The conversions are executed directly and the *cost model* (calibrated
bytes/s per pair + conversion cost) feeds the planner.  Dynamic-shape
conversions (dense->COO) run eagerly on the host.

Casts INTO triple formats (columnar, coo) leave their output as **numpy**:
these conversions are eager host work, and the consuming op may keep the
data on the host anyway (sort-merge join, the next cast hop).  The device
transfer happens when a dense consumer actually needs it —
``columnar_to_dense``/``coo_to_dense`` build tensors on the session's
``device``, and long-lived catalog objects are homed explicitly via
``tables.device_ready`` at registration.  Casts between dense and stream
alias the tensor (no copy), so neither side may be updated in place.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.tables import (COOMatrix, ColumnarTable, DenseTensor,
                                     StreamBuffer, to_device, to_numpy)


def dense_to_columnar(d: DenseTensor, device=None) -> ColumnarTable:
    a = to_numpy(d.data)
    if a.ndim == 1:
        cols = {"i": np.arange(a.shape[0], dtype=np.int32),
                "value": a}
    elif a.ndim == 2:
        n, t = a.shape
        ii, jj = np.meshgrid(np.arange(n), np.arange(t), indexing="ij")
        cols = {"i": ii.ravel().astype(np.int32),
                "j": jj.ravel().astype(np.int32),
                "value": a.ravel()}
    else:
        raise ValueError("columnar cast supports <=2D")
    return ColumnarTable(cols)     # numpy-eager (see module docstring)


def columnar_to_dense(t: ColumnarTable, device, shape=None) -> DenseTensor:
    v = to_numpy(t.columns["value"])
    valid = to_numpy(t.valid)
    if "j" in t.columns:
        i = to_numpy(t.columns["i"])[valid]
        j = to_numpy(t.columns["j"])[valid]
        vv = v[valid]
        if shape is None:
            shape = (int(i.max()) + 1 if i.size else 0,
                     int(j.max()) + 1 if j.size else 0)
        out = np.zeros(shape, v.dtype)
        out[i, j] = vv
    else:
        i = to_numpy(t.columns["i"])[valid]
        vv = v[valid]
        if shape is None:
            shape = (int(i.max()) + 1 if i.size else 0,)
        out = np.zeros(shape, v.dtype)
        out[i] = vv
    return DenseTensor(to_device(out, device), valid_count=int(valid.sum()))


def dense_to_coo(d: DenseTensor, device=None) -> COOMatrix:
    a = to_numpy(d.data)
    if a.ndim != 2:
        raise ValueError(f"coo cast expects a 2-d tensor, got {a.ndim}-d")
    r, c = np.nonzero(a != d.fill)
    return COOMatrix(r.astype(np.int32), c.astype(np.int32),
                     a[r, c], a.shape)     # numpy-eager


def coo_to_dense(m: COOMatrix, device) -> DenseTensor:
    out = np.zeros(m.shape, to_numpy(m.vals).dtype)
    out[to_numpy(m.rows), to_numpy(m.cols)] = to_numpy(m.vals)
    return DenseTensor(to_device(out, device), valid_count=m.nnz)


def coo_to_columnar(m: COOMatrix, device=None) -> ColumnarTable:
    return ColumnarTable({"i": m.rows, "j": m.cols, "value": m.vals})


def columnar_to_coo(t: ColumnarTable, device=None, shape=None) -> COOMatrix:
    valid = to_numpy(t.valid)
    r = to_numpy(t.columns["i"])[valid].astype(np.int32)
    c = to_numpy(t.columns["j"])[valid].astype(np.int32)
    v = to_numpy(t.columns["value"])[valid]
    if shape is None:
        shape = (int(r.max()) + 1 if r.size else 0,
                 int(c.max()) + 1 if c.size else 0)
    return COOMatrix(r, c, v, shape)       # numpy-eager


def stream_to_dense(s: StreamBuffer, device=None) -> DenseTensor:
    d = s.data
    if d.ndim == 2:                  # (n_windows, window_len): rows = windows
        return DenseTensor(d)
    return DenseTensor(d.reshape((-1,) + tuple(d.shape[2:])))


def dense_to_stream(d: DenseTensor, device=None) -> StreamBuffer:
    """Each row becomes one window (the ETL inverse of stream_to_dense)."""
    a = d.data
    if a.ndim != 2:
        raise ValueError("stream cast expects (n_windows, window_len)")
    return StreamBuffer(a)


_CASTS = {
    ("dense", "columnar"): dense_to_columnar,
    ("columnar", "dense"): columnar_to_dense,
    ("dense", "coo"): dense_to_coo,
    ("coo", "dense"): coo_to_dense,
    ("coo", "columnar"): coo_to_columnar,
    ("columnar", "coo"): columnar_to_coo,
    ("stream", "dense"): stream_to_dense,
    ("dense", "stream"): dense_to_stream,
}


def can_cast(src_kind: str, dst_kind: str) -> bool:
    return src_kind == dst_kind or (src_kind, dst_kind) in _CASTS


def cast_step(obj, dst_kind: str, device):
    """One registered conversion hop (no routing, no fallback); a hop that
    builds a dense tensor builds it on ``device``."""
    if obj.kind == dst_kind:
        return obj
    return _CASTS[(obj.kind, dst_kind)](obj, device)


def cast_path(src_kind: str, dst_kind: str, nbytes: float = 0.0,
              cost_model=None, obj=None) -> list:
    """Hop sequence (kind names, inclusive of endpoints) for a cast.

    With a cost model: the cheapest route over the calibrated per-pair
    bandwidths (``CostModel.cast_route``) — possibly multi-hop even when a
    direct pair exists, if the direct pair has been measured slow.  When the
    actual container is at hand, pass it as ``obj`` so every hop is sized
    from its true intermediate format (coo->dense densifies; the dense
    onward hop moves more bytes than the triples did).  Without a model:
    the direct registered pair, else the legacy two-hop through dense."""
    if src_kind == dst_kind:
        return [src_kind]
    if cost_model is not None:
        kind_nbytes = None
        if obj is not None:
            from repro_torch.core.costmodel import container_kind_nbytes
            kind_nbytes = container_kind_nbytes(obj)
        return cost_model.cast_route(src_kind, dst_kind, nbytes,
                                     kind_nbytes)[1]
    if (src_kind, dst_kind) in _CASTS:
        return [src_kind, dst_kind]
    return [src_kind, "dense", dst_kind]


def cast(obj, dst_kind: str, cost_model=None, *, device):
    for k in cast_path(obj.kind, dst_kind, getattr(obj, "nbytes", 0.0),
                       cost_model, obj=obj)[1:]:
        obj = cast_step(obj, k, device)
    return obj


# planner-side cast cost estimates live in costmodel.CostModel.cast_seconds /
# cast_route (calibrated bytes/s per (src, dst) pair, shortest-path routed,
# with a measured-default fallback)
