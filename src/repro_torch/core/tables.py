"""Polystore data containers — one native format per engine family.

These mirror the paper's data models: SciDB arrays -> DenseTensor, relational
rows -> ColumnarTable, Accumulo/D4M associative arrays -> COOMatrix, S-Store
windows -> StreamBuffer.  ``nbytes``/``describe`` feed the cast cost model.

Device data is a ``torch.Tensor`` on an explicit device.  Triple-format
containers (ColumnarTable, COOMatrix) accept **either** torch tensors or
numpy arrays for their columns/triples: eagerly-computed intermediates —
sort-merge join output, dense->triple casts — stay numpy on the host until a
dense consumer actually needs the device (see ``device_ready`` for the
explicit homing used on long-lived catalog objects, and ``to_device`` for
the per-op homing the engines use).

Row-range sharding (the multi-process scatter–gather substrate) also lives
here: ``shard_rows`` splits any container into N contiguous row-range parts,
and the three merge primitives — ``concat_shards`` (row-wise ops),
``sum_shards`` (decomposable aggregates: count, groupby_sum), and
``kmerge_shards`` (k-way ordered merge of per-shard sorted tables) —
reassemble per-shard results.  The merge helpers are deliberately
numpy-only: they run on the host and never touch a device.

The streaming/IVM substrate (``core/deltaplan.py``) builds on the same
row-range algebra: a table that grew by appended rows is exactly a 2-shard
decomposition ``[old prefix, appended suffix]``, so ``append_rows`` /
``suffix_rows`` here are the base+delta halves of ``shard_rows`` /
``concat_shards``.  Both follow their input's residency (numpy in, numpy
out).  ``container_to_jsonable`` / ``container_from_jsonable`` round-trip
small containers through JSON — the materialized-view persistence format
that rides beside the plan cache.

Tensors held by a container may be shared with other containers (casts and
appends alias buffers, as the reference's immutable arrays do), so no code
in this package updates a container's tensor in place.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch


# -- residency helpers --------------------------------------------------------

def is_tensor(a) -> bool:
    return isinstance(a, torch.Tensor)


def resolve_device(device=None) -> torch.device:
    """An entry point's device: ``None`` means the CUDA card.  Asking for
    CUDA on a host without a usable card raises — nothing falls back to the
    CPU; pass ``device="cpu"`` to run there on purpose."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


def to_numpy(a) -> np.ndarray:
    """A host numpy view/copy of a tensor or array-like."""
    if is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def to_device(a, device) -> torch.Tensor:
    """``a`` (numpy, tensor or scalar) as a tensor on ``device``."""
    if is_tensor(a):
        return a.to(device)
    a = np.asarray(a)
    if not a.flags.writeable:
        a = a.copy()           # torch refuses to wrap read-only buffers
    return torch.as_tensor(a, device=device)


def array_nbytes(a) -> int:
    if is_tensor(a):
        return a.numel() * a.element_size()
    return int(np.asarray(a).nbytes)


def array_numel(a) -> int:
    if is_tensor(a):
        return a.numel()
    return int(np.size(a))


def _astype_like(a, like):
    """``a`` cast to ``like``'s dtype (numpy or torch)."""
    if is_tensor(a):
        return a.to(like.dtype)
    return a.astype(like.dtype)


@dataclass
class DenseTensor:
    """Array-engine native: a dense (possibly padded) tensor.

    ``valid_count`` is container metadata (SciDB-style): count() is O(1) here
    but a full scan in the columnar engine — the Fig.1 crossover.
    """
    data: torch.Tensor
    valid_count: int = -1
    fill: float = 0.0

    def __post_init__(self):
        if self.valid_count < 0:
            self.valid_count = int(np.prod(self.data.shape))

    @property
    def nbytes(self) -> int:
        return array_nbytes(self.data)

    kind = "dense"


@dataclass
class ColumnarTable:
    """Relational-engine native: named columns + validity mask (lazy deletes)."""
    columns: Dict[str, torch.Tensor]
    valid: torch.Tensor = None    # (N,) bool

    def __post_init__(self):
        n = self.nrows
        if self.valid is None:
            # follow the columns' residency: numpy columns get a numpy mask
            # (building a device mask for a host-side intermediate would
            # trigger exactly the transfer this layout avoids)
            first = next(iter(self.columns.values()))
            if is_tensor(first):
                self.valid = torch.ones((n,), dtype=torch.bool,
                                        device=first.device)
            else:
                self.valid = np.ones((n,), bool)

    @property
    def nrows(self) -> int:
        return next(iter(self.columns.values())).shape[0]

    @property
    def nbytes(self) -> int:
        return sum(array_nbytes(c) for c in self.columns.values())

    kind = "columnar"


@dataclass
class COOMatrix:
    """KV/associative-array native (D4M style): (row, col, val) triples."""
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.rows.shape[0]

    @property
    def nbytes(self) -> int:
        return (array_nbytes(self.rows) + array_nbytes(self.cols)
                + array_nbytes(self.vals))

    kind = "coo"


@dataclass
class StreamBuffer:
    """Stream-engine native: window-major ring buffer of samples."""
    data: torch.Tensor           # (n_windows, window_len, ...) newest last
    t0: int = 0                  # timestamp of the first window

    @property
    def nbytes(self) -> int:
        return array_nbytes(self.data)

    kind = "stream"


FORMATS = {"dense": DenseTensor, "columnar": ColumnarTable, "coo": COOMatrix,
           "stream": StreamBuffer}


def leaves(obj) -> Iterator:
    """Every array leaf of a container (or ``obj`` itself if it is one)."""
    if isinstance(obj, ColumnarTable):
        yield from obj.columns.values()
        yield obj.valid
    elif isinstance(obj, COOMatrix):
        yield obj.rows
        yield obj.cols
        yield obj.vals
    elif isinstance(obj, (DenseTensor, StreamBuffer)):
        yield obj.data
    elif obj is not None:
        yield obj


def device_ready(obj, device):
    """Home a container's array leaves on ``device``.

    For LONG-LIVED objects — catalog registrations — that will be consumed
    by device ops many times: paying the transfer once at registration beats
    re-transferring on every query.  Eager intermediates deliberately skip
    this (see module docstring)."""
    if isinstance(obj, ColumnarTable):
        return ColumnarTable({c: to_device(v, device)
                              for c, v in obj.columns.items()},
                             valid=to_device(obj.valid, device))
    if isinstance(obj, COOMatrix):
        return COOMatrix(to_device(obj.rows, device),
                         to_device(obj.cols, device),
                         to_device(obj.vals, device), obj.shape)
    if isinstance(obj, DenseTensor):
        return DenseTensor(to_device(obj.data, device),
                           valid_count=obj.valid_count, fill=obj.fill)
    if isinstance(obj, StreamBuffer):
        return StreamBuffer(to_device(obj.data, device), obj.t0)
    return obj


def host_copy(obj):
    """Numpy-leafed clone of a container — host-resident state (streaming
    tables, persisted views) never holds device tensors."""
    if isinstance(obj, ColumnarTable):
        return ColumnarTable({c: to_numpy(v) for c, v in obj.columns.items()},
                             valid=to_numpy(obj.valid))
    if isinstance(obj, COOMatrix):
        return COOMatrix(to_numpy(obj.rows), to_numpy(obj.cols),
                         to_numpy(obj.vals), tuple(obj.shape))
    if isinstance(obj, DenseTensor):
        return DenseTensor(to_numpy(obj.data),
                           valid_count=obj.valid_count, fill=obj.fill)
    if isinstance(obj, StreamBuffer):
        return StreamBuffer(to_numpy(obj.data), obj.t0)
    return obj


# -- row-range sharding -------------------------------------------------------

def shard_bounds(nrows: int, n_shards: int) -> List[Tuple[int, int]]:
    """N contiguous ``[lo, hi)`` row ranges covering ``nrows`` (remainder
    spread over the leading shards, every shard non-degenerate when
    ``nrows >= n_shards``)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    base, rem = divmod(nrows, n_shards)
    bounds, lo = [], 0
    for i in range(n_shards):
        hi = lo + base + (1 if i < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def shard_rows(obj, n_shards: int) -> list:
    """Split a container into ``n_shards`` contiguous row-range parts.

    Dense tensors and columnar tables shard on the leading axis, COO on the
    row coordinate (rows re-based to each shard's origin), streams on the
    window axis.  Concatenating the parts back (``concat_shards``) is the
    identity.
    """
    if isinstance(obj, DenseTensor):
        a = to_numpy(obj.data)
        if a.ndim < 1:
            raise ValueError("cannot row-shard a 0-d tensor")
        if obj.valid_count not in (-1, a.size):
            # a padded tensor's valid elements are not row-attributable, so
            # per-shard counts could not reassemble to the true total
            raise ValueError("cannot row-shard a padded DenseTensor")
        return [DenseTensor(a[lo:hi], fill=obj.fill)
                for lo, hi in shard_bounds(a.shape[0], n_shards)]
    if isinstance(obj, ColumnarTable):
        cols = {c: to_numpy(v) for c, v in obj.columns.items()}
        valid = to_numpy(obj.valid)
        return [ColumnarTable({c: v[lo:hi] for c, v in cols.items()},
                              valid=valid[lo:hi])
                for lo, hi in shard_bounds(obj.nrows, n_shards)]
    if isinstance(obj, COOMatrix):
        rows = to_numpy(obj.rows)
        cols = to_numpy(obj.cols)
        vals = to_numpy(obj.vals)
        parts = []
        for lo, hi in shard_bounds(obj.shape[0], n_shards):
            m = (rows >= lo) & (rows < hi)
            parts.append(COOMatrix((rows[m] - lo).astype(rows.dtype),
                                   cols[m], vals[m],
                                   (hi - lo, obj.shape[1])))
        return parts
    if isinstance(obj, StreamBuffer):
        a = to_numpy(obj.data)
        return [StreamBuffer(a[lo:hi], t0=obj.t0 + lo)
                for lo, hi in shard_bounds(a.shape[0], n_shards)]
    raise TypeError(f"cannot shard {type(obj).__name__}")


# -- shard merges -------------------------------------------------------------

def concat_shards(parts: Sequence):
    """Reassemble row-wise per-shard results: row concatenation in shard
    order (the inverse of ``shard_rows`` for every row-preserving op)."""
    if not parts:
        raise ValueError("no shard results to merge")
    first = parts[0]
    if isinstance(first, DenseTensor):
        data = np.concatenate([to_numpy(p.data) for p in parts], axis=0)
        vc = sum(p.valid_count for p in parts)
        return DenseTensor(data, valid_count=vc, fill=first.fill)
    if isinstance(first, ColumnarTable):
        return ColumnarTable(
            {c: np.concatenate([to_numpy(p.columns[c]) for p in parts])
             for c in first.columns},
            valid=np.concatenate([to_numpy(p.valid) for p in parts]))
    if isinstance(first, COOMatrix):
        rows, off = [], 0
        for p in parts:
            rows.append(to_numpy(p.rows) + off)
            off += p.shape[0]
        return COOMatrix(np.concatenate(rows).astype(to_numpy(first.rows).dtype),
                         np.concatenate([to_numpy(p.cols) for p in parts]),
                         np.concatenate([to_numpy(p.vals) for p in parts]),
                         (off, max(p.shape[1] for p in parts)))
    if isinstance(first, StreamBuffer):
        return StreamBuffer(
            np.concatenate([to_numpy(p.data) for p in parts], axis=0),
            t0=first.t0)
    raise TypeError(f"cannot concat-merge {type(first).__name__}")


def sum_shards(parts: Sequence):
    """Merge decomposable aggregates: element-wise sum over aligned shard
    results.  Covers ``count`` (0-d DenseTensor per shard -> grand total) and
    ``groupby_sum`` (every shard emits the full aligned key range
    ``0..num_groups``, so group partial sums add position-wise)."""
    if not parts:
        raise ValueError("no shard results to merge")
    first = parts[0]
    if isinstance(first, DenseTensor):
        data = to_numpy(parts[0].data)
        for p in parts[1:]:
            data = data + to_numpy(p.data)
        return DenseTensor(data, valid_count=first.valid_count,
                           fill=first.fill)
    if isinstance(first, ColumnarTable):
        key = to_numpy(first.columns["key"])
        for p in parts[1:]:
            if not np.array_equal(to_numpy(p.columns["key"]), key):
                raise ValueError("sum-merge requires aligned group keys")
        out = {"key": key}
        for c in first.columns:
            if c == "key":
                continue
            acc = to_numpy(first.columns[c])
            for p in parts[1:]:
                acc = acc + to_numpy(p.columns[c])
            out[c] = acc
        return ColumnarTable(out)
    raise TypeError(f"cannot sum-merge {type(first).__name__}")


def kmerge_shards(parts: Sequence, by: str):
    """K-way ordered merge of per-shard SORTED columnar tables on column
    ``by`` (classic heap merge: O(total rows * log k)).  Invalid rows are
    compacted away first; ties preserve shard order (stable)."""
    if not parts:
        raise ValueError("no shard results to merge")
    compact = []
    for p in parts:
        valid = to_numpy(p.valid)
        cols = {c: to_numpy(v) for c, v in p.columns.items()}
        if not valid.all():
            cols = {c: v[valid] for c, v in cols.items()}
        compact.append(cols)
    names = list(compact[0])
    offsets = np.cumsum([0] + [c[names[0]].shape[0] for c in compact])
    def stream(cols, si):
        # bound per shard (a bare genexp in the comprehension would
        # late-bind si/cols to the last shard)
        key = cols[by]
        return ((key[i], si, offsets[si] + i) for i in range(key.shape[0]))

    streams = [stream(cols, si) for si, cols in enumerate(compact)]
    order = np.fromiter((flat for _, _, flat in heapq.merge(*streams)),
                        dtype=np.int64)
    merged = {c: np.concatenate([cols[c] for cols in compact])[order]
              for c in names}
    return ColumnarTable(merged)


# -- streaming append / delta slicing ----------------------------------------

def _cat(base, extra, axis: int = 0):
    """``base`` and ``extra`` concatenated in ``base``'s residency: numpy
    leaves stay numpy, device leaves stay on their device."""
    if is_tensor(base):
        return torch.cat([base, to_device(extra, base.device)], dim=axis)
    return np.concatenate([base, to_numpy(extra)], axis=axis)


def leading_rows(obj) -> int:
    """Leading-dimension row count of a container — the quantity appends
    grow and the materialized-view freshness stamps record.  Raises
    ``TypeError`` for containers with no row dimension (0-d tensors)."""
    if isinstance(obj, ColumnarTable):
        return obj.nrows
    if isinstance(obj, COOMatrix):
        return int(obj.shape[0])
    data = getattr(obj, "data", None)
    if data is not None and getattr(data, "ndim", 0) >= 1:
        return int(data.shape[0])
    raise TypeError(f"no row dimension on {type(obj).__name__}")


def append_rows(base, delta):
    """``base`` grown by ``delta``'s rows along the leading dimension — the
    STREAM island's append semantics.  The result's old-row prefix is
    bit-identical to ``base`` (``suffix_rows(result, leading_rows(base)) ==
    delta``), which is what lets the IVM path reconstruct the pending delta
    from the current table without keeping an append log.  Containers must
    be the same kind with matching trailing geometry; padded dense tensors
    are refused for the same reason ``shard_rows`` refuses them (their
    valid elements are not row-attributable)."""
    if type(base) is not type(delta):
        raise TypeError(f"cannot append {type(delta).__name__} rows to "
                        f"{type(base).__name__}")
    if isinstance(base, DenseTensor):
        a, d = base.data, delta.data
        if getattr(a, "ndim", 0) < 1:
            raise ValueError("cannot append rows to a 0-d tensor")
        if tuple(a.shape[1:]) != tuple(d.shape[1:]):
            raise ValueError(f"append shape mismatch: base rows are "
                             f"{tuple(a.shape[1:])}, delta rows are "
                             f"{tuple(d.shape[1:])}")
        for t in (base, delta):
            if t.valid_count not in (-1, int(np.prod(t.data.shape))):
                raise ValueError("cannot append to/with a padded DenseTensor")
        return DenseTensor(_cat(a, d), fill=base.fill)
    if isinstance(base, ColumnarTable):
        if set(base.columns) != set(delta.columns):
            raise ValueError(f"append column mismatch: "
                             f"{sorted(base.columns)} vs "
                             f"{sorted(delta.columns)}")
        cols = {c: _cat(v, delta.columns[c]) for c, v in base.columns.items()}
        return ColumnarTable(cols, valid=_cat(base.valid, delta.valid))
    if isinstance(base, COOMatrix):
        off = int(base.shape[0])
        shifted = delta.rows + off
        rows = _cat(base.rows, shifted)
        return COOMatrix(_astype_like(rows, base.rows),
                         _cat(base.cols, delta.cols),
                         _cat(base.vals, delta.vals),
                         (off + int(delta.shape[0]),
                          max(int(base.shape[1]), int(delta.shape[1]))))
    if isinstance(base, StreamBuffer):
        if tuple(base.data.shape[1:]) != tuple(delta.data.shape[1:]):
            raise ValueError("append window-shape mismatch")
        return StreamBuffer(_cat(base.data, delta.data), t0=base.t0)
    raise TypeError(f"cannot append rows to {type(base).__name__}")


def suffix_rows(obj, start: int):
    """Rows ``[start:]`` of a container as a same-kind container — the
    pending delta of a streaming table whose materialized view was taken at
    ``start`` rows (the inverse of ``append_rows``)."""
    n = leading_rows(obj)
    if not 0 <= start <= n:
        raise ValueError(f"suffix start {start} outside [0, {n}]")
    if isinstance(obj, DenseTensor):
        if obj.valid_count not in (-1, int(np.prod(obj.data.shape))):
            raise ValueError("cannot row-slice a padded DenseTensor")
        return DenseTensor(obj.data[start:], fill=obj.fill)
    if isinstance(obj, ColumnarTable):
        return ColumnarTable({c: v[start:] for c, v in obj.columns.items()},
                             valid=obj.valid[start:])
    if isinstance(obj, COOMatrix):
        m = obj.rows >= start
        return COOMatrix(_astype_like(obj.rows[m] - start, obj.rows),
                         obj.cols[m], obj.vals[m],
                         (n - start, int(obj.shape[1])))
    if isinstance(obj, StreamBuffer):
        return StreamBuffer(obj.data[start:], t0=obj.t0 + start)
    raise TypeError(f"cannot row-slice {type(obj).__name__}")


# -- JSON round-trip (materialized-view persistence) --------------------------

def _arr_to_json(a) -> Dict:
    a = to_numpy(a)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "data": a.ravel().tolist()}


def _arr_from_json(blob) -> np.ndarray:
    return np.asarray(blob["data"], dtype=np.dtype(blob["dtype"])).reshape(
        tuple(blob["shape"]))


def container_to_jsonable(obj):
    """A pure-JSON encoding of a container (numpy-leafed values; call
    ``host_copy`` first for device objects), or ``None`` for types this
    codec does not cover.  Sized for SMALL payloads — materialized views
    under the persistence cap — not as a general serialization format."""
    if isinstance(obj, DenseTensor):
        return {"kind": "dense", "array": _arr_to_json(obj.data),
                "valid_count": int(obj.valid_count), "fill": float(obj.fill)}
    if isinstance(obj, ColumnarTable):
        return {"kind": "columnar",
                "columns": {c: _arr_to_json(v)
                            for c, v in obj.columns.items()},
                "valid": to_numpy(obj.valid).tolist()}
    if isinstance(obj, COOMatrix):
        return {"kind": "coo", "rows": _arr_to_json(obj.rows),
                "cols": _arr_to_json(obj.cols),
                "vals": _arr_to_json(obj.vals),
                "shape": [int(obj.shape[0]), int(obj.shape[1])]}
    if isinstance(obj, StreamBuffer):
        return {"kind": "stream", "array": _arr_to_json(obj.data),
                "t0": int(obj.t0)}
    return None


def container_from_jsonable(blob):
    """Inverse of ``container_to_jsonable`` (numpy-leafed result).  Raises
    ``ValueError`` on unknown kinds; key/shape errors propagate as the
    usual ``KeyError``/``TypeError`` for the caller's skip-with-warning
    policy."""
    kind = blob.get("kind") if isinstance(blob, dict) else None
    if kind == "dense":
        return DenseTensor(_arr_from_json(blob["array"]),
                           valid_count=int(blob["valid_count"]),
                           fill=float(blob["fill"]))
    if kind == "columnar":
        return ColumnarTable({c: _arr_from_json(v)
                              for c, v in blob["columns"].items()},
                             valid=np.asarray(blob["valid"], bool))
    if kind == "coo":
        return COOMatrix(_arr_from_json(blob["rows"]),
                         _arr_from_json(blob["cols"]),
                         _arr_from_json(blob["vals"]),
                         (int(blob["shape"][0]), int(blob["shape"][1])))
    if kind == "stream":
        return StreamBuffer(_arr_from_json(blob["array"]),
                            t0=int(blob.get("t0", 0)))
    raise ValueError(f"unknown container kind {kind!r}")
