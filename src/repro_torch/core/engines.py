"""Execution engines — the polystore's heterogeneous backends.

Each engine is an *execution regime*: a native data layout plus layout-true
algorithms.  The relative strengths are real, not simulated:

  dense_array (SciDB-analogue)   O(1) metadata count; GEMM-shaped matmul,
                                 hand-kernel Haar and kNN; distinct must scan
                                 padded storage.
  columnar (Postgres/Myria)      scan count; sort-based distinct/group/join on
                                 compacted columns; matmul only via
                                 join-aggregate over triples (the paper's
                                 166-minute Postgres anecdote).
  kv_sparse (Accumulo/Graphulo)  O(1) nnz count; segment-sum spmm; natural
                                 TF-IDF over triples (D4M associative arrays).
  stream (S-Store)               windowed aggregation via scan; ETL to arrays.

Every op: fn(attrs, *containers, device) -> container.  ``device`` is the
session's device: inputs that arrive as host numpy (join output, triple
casts) are homed there before device work, and every tensor an op creates
lives there.  Ops that a given engine cannot express are simply absent — the
planner must cast (paper: islands have partial engine coverage).

Index outputs (``knn``) are int32, the reference's index dtype.  Segment
sums drop out-of-range segment ids, as the reference's ``segment_sum`` does
(``segment_sum`` below), and float32 products run in full float32
(``repro_torch/__init__.py`` turns TF32 off).
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.core.tables import (COOMatrix, ColumnarTable, DenseTensor,
                                     StreamBuffer, to_device, to_numpy)


# ==========================================================================
# shared math
# ==========================================================================

def haar_1d_levels(x: torch.Tensor, levels: int) -> torch.Tensor:
    """Multi-level Haar DWT over the last axis.  Returns [a_L, d_L, ..., d_1]
    concatenated (same length as input; length must be divisible by 2^levels)."""
    inv = torch.tensor(1.0 / math.sqrt(2.0), dtype=x.dtype, device=x.device)
    details = []
    a = x
    for _ in range(levels):
        e, o = a[..., 0::2], a[..., 1::2]
        details.append((e - o) * inv)
        a = (e + o) * inv
    return torch.cat([a] + details[::-1], dim=-1)


def _scale_slices(T: int, levels: int):
    """[(offset, length)] per band of the haar_1d_levels output layout."""
    out = [(0, T >> levels)]
    off = T >> levels
    for l in range(levels, 0, -1):
        n = T >> l
        out.append((off, n))
        off += n
    return out


def _div(num, den: float) -> torch.Tensor:
    """``num / den`` as a true elementwise division.  (A Python-scalar
    divisor may run as a multiply by its reciprocal on CUDA, which rounds
    differently from the reference; a device tensor divisor does not.)"""
    return torch.div(num, torch.tensor(den, dtype=num.dtype,
                                       device=num.device))


def _rdiv(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` for a scalar numerator, as a true division (the
    reflected operator computes ``reciprocal(den) * num``)."""
    return torch.div(torch.tensor(num, dtype=den.dtype, device=den.device),
                     den)


def _bins(v: torch.Tensor, lo: float, hi: float, nbins: int) -> torch.Tensor:
    """Histogram bin of every value, clipped to [0, nbins)."""
    return torch.clamp((_div(v - lo, hi - lo) * nbins).to(torch.int32),
                       0, nbins - 1)


def segment_sum(data: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum of ``data`` rows per segment id.  Ids outside
    ``[0, num_segments)`` are dropped, as the reference's segment_sum drops
    them (``index_add_`` alone would raise or assert on the device)."""
    ids = ids.to(torch.int64)
    ok = (ids >= 0) & (ids < num_segments)
    ids = torch.where(ok, ids, num_segments)         # overflow row, cut below
    out = torch.zeros((num_segments + 1,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, ids, data)[:num_segments]


def _top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    return torch.topk(scores, k, dim=-1)[1].to(torch.int32)


def tfidf_dense(tf: torch.Tensor) -> torch.Tensor:
    """tf: (docs, terms) counts -> l2-normalized tf-idf."""
    n = tf.shape[0]
    df = torch.sum(tf > 0, dim=0)
    idf = torch.log(_rdiv(float(n), 1.0 + df.to(torch.float32))) + 1.0
    w = tf.to(torch.float32) * idf[None, :]
    norm = torch.linalg.vector_norm(w, dim=1, keepdim=True)
    return w / torch.clamp(norm, min=1e-9)


def _int32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def _count_distinct_sorted(s: torch.Tensor) -> torch.Tensor:
    """Boolean 'starts a new run' flags of a sorted 1-d tensor."""
    first = torch.ones(1, dtype=torch.bool, device=s.device)
    return torch.cat([first, s[1:] != s[:-1]])


# ==========================================================================
# dense_array engine
# ==========================================================================

def _da_count(attrs, d: DenseTensor, *, device):
    # SciDB-style: element count is container metadata — O(1)
    return DenseTensor(_int32(d.valid_count, device), valid_count=1)


def _da_distinct(attrs, d: DenseTensor, *, device):
    # must scan the full (padded) dense storage — fill values included in the
    # sort, exactly the cost a real array store pays on sparse data
    flat = torch.sort(to_device(d.data, device).reshape(-1)).values
    neq = _count_distinct_sorted(flat)
    return DenseTensor(torch.sum(neq).to(torch.int32), valid_count=1)


def _da_matmul(attrs, a: DenseTensor, b: DenseTensor, *, device):
    return DenseTensor(torch.matmul(to_device(a.data, device),
                                    to_device(b.data, device)))


def _da_select(attrs, d: DenseTensor, *, device):
    lo, hi = attrs.get("lo", -np.inf), attrs.get("hi", np.inf)
    x = to_device(d.data, device)
    m = (x >= lo) & (x <= hi)
    return DenseTensor(torch.where(m, x, d.fill),
                       valid_count=int(torch.sum(m)))


def _da_haar(attrs, d: DenseTensor, *, device):
    # the main path's hot spot — the hand-written kernel on the card
    from repro_torch.kernels import ops as kops
    return DenseTensor(kops.haar(to_device(d.data, device), attrs["levels"]))


def _da_bin_hist(attrs, d: DenseTensor, *, device):
    """Per-scale histograms of Haar coefficients.  The reference sums a
    one-hot tensor; materialising that one-hot here would take
    N * T * nbins * 8 bytes, so the same integer counts are taken with one
    ``bincount`` per band (exact, so bitwise equal to the one-hot sum)."""
    nbins, levels = attrs["nbins"], attrs["levels"]
    lo, hi = attrs.get("lo", -3.0), attrs.get("hi", 3.0)
    x = to_device(d.data, device)
    N, T = x.shape
    rows = torch.arange(N, device=x.device, dtype=torch.int64)[:, None]
    outs = []
    for off, ln in _scale_slices(T, levels):
        idx = _bins(x[:, off:off + ln], lo, hi, nbins)
        key = (rows * nbins + idx).reshape(-1)
        counts = torch.bincount(key, minlength=N * nbins)
        outs.append(counts.to(torch.float32).reshape(N, nbins))
    return DenseTensor(torch.cat(outs, dim=1))


def _da_tfidf(attrs, d: DenseTensor, *, device):
    return DenseTensor(tfidf_dense(to_device(d.data, device)))


def _da_knn(attrs, train: DenseTensor, test: DenseTensor, *, device):
    """Dot-product kNN via one scores kernel + top-k (int32 indices)."""
    from repro_torch.kernels import ops as kops
    tr = to_device(train.data, device)
    te = torch.atleast_2d(to_device(test.data, device))
    if tr.dtype != te.dtype or tr.dtype not in (torch.float32,
                                                torch.bfloat16):
        # the scores accumulate in float32 either way
        tr, te = tr.to(torch.float32), te.to(torch.float32)
    idx, _ = kops.knn(tr, te, attrs["k"])
    return DenseTensor(idx)


def _da_add(attrs, a, b, *, device):
    return DenseTensor(to_device(a.data, device) + to_device(b.data, device))


def _da_concat(attrs, a: DenseTensor, b: DenseTensor, *, device):
    """Row concatenation (leading axis).  ``valid_count`` adds — exact for
    unpadded operands, and for padded ones the per-operand counts are still
    the only row-attributable accounting available."""
    return DenseTensor(torch.cat([to_device(a.data, device),
                                  to_device(b.data, device)], dim=0),
                       valid_count=a.valid_count + b.valid_count,
                       fill=a.fill)


def _da_scale(attrs, a, *, device):
    return DenseTensor(to_device(a.data, device) * attrs["factor"])


def _da_transpose(attrs, a, *, device):
    x = to_device(a.data, device)
    return DenseTensor(x.permute(*reversed(range(x.ndim))))


# ==========================================================================
# columnar engine
# ==========================================================================

def _col_count(attrs, t: ColumnarTable, *, device):
    # full validity scan — Postgres-style COUNT(*)
    return DenseTensor(torch.sum(to_device(t.valid, device)).to(torch.int32),
                       valid_count=1)


def _col_distinct(attrs, t: ColumnarTable, *, device):
    col = attrs.get("column", "value")
    v = to_device(t.columns[col], device)
    valid = to_device(t.valid, device)
    sentinel = float("inf") if v.dtype.is_floating_point \
        else torch.iinfo(v.dtype).max
    vv = torch.where(valid, v, torch.tensor(sentinel, dtype=v.dtype,
                                            device=v.device))
    s = torch.sort(vv).values
    neq = _count_distinct_sorted(s)
    valid_sorted = torch.sort(valid.to(torch.uint8),
                              descending=True).values.to(torch.bool)
    return DenseTensor(torch.sum(neq & valid_sorted).to(torch.int32),
                       valid_count=1)


def _col_select(attrs, t: ColumnarTable, *, device):
    col, lo, hi = attrs["column"], attrs.get("lo", -np.inf), attrs.get("hi", np.inf)
    v = t.columns[col]
    m = t.valid & (v >= lo) & (v <= hi)
    return ColumnarTable(dict(t.columns), valid=m)


def _col_project(attrs, t: ColumnarTable, *, device):
    return ColumnarTable({c: t.columns[c] for c in attrs["columns"]},
                         valid=t.valid)


def _col_groupby_sum(attrs, t: ColumnarTable, *, device):
    key, val = attrs["key"], attrs["value"]
    nseg = attrs["num_groups"]
    valid = to_device(t.valid, device)
    k = torch.where(valid, to_device(t.columns[key], device),
                    nseg)                             # invalid -> dropped
    s = segment_sum(to_device(t.columns[val], device), k, nseg)
    return ColumnarTable({"key": torch.arange(nseg, dtype=torch.int32,
                                              device=device), "sum": s})


def _col_sort(attrs, t: ColumnarTable, *, device):
    """ORDER BY ``attrs["by"]`` (stable).  Output is COMPACTED — invalid rows
    are dropped, not carried — which is what makes the scatter–gather merge
    for this op a pure k-way ordered merge of per-shard runs.  Columns stay
    numpy for the same host-pool reasons as the join."""
    by = attrs["by"]
    valid = to_numpy(t.valid)
    cols = {c: to_numpy(v) for c, v in t.columns.items()}
    if not valid.all():
        cols = {c: v[valid] for c, v in cols.items()}
    order = np.argsort(cols[by], kind="stable")
    return ColumnarTable({c: v[order] for c, v in cols.items()})


def _col_join(attrs, a: ColumnarTable, b: ColumnarTable, *, device=None):
    """Sort-merge equi-join (eager; dynamic output size).

    Runs on the host and its output columns stay NUMPY: argsort/searchsorted/
    fancy-indexing are host work that releases the GIL (what makes joins
    overlap on the host pool).  A downstream device consumer (segment sums
    in matmul/knn, a dense cast) moves the columns over when it actually
    needs them."""
    ka, kb = attrs["left_on"], attrs["right_on"]
    av = to_numpy(a.valid); bv = to_numpy(b.valid)

    def live(cols, mask):
        # skip the boolean gather when nothing is masked out (the common
        # catalog-table case): an all-true fancy index would copy every
        # column — pure memory-bandwidth burn that scales terribly across
        # concurrent requests
        if mask.all():
            return {c: to_numpy(v) for c, v in cols.items()}
        return {c: to_numpy(v)[mask] for c, v in cols.items()}

    an = live(a.columns, av)
    bn = live(b.columns, bv)
    order = np.argsort(bn[kb], kind="stable")
    bk = bn[kb][order]
    left = np.searchsorted(bk, an[ka], side="left")
    right = np.searchsorted(bk, an[ka], side="right")
    counts = right - left
    ai = np.repeat(np.arange(an[ka].shape[0]), counts)
    offs = (left.astype(np.int64).repeat(counts)
            + _ranges_from_counts(counts))
    bi = order[offs]
    cols = {("l_" + c if c in bn else c): v[ai]
            for c, v in an.items()}
    cols.update({("r_" + c if ("l_" + c) in cols or c in an else c):
                 v[bi] for c, v in bn.items()})
    return ColumnarTable(cols)


def _ranges_from_counts(counts):
    total = int(counts.sum())
    out = np.ones(total, np.int64)
    if total == 0:
        return out
    starts = np.cumsum(counts)[:-1]
    out[0] = 0
    # zero counts make `starts` repeat an index; plain fancy-index -= keeps
    # only the last repeat's update, so unmatched rows corrupt every range
    # after them — subtract.at accumulates all of them.  Trailing zero
    # counts land a start AT ``total``: past every live range, droppable
    live = starts < total
    np.subtract.at(out, starts[live], counts[:-1][live])
    return np.cumsum(out)


def _col_matmul(attrs, a: ColumnarTable, b: ColumnarTable, *, device):
    """Relational matrix multiply: join A.j == B.i, multiply, group by (A.i,
    B.j) — the paper's Postgres-in-166-minutes formulation."""
    j = _col_join({"left_on": "j", "right_on": "i"},
                  ColumnarTable({"i": a.columns["i"], "j": a.columns["j"],
                                 "value": a.columns["value"]}, a.valid),
                  ColumnarTable({"i": b.columns["i"], "j": b.columns["j"],
                                 "value": b.columns["value"]}, b.valid))
    prod = j.columns["l_value"] * j.columns["r_value"]
    n = int(np.max(j.columns["l_i"])) + 1 if j.nrows else 0
    m = int(np.max(j.columns["r_j"])) + 1 if j.nrows else 0
    key = j.columns["l_i"].astype(np.int32) * m + j.columns["r_j"]
    s = segment_sum(to_device(prod, device), to_device(key, device), n * m)
    flat = torch.arange(n * m, device=device)
    return ColumnarTable({
        "i": (flat // max(m, 1)).to(torch.int32),
        "j": (flat % max(m, 1)).to(torch.int32),
        "value": s})


def _lexsort_ij(i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Row order sorted by i, then j (the reference's ``lexsort((j, i))``):
    a stable sort by the minor key, then a stable sort by the major key."""
    by_j = torch.argsort(j, stable=True)
    return by_j[torch.argsort(i[by_j], stable=True)]


def _col_haar(attrs, t: ColumnarTable, *, device):
    """Haar in the relational engine: ORDER BY (i, j), restructure to rows,
    transform, flatten back — the ordering/restructure cost is the honest
    price a row store pays for array math (paper Fig. 5, SciDB side)."""
    i = to_device(t.columns["i"], device)
    jj = to_device(t.columns["j"], device)
    order = _lexsort_ij(i, jj)
    v = to_device(t.columns["value"], device)[order]
    n = int(torch.max(i)) + 1
    T = int(torch.max(jj)) + 1
    mat = v.reshape(n, T)
    out = haar_1d_levels(mat, attrs["levels"])
    return ColumnarTable({"i": i[order], "j": jj[order],
                          "value": out.reshape(-1)})


def _col_bin_hist(attrs, t: ColumnarTable, *, device):
    """Sort/segment histogram — natural in a column store."""
    nbins, levels = attrs["nbins"], attrs["levels"]
    lo, hi = attrs.get("lo", -3.0), attrs.get("hi", 3.0)
    i = to_device(t.columns["i"], device)
    jj = to_device(t.columns["j"], device)
    v = to_device(t.columns["value"], device)
    n = int(torch.max(i)) + 1
    T = int(torch.max(jj)) + 1
    slices = _scale_slices(T, levels)
    starts = torch.tensor([s for s, _ in slices] + [T], dtype=jj.dtype,
                          device=jj.device)
    scale_of_j = torch.searchsorted(starts, jj, right=True) - 1
    b = _bins(v, lo, hi, nbins)
    nscales = len(slices)
    key = (i.to(torch.int64) * nscales + scale_of_j) * nbins + b
    hist = segment_sum(torch.ones_like(v, dtype=torch.float32), key,
                       n * nscales * nbins)
    hh = hist.reshape(n, nscales * nbins)
    ii, bb = torch.meshgrid(torch.arange(n, device=device),
                            torch.arange(nscales * nbins, device=device),
                            indexing="ij")
    return ColumnarTable({"i": ii.reshape(-1).to(torch.int32),
                          "j": bb.reshape(-1).to(torch.int32),
                          "value": hh.reshape(-1)})


def _tfidf_triples(i, jj, v, n: int, V: int):
    """TF-IDF weights of (doc i, term j, tf v) triples."""
    df = segment_sum((v > 0).to(torch.float32), jj, V)
    idf = torch.log(_rdiv(float(n), 1.0 + df)) + 1.0
    w = v * idf[jj.to(torch.int64)]
    norm2 = segment_sum(w * w, i, n)
    return w / torch.sqrt(torch.clamp(norm2[i.to(torch.int64)], min=1e-18))


def _col_tfidf(attrs, t: ColumnarTable, *, device):
    """TF-IDF over (i=doc, j=term, value=tf) triples via segment ops."""
    i = to_device(t.columns["i"], device)
    jj = to_device(t.columns["j"], device)
    v = to_device(t.columns["value"], device)
    n = int(torch.max(i)) + 1
    V = int(torch.max(jj)) + 1
    return ColumnarTable({"i": i, "j": jj,
                          "value": _tfidf_triples(i, jj, v, n, V)})


def _col_knn(attrs, train: ColumnarTable, test: ColumnarTable, *, device):
    """kNN as join-aggregate: join train and test on the term column, multiply,
    group by train doc."""
    j = _col_join({"left_on": "j", "right_on": "j"},
                  train, ColumnarTable({"j": test.columns["j"],
                                        "value": test.columns["value"]},
                                       test.valid))
    prod = j.columns["l_value"] * j.columns["r_value"]
    n = int(np.max(j.columns["i"])) + 1
    scores = segment_sum(to_device(prod, device),
                         to_device(j.columns["i"], device), n)
    return DenseTensor(_top_k_indices(scores, attrs["k"])[None, :])


# ==========================================================================
# kv_sparse engine (Accumulo / Graphulo / D4M)
# ==========================================================================

def _kv_count(attrs, m: COOMatrix, *, device):
    return DenseTensor(_int32(m.nnz, device), valid_count=1)


def _kv_distinct(attrs, m: COOMatrix, *, device):
    s = torch.sort(to_device(m.vals, device)).values
    neq = _count_distinct_sorted(s)
    return DenseTensor(torch.sum(neq).to(torch.int32), valid_count=1)


def _kv_spmm(attrs, m: COOMatrix, d: DenseTensor, *, device):
    """Graphulo-style server-side sparse matmul: segment-sum over triples."""
    cols = to_device(m.cols, device).to(torch.int64)
    contrib = to_device(m.vals, device)[:, None] \
        * to_device(d.data, device)[cols]
    out = segment_sum(contrib, to_device(m.rows, device), m.shape[0])
    return DenseTensor(out)


def _kv_tfidf(attrs, m: COOMatrix, *, device):
    n, V = m.shape
    rows = to_device(m.rows, device)
    cols = to_device(m.cols, device)
    w = _tfidf_triples(rows, cols, to_device(m.vals, device), n, V)
    return COOMatrix(rows, cols, w, m.shape)


def _kv_knn(attrs, train: COOMatrix, test, *, device):
    if isinstance(test, COOMatrix):         # migrator homed the test vector
        q = torch.zeros(test.shape[1], dtype=torch.float32, device=device)
        q[to_device(test.cols, device).to(torch.int64)] = \
            to_device(test.vals, device).to(torch.float32)
    else:
        q = to_device(test.data, device).reshape(-1)
    cols = to_device(train.cols, device).to(torch.int64)
    contrib = to_device(train.vals, device) * q[cols]
    scores = segment_sum(contrib, to_device(train.rows, device),
                         train.shape[0])
    return DenseTensor(_top_k_indices(scores, attrs["k"])[None, :])


def _kv_degree(attrs, m: COOMatrix, *, device):
    axis = attrs.get("axis", 0)
    seg = m.rows if axis == 0 else m.cols
    n = m.shape[axis]
    vals = to_device(m.vals, device)
    return DenseTensor(segment_sum(torch.ones_like(vals),
                                   to_device(seg, device), n))


# ==========================================================================
# stream engine (S-Store)
# ==========================================================================

def _st_window_agg(attrs, s: StreamBuffer, *, device):
    fn = {"mean": torch.mean, "max": torch.amax,
          "min": torch.amin}[attrs.get("fn", "mean")]
    return DenseTensor(fn(to_device(s.data, device), dim=1))


def _st_haar(attrs, s: StreamBuffer, *, device):
    return StreamBuffer(haar_1d_levels(to_device(s.data, device),
                                       attrs["levels"]), s.t0)


def _st_to_array(attrs, s: StreamBuffer, *, device):
    x = to_device(s.data, device)
    return DenseTensor(x.reshape(-1, x.shape[-1]))


def _st_ingest(attrs, s: StreamBuffer, d: DenseTensor, *, device):
    """Append new windows (ETL path of the paper's streaming application)."""
    x = to_device(s.data, device)
    new = to_device(d.data, device).reshape((-1,) + tuple(x.shape[1:]))
    return StreamBuffer(torch.cat([x, new], dim=0), s.t0)


# ==========================================================================
# registry
# ==========================================================================

class Engine:
    def __init__(self, name: str, kind: str, ops: Dict[str, Callable]):
        self.name = name
        self.kind = kind          # native container kind
        self.ops = ops

    def supports(self, op: str) -> bool:
        return op in self.ops

    def run(self, op: str, attrs, *inputs, device):
        """Run ``op`` with every tensor it creates on ``device``."""
        return self.ops[op](attrs, *inputs, device=torch.device(device))

    def __repr__(self):
        return f"Engine({self.name})"


ENGINES: Dict[str, Engine] = {
    "dense_array": Engine("dense_array", "dense", {
        "count": _da_count, "distinct": _da_distinct, "matmul": _da_matmul,
        "select": _da_select, "haar": _da_haar, "bin_hist": _da_bin_hist,
        "tfidf": _da_tfidf, "knn": _da_knn, "add": _da_add,
        "scale": _da_scale, "transpose": _da_transpose,
        "concat": _da_concat,
    }),
    "columnar": Engine("columnar", "columnar", {
        "count": _col_count, "distinct": _col_distinct, "select": _col_select,
        "project": _col_project, "groupby_sum": _col_groupby_sum,
        "sort": _col_sort,
        "join": _col_join, "matmul": _col_matmul, "haar": _col_haar,
        "bin_hist": _col_bin_hist, "tfidf": _col_tfidf, "knn": _col_knn,
    }),
    "kv_sparse": Engine("kv_sparse", "coo", {
        "count": _kv_count, "distinct": _kv_distinct, "spmm": _kv_spmm,
        "tfidf": _kv_tfidf, "knn": _kv_knn, "degree": _kv_degree,
    }),
    "stream": Engine("stream", "stream", {
        "window_agg": _st_window_agg, "haar": _st_haar,
        "to_array": _st_to_array, "ingest": _st_ingest,
    }),
}
