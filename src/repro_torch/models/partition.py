"""Logical-axis partitioning environment.

The port of ``repro.models.partition``.  Model code names tensor
dimensions by *logical* axes; this module resolves them to mesh axes
according to the active ``PlanConfig`` (the polystore tensor plan: which
sharding regime runs the step).

Logical names:
  "dp"    data-parallel axes (("pod","data") on the multi-pod mesh)
  "fsdp"  parameter sharding over the DP axes (ZeRO-3 style) — plan.fsdp
  "tp"    tensor-parallel axis ("model")                      — plan.tp
  "sp"    sequence sharding of remat boundaries over "model"  — plan.sp_boundary
  "ep"    expert sharding over "model"                        — plan.moe_ep
  "cache" decode KV-cache seq sharding over "model"           — plan.cache_seq_shard
  None    replicated

Resolution drops an axis whose size does not divide the dimension (e.g.
kv_heads=2 over a 16-way model axis): the dimension is replicated.  Outside
a ``plan_scope`` every spec is empty and the model code runs on one device.

A mesh is a ``torch.distributed`` ``DeviceMesh`` (``launch.mesh``) or an
``AbstractMesh``, which has only axis names and sizes: that is all
``PlanEnv`` reads to resolve specs, so specs resolve without a process
group.  A resolved spec is a ``PartitionSpec``; ``placements`` turns it
into one ``Shard``/``Replicate`` per mesh dimension for ``DTensor``.

The reference's ``pcon`` (a sharding constraint on an activation) is not
ported.  In the port, activations are each rank's local tensors, and the
layouts the reference constrains are made by explicit collectives: the
batch split (``local_rows``) and its inverse, the per-layer weight gathers
over the ``fsdp`` axes (``gather_leaf``), and the collectives of the
tensor-parallel split over "model" that GSPMD derives from the
reference's constraints (below).

Tensor parallelism (Megatron-LM's scheme).  A tensor on the ranks along
"model" is either *replicated* (the same on every rank, and so is its
gradient) or *rank-partial*: inside a region between an entry and an exit
each rank computes with its own shard of the weights (its heads, its
``d_ff`` columns, its experts, its vocabulary), so its outputs are
partial sums and its inputs' gradients too.  The collectives come in
conjugate pairs:

  ``tp_enter`` (f)    identity forward, all-reduce of the gradient
  ``tp_exit``  (g)    all-reduce forward, identity backward
  ``seq_enter``       all-gather on seq forward, reduce-scatter backward
  ``seq_exit``        reduce-scatter on seq forward, all-gather backward
  ``tp_split``        this rank's chunk forward, all-gather backward
  ``tp_gather``       all-gather forward, this rank's chunk backward
  ``tp_sum``          all-reduce forward, all-reduce backward

(``seq_enter`` is ``tp_gather`` then f, ``seq_exit`` g then ``tp_split``:
the sequence-parallel forms of f and g.)  g is not
``torch.distributed.nn.functional.all_reduce``, whose backward all-reduces
again and multiplies the gradients by the axis size.  ``tp_sum`` is that
all-reduce: a sum inside a region (the Mamba mixer's gated norm sums its
squares over the ranks' heads) whose consumers are rank-partial, so that
the gradient each rank hands back is partial too and is summed.  Every helper is the
identity, and launches and counts nothing, when the plan resolves "tp" to
no axis or the axis has one rank (``tp_active``); otherwise each call is
counted by kind (``tp_collectives``), each ``redistribute`` that a
weight gather issues by ``weight_gathers``, and those that gather a leaf
split over "model" by the leaf's name (``model_gathers``); the bytes that
the collectives move are tallied by kind (``collective_bytes``).  A replicated weight used
inside a region, or on a rank's rows of the sequence, gets a gradient that
is a partial sum over "model": its gather says so (``gather_leaf``'s
``partial``), as does a weight split over "model" that a region gathers
whole (the Mamba mixer's conv, whose even split does not fall on the
rank's heads).
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import PlanConfig
from repro_torch.kernels import counters

_ENV = threading.local()


class AbstractMesh:
    """A mesh's axis names and sizes, without devices or a process group:
    enough to resolve specs (``spec``, the spec trees of ``models.api``)
    for a mesh larger than the ranks at hand."""

    def __init__(self, names: Sequence[str], sizes: Sequence[int]):
        if len(names) != len(sizes):
            raise ValueError(f"{len(names)} names for {len(sizes)} sizes")
        self.mesh_dim_names = tuple(names)
        self.shape = tuple(int(s) for s in sizes)


class PartitionSpec:
    """A resolved spec, as ``jax.sharding.PartitionSpec``: one entry per
    leading tensor dimension, None (replicated), a mesh axis name, or a
    tuple of names (the dimension split over those axes, major to minor).
    Not a tuple, so that a tree of specs keeps each spec as one leaf;
    ``tuple(spec)`` gives its entries."""
    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        if isinstance(other, PartitionSpec):
            return self.entries == other.entries
        return NotImplemented

    def __repr__(self):
        return f"PartitionSpec{self.entries!r}"


P = PartitionSpec


def entry_axes(entry) -> tuple:
    """The mesh axes of one spec entry, major to minor."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class PlanEnv:
    def __init__(self, mesh, plan: PlanConfig):
        self.mesh = mesh
        self.plan = plan
        names = tuple(mesh.mesh_dim_names)
        self.axis_names = names
        self.dp_axes = tuple(a for a in ("pod", "data") if a in names) \
            or (names[0],)
        self.tp_axis = "model" if "model" in names else None
        self.axis_size = dict(zip(names, (int(s) for s in mesh.shape)))
        # the spec entry that split the batch of the step being run
        # (``splitting``); None: every rank holds the whole batch
        self.split = None

    def resolve(self, name) -> Union[None, str, tuple]:
        plan = self.plan
        if name is None:
            return None
        if name == "dp":
            axes = self.dp_axes
            if not plan.tp and self.tp_axis:
                axes = axes + (self.tp_axis,)   # tp off: DP absorbs model axis
            return axes if len(axes) > 1 else axes[0]
        if name == "fsdp":
            return self.resolve("dp") if plan.fsdp else None
        if name == "tp":
            return self.tp_axis if plan.tp else None
        if name == "sp":
            return self.tp_axis if (plan.tp and plan.sp_boundary) else None
        if name == "ep":
            return self.tp_axis if (plan.tp and plan.moe_ep) else None
        if name == "cache":
            return self.tp_axis if (plan.tp and plan.cache_seq_shard) else None
        raise ValueError(f"unknown logical axis {name!r}")

    def axes_size(self, resolved) -> int:
        return math.prod(self.axis_size[a] for a in entry_axes(resolved))

    @property
    def distributed(self) -> bool:
        """Whether the mesh has ranks (a ``DeviceMesh``), not only names."""
        return not isinstance(self.mesh, AbstractMesh)

    @contextmanager
    def splitting(self, entry):
        """Within the block, gradients are partial sums over the mesh axes
        of ``entry`` (the spec entry that split the batch), and replicated
        over the others: ranks that hold the same rows compute the same
        gradient, and summing it over them would count those rows twice."""
        prev = self.split
        self.split = entry
        try:
            yield
        finally:
            self.split = prev

    def grad_placements(self) -> tuple:
        axes = entry_axes(self.split)
        return tuple(Partial() if a in axes else Replicate()
                     for a in self.axis_names)


def current_env() -> Optional[PlanEnv]:
    return getattr(_ENV, "env", None)


def ranks_env() -> Optional[PlanEnv]:
    """The current env if its mesh has ranks (a ``DeviceMesh``), else
    None: the model code then runs on one device."""
    env = current_env()
    return env if env is not None and env.distributed else None


@contextmanager
def plan_scope(mesh, plan: PlanConfig):
    """Make ``PlanEnv(mesh, plan)`` current on this thread (``mesh=None``:
    no env, one device)."""
    prev = getattr(_ENV, "env", None)
    _ENV.env = PlanEnv(mesh, plan) if mesh is not None else None
    try:
        yield _ENV.env
    finally:
        _ENV.env = prev


@contextmanager
def use_env(env: Optional[PlanEnv]):
    """Make an existing env (or none) current on this thread: the backward
    pass may run a recompute on another thread than the scope's."""
    prev = getattr(_ENV, "env", None)
    _ENV.env = env
    try:
        yield env
    finally:
        _ENV.env = prev


def spec(shape: Sequence[int], names: Sequence) -> PartitionSpec:
    """Resolve logical names against the active env, honoring divisibility."""
    env = current_env()
    if env is None:
        return P()
    entries = []
    for dim, name in zip(shape, names):
        r = env.resolve(name)
        if r is not None and dim % env.axes_size(r) != 0:
            r = None  # cannot shard this dim — replicate (e.g. kv_heads < tp)
        entries.append(r)
    return P(*entries)


def spec_placements(mesh_names: Sequence[str], s: PartitionSpec) -> tuple:
    """One placement per mesh dimension: ``Shard(d)`` where the spec splits
    tensor dimension d over that axis, else ``Replicate()``.  A dimension
    split over several axes takes them in mesh order, which is the spec's
    major-to-minor order (DTensor's default for one dimension sharded over
    several mesh dimensions)."""
    names = tuple(mesh_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(s):
        idx = [names.index(a) for a in entry_axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
        for k in idx:
            out[k] = Shard(d)
    return tuple(out)


class NamedSharding:
    """A spec on a mesh, as ``jax.sharding.NamedSharding``, with its
    ``DTensor`` placements."""
    __slots__ = ("mesh", "spec", "placements")

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec
        self.placements = spec_placements(mesh.mesh_dim_names, spec)


def placements(shape: Sequence[int], names: Sequence) -> tuple:
    """``spec(shape, names)`` as placements on the active env's mesh."""
    env = current_env()
    if env is None:
        raise RuntimeError("placements need a plan_scope")
    return spec_placements(env.axis_names, spec(shape, names))


# --------------------------------------------------------------------------
# execution under a scope: gathers and the batch split
# --------------------------------------------------------------------------

def _env_with_ranks() -> PlanEnv:
    env = ranks_env()
    if env is None:
        raise RuntimeError("needs a plan_scope over a DeviceMesh")
    return env


class _Count:
    """Counters as attributes, for ``kernels.counters``."""

    def __init__(self, *names):
        for n in names:
            setattr(self, n, 0)


TP_KINDS = ("f", "g", "seq_enter", "seq_exit", "split", "gather", "max",
            "sum")
_TP_COUNT = _Count(*TP_KINDS)
_GATHER_COUNT = _Count("redistributes")
# leaf name -> redistributes over "model" (``model_gathers``)
_MODEL_GATHERS: dict = {}


def tp_collectives() -> dict:
    """Calls of the tensor-parallel helpers since the last
    ``reset_tp_collectives``, by kind: "f" (``tp_enter``), "g"
    (``tp_exit``), "seq_enter", "seq_exit", "split" (``tp_split``),
    "gather" (``tp_gather``), "max" (``tp_max``) and "sum"
    (``tp_sum``)."""
    return counters.read({k: (_TP_COUNT, k) for k in TP_KINDS})


def reset_tp_collectives() -> None:
    counters.reset([(_TP_COUNT, k) for k in TP_KINDS])


def weight_gathers() -> int:
    """``DTensor.redistribute`` calls issued by weight gathers
    (``gather_leaf``) since the last ``reset_weight_gathers``."""
    return _GATHER_COUNT.redistributes


def model_gathers() -> dict:
    """Of those, the ones that gathered a leaf split over "model", by the
    leaf's name (``gather_leaf``'s ``name``)."""
    with counters._LOCK:
        return dict(_MODEL_GATHERS)


def reset_weight_gathers() -> None:
    counters.reset([(_GATHER_COUNT, "redistributes")])
    with counters._LOCK:
        _MODEL_GATHERS.clear()


# kind -> [collectives, bytes] (``collective_bytes``)
_COLL_BYTES: dict = {}


def _tally(kind: str, t) -> None:
    """Count one collective of ``kind`` whose result is ``t`` (a tensor, or
    its size in bytes): an all-reduce twice its size (a ring's
    reduce-scatter and all-gather), the others their result's size."""
    nbytes = t if isinstance(t, int) else t.numel() * t.element_size()
    with counters._LOCK:
        rec = _COLL_BYTES.setdefault(kind, [0, 0.0])
        rec[0] += 1
        rec[1] += nbytes * (2.0 if kind == "all-reduce" else 1.0)


def collective_bytes() -> tuple:
    """(total bytes, {kind: {"count", "bytes"}}) of the collectives that
    this rank has issued in this process (a caller takes differences), as
    ``repro.launch.dryrun.parse_collective_bytes`` reads them from HLO:
    the tensor-parallel helpers' (forward and backward), the weight
    gathers' all-gathers and their gradients' reductions (one
    reduce-scatter onto the weight's shard, or an all-reduce where it is
    replicated over an axis that splits the batch), the cache's gathers
    (``rows_of``), the batch's (``gather_rows``) and ``all_reduce``'s.
    Collectives that ``DTensor`` issues on its own (the optimizer's norm,
    a gradient's ``redistribute`` onto its parameter's placements) are not
    in it."""
    with counters._LOCK:
        out = {k: {"count": n, "bytes": b} for k, (n, b)
               in _COLL_BYTES.items()}
    return sum(v["bytes"] for v in out.values()), out


def _tally_gradient(local, shard_bytes: int, kind: str) -> None:
    """Tally the reduction of ``local``'s gradient when backward makes it."""
    if local.requires_grad:
        local.register_hook(
            lambda g: _tally(kind, shard_bytes if kind == "reduce-scatter"
                             else g))


def gather_leaf(t, *, keep_tp: bool = True, partial: bool = False,
                name: str = ""):
    """A ``DTensor`` weight as this rank's local tensor for compute: gathered
    over every mesh axis but "model" (the ``fsdp`` axes: the reference's
    ``gather_fsdp``), or over all of them with ``keep_tp=False``; a split
    over "model" stays this rank's shard.  Axes of one rank are not
    gathered, so a mesh of size-1 axes issues no ``redistribute``.  The
    local tensor's gradient goes back as a partial sum over the axes that
    split the batch (a reduce-scatter onto ``t``'s shards, or an all-reduce
    where ``t`` is replicated), as this rank's shard over "model" where
    that is kept, and, with ``partial``, as a partial sum over "model"
    where the local tensor is whole there (a replicated weight used inside
    a tensor-parallel region or on a rank's rows of the sequence, or a
    split one gathered whole for such a region: reduce-scattered back onto
    its shards).  ``name`` (the leaf's) is what ``model_gathers`` counts.
    A plain tensor passes through."""
    if not isinstance(t, DTensor):
        return t
    env = _env_with_ranks()
    mesh = t.device_mesh
    tp = env.resolve("tp")
    split = entry_axes(env.split)
    target, grads = [], []
    over_model = False
    for axis, pl, n in zip(mesh.mesh_dim_names, t.placements, mesh.shape):
        if n == 1:
            target.append(pl)
            grads.append(pl)
        elif axis == tp and keep_tp:
            target.append(pl)
            grads.append(pl if isinstance(pl, Shard)
                         else Partial() if partial else Replicate())
        else:
            target.append(Replicate())
            over_model |= axis == tp and isinstance(pl, Shard)
            grads.append(Partial() if axis in split
                         or (partial and axis == tp) else Replicate())
    if tuple(target) != tuple(t.placements):
        counters.count(_GATHER_COUNT, "redistributes")
        if over_model:
            with counters._LOCK:
                _MODEL_GATHERS[name] = _MODEL_GATHERS.get(name, 0) + 1
        shard = t.to_local()
        shard_bytes = shard.numel() * shard.element_size()
        sharded = any(isinstance(pl, Shard) and not isinstance(tg, Shard)
                      for pl, tg in zip(t.placements, target))
        t = t.redistribute(mesh, target)
        local = t.to_local(grad_placements=grads)
        _tally("all-gather", local)
        if any(isinstance(g, Partial) for g in grads):
            _tally_gradient(local, shard_bytes, "reduce-scatter" if sharded
                            else "all-reduce")
        return local
    local = t.to_local(grad_placements=grads)
    if any(isinstance(g, Partial) for g in grads):
        _tally_gradient(local, 0, "all-reduce")
    return local


def _split(entry) -> tuple:
    """(this rank's block, number of blocks) of a dimension split by spec
    entry ``entry``: the coordinates on its axes, major to minor."""
    env = _env_with_ranks()
    index, n = 0, 1
    for a in entry_axes(entry):
        size = env.axis_size[a]
        index = index * size + env.mesh.get_local_rank(a)
        n *= size
    return index, n


def batch_entry(batch: int):
    """The spec entry that splits a batch of ``batch`` rows ("dp", with
    the divisibility guard)."""
    return spec((batch,), ("dp",))[0]


def local_rows(x, entry):
    """This rank's rows (dimension 0) of a global batch tensor ``x``
    split by spec entry ``entry``; ``x`` itself when ``entry`` is None."""
    if entry is None:
        return x
    i, n = _split(entry)
    rows = x.shape[0] // n
    return x[i * rows:(i + 1) * rows]


def current_split():
    """The spec entry that split the current step's batch (None outside a
    scope or when it is not split)."""
    env = ranks_env()
    return None if env is None else env.split


def gather_rows(x):
    """The inverse of ``local_rows`` under the batch split of the current
    step (``PlanEnv.splitting``): every rank's rows of ``x``, all-gathered
    in the global order.  ``x`` itself outside a scope or when the batch is
    not split."""
    env = ranks_env()
    if env is None or env.split is None:
        return x
    pl = spec_placements(env.axis_names, P(env.split))
    out = DTensor.from_local(x.contiguous(), env.mesh, pl,
                             run_check=False).full_tensor()
    _tally("all-gather", out)
    return out


def mean_over_split(x):
    """The mean over the ranks that split the current step's batch of a
    value that each computed on its own rows (a 0-d tensor)."""
    env = ranks_env()
    if env is None or env.split is None:
        return x
    axes = entry_axes(env.split)
    pl = tuple(Partial() if a in axes else Replicate()
               for a in env.axis_names)
    total = DTensor.from_local(x.detach().reshape(()), env.mesh, pl,
                               run_check=False).full_tensor()
    _tally("all-reduce", total)
    return total / env.axes_size(env.split)


# --------------------------------------------------------------------------
# cache spans
# --------------------------------------------------------------------------

def rows_placements(mesh_names, pls, keep_tp: bool = False) -> list:
    """Placements ``pls`` with only the DP axes' kept (and, with
    ``keep_tp``, the "model" axis's): the layout of this rank's rows,
    whole along every other dimension."""
    env = _env_with_ranks()
    keep = entry_axes(env.resolve("dp"))
    if keep_tp:
        keep = keep + entry_axes(env.resolve("tp"))
    return [pl if name in keep else Replicate()
            for name, pl in zip(mesh_names, pls)]


def _rows_placements(t: DTensor, keep_tp: bool) -> list:
    return rows_placements(t.device_mesh.mesh_dim_names, t.placements,
                           keep_tp)


def rows_of(t, keep_tp: bool = False):
    """A cache leaf's rows of this rank, whole along the other dimensions
    (gathered over the axes that split them), or with ``keep_tp`` still
    split over "model" (this rank's heads of an SSM state: no gather); a
    plain tensor itself."""
    if not isinstance(t, DTensor):
        return t
    pls = _rows_placements(t, keep_tp)
    if pls == list(t.placements):
        return t.to_local()
    rows = t.redistribute(t.device_mesh, pls).to_local()
    _tally("all-gather", rows)
    return rows


def store_rows(t, rows, keep_tp: bool = False):
    """Write this rank's span of ``rows`` (as ``rows_of`` gives them, with
    the same ``keep_tp``) into the cache leaf ``t`` IN PLACE; nothing to
    do where ``rows`` is the leaf's own storage."""
    local = t.to_local() if isinstance(t, DTensor) else t
    if local.data_ptr() == rows.data_ptr() and local.shape == rows.shape:
        return
    pls = _rows_placements(t, keep_tp) if isinstance(t, DTensor) else None
    if pls is None or pls == list(t.placements):
        local.copy_(rows)
        return
    span = DTensor.from_local(rows, t.device_mesh, pls, run_check=False)
    local.copy_(span.redistribute(t.device_mesh, t.placements).to_local())


def span_start(t: DTensor, dim: int, axis: str) -> int:
    """The global index of the first element of ``t``'s local span along
    ``dim``, which is split over mesh axis ``axis`` alone."""
    return t.device_mesh.get_local_rank(axis) * t.to_local().shape[dim]


def all_reduce(x, op, axis: str):
    """In-place all-reduce of ``x`` over the ranks along mesh ``axis``."""
    env = _env_with_ranks()
    dist.all_reduce(x, op=op, group=env.mesh.get_group(axis))
    _tally("all-reduce", x)
    return x


# --------------------------------------------------------------------------
# tensor parallelism over "model"
# --------------------------------------------------------------------------

def _tp_axis():
    """(group, ranks, this rank's index) along the axis that "tp" resolves
    to, when it has more than one rank; else None."""
    env = ranks_env()
    if env is None:
        return None
    axis = env.resolve("tp")
    if axis is None or env.axis_size[axis] == 1:
        return None
    return (env.mesh.get_group(axis), env.axis_size[axis],
            env.mesh.get_local_rank(axis))


def tp_active() -> bool:
    """Whether the compute is split over "model" (a ranks' scope whose plan
    resolves "tp" to an axis of more than one rank)."""
    return _tp_axis() is not None


def tp_rank() -> int:
    """This rank's index along "model" (0 when the compute is not split)."""
    t = _tp_axis()
    return 0 if t is None else t[2]


def tp_splits(n: int) -> bool:
    """Whether a dimension of ``n`` that a rule marks "tp" is split over
    "model" here: the compute is split and the divisibility guard keeps
    the axis (``spec``)."""
    return tp_active() and spec((n,), ("tp",))[0] is not None


def tp_ways(n: int) -> int:
    """The ranks along "model" that a dimension of ``n`` marked "tp" is
    split over under the current env, a mesh with ranks or an
    ``AbstractMesh`` (``spec``'s divisibility guard); 1 outside a scope,
    where the plan resolves "tp" to no axis, or where the guard keeps the
    dimension whole."""
    env = current_env()
    axis = None if env is None else env.resolve("tp")
    if axis is None:
        return 1
    size = env.axis_size[axis]
    return size if n % size == 0 else 1


def seq_splits(n: int) -> bool:
    """Whether a sequence of ``n`` rows is split over "model" between blocks
    (``sp_boundary``, the "sp" rule, with its divisibility guard)."""
    return tp_active() and spec((n,), ("sp",))[0] is not None


_all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _all_reduce_sum(x, group):
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    _tally("all-reduce", out)
    return out


def _all_gather(x, dim, group, n):
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    x0 = x.movedim(dim, 0).contiguous()
    out = x0.new_empty((n * x0.shape[0],) + tuple(x0.shape[1:]))
    _all_gather_single(out, x0, group=group)
    _tally("all-gather", out)
    return out.movedim(0, dim)


def _reduce_scatter(x, dim, group, n):
    """This rank's chunk along ``dim`` of the sum of the ranks' ``x``."""
    x0 = x.movedim(dim, 0).contiguous()
    out = x0.new_empty((x0.shape[0] // n,) + tuple(x0.shape[1:]))
    _reduce_scatter_single(out, x0, group=group)
    _tally("reduce-scatter", out)
    return out.movedim(0, dim)


def _chunk(x, dim, n, rank):
    size = x.shape[dim] // n
    return x.narrow(dim, rank * size, size)


class _Enter(torch.autograd.Function):
    """f: identity forward, the gradient all-reduced."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce_sum(dy, ctx.group), None


class _Exit(torch.autograd.Function):
    """g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _Sum(torch.autograd.Function):
    """All-reduce forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce_sum(dy, ctx.group), None


class _SeqEnter(torch.autograd.Function):
    """All-gather forward, reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.args = (dim, group, n)
        return _all_gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, dy):
        return _reduce_scatter(dy, *ctx.args), None, None, None


class _SeqExit(torch.autograd.Function):
    """Reduce-scatter forward, all-gather backward."""

    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.args = (dim, group, n)
        return _reduce_scatter(x, dim, group, n)

    @staticmethod
    def backward(ctx, dy):
        return _all_gather(dy, *ctx.args), None, None, None


class _Split(torch.autograd.Function):
    """This rank's chunk forward, all-gather backward."""

    @staticmethod
    def forward(ctx, x, dim, group, n, rank):
        ctx.args = (dim, group, n)
        return _chunk(x, dim, n, rank)

    @staticmethod
    def backward(ctx, dy):
        return _all_gather(dy, *ctx.args), None, None, None, None


class _Gather(torch.autograd.Function):
    """All-gather forward, this rank's chunk backward."""

    @staticmethod
    def forward(ctx, x, dim, group, n, rank):
        ctx.args = (dim, n, rank)
        return _all_gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, dy):
        return _chunk(dy, *ctx.args), None, None, None, None


def tp_enter(x):
    """f: ``x`` (replicated over "model") into a tensor-parallel region."""
    t = _tp_axis()
    if t is None:
        return x
    counters.count(_TP_COUNT, "f")
    return _Enter.apply(x, t[0])


def tp_exit(x):
    """g: the ranks' partial sums ``x`` summed (all-reduce), replicated."""
    t = _tp_axis()
    if t is None:
        return x
    counters.count(_TP_COUNT, "g")
    return _Exit.apply(x, t[0])


def tp_sum(x):
    """The sum over the ranks of a rank-partial ``x`` inside a region,
    for rank-partial consumers: all-reduced, and its gradient too."""
    t = _tp_axis()
    if t is None:
        return x
    counters.count(_TP_COUNT, "sum")
    return _Sum.apply(x, t[0])


def seq_enter(x, dim: int = 1):
    """This rank's rows of the sequence (``dim``) all-gathered into a
    tensor-parallel region (its gradient reduce-scattered)."""
    t = _tp_axis()
    if t is None:
        return x
    counters.count(_TP_COUNT, "seq_enter")
    return _SeqEnter.apply(x, dim, t[0], t[1])


def seq_exit(x, dim: int = 1):
    """The ranks' partial sums ``x`` reduce-scattered on the sequence
    (``dim``): this rank's rows of their sum."""
    t = _tp_axis()
    if t is None:
        return x
    counters.count(_TP_COUNT, "seq_exit")
    return _SeqExit.apply(x, dim, t[0], t[1])


def tp_split(x, dim: int):
    """This rank's chunk along ``dim`` of a replicated ``x`` (a view)."""
    t = _tp_axis()
    if t is None:
        return x
    counters.count(_TP_COUNT, "split")
    return _Split.apply(x, dim, t[0], t[1], t[2])


def tp_gather(x, dim: int):
    """The ranks' chunks ``x`` concatenated along ``dim``, replicated."""
    t = _tp_axis()
    if t is None:
        return x
    counters.count(_TP_COUNT, "gather")
    return _Gather.apply(x, dim, t[0], t[1], t[2])


def tp_max(x):
    """The element-wise maximum of the ranks' ``x`` (no gradient)."""
    t = _tp_axis()
    if t is None:
        return x
    counters.count(_TP_COUNT, "max")
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=t[0])
    _tally("all-reduce", out)
    return out
