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
ported.  In the port, activations are each rank's local tensors: the
layouts the reference constrains follow from the batch split
(``local_rows``) and the per-layer weight gathers (``gather_whole``), so a
``pcon`` would be an identity at every call site.  The helpers below are
what the port's model code runs under a scope instead: gathers of weights
and cache spans, the batch split and its inverse.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Optional, Sequence, Union

import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import PlanConfig

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


def gather_whole(t):
    """A ``DTensor`` weight gathered whole, as a local tensor whose gradient
    goes back as a partial sum over the axes that split the batch (a
    reduce-scatter onto ``t``'s shards, or an all-reduce where ``t`` is
    replicated).  A plain tensor passes through."""
    if not isinstance(t, DTensor):
        return t
    env = _env_with_ranks()
    full = t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)
    return full.to_local(grad_placements=env.grad_placements())


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
    return DTensor.from_local(x.contiguous(), env.mesh, pl,
                              run_check=False).full_tensor()


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
    return total / env.axes_size(env.split)


# --------------------------------------------------------------------------
# cache spans
# --------------------------------------------------------------------------

def rows_placements(mesh_names, pls) -> list:
    """Placements ``pls`` with only the DP axes' kept: the layout of this
    rank's rows, whole along every other dimension."""
    dp = entry_axes(_env_with_ranks().resolve("dp"))
    return [pl if name in dp else Replicate()
            for name, pl in zip(mesh_names, pls)]


def _rows_placements(t: DTensor) -> list:
    return rows_placements(t.device_mesh.mesh_dim_names, t.placements)


def rows_of(t):
    """A cache leaf's rows of this rank, whole along the other dimensions
    (gathered over the axes that split them); a plain tensor itself."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, _rows_placements(t)).to_local()


def store_rows(t, rows):
    """Write this rank's span of ``rows`` (as ``rows_of`` gives them) into
    the cache leaf ``t`` IN PLACE; nothing to do where ``rows`` is the
    leaf's own storage."""
    local = t.to_local() if isinstance(t, DTensor) else t
    if local.data_ptr() == rows.data_ptr() and local.shape == rows.shape:
        return
    if not isinstance(t, DTensor):
        t.copy_(rows)
        return
    span = DTensor.from_local(rows, t.device_mesh, _rows_placements(t),
                              run_check=False)
    local.copy_(span.redistribute(t.device_mesh, t.placements).to_local())


def span_start(t: DTensor, dim: int, axis: str) -> int:
    """The global index of the first element of ``t``'s local span along
    ``dim``, which is split over mesh axis ``axis`` alone."""
    return t.device_mesh.get_local_rank(axis) * t.to_local().shape[dim]


def all_reduce(x, op, axis: str):
    """In-place all-reduce of ``x`` over the ranks along mesh ``axis``."""
    env = _env_with_ranks()
    dist.all_reduce(x, op=op, group=env.mesh.get_group(axis))
    return x
