"""Dry run of the port: prove that an (architecture x input-shape x mesh)
cell fits one rank of the production mesh, and expose its roofline terms.

The port of ``repro.launch.dryrun``.  The reference compiles each cell for
256 or 512 placeholder host devices and reads XLA's analyses.  The port
has a card instead, so its fit proof is one rank's real step, measured.
Per cell:

  mesh        a fake process group of 256 ranks (512 with ``--multi-pod``)
              under the production mesh (``launch.mesh``); rank 0 stands
              for every rank.  Its collectives move nothing and leave their
              outputs as allocated, so the step's values are not the
              model's: its shapes, memory, launches and work are.  No shape
              in a step depends on a value (MoE dispatch is bounded by its
              capacity).
  state       placed from local shapes: the shapes come from ``meta``
              (``init_params``, the optimizer's ``init``, ``example_batch``,
              ``example_cache``), and each leaf is a ``DTensor`` made with
              ``DTensor.from_local`` from a zero-filled tensor of its shard's
              shape under ``param_specs`` / ``train_state_specs`` /
              ``cache_specs``, so no rank ever holds a whole tree.  A batch
              leaf is a zero-strided view of its global shape, of which the
              rank reads only its rows (``batch_specs``).
  fit         the peak memory statistics are reset before the state is
              placed, then one full-depth step of the real program runs:
              ``make_train_step`` with the plan's accumulation (a train
              cell), ``make_prefill``, or ``make_serve_step`` on the cache.
              ``state_bytes`` is exact, from the local shapes (the
              reference's ``arg_bytes``: the state, the rank's rows of the
              batch and the cache); ``peak_allocated_bytes`` and
              ``peak_reserved_bytes`` are the allocator's peaks over the
              placement and the step, less what the process held before
              (``baseline_*``), so they are the step's whole footprint, the
              state's copy that the step returns included (the port's
              update returns a new state; nothing is donated);
              ``hbm_bytes_per_device`` is the allocated peak, and ``fits``
              holds the reserved peak, the baseline included, to
              ``FIT_MARGIN`` of the card's memory.  On the CPU the step runs
              the same way, and the peaks, the capacity and ``fits`` are
              None.  A step that runs out of the card's memory does not
              fit: the record keeps the allocator's message (``oom``) and
              the peaks it reached, and goes on to the costs.
              ``placed_bytes`` is what the placed shards hold, read back.
  cost        the counts of a full-depth step cost too much host time, so,
              as the reference does, the steps of ``_probe_cfg`` depths 1
              and 2 are counted and ``_combine`` extrapolates linearly to
              ``scan_depth``.  A training cell's probes are one microbatch's
              gradient (the step at accumulation 1 less its optimizer
              update, counted alone on the same state), scaled by the
              accumulation, plus the update, extrapolated in depth too
              (the reference compiles it at full size: it is elementwise
              over the parameters, so linear in depth).  Operations and
              bytes are counted by ``kernels.work.count`` (aten ops by
              dispatch; the hand kernels, and on the CPU their plain
              versions, credited from their shapes), so the counts are the
              same on either device.
  collectives the bytes that ``models.partition`` tallies where it issues
              them (``collective_bytes``), an all-reduce twice (a ring), by
              kind.
  roofline    against the H100 SXM's published peaks at 700 W (NVIDIA's
              data sheet): 989 TFLOP/s bf16, 3.35 TB/s HBM, NVLink 450 GB/s
              a direction; the card's name and power limit go into the
              record.  Its keys are the reference's, so
              ``launch.hillclimb`` reads it unchanged.

``NO_COUNTERPART`` lists the reference record's keys that only XLA has:
its HLO's size, the compile time, the memory analysis' argument, output,
temporary and aliased bytes (their counterparts are ``state_bytes`` and
the measured peaks), ``fits_16g`` (a TPU's memory; ``fits`` holds the
card's), and the cost analysis of the scanned full-depth program.
``parse_collective_bytes`` has none either: the collectives are tallied
where they are issued.  ``PlanConfig.unroll_inner`` / ``unroll_layers``
are no-ops in the eager port (its loops are Python's), so the probes set
them only as the reference does.  Importing this module sets no
environment variable and touches neither CUDA nor a process group.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k \\
      [--multi-pod] [--plan-name baseline] [--set accum=4 sp_boundary=false]
      [--out artifacts/torch/dryrun/...json] [--skip-cost] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from contextlib import contextmanager

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs import (ARCHS, SHAPES_BY_NAME, ArchConfig,
                                 PlanConfig, ShapeConfig, get_arch,
                                 shape_applicable)
from repro_torch.core.tables import resolve_device
from repro_torch.core.tensorplan import default_plan
from repro_torch.kernels import counters, ops, work
from repro_torch.launch.mesh import make_mesh_compat, make_production_mesh
from repro_torch.models import api, partition
from repro_torch.models.partition import plan_scope
from repro_torch.optim import AdamW
from repro_torch.optim.compression import int8_ef_compress
from repro_torch.tree import tree_leaves, tree_map

# H100 SXM, NVIDIA's data sheet, at 700 W (roofline)
PEAK_FLOPS = 989e12          # dense bf16 / card
HBM_BW = 3.35e12             # B/s / card
LINK_BW = 450e9              # NVLink, B/s a direction / card
FIT_MARGIN = 0.9             # of the card's memory that a reserved peak may take

NO_COUNTERPART = ("fits_16g", "memory.arg_bytes", "memory.out_bytes",
                  "memory.temp_bytes", "memory.alias_bytes",
                  "memory.hlo_chars", "memory.compile_s", "memory.flops",
                  "memory.bytes", "probes.*.arg_bytes",
                  "probes.*.out_bytes", "probes.*.temp_bytes",
                  "probes.*.alias_bytes", "probes.*.hlo_chars",
                  "probes.*.compile_s")
COST_KEYS = ("flops", "bytes", "coll_bytes")


def _probe_cfg(cfg, depth_units: int):
    """Reduced-depth config with ``depth_units`` layer-stack iterations."""
    if cfg.family == "hybrid":
        nl = cfg.attn_period * depth_units + \
            (cfg.num_layers % cfg.attn_period)
        return dataclasses.replace(cfg, num_layers=nl)
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, num_layers=depth_units,
                                   encoder_layers=depth_units)
    prefix = cfg.moe.first_dense_layers if cfg.moe else 0
    return dataclasses.replace(cfg, num_layers=prefix + depth_units)


def scan_depth(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_period
    prefix = cfg.moe.first_dense_layers if cfg.moe else 0
    return cfg.num_layers - prefix


def mesh_kind(multi_pod: bool, mesh_shape=None) -> str:
    if mesh_shape is not None:
        return "mesh_" + "x".join(str(n) for n in mesh_shape)
    return "multipod_2x16x16" if multi_pod else "pod_16x16"


# -- the rank --------------------------------------------------------------

@contextmanager
def _rank_zero(world: int):
    """Rank 0 of a fake process group of ``world`` ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a dry run opens its own process group; one is "
                           "already open")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(multi_pod: bool, mesh_shape, device_type: str):
    if mesh_shape is None:
        return make_production_mesh(multi_pod=multi_pod,
                                    device_type=device_type)
    axes = ("data", "model") if len(mesh_shape) == 2 \
        else ("pod", "data", "model")
    return make_mesh_compat(mesh_shape, axes, device_type)


def local_shape(shape, placements, mesh_sizes) -> tuple:
    """The shard of a leaf of ``shape`` that a rank holds under
    ``placements`` (the specs' divisibility guard makes every split
    even)."""
    out = list(shape)
    for pl, n in zip(placements, mesh_sizes):
        if isinstance(pl, Shard):
            if out[pl.dim] % n:
                raise ValueError(f"dimension {pl.dim} of {tuple(shape)} "
                                 f"does not split {n} ways")
            out[pl.dim] //= n
    return tuple(out)


def place(tree, shardings, device):
    """``tree``'s shapes (``meta`` tensors) as zero ``DTensor``s placed by
    ``shardings``, each rank allocating only its shard."""
    def one(t, sh):
        shp = local_shape(t.shape, sh.placements, sh.mesh.shape)
        local = torch.zeros(shp, dtype=t.dtype, device=device)
        return DTensor.from_local(local, sh.mesh, sh.placements,
                                  run_check=False, shape=t.shape,
                                  stride=_contiguous_stride(t.shape))
    return tree_map(one, tree, shardings)


def _contiguous_stride(shape) -> tuple:
    stride, out = 1, []
    for n in reversed(tuple(shape)):
        out.append(stride)
        stride *= n
    return tuple(reversed(out))


def local_bytes(tree, shardings) -> int:
    """The bytes of ``tree``'s shards on one rank (``meta`` shapes and
    their shardings: nothing is allocated)."""
    return sum(math.prod(local_shape(t.shape, sh.placements, sh.mesh.shape))
               * t.element_size()
               for t, sh in zip(tree_leaves(tree), tree_leaves(shardings)))


def _batch(batch_meta, device):
    """A batch of zeros as zero-strided views of the global shapes."""
    return {k: torch.zeros((1,) * t.ndim, dtype=t.dtype,
                           device=device).expand(t.shape)
            for k, t in batch_meta.items()}


def _optimizer(plan) -> AdamW:
    return AdamW(learning_rate=1e-4, moment_dtype=plan.moment_dtype)


def _state_meta(cfg, plan) -> dict:
    """The train state's shapes on ``meta`` (``init_train_state``'s)."""
    return api.init_train_state(cfg, plan, None, _optimizer(plan), "meta")


def layout(cfg, shape, plan, mesh) -> dict:
    """{part: (its shapes on ``meta``, their shardings)} of a cell's inputs
    on ``mesh`` (a ``DeviceMesh`` or an ``AbstractMesh``): "batch" and
    "state" (the train state) for a train cell, "batch" and "params" (and
    "cache" to decode) for a serving one."""
    batch = api.example_batch(cfg, shape, plan)
    with plan_scope(mesh, plan):
        out = {"batch": (batch, api.to_shardings(
            mesh, api.batch_specs(cfg, plan, batch)))}
        if shape.mode == "train":
            meta = _state_meta(cfg, plan)
            out["state"] = (meta, api.to_shardings(
                mesh, api.train_state_specs(cfg, plan, meta)))
        else:
            meta = api.init_params(cfg, None, plan, "meta")
            out["params"] = (meta, api.to_shardings(
                mesh, api.param_specs(cfg, plan, meta)))
            if shape.mode == "decode":
                cmeta = api.example_cache(cfg, shape, plan)
                out["cache"] = (cmeta, api.to_shardings(
                    mesh, api.cache_specs(cfg, plan, cmeta)))
    return out


def state_bytes(cfg, shape, plan, mesh) -> tuple:
    """(bytes, {part: bytes}) of a cell's inputs on one rank, from the
    shapes and the specs alone: nothing is allocated."""
    parts = {k: local_bytes(*v) for k, v in layout(cfg, shape, plan,
                                                    mesh).items()}
    return sum(parts.values()), parts


class _Cell:
    """One cell's program on the rank: its inputs placed, its step."""

    def __init__(self, cfg, shape, plan, mesh, device):
        self.cfg, self.shape, self.plan = cfg, shape, plan
        self.mesh, self.device = mesh, device
        parts = layout(cfg, shape, plan, mesh)
        self.batch = _batch(parts.pop("batch")[0], device)
        placed = {k: place(*v, device) for k, v in parts.items()}
        # what the rank holds of them, read from the placed shards
        self.placed_bytes = sum(
            t.to_local().numel() * t.to_local().element_size()
            for tree in placed.values() for t in tree_leaves(tree))
        self.state = placed.get("state")
        self.params = placed.get("params")
        self.cache = placed.get("cache")

    def step(self):
        """One step of the cell's program (its output is dropped)."""
        cfg, shape, plan = self.cfg, self.shape, self.plan
        with plan_scope(self.mesh, plan):
            if shape.mode == "train":
                api.make_train_step(cfg, plan, _optimizer(plan))(
                    self.state, self.batch)
            elif shape.mode == "prefill":
                api.make_prefill(cfg, shape, plan)(self.params, self.batch)
            else:
                api.make_serve_step(cfg, shape, plan)(
                    self.params, self.cache, self.batch["tokens"],
                    self.batch["pos"])
        _sync(self.device)

    def optimizer_tail(self, grads):
        """The train step's update alone on ``grads`` (int8 error feedback
        where the plan has it, then the optimizer; its output is
        dropped)."""
        plan, state = self.plan, self.state
        with plan_scope(self.mesh, plan):
            if plan.grad_compression == "int8_ef":
                grads, _ = int8_ef_compress(grads, state["ef"])
            _optimizer(plan).update(grads, state["opt"], state["master"])
        _sync(self.device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _snapshot() -> dict:
    return {"launches": counters.read(ops.LAUNCHES),
            "tp_collectives": partition.tp_collectives(),
            "weight_gathers": partition.weight_gathers(),
            "coll": partition.collective_bytes()[1]}


def _since(before: dict) -> dict:
    """Launches, split collectives, weight gathers and collective bytes
    since ``before`` (``_snapshot``)."""
    now = _snapshot()
    coll = {k: {f: v[f] - before["coll"].get(k, {}).get(f, 0)
                for f in ("count", "bytes")}
            for k, v in now["coll"].items()}
    coll = {k: v for k, v in coll.items() if v["count"]}
    return {"launches": {k: n - before["launches"][k]
                         for k, n in now["launches"].items()
                         if n - before["launches"][k]},
            "tp_collectives": {k: n - before["tp_collectives"][k]
                               for k, n in now["tp_collectives"].items()},
            "weight_gathers": now["weight_gathers"]
            - before["weight_gathers"],
            "coll_bytes": sum(v["bytes"] for v in coll.values()),
            "coll_breakdown": coll}


def _counted(fn) -> dict:
    """``fn()`` counted: operations, bytes and collective bytes."""
    before = _snapshot()
    t0 = time.perf_counter()
    with work.count() as tally:
        fn()
    seen = _since(before)
    return {**tally.as_dict(), "coll_bytes": seen["coll_bytes"],
            "coll_breakdown": seen["coll_breakdown"],
            "launches": seen["launches"],
            "seconds": time.perf_counter() - t0}


def _combine(base, delta, n):
    """base + n * delta for the cost keys."""
    return {k: base[k] + n * delta[k] for k in COST_KEYS}


def _minus(a, b):
    return {k: a[k] - b[k] for k in COST_KEYS}


def _probe(cfg, shape, plan, mesh, device) -> tuple:
    """(the counted step, the counted optimizer update or None) of one
    probe config."""
    cell = _Cell(cfg, shape, plan, mesh, device)
    step = _counted(cell.step)
    tail = None
    if shape.mode == "train":
        grads = tree_map(torch.zeros_like, cell.state["master"])
        tail = _counted(lambda: cell.optimizer_tail(grads))
    return step, tail


def _costs(cfg, shape, plan, mesh, device, record) -> dict:
    probe_plan = plan.with_(unroll_inner=True, unroll_layers=True)
    L = scan_depth(cfg)
    c1, c2 = _probe_cfg(cfg, 1), _probe_cfg(cfg, 2)
    if shape.mode == "train":
        A = plan.accum
        micro = dataclasses.replace(shape,
                                    global_batch=shape.global_batch // A)
        mplan = probe_plan.with_(accum=1)
        s1, o1 = _probe(c1, micro, mplan, mesh, device)
        s2, o2 = _probe(c2, micro, mplan, mesh, device)
        g1, g2 = _minus(s1, o1), _minus(s2, o2)
        opt = _combine(o1, _minus(o2, o1), L - 1)
        per_micro = _combine(g1, _minus(g2, g1), L - 1)
        cost = {k: A * per_micro[k] + opt[k] for k in COST_KEYS}
        record["probes"] = {"g1": {**s1, **g1}, "g2": {**s2, **g2},
                            "opt1": o1, "opt2": o2, "opt": opt}
    else:
        s1, _ = _probe(c1, shape, probe_plan, mesh, device)
        s2, _ = _probe(c2, shape, probe_plan, mesh, device)
        cost = _combine(s1, _minus(s2, s1), L - 1)
        record["probes"] = {"s1": s1, "s2": s2}
    return cost


def card_info(device) -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them, and
    torch's name for it; on the CPU only the device's type."""
    if device.type != "cuda":
        return {"type": device.type}
    info = {"type": "cuda", "name": torch.cuda.get_device_name(device),
            "nvidia_smi": None}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader",
                              f"--id={device.index or 0}"],
                             capture_output=True, text=True, timeout=60)
        if smi.returncode == 0:
            info["nvidia_smi"] = smi.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return info


def run_cell(arch, shape, *, multi_pod: bool, plan: PlanConfig,
             skip_cost: bool = False, device=None, mesh_shape=None) -> dict:
    """One cell's record.  ``arch`` and ``shape`` are names or config
    objects; ``mesh_shape`` replaces the production mesh ((16, 16), or
    (2, 16, 16) with ``multi_pod``) by a (data, model) or (pod, data,
    model) mesh of that shape.  ``device=None`` means the CUDA card (it
    raises without one); pass ``device="cpu"`` to run on the CPU."""
    cfg = arch if isinstance(arch, ArchConfig) else get_arch(arch)
    shape = shape if isinstance(shape, ShapeConfig) \
        else SHAPES_BY_NAME[shape]
    ok, why = shape_applicable(cfg, shape)
    record = {
        "arch": cfg.name, "shape": shape.name,
        "mesh": mesh_kind(multi_pod, mesh_shape),
        "plan": dataclasses.asdict(plan), "applicable": ok,
        "skip_reason": why,
        "params": api.count_params(cfg),
        "active_params": api.count_params(cfg, active_only=True),
    }
    if not ok:
        return record
    dev = resolve_device(device)
    sizes = tuple(mesh_shape) if mesh_shape is not None \
        else ((2, 16, 16) if multi_pod else (16, 16))
    ndev = math.prod(sizes)
    if shape.mode == "train":
        # microbatches must still split over the data-parallel axes
        dp = ndev // sizes[-1]
        max_accum = max(shape.global_batch // dp, 1)
        if plan.accum > max_accum:
            plan = plan.with_(accum=max_accum)
            record["plan"] = dataclasses.asdict(plan)
    record["device"] = card_info(dev)

    with _rank_zero(ndev):
        mesh = _mesh(multi_pod, mesh_shape, dev.type)
        # ---- the fit proof: one full-depth step on the rank -------------
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            base_alloc = torch.cuda.memory_allocated(dev)
            base_res = torch.cuda.memory_reserved(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        before = _snapshot()
        t0 = time.perf_counter()
        place_s = step_s = placed = oom = None
        try:
            cell = _Cell(cfg, shape, plan, mesh, dev)
            place_s, placed = time.perf_counter() - t0, cell.placed_bytes
            t1 = time.perf_counter()
            cell.step()
            step_s = time.perf_counter() - t1
        except torch.OutOfMemoryError as e:
            # does not fit: the record says so, as the reference's
            # compile reports a size beyond the chip's
            oom = str(e).splitlines()[0]
        cell = None
        seen = _since(before)
        mem = {"state_bytes": None, "state_parts": None,
               "placed_bytes": placed, "oom": oom,
               "peak_allocated_bytes": None, "peak_reserved_bytes": None,
               "baseline_allocated_bytes": None,
               "baseline_reserved_bytes": None,
               "coll_bytes": seen["coll_bytes"],
               "coll_breakdown": seen["coll_breakdown"],
               "place_s": place_s, "step_s": step_s,
               "includes": "the placed state, the batch's rows (and the "
                           "cache) and one full-depth step, the state it "
                           "returns included"}
        record["step"] = {k: seen[k] for k in ("launches", "tp_collectives",
                                               "weight_gathers")}
        capacity = None
        if dev.type == "cuda":
            peak_alloc = torch.cuda.max_memory_allocated(dev)
            peak_res = torch.cuda.max_memory_reserved(dev)
            capacity = torch.cuda.get_device_properties(dev).total_memory
            mem.update(peak_allocated_bytes=peak_alloc - base_alloc,
                       peak_reserved_bytes=peak_res - base_res,
                       baseline_allocated_bytes=base_alloc,
                       baseline_reserved_bytes=base_res)
            gc.collect()            # an interrupted step's cycles
            torch.cuda.empty_cache()
        total, parts = state_bytes(cfg, shape, plan, mesh)
        mem.update(state_bytes=total, state_parts=parts)
        record["memory"] = mem
        record["state_bytes"] = total
        record["hbm_bytes_per_device"] = mem["peak_allocated_bytes"]
        record["hbm_capacity_bytes"] = capacity
        record["fits"] = None if capacity is None else bool(
            oom is None and mem["peak_reserved_bytes"]
            + mem["baseline_reserved_bytes"] <= FIT_MARGIN * capacity)

        if skip_cost or multi_pod:
            return record
        # ---- cost probes (single-pod roofline) ---------------------------
        cost = _costs(cfg, shape, plan, mesh, dev, record)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    record["cost"] = cost

    # ---- roofline terms ---------------------------------------------------
    n_act = record["active_params"]
    if shape.mode == "train":
        model_flops = 6.0 * n_act * shape.tokens
    elif shape.mode == "prefill":
        model_flops = 2.0 * n_act * shape.tokens
    else:
        model_flops = 2.0 * n_act * shape.global_batch
    mf_dev = model_flops / ndev
    t_compute = cost["flops"] / PEAK_FLOPS
    t_memory = cost["bytes"] / HBM_BW
    t_collective = cost["coll_bytes"] / LINK_BW
    dominant = max((t_compute, "compute"), (t_memory, "memory"),
                   (t_collective, "collective"))
    record["roofline"] = {
        "t_compute": t_compute, "t_memory": t_memory,
        "t_collective": t_collective,
        "dominant": dominant[1],
        "model_flops_per_device": mf_dev,
        "useful_flops_ratio": mf_dev / max(cost["flops"], 1.0),
        "roofline_fraction": (mf_dev / PEAK_FLOPS) / max(
            t_compute, t_memory, t_collective),
        "peaks": {"flops": PEAK_FLOPS, "hbm": HBM_BW, "link": LINK_BW},
    }
    return record


def _parse_overrides(pairs):
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                out[k] = v
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES_BY_NAME))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--skip-cost", action="store_true")
    ap.add_argument("--plan-name", default=None)
    ap.add_argument("--set", nargs="*", default=[],
                    help="plan overrides: accum=4 sp_boundary=false ...")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="the CUDA card unless 'cpu' is asked for")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    shape = SHAPES_BY_NAME[args.shape]
    plan = default_plan(cfg, shape)
    ov = _parse_overrides(args.set)
    if args.plan_name:
        ov["name"] = args.plan_name
    if ov:
        plan = plan.with_(**ov)

    t0 = time.time()
    rec = run_cell(args.arch, args.shape, multi_pod=args.multi_pod, plan=plan,
                   skip_cost=args.skip_cost, device=args.device)
    rec["wall_s"] = time.time() - t0

    blob = json.dumps(rec, indent=1, default=float)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(blob)
    print(blob)
    if rec.get("applicable") and "memory" in rec:
        peak = rec["hbm_bytes_per_device"]
        print(f"\nOK {args.arch} x {args.shape} x "
              f"{'multipod' if args.multi_pod else 'singlepod'}: "
              f"state={rec['state_bytes'] / 1e9:.2f} GB "
              f"peak={'n/a' if peak is None else f'{peak / 1e9:.2f} GB'} "
              f"fits={rec['fits']}", file=sys.stderr)


if __name__ == "__main__":
    main()
