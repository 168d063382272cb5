"""Where the host time of a decode step goes on a 1-rank mesh: internlm2-1.8b
at full width and depth (bf16, seeded init), 8 slots of a 4096-row cache,
one decode step at the cache's end traced under ``torch.profiler`` with
CPU and CUDA activity, three ways in one process: unsharded, and on a
(1, 1) ("data", "model") mesh over a 1-rank NCCL group (a ``FileStore``
in a temporary directory) with context-parallel decode and with the naive
route.  Prints one JSON line per way: host wall ms (median of 5 calls,
each ending in a synchronize), the device's busy ms, the operators that
took the most host time themselves (``self_cpu_time_total``, ms a step)
with their call counts, and on the mesh the step's weight gathers
(``DTensor.redistribute`` calls, ``partition.weight_gathers``) and
tensor-parallel collectives (``partition.tp_collectives``), both none
where every axis has one rank; the card's name and power limit.

Run from the repository root on a machine with one CUDA card:
    python3 tools/sharded_decode_profile.py [--top N]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import PlanConfig, ShapeConfig, get_arch  # noqa: E402
from repro_torch.launch.mesh import make_mesh_compat  # noqa: E402
from repro_torch.models import api, partition  # noqa: E402
from repro_torch.models.partition import plan_scope  # noqa: E402

SLOTS, MAX_LEN = 8, 4096


def _profile(fn, dev, top: int) -> dict:
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize(dev)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {"wall_ms_median": statistics.median(walls), "wall_ms": walls,
            "device_busy_ms": busy / 1e3,
            "host_self_ms": [[e.key, e.self_cpu_time_total / 1e3, e.count]
                             for e in ops[:top]]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sharded_decode_profile: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = get_arch("internlm2-1.8b")
    plan = PlanConfig(decode_cp=True)
    shape = ShapeConfig("serve", "decode", MAX_LEN, SLOTS)
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             plan, dev)
    toks = torch.zeros((SLOTS,), dtype=torch.int32, device=dev)
    pos = torch.full((SLOTS,), MAX_LEN - 2, dtype=torch.int32, device=dev)
    decode = api.make_decode_step(cfg, shape, plan)
    cache = api.init_cache(cfg, SLOTS, MAX_LEN, torch.bfloat16, dev)
    out = {"unsharded": _profile(lambda: decode(params, cache, toks, pos),
                                 dev, args.top)}
    del cache
    with tempfile.TemporaryDirectory(prefix="decode-profile-") as d:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(d, "store"), 1), rank=0, world_size=1)
        try:
            mesh = make_mesh_compat((1, 1), ("data", "model"))
            for way, cp in (("cp", True), ("naive", False)):
                p2 = plan.with_(decode_cp=cp)
                step = api.make_decode_step(cfg, shape, p2)
                with plan_scope(mesh, p2):
                    placed = api.distribute(params, api.to_shardings(
                        mesh, api.param_specs(cfg, p2, params)))
                    cache = api.init_cache(cfg, SLOTS, MAX_LEN,
                                           torch.bfloat16, dev)
                    partition.reset_weight_gathers()
                    partition.reset_tp_collectives()
                    step(placed, cache, toks, pos)
                    counts = {"weight_gathers": partition.weight_gathers(),
                              "tp_collectives":
                                  partition.tp_collectives()}
                    out[way] = {**_profile(
                        lambda: step(placed, cache, toks, pos), dev,
                        args.top), **counts}
                del placed, cache
        finally:
            dist.destroy_process_group()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    for way, row in out.items():
        print(json.dumps({"way": way, "card": card, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
