"""One run of one cell: its driver, its metrics, its check, its result."""
from __future__ import annotations

import importlib
from pathlib import Path
from types import SimpleNamespace

import torch

from harness import check, spec
from harness.peaks import PEAKS

DRIVERS = {"train": "harness.train", "serve": "harness.serve"}


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float,
             bench_dir: Path = spec.BENCH, control: bool = False) -> tuple:
    """(the result line's object, the driver's records).  ``t_start`` is
    the process's start on ``time.perf_counter``'s clock."""
    cell = spec.load_cell(root, workload, bench_dir)
    driver = importlib.import_module(DRIVERS[cell.traffic["kind"]])
    rec = driver.run(cell, seed, seconds, trace, device, control=control)
    rec["e2e"]["setup_s"] = rec["t0"] - t_start
    if trace:
        run = SimpleNamespace(cfg=cell.config, traffic=cell.traffic,
                              peaks=PEAKS, **rec)
        values = {m["name"]: spec.metric_reader(m["name"], bench_dir)(run)
                  for m in cell.per_layer}
        chosen = cell.per_layer
    else:
        values, chosen = rec["e2e"], cell.end_to_end
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in chosen if values.get(m["name"]) is not None}
    correct, compared = check.judge(rec["readings"], cell.limits)
    dev = torch.device(device)
    result = {"correct": correct, "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else
                         dev.type,
                         "kind": torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else dev.type,
                         "count": cell.chips,
                         "memory_peak_bytes": rec["memory_peak_bytes"]}}
    traced = rec.get("traced")
    if traced is not None:
        result["device"].update(busy_s=traced.busy_s(),
                                window_s=traced.window_s)
        result["breakdown"] = traced.breakdown()
    result["compared"] = compared
    return result, rec
