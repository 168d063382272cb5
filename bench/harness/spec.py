"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  The configuration's file is the one its entry of ``configs`` gives;
the traffic mix is ``traffic/<traffic>.json``; the limits of the
comparison that decides ``correct`` are ``limits/<cell>.json``; a
per-layer metric is read by ``metrics/<metric>.py``.  A later cell or
metric is added by adding files and entries: nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent


@dataclass
class Cell:
    """One cell of the benchmark, with every file it needs read in."""
    name: str
    chips: int
    config: dict            # the configuration's file
    traffic: dict           # the traffic mix's file
    limits: dict            # limits/<cell>.json
    end_to_end: list        # the metrics of BENCHMARK.json that this cell
    per_layer: list         # reports, each its entry there


def load_benchmark(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str, bench_dir: Path = BENCH) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``; a ``KeyError``
    names a cell that is not there."""
    bench = load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(there are {sorted(work)})")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((Path(root) / configs[w["config"]]["file"])
                        .read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits_file = bench_dir / "limits" / f"{name}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() \
        else {}
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


def metric_reader(name: str, bench_dir: Path = BENCH):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
