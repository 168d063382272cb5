"""Perf hillclimbing: BigDAWG's training phase applied to tensor
plans.

The port of ``repro.launch.hillclimb``.  For one (arch x shape) cell it
evaluates a list of plan variants (each a dry-run subprocess on the card,
``launch.dryrun``), records their roofline terms in the tensor-plan
monitor DB, prints the comparison and the production pick.

Usage:
  python -m repro_torch.launch.hillclimb --arch qwen2-72b --shape train_4k \\
      --variant baseline --variant accum16:accum=16 \\
      --variant nosp:sp_boundary=false
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from repro_torch.configs import SHAPES_BY_NAME, get_arch
from repro_torch.core.monitor import Monitor
from repro_torch.core.tensorplan import cell_signature
from repro_torch.launch.sweep import SRC

OUTDIR = os.path.join(os.path.dirname(SRC), "artifacts", "torch",
                      "hillclimb")
DBPATH = os.path.join(OUTDIR, "tensorplan_monitor.json")


def run_variant(arch, shape, name, overrides, timeout=3000):
    out = os.path.join(OUTDIR, f"{arch}.{shape}.{name}.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--plan-name", name, "--out", out]
    if overrides:
        cmd += ["--set"] + overrides
    env = dict(os.environ, PYTHONPATH=SRC)
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                       env=env)
    if p.returncode != 0:
        return None, (p.stdout + p.stderr)[-1500:]
    with open(out) as f:
        return json.load(f), None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", action="append", default=[],
                    help="name[:k=v,k=v...]")
    args = ap.parse_args(argv)
    os.makedirs(OUTDIR, exist_ok=True)
    monitor = Monitor(DBPATH)
    sig = cell_signature(get_arch(args.arch), SHAPES_BY_NAME[args.shape],
                         "pod_16x16")

    print(f"{'variant':18s} {'t_comp':>8s} {'t_mem':>8s} {'t_coll':>8s} "
          f"{'dominant':>10s} {'domval':>8s} {'rooffrac':>8s} {'hbm':>7s} "
          f"{'fits':>5s}")
    for v in args.variant:
        if ":" in v:
            name, ov = v.split(":", 1)
            overrides = ov.split(",")
        else:
            name, overrides = v, []
        rec, err = run_variant(args.arch, args.shape, name, overrides)
        if rec is None or "roofline" not in rec:
            print(f"{name:18s} FAILED: {(err or 'no roofline')[:90]}")
            continue
        rf = rec["roofline"]
        dom = max(rf["t_compute"], rf["t_memory"], rf["t_collective"])
        hbm = rec["hbm_bytes_per_device"]
        monitor.record(sig, name, dom, extra={
            "t_compute": rf["t_compute"], "t_memory": rf["t_memory"],
            "t_collective": rf["t_collective"],
            "roofline_fraction": rf["roofline_fraction"],
            "hbm_gb": None if hbm is None else hbm / 1e9,
            "fits": rec["fits"]})
        print(f"{name:18s} {rf['t_compute']:8.3f} {rf['t_memory']:8.3f} "
              f"{rf['t_collective']:8.3f} {rf['dominant']:>10s} {dom:8.3f} "
              f"{rf['roofline_fraction']:8.4f} "
              f"{'n/a' if hbm is None else f'{hbm / 1e9:6.1f}G':>7s} "
              f"{str(rec['fits']):>5s}")
    monitor.save()
    key, stats, _ = monitor.best(sig)
    if key is None:
        print(f"\nproduction pick for {sig}: none (no variant ran)")
        return
    print(f"\nproduction pick for {sig}: {key} "
          f"(dominant {stats.mean_seconds:.3f}s)")


if __name__ == "__main__":
    main()
