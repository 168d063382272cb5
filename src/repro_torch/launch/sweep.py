"""Dry-run sweep: one subprocess per (arch x shape x mesh) cell.

The port of ``repro.launch.sweep``.  Each cell runs in a fresh process
(``python -m repro_torch.launch.dryrun``): it opens its own process group
of 256 or 512 fake ranks and measures its own peak memory, and a
subprocess makes the sweep resumable: existing records are skipped.
Failures are recorded to <cell>.err and the sweep continues.  The cells
run on the card; ``--timeout`` bounds each one's seconds.

Usage: python -m repro_torch.launch.sweep [--mesh pod|multipod|both]
           [--force] [--arch A ...] [--shape S ...]
           [--outdir artifacts/torch/dryrun] [--timeout 3000]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from repro_torch.configs import ARCHS, SHAPES, shape_applicable

# ascending size: fail fast on the cheap ones
ORDER = ["mamba2-370m", "seamless-m4t-medium", "internlm2-1.8b",
         "codeqwen1.5-7b", "glm4-9b", "zamba2-7b", "deepseek-v2-lite-16b",
         "internvl2-26b", "qwen2-72b", "grok-1-314b"]
# the package's root: the subprocess imports it from here
SRC = str(Path(__file__).resolve().parents[2])
OUTDIR = os.path.join(os.path.dirname(SRC), "artifacts", "torch", "dryrun")


def cell_path(outdir, arch, shape, mesh):
    return os.path.join(outdir, f"{arch}.{shape}.{mesh}.json")


def run_cell(arch, shape, mesh, outdir, timeout=3000):
    out = cell_path(outdir, arch, shape, mesh)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out", out]
    if mesh == "multipod":
        cmd.append("--multi-pod")
    env = dict(os.environ, PYTHONPATH=SRC)
    t0 = time.time()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout, env=env)
        ok = p.returncode == 0
        tail = (p.stdout + p.stderr)[-4000:]
    except subprocess.TimeoutExpired:
        ok, tail = False, f"TIMEOUT after {timeout}s"
    dt = time.time() - t0
    if not ok:
        with open(out.replace(".json", ".err"), "w") as f:
            f.write(tail)
    return ok, dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--outdir", default=OUTDIR)
    ap.add_argument("--arch", nargs="*", default=None)
    ap.add_argument("--shape", nargs="*", default=None)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--timeout", type=int, default=3000)
    args = ap.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)

    archs = args.arch or [a for a in ORDER if a in ARCHS]
    shapes = args.shape or [s.name for s in SHAPES]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    total = ok_n = skip_n = 0
    for mesh in meshes:
        for arch in archs:
            for shape in shapes:
                cfg = ARCHS[arch]
                sh = next(s for s in SHAPES if s.name == shape)
                applicable, why = shape_applicable(cfg, sh)
                out = cell_path(args.outdir, arch, shape, mesh)
                if not applicable:
                    with open(out, "w") as f:
                        json.dump({"arch": arch, "shape": shape, "mesh": mesh,
                                   "applicable": False, "skip_reason": why},
                                  f, indent=1)
                    print(f"SKIP {arch} x {shape} x {mesh}: {why}",
                          flush=True)
                    skip_n += 1
                    continue
                if os.path.exists(out) and not args.force:
                    try:
                        with open(out) as f:
                            rec = json.load(f)
                        if "memory" in rec:
                            print(f"HAVE {arch} x {shape} x {mesh}",
                                  flush=True)
                            continue
                    except (OSError, ValueError):
                        pass
                total += 1
                ok, dt = run_cell(arch, shape, mesh, args.outdir,
                                  timeout=args.timeout)
                ok_n += ok
                print(f"{'OK  ' if ok else 'FAIL'} {arch} x {shape} x {mesh} "
                      f"({dt:.0f}s)", flush=True)
    print(f"\nsweep done: {ok_n}/{total} ran ok, {skip_n} skipped by design",
          flush=True)


if __name__ == "__main__":
    main()
