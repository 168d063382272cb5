"""The readings that a cell's limits of ``correct`` are set from: the
program's on many seeds and, on the first few, the control's (the plain
reference computed in float8 in the program's place) and, in a training
cell, the half-batch fault's (the reference on half of each batch), all
in one process on the card.

    python3 bench/tools/readings.py --workload <cell> --seeds 11,12,13 \
        --seconds 30 --control 3 --out readings/<cell>.json

Each seed is a whole run of the cell (its set-up, a window of
``--seconds``, its check); the file is written again after every seed.
The benchmark's own runs never run the control.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "bench")]

import torch  # noqa: E402

from harness.cell import run_cell  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=3,
                    help="how many of the first seeds also read the control")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("readings: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    rows = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result, rec = run_cell(ROOT, args.workload, seed, args.seconds,
                               False, device, t0,
                               control=i < args.control)
        row = {"seed": seed, "readings": rec["readings"],
               "control": rec.get("control"),
               "fault_half_batch": rec.get("fault_half_batch"),
               "checked": rec.get("checked"), "metrics": result["metrics"],
               "gaps": rec.get("gaps"), "control_gaps": rec.get("control_gaps"),
               "memory_peak_bytes": rec["memory_peak_bytes"],
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items()
                          if not k.endswith("gaps")}), flush=True)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
        del result, rec
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    names = rows[0]["readings"].keys()
    for n in names:
        prog = [r["readings"][n] for r in rows]
        ctrl = [r["control"][n] for r in rows if r["control"]]
        fault = [r["fault_half_batch"][n] for r in rows
                 if r["fault_half_batch"]]
        print(f"readings: {n} program max {max(prog)!r} over {len(prog)} "
              f"seeds; control min {min(ctrl, default=None)!r} over "
              f"{len(ctrl)}; half-batch fault min "
              f"{min(fault, default=None)!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
