"""The highest rate that a serving cell sustains: one set-up, then a window
of ``--seconds`` at each rate of an open loop with evenly spaced arrivals,
the server drained between rates.

    python3 bench/tools/sweep.py --workload <cell> --rates 2,2.5,3 \
        --seconds 40 --seed 7 --out sweep.json

A rate is sustained where the queue at the window's end holds no more
than a request or two and the admissions kept up with the arrivals.
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "bench")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import serve, spec  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(ROOT, args.workload)
    mix = dict(cell.traffic, start="warm",
               warm_requests=cell.traffic.get("warm_requests", 4))
    cell = dataclasses.replace(cell, traffic=mix)
    _, srv, loop = serve.setup(cell, args.seed, torch.device("cuda", 0))
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        loop.waiting.clear()
        while loop.live:
            srv.step()
            loop.live = {r: v for r, v in loop.live.items() if not v[0].done}
        loop.mix = dict(mix, rate=rate)
        loop.due, done0 = None, len(loop.finished)
        prefills, ttft = [], []
        t0 = time.perf_counter()
        admitted = loop.run(t0 + args.seconds, prefills, ttft)
        wall = time.perf_counter() - t0
        row = {"rate": rate, "admitted_per_s": admitted / wall,
               "completed_per_s": (len(loop.finished) - done0) / wall,
               "queued_at_end": len(loop.waiting),
               "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
               "ttft_p95_ms": float(np.percentile(ttft, 95)) * 1e3,
               "prefill_s_share": sum(s for s, _ in prefills) / wall}
        rows.append(row)
        print(json.dumps(row), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
