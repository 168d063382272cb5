"""Run one cell of the port's benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``bench/`` and
the port (``src/repro_torch``).  With ``--trace 0`` the last line of
standard output is the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, the device's busy seconds in a traced stretch after
the window and a ``breakdown`` of it; either way ``correct`` says whether
what the window produced agrees with the plain reference, and the numbers
compared, each beside its limit, are the last lines of standard error.
The run needs as many CUDA cards as the cell asks for and exits with 2,
printing no result, where there are fewer.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _caches() -> None:
    """Every build and kernel cache at a fixed place in the checkout."""
    cache = ROOT / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)


def _power_limit() -> str:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "unknown"
    try:
        out = subprocess.run([smi, "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().replace("\n", "; ") or "unknown"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    _caches()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "bench")]

    import torch
    from harness import spec
    from harness.cell import run_cell

    chips = spec.load_cell(ROOT, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: the cell needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, rec = run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), torch.device("cuda", 0), T_START)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"bench: the process loaded {loaded}, which the port must "
              f"not use", file=sys.stderr)
        return 3
    print(f"bench: card {_power_limit()}", file=sys.stderr)
    print(f"bench: set-up {rec['e2e']['setup_s']:.3f} s, window "
          f"{rec['window_s']:.3f} s, whole run "
          f"{time.perf_counter() - T_START:.3f} s; checked "
          f"{json.dumps(rec.get('checked'))}", file=sys.stderr)
    if rec.get("host") is not None:
        print(f"bench: host {json.dumps(rec['host'])}", file=sys.stderr)
    if rec.get("traced") is not None:
        print(f"bench: traced device seconds by kind "
              f"{json.dumps(rec['traced'].by_kind())}", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"bench: compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
