"""Device milliseconds of the bfloat16 flash-attention kernel that
``variant`` names, at the paths' shapes, for comparing two trees on one
card: the package imported is the first ``repro_torch`` on ``sys.path``,
so

    PYTHONPATH=<tree>/src python3 tools/flash_time.py --tag <name>

times ``<tree>``'s kernels (it needs only ``flash_attention_cuda``, which
every tree since the port's first flash kernel has).  Run it for the two
trees in turns (parent, change, change, parent) in one call on one card.
Each shape's time is CUDA events around 50 back-to-back calls after 5
warm-up calls, the card held asleep while the host queues them (as
``chip_smoke.time_ms``).  Prints one JSON line: the tag, the card's
``nvidia-smi`` name and power limit, and ms by shape.

``--splits`` times instead the split over keys at the two ranks' shapes
(the grids under a wave): unsplit, and each count of key tiles a chunk
from the most a q-tile reads down to the least ``MAX_CHUNKS`` allows, the
plan forced in place of ``split_plan``'s; ``SPLIT_MIN_KEYS`` is read from
where a split stops paying.

Run on a machine with one CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels.flash_attention import flash_attention_cuda

# (B, Sq, Sk, H, KV, d, causal[, v width]): internlm2's prefill (16 heads
# over 8 of 128), grok-1's group of 6, seamless's non-causal encoder at d
# 64 and codeqwen's rank of 2 heads of 4096 rows: "tc" at d 64 and 128 with
# grids of a wave or more; then one rank's heads of internlm2 (4 over 2)
# and of zamba2 (8 of 112), grids under a wave; then internvl2's group of 6
# at 2304 rows, zamba2's 32 heads of 112 and deepseek's MLA (q/k 192, v 128)
SHAPES = [(1, 2048, 2048, 16, 8, 128, True), (1, 2048, 2048, 48, 8, 128, True),
          (1, 4096, 4096, 16, 16, 64, False),
          (16, 4096, 4096, 2, 2, 128, True),
          (1, 2048, 2048, 4, 2, 128, True), (1, 2048, 2048, 8, 8, 112, True),
          (1, 2304, 2304, 48, 8, 128, True),
          (1, 2048, 2048, 32, 32, 112, True),
          (1, 2048, 2048, 16, 16, 192, True, 128)]
# the two ranks' shapes, which split over keys
SPLIT_SHAPES = [SHAPES[4], SHAPES[5]]
# cycles the card sleeps before the timed calls: about 10 ms, longer than
# the host takes to queue 50 calls of ~0.15 ms
SLEEP_CYCLES = 20_000_000


def time_ms(fn, n: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _inputs(shape, gen, dev):
    b, sq, sk, h, kv, d, causal, *dv = shape
    dv = dv[0] if dv else d
    q = torch.randn((b, sq, h, d), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, sk, kv, d), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, sk, kv, dv), generator=gen, device=dev).bfloat16()
    return q, k, v, causal


def time_splits(gen, dev) -> dict:
    """ms of each forced split plan at SPLIT_SHAPES: "unsplit" and
    "<chunks>x<tiles a chunk>", beside the plan ``split_plan`` makes."""
    out = {}
    real = tflash.split_plan
    sms = tflash._sm_count(dev)
    try:
        for shape in SPLIT_SHAPES:
            q, k, v, causal = _inputs(shape, gen, dev)
            b, sq, sk, h, _, d, _, *dv = shape
            bk = tflash.tc_key_tile(d, dv[0] if dv else d)
            most = tflash._row_tiles((-(-sq // tflash.TC_ROWS) - 1)
                                     * tflash.TC_ROWS, sq, sk, bk, causal)
            plans = {"unsplit": (1, most)}
            for tpc in range(most - 1, -(-most // tflash.MAX_CHUNKS) - 1,
                             -1):
                plans[f"{-(-most // tpc)}x{tpc}"] = (-(-most // tpc), tpc)
            row = {"key_tile": bk, "most_tiles": most,
                   "plan": list(real(b, h, sq, sk, causal, sms, bk))}
            for name, plan in plans.items():
                tflash.split_plan = lambda *a, p=plan, **kw: p
                row[name] = time_ms(
                    lambda: flash_attention_cuda(q, k, v, causal=causal))
            out[str(shape)] = row
    finally:
        tflash.split_plan = real
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", required=True)
    ap.add_argument("--splits", action="store_true",
                    help="time forced split plans at the ranks' shapes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_time: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.splits:
        out = time_splits(gen, dev)
    else:
        out = {}
        for shape in SHAPES:
            q, k, v, causal = _inputs(shape, gen, dev)
            out[str(shape)] = time_ms(
                lambda: flash_attention_cuda(q, k, v, causal=causal))
    print(json.dumps({"tag": args.tag, "card": card, "ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
