"""Cycles per warp-level tensor-core instruction (``mma.sync``) on the card
(``tools/mma_rate.cu``), with 4, 8 and 16 warps per SM: prints one JSON
line with the median over the card's SMs of the cycles an SM takes per
instruction.  At the published dense rates (989 TFLOP/s bfloat16, 495
TF32, over 132 SMs at 1.83 GHz) an SM does one bfloat16 m16n8k16 or one
tf32 m16n8k8 a cycle.  The flash and kNN kernels' float32 path issues three
tf32 products for each float32 one (3xTF32).

Run on a machine with one CUDA card and nvcc:  python3 tools/mma_rate.py
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import _build  # noqa: E402

MODES = {0: ("bf16 m16n8k16", 1), 1: ("tf32 m16n8k8", 1),
         2: ("3xTF32: three tf32 m16n8k8 on one accumulator", 3)}


def main() -> int:
    with tempfile.TemporaryDirectory(prefix="mma-rate-") as tmp:
        so = Path(tmp) / "libmma_rate.so"
        subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS,
                        *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o", str(so),
                        str(Path(__file__).with_name("mma_rate.cu"))],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
    lib.mma_rate.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2
                             + [ctypes.c_int] * 3)
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.zeros(sms * 512, device=dev)
    cycles = torch.zeros(sms, dtype=torch.int64, device=dev)
    rows = []
    iters = 4096
    for mode, (name, per_product) in MODES.items():
        for warps in (4, 8, 16):
            for _ in range(2):         # the second run is read
                rc = lib.mma_rate(mode, out.data_ptr(), cycles.data_ptr(),
                                  iters, sms, 32 * warps)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            n = iters * 8 * warps * per_product
            rows.append({"mma": name, "warps_per_sm": warps,
                         "cycles_per_mma_per_sm":
                             statistics.median(cycles.tolist()) / n})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(json.dumps({"card": smi.stdout.strip(), "sms": sms,
                      "rates": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
