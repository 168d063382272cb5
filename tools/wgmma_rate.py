"""Cycles per wgmma on the card for the SSD tensor-core kernel's shapes
(``tools/wgmma_rate.cu``), with one and two warpgroups per SM: prints one
JSON line with the median over the card's SMs of the cycles a warpgroup
takes per wgmma and the cycles an SM takes per wgmma.  At the published
TF32 rate (495 TFLOP/s over 132 SMs at 1.83 GHz: about 1024 multiply-adds
a cycle an SM) an m64n64k8 takes 32 cycles of an SM.

Run on a machine with one CUDA card and nvcc:  python3 tools/wgmma_rate.py
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

MODES = {0: ("tf32 m64n64k8, A in registers", 12),
         1: ("tf32 m64n128k8, A in registers", 12),
         2: ("tf32 m64n64k8, A in shared memory", 12),
         3: ("bf16 m64n64k16, A in shared memory", 12),
         4: ("tf32 m64n64k8, A in registers, groups of 48", 48)}


def main() -> int:
    with tempfile.TemporaryDirectory(prefix="wgmma-rate-") as tmp:
        so = Path(tmp) / "libwgmma_rate.so"
        subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS,
                        *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o", str(so),
                        str(Path(__file__).with_name("wgmma_rate.cu"))],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
    lib.wgmma_rate.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2
                               + [ctypes.c_int] * 3)
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.zeros(sms * 256, device=dev)
    cycles = torch.zeros(sms, dtype=torch.int64, device=dev)
    rows = []
    for mode, (name, group) in MODES.items():
        for wgs in (1, 2):
            iters = 2400 // group
            for _ in range(2):         # the second run is read
                rc = lib.wgmma_rate(mode, out.data_ptr(), cycles.data_ptr(),
                                    iters, sms, 128 * wgs)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            per_wg = statistics.median(cycles.tolist()) / (iters * group)
            rows.append({"wgmma": name, "warpgroups_per_sm": wgs,
                         "cycles_per_wgmma_per_warpgroup": per_wg,
                         "cycles_per_wgmma_per_sm": per_wg / wgs})
    print(json.dumps({"card": torch.cuda.get_device_name(0), "sms": sms,
                      "rates": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
