"""Where a block of the SSD tensor-core kernel spends its time, phase by
phase, on the card: builds a copy of ``kernels/csrc/ssd_scan.cu`` with
``clock64`` stamps inserted at the phase boundaries of ``ssd_intra_wgmma``
(thread 0 of each warpgroup, the first 256 blocks), runs it at a shape, and
prints one JSON line: the median cycles over blocks of each phase, per
warpgroup.

Phases: ``start`` (barrier init, TMA of B, C and the first x, B's split),
``G`` (C·Bᵀ), ``G_sync`` (waiting for the other warpgroup), then per head
``h<i>_x`` (the previous head's end barrier, xᵀ written, cumsum, barrier),
``h<i>_y`` ((G∘L)·x) and ``h<i>_states`` ((Bᵀ∘w)·x).

Run on a machine with one CUDA card and nvcc:
    python3 tools/ssd_trace.py [b Q h p g n]
(default: the mamba2 prefill path's 16 128 32 64 1 128).
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

SLOTS, BLOCKS = 64, 256
STAMPS = [  # (text the stamp goes before, stamp)
    ("  const int nt = b_tiles(n);\n  const int hg", "  TR(0);\n"),
    ("  float gacc[KW / 2];", "  TR(1);\n"),
    ("  block_sync();              // C's space becomes", "  TR(2);\n"),
    ("  float dn[4];", "  TR(3);\n"),
    ("    // the stage is free: the next head's x lands", "    TR(4 + 3 * i);\n"),
    ("    // states (n, p) = (Bᵀ∘w)·x", "    TR(5 + 3 * i);\n"),
    ("    block_sync();              // xᵀ, cs and wk", "    TR(6 + 3 * i);\n"),
]


def instrumented_source() -> str:
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    head = ('#include "hopper.cuh"\n'
            f"__device__ long long g_trace[{BLOCKS} * 2 * {SLOTS}];\n"
            "#define TR(slot) do { if ((threadIdx.x & 127) == 0 && "
            f"blockIdx.x < {BLOCKS} && (slot) < {SLOTS}) "
            f"g_trace[(blockIdx.x * 2 + (threadIdx.x >> 7)) * {SLOTS} + "
            "(slot)] = clock64(); } while (0)\n")
    if src.count('#include "hopper.cuh"\n') != 1:
        raise RuntimeError("ssd_scan.cu changed: no single hopper.cuh include")
    src = src.replace('#include "hopper.cuh"\n', head, 1)
    for anchor, stamp in STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"ssd_scan.cu changed: anchor {anchor!r}")
        src = src.replace(anchor, stamp + anchor)
    return src + ('\nextern "C" int read_trace(void* dst) {\n'
                  "  return (int)cudaMemcpyFromSymbol(dst, g_trace, "
                  "sizeof(g_trace));\n}\n")


def main(argv) -> int:
    b, q, h, p, g, n = (int(a) for a in argv) if argv else (16, 128, 32, 64,
                                                           1, 128)
    with tempfile.TemporaryDirectory(prefix="ssd-trace-") as tmp:
        cu = Path(tmp) / "ssd_trace.cu"
        cu.write_text(instrumented_source())
        so = Path(tmp) / "libssd_trace.so"
        subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS,
                        *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o", str(so),
                        str(cu)], check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
    lib.ssd_intra_launch.argtypes = ([ctypes.c_void_p] * 7
                                     + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((b, q, h, p), generator=gen, device=dev)
    da = -torch.nn.functional.softplus(
        torch.randn((b, q, h), generator=gen, device=dev))
    B = torch.randn((b, q, g, n), generator=gen, device=dev)
    C = torch.randn((b, q, g, n), generator=gen, device=dev)
    y = torch.empty_like(x)
    st = torch.empty((b, h, n, p), device=dev)
    cd = torch.empty((b, h), device=dev)
    for _ in range(3):                 # the last launch's stamps are read
        rc = lib.ssd_intra_launch(
            x.data_ptr(), da.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), st.data_ptr(), cd.data_ptr(), b, q, h, p, g, n, 1,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: code {rc}")
    torch.cuda.synchronize(dev)
    buf = (ctypes.c_longlong * (BLOCKS * 2 * SLOTS))()
    if lib.read_trace(buf):
        raise RuntimeError("reading the stamps failed")
    # heads of the first block: the launcher's heads-per-block choice
    stamped = [s for s in range(SLOTS) if buf[s]]
    heads = (max(stamped) - 3) // 3
    blocks = [blk for blk in range(BLOCKS) if buf[blk * 2 * SLOTS]]
    out = {"shape": [b, q, h, p, g, n], "blocks": len(blocks),
           "heads_per_block": heads, "card": torch.cuda.get_device_name(0)}
    names = [("start", 0, 1), ("G", 1, 2), ("G_sync", 2, 3)]
    prev = 3
    for i in range(heads):
        names += [(f"h{i}_x", prev, 4 + 3 * i), (f"h{i}_y", 4 + 3 * i,
                                                 5 + 3 * i),
                  (f"h{i}_states", 5 + 3 * i, 6 + 3 * i)]
        prev = 6 + 3 * i
    for wg in (0, 1):
        rows = [[buf[(blk * 2 + wg) * SLOTS + s] for s in range(SLOTS)]
                for blk in blocks]
        out[f"wg{wg}_cycles"] = {
            name: statistics.median(r[bb] - r[a] for r in rows)
            for name, a, bb in names}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
