"""Where a block of the bfloat16 tensor-core flash kernel spends its cycles,
phase by phase, on the card: builds a copy of
``kernels/csrc/flash_attention.cu`` with ``clock64`` stamps inserted at the
phase boundaries of ``flash_fwd_wgmma`` (thread 0 of each consumer
warpgroup, the first 1024 (block, unit) records), runs it at each shape,
and prints one JSON line a shape: the median cycles of each phase, per
warpgroup.

Phases of a warpgroup: ``fill`` (barrier init, Q's and the first K/V
tile's copies, up to the first S issued), ``tile0`` (the first tile's S and
softmax), then per later tile ``full_wait`` (the wait for its K/V stage),
``turn_wait`` (the ping-pong schedule only: the wait for the other
warpgroup's issue), ``issue`` (S of this tile and P·V of the last),
``s_wait``, ``softmax``, ``pv_wait`` and ``rescale_pack`` (P's packing,
and the accumulator's rescale, which the ping-pong schedule runs inside
``issue`` instead); then ``last_pv`` (the last P·V and the tiles past the
diagonal) and ``epilogue`` (the denominators' sums and o's stores).  On
the persistent grid each unit a block takes is traced apart (at most 8 a
block), its ``fill`` from the unit's start.  ``fill_epilogue_share`` is
(fill + epilogue) over the unit's cycles, the median over the units that
read the most key tiles.

Also builds one softmax tile alone (``softmax_probe``: ``softmax_tile`` and
``pack_p`` at 128 and 64 keys, the mask's branch included) and counts its
SASS instructions by opcode (``cuobjdump -sass``), loads, stores and
control left out.

The stamps are placed by anchors in the kernel's text, one table for each
schedule the kernel has had ("serial": the two consumer warpgroups unordered;
"pingpong": their issue ordered by named barriers); the table whose anchors
all match is used, so ``--source`` may name an older tree's kernel.  The
build fails if ptxas serialized a wgmma (a C75xx line): the stamps must not
change the schedule they measure.

Run on a machine with one CUDA card and nvcc:
    python3 tools/flash_trace.py [--source FILE] [B Sq Sk H KV d causal ...]
(default: grok-1's group of 6, (1, 2048, 2048, 48, 8, 128, causal), and
seamless's encoder, (1, 4096, 4096, 16, 16, 64, non-causal)).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402

SHAPES = [(1, 2048, 2048, 48, 8, 128, True),
          (1, 4096, 4096, 16, 16, 64, False)]
# records of (block, unit a block has taken: 0 but in the persistent grid),
# warpgroups a block, slots of a record
RECORDS, UNITS, WGS, TILE0, STRIDE, MAX_TILES = 1024, 8, 3, 8, 8, 40
SLOTS = TILE0 + STRIDE * MAX_TILES
# block-level stamps 0-5: entry, the first S's issue, the loop's start and
# end, the epilogue's start and the block's end
BLOCK_PHASES = [("fill", 0, 1), ("tile0", 1, 2), ("last_pv", 3, 4),
                ("epilogue", 4, 5), ("total", 0, 5)]

# Each table: the per-tile phases (between consecutive per-tile stamps
# 0, 1, ...) and the stamps, each (text before, text after, stamp): the
# stamp goes between the two texts, whose join must occur once.
TABLES = {
    "serial": {
        "tile_phases": ["full_wait", "issue", "s_wait", "softmax", "pv_wait",
                        "rescale_pack"],
        "stamps": [
            ("flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,"
             "\n                const __grid_constant__ CUtensorMap kmap,"
             "\n                const __grid_constant__ CUtensorMap vmap,"
             "\n                __nv_bfloat16* __restrict__ o, Geom g, "
             "float scale_log2,\n                int causal, Split split) {\n",
             "  using L = TcSmem<D, DV>;", "  TR(0);\n"),
            ("      mbar_wait(&full[0], 0);\n", "      float sc[kBK / 2];",
             "      TR(1);\n"),
            ("      pack_p<kBK>(sc, p);\n    }\n",
             "    // Tile j's P·V runs", "    TR(2);\n"),
            ("    for (int j = 0; j + 1 < n_live; ++j) {\n",
             "      mbar_wait(&full[(j + 1) % kStages]", "      TT(j, 0);\n"),
            ("((j + 1) / kStages) & 1);\n", "      float sc[kBK / 2];",
             "      TT(j, 1);\n"),
            ("      issue_pv<kN, kBK>(acc, p, v_smem(j));\n",
             "      wg_wait<1>();", "      TT(j, 2);\n"),
            ("      fence_regs(sc);\n",
             "      softmax_tile<kBK>(sc, st, al_a, al_b, (t0 + j + 1)",
             "      TT(j, 3);\n"),
            ("c2, g.Sk, scale_log2, causal);\n",
             "      wg_wait<0>();\n      fence_regs(acc);\n"
             "      fence_regs(p);\n      release(j);", "      TT(j, 4);\n"),
            ("      fence_regs(p);\n", "      release(j);\n#pragma unroll",
             "      TT(j, 5);\n"),
            ("      pack_p<kBK>(sc, p);\n",
             "    }\n    if (n_live > 0) {\n      fence_regs(acc);",
             "      TT(j, 6);\n"),
            ("    }\n", "    if (n_live > 0) {\n      fence_regs(acc);\n"
             "      fence_regs(p);\n      wg_fence();\n      issue_pv<kN, kBK>"
             "(acc, p, v_smem(n_live - 1));", "    TR(3);\n"),
            ("      release(j);\n    }\n\n", "    if (wg_live) {",
             "    TR(4);\n"),
            ("acc[4 * i + 3] / den_b);\n      }\n", "    }\n  }\n}\n",
             "      TR(5);\n"),
        ],
    },
    "pingpong": {
        "tile_phases": ["full_wait", "turn_wait", "issue", "s_wait",
                        "softmax", "pv_wait", "rescale_pack"],
        "stamps": [
            ("flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,"
             "\n                const __grid_constant__ CUtensorMap kmap,"
             "\n                const __grid_constant__ CUtensorMap vmap,"
             "\n                __nv_bfloat16* __restrict__ o, Geom g, "
             "float scale_log2,\n                int causal, Split split) {\n",
             "  using L = TcSmem<D, DV>;", "  TRU(0, 0);\n"),
            ("      if (!tc_unit<kSplit>(r, g, causal, kBK, split.tpc, un)) "
             "continue;\n", "      const int q0w = un.q0 + 64 * wg;",
             "      if (n > 0) TRU(n, 0);\n"),
            ("        wait_full(it);\n", "        float sc[kBK / 2];",
             "        TRU(n, 1);\n"),
            ("        pack_p<kBK>(sc, p);\n      }\n",
             "      // Inside a warpgroup too", "      TRU(n, 2);\n"),
            ("      for (int j = 0; j + 1 < n_live; ++j) {\n",
             "        wait_full(it + j + 1);", "        TTU(n, j, 0);\n"),
            ("        fence_regs(p);\n", "        turn_begin();\n        "
             "wg_fence();\n        issue_qk<D, kBK>(sc, q_s, k_smem(it + j + "
             "1));", "        TTU(n, j, 1);\n"),
            ("        turn_begin();\n", "        wg_fence();\n        "
             "issue_qk<D, kBK>(sc, q_s, k_smem(it + j + 1));",
             "        TTU(n, j, 2);\n"),
            ("        turn_end(j + 1);\n", "        wg_wait<1>();",
             "        TTU(n, j, 3);\n"),
            ("        fence_regs(sc);\n",
             "        softmax_tile<kBK>(sc, st, al_a, al_b, (un.t0 + j + 1)",
             "        TTU(n, j, 4);\n"),
            ("row_a, c2, g.Sk, scale_log2, causal);\n",
             "        wg_wait<0>();\n        fence_regs(acc);\n        "
             "fence_regs(p);\n        arrive(&empty[(it + j) % kStages]);",
             "        TTU(n, j, 5);\n"),
            ("        fence_regs(p);\n",
             "        arrive(&empty[(it + j) % kStages]);\n        if (j + 2",
             "        TTU(n, j, 6);\n"),
            ("        pack_p<kBK>(sc, p);\n",
             "      }\n      if (n_live > 0) {\n        fence_regs(acc);",
             "        TTU(n, j, 7);\n"),
            ("      }\n", "      if (n_live > 0) {\n        fence_regs(acc);"
             "\n        fence_regs(p);\n        turn_begin();",
             "      TRU(n, 3);\n"),
            ("        arrive(&empty[(it + j) % kStages]);\n      }\n",
             "      // every warpgroup with rows writes",
             "      TRU(n, 4);\n"),
            ("ob + row_b * g.oss + col) = rb;\n            }\n          }\n",
             "        }\n      }\n      it += un.n_tiles;",
             "          TRU(n, 5);\n"),
        ],
    },
}

PROBE = r"""
// one softmax tile alone, for counting its instructions
template <int BK>
__global__ void softmax_probe(float* buf, int k0, int q0w, int sk,
                              float scale_log2, int causal) {
  float* mine = buf + threadIdx.x * (BK / 2 + 6);
  float sc[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = mine[i];
  RowState st{mine[BK / 2], mine[BK / 2 + 1], mine[BK / 2 + 2],
              mine[BK / 2 + 3]};
  float al_a, al_b;
  const int lane = threadIdx.x & 31;
  softmax_tile<BK>(sc, st, al_a, al_b, k0, q0w,
                   q0w + (threadIdx.x >> 5) * 16 + (lane >> 2),
                   2 * (lane & 3), sk, scale_log2, causal);
  uint32_t p[BK / 4];
  pack_p<BK>(sc, p);
  uint32_t* out = reinterpret_cast<uint32_t*>(mine);
#pragma unroll
  for (int j = 0; j < BK / 4; ++j) out[j] = p[j];
  mine[BK / 2] = st.m_a;
  mine[BK / 2 + 1] = st.m_b;
  mine[BK / 2 + 2] = st.l_a;
  mine[BK / 2 + 3] = st.l_b;
  mine[BK / 2 + 4] = al_a;
  mine[BK / 2 + 5] = al_b;
}
template __global__ void softmax_probe<128>(float*, int, int, int, float, int);
template __global__ void softmax_probe<64>(float*, int, int, int, float, int);

extern "C" int read_trace(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));
}
"""
# opcodes that are the probe's own loads, stores and control, not softmax
NOT_SOFTMAX = {"LDG", "STG", "LDC", "ULDC", "S2R", "S2UR", "EXIT", "BRA",
               "NOP", "BSSY", "BSYNC"}


def instrumented_source(src: str) -> tuple:
    """(the source with stamps and the probe, the table's name)."""
    for name, table in TABLES.items():
        stamped = _apply(src, table["stamps"])
        if stamped is not None:
            break
    else:
        raise RuntimeError("flash_attention.cu matches no stamp table: "
                           "update tools/flash_trace.py's anchors")
    units = UNITS if name == "pingpong" else 1
    head = ('#include "hopper.cuh"\n'
            f"__device__ long long g_trace[{RECORDS} * {WGS} * {SLOTS}];\n"
            "#define TRU(unit, slot) do { const int rec_ = (blockIdx.x + "
            "gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) * "
            f"{units} + (unit); if ((threadIdx.x & 127) == 0 && (unit) < "
            f"{units} && rec_ < {RECORDS} && (slot) < {SLOTS}) "
            f"g_trace[(rec_ * {WGS} + (threadIdx.x >> 7)) * {SLOTS} + "
            "(slot)] = clock64(); } while (0)\n"
            "#define TR(slot) TRU(0, slot)\n"
            f"#define TTU(unit, j, k) TRU(unit, {TILE0} + {STRIDE} * (j) + "
            "(k))\n#define TT(j, k) TTU(0, j, k)\n")
    if stamped.count('#include "hopper.cuh"\n') != 1:
        raise RuntimeError("flash_attention.cu: no single hopper.cuh include")
    return stamped.replace('#include "hopper.cuh"\n', head, 1) + PROBE, name


def _apply(src: str, stamps) -> str | None:
    """The source with each stamp inserted in turn, or None where an
    anchor does not occur exactly once in the text stamped so far."""
    for before, after, stamp in stamps:
        if src.count(before + after) != 1:
            return None
        src = src.replace(before + after, before + stamp + after, 1)
    return src


def _nvcc_build(cu: Path, so: Path, include: Path) -> str:
    run = subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS,
                          *_build.NVCC_FLAGS, f"-I{include}", "-o", str(so),
                          str(cu)], capture_output=True, text=True)
    log = run.stdout + run.stderr
    if run.returncode:
        raise RuntimeError(f"nvcc failed:\n{log}")
    serialized = [line for line in log.splitlines() if "C75" in line]
    if serialized:
        raise RuntimeError(f"ptxas serialized wgmma: {serialized}")
    return log


def _cuobjdump() -> str | None:
    found = shutil.which("cuobjdump")
    if found:
        return found
    nvcc = Path(_build._nvcc()).resolve()
    cand = nvcc.parent / "cuobjdump"
    return str(cand) if cand.exists() else None


def softmax_sass(so: Path) -> dict:
    """Opcode counts of each softmax_probe instantiation's SASS."""
    tool = _cuobjdump()
    if tool is None:
        return {"error": "no cuobjdump"}
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for func in re.split(r"\n\s+Function : ", sass)[1:]:
        name = func.split("\n", 1)[0].strip()
        if "softmax_probe" not in name:
            continue
        bk = 128 if "ILi128E" in name else 64
        ops = {}
        for m in re.finditer(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                             r"([A-Z][A-Z0-9_]*)", func):
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
        body = {k: v for k, v in ops.items() if k not in NOT_SOFTMAX}
        out[f"keys_{bk}"] = {"instructions": sum(body.values()),
                             "per_score": sum(body.values()) / (bk / 2),
                             "by_opcode": dict(sorted(body.items(),
                                                      key=lambda kv: -kv[1]))}
    return out


def trace_shape(lib, shape) -> dict:
    b, sq, sk, h, kv, d, causal = shape
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((b, sq, h, d), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, sk, kv, d), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, sk, kv, d), generator=gen, device=dev).bfloat16()
    o = torch.empty_like(q)
    chunks, tpc = tflash.split_plan(b, h, sq, sk, causal,
                                    tflash._sm_count(dev),
                                    tflash.tc_key_tile(d, d))
    ws = (torch.empty(chunks * b * h * sq * (d + 2), device=dev)
          if chunks > 1 else None)
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12 + [ctypes.c_float]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)
    for _ in range(3):                 # the last launch's stamps are read
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                b, sq, sk, h, kv, d, d, *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], *o.stride()[:3], 1.0 / math.sqrt(d),
                int(causal), 1, 1, chunks, tpc,
                None if ws is None else ws.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: code {rc}")
    torch.cuda.synchronize(dev)
    err = float((o.float() - tflash.flash_attention_ref(
        q, k, v, causal=causal).float()).abs().max())
    buf = (ctypes.c_longlong * (RECORDS * WGS * SLOTS))()
    if lib.read_trace(buf):
        raise RuntimeError("reading the stamps failed")
    return {"chunks": chunks, "max_abs_err": err}, buf


def summarize(buf, tile_phases) -> dict:
    out = {}
    for wg in (0, 1):
        rows = [buf[(rec * WGS + wg) * SLOTS:(rec * WGS + wg + 1) * SLOTS]
                for rec in range(RECORDS)]
        rows = [r for r in rows if r[0] and r[5]]
        tiles = [sum(1 for j in range(MAX_TILES) if r[TILE0 + STRIDE * j])
                 for r in rows]
        phases = {}
        for name, a, z in BLOCK_PHASES:
            vals = [r[z] - r[a] for r in rows if r[a] and r[z]]
            if vals:
                phases[name] = statistics.median(vals)
        for k, name in enumerate(tile_phases):
            vals = [r[TILE0 + STRIDE * j + k + 1] - r[TILE0 + STRIDE * j + k]
                    for r in rows for j in range(MAX_TILES)
                    if r[TILE0 + STRIDE * j]]
            if vals:
                phases[name] = statistics.median(vals)
        per_tile = [(r[3] - r[2]) / n for r, n in zip(rows, tiles)
                    if n and r[2] and r[3]]
        most = max(tiles) if tiles else 0
        heavy = [r for r, n in zip(rows, tiles) if n == most]
        share = [((r[1] - r[0]) + (r[5] - r[4])) / (r[5] - r[0])
                 for r in heavy if r[1] and r[4]]
        out[f"wg{wg}"] = {
            "units": len(rows), "most_tiles": most + 1,
            "cycles": phases,
            "loop_cycles_per_tile": (statistics.median(per_tile)
                                     if per_tile else None),
            "fill_epilogue_share": (statistics.median(share)
                                    if share else None)}
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", default=str(_build.CSRC
                                            / "flash_attention.cu"))
    ap.add_argument("shape", nargs="*", type=int)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_trace: no CUDA device")
    shapes = SHAPES
    if args.shape:
        if len(args.shape) % 7:
            raise SystemExit("a shape is B Sq Sk H KV d causal")
        shapes = [tuple(args.shape[i:i + 7])
                  for i in range(0, len(args.shape), 7)]
    source = Path(args.source).resolve()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory(prefix="flash-trace-") as tmp:
        text, table = instrumented_source(source.read_text())
        cu = Path(tmp) / "flash_trace.cu"
        cu.write_text(text)
        so = Path(tmp) / "libflash_trace.so"
        log = _nvcc_build(cu, so, source.parent)
        regs = sorted(set(re.findall(r"Used (\d+) registers", log)))
        sass = softmax_sass(so)
        lib = ctypes.CDLL(str(so))
        print(json.dumps({"source": str(source), "schedule": table,
                          "card": card, "softmax_sass": sass,
                          "registers_seen": regs}), flush=True)
        for shape in shapes:
            info, buf = trace_shape(lib, shape)
            print(json.dumps({"shape": list(shape), "schedule": table,
                              "card": card, **info,
                              **summarize(buf,
                                          TABLES[table]["tile_phases"])}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
