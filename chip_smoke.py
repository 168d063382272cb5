"""Chip smoke test of the PyTorch/CUDA port: builds the hand-written kernels,
holds each against its plain PyTorch version on the card, and drives the
port's paths through their entry points: the quickstart's cross-island
query and the §IV-B wavelet-signature kNN analytic at 4096 patients through
``connect()`` (plan-level fusion on: tfidf -> knn as one CUDA graph
replay), the same analytic served by ``QueryServer`` over a resilient
session with the 64 test patients as one batch (cold race, throughput,
shedding, failover, tracing, warm restart), the process pool on the same
state (``procpool``: a master in a fresh process that never initializes
CUDA drives pools of 1 and 4 workers on the card, the analytic's front
half over 4 row-range shards, an append through a pool and a worker
killed mid-request; streaming views patched after appends in this
process), then LM serving
(``BatchServer`` prefill + continuous-batching decode) of internlm2-1.8b,
mamba2-370m, deepseek-v2-lite-16b (MoE, MLA) and zamba2-7b (hybrid: 81
Mamba2 layers and a shared attention block 13 times, both LM kernels in one
model), internvl2-26b (vision-language: 256 patch embeddings before the
prompt, 48 heads over 8 KV heads) and seamless-m4t-medium
(encoder-decoder: a non-causal encoder over 4096 frames, a decoder with
cross-attention) at full width and depth and of grok-1-314b (MoE) at full
width and depth 2, with bfloat16 parameters from the port's seeded init,
internlm2 once more on a 1-rank NCCL mesh (``lm_sharded``: 4 of
``lm_dense``'s requests under context-parallel decode, held to
``lm_dense``'s logits and tokens, and 2 train steps at depth 4 held to
unsharded ones, through the tensor-parallel code, whose collectives and
weight gathers a 1-rank mesh reduces to none), one rank's share of
internlm2 split four ways over "model" (``tp_rank``: rank 0 of a (1, 4)
mesh over torch's fake process group, whose collectives move nothing: a
2048-token prefill on its 4 query heads and 2 KV heads, and 4 decode
steps, timed, no value checked) and of zamba2-7b (``tp_rank_hybrid``: the
Mamba mixer on 28 of 112 heads in each of 81 layers, the shared block on
8 of 32), the dry run of codeqwen1.5-7b at train_4k (``dryrun``:
``launch.dryrun.run_cell`` as rank 0 of the production (16, 16) mesh over
the fake group: one full-depth train step on the card, its peak memory
against the card's, the cost probes and the roofline), and last LM
training of internlm2, mamba2 (at depth 24), deepseek (at
depth 3), zamba2 (at depth 13), internvl2 (at depth 2) and seamless
(``train``: the
kernels' gradients against the plain versions, a
float32 step on the card against the CPU, steps from ``TokenStream``
batches through ``ShardedLoader``, and a ``Trainer`` run with injected
failures against an uninterrupted one).

Run on a machine with one CUDA card:  python3 chip_smoke.py

Each phase prints one JSON line (procpool and train one a section, the
kernel phases one a shape) and a line with its wall ``seconds``; any
failure exits non-zero.  The line before the last lists every ported
kernel with its launches on its path
(Haar and kNN on the analytic, the tensor-core kNN on the serving phase,
and both in the procpool phase's workers as ``pool_launches``,
the bfloat16 tensor-core flash attention on the dense LM's bfloat16
serving (and as entries of their own on internvl2's at a GQA group of 6,
seamless's at d 64, deepseek's MLA at q/k 192 and v 128, zamba2's at 112,
and one rank's heads of zamba2 and internlm2, split over keys), the
float32 (3xTF32) one on its float32 prefill check, the warp-level
tensor-core one on the smoke configs' float32 ragged prefills (and as its
own entry on zamba2's float32 prefill at 112),
the CUDA-core one on the flash phase's entry-point calls at widths
that are not a multiple of 8, the tensor-core SSD on the SSM LM's
serving (and as its own entry on zamba2's at p 64, n 64), the CUDA-core one on the SSM smoke config's ragged prefill
check; ``train_launches``: the tensor-core flash and SSD kernels in the
train phase's steps, forward and remat recompute), its error against the
plain version, its time, the plain version's time, the bound and the
yardstick library call's time.
Times are device times: CUDA events around many back-to-back launches,
divided by their count (``time_ms``); ``call_ms`` beside them is the old
one-call figure, what the path pays per call with the host's work.  The
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository's ``src/`` beside it, the script fails and prints no
result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import multiprocessing
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import PlanConfig, ShapeConfig, get_arch  # noqa: E402
from repro_torch.core import (DenseTensor, EngineHealth, ProcPool,  # noqa: E402
                              array, connect, execute_plan, fuseplan)
from repro_torch.core import middleware as mw  # noqa: E402
from repro_torch.core.engines import ENGINES  # noqa: E402
from repro_torch.core.middleware import _plan_from_key  # noqa: E402
from repro_torch.core.qlang import bigdawg  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.data import (ShardedLoader, TokenStream,  # noqa: E402
                              ecg_waveforms)
from repro_torch.kernels import _build, counters, ops  # noqa: E402
from repro_torch.kernels.work import flash_work, ssd_work  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_cuda, decode_attention_ref)
from repro_torch.kernels.haar import haar_cuda, haar_ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    TC_WIDTHS, TF32_HEAD_DIMS, flash_attention_cuda, flash_attention_ref,
    split_plan, tc_key_tile, tc_occupancy, tc_smem_bytes, tf32_smem_bytes,
    variant)
from repro_torch.kernels.knn import (  # noqa: E402
    knn_scores_cuda, knn_scores_ref, variant as knn_variant)
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd_intra_cuda, ssd_intra_ref, variant as ssd_variant)
from repro_torch.launch.mesh import make_mesh_compat  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import partition, ssm  # noqa: E402
from repro_torch.models.partition import plan_scope  # noqa: E402
from repro_torch.models.specs import gather_fsdp  # noqa: E402
from repro_torch.models.encdec import DECODE_ENC_LEN  # noqa: E402
from repro_torch.models.hybrid import _geometry as hybrid_geometry  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.core.tables import host_copy  # noqa: E402
from repro_torch.runtime import (BatchServer, EngineFaultInjector,  # noqa: E402
                                 FailureInjector, Overloaded, QueryServer,
                                 Request, Trainer, WorkerKillInjector)

# H100 SXM published peaks (NVIDIA data sheet): HBM rate, and operations a
# second of each kind of unit: float32 outside the tensor cores, dense
# bfloat16 tensor cores, and float32 as 3xTF32 on the dense TF32 tensor
# cores (495 TFLOP/s, three TF32 products per float32 one).  Bounds use them
# with the card's power limit printed beside (a lower limit runs slower
# under load).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "bf16": 989e12, "3xtf32": 495e12 / 3}
UNITS = {torch.float32: "f32", torch.bfloat16: "bf16"}

LEVELS, NBINS, K = 6, 32, 11
N_TRAIN, N_TEST, SAMPLES = 4096, 64, 16384
ANALYTIC = (f"ARRAY(knn(tfidf(bin_hist(haar(waves, levels={LEVELS}), "
            f"nbins={NBINS}, levels={LEVELS})), test_hist, k={K}))")
QUICKSTART = ("ARRAY(matmul(RELATIONAL(select(A, column=value, lo=-0.5, "
              "hi=2.0)), B))")
# the serving phase's query: the analytic over all 64 test patients at once
# (one 64 x 224 test batch, so kNN runs at B 64 on the tensor-core kernel)
SERVING = ANALYTIC.replace("test_hist", "test_batch")
# post-order positions of tfidf and knn in both queries: the one fusable
# chain, a segment when the plan puts both on dense_array (the production
# plan can move to another known plan while monitor means settle)
FUSED_TAIL = (2, 3)
# analytic: production serves timed with fusion on and off, alternating
FUSE_COMPARE_SERVES = 12
# serving: cold racers, warm requests a throughput run, request threads,
# the shedding batch and its bound, the failover waves' shape
SERVE_COLD, SERVE_WARM, SERVE_WORKERS = 16, 64, 8
SHED_BATCH, SHED_PENDING = 32, 2
FAILOVER_WAVES = (256, 1024)
# procpool: worker counts of the warm runs (the largest also traced; a
# pool of 2 was dropped for the time budget: its start-up alone took
# 16-17 s), warm requests a run and client
# threads; the scatter run's shards, workers, planner breadth and timed
# serves a mode; the stream run's appends and rows an append; the kill
# run's requests and the execute dispatch its injector kills; how long the
# phase's master may stay silent
POOL_SIZES, POOL_WARM, POOL_CLIENTS = (1, 4), 64, 8
SCATTER_SHARDS, SCATTER_WORKERS, SCATTER_TRAIN_PLANS = 4, 2, 2
SCATTER_SERVES = 6
STREAM_APPENDS, STREAM_ROWS = 8, 64
KILL_REQUESTS, KILL_ON_DISPATCH = 16, 3
POOL_MASTER_TIMEOUT_S = 300
# the analytic's front half (examples/polystore_analytic.py:28-29): row-wise,
# so it scatters over row-range shards and patches a view after appends
FRONT_HALF = (f"ARRAY(bin_hist(haar(waves, levels={LEVELS}), nbins={NBINS}, "
              f"levels={LEVELS}))")
STREAM_QUERY = FRONT_HALF.replace("waves", "S")
HAAR_SHAPES = [(4096, 16384, 6), (130, 256, 4), (3, 32, 1)]
# (N, V, B): the analytic's B 1 and a B 64 batch (both timed), then the two
# kernels' boundary (B 8 the last of the matrix-vector kernel, B 9 the first
# of the tensor-core one) at a ragged N and a V that is not a multiple of 8
KNN_SHAPES = [(4096, 224, 1), (4096, 224, 64), (100, 48, 3), (1001, 227, 8),
              (1001, 227, 9)]
# kernel vs plain: Haar keeps the plain version's operation order, so it is
# bitwise in float32; bfloat16 is held at the reference tests' tolerance.
# knn sums in another order than the plain product: the reference tests'
# score tolerances, and equal top-k indices in float32.
HAAR_TOL = {torch.float32: (0.0, 0.0), torch.bfloat16: (2e-2, 2e-2)}
KNN_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2e-2, 0.3)}
# L2 cache of the H100 (50 MB): inputs that the path reads cold are rotated
# through copies that together exceed it twice
L2_BYTES = 50e6
# (BH, Sq, Sk, d, causal, dtype), the (BH, S, d) form; the first three are
# the dense prefill's attention folded (internlm2: 16 heads of 128, a
# 2048-token prompt) in bfloat16 and float32, and float32 at d 64, the rest
# ragged, the last two non-causal with Sq != Sk.  Every float32 shape that
# a wgmma kernel takes, and every shape that the warp-level kernel ("mma")
# takes, is also checked on the CUDA-core kernel.
FLASH_SHAPES = [(16, 2048, 2048, 128, True, torch.bfloat16),
                (16, 2048, 2048, 128, True, torch.float32),
                (16, 2048, 2048, 64, True, torch.float32),
                (4, 1, 1, 64, True, torch.float32),
                (4, 77, 77, 80, True, torch.float32),
                (2, 1000, 1000, 64, True, torch.float32),
                (2, 1000, 1000, 80, False, torch.float32),
                (3, 200, 200, 128, False, torch.float32),
                (3, 129, 129, 17, True, torch.bfloat16),
                (3, 150, 150, 40, True, torch.bfloat16),
                (3, 150, 150, 40, False, torch.float32),
                (2, 97, 97, 256, True, torch.float32),
                (2, 97, 97, 256, False, torch.bfloat16),
                (4, 33, 200, 64, False, torch.float32),
                (3, 200, 50, 128, False, torch.bfloat16)]
# deepseek-v2-lite's MLA prefill of 2048 tokens (16 heads, q and k 192
# wide: qk_nope 128 + qk_rope 64; v 128, read at its own width on the
# path), the shape's last element v's width, and grok-1's (48 query heads
# over 8 KV heads of 128), both bfloat16
MLA_V_WIDTH = 128
MLA_FLASH_SHAPE = (1, 2048, 2048, 16, 16, 192, True, torch.bfloat16,
                   MLA_V_WIDTH)
GROK_FLASH_SHAPE = (1, 2048, 2048, 48, 8, 128, True, torch.bfloat16)
# internvl2-26b's prefill of 256 patches and a 2048-token prompt (grok's
# group of 6: 48 heads over 8), seamless-m4t-medium's encoder over 4096
# frames (16 heads of 64, non-causal) and its decoder's cross-attention
# of a 77-token and a 1-token prompt against the 4096 encoder rows
VLM_FLASH_SHAPE = (1, 2304, 2304, 48, 8, 128, True, torch.bfloat16)
ENC_FLASH_SHAPE = (1, 4096, 4096, 16, 16, 64, False, torch.bfloat16)
CROSS_FLASH_SHAPES = [(1, 77, 4096, 16, 16, 64, False, torch.bfloat16),
                      (1, 1, 4096, 16, 16, 64, False, torch.bfloat16),
                      (1, 77, 4096, 16, 16, 64, False, torch.float32),
                      (1, 1, 4096, 16, 16, 64, False, torch.float32)]
# one rank's share of internlm2-1.8b's prefill split 4 ways over "model"
# (phase tp_rank: 4 of 16 query heads over 2 of 8 KV heads), of
# zamba2-7b's shared block split the same way (tp_rank_hybrid: 8 of 32
# heads of 112), and of
# internvl2-26b's or grok-1's split 16 ways, where KV % tp != 0 keeps wk
# and wv whole: 3 of 48 query heads read one KV head of 8 in place, k and
# v narrowed views of the whole projection (``layers.rank_kv``), given as
# (shape, whole KV heads, first KV head read: ranks 10 and 11's)
TP_RANK_FLASH_SHAPE = (1, 2048, 2048, 4, 2, 128, True, torch.bfloat16)
TP_RANK_HYBRID_FLASH_SHAPE = (1, 2048, 2048, 8, 8, 112, True,
                              torch.bfloat16)
# dryrun: ``launch.dryrun.run_cell`` of codeqwen1.5-7b (dense MHA, qkv
# bias) at train_4k as rank 0 of the production (16, 16) mesh over torch's
# fake process group, at full width and depth with its default plan: the
# fit proof (one full-depth train step on the card, its peak memory), the
# cost probes and the roofline; its flash kernel at the rank's 2 of 32
# heads, 16 // accum rows of 4096 tokens (DRYRUN_FLASH_SHAPE at accumulation 1)
DRYRUN_ARCH, DRYRUN_SHAPE = "codeqwen1.5-7b", "train_4k"
DRYRUN_FLASH_SHAPE = (16, 4096, 4096, 2, 2, 128, True, torch.bfloat16)
FLASH_NARROW_KV = [((1, 2048, 2048, 3, 1, 128, True, torch.bfloat16), 8, 5),
                   ((1, 2048, 2048, 3, 1, 128, True, torch.float32), 8, 5)]
# (B, Sq, Sk, H, KV, d, causal, dtype[, v width]), the (B, S, H, d) form
# with the KV heads read in place; first the paths' own shapes: internlm2's
# prefill (16
# query heads over 8 KV heads of 128) of 2048 tokens in bfloat16 (serving)
# and float32 (the traced float32 prefill), of 256 in float32 (cpu_check),
# and its smoke config's 61-token float32 prefill (ragged_check: head width
# 32); then zamba2-7b's shared block (32 heads of 112) at 2048 tokens in
# both dtypes (bfloat16: its serving), the MoE models', internvl2's and
# seamless's prefills, ragged shapes, and non-causal Sq != Sk on every
# kernel: Sq < Sk and Sq > Sk on "tc" and "tf32" at d 64 and 128, "tc" at
# 112 and 192 (v 128 and 192), "mma" at d 80 and float32 112 (and forced
# "simt" there), "simt" at d 17; Sq 1 against Sk 4096 on "tc", "tf32" and
# "mma" (and forced "simt")
FLASH_GQA_SHAPES = [(1, 2048, 2048, 16, 8, 128, True, torch.bfloat16),
                    (1, 2048, 2048, 16, 8, 128, True, torch.float32),
                    (1, 256, 256, 16, 8, 128, True, torch.float32),
                    (1, 61, 61, 4, 2, 32, True, torch.float32),
                    (1, 2048, 2048, 32, 32, 112, True, torch.bfloat16),
                    (1, 2048, 2048, 32, 32, 112, True, torch.float32),
                    MLA_FLASH_SHAPE, GROK_FLASH_SHAPE, VLM_FLASH_SHAPE,
                    TP_RANK_FLASH_SHAPE, TP_RANK_HYBRID_FLASH_SHAPE,
                    DRYRUN_FLASH_SHAPE, ENC_FLASH_SHAPE,
                    *CROSS_FLASH_SHAPES,
                    (2, 1000, 1000, 4, 1, 64, False, torch.bfloat16),
                    (1, 65, 65, 8, 2, 80, True, torch.bfloat16),
                    (2, 129, 129, 6, 2, 128, True, torch.float32),
                    (1, 333, 333, 8, 2, 64, True, torch.float32),
                    (1, 77, 77, 8, 2, 40, True, torch.float32),
                    (1, 130, 130, 4, 2, 256, True, torch.bfloat16),
                    (2, 300, 130, 4, 2, 128, False, torch.bfloat16),
                    (1, 130, 300, 8, 2, 128, False, torch.float32),
                    (2, 300, 130, 4, 2, 64, False, torch.float32),
                    (1, 77, 333, 8, 2, 80, False, torch.bfloat16),
                    (2, 300, 130, 4, 2, 64, False, torch.bfloat16),
                    (1, 130, 300, 8, 2, 128, False, torch.bfloat16),
                    (2, 300, 130, 4, 2, 128, False, torch.float32),
                    (1, 300, 97, 4, 4, 112, False, torch.float32),
                    (2, 300, 130, 4, 2, 112, False, torch.bfloat16),
                    (1, 333, 333, 4, 2, 192, True, torch.bfloat16, 128),
                    (1, 130, 300, 4, 2, 192, False, torch.bfloat16, 128),
                    (1, 200, 200, 4, 2, 192, True, torch.bfloat16),
                    (1, 1, 4096, 4, 4, 32, False, torch.float32),
                    (2, 70, 150, 4, 2, 17, False, torch.bfloat16),
                    (2, 150, 70, 4, 1, 17, False, torch.float32)]
# the (shape, kernel) pairs that phase_flash times, with their row's name:
# each kernel at its path's shape ("tc", "tf32", "mma"); the CUDA-core
# kernel, forced, at the warp-level kernel's path shape ("simt_before":
# its time before "mma" took that path, the CUDA-core kernel's row of the
# kernels line); zamba2's shared block on "tc" in bfloat16 (its serving)
# and on "mma" in float32; the MoE models' prefills (MLA at q/k 192, v
# 128 on "tc", grok's group of 6 on "tc"), internvl2's group of 6 and
# seamless's non-causal encoder at d 64 on "tc"; zamba2's shared block on
# the rank's 8 heads (tp_rank_hybrid) and internlm2's rank of four
# (tp_rank) on "tc", both split over keys; codeqwen's rank of 16 (dryrun:
# 2 heads, 16 rows of 4096) on "tc"; and the folded forms at 2048 tokens.
# The CUDA-core kernel's times at zamba2's width and the folded float32
# form (the "before" of the kernels that took those shapes), and the
# warp-level kernel's at zamba2's and MLA's bfloat16 shapes (the "before"
# of "tc" there), are no longer taken, for the time budget; those shapes
# are still checked
FLASH_TIMED = {(FLASH_GQA_SHAPES[0], "tc"): "tc",
               (FLASH_GQA_SHAPES[1], "tf32"): "tf32",
               (FLASH_GQA_SHAPES[3], "mma"): "mma",
               (FLASH_GQA_SHAPES[3], "simt"): "simt_before",
               (FLASH_GQA_SHAPES[4], "tc"): "tc_d112",
               (FLASH_GQA_SHAPES[5], "mma"): "mma_d112_f32",
               (MLA_FLASH_SHAPE, "tc"): "tc_mla",
               (GROK_FLASH_SHAPE, "tc"): "tc_gqa6",
               (VLM_FLASH_SHAPE, "tc"): "tc_gqa6_vlm",
               (ENC_FLASH_SHAPE, "tc"): "tc_d64_noncausal",
               (TP_RANK_HYBRID_FLASH_SHAPE, "tc"): "tc_tp_rank_hybrid",
               (TP_RANK_FLASH_SHAPE, "tc"): "tc_tp_rank",
               (DRYRUN_FLASH_SHAPE, "tc"): "tc_dryrun",
               (FLASH_SHAPES[0], "tc"): "tc_folded",
               (FLASH_SHAPES[1], "tf32"): "tf32_folded",
               (FLASH_SHAPES[2], "tf32"): "tf32_d64"}
# (b, Q, h, p, g, n); the first is the SSM prefill path's shape (mamba2:
# 16 chunks of 128 for a 2048-token prompt), then zamba2-7b's p and n at 32
# heads, zamba2's own prefill shape (112 heads), a tensor-core shape with
# g = 2, the SSM smoke config's 61-token prefill (ragged_check: 8 chunks of
# 8), ragged shapes that only the CUDA-core kernel takes, and a rank's
# heads of a Mamba mixer split over "model": zamba2's 28 at tp 4
# (tp_rank_hybrid's path), mamba2's 8 at tp 4 and zamba2's 7 at tp 16.
# Every shape runs on the CUDA-core kernel, and on the tensor-core kernel
# where ssd_scan.variant names it.
HYBRID_SSD_SHAPE = (16, 128, 112, 64, 1, 64)
TP_RANK_HYBRID_SSD = (16, 128, 28, 64, 1, 64)
SSD_SHAPES = [(16, 128, 32, 64, 1, 128), (16, 128, 32, 64, 1, 64),
              HYBRID_SSD_SHAPE, (2, 128, 8, 64, 2, 32), (8, 8, 16, 16, 1, 16),
              (3, 40, 6, 17, 2, 9), (5, 77, 4, 33, 2, 31),
              TP_RANK_HYBRID_SSD, (16, 128, 8, 64, 1, 128),
              (16, 128, 7, 64, 1, 64)]
# the (shape, kernel) pairs that phase_ssd times: each kernel at its path's
# shape (the tensor-core one at mamba2's, at zamba2's and at zamba2's
# rank of four), and the CUDA-core kernel, forced, at the tensor-core
# kernel's first path shape, its time before the tensor-core kernel took
# that path
SSD_TIMED = {(SSD_SHAPES[0], "tc"): "tc", (SSD_SHAPES[4], "simt"): "simt",
             (SSD_SHAPES[0], "simt"): "simt_before",
             (HYBRID_SSD_SHAPE, "tc"): "tc_p64_n64",
             (TP_RANK_HYBRID_SSD, "tc"): "tc_tp_rank"}
# the reference tests' tolerances: attention float32 1e-4, bfloat16 3e-2;
# SSD y and states 2e-4, chunk decay 1e-5 relative / 1e-6 absolute
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# a bfloat16 output is also held against the plain version in float32 on
# the same inputs, at twice the 8.2e-3 this script measured at the dense
# path's shape on the H100; its late rows average ~1000 keys (|o| ~ 0.05),
# and the float32 case at the same shape holds them at 1e-4
FLASH_BF16_VS_F32_TOL = 1.6e-2
# SSD: the kernel's float32 against the plain version in float64, y and
# states at 2e-4 relative and 2e-4 of the largest |value| absolute (B and C
# at unit scale make y of order 100: see phase_ssd)
SSD_TOL = [(2e-4, 2e-4), (2e-4, 2e-4), (1e-5, 1e-6)]
# decode attention at the decode cell's step (bench/traffic/serve-decode):
# 64 slots of 2,048 rows, 16 query over 8 KV heads of 128, bfloat16, each
# slot's position a prompt of 64-512 tokens and a uniform part of its
# 256-1,024 output tokens (DECODE_POS_SEED draws them); the kernel against
# the plain version at FLASH_TOL, and against the plain version in float32
# on the same values at DECODE_BF16_VS_F32_TOL (the kernel keeps its
# scores, weights and sums in float32: only its output rounds, 2^-9 of
# values under 4)
DECODE_SHAPE, DECODE_POS_SEED, DECODE_BF16_VS_F32_TOL = \
    (64, 2048, 16, 8, 128), 5, 1e-2
# LM serving: slots and cache capacity, requests, new tokens each
LM_SLOTS, LM_MAX_LEN, LM_REQUESTS, LM_NEW_TOKENS = 8, 4096, 16, 32
# cpu_check: the same depth-2 float32 model on the card (kernels) and on the
# CPU (plain versions); logits must agree to 1e-3 relative + 1e-3 absolute
# (float32 sums in other orders through two layers), and the greedy token
# must be equal or a near-tie within that tolerance
CPU_CHECK_TOKENS, CPU_CHECK_DEPTH, CPU_CHECK_TOL = 256, 2, 1e-3
# decode_vs_cpu (the MoE family): the served parameters' first layers in
# float32 (deepseek 2), this many slots prefilled with prompts of lengths
# in [16, 48], then decode steps; grok at GROK_DECODE_CHECK (depth,
# slots, steps): its depth 1 puts 26 GB of float32 on the host, and at 8
# slots and 4 steps the check took 27-31 s of the script, so it runs
# reduced to fit the time budget
DECODE_CHECK_SLOTS, DECODE_CHECK_PROMPT, DECODE_CHECK_STEPS = 8, (16, 49), 4
GROK_DECODE_CHECK = (1, 2, 2)
# grok-1 serves at full width and this depth, fewer requests (its
# published 64 layers are 633 GB in bfloat16)
GROK_DEPTH, GROK_REQUESTS = 2, 4
# zamba2-7b serves at full width and depth with fewer requests; its
# cpu_check runs one group and the tail (depth 7: G 1, T 1), since at
# depth 2 no group, so no shared block, would run
HYBRID_REQUESTS, HYBRID_CHECK_DEPTH = 8, 7
# internvl2-26b and seamless-m4t-medium serve at full width and depth with
# fewer requests.  Their frontends are stubs: one seeded standard-normal
# tensor a phase, shared by its requests (the server passes a prefill only
# the tokens): internvl2's 256 patch embeddings, seamless's DECODE_ENC_LEN
# (4096) frames, so that no request's encoder rows are zero-filled.
# seamless's decoder prompts are 1-128 tokens (default_rng(0)), one a
# single token (the reference's BOS-only prefill); its float32 cpu_check
# encodes the first CPU_CHECK_FRAMES frames
VLM_REQUESTS, ENCDEC_REQUESTS = 4, 8
ENCDEC_PROMPT, CPU_CHECK_FRAMES = (1, 129), 512
# decode_vs_prefill: in bfloat16 the kernel prefill and the plain decode
# round at other places over the whole depth; a token that differs must be
# a near-tie, its prefill logit within this margin of the prefill's argmax
DECODE_NEAR_TIE = 0.5
# LM training (phase "train"): batch at S 2048 per model, full width and
# depth but TRAIN_DEPTH's (deepseek-v2-lite: its dense first layer and two
# MoE layers, 1.67 B parameters), PlanConfig defaults (bfloat16 compute,
# float32 master and moments, block remat, attention and loss chunks of
# 1024); one warm-up step, then TRAIN_STEPS timed ones (cut from 8 to 4,
# then to 2, for the time budget: 4's medians came within 2% of 8's), with
# AdamW at TRAIN_LR
TRAIN_BATCH = {"internlm2-1.8b": 4, "mamba2-370m": 8,
               "deepseek-v2-lite-16b": 4, "zamba2-7b": 4,
               "internvl2-26b": 4, "seamless-m4t-medium": 4}
# zamba2 at depth 13: two groups of 6 and one tail layer, 1.34 B
# parameters (the whole model's float32 master and moments are 80 GB);
# internvl2 at depth 2, 1.92 B parameters (the whole model's float32
# master and moments are 238 GB); mamba2 at depth 24 of its 48, to keep
# the script within its time budget (its steps were the longest: 1.7 s)
TRAIN_DEPTH = {"deepseek-v2-lite-16b": 3, "zamba2-7b": 13,
               "internvl2-26b": 2, "mamba2-370m": 24}
# S 2048 a row: internvl2's 256 patch embeddings and 1792 tokens;
# seamless's 2048 frames and 2048 decoder tokens (the reference's train
# batch, ``api.example_batch``)
TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2048, 2, 1e-3
# grad_check: gradients through the kernels' autograd Functions against
# autograd through the plain versions, the largest error over the
# gradient's largest magnitude: 1e-4 in float32, 2e-2 in bfloat16
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# flash (B, Sq, Sk, H, KV, d, causal, dtype[, v width]): internlm2's layer
# at B 1, and in bfloat16 also at the batch of its full-depth train steps,
# the dense smoke config's heads at S 256, and deepseek's MLA at its train
# steps' batch (v and o 128 wide beside q and k's 192, as on the path:
# "tc" in bfloat16, "mma" with v zero-padded in float32), zamba2's shared
# block at its train
# steps' batch in both dtypes, internvl2's (grok's group of 6: 48 heads
# over 8) at its train steps' batch in both dtypes (the float32 row the
# dtype its train cpu_check ran before that check's cut), and seamless's
# at its train steps' batch in
# both dtypes: the encoder's non-causal self-attention and a
# cross-attention of 500 decoder rows against 2048 encoder rows; SSD (b,
# Q, h, p, g, n): mamba2's chunks of
# one 2048-token sequence (16) and of its train steps' batch (8
# x 16), the SSM smoke config's chunk 8, and zamba2's train steps' chunks
# (4 x 16 at 112 heads, p 64, n 64).  Each forward output is also held
# against the plain version at FLASH_TOL / SSD_TOL.
_ED_B = TRAIN_BATCH["seamless-m4t-medium"]
FLASH_GRAD_SHAPES = [(1, 2048, 2048, 16, 8, 128, True, torch.bfloat16),
                     (TRAIN_BATCH["internlm2-1.8b"], 2048, 2048, 16, 8, 128,
                      True, torch.bfloat16),
                     (1, 2048, 2048, 16, 8, 128, True, torch.float32),
                     (2, 256, 256, 4, 2, 32, True, torch.bfloat16),
                     (2, 256, 256, 4, 2, 32, True, torch.float32),
                     (TRAIN_BATCH["deepseek-v2-lite-16b"], 2048, 2048, 16, 16,
                      192, True, torch.bfloat16, MLA_V_WIDTH),
                     (TRAIN_BATCH["deepseek-v2-lite-16b"], 2048, 2048, 16, 16,
                      192, True, torch.float32, MLA_V_WIDTH),
                     (TRAIN_BATCH["zamba2-7b"], 2048, 2048, 32, 32, 112,
                      True, torch.bfloat16),
                     (TRAIN_BATCH["zamba2-7b"], 2048, 2048, 32, 32, 112,
                      True, torch.float32),
                     (TRAIN_BATCH["internvl2-26b"], 2048, 2048, 48, 8, 128,
                      True, torch.bfloat16),
                     (TRAIN_BATCH["internvl2-26b"], 2048, 2048, 48, 8, 128,
                      True, torch.float32),
                     (_ED_B, 2048, 2048, 16, 16, 64, False, torch.bfloat16),
                     (_ED_B, 2048, 2048, 16, 16, 64, False, torch.float32),
                     (_ED_B, 500, 2048, 16, 16, 64, False, torch.bfloat16),
                     (_ED_B, 500, 2048, 16, 16, 64, False, torch.float32)]
SSD_GRAD_SHAPES = [(16, 128, 32, 64, 1, 128),
                   (TRAIN_BATCH["mamba2-370m"] * 16, 128, 32, 64, 1, 128),
                   (8, 8, 16, 16, 1, 16),
                   (TRAIN_BATCH["zamba2-7b"] * 16, 128, 112, 64, 1, 64)]
# train cpu_check: one float32 train step at full width and this depth,
# batch and length on the card and on the CPU from one state: loss 1e-4
# relative, grad norm 1e-3, each master leaf atol 1e-3 / rtol 3e-3 (the
# reference's allowance for a reordered first Adam step), and each leaf's
# gradient within TRAIN_GRAD_TOL of its largest magnitude (the CPU tests'
# tolerance for a gradient leaf against the reference)
TRAIN_CHECK_DEPTH, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 2, 256
# the hybrid's: one group and the tail (as its serving cpu_check), at B 1
# since tp_rank_hybrid came (its CPU step at B 2 took 22-24 s of the
# script; the batch dimension stays held by the other models' checks at
# B 2), and deepseek-v2-lite's at B 1 since the dry run came (its CPU step
# at B 2 took 26 s); the encoder-decoder's one layer and one encoder layer, at a
# smaller (batch, tokens) so that the CPU's step at its vocabulary
# (256,206) stays near 15 s, over TRAIN_CHECK_FRAMES frames.  Not internvl2 (cut for the time
# budget: its CPU step at depth 1 took 30-40 s of the script).  Without it
# the card checks neither the vlm loss nor the gradient through the
# patches: the transformer's train step is held by internlm2's train
# cpu_check, the patches' forward by internvl2's serving cpu_check, and
# the flash Function's backward at internvl2's train shape by grad_check
TRAIN_CHECK_DEPTHS = {"zamba2-7b": HYBRID_CHECK_DEPTH,
                      "seamless-m4t-medium": 1}
TRAIN_CHECK_SIZES = {"seamless-m4t-medium": (1, 256),
                     "zamba2-7b": (1, TRAIN_CHECK_SEQ),
                     "deepseek-v2-lite-16b": (1, TRAIN_CHECK_SEQ)}
TRAIN_CHECK_SKIP = ("internvl2-26b",)
TRAIN_CHECK_FRAMES = 512
TRAIN_GRAD_TOL = 1e-4
# restart: mamba2-370m at full width and this depth; a run with failures
# injected at RESTART_FAIL_AT, a checkpoint every RESTART_CKPT_EVERY steps,
# gives the uninterrupted run's losses within 1e-4 relative
RESTART_DEPTH, RESTART_BATCH, RESTART_SEQ = 4, 4, 512
RESTART_STEPS, RESTART_CKPT_EVERY, RESTART_FAIL_AT = 12, 5, (7, 11)


# lm_sharded: internlm2-1.8b on a 1-rank NCCL mesh (1, 1) ("data",
# "model") under decode_cp: the first SHARDED_REQUESTS of lm_dense's
# requests served (each prefill's logits within SHARDED_LOGIT_TOL of
# lm_dense's, its tokens equal or near-ties), then SHARDED_TRAIN_STEPS
# train steps at full width and SHARDED_TRAIN_DEPTH, B
# SHARDED_TRAIN_BATCH x TRAIN_SEQ, on the mesh against as many unsharded
# steps from one state (the train cpu_check's tolerances); its decode step
# timed SHARDED_DECODE_TIMED times each way
SHARDED_REQUESTS, SHARDED_LOGIT_TOL = 4, 1e-3
SHARDED_TRAIN_DEPTH, SHARDED_TRAIN_BATCH, SHARDED_TRAIN_STEPS = 4, 4, 2
SHARDED_DECODE_TIMED = 5

# tp_rank: internlm2-1.8b at full width and depth as rank 0 of a
# (1, TP_RANK_WAYS) ("data", "model") mesh over torch's fake process group
# (every collective returns at once and moves nothing, so no value is
# checked): one TP_RANK_PROMPT-token prefill (its flash kernel at
# TP_RANK_FLASH: the rank's 4 query heads and 2 KV heads) and
# TP_RANK_STEPS decode steps at LM_SLOTS slots of LM_MAX_LEN under
# decode_cp, timed; the rank's weights, peak memory and the prefill's
# device time by kind
TP_RANK_WAYS, TP_RANK_PROMPT, TP_RANK_STEPS = 4, 2048, 4
TP_RANK_FLASH = ((1, 2048, 4, 128), (1, 2048, 2, 128))
# tp_rank_hybrid: zamba2-7b the same way (81 Mamba layers with the mixer on
# the rank's 28 of 112 heads, the shared block 13 times on 8 of 32 heads):
# its flash kernel's q and k shapes (its SSD kernel's: TP_RANK_HYBRID_SSD)
TP_RANK_HYBRID_FLASH = ((1, 2048, 8, 112), (1, 2048, 8, 112))


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def fusable(plan_key: str) -> bool:
    """Whether the plan puts the analytic's tfidf -> knn on dense_array,
    the one chain that fuses."""
    engines = dict(_plan_from_key(plan_key).assignment)
    return all(engines[p] == "dense_array" for p in FUSED_TAIL)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# labels of device timings whose launches the host could not queue ahead of
# the card (their time may hold host gaps); emitted by the "total" phase
HOST_BEHIND = []
# cycles of torch.cuda._sleep per millisecond, at the H100's top clock
# (1.98 GHz), so that a sleep lasts at least as long as asked
SLEEP_CYCLES_PER_MS = 1.98e6


def time_ms(fn, dev, n: int = 50, warmup: int = 5, label: str = "") -> float:
    """Device milliseconds of one call of ``fn``: CUDA events around ``n``
    back-to-back calls after ``warmup``, one synchronize, the elapsed time
    over ``n`` (the host clock elsewhere).  Before the start event the card
    sleeps for longer than the host takes to queue the ``n`` calls (from the
    warm-up's host time), so a call whose host work outlasts its kernel is
    still timed back to back on the device; if the start event has already
    passed when the last call is queued, ``label`` goes to HOST_BEHIND.
    The host's time a call is the median of the warm-up calls but the
    first: the first call's one-time work (a library's plan build, a module
    load) would otherwise lengthen the sleep by 2 ``n`` / ``warmup`` times
    itself.  ``fn`` takes the call's index, so that a caller can rotate
    inputs."""
    host = []
    for i in range(warmup):
        t0 = time.perf_counter()
        fn(i)
        host.append((time.perf_counter() - t0) * 1e3)
    host_ms = statistics.median(host[1:] or host)
    sync(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(SLEEP_CYCLES_PER_MS * (2 * n * host_ms + 5)))
        start.record()
        for i in range(n):
            fn(i)
        end.record()
        if start.query():
            HOST_BEHIND.append(label or getattr(fn, "__name__", "?"))
        end.synchronize()
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    return (time.perf_counter() - t0) * 1e3 / n


def call_ms(fn, dev, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of one call of ``fn`` (no arguments) with a
    synchronize after it: CUDA events around each call on the card, the
    host clock elsewhere.  For a call of tens of microseconds this is the
    wrapper's and the launch's host time, what the path pays per call."""
    for _ in range(warmup):
        fn()
    sync(dev)
    times = []
    for _ in range(iters):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound_ms(nbytes: float, ops_count: float, units: str,
             beside: tuple = ()) -> dict:
    """The least milliseconds of a call and what bounds it: bytes over the
    HBM rate vs operations at the peak rate of ``units`` (a key of
    PEAK_OPS_PER_S); the bytes' time and the operations' time at ``units``
    and at each of ``beside`` go with it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = {u: ops_count / PEAK_OPS_PER_S[u] * 1e3 for u in (units, *beside)}
    return {"bound_ms": max(t_bytes, t_ops[units]),
            "bound_by": "bytes" if t_bytes >= t_ops[units] else "operations",
            "bound_bytes_ms": t_bytes,
            **{f"bound_ops_{u}_ms": t for u, t in t_ops.items()}}


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.float() - b.float()).abs().max())


# -- phases -------------------------------------------------------------------

def phase_device(dev) -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    cap = torch.cuda.get_device_capability(dev)
    check(tuple(cap) == (9, 0), f"need an sm_90 card, got capability {cap}")
    t0 = time.perf_counter()
    # one nvcc per source, all at once
    _build.build(["haar", "knn", "flash_attention", "ssd_scan",
                  "decode_attention"])
    build_s = time.perf_counter() - t0
    # each kernel's registers and spills, and any wgmma that ptxas had to
    # serialize (C7510, C7513, C7520: a register of an in-flight wgmma
    # touched, a wgmma under a condition); a serialized wgmma fails the run
    ptxas = {name: [line.strip() for line in log.splitlines()
                    if "registers" in line or "spill" in line
                    or "Function properties" in line or "C75" in line]
             for name, log in _build.build_log.items()}
    serialized = [line for lines in ptxas.values() for line in lines
                  if "C75" in line]
    check(not serialized, f"ptxas serialized wgmma: {serialized}")
    # each tensor-core flash instantiation's registers and shared memory
    # against the layouts that kernels/flash_attention.py mirrors; the
    # bfloat16 kernel's block must start with registers enough for
    # setmaxnreg's 240 a consumer thread and 24 a producer thread
    occupancy = {"tc": {f"{d}/{dv}": tc_occupancy(d, "tc", dv)
                        for d, dvs in TC_WIDTHS.items() for dv in dvs},
                 "tf32": {str(d): tc_occupancy(d, "tf32")
                          for d in TF32_HEAD_DIMS}}
    for d in TF32_HEAD_DIMS:
        got = occupancy["tf32"][str(d)]["smem_bytes"]
        check(got == tf32_smem_bytes(d),
              f"flash tf32 d {d}: {got} bytes of shared memory, the layout "
              f"says {tf32_smem_bytes(d)}")
    for key, got in occupancy["tc"].items():
        d, dv = map(int, key.split("/"))
        check(got["smem_bytes"] == tc_smem_bytes(d, dv),
              f"flash tc {key}: {got['smem_bytes']} bytes of shared memory, "
              f"the layout says {tc_smem_bytes(d, dv)}")
        check(got["registers"] * 384 >= 240 * 256 + 24 * 128,
              f"flash tc {key}: {got['registers']} registers a thread, too "
              f"few for setmaxnreg")
    info = {"card": card, "capability": list(cap),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "build_s": round(build_s, 3),
            "flash_attention_nvcc_s": round(
                _build.build_seconds.get("flash_attention", 0.0), 3),
            "build_s_each": {k: round(v, 3)
                             for k, v in _build.build_seconds.items()},
            "ptxas": ptxas, "flash_tc_occupancy": occupancy}
    emit("device", **info)
    return info


def phase_haar(dev, shapes=HAAR_SHAPES) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    main = {}
    for n, t, levels in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((n, t), generator=gen, device=dev).to(dtype)
            got = haar_cuda(x, levels)
            want = haar_ref(x, levels)
            sync(dev)
            err = max_abs_err(got, want)
            rtol, atol = HAAR_TOL[dtype]
            ok = torch.allclose(got.float(), want.float(), rtol=rtol,
                                atol=atol)
            check(ok, f"haar {n}x{t} L{levels} {dtype}: max err {err}")
            row = {"shape": [n, t], "levels": levels,
                   "dtype": str(dtype).replace("torch.", ""),
                   "max_abs_err": err,
                   "bitwise": bool(torch.equal(got, want))}
            if (n, t, levels) == shapes[0]:
                # 256 MB in and out: every launch reads from device memory
                tag = f"haar {dtype}"
                row["ms"] = time_ms(lambda i: haar_cuda(x, levels), dev,
                                    label=tag)
                row["plain_ms"] = time_ms(lambda i: haar_ref(x, levels), dev,
                                          label=f"{tag} plain")
                row["call_ms"] = call_ms(lambda: haar_cuda(x, levels), dev)
                row.update(bound_ms(2.0 * x.numel() * x.element_size(),
                                    4.0 * x.numel(), UNITS[dtype]))
                if dtype == torch.float32:
                    main = dict(row)
            emit("haar", **row)
    return main


def phase_knn(dev, shapes=KNN_SHAPES, k: int = K) -> dict:
    """Both kernels against the plain version at every shape; returns the
    timed float32 rows by B (1: the analytic's gemv, 64: the serving
    phase's tiled)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    main = {}
    for n, v, b in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            train = torch.randn((n, v), generator=gen, device=dev).to(dtype)
            test = torch.randn((b, v), generator=gen, device=dev).to(dtype)
            got = knn_scores_cuda(train, test)
            want = knn_scores_ref(train, test)
            sync(dev)
            err = max_abs_err(got, want)
            rtol, atol = KNN_TOL[dtype]
            check(torch.allclose(got, want, rtol=rtol, atol=atol),
                  f"knn_scores {n}x{v} B{b} {dtype}: max err {err}")
            row = {"shape": {"N": n, "V": v, "B": b},
                   "dtype": str(dtype).replace("torch.", ""),
                   "variant": knn_variant(b), "max_abs_err": err}
            if dtype == torch.float32:
                kk = min(k, n)
                idx_k = torch.topk(got, kk, dim=-1)[1]
                idx_p = torch.topk(want, kk, dim=-1)[1]
                check(torch.equal(idx_k, idx_p),
                      f"knn top-{kk} indices differ at {n}x{v} B{b}")
                row["topk_equal"] = True
            if (n, v) == shapes[0][:2] and b in (1, 64):
                # the path reads train cold (a 256 MB Haar pass precedes
                # it): rotate through copies that exceed the L2 twice
                copies = math.ceil(2 * L2_BYTES
                                   / (train.numel() * train.element_size()))
                trains = [train.clone() for _ in range(copies)]
                row["l2_copies"] = copies
                tag = f"knn B{b} {dtype}"
                row["ms"] = time_ms(lambda i: knn_scores_cuda(
                    trains[i % copies], test), dev, label=tag)
                row["plain_ms"] = time_ms(lambda i: knn_scores_ref(
                    trains[i % copies], test), dev, label=f"{tag} plain")
                row["library_ms"] = time_ms(lambda i: torch.matmul(
                    test, trains[i % copies].t()), dev,
                    label=f"{tag} library")
                row["call_ms"] = call_ms(lambda: knn_scores_cuda(train, test),
                                         dev)
                del trains
                nbytes = (n * v + b * v) * train.element_size() + b * n * 4
                # the tensor-core kernel does float32 as 3xTF32
                units = UNITS[dtype]
                if units == "f32" and knn_variant(b) == "tiled":
                    units = "3xtf32"
                row.update(bound_ms(nbytes, 2.0 * b * n * v, units,
                                    ("f32", "3xtf32") if units != "bf16"
                                    else ()))
                if dtype == torch.float32:
                    main[b] = dict(row)
            emit("knn", **row)
    return main


def _sdpa_layout(q, k, v):
    """q, k, v in ``scaled_dot_product_attention``'s (B, H, S, d), KV heads
    expanded, laid out before the yardstick is timed."""
    if q.ndim == 3:
        return tuple(t.unsqueeze(0) for t in (q, k, v))
    rep = q.shape[2] // k.shape[2]
    return (q.transpose(1, 2).contiguous(),
            *(torch.repeat_interleave(t, rep, dim=2).transpose(1, 2)
              .contiguous() for t in (k, v)))


def _kernel_names(fn, dev) -> list:
    """Names of the device kernels that one call of ``fn`` (warmed up)
    launches, from ``torch.profiler``; none off the card."""
    if dev.type != "cuda":
        return []
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync(dev)
    return sorted({e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def _flash_units(kind: str, dtype) -> str:
    """The units whose peak rate bounds a flash kernel's operations: the
    tensor cores in bfloat16 or as 3xTF32, or the CUDA cores in float32."""
    if kind == "simt":
        return "f32"
    return "bf16" if dtype == torch.bfloat16 else "3xtf32"


def _flash_out_check(got, q, k, v, causal, label) -> dict:
    """A flash kernel's output against the plain version on the same inputs
    at FLASH_TOL; a bfloat16 output also against the plain version in
    float32, at FLASH_BF16_VS_F32_TOL.  Returns the errors."""
    dtype = q.dtype
    with torch.no_grad():
        want = flash_attention_ref(q, k, v, causal=causal)
    err, tol = max_abs_err(got, want), FLASH_TOL[dtype]
    check(got.dtype == dtype and got.shape == (*q.shape[:-1], v.shape[-1]),
          f"{label}: {got.dtype} {tuple(got.shape)}")
    check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
          f"{label}: max err {err}")
    row = {"max_abs_err": err, "tol": tol}
    if dtype == torch.bfloat16:
        del want
        with torch.no_grad():
            want32 = flash_attention_ref(q.float(), k.float(), v.float(),
                                         causal=causal)
        err32 = max_abs_err(got, want32)
        check(err32 <= FLASH_BF16_VS_F32_TOL,
              f"{label} bfloat16 vs float32 plain: max err {err32}")
        row["max_abs_err_vs_f32"] = err32
        row["tol_vs_f32"] = FLASH_BF16_VS_F32_TOL
    return row


def phase_flash(dev, shapes=FLASH_SHAPES, gqa_shapes=FLASH_GQA_SHAPES,
                timed_at=FLASH_TIMED, narrow_kv=FLASH_NARROW_KV) -> dict:
    """Every kernel against the plain version in both layouts: each shape on
    the kernel that ``variant`` names, through the entry point
    (``ops.flash_attention``), and forced on the CUDA-core kernel where the
    warp-level kernel takes the shape, or a wgmma kernel in float32;
    ``narrow_kv``'s shapes with k and v narrowed views of wider tensors.
    Returns the rows that ``timed_at`` names, timed beside the plain version
    and SDPA ("tc" rows with the split over keys that ``split_plan`` makes
    on this card), and under "entry_launches" the launches of the
    entry-point calls (the CUDA-core kernel's only caller on the card
    now)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count \
        if dev.type == "cuda" else 132

    def full(shape):
        """(B, Sq, Sk, H, KV, d, causal, dtype, v width)"""
        return (*shape[:8], shape[8] if len(shape) > 8 else shape[5])
    # both forms as (shape as given, form, narrowed KV (whole heads,
    # first head) or None, B, Sq, Sk, H, KV, d, causal, dtype, v width);
    # (BH, S, d) is B 1 with H = KV = BH for the work it does
    cases = ([(shape, "BH,S,d", None, 1, *shape[1:3], shape[0], shape[0],
               *shape[3:], shape[3]) for shape in shapes]
             + [(shape, "B,S,H,d", None, *full(shape))
                for shape in gqa_shapes]
             + [(shape, "B,S,H,d", (whole, kv0), *full(shape))
                for shape, whole, kv0 in narrow_kv])
    timed = {}
    entry = dict.fromkeys(ops.LAUNCHES, 0)
    for given, form, narrow, b, sq, sk, h, kv, d, causal, dtype, dv in cases:
        rnd = lambda *shape: torch.randn(shape, generator=gen,
                                         device=dev).to(dtype)
        if narrow:
            whole, kv0 = narrow
            q = rnd(b, sq, h, d)
            k = rnd(b, sk, whole, d).narrow(2, kv0, kv)
            v = rnd(b, sk, whole, dv).narrow(2, kv0, kv)
            shape = {"B": b, "Sq": sq, "Sk": sk, "H": h, "KV": kv, "d": d,
                     "KV_of": whole, "KV_from": kv0}
        elif form == "B,S,H,d":
            q, k, v = rnd(b, sq, h, d), rnd(b, sk, kv, d), rnd(b, sk, kv, dv)
            shape = {"B": b, "Sq": sq, "Sk": sk, "H": h, "KV": kv, "d": d}
        else:
            q, k, v = rnd(h, sq, d), rnd(h, sk, d), rnd(h, sk, d)
            shape = {"BH": h, "Sq": sq, "Sk": sk, "d": d}
        if dv != d:
            shape["dv"] = dv
        fits = variant(dtype, d)
        kinds = [fits]
        if fits == "mma" or (dtype == torch.float32 and fits != "simt"):
            kinds.append("simt")
        for kind in kinds:
            t_row = time.perf_counter()
            label = f"flash {kind} {shape} causal={causal} {dtype}"
            if kind == fits:
                ops.reset_launches()
                got = ops.flash_attention(q, k, v, causal=causal)
                for key, n in counters.read(ops.LAUNCHES).items():
                    entry[key] += n
            else:
                got = flash_attention_cuda(q, k, v, causal=causal, kind=kind)
            sync(dev)
            row = {"form": form, "shape": shape, "causal": causal,
                   "dtype": str(dtype).replace("torch.", ""),
                   "variant": kind,
                   **_flash_out_check(got, q, k, v, causal, label)}
            if (given, kind) in timed_at:
                name = timed_at[given, kind]
                tag = f"flash {name}"
                ql, kl, vl = _sdpa_layout(q, k, v)
                run = lambda i, kind=kind: flash_attention_cuda(
                    q, k, v, causal=causal, kind=kind)
                row["ms"] = time_ms(run, dev, label=tag)
                row["plain_ms"] = time_ms(lambda i: flash_attention_ref(
                    q, k, v, causal=causal), dev, label=f"{tag} plain")
                library = lambda i=0: \
                    torch.nn.functional.scaled_dot_product_attention(
                        ql, kl, vl, is_causal=causal)
                t1 = time.perf_counter()
                library()
                sync(dev)
                # the library's first call at a shape (its plan's build)
                row["library_first_call_s"] = time.perf_counter() - t1
                row["library_ms"] = time_ms(library, dev,
                                            label=f"{tag} library")
                row["library_kernels"] = _kernel_names(library, dev)
                row["call_ms"] = call_ms(lambda: run(0), dev)
                nbytes, ops_count = flash_work(b, sq, sk, h, kv, d, causal,
                                                q.element_size(), dv)
                units = _flash_units(kind, dtype)
                row.update(bound_ms(nbytes, ops_count, units,
                                    () if units == "bf16"
                                    else ("f32", "3xtf32")))
                row["v_width"] = dv
                if kind == "tc":
                    # (chunks, key tiles a chunk): (1, ...) is no split
                    row["split"] = list(split_plan(b, h, sq, sk, causal,
                                                   sms, tc_key_tile(d, dv)))
                    row["key_tile"] = tc_key_tile(d, dv)
                del ql, kl, vl
                timed[name] = dict(row)
            row["seconds"] = time.perf_counter() - t_row
            emit("flash_attention", **row)
    emit("flash_attention_entry", launches=entry)
    if dev.type == "cuda":
        used = {variant(c[10], c[8]) for c in cases}
        check(all(entry[f"flash_attention_{kind}"] > 0 for kind in used),
              f"flash entry launches {entry}, want each of {sorted(used)}")
    timed["entry_launches"] = entry
    return timed


SSD_OUTPUTS = ("y", "states", "decay")


def _ssd_out_check(got, want, label) -> tuple:
    """An SSD kernel's (y, states, decay) against the plain version in
    float64 (``want``) at SSD_TOL, the absolute tolerance of y and states
    scaled by their largest |value|.  Returns (errors, absolute
    tolerances)."""
    errs, atols = [], []
    for name, a, w, (rtol, atol) in zip(SSD_OUTPUTS, got, want, SSD_TOL):
        check(a.dtype == torch.float32 and a.shape == w.shape,
              f"{label} {name} {a.dtype} {tuple(a.shape)}")
        if name != "decay":
            atol *= float(w.abs().max())
        errs.append(max_abs_err(a, w))
        atols.append(atol)
        check(torch.allclose(a.double(), w, rtol=rtol, atol=atol),
              f"{label} {name}: max err {errs[-1]}, atol {atol}")
    return errs, atols


def phase_ssd(dev, shapes=SSD_SHAPES, timed_at=SSD_TIMED) -> dict:
    """Both kernels against the plain version in float64.  Returns the rows
    that ``timed_at`` names, timed beside the plain version."""
    gen = torch.Generator(device=dev).manual_seed(3)
    timed = {}
    for b, q, h, p, g, n in shapes:
        x = torch.randn((b, q, h, p), generator=gen, device=dev)
        da = -torch.nn.functional.softplus(
            torch.randn((b, q, h), generator=gen, device=dev))
        # B and C at unit scale: C·Bᵀ sums n products, so y is of order
        # 100 at n = 128; the tolerance scales with the output
        B = torch.randn((b, q, g, n), generator=gen, device=dev)
        C = torch.randn((b, q, g, n), generator=gen, device=dev)
        want = ssd_intra_ref(*(t.double() for t in (x, da, B, C)))
        plain32 = ssd_intra_ref(x, da, B, C)
        kinds = ["tc", "simt"] if ssd_variant(q, p, n) == "tc" else ["simt"]
        for kind in kinds:
            got = ssd_intra_cuda(x, da, B, C, kind=kind)
            sync(dev)
            errs, atols = _ssd_out_check(
                got, want, f"ssd {kind} at {(b, q, h, p, g, n)}")
            row = {"shape": {"b": b, "Q": q, "h": h, "p": p, "g": g, "n": n},
                   "variant": kind, "dtype": "float32",
                   "max_abs_err": max(errs),
                   "max_abs_err_each": dict(zip(SSD_OUTPUTS, errs)),
                   "atol_each": dict(zip(SSD_OUTPUTS, atols)),
                   "max_abs_each": {nm: float(w.abs().max())
                                    for nm, w in zip(SSD_OUTPUTS, want)},
                   "plain_f32_max_abs_err_each": {
                       nm: max_abs_err(a, w)
                       for nm, a, w in zip(SSD_OUTPUTS, plain32, want)}}
            name = timed_at.get(((b, q, h, p, g, n), kind))
            if name:
                run = lambda i, kind=kind: ssd_intra_cuda(x, da, B, C,
                                                          kind=kind)
                row["ms"] = time_ms(run, dev, label=f"ssd {name}")
                row["plain_ms"] = time_ms(
                    lambda i: ssd_intra_ref(x, da, B, C), dev,
                    label=f"ssd {name} plain")
                row["call_ms"] = call_ms(lambda: run(0), dev)
                row["library_ms"] = None          # no single PyTorch call
                # 3xTF32 on the tensor cores takes the operations below the
                # bytes: the tensor-core kernel's bound is the bytes
                units = "3xtf32" if kind == "tc" else "f32"
                row.update(bound_ms(*ssd_work(b, q, h, p, g, n), units,
                                    ("f32", "3xtf32")))
                timed[name] = dict(row)
            emit("ssd_intra", **row)
    return timed


def phase_decode(dev, shape=DECODE_SHAPE) -> dict:
    """The decode kernel at the decode cell's step (``DECODE_SHAPE``) against
    the plain version, timed beside it, beside SDPA over the repeated heads
    with the positions' mask (``library_ms``: a yardstick only, the port
    never calls it) and beside its byte bounds: the K and V rows up to each
    position (``bound_ms``) and the whole cache (``bound_cache_ms``)."""
    b, s, h, kv, d = shape
    gen = torch.Generator(device=dev).manual_seed(DECODE_POS_SEED)
    q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, s, kv, d), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    rng = np.random.default_rng(DECODE_POS_SEED)
    prompt, out = rng.integers(64, 513, b), rng.integers(256, 1025, b)
    at = np.minimum(prompt + (rng.random(b) * out).astype(np.int64), s - 1)
    pos = torch.from_numpy(at.astype(np.int32)).to(dev)
    got = decode_attention_cuda(q, k, v, pos)
    err = max_abs_err(got, decode_attention_ref(q, k, v, pos))
    err32 = max_abs_err(got, decode_attention_ref(q.float(), k.float(),
                                                  v.float(), pos))
    tol = FLASH_TOL[torch.bfloat16]
    check(err <= tol and err32 <= DECODE_BF16_VS_F32_TOL,
          f"decode_attention at {shape}: off the plain version by {err} "
          f"(tol {tol}), by {err32} in float32 (tol "
          f"{DECODE_BF16_VS_F32_TOL})")
    rows = int((at + 1).sum())
    row = {"shape": {"B": b, "S": s, "H": h, "KV": kv, "d": d},
           "dtype": "bfloat16", "rows": rows, "pos_mean": float(at.mean()),
           "max_abs_err": err, "max_abs_err_f32": err32,
           "tol": tol, "tol_f32": DECODE_BF16_VS_F32_TOL}
    run = lambda i: decode_attention_cuda(q, k, v, pos)
    row["ms"] = time_ms(run, dev, label="decode_attention")
    row["plain_ms"] = time_ms(lambda i: decode_attention_ref(q, k, v, pos),
                              dev, n=10, label="decode_attention plain")
    ke, ve = (t.repeat_interleave(h // kv, 2).transpose(1, 2)
              for t in (k, v))
    mask = (torch.arange(s, device=dev)[None, :]
            <= pos[:, None])[:, None, None, :]
    row["library_ms"] = time_ms(
        lambda i: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], ke, ve, attn_mask=mask), dev, n=10,
        label="decode_attention library")
    del ke, ve
    row["call_ms"] = call_ms(lambda: run(0), dev)
    # bytes: each K and V row up to the position once, q read and the
    # output written; operations: 2 G d a row for the scores and again
    # for the weighted sum, each of kv heads
    elem = q.element_size()
    nbytes = 2 * rows * kv * d * elem + 2 * q.numel() * elem
    row.update(bound_ms(nbytes, 4 * rows * h * d, "f32"))
    row["bound_cache_ms"] = 2 * k.numel() * elem / HBM_BYTES_PER_S * 1e3
    emit("decode_attention", **row)
    return row


def phase_quickstart(dev, state_dir: str) -> dict:
    """The quickstart's query at its sizes: train (with the cost model
    calibrated on the card), persist, restart warm and serve production
    four times with zero plan enumerations."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(256, 256)).astype(np.float32)
    B = rng.normal(size=(256, 64)).astype(np.float32)

    def session():
        s = connect(os.path.join(state_dir, "monitor.json"), device=dev,
                    explore_budget=0.5, calibrate=True)
        s.register("A", DenseTensor(torch.from_numpy(A)), engine="columnar")
        s.register("B", DenseTensor(torch.from_numpy(B)),
                   engine="dense_array")
        for name in ("A", "B"):
            for leaf in _leaves(s.catalog[name].obj):
                check(leaf.device.type == dev.type,
                      f"catalog {name} not on {dev}")
        return s

    ops.reset_launches()
    t0 = time.perf_counter()
    s = session()
    res = s.execute(QUICKSTART, mode="training")
    train_s = time.perf_counter() - t0
    s.persist()
    enumerations = []
    real_dp = mw.dp_plans

    def counting_dp(*a, **kw):
        enumerations.append(1)
        return real_dp(*a, **kw)

    mw.dp_plans = counting_dp
    try:
        s2 = session()
        # isolate the restart from online re-planning (its trigger is
        # millisecond timing noise here) and from usage-drift retraining
        # (peak RSS only grows in one process), as the reference's serving
        # tests and benchmarks do
        s2.bigdawg.replan_factor = float("inf")
        s2.bigdawg.monitor.DRIFT_THRESHOLD = float("inf")
        served = [s2.execute(QUICKSTART) for _ in range(4)]
        s2.bigdawg.drain_explorations()
    finally:
        mw.dp_plans = real_dp
    launches = counters.read(ops.LAUNCHES)
    out = served[-1].value.data
    want = np.where((A >= -0.5) & (A <= 2.0), A, 0.0) @ B
    err = float(np.abs(out.cpu().numpy() - want).max()) \
        if tuple(out.shape) == want.shape else None
    row = {"train_plan": res.plan_key, "plans_tried": res.report.plans_tried,
           "train_s": train_s,
           "served": [{"mode": r.mode, "plan": r.plan_key,
                       "ms": r.seconds * 1e3,
                       "predicted_ms": r.report.predicted_s * 1e3,
                       "cache_hit": r.report.cache_hit,
                       "replanned": r.report.replanned,
                       "explored": r.report.explored_key} for r in served],
           "enumerations": len(enumerations), "max_abs_err": err,
           "calibrated": s2.bigdawg.cost_model.calibrated,
           "launches": launches}
    emit("quickstart", **row)
    check(out.device.type == dev.type, f"quickstart result on {out.device}")
    check(tuple(out.shape) == (256, 64), f"quickstart shape {out.shape}")
    check(bool(torch.isfinite(out).all()), "quickstart result not finite")
    check(err <= 1e-3, f"quickstart differs from numpy by {err}")
    check(all(r.mode == "production" for r in served),
          f"warm restart modes {[r.mode for r in served]}")
    check(not enumerations, f"warm restart enumerated {len(enumerations)}x")
    return row


def _leaves(obj):
    from repro_torch.core.tables import leaves
    return [x for x in leaves(obj) if isinstance(x, torch.Tensor)]


def analytic_data(dev, n_train=N_TRAIN, n_test=N_TEST,
                  samples=SAMPLES) -> dict:
    """The analytic's patients from ``ecg_waveforms(seed=0)``: training
    waveforms and labels on the host, and the test patients' histograms on
    ``dev``, made with the plain Haar (data preparation, as the example
    does; no kernel launch)."""
    t0 = time.perf_counter()
    waves, labels = ecg_waveforms(n_train + n_test, samples, seed=0)
    test_w = waves[n_train:]
    test_hists = ENGINES["dense_array"].run(
        "bin_hist", {"nbins": NBINS, "levels": LEVELS},
        DenseTensor(haar_ref(torch.from_numpy(test_w).to(dev), LEVELS)),
        device=dev).data
    return {"train_w": waves[:n_train], "train_y": labels[:n_train],
            "test_y": labels[n_train:], "test_hists": test_hists,
            "samples": samples, "seconds": time.perf_counter() - t0}


def phase_analytic(dev, data, train_plans=36, cpu_checks=4,
                   compare_serves=FUSE_COMPARE_SERVES) -> dict:
    """The §IV-B analytic through connect(): training on the first test
    patient, production for the rest, with plan-level fusion on (the
    default: tfidf -> knn as one CUDA graph replay); accuracy must beat the
    majority class by the example's margin."""
    t0 = time.perf_counter()
    train_w, train_y, test_y = data["train_w"], data["train_y"], \
        data["test_y"]
    test_hists = data["test_hists"]
    n_train, n_test = len(train_w), len(test_y)
    s = connect(device=dev, train_plans=train_plans)
    # a one-shot run: usage drift (peak RSS grows as training casts 67M-row
    # tables) must not re-train mid-run, as the repo's benchmarks pin it
    s.bigdawg.monitor.DRIFT_THRESHOLD = float("inf")
    s.register("waves", DenseTensor(torch.from_numpy(train_w)),
               engine="dense_array")
    check(s.catalog["waves"].obj.data.device.type == dev.type,
          "waves not homed on the session device")
    setup_s = time.perf_counter() - t0 + data["seconds"]

    ops.reset_launches()
    results, seconds = [], []
    for i in range(n_test):
        s.register("test_hist", DenseTensor(test_hists[i:i + 1]),
                   engine="dense_array")
        t1 = time.perf_counter()
        res = s.execute(ANALYTIC)
        seconds.append(time.perf_counter() - t1)
        results.append(res)
    launches = counters.read(ops.LAUNCHES)

    correct = 0
    for i, res in enumerate(results):
        nb = res.value.data
        check(nb.device.type == dev.type, f"result on {nb.device}")
        check(nb.dtype == torch.int32 and tuple(nb.shape) == (1, K),
              f"result {nb.dtype} {tuple(nb.shape)}")
        pred = int(np.round(train_y[nb[0].cpu().numpy()].mean()))
        correct += int(pred == test_y[i])
    acc = correct / n_test
    base = max(test_y.mean(), 1 - test_y.mean())
    check(acc > base + 0.05, f"accuracy {acc} does not beat {base} + 0.05")
    modes = [r.mode for r in results]
    check(modes[0] == "training", f"first query mode {modes[0]}")
    if dev.type == "cuda":
        # one test patient a query: the matrix-vector kNN kernel
        check(launches["haar"] > 0 and launches["knn_scores"] > 0
              and launches["knn_scores_gemv"] == launches["knn_scores"],
              f"main path did not launch both kernels: {launches}")
    prod = [sec for sec, m in zip(seconds, modes) if m == "production"]
    # every production serve whose plan puts tfidf -> knn on dense_array
    # ran it as one fused segment, and no capture or replay fell back (a
    # broken segment would hide one)
    prod_res = [r for r in results if r.mode == "production"]
    wrong = [(r.plan_key, r.fused_segments) for r in prod_res
             if bool(r.fused_segments) != fusable(r.plan_key)]
    broken = fuseplan.broken_keys()
    check(s.bigdawg.fusion_fallbacks == 0 and not broken,
          f"analytic fusion fell back {s.bigdawg.fusion_fallbacks}x, "
          f"broken segments {broken}")
    fused_serves = sum(bool(r.fused_segments) for r in prod_res)
    check(fused_serves > 0 and not wrong,
          f"analytic fused {fused_serves} of {len(prod_res)} production "
          f"serves; fused where the plan says otherwise: {wrong}")
    stage_ms = _stage_ms(dev, s.catalog["waves"].obj,
                         DenseTensor(test_hists[:1]))
    row = {"patients": {"train": n_train, "test": n_test,
                        "samples": data["samples"]},
           "levels": LEVELS, "nbins": NBINS, "k": K,
           "train_plans": train_plans, "setup_s": setup_s,
           "training_s": seconds[0],
           "plans_tried": results[0].report.plans_tried,
           "production_plan": results[-1].plan_key,
           "production_queries": len(prod),
           "production_ms_median": statistics.median(prod) * 1e3
           if prod else None,
           "production_ms_mean": statistics.mean(prod) * 1e3
           if prod else None,
           "fused_serves": fused_serves,
           "fusable_plans": sorted({r.plan_key for r in prod_res
                                    if fusable(r.plan_key)}),
           "other_plans": sorted({r.plan_key for r in prod_res
                                  if not fusable(r.plan_key)}),
           "fusion_fallbacks": s.bigdawg.fusion_fallbacks,
           "broken_keys": broken,
           "fused_segments": [list(seg) for seg in results[-1].fused_segments],
           "stage_ms": stage_ms,
           "accuracy": acc, "baseline": base, "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9
           if dev.type == "cuda" else None}
    row["cpu_check"] = _cpu_check(results[-1].plan_key, train_w, test_hists,
                                  results, cpu_checks)
    row["fuse_compare"] = _fuse_compare(s, test_hists, compare_serves)
    emit("analytic", **row)
    return row


def _fuse_compare(s, test_hists, n: int) -> dict:
    """Production ms of the analytic with fusion on and off, alternating
    serve by serve over the first ``n`` test patients (after the main
    path's counts were read); on one plan both must give the same
    neighbours."""
    ms = {True: [], False: []}
    for i in range(n):
        s.register("test_hist", DenseTensor(test_hists[i:i + 1]),
                   engine="dense_array")
        got = {}
        for fuse in (True, False):
            s.bigdawg.fuse = fuse
            t0 = time.perf_counter()
            res = s.execute(ANALYTIC)
            ms[fuse].append((time.perf_counter() - t0) * 1e3)
            check(res.mode == "production" and bool(res.fused_segments)
                  == (fuse and fusable(res.plan_key)),
                  f"fuse={fuse}: {res.mode} on {res.plan_key}, segments "
                  f"{res.fused_segments}")
            got[fuse] = (res.plan_key, res.value.data)
        check(got[True][0] != got[False][0]
              or torch.equal(got[True][1], got[False][1]),
              f"patient {i}: fused and unfused neighbours differ")
    s.bigdawg.fuse = True
    return {"serves": n,
            "fused_ms_median": statistics.median(ms[True]),
            "unfused_ms_median": statistics.median(ms[False]),
            "fused_ms": ms[True], "unfused_ms": ms[False]}


def _stage_ms(dev, waves, test_hist) -> dict:
    """One-call time of each dense_array op of the production plan at the
    analytic's shapes, host work included (after the main path's counts
    were read)."""
    eng = ENGINES["dense_array"]
    hist_attrs = {"nbins": NBINS, "levels": LEVELS}
    coeffs = eng.run("haar", {"levels": LEVELS}, waves, device=dev)
    hist = eng.run("bin_hist", hist_attrs, coeffs, device=dev)
    feats = eng.run("tfidf", {}, hist, device=dev)
    return {
        "haar": call_ms(lambda: eng.run("haar", {"levels": LEVELS}, waves,
                                        device=dev), dev, iters=10),
        "bin_hist": call_ms(lambda: eng.run("bin_hist", hist_attrs, coeffs,
                                            device=dev), dev, iters=10),
        "tfidf": call_ms(lambda: eng.run("tfidf", {}, hist, device=dev),
                         dev, iters=10),
        "knn": call_ms(lambda: eng.run("knn", {"k": K}, feats, test_hist,
                                       device=dev), dev, iters=10),
    }


def _cpu_check(plan_key: str, train_w, test_hists, results, n: int) -> dict:
    """The production plan run with device="cpu" on the same data must give
    the same neighbours for the first ``n`` test patients; an index that
    differs must be a near-tie (score within 1e-5 relative of the k-th)."""
    cpu = torch.device("cpu")
    s = connect(device="cpu")
    s.register("waves", DenseTensor(torch.from_numpy(train_w)),
               engine="dense_array")
    plan = _plan_from_key(plan_key)
    q = bigdawg(ANALYTIC)
    feats = ENGINES["dense_array"].run(
        "tfidf", {}, ENGINES["dense_array"].run(
            "bin_hist", {"nbins": NBINS, "levels": LEVELS},
            DenseTensor(haar_ref(torch.from_numpy(train_w), LEVELS)),
            device=cpu), device=cpu).data
    differing, near_ties = 0, 0
    for i in range(n):
        th = test_hists[i:i + 1].cpu()
        s.register("test_hist", DenseTensor(th), engine="dense_array")
        res = execute_plan(q, plan, s.catalog, device="cpu")
        cpu_idx = set(res.value.data[0].tolist())
        gpu_idx = set(results[i].value.data[0].cpu().tolist())
        if cpu_idx == gpu_idx:
            continue
        scores = knn_scores_ref(feats, th)[0]
        kth = float(torch.topk(scores, K)[0][-1])
        for j in cpu_idx ^ gpu_idx:
            differing += 1
            check(abs(float(scores[j]) - kth) <= 1e-5 * abs(kth),
                  f"patient {i}: neighbour {j} differs and is no near-tie")
            near_ties += 1
    return {"patients": n, "plan": plan_key, "differing": differing,
            "near_ties": near_ties}


# -- polystore serving ------------------------------------------------------

def _same_neighbours(got, want, feats, test, what: str) -> int:
    """``got`` and ``want`` (B, K) indices hold the same neighbours for every
    row, or differ only in near-ties (a score within 1e-5 relative of the
    row's k-th, from the plain scores of ``feats`` and ``test``); returns
    how many indices differ."""
    if torch.equal(got, want):
        return 0
    scores = knn_scores_ref(feats, test)
    differing = 0
    for r in range(got.shape[0]):
        a, b = set(got[r].tolist()), set(want[r].tolist())
        if a == b:
            continue
        kth = float(torch.topk(scores[r], got.shape[1])[0][-1])
        for j in a ^ b:
            differing += 1
            check(abs(float(scores[r, j]) - kth) <= 1e-5 * abs(kth),
                  f"{what}: row {r} neighbour {j} differs, no near-tie")
    return differing


def per_row(key: str) -> bool:
    """Plan ``key`` runs knn on dense_array, the one engine whose knn scores
    each test row.  Off dense_array a batch's answer is the reference's
    (1, k) quirk, and kv_sparse's scatter of the batch into one vector picks
    its values in no fixed order (ROADMAP queue 3)."""
    return dict(_plan_from_key(key).assignment)[FUSED_TAIL[1]] \
        == "dense_array"


def _same_answer(got, want, key: str, feats, test, what: str) -> int:
    """``got`` has the shape of ``want``, the in-process serve of plan
    ``key``, and where the plan scores each row (``per_row``) the same
    neighbours, or near-ties (``_same_neighbours``).  Returns how many
    indices differ."""
    check(tuple(got.shape) == tuple(want.shape),
          f"{what} on {key}: {tuple(got.shape)} vs {tuple(want.shape)}")
    if not per_row(key):
        return 0
    return _same_neighbours(got, want, feats, test, f"{what} on {key}")


def _timed(srv) -> list:
    """Record each request's latency through ``srv.submit`` (the
    admission's own call), waiting on the signature lock included."""
    lat, submit = [], srv.submit

    def timed(query, degrade=False):
        t0 = time.perf_counter()
        rep = submit(query, degrade=degrade)
        lat.append(time.perf_counter() - t0)
        return rep

    srv.submit = timed
    return lat


def _pct(values, q: float) -> float:
    return float(np.percentile(np.asarray(values) * 1e3, q))


def phase_serving(dev, data, state_dir: str, train_plans=36,
                  cold=SERVE_COLD, warm=SERVE_WARM, workers=SERVE_WORKERS,
                  failover_waves=FAILOVER_WAVES) -> dict:
    """``QueryServer`` over a resilient session at the analytic's full size:
    the 64 test patients as one 64 x 224 batch (kNN at B 64, the tiled
    kernel, inside the fused tfidf -> knn graph).  Six checks: a cold race
    trains once; warm throughput, with the kNN launches credited across
    graph replays and the fused neighbours equal to an unfused serve's;
    shedding beyond ``max_pending``; failover and recovery of a small
    portable query under injected outages; a traced warm serve; a warm
    restart from ``persist()`` with zero plan enumerations."""
    train_w = data["train_w"]
    batch = data["test_hists"]
    state = os.path.join(state_dir, "monitor.json")
    q = lambda: bigdawg(SERVING)

    def session():
        s = connect(state, device=dev, resilient=True,
                    train_plans=train_plans)
        # isolate the serving checks from usage-drift retraining (peak RSS
        # only grows in one process) and from the millisecond-noise re-plan
        # trigger, as the reference's serving tests and benchmarks do
        s.bigdawg.monitor.DRIFT_THRESHOLD = float("inf")
        s.bigdawg.replan_factor = float("inf")
        s.register("waves", DenseTensor(torch.from_numpy(train_w)),
                   engine="dense_array")
        s.register("test_batch", DenseTensor(batch), engine="dense_array")
        return s

    row = {"patients": {"train": len(train_w), "test_batch": len(batch)}}
    # features of the training patients with the plain versions (no launch)
    feats = ENGINES["dense_array"].run("tfidf", {}, ENGINES["dense_array"].run(
        "bin_hist", {"nbins": NBINS, "levels": LEVELS},
        DenseTensor(haar_ref(torch.from_numpy(train_w).to(dev), LEVELS)),
        device=dev), device=dev).data

    # 1. cold race: racing requests on a fresh session train once
    s = session()
    t0 = time.perf_counter()
    reports = s.server(max_pending=cold).submit_many(
        [q() for _ in range(cold)], workers=workers)
    cold_s = time.perf_counter() - t0
    modes = [r.mode for r in reports]
    check(modes.count("training") == 1
          and modes.count("production") == cold - 1
          and s.bigdawg.metrics.value("server.trainings") == 1,
          f"cold race modes {modes}")
    prod = next(r for r in reports if r.mode == "production")
    first = prod.result.data
    rows = len(batch) if per_row(prod.plan_key) else 1
    check(first.dtype == torch.int32 and tuple(first.shape) == (rows, K)
          and first.device.type == dev.type,
          f"serving result {first.dtype} {tuple(first.shape)} {first.device}"
          f" on {prod.plan_key}")
    # each serve is held to the in-process serve of its own plan: the
    # production plan may move while monitor means settle, and off
    # dense_array a batch's answer is the reference's quirk (``per_row``)
    answers = {prod.plan_key: first}

    def answer(key):
        if key not in answers:
            answers[key] = execute_plan(q(), _plan_from_key(key),
                                        s.catalog, device=dev).value.data
        return answers[key]

    ties = sum(_same_answer(r.result.data, answer(r.plan_key), r.plan_key,
                            feats, batch, "cold race") for r in reports)
    row["cold_race"] = {"requests": cold, "workers": workers,
                        "seconds": cold_s, "modes": dict(
                            (m, modes.count(m)) for m in set(modes)),
                        "plans_tried": next(
                            r.plans_tried for r in reports
                            if r.mode == "training"),
                        "plan": reports[-1].plan_key,
                        "near_tie_indices": ties}

    # 2. warm throughput, the kNN launches credited across graph replays
    srv = s.server()
    lat = _timed(srv)
    fused0 = s.bigdawg.fused_serves
    ops.reset_launches()
    runs, served = {}, []
    for w in (workers, 1):
        del lat[:]
        out = srv.serve([q() for _ in range(warm)], workers=w)
        runs[w] = {"rps": out["rps"], "seconds": out["seconds"],
                   "shed": out["shed"], "latency_ms_p50": _pct(lat, 50),
                   "latency_ms_p95": _pct(lat, 95)}
        served += out["reports"]
        seen = [(r.mode, r.status, r.fused_segments, r.plan_key)
                for r in out["reports"]]
        check(out["shed"] == 0 and all(
            mode == "production" and status == "ok"
            and bool(segs) == fusable(key)
            for mode, status, segs, key in seen),
            f"warm serves at {w} workers: {seen}")
    launches = counters.read(ops.LAUNCHES)
    fused = s.bigdawg.fused_serves - fused0
    n_fusable = sum(fusable(r.plan_key) for r in served)
    check(fused == n_fusable > 0,
          f"{fused} warm serves fused, {n_fusable} on a fusable plan")
    if dev.type == "cuda":
        # one kNN launch a fused serve, every one a replay of the graph
        check(launches["knn_scores_tiled"] == n_fusable
              and launches["knn_scores"] == n_fusable,
              f"warm serving launches {launches}, want kNN tiled = "
              f"{n_fusable}")
    last = served[-1]
    plain = QueryServer(s.bigdawg, fuse=False).submit(q())
    s.bigdawg.fuse = True
    check(not plain.fused_segments, "a fuse=False server fused")
    _same_answer(plain.result.data, last.result.data if
                 plain.plan_key == last.plan_key else answer(plain.plan_key),
                 plain.plan_key, feats, batch, "fused vs unfused serving")
    row["warm"] = {"requests": warm, "by_workers": runs,
                   "fused_serves": fused, "launches": launches,
                   "plans": sorted({r.plan_key for r in served}),
                   "serve_ms_median": statistics.median(
                       r.seconds * 1e3 for r in served)}

    # 3. shedding beyond max_pending
    shed0 = s.bigdawg.metrics.value("server.shed")
    out = s.server(max_pending=SHED_PENDING).submit_many(
        [q() for _ in range(SHED_BATCH)], workers=workers)
    shed = [r for r in out if isinstance(r, Overloaded)]
    served = [r for r in out if not isinstance(r, Overloaded)]
    shed_stat = s.bigdawg.metrics.value("server.shed") - shed0
    check(shed and shed_stat == len(shed)
          and len(shed) + len(served) == SHED_BATCH
          and all(r.reason == "max_pending" for r in shed)
          and all(r.mode == "production" for r in served),
          f"shedding: {len(shed)} shed ({shed_stat} counted), "
          f"{len(served)} served of {SHED_BATCH}")
    row["shedding"] = {"batch": SHED_BATCH, "max_pending": SHED_PENDING,
                       "shed": len(shed), "served": len(served)}

    # 4. failover and recovery on a small portable query (each node has at
    # least two capable engines), with an injected clock
    row["failover"] = _failover(dev, failover_waves)

    # 5. a traced warm serve: one connected span tree, tfidf and knn as
    # engine_op children of one fused_segment
    s.bigdawg.tracer.enabled = True
    for _ in range(5):                 # a serve on a fusable plan
        rep = srv.submit(q())
        if fusable(rep.plan_key):
            break
    s.bigdawg.tracer.enabled = False
    spans = rep.trace.spans
    sids = {sp["sid"] for sp in spans}
    segs = rep.trace.find("fused_segment")
    kids = [sp for sp in spans if segs and sp["parent"] == segs[0]["sid"]]
    check(sum(sp["parent"] is None for sp in spans) == 1
          and all(sp["parent"] in sids for sp in spans
                  if sp["parent"] is not None),
          "serving trace is not one connected tree")
    check(len(segs) == 1 and [(k["name"], k["attrs"].get("op"))
                              for k in kids]
          == [("engine_op", "tfidf"), ("engine_op", "knn")],
          f"serving trace segments {segs}, children {kids}")
    row["trace"] = {"spans": len(spans),
                    "names": sorted({sp["name"] for sp in spans}),
                    "fused_segment_ms": segs[0]["seconds"] * 1e3}

    # 6. restart: persist, then a new session on the same state serves
    # production with zero plan enumerations
    srv.persist()
    enumerations = []
    real_dp = mw.dp_plans

    def counting_dp(*a, **kw):
        enumerations.append(1)
        return real_dp(*a, **kw)

    mw.dp_plans = counting_dp
    try:
        s2 = session()
        srv2 = s2.server()
        again = [srv2.submit(q()) for _ in range(4)]
    finally:
        mw.dp_plans = real_dp
    check(all(r.mode == "production" for r in again) and not enumerations,
          f"restart modes {[r.mode for r in again]}, "
          f"{len(enumerations)} enumerations")
    ties = sum(_same_answer(r.result.data, answer(r.plan_key), r.plan_key,
                            feats, batch, "restart") for r in again)
    row["restart"] = {"serves": len(again), "enumerations": len(enumerations),
                      "modes": [r.mode for r in again],
                      "plans": [r.plan_key for r in again],
                      "near_tie_indices": ties}
    row["broken_keys"] = fuseplan.broken_keys()
    row["fusion_fallbacks"] = s.bigdawg.fusion_fallbacks
    row["stats"] = dict(srv.stats)
    check(not row["broken_keys"] and row["fusion_fallbacks"] == 0,
          f"serving fusion fell back: {row['broken_keys']}")
    del s, s2, srv, srv2, feats, answers, first
    emit("serving", **row)
    return row


def _failover(dev, shape) -> dict:
    """The reference test's portable query ``tfidf(haar(waves, levels=2))``
    on a ``shape`` waveform table on the card: fail every engine of the
    incumbent plan, serve degraded (no ``EngineDown`` reaches the caller),
    recover and advance the clock past the cooldown, and the next serve
    restores the incumbent."""
    t = [0.0]
    inj = EngineFaultInjector()
    health = EngineHealth(failure_threshold=2, cooldown_s=5.0,
                          time_fn=lambda: t[0], injector=inj)
    f = connect(device=dev, health=health, train_plans=2, train_repeats=1)
    f.bigdawg.monitor.DRIFT_THRESHOLD = float("inf")
    f.bigdawg.replan_factor = float("inf")
    f.register("waves", DenseTensor(torch.from_numpy(
        np.random.default_rng(0).normal(size=shape).astype(np.float32))),
        engine="dense_array")
    pq = array.tfidf(array.haar("waves", levels=2))
    f.execute(pq, mode="training")
    ok = f.execute(pq)
    incumbent = ok.plan_key
    down = sorted({eng for _, eng in _plan_from_key(incumbent).assignment})
    for eng in down:
        inj.fail_engine(eng)
    deg = [f.execute(pq) for _ in range(2)]
    for r in deg:
        used = {eng for _, eng in _plan_from_key(r.plan_key).assignment}
        check(r.status == "degraded" and not used & set(down)
              and tuple(r.value.data.shape) == shape
              and bool(torch.isfinite(r.value.data).all()),
              f"failover serve {r.status} on {r.plan_key}, down {down}")
    check(deg[0].failovers >= 1 and deg[1].failovers == 0,
          f"failovers {[r.failovers for r in deg]}")
    for eng in down:
        inj.recover(eng)
    t[0] += 5.0
    rec = f.execute(pq)
    check(rec.status == "ok" and rec.plan_key == incumbent,
          f"recovery served {rec.status} on {rec.plan_key}, incumbent "
          f"{incumbent}")
    return {"waves": list(shape), "incumbent": incumbent, "down": down,
            "degraded_plans": [r.plan_key for r in deg],
            "failovers": deg[0].failovers, "faults_fired": inj.faults_fired,
            "recovered_plan": rec.plan_key,
            "breaker_trips": health.trips()}


# -- process pool, sharded scatter-gather, streaming views ---------------------

def _pin_worker(bd) -> None:
    """``worker_init`` of the procpool phase's pools: hold each worker's
    middleware to its cached plans, as the serving phase pins its sessions
    (no usage-drift retraining: a worker's peak RSS is not the process's
    that trained; no re-plan on millisecond timing noise)."""
    bd.monitor.DRIFT_THRESHOLD = float("inf")
    bd.replan_factor = float("inf")


def _note(conn, step: str, **fields) -> None:
    """Progress of the pool master, printed by the parent to stderr as it
    arrives (where a slow or stuck step shows), one JSON line a step."""
    conn.send(("note", {"step": step, **fields}))


def _serving_pool(inp: dict, processes: int, **kw):
    """A pool of ``processes`` workers on the card over the serving phase's
    state (its monitor, calibration and plan cache, shared), with the
    training patients and the test batch registered: ``(pool, seconds to
    start and register)``."""
    t0 = time.perf_counter()
    pool = ProcPool(processes, state_path=inp["state"], resilient=True,
                    train_plans=36, device=inp["device"],
                    worker_init=_pin_worker, **kw)
    pool.register("waves", DenseTensor(inp["train_w"]), "dense_array")
    pool.register("test_batch", DenseTensor(inp["test_batch"]),
                  "dense_array")
    check(all(pid is not None for pid in pool.ping()),
          f"pool of {processes} did not start")
    return pool, time.perf_counter() - t0


def _unique(arrays) -> list:
    """The distinct arrays of ``arrays``, in first-seen order."""
    out, seen = [], set()
    for a in arrays:
        key = (a.shape, str(a.dtype), a.tobytes())
        if key not in seen:
            seen.add(key)
            out.append(a)
    return out


def _by_plan(reps) -> dict:
    """Plan key -> (serves, distinct neighbour arrays) of pool reports: the
    monitor may move a warm signature between known plans while its means
    settle, and each plan's answer is held against the in-process serve of
    that plan."""
    out = {}
    for r in reps:
        check(isinstance(r.result.data, np.ndarray)
              and r.result.data.dtype == np.int32,
              f"pool result {type(r.result.data)} on {r.plan_key}")
        out.setdefault(r.plan_key, []).append(r.result.data)
    return {key: (len(nbs), _unique(nbs)) for key, nbs in out.items()}


def _fragment_engines(trace, op: str) -> list:
    """Per worker-side request root of a traced pool serve (one a fragment
    or one for an unsharded serve), the engines its ``op`` spans ran on."""
    spans = {sp["sid"]: sp for sp in trace.spans}
    master = next(sp["sid"] for sp in trace.spans if sp["parent"] is None)
    roots = [sp["sid"] for sp in trace.spans
             if sp["parent"] == master and sp["name"] == "request"]
    out = {sid: [] for sid in roots}
    for sp in trace.spans:
        if sp["name"] != "engine_op" or sp["attrs"].get("op") != op:
            continue
        sid = sp["parent"]
        while sid is not None and sid not in out:
            sid = spans[sid]["parent"]
        check(sid is not None, f"{op} span outside a worker request")
        out[sid].append(sp["attrs"]["engine"])
    return [out[sid] for sid in roots]


def _pool_warm(conn, inp: dict, processes: int) -> dict:
    """``QueryServer`` over a pool of ``processes`` workers on the card:
    warm-up serves (each worker loads the kernels and captures its graph),
    the card's used memory read by the parent, then the warm run with the
    workers' launch counts zeroed before and read after, and for 2 workers
    a traced serve."""
    pool, start_s = _serving_pool(inp, processes)
    _note(conn, "warm.started", processes=processes, start_s=start_s)
    q = lambda: bigdawg(SERVING)
    try:
        srv = QueryServer(pool)
        t0 = time.perf_counter()
        warmup = srv.submit_many([q() for _ in range(2 * processes)],
                                 workers=processes)
        warmup_s = time.perf_counter() - t0
        _note(conn, "warm.warmed", processes=processes, seconds=warmup_s,
              serve_s=[r.seconds for r in warmup],
              modes=[r.mode for r in warmup])
        check(all(r.mode == "production" for r in warmup),
              f"pool of {processes} warm-up modes "
              f"{[r.mode for r in warmup]}: the plan cache did not serve")
        conn.send(("mem", processes))
        used_gb = conn.recv()
        pool.launches(reset=True)
        lat = _timed(srv)
        out = srv.serve([q() for _ in range(POOL_WARM)],
                        workers=POOL_CLIENTS)
        launches = pool.launches()
        reps = out["reports"]
        _note(conn, "warm.served", processes=processes,
              seconds=out["seconds"])
        seen = [(r.mode, r.status, r.fused_segments, r.plan_key)
                for r in reps]
        check(out["shed"] == 0 and len(reps) == POOL_WARM and all(
            mode == "production" and status == "ok"
            and bool(segs) == fusable(key)
            for mode, status, segs, key in seen),
            f"pool of {processes}: warm serves {seen}")
        n_fusable = sum(fusable(r.plan_key) for r in reps)
        # one tensor-core kNN launch a fused serve, in the workers
        check(n_fusable > 0 and (inp["device"] is not None or (
            launches["knn_scores_tiled"] == n_fusable
            and launches["knn_scores"] == n_fusable)),
              f"pool of {processes}: launches {launches}, {n_fusable} "
              f"serves on a fusable plan")
        row = {"processes": processes, "start_s": start_s,
               "warmup_serves": len(warmup), "warmup_s": warmup_s,
               "requests": POOL_WARM, "clients": POOL_CLIENTS,
               "rps": out["rps"], "seconds": out["seconds"],
               "latency_ms_p50": _pct(lat, 50),
               "latency_ms_p95": _pct(lat, 95),
               "serve_ms_median": statistics.median(
                   r.seconds * 1e3 for r in reps),
               "used_gb": used_gb, "launches": launches,
               "dispatches": pool.dispatches, "by_plan": _by_plan(reps)}
        if processes == POOL_SIZES[-1]:
            row["trace"] = _pool_trace(pool, q)
        return row
    finally:
        pool.close()


def _pool_trace(pool, q) -> dict:
    """A traced warm serve through the pool: the master's spans and the
    worker's in one tree, the worker's ``fused_segment`` holding tfidf and
    knn on dense_array (the kNN kernel ran in the worker as a replay)."""
    for i in range(4):                  # a serve on a fusable plan
        rep = pool.execute(q(), trace_ctx=(f"pool-trace-{i}", None))
        if fusable(rep.plan_key):
            break
    spans = rep.trace.spans
    sids = {sp["sid"] for sp in spans}
    segs = rep.trace.find("fused_segment")
    kids = [sp for sp in spans if segs and sp["parent"] == segs[0]["sid"]]
    check(sum(sp["parent"] is None for sp in spans) == 1
          and all(sp["parent"] in sids for sp in spans
                  if sp["parent"] is not None),
          "pool trace is not one connected tree")
    check(len(segs) == 1 and segs[0]["attrs"]["engine"] == "dense_array"
          and [(k["name"], k["attrs"].get("op"), k["attrs"].get("engine"))
               for k in kids]
          == [("engine_op", "tfidf", "dense_array"),
              ("engine_op", "knn", "dense_array")],
          f"pool trace segments {segs}, children {kids}")
    names = sorted({sp["name"] for sp in spans})
    check({"worker_dispatch", "queue_wait"} <= set(names),
          f"pool trace lacks the master's spans: {names}")
    return {"spans": len(spans), "names": names, "plan": rep.plan_key,
            "fused_segment_ms": segs[0]["seconds"] * 1e3}


def _pool_scatter(conn, inp: dict) -> dict:
    """The training patients registered with ``shards=SCATTER_SHARDS`` on a
    pool of ``SCATTER_WORKERS``: the analytic's front half served scattered
    and whole, alternating, with the workers' launch counts zeroed before
    the first serve (training included) and read after; a traced scattered
    serve names the engine that ran haar in each fragment."""
    fq = lambda: bigdawg(FRONT_HALF)
    pool = ProcPool(SCATTER_WORKERS, state_path=inp["state"],
                    train_plans=SCATTER_TRAIN_PLANS, device=inp["device"],
                    worker_init=_pin_worker, scatter="always")
    try:
        pool.register("waves", DenseTensor(inp["train_w"]), "dense_array",
                      shards=SCATTER_SHARDS)
        pool.launches(reset=True)
        _note(conn, "scatter.started")
        train_s = {}
        for mode in ("always", "never"):
            pool.scatter = mode
            t0 = time.perf_counter()
            pool.execute(fq())          # trains each signature once
            train_s[mode] = time.perf_counter() - t0
            _note(conn, "scatter.trained", mode=mode, seconds=train_s[mode])
        ms = {"always": [], "never": []}
        results, plans = [], {"always": set(), "never": set()}
        for _ in range(SCATTER_SERVES):
            for mode in ("always", "never"):
                pool.scatter = mode
                t0 = time.perf_counter()
                rep = pool.execute(fq())
                ms[mode].append((time.perf_counter() - t0) * 1e3)
                check(rep.mode == "production"
                      and rep.shards == (SCATTER_SHARDS if mode == "always"
                                         else 0),
                      f"scatter={mode}: {rep.mode}, {rep.shards} shards")
                plans[mode].add(rep.plan_key)
                results.append(rep.result.data)
        pool.scatter = "always"
        traced = pool.execute(fq(), trace_ctx=("pool-scatter", None))
        launches = pool.launches()
        haar = _fragment_engines(traced.trace, "haar")
        check(len(haar) == SCATTER_SHARDS
              and all(len(e) == 1 for e in haar),
              f"traced scatter serve: haar engines per fragment {haar}")
        unique = _unique(results + [traced.result.data])
        check(len(unique) == 1,
              f"scatter and whole serves differ: {len(unique)} results")
        return {"shards": SCATTER_SHARDS, "workers": SCATTER_WORKERS,
                "train_plans": SCATTER_TRAIN_PLANS,
                "training_s": train_s, "serves_each": SCATTER_SERVES,
                "always_ms_median": statistics.median(ms["always"]),
                "never_ms_median": statistics.median(ms["never"]),
                "always_ms": ms["always"], "never_ms": ms["never"],
                "plans": {m: sorted(p) for m, p in plans.items()},
                "scatter_serves": pool.scatter_serves,
                "haar_engines": [e[0] for e in haar],
                "launches": launches, "result": unique[0]}
    finally:
        pool.close()


def _pool_stream(conn, inp: dict) -> dict:
    """A streaming registration on a 2-worker pool: one append fans out to
    both workers, then worker 0 is killed and its replacement replays the
    current rows; every serve after the append covers the grown table."""
    sq = lambda: bigdawg(STREAM_QUERY)
    pool = ProcPool(2, train_plans=1, train_repeats=1, incremental="force",
                    device=inp["device"], worker_init=_pin_worker)
    try:
        pool.register("S", DenseTensor(inp["train_w"]), "dense_array",
                      streaming=True)
        for _ in range(2):              # each worker materializes its view
            pool.execute(sq())
        _note(conn, "stream_pool.trained")
        version = pool.append("S", DenseTensor(inp["stream_rows"]))
        before = [pool.execute(sq()) for _ in range(2)]
        pool.workers[0].proc.kill()
        pool.workers[0].proc.join(timeout=30)
        t0 = time.perf_counter()
        after = [pool.execute(sq()) for _ in range(2)]
        respawn_s = time.perf_counter() - t0
        check(pool.respawns == 1, f"stream pool respawns {pool.respawns}")
        return {"version": version, "respawns": pool.respawns,
                "respawn_serves_s": respawn_s,
                "incremental": [r.incremental for r in before + after],
                "rows": [r.result.data.shape[0] for r in before + after],
                "results": _unique([r.result.data for r in before + after])}
    finally:
        pool.close()


def _pool_kill(conn, inp: dict) -> dict:
    """``KILL_REQUESTS`` warm requests through a 2-worker pool whose
    injector SIGKILLs the worker that request ``KILL_ON_DISPATCH`` went
    to, mid-request: every request is served, one respawn."""
    q = lambda: bigdawg(SERVING)
    inj = WorkerKillInjector(kill_on_dispatch=KILL_ON_DISPATCH)
    pool, start_s = _serving_pool(inp, 2, kill_injector=inj)
    _note(conn, "kill.started", start_s=start_s)
    try:
        lat, reps = [], []
        for _ in range(KILL_REQUESTS):
            t0 = time.perf_counter()
            reps.append(pool.execute(q()))
            lat.append((time.perf_counter() - t0) * 1e3)
        check(len(reps) == KILL_REQUESTS and inj.kills == 1
              and pool.respawns == 1
              and all(r.mode == "production" for r in reps),
              f"kill run: {len(reps)} served, {inj.kills} kills, "
              f"{pool.respawns} respawns, modes {[r.mode for r in reps]}")
        return {"requests": KILL_REQUESTS, "served": len(reps),
                "kill_on_dispatch": KILL_ON_DISPATCH, "kills": inj.kills,
                "respawns": pool.respawns,
                "breaker_trips": pool.breaker_trips, "start_s": start_s,
                "killed_request_ms": lat[KILL_ON_DISPATCH - 1],
                "other_ms_median": statistics.median(
                    lat[:KILL_ON_DISPATCH - 1] + lat[KILL_ON_DISPATCH:]),
                "latency_ms": lat,
                "modes": sorted({r.mode for r in reps}),
                "by_plan": _by_plan(reps)}
    finally:
        pool.close()


def _pool_master(conn, inp: dict) -> None:
    """The procpool phase's master, in a freshly spawned process: it gets
    numpy inputs, drives the pools, and sends its row back through
    ``conn`` (asking the parent for the card's used memory on the way).
    It never initializes CUDA: its last check."""
    try:
        row = {"cpu_count": os.cpu_count(),
               "warm": {str(p): _pool_warm(conn, inp, p)
                        for p in POOL_SIZES},
               "scatter": _pool_scatter(conn, inp),
               "stream_pool": _pool_stream(conn, inp),
               "kill": _pool_kill(conn, inp),
               "jax_loaded": "jax" in sys.modules,
               "cuda_initialized": torch.cuda.is_initialized()}
        conn.send(("row", row))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise
    finally:
        conn.close()


def _used_gb(dev):
    """The card's used memory, every process's, in GB (None off the card)."""
    if dev.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(dev)
    return (total - free) / 1e9


def _run_pool_master(dev, inp: dict) -> dict:
    """Spawn the phase's master, print its progress notes to stderr,
    answer its memory questions with ``torch.cuda.mem_get_info`` here, and
    return its row; any failure in the master, or a master silent for
    ``POOL_MASTER_TIMEOUT_S``, fails the phase."""
    ctx = multiprocessing.get_context("spawn")
    conn, child = ctx.Pipe()
    t0 = time.perf_counter()
    proc = ctx.Process(target=_pool_master, args=(child, inp),
                       name="chip-smoke-pool-master")
    proc.start()
    child.close()
    try:
        while True:
            if not conn.poll(POOL_MASTER_TIMEOUT_S):
                raise SmokeFailure(f"pool master silent for "
                                   f"{POOL_MASTER_TIMEOUT_S} s")
            try:
                kind, payload = conn.recv()
            except EOFError:
                raise SmokeFailure(f"pool master died (exit code "
                                   f"{proc.exitcode})") from None
            if kind == "note":
                print(json.dumps({"procpool_note": payload, "t": round(
                    time.perf_counter() - t0, 3)}), file=sys.stderr,
                      flush=True)
            elif kind == "mem":
                conn.send(_used_gb(dev))
            elif kind == "error":
                raise SmokeFailure(f"pool master failed:\n{payload}")
            else:
                row = payload
                break
        proc.join(timeout=60)
        check(proc.exitcode == 0, f"pool master exit code {proc.exitcode}")
        return row
    finally:
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=30)


def _stream_views(dev, train_w, blocks) -> tuple:
    """In-process streaming views on the card: the training patients as a
    streaming table in a session that always patches its view
    (``incremental="force"``) and in one that always recomputes, the same
    appends to both, a warm serve of each after each append; then the
    default gate (``incremental=True``) on one more append of the same
    size.  Returns the row and the recompute's result after the first
    append."""
    twins = {}
    for name, mode in (("delta", "force"), ("full", False)):
        s = connect(device=dev, incremental=mode, train_plans=1,
                    train_repeats=1)
        s.bigdawg.monitor.DRIFT_THRESHOLD = float("inf")
        s.bigdawg.replan_factor = float("inf")
        s.register("S", DenseTensor(train_w), engine="dense_array",
                   streaming=True)
        s.execute(STREAM_QUERY, mode="training")
        twins[name] = s
    ms = {"delta": [], "full": []}
    first_append = None
    for i, block in enumerate(blocks[:STREAM_APPENDS]):
        got = {}
        for name, s in twins.items():
            s.append("S", DenseTensor(block))
            t0 = time.perf_counter()
            res = s.execute(STREAM_QUERY)
            sync(dev)
            ms[name].append((time.perf_counter() - t0) * 1e3)
            got[name] = (res.incremental, host_copy(res.value).data)
        rows = len(train_w) + (i + 1) * STREAM_ROWS
        check(got["delta"][0] is True and got["full"][0] is False,
              f"append {i}: incremental {got['delta'][0]} / "
              f"{got['full'][0]}")
        check(got["delta"][1].shape == (rows, (LEVELS + 1) * NBINS)
              and np.array_equal(got["delta"][1], got["full"][1]),
              f"append {i}: the patched view differs from the recompute")
        if i == 0:
            first_append = got["full"][1]
    bd = twins["delta"].bigdawg
    check(bd.ivm_serves == STREAM_APPENDS and bd.ivm_fallbacks == 0,
          f"ivm serves {bd.ivm_serves}, fallbacks {bd.ivm_fallbacks}")
    # the default gate on one more append of the same size: a finding,
    # not a check; its answer must still equal the recompute
    bd.incremental = True
    gate = {}
    for name, s in twins.items():
        s.append("S", DenseTensor(blocks[STREAM_APPENDS]))
        res = s.execute(STREAM_QUERY)
        gate[name] = (res.incremental, host_copy(res.value).data)
    check(np.array_equal(gate["delta"][1], gate["full"][1]),
          "gated serve differs from the recompute")
    row = {"rows": len(train_w), "appends": STREAM_APPENDS,
           "rows_each": STREAM_ROWS,
           "append_mib": blocks[0].nbytes / 2 ** 20,
           "delta_ms_median": statistics.median(ms["delta"]),
           "full_ms_median": statistics.median(ms["full"]),
           "delta_ms": ms["delta"], "full_ms": ms["full"],
           "ivm_serves": STREAM_APPENDS, "ivm_fallbacks": 0,
           "plan": twins["full"].bigdawg.plan_cache[next(iter(
               twins["full"].bigdawg.plan_cache))].plan.key,
           "default_gate": {"incremental": gate["delta"][0],
                            "ivm_fallbacks": bd.ivm_fallbacks}}
    del twins, bd
    return row, first_append


def phase_procpool(dev, data, state_dir: str) -> dict:
    """The process pool, sharded scatter-gather and streaming views at the
    analytic's full size, inside the serving phase's state directory (the
    workers open its monitor, calibration and plan cache, shared, and
    serve warm).  In this process: the in-process references (the
    ``QueryServer`` neighbours, the unsharded front half) and the streaming
    views.  In a freshly spawned master that never initializes CUDA: the
    warm runs at 1 and 4 workers (the 4-worker one traced), the scattered
    and whole front half, an append through a pool with a respawn, and a
    worker killed mid-request.  Emits one line a section."""
    t_phase = time.perf_counter()
    train_w = data["train_w"]
    batch = data["test_hists"]
    state = os.path.join(state_dir, "monitor.json")
    eng = ENGINES["dense_array"]
    feats = eng.run("tfidf", {}, eng.run(
        "bin_hist", {"nbins": NBINS, "levels": LEVELS},
        DenseTensor(haar_ref(torch.from_numpy(train_w).to(dev), LEVELS)),
        device=dev), device=dev).data
    # the in-process front half on the same data
    f = connect(device=dev, train_plans=SCATTER_TRAIN_PLANS)
    f.register("waves", DenseTensor(torch.from_numpy(train_w)),
               engine="dense_array")
    f.execute(FRONT_HALF, mode="training")
    want_front = host_copy(f.execute(FRONT_HALF).value).data
    del f
    samples = train_w.shape[1]
    blocks = ecg_waveforms((STREAM_APPENDS + 1) * STREAM_ROWS, samples,
                           seed=1)[0].reshape(STREAM_APPENDS + 1,
                                              STREAM_ROWS, samples)
    stream, first_append = _stream_views(dev, train_w, blocks)
    emit("procpool", section="stream", **stream)
    torch.cuda.empty_cache()
    parent_gb = _used_gb(dev)

    # the workers' device: None is the card, as in every entry point
    inp = {"state": state, "device": None if dev.type == "cuda" else str(dev),
           "train_w": train_w, "test_batch": batch.cpu().numpy(),
           "stream_rows": blocks[0]}
    row = _run_pool_master(dev, inp)
    check(row["cuda_initialized"] is False,
          "the pool master initialized CUDA")
    check(row["jax_loaded"] is False, "the pool master loaded jax")

    # the in-process QueryServer on the same state, and the in-process
    # serve of every plan the pools served
    s = connect(state, device=dev, resilient=True, train_plans=36)
    s.bigdawg.monitor.DRIFT_THRESHOLD = float("inf")
    s.bigdawg.replan_factor = float("inf")
    s.register("waves", DenseTensor(torch.from_numpy(train_w)),
               engine="dense_array")
    s.register("test_batch", DenseTensor(batch), engine="dense_array")
    ref_rep = s.server().submit(bigdawg(SERVING))
    check(ref_rep.mode == "production", f"in-process serve {ref_rep.mode}")
    in_process = {ref_rep.plan_key: ref_rep.result.data.cpu()}

    def same(by_plan, what):
        """Every pool answer is the in-process serve's of its plan
        (``_same_answer``).  Returns the near-tie count and each plan's
        serves."""
        ties = 0
        for key, (_, nbs) in by_plan.items():
            if key not in in_process:
                in_process[key] = execute_plan(
                    bigdawg(SERVING), _plan_from_key(key), s.catalog,
                    device=dev).value.data.cpu()
            for nb in nbs:
                ties += _same_answer(torch.from_numpy(nb), in_process[key],
                                     key, feats, batch, what)
        return ties, {key: n for key, (n, _) in by_plan.items()}

    for p, w in row["warm"].items():
        w["near_tie_indices"], w["plans"] = same(w.pop("by_plan"),
                                                 f"pool of {p}")
        w["in_process_plan"] = ref_rep.plan_key
        w["used_gb_beyond_parent"] = None if parent_gb is None \
            else w["used_gb"] - parent_gb
        emit("procpool", section="warm", **w)
    sc = row["scatter"]
    got = sc.pop("result")
    check(np.array_equal(got, want_front),
          "scattered front half differs from the in-process serve")
    check(sc["scatter_serves"] == SCATTER_SERVES + 2,
          f"scatter serves {sc['scatter_serves']}")
    check(dev.type != "cuda" or sc["launches"]["haar"] > 0,
          f"no Haar launch in the scatter workers: {sc['launches']}")
    emit("procpool", section="scatter", bitwise_equal=True, **sc)
    sp = row["stream_pool"]
    results = sp.pop("results")
    check(len(results) == 1 and np.array_equal(results[0], first_append)
          and sp["rows"] == [len(train_w) + STREAM_ROWS] * 4,
          f"pool append: rows {sp['rows']}, {len(results)} distinct results")
    emit("procpool", section="stream_pool", **sp)
    kill = row["kill"]
    kill["near_tie_indices"], kill["plans"] = same(kill.pop("by_plan"),
                                                   "kill run")
    kill["in_process_plan"] = ref_rep.plan_key
    del s, in_process
    emit("procpool", section="kill", **kill)
    out = {"warm": row["warm"], "scatter": sc, "stream": stream,
           "stream_pool": sp, "kill": kill, "cpu_count": row["cpu_count"],
           "parent_used_gb": parent_gb,
           "seconds": time.perf_counter() - t_phase}
    emit("procpool", section="master", cpu_count=row["cpu_count"],
         cuda_initialized=row["cuda_initialized"],
         jax_loaded=row["jax_loaded"], parent_used_gb=parent_gb,
         seconds=out["seconds"])
    return out


# -- LM serving -----------------------------------------------------------------

def _lm_prompts(cfg, n_req: int, one_token: bool) -> list:
    """Prompt lengths from default_rng(0) in [128, 2048], one of them
    exactly 2048 (request 1), plus a 1-token prompt for the dense model;
    the encoder-decoder's decoder prompts in ENCDEC_PROMPT, request 1 a
    single token; tokens from the same generator."""
    rng = np.random.default_rng(0)
    if cfg.family == "encdec":
        lengths = [int(x) for x in rng.integers(*ENCDEC_PROMPT, n_req)]
        lengths[1] = 1
    else:
        lengths = [int(x) for x in rng.integers(128, 2049, n_req)]
        lengths[1] = 2048
    if one_token:
        lengths.append(1)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lengths]


def _stub(cfg, batch: int, seed: int, dev, dtype, frames=DECODE_ENC_LEN):
    """The frontend stub's inputs of a family, standard normal from a
    generator seeded with ``seed`` on ``dev``: (batch, P, D) patch
    embeddings (vlm) or (batch, frames, D) frames (encdec); {} for the
    families without a frontend."""
    if cfg.family == "vlm":
        key, shape = "patch_embeds", (batch, cfg.num_frontend_tokens,
                                      cfg.d_model)
    elif cfg.family == "encdec":
        key, shape = "frames", (batch, frames, cfg.d_model)
    else:
        return {}
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {key: torch.randn(shape, generator=gen, device=dev).to(dtype)}


def _prefill_logits(cfg, plan, params, tokens: np.ndarray, dev, stub=None):
    """Last-token logits (float32, on the host) of one prompt, after the
    frontend stub's inputs ``stub`` (moved to ``dev`` in the plan's
    parameter dtype)."""
    tok = torch.as_tensor(tokens[None, :], device=dev)
    dtype = getattr(torch, plan.param_dtype)
    extra = {k: t.to(dev, dtype) for k, t in (stub or {}).items()}
    # cache rows: the patches' too
    rows = len(tokens) + (extra["patch_embeds"].shape[1]
                          if "patch_embeds" in extra else 0)
    shape = ShapeConfig("check", "prefill", rows + 1, 1)
    logits, _, _ = api.make_prefill(cfg, shape, plan)(
        params, {"tokens": tok, **extra})
    return logits[0].float().cpu()


def _prefill_launches(cfg, dtype) -> dict:
    """{launch counter: launches} of one prefill of ``cfg`` in ``dtype``:
    SSD in every Mamba layer, flash attention at the q/k head width (MLA:
    qk_nope + qk_rope) in every attention layer (the hybrid: once a
    group, its shared block; the encoder-decoder: each encoder layer and
    twice a decoder layer, its self- and cross-attention)."""
    out = {}
    if cfg.family in ("ssm", "hybrid"):
        ssd = "ssd_intra_" + ssd_variant(cfg.ssm.chunk, cfg.ssm.head_dim,
                                         cfg.ssm.state_dim)
        out[ssd] = cfg.num_layers
    if cfg.family != "ssm":
        d = cfg.head_dim if cfg.mla is None \
            else cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        n = cfg.num_layers
        if cfg.family == "hybrid":
            n = hybrid_geometry(cfg)[0]
        elif cfg.family == "encdec":
            n = cfg.encoder_layers + 2 * cfg.num_layers
        out["flash_attention_" + variant(dtype, d)] = n
    return out


def _step_launches(cfg, dtype) -> dict:
    """{launch counter: launches} of one train step under block remat: each
    kernel's forward and its recompute, twice a layer, but in the hybrid's
    tail layers, which are not rematerialized (as in the reference)."""
    out = {k: 2 * n for k, n in _prefill_launches(cfg, dtype).items()}
    if cfg.family == "hybrid":
        tail = hybrid_geometry(cfg)[2]
        out = {k: n - tail if k.startswith("ssd_") else n
               for k, n in out.items()}
    return out


def _decode_launches(cfg) -> dict:
    """{launch counter: launches} of one decode step of ``cfg``: decode
    attention in every GQA self-attention layer (the hybrid: its shared
    block, once a group; the encoder-decoder: its decoder's
    self-attention); none for MLA or an SSM."""
    if cfg.family == "ssm" or cfg.mla is not None:
        return {}
    n = hybrid_geometry(cfg)[0] if cfg.family == "hybrid" \
        else cfg.num_layers
    return {"decode_attention": n}


def _run_launches(cfg, dtype, prefills: int, steps: int) -> dict:
    """{launch counter: launches} of ``prefills`` prefills and ``steps``
    decode steps of ``cfg``."""
    return {**{k: n * prefills
               for k, n in _prefill_launches(cfg, dtype).items()},
            **{k: n * steps for k, n in _decode_launches(cfg).items()}}


def _check_launches(launches: dict, want: dict, what: str) -> None:
    """Each counter of ``want`` at its count, every other counter 0."""
    check(all(launches[k] == n for k, n in want.items())
          and all(n == 0 for k, n in launches.items() if k not in want),
          f"{what}: launches {launches}, want {want} and nothing else")


# device kernel name (in the profiler's trace) of each launch counter
DEVICE_KERNEL = {"flash_attention_tc": "flash_fwd_wgmma",
                 "flash_attention_tf32": "flash_fwd_wgmma_tf32",
                 "flash_attention_mma": "flash_fwd_mma",
                 "flash_attention_simt": "flash_fwd_simt",
                 "ssd_intra_tc": "ssd_intra_wgmma",
                 "ssd_intra_simt": "ssd_intra_kernel",
                 "decode_attention": "decode_split"}


def _device_kernels(counters) -> list:
    """The device kernels of launch counters, as ``DEVICE_KERNEL`` names
    them; the "tc" flash kernel's split over keys also runs
    flash_fwd_combine, and every decode-attention call decode_combine."""
    names = [DEVICE_KERNEL[k] for k in counters]
    if "flash_attention_tc" in counters:
        names.append("flash_fwd_combine")
    if "decode_attention" in counters:
        names.append("decode_combine")
    return names


def _cut(cfg, depth: int):
    """``cfg`` at ``depth`` layers; an MoE model keeps its dense first
    layers (``prefix_blocks``) first, as many as the depth holds; a hybrid
    has depth // attn_period groups and the rest as its tail; an
    encoder-decoder has ``depth`` encoder and decoder layers."""
    cut = dataclasses.replace(cfg, num_layers=depth)
    if cfg.encoder_layers:
        cut = dataclasses.replace(cut, encoder_layers=depth)
    if cfg.moe is not None:
        cut = dataclasses.replace(cut, moe=dataclasses.replace(
            cfg.moe, first_dense_layers=min(cfg.moe.first_dense_layers,
                                            depth)))
    return cut


def _f32_cut(cfg, params, depth=CPU_CHECK_DEPTH):
    """The first ``depth`` layers of the served parameters in float32, with
    the cut config and its float32 plan."""
    cut = _cut(cfg, depth)
    plan = PlanConfig(param_dtype="float32", compute_dtype="float32")
    if cfg.family == "hybrid":
        # the first groups (their Mamba layers and LoRA deltas), the
        # shared block, the first tail layers
        G, _, T_ = hybrid_geometry(cut)
        small = {k: v for k, v in params.items() if k != "tail"}
        small["groups"] = tree_map(lambda a: a[:G], params["groups"])
        small["lora"] = tree_map(lambda a: a[:G], params["lora"])
        if T_:
            small["tail"] = tree_map(lambda a: a[:T_], params["tail"])
        return cut, plan, tree_map(lambda a: a.float(), small)
    if cfg.family == "encdec":
        small = dict(params)
        for stack in ("enc_blocks", "dec_blocks"):
            small[stack] = tree_map(lambda a: a[:depth], params[stack])
        return cut, plan, tree_map(lambda a: a.float(), small)
    n_prefix = T.prefix_layers(cut)
    small = {k: v for k, v in params.items() if k != "prefix_blocks"}
    small["blocks"] = tree_map(lambda a: a[:depth - n_prefix],
                               params["blocks"])
    if n_prefix:
        small["prefix_blocks"] = tree_map(lambda a: a[:n_prefix],
                                          params["prefix_blocks"])
    return cut, plan, tree_map(lambda a: a.float(), small)


def _lm_cpu_check(cfg, params, prompt, dev, depth=CPU_CHECK_DEPTH,
                  n_tokens=CPU_CHECK_TOKENS, stub=None) -> dict:
    """The first ``depth`` layers of the served parameters in float32 (the
    hybrid: one group and the tail; the encoder-decoder: ``depth`` encoder
    and decoder layers): a prefill of the prompt's first tokens, after the
    frontend stub's inputs ``stub`` (the vision-language model's patches,
    the encoder-decoder's first CPU_CHECK_FRAMES frames), on the card
    (kernels) and on the CPU (plain versions) must give the same last-token
    logits and greedy token.  The card's prefill launches are counted on
    their own.  A float32 prefill takes the 3xTF32 flash kernel at the
    model's width ("tf32" at 128 and 64, "mma" at MLA's 192 and the
    hybrid's 112)."""
    cut, plan, small = _f32_cut(cfg, params, depth)
    toks = prompt[:n_tokens]
    stub = {k: t[:, :CPU_CHECK_FRAMES] if k == "frames" else t
            for k, t in (stub or {}).items()}
    ops.reset_launches()
    card = _prefill_logits(cut, plan, small, toks, dev, stub)
    launches = counters.read(ops.LAUNCHES)
    host = _prefill_logits(cut, plan, tree_map(lambda a: a.cpu(), small),
                           toks, torch.device("cpu"), stub)
    err = float((card - host).abs().max())
    scale = float(host.abs().max())
    ok = bool(torch.allclose(card, host, rtol=CPU_CHECK_TOL,
                             atol=CPU_CHECK_TOL))
    t_card, t_host = int(card.argmax()), int(host.argmax())
    gap = float(host[t_host] - host[t_card])
    row = {"depth": depth, "tokens": len(toks), "dtype": "float32",
           **{f"{k}_shape": list(t.shape) for k, t in stub.items()},
           "max_abs_err": err, "max_abs_logit": scale, "tol": CPU_CHECK_TOL,
           "token_card": t_card, "token_cpu": t_host,
           "near_tie": t_card != t_host, "gap": gap, "launches": launches}
    if dev.type == "cuda":
        _check_launches(launches, _prefill_launches(cut, torch.float32),
                        "cpu_check")
    check(ok, f"cpu_check logits differ by {err} (|logit| up to {scale})")
    check(t_card == t_host or gap <= CPU_CHECK_TOL * max(1.0, scale),
          f"cpu_check greedy tokens {t_card} vs {t_host}, gap {gap}")
    return row


def _lm_ragged_check(cfg, dev, n_tokens: int = 61,
                     n_frames: int = 97) -> dict:
    """The family's smoke config in float32 from a seeded init (dense,
    vision-language and encoder-decoder: head width 32, a width of the
    warp-level tensor-core flash kernel; SSM: chunk 8, head width 16, state
    16, a shape only the CUDA-core SSD kernel takes; the hybrid both, in 7
    layers of which 6 in two groups): a prefill of a ragged prompt (after
    8 patch embeddings, or over ``n_frames`` frames) on the card (kernels)
    and on the CPU (plain versions) must give the same last-token logits.
    The card's prefill launches are counted on their own."""
    small = cfg.smoke()
    plan = PlanConfig(param_dtype="float32", compute_dtype="float32")
    cpu = torch.device("cpu")
    params = api.init_params(small, torch.Generator().manual_seed(1), plan,
                             cpu)
    toks = np.random.default_rng(1).integers(
        0, small.vocab_size, n_tokens).astype(np.int32)
    stub = _stub(small, 1, 1, cpu, torch.float32, frames=n_frames)
    ops.reset_launches()
    card = _prefill_logits(small, plan, tree_map(lambda a: a.to(dev),
                                                 params), toks, dev, stub)
    launches = counters.read(ops.LAUNCHES)
    host = _prefill_logits(small, plan, params, toks, cpu, stub)
    err = float((card - host).abs().max())
    row = {"model": small.name, "layers": small.num_layers,
           "tokens": n_tokens, "dtype": "float32", "max_abs_err": err,
           **{f"{k}_shape": list(t.shape) for k, t in stub.items()},
           "max_abs_logit": float(host.abs().max()), "tol": CPU_CHECK_TOL,
           "launches": launches}
    if dev.type == "cuda":
        _check_launches(launches, _prefill_launches(small, torch.float32),
                        "ragged_check")
    check(bool(torch.allclose(card, host, rtol=CPU_CHECK_TOL,
                              atol=CPU_CHECK_TOL)),
          f"ragged_check logits differ by {err}")
    return row


def _decode_vs_prefill(cfg, plan, params, req, dev, k=8, stub=None) -> dict:
    """A prefill over the prompt (after the frontend stub's inputs
    ``stub``) and the first k-1 generated tokens must predict the k-th
    generated token (or a near-tie).  The vision-language model's decode
    continues the first L rows of [patches; prompt], L the prompt's length:
    ``BatchServer`` places a request at its prompt's length, whatever rows
    the prefill wrote, so decode writes over the last P of them (a quirk
    of the reference that the port copies); its prefill is over those
    rows."""
    prompt, stub = req.prompt, dict(stub or {})
    if cfg.family == "vlm":
        L, P = len(prompt), cfg.num_frontend_tokens
        stub["patch_embeds"] = stub["patch_embeds"][:, :min(L, P)]
        prompt = prompt[:max(L - P, 0)]
    toks = np.concatenate([prompt, np.asarray(req.out_tokens[:k - 1],
                                              np.int32)])
    logits = _prefill_logits(cfg, plan, params, toks, dev, stub)
    want = req.out_tokens[k - 1]
    got = int(logits.argmax())
    gap = float(logits[got] - logits[want])
    row = {"k": k, "prefill_token": got, "decoded_token": want,
           "equal": got == want, "gap": gap, "margin": DECODE_NEAR_TIE,
           "prefill_tokens": len(toks),
           **{f"{key}_rows": t.shape[1] for key, t in stub.items()}}
    check(got == want or gap <= DECODE_NEAR_TIE,
          f"decode_vs_prefill: prefill says {got}, decode said {want}, "
          f"gap {gap}")
    return row


def _decode_vs_cpu(cfg, params, dev, depth: int, slots=DECODE_CHECK_SLOTS,
                   steps=DECODE_CHECK_STEPS) -> dict:
    """The MoE family's decode check.  An MoE decode step routes all slots
    as one group (deepseek at 8 slots: capacity 1 an expert), a prefill one
    sequence, so a decode is not the function that a longer prefill
    computes, even in the reference.  Instead the first ``depth`` layers
    of the served parameters in float32 serve ``slots`` requests through
    ``BatchServer`` on the card (kernels) and on the CPU (plain versions):
    every slot prefilled, then ``steps`` decode steps over all of them.
    The tokens must be equal, and every cache leaf within CPU_CHECK_TOL.
    The row's ``card_s``, ``copy_s`` and ``cpu_s`` are its parts' wall
    times."""
    cut, plan, small = _f32_cut(cfg, params, depth)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cut.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(*DECODE_CHECK_PROMPT,
                                     slots)]
    max_len = DECODE_CHECK_PROMPT[1] + steps + 1
    shape = ShapeConfig("check", "decode", max_len, slots)
    prefill = api.make_prefill(cut, shape, plan)

    def serve(p, d):
        srv = BatchServer(
            slots=slots, max_len=max_len,
            prefill_fn=lambda p_, t: prefill(p_, {"tokens": t}),
            decode_fn=api.make_decode_step(cut, shape, plan), params=p,
            init_cache_fn=lambda b, ml: api.init_cache(cut, b, ml,
                                                       torch.float32, d))
        reqs = [Request(i, pr, steps + 1)
                for i, pr in enumerate(prompts)]
        srv.run(reqs)
        return [r.out_tokens for r in reqs], srv

    ops.reset_launches()
    t0 = time.perf_counter()
    card_tokens, card = serve(small, dev)
    sync(dev)
    card_s = time.perf_counter() - t0
    launches = counters.read(ops.LAUNCHES)
    t0 = time.perf_counter()
    host = tree_map(lambda a: a.cpu(), small)
    del small
    copy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_tokens, cpu = serve(host, torch.device("cpu"))
    host_s = time.perf_counter() - t0
    del host
    errs = {"/".join(path): max_abs_err(card_leaf.cpu(), host_leaf)
            for path, card_leaf, host_leaf in (
                ((g, k), card.cache[g][k], cpu.cache[g][k])
                for g in cpu.cache for k in cpu.cache[g])}
    row = {"depth": depth, "slots": slots,
           "prompt_lengths": [len(p) for p in prompts],
           "decode_steps": card.stats["decode_steps"],
           "tokens_equal": card_tokens == host_tokens,
           "tokens_card": card_tokens, "tokens_cpu": host_tokens,
           "cache_max_abs_err": errs, "tol": CPU_CHECK_TOL,
           "card_s": card_s, "copy_s": copy_s, "cpu_s": host_s,
           "launches": launches}
    if dev.type == "cuda":
        _check_launches(launches, _run_launches(
            cut, torch.float32, slots, card.stats["decode_steps"]),
            "decode_vs_cpu")
    check(card.stats["decode_steps"] == cpu.stats["decode_steps"]
          == steps, f"decode_vs_cpu: {card.stats} / "
          f"{cpu.stats}")
    check(card_tokens == host_tokens,
          f"decode_vs_cpu tokens: card {card_tokens}, cpu {host_tokens}")
    for path in errs:
        g, k = path.split("/")
        check(torch.allclose(card.cache[g][k].cpu(), cpu.cache[g][k],
                             rtol=CPU_CHECK_TOL, atol=CPU_CHECK_TOL),
              f"decode_vs_cpu cache {path} differs by {errs[path]}")
    return row


def _device_profile(fn, dev, kernels, top: int = 5, warm: bool = True) -> dict:
    """One call of ``fn`` (warmed up first, unless the caller has just run
    it: ``warm=False``) under ``torch.profiler`` with
    CUDA activity only: host wall ms of the call (ending in a synchronize),
    the device's busy ms (union of its kernel and copy intervals), the busy
    share, the device ms and launches of each hand kernel of ``kernels``
    (device names; ``kernel_ms`` and ``kernel_launches`` their sums), the
    device ms by kind of work (``_kind``), and the kernels that took the
    most device time."""
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end, by_name, by_kind = 0.0, float("-inf"), {}, {}
    for a, b, name in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
        by_kind[_kind(name)] = by_kind.get(_kind(name), 0.0) + (b - a) / 1e3
    busy /= 1e3
    each = {}
    for kernel in kernels:
        # the whole name: flash_fwd_wgmma is not flash_fwd_wgmma_tf32
        word = re.compile(rf"\b{re.escape(kernel)}\b")
        mine = [b - a for a, b, name in spans if word.search(name)]
        each[kernel] = {"ms": sum(mine) / 1e3, "launches": len(mine)}
    return {"wall_ms": wall, "device_busy_ms": busy if spans else None,
            "busy_share": busy / wall if spans else None,
            "device_ops": len(spans), "kernels": each,
            "kernel_ms": sum(k["ms"] for k in each.values()),
            "kernel_launches": sum(k["launches"] for k in each.values()),
            "by_kind_ms": by_kind,
            "top_ms": sorted(by_name.items(), key=lambda kv: -kv[1])[:top]}


def _kind(name: str) -> str:
    """The kind of work of a device kernel, from its name: a hand kernel,
    a matrix product (cuBLAS / CUTLASS), a sort or search (the MoE
    dispatch's top-k and inverse), a gather or index (its slots), a copy
    or cast, a reduction, other elementwise work."""
    n = name.lower()
    if any(w in n for w in ("flash_fwd", "ssd_intra", "haar", "knn_",
                            "decode_split", "decode_combine")):
        return "hand"
    if any(w in n for w in ("gemm", "nvjet", "cutlass", "xmma")):
        return "gemm"
    if "sort" in n or "searchsorted" in n:
        return "sort"
    if any(w in n for w in ("gather", "scatter", "index")):
        return "gather"
    if "copy" in n or n.startswith(("memcpy", "memset")):
        return "copy"
    if "reduce" in n or "softmax" in n or "scan" in n:
        return "reduce"
    return "elementwise" if "elementwise" in n else "other"


def phase_lm(dev, name: str, cfg=None, slots=LM_SLOTS, max_len=LM_MAX_LEN,
             n_req=LM_REQUESTS, new_tokens=LM_NEW_TOKENS, phase=None,
             cpu_check=True, cpu_check_depth=CPU_CHECK_DEPTH,
             decode_check=(CPU_CHECK_DEPTH, DECODE_CHECK_SLOTS,
                           DECODE_CHECK_STEPS), keep=0) -> dict:
    """Serve ``n_req`` requests (plus a 1-token prompt for the dense model)
    through ``BatchServer.run`` at full width (and full depth unless
    ``cfg`` cuts it), bfloat16 parameters (``PlanConfig`` defaults) from
    the port's seeded init (a frontend stub's seeded inputs shared by the
    requests: ``_stub``); then the checks against the CPU in float32
    (``cpu_check`` at ``cpu_check_depth``: not for a model whose float32
    layers would not fit the host) and of decode (``decode_vs_prefill``;
    the MoE family's ``decode_vs_cpu`` at ``decode_check``'s depth,
    slots and decode steps).  The
    row returned (not printed) also holds ``kept``: the first ``keep``
    requests' prompts, prefill logits (on the host) and tokens, which
    ``lm_sharded`` holds its own against."""
    t_phase = time.perf_counter()
    cfg = cfg or get_arch(name)
    plan = PlanConfig()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    want = _prefill_launches(cfg, torch.bfloat16)
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             plan, dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    shape = ShapeConfig("serve", "decode", max_len, slots)
    prefill = api.make_prefill(cfg, shape, plan)
    decode = api.make_decode_step(cfg, shape, plan)
    stub = _stub(cfg, 1, 4, dev, torch.bfloat16)
    # rows a prefill runs besides the prompt's: the patches
    extra_rows = cfg.num_frontend_tokens if cfg.family == "vlm" else 0
    prefill_ms, decode_ms, kept_logits = [], [], []

    def timed_prefill(p, tok):
        t1 = time.perf_counter()
        out = prefill(p, {"tokens": tok, **stub})
        sync(dev)
        prefill_ms.append(((time.perf_counter() - t1) * 1e3, tok.shape[1]))
        if len(kept_logits) < keep:       # run() prefills in request order
            kept_logits.append(out[0][0].float().cpu())
        return out

    def timed_decode(p, c, t, pos):
        t1 = time.perf_counter()
        out = decode(p, c, t, pos)
        sync(dev)
        decode_ms.append((time.perf_counter() - t1) * 1e3)
        return out

    srv = BatchServer(slots=slots, max_len=max_len, prefill_fn=timed_prefill,
                      decode_fn=timed_decode, params=params,
                      init_cache_fn=lambda b, ml: api.init_cache(
                          cfg, b, ml, torch.bfloat16, dev))
    prompts = _lm_prompts(cfg, n_req, one_token=cfg.family == "dense")
    reqs = [Request(i, p, new_tokens) for i, p in enumerate(prompts)]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    srv.run(reqs)
    sync(dev)
    run_s = time.perf_counter() - t0
    launches = counters.read(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 \
        if dev.type == "cuda" else None

    vp = T.padded_vocab(cfg)
    for r in reqs:
        check(r.done and len(r.out_tokens) == new_tokens,
              f"{name} request {r.rid}: done={r.done}, "
              f"{len(r.out_tokens)} tokens")
        check(all(0 <= t < vp for t in r.out_tokens),
              f"{name} request {r.rid}: token outside [0, {vp})")
    for leaf in tree_leaves(srv.cache) + tree_leaves(params):
        check(leaf.device.type == dev.type, f"{name}: a leaf on "
              f"{leaf.device}")
    prefills = srv.stats["prefills"]
    check(prefills == len(reqs), f"{name}: {prefills} prefills")
    steps = srv.stats["decode_steps"]
    if dev.type == "cuda":
        # each prefill's and decode step's kernels at their counts, and no
        # other launch
        _check_launches(launches, _run_launches(cfg, torch.bfloat16,
                                                prefills, steps),
                        f"{name}: {prefills} prefills, {steps} decode steps")
    full = [ms for ms, n in prefill_ms]
    row = {"model": cfg.name, "family": cfg.family, "params": n_params,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "param_dtype": plan.param_dtype, "init_s": init_s,
           "slots": slots, "max_len": max_len, "requests": len(reqs),
           "prompt_lengths": [len(p) for p in prompts],
           "new_tokens": new_tokens, "prefills": prefills,
           "decode_steps": srv.stats["decode_steps"],
           "tokens_out": srv.stats["tokens_out"], "run_s": run_s,
           **{f"{k}_shape": list(t.shape) for k, t in stub.items()},
           "prefill_ms_median": statistics.median(full),
           "prefill_ms_per_token_median": statistics.median(
               ms / (n + extra_rows) for ms, n in prefill_ms),
           "prefill_ms_2048": [ms for ms, n in prefill_ms if n == 2048],
           "decode_step_ms_median": statistics.median(decode_ms),
           "decode_tokens_per_s": srv.stats["tokens_out"]
           / srv.stats["decode_seconds"],
           "peak_mem_gb": peak, "launches": launches,
           "prefill_launches": want}
    if dev.type == "cuda":
        # where the time goes, after the counts were read: the longest
        # prompt's prefill (2048 tokens; seamless's 4096 frames and its
        # longest decoder prompt), and one decode step over all slots of
        # the used cache
        long = max(prompts, key=len)
        tok = torch.as_tensor(long[None, :], device=dev)
        toks = torch.zeros((slots,), dtype=torch.int32, device=dev)
        pos = torch.full((slots,), max_len - 2, dtype=torch.int32,
                         device=dev)
        device_name = _device_kernels(want)
        row["profile"] = {
            f"prefill_{len(long)}": _device_profile(
                lambda: prefill(params, {"tokens": tok, **stub}), dev,
                device_name),
            "decode_step": _device_profile(
                lambda: decode(params, srv.cache, toks, pos), dev,
                _device_kernels(_decode_launches(cfg)))}
        if cfg.family == "dense":
            # the float32 prefill (the 3xTF32 kernel) at cpu_check's depth
            cut, plan32, small = _f32_cut(cfg, params)
            prefill32 = api.make_prefill(cut, shape, plan32)
            row["profile"]["prefill_2048_f32"] = _device_profile(
                lambda: prefill32(small, {"tokens": tok}), dev,
                _device_kernels(_prefill_launches(cfg, torch.float32)))
            del small
        if cfg.moe is not None:
            # one MoE layer on a 2048-token hidden: the expert products,
            # the dispatch's sorts and the gathers apart from attention
            moe = tree_map(lambda a: a[0], params["blocks"]["moe"])
            h = torch.randn((1, 2048, cfg.d_model), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(3)).to(torch.bfloat16)
            row["profile"]["moe_layer_2048"] = _device_profile(
                torch.inference_mode()(lambda: M.moe_apply(
                    moe, cfg, h, group_size=plan.moe_group_size)), dev,
                device_name)
            del moe, h
    if cpu_check:
        row["cpu_check"] = _lm_cpu_check(cfg, params, reqs[0].prompt, dev,
                                         depth=cpu_check_depth, stub=stub)
    row["ragged_check"] = _lm_ragged_check(cfg, dev)
    if cfg.moe is not None:
        row["decode_vs_cpu"] = _decode_vs_cpu(cfg, params, dev,
                                              *decode_check)
    else:
        row["decode_vs_prefill"] = _decode_vs_prefill(cfg, plan, params,
                                                      reqs[0], dev,
                                                      stub=stub)
    row["seconds"] = time.perf_counter() - t_phase
    emit(phase or f"lm_{cfg.family}", **row)
    row["kept"] = [{"prompt": r.prompt, "logits": lg,
                    "tokens": list(r.out_tokens)}
                   for r, lg in zip(reqs, kept_logits)]
    return row


# -- LM serving and training on a mesh ----------------------------------------

def _sharded_serve(dev, cfg, plan, mesh, kept, slots, max_len,
                   new_tokens) -> dict:
    """``kept``'s requests served through ``BatchServer`` on the mesh: the
    parameters seeded as ``phase_lm`` seeds them and placed by
    ``param_specs``, each prefill's logits against ``phase_lm``'s, the
    tokens equal or near-ties (``decode_vs_prefill``'s margin: where they
    part, a prefill over the prompt and the shared tokens on the mesh
    puts the two candidates within DECODE_NEAR_TIE), one flash launch a
    layer a prefill and one CP combine a layer a decode step; then one
    decode step over all slots timed with CP, without it (the naive
    route: the spans gathered) and unsharded (the same weights whole),
    and the host's part of it: one all-reduce of a combine's size, one
    layer's weights gathered; the weight gathers and tensor-parallel
    collectives of the run and of one decode step, none on a 1-rank
    mesh."""
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             plan, dev)
    shape = ShapeConfig("serve", "decode", max_len, slots)
    with plan_scope(mesh, plan):
        placed = api.distribute(params, api.to_shardings(
            mesh, api.param_specs(cfg, plan, params)))
        prefill = api.make_prefill(cfg, shape, plan)
        decode = api.make_decode_step(cfg, shape, plan)
        logit_err, prefill_ms, decode_ms = [], [], []

        def timed_prefill(p, tok):
            t1 = time.perf_counter()
            out = prefill(p, {"tokens": tok})
            sync(dev)
            prefill_ms.append((time.perf_counter() - t1) * 1e3)
            want = kept[len(logit_err)]["logits"]
            logit_err.append(float((out[0][0].float().cpu() - want)
                                   .abs().max()))
            return out

        def timed_decode(p, c, t, pos):
            t1 = time.perf_counter()
            out = decode(p, c, t, pos)
            sync(dev)
            decode_ms.append((time.perf_counter() - t1) * 1e3)
            return out

        srv = BatchServer(slots=slots, max_len=max_len,
                          prefill_fn=timed_prefill, decode_fn=timed_decode,
                          params=placed, init_cache_fn=lambda b, ml:
                          api.init_cache(cfg, b, ml, torch.bfloat16, dev))
        reqs = [Request(i, k["prompt"], new_tokens)
                for i, k in enumerate(kept)]
        ops.reset_launches()
        L.reset_cp_combines()
        partition.reset_weight_gathers()
        partition.reset_tp_collectives()
        t0 = time.perf_counter()
        srv.run(reqs)
        sync(dev)
        run_s = time.perf_counter() - t0
        launches, combines = counters.read(ops.LAUNCHES), L.cp_combines()
        run_gathers = partition.weight_gathers()
        run_tp = partition.tp_collectives()
        tokens = []
        for r, k in zip(reqs, kept):
            got, want = r.out_tokens, k["tokens"]
            part = next((i for i, (a, b) in enumerate(zip(got, want))
                         if a != b), None)
            t = {"rid": r.rid, "equal": got == want, "parted_at": part}
            if part is not None:
                toks = np.concatenate([r.prompt,
                                       np.asarray(got[:part], np.int32)])
                logits = _prefill_logits(cfg, plan, placed, toks, dev)
                t["gap"] = float((logits[got[part]]
                                  - logits[want[part]]).abs())
            tokens.append(t)
        # one decode step over all slots at the end of the cache, each way
        toks = torch.zeros((slots,), dtype=torch.int32, device=dev)
        pos = torch.full((slots,), max_len - 2, dtype=torch.int32,
                         device=dev)
        cp_step = lambda: decode(placed, srv.cache, toks, pos)
        partition.reset_weight_gathers()
        partition.reset_tp_collectives()
        cp_step()
        step_gathers = partition.weight_gathers()
        step_tp = partition.tp_collectives()
        timed = {"cp": call_ms(cp_step, dev, iters=SHARDED_DECODE_TIMED,
                               warmup=1)}
        profile = {"decode_step_cp": _device_profile(
            cp_step, dev, [], top=8)} if dev.type == "cuda" else None
        # the host's part: one all-reduce of a CP combine's size over
        # "model", one layer's weights gathered over the fsdp axes
        combine = torch.zeros((slots, cfg.num_heads, cfg.head_dim + 1),
                              device=dev)
        timed["all_reduce"] = call_ms(lambda: partition.all_reduce(
            combine, dist.ReduceOp.SUM, "model"), dev, warmup=1)
        layer = tree_map(lambda a: a[0], placed["blocks"])
        with torch.no_grad():
            timed["gather_layer"] = call_ms(lambda: gather_fsdp(layer), dev,
                                            warmup=1)
        naive = api.make_decode_step(cfg, shape, plan.with_(decode_cp=False))
        with plan_scope(mesh, plan.with_(decode_cp=False)):
            timed["naive"] = call_ms(lambda: naive(placed, srv.cache, toks,
                                                   pos), dev,
                                     iters=SHARDED_DECODE_TIMED, warmup=1)
    whole = tree_map(lambda t: t.full_tensor(), srv.cache)
    timed["unsharded"] = call_ms(lambda: decode(params, whole, toks, pos),
                                 dev, iters=SHARDED_DECODE_TIMED, warmup=1)
    if profile is not None:
        profile["decode_step_unsharded"] = _device_profile(
            lambda: decode(params, whole, toks, pos), dev, [], top=8)
    del whole
    want = {k: n * len(reqs) for k, n in
            _prefill_launches(cfg, torch.bfloat16).items()}
    row = {"requests": len(reqs), "slots": slots, "max_len": max_len,
           "new_tokens": new_tokens, "prompt_lengths":
           [len(r.prompt) for r in reqs], "run_s": run_s,
           "prefill_logits_max_abs_err": logit_err,
           "logit_tol": SHARDED_LOGIT_TOL, "tokens": tokens,
           "near_tie": DECODE_NEAR_TIE, "launches": launches,
           "prefill_launches": want, "cp_combines": combines,
           "weight_gathers": run_gathers, "tp_collectives": run_tp,
           "decode_step_weight_gathers": step_gathers,
           "decode_step_tp_collectives": step_tp,
           "decode_steps": srv.stats["decode_steps"],
           "prefill_ms": prefill_ms,
           "decode_step_ms_median": statistics.median(decode_ms),
           "decode_step_call_ms": timed, "profile": profile}
    for r in reqs:
        check(r.done and len(r.out_tokens) == new_tokens,
              f"lm_sharded request {r.rid}: {len(r.out_tokens)} tokens")
    check(len(logit_err) == len(reqs) and
          max(logit_err) <= SHARDED_LOGIT_TOL,
          f"lm_sharded: prefill logits off lm_dense's by {logit_err}")
    check(all(t["equal"] or t["gap"] <= DECODE_NEAR_TIE for t in tokens),
          f"lm_sharded: tokens part from lm_dense's: {tokens}")
    if dev.type == "cuda":
        _check_launches(launches, want, "lm_sharded serving")
    check(combines == cfg.num_layers * srv.stats["decode_steps"],
          f"lm_sharded: {combines} CP combines, want {cfg.num_layers} x "
          f"{srv.stats['decode_steps']} decode steps")
    # a (1, 1) mesh: nothing to gather and no collective of the split
    check(run_gathers == 0 and step_gathers == 0,
          f"lm_sharded: {run_gathers} weight gathers serving, "
          f"{step_gathers} a decode step, on a 1-rank mesh")
    check(not any(run_tp.values()) and not any(step_tp.values()),
          f"lm_sharded: tensor-parallel collectives on a 1-rank mesh: "
          f"{run_tp}, a decode step {step_tp}")
    return row


def _sharded_train(dev, cfg, mesh, batch, seq, steps) -> dict:
    """``steps`` train steps (PlanConfig defaults) of ``cfg`` on the mesh,
    the state placed by ``train_state_specs``, against as many unsharded
    steps from the same state and batches: each loss within 1e-4 relative,
    the masters within atol 1e-3 / rtol 3e-3 (the train cpu_check's
    tolerances), each step's flash launches (forward and remat
    recompute); the steps' times on the host clock, to the loss read, the
    unsharded steps run before and after the sharded ones (the first run
    pays the card's warm-up)."""
    plan = PlanConfig()
    opt = AdamW(learning_rate=TRAIN_LR)
    state = api.init_train_state(cfg, plan,
                                 torch.Generator(device=dev).manual_seed(0),
                                 opt, dev)
    stream = TokenStream(cfg.vocab_size, batch, seq, seed=0)
    batches = [{"tokens": stream.batch_at(i).to(dev)} for i in range(steps)]
    step = api.make_train_step(cfg, plan, opt)
    want = _step_launches(cfg, torch.bfloat16)

    def run(s):
        losses, ms, launches = [], [], []
        for b in batches:
            ops.reset_launches()
            t1 = time.perf_counter()
            s, m = step(s, b)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t1) * 1e3)
            launches.append(counters.read(ops.LAUNCHES))
        return s, losses, ms, launches

    plain, plain_losses, plain_ms, _ = run(state)
    with plan_scope(mesh, plan):
        placed = api.distribute(state, api.to_shardings(
            mesh, api.train_state_specs(cfg, plan, state)))
        partition.reset_weight_gathers()
        partition.reset_tp_collectives()
        sharded, losses, ms, launches = run(placed)
        gathers, tp = partition.weight_gathers(), partition.tp_collectives()
    del placed
    plain_ms_after = run(state)[2]
    del state
    worst, worst_leaf = max(
        (float(((a.full_tensor() - w).abs() - 3e-3 * w.abs()).max()), k)
        for (k, a), w in zip(_leaf_paths(sharded["master"]),
                             tree_leaves(plain["master"])))
    loss_err = [abs(a - b) / abs(b) for a, b in zip(losses, plain_losses)]
    row = {"model": cfg.name, "layers": cfg.num_layers, "batch": batch,
           "seq": seq, "steps": steps, "losses": losses,
           "losses_unsharded": plain_losses, "loss_rel_err": loss_err,
           "step_ms": ms, "step_ms_unsharded": plain_ms,
           "step_ms_unsharded_after": plain_ms_after,
           "master_worst_excess": worst, "master_worst_leaf": worst_leaf,
           "master_tol": {"atol": 1e-3, "rtol": 3e-3},
           "launches_per_step": launches, "step_launches": want,
           "weight_gathers": gathers, "tp_collectives": tp}
    check(gathers == 0 and not any(tp.values()),
          f"lm_sharded train: {gathers} weight gathers, collectives {tp} "
          f"on a 1-rank mesh")
    check(max(loss_err) <= 1e-4, f"lm_sharded train: losses {losses} vs "
          f"{plain_losses}")
    check(worst <= 1e-3, f"lm_sharded train: master {worst_leaf} off by "
          f"{worst} beyond rtol 3e-3")
    if dev.type == "cuda":
        for counts in launches:
            _check_launches(counts, want, "lm_sharded train step")
    return row


def phase_lm_sharded(dev, dense: dict, cfg=None, slots=LM_SLOTS,
                     max_len=LM_MAX_LEN, new_tokens=LM_NEW_TOKENS,
                     train_cfg=None, train_batch=SHARDED_TRAIN_BATCH,
                     train_seq=TRAIN_SEQ) -> dict:
    """internlm2-1.8b on a (1, 1) ("data", "model") mesh over a 1-rank
    process group (NCCL on the card, from a ``FileStore`` in a temporary
    directory: no network), under ``decode_cp``: ``lm_dense``'s first
    requests served (``_sharded_serve``) and train steps at full width and
    SHARDED_TRAIN_DEPTH (``_sharded_train``).  The group is destroyed
    whatever happens; a failure to open it fails the phase."""
    t_phase = time.perf_counter()
    cfg = cfg or get_arch("internlm2-1.8b")
    train_cfg = train_cfg or _cut(cfg, SHARDED_TRAIN_DEPTH)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory(prefix="chip-smoke-group-") as d:
        dist.init_process_group(backend, store=dist.FileStore(
            os.path.join(d, "store"), 1), rank=0, world_size=1)
        try:
            mesh = make_mesh_compat((1, 1), ("data", "model"), dev.type)
            row = {"backend": backend, "mesh": [1, 1],
                   "serve": _sharded_serve(
                       dev, cfg, PlanConfig(decode_cp=True), mesh,
                       dense["kept"][:SHARDED_REQUESTS], slots, max_len,
                       new_tokens),
                   "train": _sharded_train(dev, train_cfg, mesh, train_batch,
                                           train_seq, SHARDED_TRAIN_STEPS)}
        finally:
            dist.destroy_process_group()
    row["launches"] = row["serve"]["launches"]
    row["seconds"] = time.perf_counter() - t_phase
    emit("lm_sharded", **row)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return row


def phase_tp_rank(dev, cfg=None, ways=TP_RANK_WAYS, prompt=TP_RANK_PROMPT,
                  slots=LM_SLOTS, max_len=LM_MAX_LEN, steps=TP_RANK_STEPS,
                  flash_shapes=TP_RANK_FLASH, ssd_shape=None,
                  phase="tp_rank") -> dict:
    """Rank 0's share of a model (internlm2-1.8b by default) split ``ways``
    ways over "model" (``TP_RANK_*``): its local weights, a prefill of
    ``prompt`` tokens (warmed up once, then timed twice and traced once),
    ``steps`` decode steps at ``slots`` slots of ``max_len``, each hand
    kernel's launches and shapes in one prefill (flash at ``flash_shapes``,
    SSD at ``ssd_shape`` or nowhere), the split's collectives and weight
    gathers over "model" (a Mamba mixer's: one gated-norm sum a layer, its
    sequence-parallel entry and exit, and only the conv's weights
    gathered), and the phase's peak memory.  The fake group's collectives
    leave their outputs as allocated, so the values are not the model's
    and none is checked; the shapes and counts are."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    t_phase = time.perf_counter()
    cfg = cfg or get_arch("internlm2-1.8b")
    plan = PlanConfig(decode_cp=True)
    shape = ShapeConfig("serve", "decode", max_len, slots)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    seen, ssd_seen = [], []
    flash, ssd = ops.flash_attention, ops.ssd_intra

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape)))
        return flash(q, k, v, **kw)

    def ssd_spy(x, da, B, C):
        ssd_seen.append(tuple(x.shape) + tuple(B.shape[2:]))
        return ssd(x, da, B, C)

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ways)
    ops.flash_attention, ops.ssd_intra = spy, ssd_spy
    try:
        mesh = make_mesh_compat((1, ways), ("data", "model"), dev.type)
        params = api.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), plan, dev)
        with plan_scope(mesh, plan):
            placed = api.distribute(params, api.to_shardings(
                mesh, api.param_specs(cfg, plan, params)))
        del params
        local_gb = sum(t.to_local().numel() * t.to_local().element_size()
                       for t in tree_leaves(placed)) / 1e9
        tok = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (1, prompt)).astype(np.int32)).to(dev)
        prefill = api.make_prefill(cfg, shape, plan)
        decode = api.make_decode_step(cfg, shape, plan)
        with plan_scope(mesh, plan):
            mixer = cfg.ssm is not None and ssm.mixer_splits(cfg)
            run_prefill = lambda: prefill(placed, {"tokens": tok})
            run_prefill()
            sync(dev)
            ops.reset_launches()
            counters.reset([(flash_attention_cuda, "launches_tc_split")])
            seen.clear()
            ssd_seen.clear()
            partition.reset_tp_collectives()
            partition.reset_weight_gathers()
            prefill_ms = []
            for _ in range(2):
                t0 = time.perf_counter()
                run_prefill()
                sync(dev)
                prefill_ms.append((time.perf_counter() - t0) * 1e3)
            launches = counters.read(ops.LAUNCHES)
            split = flash_attention_cuda.launches_tc_split // 2
            tp = partition.tp_collectives()
            gathered = partition.model_gathers()
            shapes, ssd_shapes = sorted(set(seen)), sorted(set(ssd_seen))
            kernels = _device_kernels(_prefill_launches(cfg,
                                                        torch.bfloat16))
            profile = _device_profile(run_prefill, dev, kernels, top=8,
                                      warm=False) \
                if dev.type == "cuda" else None
            cache = api.init_cache(cfg, slots, max_len, torch.bfloat16, dev)
            toks = torch.zeros((slots,), dtype=torch.int32, device=dev)
            decode_ms = []
            for i in range(steps + 1):
                pos = torch.full((slots,), prompt + i, dtype=torch.int32,
                                 device=dev)
                t0 = time.perf_counter()
                decode(placed, cache, toks, pos)
                sync(dev)
                decode_ms.append((time.perf_counter() - t0) * 1e3)
            cache_gb = sum(t.to_local().numel() * t.to_local().element_size()
                           for t in tree_leaves(cache)) / 1e9
            del cache
    finally:
        ops.flash_attention, ops.ssd_intra = flash, ssd
        dist.destroy_process_group()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 \
        if dev.type == "cuda" else None
    per_prefill = {k: n // 2 for k, n in launches.items() if n}
    tp_per = {k: n // 2 for k, n in tp.items()}
    gathered_per = {k: n // 2 for k, n in gathered.items()}
    row = {"model": cfg.name, "mesh": [1, ways], "rank": 0,
           "backend": "fake", "values_checked": False,
           "note": "the fake group's collectives move nothing: shapes, "
                   "launches and times only, no value checked",
           "prompt": prompt, "slots": slots, "max_len": max_len,
           "local_weights_gb": local_gb, "local_cache_gb": cache_gb,
           "peak_mem_gb": peak, "prefill_ms": prefill_ms,
           "decode_step_ms": decode_ms[1:], "decode_first_ms": decode_ms[0],
           "launches": per_prefill, "split_launches": split,
           "flash_shapes": shapes,
           "ssd_shapes": ssd_shapes, "mixer_splits": mixer,
           "tp_collectives_per_prefill": tp_per,
           "model_gathers_per_prefill": gathered_per,
           "profile_prefill": profile}
    if dev.type == "cuda":
        want = _prefill_launches(cfg, torch.bfloat16)
        check(per_prefill == want,
              f"{phase}: {per_prefill} launches a prefill, want {want}")
        # a rank's heads are a grid under one wave: every "tc" launch of
        # the prefill splits its keys, as split_plan says on this card
        (b, sq, h, d), (_, sk, kv, _) = flash_shapes
        plan_split = split_plan(
            b, h, sq, sk, True,
            torch.cuda.get_device_properties(dev).multi_processor_count,
            tc_key_tile(d, d))
        row["split_plan"] = list(plan_split)
        want_split = per_prefill.get("flash_attention_tc", 0) \
            if plan_split[0] > 1 else 0
        check(split == want_split, f"{phase}: {split} split launches a "
              f"prefill, want {want_split}")
    check(shapes == [tuple(flash_shapes)],
          f"{phase}: flash ran at {shapes}, want {flash_shapes}")
    check(ssd_shapes == ([tuple(ssd_shape)] if ssd_shape else []),
          f"{phase}: SSD ran at {ssd_shapes}, want {ssd_shape}")
    check(tp["g"] > 0 and tp["seq_exit"] > 0,
          f"{phase}: the split issued no collectives: {tp}")
    if cfg.ssm is not None:
        n = cfg.num_layers
        check(mixer and tp_per["sum"] == n and tp_per["seq_enter"] >= n
              and tp_per["seq_exit"] >= n,
              f"{phase}: the mixer's collectives a prefill {tp_per}, want "
              f"{n} gated-norm sums and a sequence pair a layer")
    want = {"conv_w": cfg.num_layers, "conv_b": cfg.num_layers} \
        if cfg.ssm is not None else {}
    check(gathered_per == want,
          f"{phase}: weights gathered over \"model\" a prefill "
          f"{gathered_per}, want {want}")
    row["seconds"] = time.perf_counter() - t_phase
    emit(phase, **row)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return row


def phase_dryrun(dev, arch=DRYRUN_ARCH, shape=DRYRUN_SHAPE, mesh_shape=None,
                 flash_shape=DRYRUN_FLASH_SHAPE) -> dict:
    """``launch.dryrun.run_cell`` of ``arch`` x ``shape`` (codeqwen1.5-7b
    at train_4k: names, or config objects to rehearse) as rank 0 of the
    production mesh (or of ``mesh_shape``), with the cell's default plan:
    the step fits the card; ``state_bytes`` equals the shards the rank
    placed and the specs' count on an ``AbstractMesh``; the fit step
    launched the flash kernel twice a layer and microbatch (forward and
    remat recompute) at the rank's shape (``flash_shape`` at accumulation
    1: its rows divided by the accumulation); the collective tally by kind
    covers the split's collectives; the roofline is finite.  The fake
    group's collectives move nothing: no value is checked."""
    from repro_torch.configs import SHAPES_BY_NAME
    from repro_torch.core.tensorplan import default_plan
    from repro_torch.launch import dryrun
    t_phase = time.perf_counter()
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    sh = SHAPES_BY_NAME[shape] if isinstance(shape, str) else shape
    plan = default_plan(cfg, sh)
    seen = []
    flash = ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape)))
        return flash(q, k, v, **kw)

    ops.flash_attention = spy
    try:
        rec = dryrun.run_cell(cfg, sh, multi_pod=False, plan=plan,
                              device=dev, mesh_shape=mesh_shape)
    finally:
        ops.flash_attention = flash
    accum = rec["plan"]["accum"]
    sizes = mesh_shape or (16, 16)
    mem = rec["memory"]
    meta_total, meta_parts = dryrun.state_bytes(
        cfg, sh, PlanConfig(**rec["plan"]),
        partition.AbstractMesh(("data", "model"), sizes))
    check(rec["state_bytes"] == meta_total
          and mem["placed_bytes"] == meta_total - meta_parts["batch"],
          f"dryrun: state {rec['state_bytes']} bytes, placed "
          f"{mem['placed_bytes']}, the specs' {meta_parts}")
    b, s, _, h, kv, d, _, _ = flash_shape
    rank_shape = ((b // accum, s, h, d), (b // accum, s, kv, d))
    check(sorted(set(seen)) == [rank_shape],
          f"dryrun: flash ran at {sorted(set(seen))}, want {rank_shape}")
    launches = rec["step"]["launches"]
    if dev.type == "cuda":
        check(rec["fits"] and mem["oom"] is None,
              f"dryrun: {cfg.name} x {sh.name} does not fit: "
              f"{mem['peak_reserved_bytes']} bytes reserved, {mem['oom']}")
        want = {k: n * accum for k, n in
                _step_launches(cfg, torch.bfloat16).items()}
        check(launches == want,
              f"dryrun: {launches} launches in the step, want {want}")
    tp, coll = rec["step"]["tp_collectives"], mem["coll_breakdown"]
    n = lambda kind: coll.get(kind, {}).get("count", 0)
    check(n("reduce-scatter") >= tp["seq_exit"]
          and n("all-reduce") >= tp["g"] + tp["sum"] + tp["max"]
          and n("all-gather") >= tp["gather"] + tp["seq_enter"]
          and tp["g"] > 0 and mem["coll_bytes"] > 0,
          f"dryrun: collectives {coll} against the split's {tp}")
    rf = rec["roofline"]
    check(all(math.isfinite(rf[k]) and rf[k] > 0 for k in
              ("t_compute", "t_memory", "t_collective",
               "model_flops_per_device", "roofline_fraction")),
          f"dryrun: roofline {rf}")
    gb = lambda x: None if x is None else x / 1e9
    row = {"model": cfg.name, "shape": sh.name, "mesh": rec["mesh"],
           "rank": 0, "backend": "fake", "values_checked": False,
           "plan": {k: rec["plan"][k] for k in
                    ("accum", "remat", "moment_dtype", "tp", "fsdp",
                     "sp_boundary")},
           "state_gb": gb(rec["state_bytes"]),
           "state_parts_gb": {k: gb(v) for k, v in
                              mem["state_parts"].items()},
           "peak_allocated_gb": gb(mem["peak_allocated_bytes"]),
           "peak_reserved_gb": gb(mem["peak_reserved_bytes"]),
           "capacity_gb": gb(rec["hbm_capacity_bytes"]), "fits": rec["fits"],
           "step_s": mem["step_s"], "place_s": mem["place_s"],
           "launches": launches, "flash_shape": rank_shape,
           "tp_collectives": tp, "coll_breakdown": coll,
           "cost": rec["cost"], "roofline": rf,
           "probe_s": {k: v.get("seconds") for k, v in
                       rec["probes"].items()},
           "device": rec["device"]}
    row["seconds"] = time.perf_counter() - t_phase
    emit("dryrun", **row)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return row


# -- LM training --------------------------------------------------------------

def _rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over the largest |b|."""
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def _grad_check(dev) -> list:
    """Gradients through the kernels' autograd Functions (kernel forward,
    plain backward) against autograd through the plain versions, on the
    card, and the Functions' forward outputs against the plain versions;
    and the device ms of a forward and backward each way.  The SSD backward
    recomputes from the inputs alone, so its gradients show the wiring and
    its forward check holds the kernel; the flash backward reads the
    kernel's output."""
    rows = []
    for b, sq, sk, h, kv, d, causal, dtype, *vw in FLASH_GRAD_SHAPES:
        dv = vw[0] if vw else d
        gen = torch.Generator(device=dev).manual_seed(sq + sk + d)
        q = torch.randn((b, sq, h, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, sk, kv, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, sk, kv, dv), generator=gen, device=dev).to(dtype)
        do = torch.randn((b, sq, h, dv), generator=gen, device=dev).to(dtype)
        ins = [t.requires_grad_(True) for t in (q, k, v)]
        kernel = "flash_attention_" + variant(dtype, d)
        ops.reset_launches()
        out = ops.flash_attention(*ins, causal=causal)
        got = torch.autograd.grad(out, ins, do)
        sync(dev)
        launches = counters.read(ops.LAUNCHES)
        want = torch.autograd.grad(flash_attention_ref(*ins, causal=causal),
                                   ins, do)
        errs = {f"d{n}": _rel_err(a, w) for n, a, w in zip("qkv", got, want)}
        shape = [b, sq, sk, h, kv, d]
        row = {"kernel": "flash_attention", "shape": shape,
               "causal": causal, "v_width": dv,
               "dtype": str(dtype).removeprefix("torch."),
               "variant": kernel, "grad_fn": type(out.grad_fn).__name__,
               "rel_err": errs, "tol": GRAD_TOL[dtype],
               "forward": _flash_out_check(
                   out.detach(), *(t.detach() for t in ins), causal,
                   f"grad_check flash forward {shape} causal={causal} "
                   f"{dtype}"),
               "launches": launches[kernel],
               "fwd_bwd_ms": time_ms(lambda i: torch.autograd.grad(
                   ops.flash_attention(*ins, causal=causal), ins, do), dev,
                   n=10, warmup=2, label=f"flash fwd+bwd {dtype}"),
               "plain_fwd_bwd_ms": time_ms(lambda i: torch.autograd.grad(
                   flash_attention_ref(*ins, causal=causal), ins, do), dev,
                   n=10, warmup=2, label=f"flash plain fwd+bwd {dtype}")}
        rows.append(row)
        emit("train", section="grad_check", **row)
        check(row["grad_fn"] == "FlashAttentionBackward"
              and (dev.type != "cuda" or launches[kernel] == 1),
              f"grad_check {row['shape']}: the forward left the kernel "
              f"({row['grad_fn']}, {launches})")
        check(all(e <= GRAD_TOL[dtype] for e in errs.values()),
              f"grad_check flash {row['shape']} {dtype}: {errs}")
    for b, q, h, p, g, n in SSD_GRAD_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(q)
        x = torch.randn((b, q, h, p), generator=gen, device=dev)
        da = -torch.nn.functional.softplus(
            torch.randn((b, q, h), generator=gen, device=dev))
        B = torch.randn((b, q, g, n), generator=gen, device=dev)
        C = torch.randn((b, q, g, n), generator=gen, device=dev)
        ins = [t.requires_grad_(True) for t in (x, da, B, C)]
        kernel = "ssd_intra_" + ssd_variant(q, p, n)
        ops.reset_launches()
        outs = ops.ssd_intra(*ins)
        cots = [torch.randn(o.shape, generator=gen, device=dev)
                for o in outs]
        got = torch.autograd.grad(outs, ins, cots)
        sync(dev)
        launches = counters.read(ops.LAUNCHES)
        want = torch.autograd.grad(ssd_intra_ref(*ins), ins, cots)
        errs = {f"d{n_}": _rel_err(a, w)
                for n_, a, w in zip(("x", "da", "B", "C"), got, want)}
        with torch.no_grad():
            want = ssd_intra_ref(*(t.double() for t in ins))
        fwd_errs, fwd_atols = _ssd_out_check(
            [o.detach() for o in outs], want,
            f"grad_check ssd forward {[b, q, h, p, g, n]}")
        del want
        row = {"kernel": "ssd_intra", "shape": [b, q, h, p, g, n],
               "dtype": "float32", "variant": kernel,
               "grad_fn": type(outs[0].grad_fn).__name__, "rel_err": errs,
               "tol": GRAD_TOL[torch.float32],
               "forward": {"max_abs_err_each": dict(zip(SSD_OUTPUTS,
                                                        fwd_errs)),
                           "atol_each": dict(zip(SSD_OUTPUTS, fwd_atols))},
               "launches": launches[kernel],
               "grad_max": {f"d{n_}": float(a.abs().max()) for n_, a in
                            zip(("x", "da", "B", "C"), got)},
               "fwd_bwd_ms": time_ms(lambda i: torch.autograd.grad(
                   ops.ssd_intra(*ins), ins, cots), dev, n=10, warmup=2,
                   label="ssd fwd+bwd"),
               "plain_fwd_bwd_ms": time_ms(lambda i: torch.autograd.grad(
                   ssd_intra_ref(*ins), ins, cots), dev, n=10, warmup=2,
                   label="ssd plain fwd+bwd")}
        rows.append(row)
        emit("train", section="grad_check", **row)
        check(row["grad_fn"] == "SSDIntraBackward"
              and (dev.type != "cuda" or launches[kernel] == 1),
              f"grad_check {row['shape']}: the forward left the kernel "
              f"({row['grad_fn']}, {launches})")
        check(all(v > 0 for v in row["grad_max"].values()),
              f"grad_check ssd {row['shape']}: a zero gradient")
        check(all(e <= GRAD_TOL[torch.float32] for e in errs.values()),
              f"grad_check ssd {row['shape']}: {errs}")
    return rows


def _train_cpu_check(dev, name: str) -> dict:
    """One float32 train step at full width and TRAIN_CHECK_DEPTH (the
    hybrid and the encoder-decoder model: TRAIN_CHECK_DEPTHS,
    at TRAIN_CHECK_SIZES), from one state (a seeded init on the card; on
    the CPU its master's host copy with the optimizer's initial state, the
    zero moments that ``init_train_state`` gives the card) on the card
    (kernels, twice a layer under block remat) and on the CPU (plain
    versions, without the remat's recompute: on the CPU block remat gives
    the same loss and gradients bit for bit, as
    ``test_block_remat_gives_the_same_loss_and_gradients`` holds)."""
    cfg = _cut(get_arch(name), TRAIN_CHECK_DEPTHS.get(name,
                                                      TRAIN_CHECK_DEPTH))
    batch, seq = TRAIN_CHECK_SIZES.get(name, (TRAIN_CHECK_BATCH,
                                              TRAIN_CHECK_SEQ))
    plan = PlanConfig(param_dtype="float32", compute_dtype="float32",
                      master_dtype="float32")
    opt = AdamW(learning_rate=TRAIN_LR)
    # the card steps from the init itself (a step leaves its state as it
    # was), the CPU from its host copy
    state = api.init_train_state(
        cfg, plan, torch.Generator(device=dev).manual_seed(0), opt, dev)
    t0 = time.perf_counter()
    master = tree_map(lambda t: t.cpu(), state["master"])
    host_state = {"master": master, "opt": opt.init(master),
                  "step": state["step"].cpu()}
    copy_s = time.perf_counter() - t0
    data = {"tokens": TokenStream(cfg.vocab_size, batch, seq,
                                  seed=0).batch_at(0),
            **_stub(cfg, batch, 0, torch.device("cpu"), torch.float32,
                    frames=TRAIN_CHECK_FRAMES)}
    step = api.make_train_step(cfg, plan, opt)
    ops.reset_launches()
    card, m_card = step(state, {k: t.to(dev) for k, t in data.items()})
    del state
    sync(dev)
    launches = counters.read(ops.LAUNCHES)
    host_step = api.make_train_step(cfg, plan.with_(remat="none"), opt)
    t0 = time.perf_counter()
    host, m_host = host_step(host_state, data)
    host_s = time.perf_counter() - t0
    del host_state, master
    # the comparisons run on the card, each CPU leaf copied there
    t0 = time.perf_counter()
    # the largest |card - cpu| - 3e-3 |cpu| over the master's leaves
    worst, worst_leaf = max(
        (float(((a - w.to(dev)).abs() - 3e-3 * w.to(dev).abs()).max()), k)
        for (k, a), w in zip(_leaf_paths(card["master"]),
                             tree_leaves(host["master"])))
    # each leaf's gradient: the first step's moment m, (1 - b1) times the
    # clipped gradient, against the CPU's over its largest magnitude (a
    # leaf whose gradient is lost on the card reads 1; the master's first
    # Adam step moves no element by more than lr and cannot show it)
    grad_worst, grad_worst_leaf = max(
        (_rel_err(a, w.to(dev)), k)
        for (k, a), w in zip(_leaf_paths(card["opt"]["m"]),
                             tree_leaves(host["opt"]["m"])))
    compare_s = time.perf_counter() - t0
    row = {"model": cfg.name, "layers": cfg.num_layers,
           "encoder_layers": cfg.encoder_layers, "batch": batch, "seq": seq,
           **{f"{k}_shape": list(t.shape) for k, t in data.items()
              if k != "tokens"},
           "dtype": "float32", "loss_card": float(m_card["loss"]),
           "loss_cpu": float(m_host["loss"]),
           "grad_norm_card": float(m_card["grad_norm"]),
           "grad_norm_cpu": float(m_host["grad_norm"]),
           "master_worst_excess": worst, "master_worst_leaf": worst_leaf,
           "master_tol": {"atol": 1e-3, "rtol": 3e-3},
           "grad_worst_rel_err": grad_worst,
           "grad_worst_leaf": grad_worst_leaf, "grad_tol": TRAIN_GRAD_TOL,
           "cpu_step_s": host_s, "copy_s": copy_s, "compare_s": compare_s,
           "launches": launches}
    row["loss_rel_err"] = abs(row["loss_card"] - row["loss_cpu"]) \
        / abs(row["loss_cpu"])
    row["grad_norm_rel_err"] = abs(row["grad_norm_card"]
                                   - row["grad_norm_cpu"]) \
        / abs(row["grad_norm_cpu"])
    emit("train", section="cpu_check", **row)
    if dev.type == "cuda":
        _check_launches(launches, _step_launches(cfg, torch.float32),
                        f"train cpu_check {name}")
    check(row["loss_rel_err"] <= 1e-4,
          f"train cpu_check {name}: loss {row['loss_card']} vs "
          f"{row['loss_cpu']}")
    check(row["grad_norm_rel_err"] <= 1e-3,
          f"train cpu_check {name}: grad norm {row['grad_norm_card']} vs "
          f"{row['grad_norm_cpu']}")
    check(worst <= 1e-3, f"train cpu_check {name}: master {worst_leaf} off "
          f"by {worst} beyond rtol 3e-3")
    check(grad_worst <= TRAIN_GRAD_TOL,
          f"train cpu_check {name}: gradient of {grad_worst_leaf} off by "
          f"{grad_worst} of its largest magnitude")
    return row


def _leaf_paths(tree, prefix=""):
    """(path, leaf) pairs of a tree in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [pair for k, v in tree.items()
                for pair in _leaf_paths(v, f"{prefix}/{k}" if prefix else k)]
    return [(prefix, tree)]


def _train_full(dev, name: str, batch: int) -> dict:
    """Train steps of the model at full width and depth (TRAIN_DEPTH's
    models at that depth; PlanConfig defaults) on batches of
    ``TokenStream(seed=0)`` (and the frontend stub's inputs, seeded by the
    step, in bfloat16: internvl2's patches before TRAIN_SEQ - 256 tokens,
    seamless's TRAIN_SEQ frames) through ``ShardedLoader``: one warm-up
    step and TRAIN_STEPS timed ones (host clock from the call to the loss
    read, which waits for the card), each step's launches counted on their
    own; then one more step traced under ``torch.profiler``."""
    cfg = get_arch(name)
    if name in TRAIN_DEPTH:
        cfg = _cut(cfg, TRAIN_DEPTH[name])
    plan = PlanConfig()
    opt = AdamW(learning_rate=TRAIN_LR)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = api.init_train_state(cfg, plan,
                                 torch.Generator(device=dev).manual_seed(0),
                                 opt, dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(state["master"]))
    seq = TRAIN_SEQ - (cfg.num_frontend_tokens if cfg.family == "vlm"
                       else 0)
    stream = TokenStream(cfg.vocab_size, batch, seq, seed=0)
    cpu = torch.device("cpu")
    loader = ShardedLoader(lambda i: {
        "tokens": stream.batch_at(i),
        **_stub(cfg, batch, i, cpu, torch.bfloat16, frames=TRAIN_SEQ)},
        device=dev)
    step = api.make_train_step(cfg, plan, opt)
    want = _step_launches(cfg, torch.bfloat16)
    losses, step_ms, per_step, wait_ms = [], [], [], []
    try:
        for i in range(1 + TRAIN_STEPS):
            t1 = time.perf_counter()
            b = next(loader)
            wait_ms.append((time.perf_counter() - t1) * 1e3)
            ops.reset_launches()
            t1 = time.perf_counter()
            state, metrics = step(state, b)
            losses.append(float(metrics["loss"]))       # waits for the card
            dt = (time.perf_counter() - t1) * 1e3
            per_step.append(counters.read(ops.LAUNCHES))
            if i:
                step_ms.append(dt)
        peak = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None
        profile = _device_profile(lambda: step(state, b), dev,
                                  _device_kernels(want), top=12,
                                  warm=False) if cuda else None
    finally:
        loader.close()
    med = statistics.median(step_ms)
    row = {"model": cfg.name, "family": cfg.family, "params": n_params,
           "layers": cfg.num_layers, "encoder_layers": cfg.encoder_layers,
           "batch": batch, "seq": TRAIN_SEQ, "tokens": seq,
           "compute_dtype": plan.compute_dtype, "remat": plan.remat,
           "init_s": init_s, "losses": losses, "step_ms": step_ms,
           "step_ms_median": med,
           "tokens_per_s": batch * TRAIN_SEQ / (med / 1e3),
           "loader_wait_ms": wait_ms, "peak_mem_gb": peak,
           "launches_per_step": per_step[-1], "step_launches": want,
           "launches": {k: sum(c[k] for c in per_step) for k in want},
           "profile": profile}
    emit("train", section="steps", **row)
    check(all(math.isfinite(x) for x in losses),
          f"train {name}: a loss is not finite: {losses}")
    check(statistics.mean(losses[-2:]) < statistics.mean(losses[:2]),
          f"train {name}: losses did not fall: {losses}")
    # the forward and its recompute under block remat: twice a layer
    for counts in per_step:
        if cuda:
            _check_launches(counts, want, f"train {name} step")
    del state, metrics, b
    if cuda:
        torch.cuda.empty_cache()
    return row


def _train_restart(dev) -> dict:
    """``Trainer.run`` against ``Trainer.run_with_restarts`` with injected
    failures, mamba2-370m at full width and RESTART_DEPTH, from one state;
    then the times of an async save and of a restore onto the card."""
    cfg = dataclasses.replace(get_arch("mamba2-370m"),
                              num_layers=RESTART_DEPTH)
    plan = PlanConfig()
    opt = AdamW(learning_rate=TRAIN_LR)
    state0 = api.init_train_state(cfg, plan,
                                  torch.Generator(device=dev).manual_seed(1),
                                  opt, dev)
    stream = TokenStream(cfg.vocab_size, RESTART_BATCH, RESTART_SEQ, seed=0)
    batch_fn = lambda i: {"tokens": stream.batch_at(i).to(dev)}
    step = api.make_train_step(cfg, plan, opt)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-ckpt-") as d:
        clean = Trainer(step, batch_fn, CheckpointManager(f"{d}/clean"),
                        ckpt_every=RESTART_CKPT_EVERY)
        t0 = time.perf_counter()
        clean.run(state0, RESTART_STEPS)
        clean_s = time.perf_counter() - t0
        faulty = Trainer(step, batch_fn, CheckpointManager(f"{d}/faulty"),
                         ckpt_every=RESTART_CKPT_EVERY,
                         injector=FailureInjector(set(RESTART_FAIL_AT)))
        t0 = time.perf_counter()
        final, restarts = faulty.run_with_restarts(state0, RESTART_STEPS)
        faulty_s = time.perf_counter() - t0
        mgr = CheckpointManager(f"{d}/timing", keep_last=1)
        sync(dev)
        t0 = time.perf_counter()
        mgr.save(1, final)
        save_call_s = time.perf_counter() - t0
        mgr.wait()
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored, _ = mgr.restore(final, device=dev)
        sync(dev)
        restore_s = time.perf_counter() - t0
        same = all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(final), tree_leaves(restored)))
        nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(final))
    a = {h["step"]: h["loss"] for h in clean.history}
    b = {h["step"]: h["loss"] for h in faulty.history}
    errs = [abs(a[i] - b[i]) / abs(a[i]) for i in sorted(a)] \
        if set(a) == set(b) else None
    row = {"model": cfg.name, "layers": cfg.num_layers,
           "batch": RESTART_BATCH, "seq": RESTART_SEQ,
           "steps": RESTART_STEPS, "ckpt_every": RESTART_CKPT_EVERY,
           "fail_at": list(RESTART_FAIL_AT), "restarts": restarts,
           "losses_clean": [a[i] for i in sorted(a)],
           "losses_restarted": [b[i] for i in sorted(b)],
           "loss_rel_err_max": max(errs) if errs else None,
           "clean_s": clean_s, "restarted_s": faulty_s,
           "state_gb": nbytes / 1e9, "save_call_s": save_call_s,
           "save_s": save_s, "restore_s": restore_s,
           "restored_equal": same}
    emit("train", section="restart", **row)
    check(restarts == len(RESTART_FAIL_AT),
          f"restart: {restarts} restarts, want {len(RESTART_FAIL_AT)}")
    check(errs is not None and max(errs) <= 1e-4,
          f"restart: losses differ: {a} vs {b}")
    check(same, "restart: a restored leaf differs from the saved one")
    return row


def phase_train(dev) -> dict:
    """LM training of every family on the card: the kernels' gradients
    (``grad_check``), a train step on the card against the CPU
    (``cpu_check``, all but TRAIN_CHECK_SKIP), full-width steps (full
    depth but mamba2's,
    deepseek's, zamba2's and internvl2's), and restarts from
    checkpoints."""
    t0 = time.perf_counter()
    out = {"grad_check": _grad_check(dev),
           "cpu_check": {n: _train_cpu_check(dev, n) for n in TRAIN_BATCH
                         if n not in TRAIN_CHECK_SKIP},
           "steps": {n: _train_full(dev, n, b)
                     for n, b in TRAIN_BATCH.items()},
           "restart": _train_restart(dev)}
    out["seconds"] = time.perf_counter() - t0
    emit("train", section="total", seconds=out["seconds"])
    return out


def _kernel_entry(name, source, replaces, launches, row) -> dict:
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row.get("library_ms"),
            "call_ms": row["call_ms"],
            **{key: val for key, val in row.items()
               if key.startswith("bound_ops_") or key == "bound_bytes_ms"}}


def kernels_line(haar_row: dict, knn_rows: dict, flash_rows: dict,
                 ssd_rows: dict, decode_row: dict, analytic: dict,
                 serving: dict,
                 procpool: dict, lm_dense: dict, lm_sharded: dict,
                 tp_rank: dict, tp_rank_hybrid: dict, dryrun: dict,
                 lm_ssm: dict,
                 lm_moe: dict, lm_moe_grok: dict, lm_hybrid: dict,
                 lm_vlm: dict, lm_encdec: dict, train: dict) -> dict:
    """Launches of each kernel on its own path: Haar and kNN (all kernels,
    the matrix-vector one at B 1) on the analytic, the tensor-core kNN at
    B 64 on the serving phase's warm run (credited across CUDA graph
    replays; ``pool_launches``: in the procpool phase's workers over its
    three warm runs, and Haar's in its scatter run's workers), the
    bfloat16 tensor-core flash attention on dense LM serving (and grok-1's
    as ``moe_grok_launches``, and the same model's served on a 1-rank mesh
    as ``sharded_launches``, its train steps there as
    ``sharded_train_launches``, one prefill of rank 0 of its four-way
    split as ``tp_rank_launches``), the 3xTF32 one on the dense LM's float32
    prefill (``cpu_check``), the bfloat16 tensor-core one on deepseek-v2-
    lite's serving (MLA: q/k 192, v 128) and on zamba2-7b's (d 112) as
    entries of their own, the warp-level one on the smoke configs' float32
    ragged prefills (``ragged_check``; ``mla_cpu_check_launches``:
    deepseek's float32 prefill at 192, v padded) and on zamba2's float32
    prefill at d 112 (``cpu_check``, an entry of its own), the CUDA-core
    one on phase_flash's entry-point calls (its only caller: widths that
    are not a multiple of 8), the tensor-core SSD on SSM serving, the
    CUDA-core one on the SSM smoke config's ragged prefill
    (``ragged_check``); zamba2-7b's tensor-core SSD at p 64, n 64 as an
    entry of its own, with its times at that path's shape; internvl2-26b's
    serving (the tensor-core flash kernel at a GQA group of 6, 2304 rows)
    and seamless-m4t-medium's (the tensor-core flash kernel at d 64, timed
    at its non-causal encoder's shape; its prefills also run the decoder's
    causal self-attention and its cross-attention on the same kernel) as
    entries of their own; rank 0 of zamba2-7b's four-way split
    (``tp_rank_hybrid``: the tensor-core flash kernel on 8 of 32 heads of
    112, split over keys, the tensor-core SSD on 28 of 112) and of
    internlm2's (``tp_rank``: 4 of 16 heads, split) as three more, timed
    at those shapes (``split_launches``: the launches that split and ran
    flash_fwd_combine);
    rank 0 of codeqwen1.5-7b's (16, 16) train_4k step (``dryrun``: the
    tensor-core flash kernel on 2 of 32 heads, forward and remat
    recompute) as one more, and as ``dryrun_launches`` on the first.
    ``train_launches``: the bfloat16 flash kernel (tensor-core at d 128,
    MLA's 192/128 and zamba2's 112) and SSD in the train
    phase's steps (forward and remat recompute), the 3xTF32 flash kernel in
    its float32 ``cpu_check`` steps.  The CUDA-core flash kernel's times are
    its forced row at the dense smoke config's shape.  Last, the decode
    kernel, which replaces no TPU kernel, on dense LM serving's decode
    steps (``moe_grok_launches``, ``hybrid_launches``, ``vlm_launches``,
    ``encdec_launches``: those of the other families that decode over a
    GQA cache), timed at the decode cell's step (``phase_decode``)."""
    flash = "src/repro/kernels/flash_attention.py:73"
    ssd = "src/repro/kernels/ssd_scan.py:45"
    pool_knn = sum(w["launches"]["knn_scores_tiled"]
                   for w in procpool["warm"].values())
    steps = train["steps"]
    return {"kernels": [
        dict(_kernel_entry("haar", "haar.cu", "src/repro/kernels/haar.py:32",
                           analytic["launches"]["haar"], haar_row),
             pool_launches=procpool["scatter"]["launches"]["haar"]),
        _kernel_entry("knn_scores", "knn.cu", "src/repro/kernels/knn.py:34",
                      analytic["launches"]["knn_scores"], knn_rows[1]),
        dict(_kernel_entry("knn_scores_tiled", "knn.cu",
                           "src/repro/kernels/knn.py:34",
                           serving["warm"]["launches"]["knn_scores_tiled"],
                           knn_rows[64]),
             pool_launches=pool_knn),
        dict(_kernel_entry("flash_attention_tc", "flash_attention.cu",
                           flash, lm_dense["launches"]["flash_attention_tc"],
                           flash_rows["tc"]),
             moe_grok_launches=lm_moe_grok["launches"]["flash_attention_tc"],
             sharded_launches=lm_sharded["launches"]["flash_attention_tc"],
             sharded_train_launches=sum(
                 c["flash_attention_tc"] for c in
                 lm_sharded["train"]["launches_per_step"]),
             tp_rank_launches=tp_rank["launches"].get("flash_attention_tc",
                                                      0),
             dryrun_launches=dryrun["launches"].get("flash_attention_tc",
                                                    0),
             train_launches=steps["internlm2-1.8b"]["launches"]
             ["flash_attention_tc"]),
        dict(_kernel_entry("flash_attention_tc_gqa6_vlm",
                           "flash_attention.cu", flash,
                           lm_vlm["launches"]["flash_attention_tc"],
                           flash_rows["tc_gqa6_vlm"]),
             train_launches=steps["internvl2-26b"]["launches"]
             ["flash_attention_tc"]),
        dict(_kernel_entry("flash_attention_tc_d64_encdec",
                           "flash_attention.cu", flash,
                           lm_encdec["launches"]["flash_attention_tc"],
                           flash_rows["tc_d64_noncausal"]),
             train_launches=steps["seamless-m4t-medium"]["launches"]
             ["flash_attention_tc"]),
        dict(_kernel_entry("flash_attention_tf32", "flash_attention.cu",
                           flash, lm_dense["cpu_check"]["launches"]
                           ["flash_attention_tf32"], flash_rows["tf32"]),
             vlm_launches=lm_vlm["cpu_check"]["launches"]
             ["flash_attention_tf32"],
             encdec_launches=lm_encdec["cpu_check"]["launches"]
             ["flash_attention_tf32"],
             train_launches=sum(train["cpu_check"][n]["launches"]
                                ["flash_attention_tf32"]
                                for n in ("internlm2-1.8b",
                                          "seamless-m4t-medium"))),
        dict(_kernel_entry("flash_attention_tc_mla", "flash_attention.cu",
                           flash, lm_moe["launches"]["flash_attention_tc"],
                           flash_rows["tc_mla"]),
             train_launches=steps["deepseek-v2-lite-16b"]["launches"]
             ["flash_attention_tc"]),
        dict(_kernel_entry("flash_attention_tc_d112", "flash_attention.cu",
                           flash,
                           lm_hybrid["launches"]["flash_attention_tc"],
                           flash_rows["tc_d112"]),
             train_launches=steps["zamba2-7b"]["launches"]
             ["flash_attention_tc"]),
        dict(_kernel_entry("flash_attention_mma", "flash_attention.cu",
                           flash,
                           sum(row["ragged_check"]["launches"]
                               ["flash_attention_mma"]
                               for row in (lm_dense, lm_moe, lm_hybrid,
                                           lm_vlm, lm_encdec)),
                           flash_rows["mma"]),
             mla_cpu_check_launches=lm_moe["cpu_check"]["launches"]
             ["flash_attention_mma"]),
        dict(_kernel_entry("flash_attention_mma_d112_f32",
                           "flash_attention.cu", flash,
                           lm_hybrid["cpu_check"]["launches"]
                           ["flash_attention_mma"],
                           flash_rows["mma_d112_f32"])),
        _kernel_entry("flash_attention_simt", "flash_attention.cu", flash,
                      flash_rows["entry_launches"]["flash_attention_simt"],
                      flash_rows["simt_before"]),
        dict(_kernel_entry("ssd_intra_tc", "ssd_scan.cu", ssd,
                           lm_ssm["launches"]["ssd_intra_tc"],
                           ssd_rows["tc"]),
             train_launches=steps["mamba2-370m"]["launches"]["ssd_intra_tc"]),
        dict(_kernel_entry("ssd_intra_tc_p64_n64", "ssd_scan.cu", ssd,
                           lm_hybrid["launches"]["ssd_intra_tc"],
                           ssd_rows["tc_p64_n64"]),
             cpu_check_launches=lm_hybrid["cpu_check"]["launches"]
             ["ssd_intra_tc"],
             train_launches=steps["zamba2-7b"]["launches"]["ssd_intra_tc"]),
        _kernel_entry("ssd_intra_simt", "ssd_scan.cu", ssd,
                      lm_ssm["ragged_check"]["launches"]["ssd_intra_simt"],
                      ssd_rows["simt"]),
        dict(_kernel_entry("flash_attention_tc_tp_rank_hybrid",
                           "flash_attention.cu", flash,
                           tp_rank_hybrid["launches"].get(
                               "flash_attention_tc", 0),
                           flash_rows["tc_tp_rank_hybrid"]),
             split_launches=tp_rank_hybrid["split_launches"]),
        dict(_kernel_entry("flash_attention_tc_tp_rank",
                           "flash_attention.cu", flash,
                           tp_rank["launches"].get("flash_attention_tc", 0),
                           flash_rows["tc_tp_rank"]),
             split_launches=tp_rank["split_launches"]),
        _kernel_entry("ssd_intra_tc_tp_rank", "ssd_scan.cu", ssd,
                      tp_rank_hybrid["launches"]["ssd_intra_tc"],
                      ssd_rows["tc_tp_rank"]),
        _kernel_entry("flash_attention_tc_dryrun", "flash_attention.cu",
                      flash, dryrun["launches"]["flash_attention_tc"],
                      flash_rows["tc_dryrun"]),
        dict(_kernel_entry("decode_attention", "decode_attention.cu", None,
                           lm_dense["launches"]["decode_attention"],
                           decode_row),
             moe_grok_launches=lm_moe_grok["launches"]["decode_attention"],
             hybrid_launches=lm_hybrid["launches"]["decode_attention"],
             vlm_launches=lm_vlm["launches"]["decode_attention"],
             encdec_launches=lm_encdec["launches"]["decode_attention"],
             bound_cache_ms=decode_row["bound_cache_ms"]),
    ]}


def timed_phase(phase: str, fn, *args):
    """``fn(*args)``, then the phase's line with its wall seconds (the
    phases that print no such line of their own)."""
    t0 = time.perf_counter()
    out = fn(*args)
    emit(phase, section="total", seconds=time.perf_counter() - t0)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    timed_phase("device", phase_device, dev)
    haar_row = timed_phase("haar", phase_haar, dev)
    knn_rows = timed_phase("knn", phase_knn, dev)
    flash_rows = timed_phase("flash_attention", phase_flash, dev)
    ssd_rows = timed_phase("ssd_intra", phase_ssd, dev)
    decode_row = timed_phase("decode_attention", phase_decode, dev)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as state_dir:
        timed_phase("quickstart", phase_quickstart, dev, state_dir)
    data = analytic_data(dev)
    analytic = timed_phase("analytic", phase_analytic, dev, data)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as state_dir:
        serving = timed_phase("serving", phase_serving, dev, data, state_dir)
        procpool = phase_procpool(dev, data, state_dir)
    del data
    lm_dense = phase_lm(dev, "internlm2-1.8b", keep=SHARDED_REQUESTS)
    lm_sharded = phase_lm_sharded(dev, lm_dense)
    tp_rank = phase_tp_rank(dev)
    tp_rank_hybrid = phase_tp_rank(
        dev, cfg=get_arch("zamba2-7b"), flash_shapes=TP_RANK_HYBRID_FLASH,
        ssd_shape=TP_RANK_HYBRID_SSD, phase="tp_rank_hybrid")
    dry = phase_dryrun(dev)
    lm_ssm = phase_lm(dev, "mamba2-370m")
    lm_moe = phase_lm(dev, "deepseek-v2-lite-16b")
    grok = get_arch("grok-1-314b")
    lm_moe_grok = phase_lm(dev, grok.name, cfg=_cut(grok, GROK_DEPTH),
                           n_req=GROK_REQUESTS, phase="lm_moe_grok",
                           cpu_check=False, decode_check=GROK_DECODE_CHECK)
    lm_hybrid = phase_lm(dev, "zamba2-7b", n_req=HYBRID_REQUESTS,
                         phase="lm_hybrid", cpu_check_depth=HYBRID_CHECK_DEPTH)
    lm_vlm = phase_lm(dev, "internvl2-26b", n_req=VLM_REQUESTS)
    lm_encdec = phase_lm(dev, "seamless-m4t-medium", n_req=ENCDEC_REQUESTS)
    train = phase_train(dev)
    emit("total", seconds=time.perf_counter() - t0,
         host_behind=HOST_BEHIND)
    line = kernels_line(haar_row, knn_rows, flash_rows, ssd_rows,
                        decode_row, analytic,
                        serving, procpool, lm_dense, lm_sharded, tp_rank,
                        tp_rank_hybrid, dry, lm_ssm, lm_moe, lm_moe_grok,
                        lm_hybrid, lm_vlm, lm_encdec, train)
    idle = [k["name"] for k in line["kernels"] if not k["launches"] > 0]
    check(not idle, f"kernels never launched on their paths: {idle}")
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
