"""Tensor plans: BigDAWG's planner/monitor protocol applied to the port's
training and serving steps.

The port of ``repro.core.tensorplan``.  A ``PlanConfig`` is an *engine
choice* for an (architecture x input-shape x mesh) cell: sharding regime,
remat policy, accumulation depth, attention layout.  ``default_plan`` is
the a-priori candidate (the paper's island preference order);
``enumerate_variants`` is the training-phase plan space; the dry run's
roofline terms (``launch.dryrun``) are the stats the monitor records;
production picks the plan with the lowest dominant roofline term.

Every field of every plan equals the reference's but two, which are sized
for the card the port runs on, not for the reference's TPU: the
accumulation depth of a training cell (``_TRAIN_ACCUM``) and the optimizer
moments' dtype (``_MOMENT_DTYPE``).  Both come from one rank's measured
step on the card (``launch.dryrun``, ``PERF.md`` §5).  An architecture
that was not measured is in neither table: it takes accumulation 1 and
float32 moments.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ArchConfig, PlanConfig, ShapeConfig
from repro_torch.core.monitor import Monitor

# Accumulation of a train_4k cell: the smallest of (1, 2, 4, 8, 16) that
# divides the rank's batch of 16 rows and whose measured step fits (rank 0
# of the (16, 16) mesh, one full-depth step: the allocator's reserved peak
# within ``launch.dryrun.FIT_MARGIN``, 90%, of the card's 85.0 GB, and no
# out-of-memory error).  Measured on an NVIDIA H100 80GB HBM3 at a 700 W
# power limit by ``python -m repro_torch.launch.sweep --mesh pod --shape
# train_4k`` (every arch at 1: reserved peaks 3.28-38.99 GB, grok-1 out of
# memory at 79.89 GB allocated) and ``python -m repro_torch.launch.hillclimb
# --arch grok-1-314b --shape train_4k`` over its accum variants (2: 73.06
# GB reserved; 4, 8, 16 fit too).
_TRAIN_ACCUM: Dict[str, int] = {
    "mamba2-370m": 1, "seamless-m4t-medium": 1, "internlm2-1.8b": 1,
    "codeqwen1.5-7b": 1, "glm4-9b": 1, "zamba2-7b": 1,
    "deepseek-v2-lite-16b": 1, "internvl2-26b": 1, "qwen2-72b": 1,
    "grok-1-314b": 2,
}

# Moments stay float32 unless only bfloat16 fits (same runs: grok-1's
# float32 moments fit at accumulation 2, and bfloat16 ones do not fit at
# 1, 78.78 GB allocated), so no arch takes bfloat16.
_MOMENT_DTYPE: Dict[str, str] = {}


def default_plan(cfg: ArchConfig, shape: ShapeConfig) -> PlanConfig:
    plan = PlanConfig(name="baseline")
    if shape.mode == "train":
        plan = plan.with_(accum=_TRAIN_ACCUM.get(cfg.name, 1))
    if cfg.name in _MOMENT_DTYPE:
        plan = plan.with_(moment_dtype=_MOMENT_DTYPE[cfg.name])
    if shape.mode != "train":
        plan = plan.with_(remat="none")
    return plan


def enumerate_variants(cfg: ArchConfig, shape: ShapeConfig) -> List[PlanConfig]:
    """Training-phase plan space for hillclimbing."""
    base = default_plan(cfg, shape)
    variants = [base]
    if shape.mode == "train":
        for a in (1, 2, 4, 8, 16):
            if a != base.accum and shape.global_batch % a == 0:
                variants.append(base.with_(name=f"accum{a}", accum=a))
        variants.append(base.with_(name="no_sp", sp_boundary=False))
        variants.append(base.with_(name="no_fsdp", fsdp=False))
        variants.append(base.with_(name="remat_none", remat="none"))
    if shape.mode == "prefill":
        for c in (512, 2048, 4096):
            variants.append(base.with_(name=f"chunk{c}", attn_chunk=c))
    if shape.mode == "decode":
        variants.append(base.with_(name="cache_replicated",
                                   cache_seq_shard=False))
    if cfg.moe is not None:
        variants.append(base.with_(name="no_ep", moe_ep=False))
    variants.append(base.with_(name="no_tp", tp=False))
    return variants


def cell_signature(cfg: ArchConfig, shape: ShapeConfig, mesh_kind: str) -> str:
    """The monitor key for a step's cell: structure, objects and constants,
    like the query signatures in ``core.signature``."""
    return f"cell:{cfg.name}|{shape.name}|{mesh_kind}"


class TensorPlanSelector:
    """Production-phase plan pick from recorded roofline stats."""

    def __init__(self, monitor: Monitor):
        self.monitor = monitor

    def record(self, cfg, shape, mesh_kind, plan: PlanConfig,
               terms: Dict[str, float]):
        sig = cell_signature(cfg, shape, mesh_kind)
        dominant = max(terms["t_compute"], terms["t_memory"],
                       terms["t_collective"])
        self.monitor.record(sig, plan.name, dominant, extra=dict(terms))

    def best(self, cfg, shape, mesh_kind):
        sig = cell_signature(cfg, shape, mesh_kind)
        key, stats, _ = self.monitor.best(sig)
        return key, stats
