"""The system under test: everything the benchmark takes from the port.

This is the only module of the benchmark that imports ``repro_torch``.
It builds the port's ``ArchConfig`` from the ``port`` group of a
configuration's file, asks the port for its parameter shapes, and hands
out its entry points: ``api.make_prefill`` and ``api.make_decode_step``
behind a ``BatchServer``, ``api.make_train_step`` with the port's AdamW,
the launch counters (``ops.launches``) and the server's ``stats``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import (ArchConfig, MLAConfig, MoEConfig,
                                      PlanConfig, ShapeConfig)
from repro_torch.kernels import ops
from repro_torch.models import api
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.server import BatchServer, Request

from harness.weights import flatten

launches, reset_launches = ops.launches, ops.reset_launches


def arch(config: dict) -> ArchConfig:
    p = {k: v for k, v in config["port"].items() if not k.endswith("_note")}
    mla, moe = p.pop("mla", None), p.pop("moe", None)
    return ArchConfig(**p, mla=MLAConfig(**mla) if mla else None,
                      moe=MoEConfig(**moe) if moe else None)


def plan(dtype: str = "bfloat16") -> PlanConfig:
    """The port's default plan; ``dtype`` for parameters and compute (the
    masters and moments stay float32)."""
    return PlanConfig(param_dtype=dtype, compute_dtype=dtype)


def param_shapes(a: ArchConfig, dtype: str) -> dict:
    """The port's parameter tree on ``meta``: shapes and dtypes only."""
    return api.init_params(a, None, PlanConfig(param_dtype=dtype), "meta")


def server(a: ArchConfig, params, slots: int, max_len: int, device,
           dtype=torch.bfloat16) -> BatchServer:
    shape = ShapeConfig("serve", "decode", max_len, slots)
    pl = plan(str(dtype).replace("torch.", ""))
    prefill = api.make_prefill(a, shape, pl)
    return BatchServer(
        slots=slots, max_len=max_len,
        prefill_fn=lambda p, tok: prefill(p, {"tokens": tok}),
        decode_fn=api.make_decode_step(a, shape, pl), params=params,
        init_cache_fn=lambda b, n: api.init_cache(a, b, n, dtype, device))


def adamw(opt: dict) -> AdamW:
    if opt.get("name", "adamw") != "adamw":
        raise ValueError(f"the port has no optimizer {opt['name']!r}")
    return AdamW(**{k: v for k, v in opt.items() if k != "name"})


def train_state(master: dict, optimizer: AdamW) -> dict:
    """The train step's state over masters made by the benchmark, as
    ``api.init_train_state`` lays it out."""
    return {"master": master, "opt": optimizer.init(master),
            "step": torch.zeros((), dtype=torch.int32,
                                device=flatten(master)[0][1].device)}


def train_step(a: ArchConfig, optimizer: AdamW, dtype: str = "bfloat16"):
    return api.make_train_step(a, plan(dtype), optimizer)
