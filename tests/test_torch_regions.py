"""The LM path's profiler regions and work counters, on the CPU.

``core.tracing.region`` marks the serving loop (``BatchServer``), the
model blocks, the MoE layer and the train step as ``record_function``
ranges named ``repro_torch.<name>`` while a profiler runs, and as one
shared no-op context otherwise.  ``kernels.ops.launches()`` reads the work
counts (``expand_kv_bytes``, ``moe_rows_computed``, ``moe_rows_routed``)
beside the launch counts, at their formulas from the shapes.  Smoke
configs of internlm2-1.8b (GQA, 4 query over 2 KV heads) and
deepseek-v2-lite-16b (MLA, 4 experts top-2 with shared experts, a dense
first layer), in float32; zamba2-7b and seamless-m4t-medium at 2 KV heads
for the decode step's counts.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import PlanConfig, ShapeConfig, get_arch
from repro_torch.core import tracing
from repro_torch.kernels import counters, ops
from repro_torch.models import api
from repro_torch.models import moe as M
from repro_torch.optim import AdamW
from repro_torch.runtime import BatchServer, Request

GQA, MOE = "internlm2-1.8b", "deepseek-v2-lite-16b"
HYBRID, ENCDEC = "zamba2-7b", "seamless-m4t-medium"
SLOTS, MAX_LEN = 2, 24
PREFIX = "repro_torch."
# each region and the region it nests in, in serving
SERVE_PARENTS = {"serve.decode.launch": "serve.decode",
                 "serve.decode.wait": "serve.decode"}
MOE_PHASES = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine",
              "moe.shared")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (see
    ``tests/test_torch_models.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plan(remat="none"):
    return PlanConfig(param_dtype="float32", compute_dtype="float32",
                      remat=remat)


def _server(name):
    cfg = get_arch(name).smoke()
    plan = _plan()
    params = api.init_params(cfg, torch.Generator().manual_seed(0), plan,
                             "cpu")
    shape = ShapeConfig("serve", "decode", MAX_LEN, SLOTS)
    prefill = api.make_prefill(cfg, shape, plan)
    return cfg, BatchServer(
        slots=SLOTS, max_len=MAX_LEN,
        prefill_fn=lambda p, t: prefill(p, {"tokens": t}),
        decode_fn=api.make_decode_step(cfg, shape, plan), params=params,
        init_cache_fn=lambda b, n: api.init_cache(cfg, b, n, torch.float32,
                                                  "cpu"))


def _prompt(cfg, n=9, seed=1):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, size=(n,)).astype(np.int32)


def _events(prof):
    """[(name, start_us, end_us)] of the profiler's host events."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()]


def _regions(events, name):
    return [(a, b) for n, a, b in events if n == PREFIX + name]


def _within(inner, outer):
    a, b = inner
    return any(o0 <= a and b <= o1 for o0, o1 in outer)


def _served(name):
    cfg, srv = _server(name)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert srv.submit(Request(0, _prompt(cfg), max_new_tokens=4))
        srv.step()
    return cfg, _events(prof)


@pytest.mark.parametrize("name", [GQA, MOE])
def test_serving_records_nested_regions(name):
    """One ``submit`` and one ``step``: the prefill, the rows' copy and the
    first token, then a decode step whose launch and wait nest in it, with
    the model's regions inside the prefill and inside the launch (an MoE
    block's five phases inside ``model.moe``)."""
    cfg, events = _served(name)
    for region in ("serve.prefill", "serve.write_rows", "serve.first_token",
                   "serve.decode", *SERVE_PARENTS):
        assert len(_regions(events, region)) == 1, region
    for child, parent in SERVE_PARENTS.items():
        assert _within(_regions(events, child)[0],
                       _regions(events, parent))
    dense = cfg.moe.first_dense_layers if cfg.moe else cfg.num_layers
    want = {"model.attention": cfg.num_layers, "model.mlp": dense,
            "model.moe": cfg.num_layers - dense}
    for phase in ("serve.prefill", "serve.decode.launch"):
        outer = _regions(events, phase)
        for block, n in want.items():
            inside = [r for r in _regions(events, block)
                      if _within(r, outer)]
            assert len(inside) == n, (phase, block)
    moe = _regions(events, "model.moe")
    for sub in MOE_PHASES:
        got = _regions(events, sub)
        assert len(got) == (len(moe) if cfg.moe else 0), sub
        assert all(_within(r, moe) for r in got), sub


@pytest.mark.parametrize("name", [GQA, MOE])
def test_decode_ops_fall_inside_the_launch(name):
    """On the profiler's clock every operator of a decode step runs inside
    ``serve.decode.launch`` but the copy of its tokens to the host, which
    runs inside ``serve.decode.wait``: the step's self time is the per-slot
    bookkeeping."""
    _, events = _served(name)
    step = _regions(events, "serve.decode")
    launch = _regions(events, "serve.decode.launch")
    wait = _regions(events, "serve.decode.wait")
    ops_in_step = [(a, b) for n, a, b in events
                   if n.startswith("aten::") and _within((a, b), step)]
    assert len(ops_in_step) > 50
    for op in ops_in_step:
        assert _within(op, launch) or _within(op, wait), op
    assert any(_within(op, wait) for op in ops_in_step)


@pytest.mark.parametrize("name,remat", [(GQA, "none"), (MOE, "block")])
def test_train_step_records_forward_backward_optimizer(name, remat):
    """One train step: ``train.forward``, ``train.backward`` and
    ``train.optimizer`` once each, in that order; the blocks' regions
    inside the forward, and under block remat a second set inside the
    backward (the recompute)."""
    cfg = get_arch(name).smoke()
    plan = _plan(remat)
    opt = AdamW(learning_rate=1e-3)
    state = api.init_train_state(cfg, plan, torch.Generator().manual_seed(0),
                                 opt, "cpu")
    batch = {"tokens": torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(2, 8)).astype(np.int32))}
    step = api.make_train_step(cfg, plan, opt)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    events = _events(prof)
    phases = [_regions(events, f"train.{p}")
              for p in ("forward", "backward", "optimizer")]
    assert [len(p) for p in phases] == [1, 1, 1]
    (f0, f1), (b0, b1), (o0, o1) = (p[0] for p in phases)
    assert f1 <= b0 and b1 <= o0
    attention = _regions(events, "model.attention")
    in_forward = [r for r in attention if _within(r, phases[0])]
    in_backward = [r for r in attention if _within(r, phases[1])]
    assert len(in_forward) == cfg.num_layers
    assert len(in_backward) == (cfg.num_layers if remat == "block" else 0)


def test_no_profiler_makes_no_record_function(monkeypatch):
    """With no profiler running, serving and a train step never reach
    ``record_function``, and every region is the one shared no-op
    context."""
    def boom(*a, **k):
        raise AssertionError("record_function without a profiler")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert tracing.region("serve.decode") is tracing.region("moe.route")
    cfg, srv = _server(MOE)
    assert srv.submit(Request(0, _prompt(cfg), max_new_tokens=3))
    srv.step()
    plan = _plan()
    opt = AdamW(learning_rate=1e-3)
    state = api.init_train_state(cfg, plan, torch.Generator().manual_seed(0),
                                 opt, "cpu")
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    api.make_train_step(cfg, plan, opt)(state, {"tokens": tokens})


def test_region_is_a_record_function_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.region("model.mlp"):
            torch.ones(3).sum()
    events = _events(prof)
    assert _regions(events, "model.mlp")
    assert tracing.region("model.mlp") is tracing.region("x")


@pytest.mark.parametrize("name", [GQA, HYBRID, ENCDEC])
def test_decode_step_counts_the_expanded_kv_bytes(name):
    """``expand_kv_bytes`` after one decode step of a config with 4 query
    over 2 KV heads: the self-attention reads the cache's KV heads in place
    (``ops.decode_attention``) and counts none; the encoder-decoder's
    cross-attention still repeats its k and v (slots x encoder rows x query
    heads x d, float32, each layer)."""
    cfg = dataclasses.replace(get_arch(name).smoke(), num_kv_heads=2)
    assert cfg.num_heads > cfg.num_kv_heads
    plan = _plan()
    params = api.init_params(cfg, torch.Generator().manual_seed(0), plan,
                             "cpu")
    step = api.make_decode_step(cfg, ShapeConfig("serve", "decode", MAX_LEN,
                                                 SLOTS), plan)
    cache = api.init_cache(cfg, SLOTS, MAX_LEN, torch.float32, "cpu")
    ops.reset_launches()
    step(params, cache, torch.tensor([3, 7], dtype=torch.int32),
         torch.tensor([0, MAX_LEN - 1], dtype=torch.int32))
    want = 0
    if cfg.family == "encdec":
        want = cfg.num_layers * 2 * SLOTS * cache["xk"].shape[2] \
            * cfg.num_heads * cfg.head_dim * 4
        assert want > 0
    assert ops.launches()["expand_kv_bytes"] == want
    ops.reset_launches()
    assert ops.launches()["expand_kv_bytes"] == 0


@pytest.mark.parametrize("shape,group_size", [((3, 10), 0), ((2, 12), 4),
                                               ((5,), 0)])
def test_moe_counts_computed_and_routed_rows(shape, group_size):
    """``moe_rows_computed`` = G x experts x C and ``moe_rows_routed`` =
    G x T x k over every group that ``moe_apply`` routes: the sequences of
    a prefill, their chunks of ``group_size``, or the slots of a decode
    step (one group)."""
    cfg = get_arch(MOE).smoke()
    m = cfg.moe
    params = api.init_params(cfg, torch.Generator().manual_seed(0), _plan(),
                             "cpu")
    p = {k: v[0] for k, v in params["blocks"]["moe"].items()
         if k != "shared"}
    p["shared"] = {k: v[0] for k, v in params["blocks"]["moe"]["shared"]
                   .items()}
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=shape + (cfg.d_model,)).astype(np.float32))
    if len(shape) == 1:
        G, T = 1, shape[0]
    elif group_size:
        G, T = shape[0] * shape[1] // group_size, group_size
    else:
        G, T = shape
    ops.reset_launches()
    M.moe_apply(p, cfg, x, group_size=group_size)
    got = ops.launches()
    assert got["moe_rows_computed"] == G * m.num_experts * M._capacity(T, m)
    assert got["moe_rows_routed"] == G * T * m.top_k
    assert got["expand_kv_bytes"] == 0
    ops.reset_launches()
    assert ops.launches()["moe_rows_computed"] == 0
    assert ops.launches()["moe_rows_routed"] == 0


def test_add_counts_n_and_is_recorded():
    """``counters.add`` adds n under the lock, and a ``recording()`` block
    gathers it as it gathers a launch (so a graph replay credits it)."""
    ops.reset_launches()
    with counters.recording() as deltas:
        counters.add(counters.LM_WORK, "moe_rows_routed", 7)
        counters.add(counters.LM_WORK, "moe_rows_routed", 5)
    assert deltas == {(counters.LM_WORK, "moe_rows_routed"): 12}
    counters.credit(deltas, 2)
    assert ops.launches()["moe_rows_routed"] == 36
    ops.reset_launches()
