"""Model API of the port: the serving and training parts of
``repro.models.api``.

  init_params(cfg, gen, plan, device)   -> parameter dict
  cast_params(params, dtype)            -> same dict, float leaves cast
  get_loss_fn(cfg, plan)                -> f(params, batch) -> scalar
  init_train_state(cfg, plan, gen, optimizer, device)
                                        -> {"master", "opt", "step"[, "ef"]}
  make_train_step(cfg, plan, optimizer) -> f(state, batch) -> (state, metrics)
  make_prefill(cfg, shape, plan)        -> f(params, batch) -> (logits, cache, pos)
  make_decode_step(cfg, shape, plan)    -> f(params, cache, tokens, pos) -> (tok, cache)
  make_serve_step(cfg, shape, plan)     -> the decode step (a decode cell's)
  example_batch(cfg, shape, plan)       -> a cell's inputs, on ``meta``
  example_cache(cfg, shape, plan)       -> a decode cell's cache, on ``meta``
  count_params(cfg, active_only)        -> parameter count (shapes only)
  param_specs / cache_specs / batch_specs / train_state_specs
                                        -> PartitionSpec trees (plan-resolved)
  to_shardings(mesh, spec_tree)         -> NamedSharding trees (placements)
  distribute(tree, shardings)           -> the tree as DTensors on the mesh

Every family is ported: ``dense`` and ``moe`` (MoE blocks, MLA attention:
the transformer's routes), ``vlm`` (the transformer with patch embeddings
prepended: ``batch["patch_embeds"]``), ``ssm``, ``hybrid`` (Mamba2 layers
and a shared attention block) and ``encdec`` (an encoder over
``batch["frames"]`` and a decoder with cross-attention; its decode cache
holds ``encdec.DECODE_ENC_LEN`` encoder rows, as the reference's
``example_cache``).  Prefill and decode run under
``torch.inference_mode()`` (decode updates the cache in place; under a
scope ``torch.no_grad()``: a ``DTensor`` made outside inference mode cannot
be viewed inside it); the train step runs with gradients and returns a new
state, as the reference's does.

Under a ``partition.plan_scope`` over a ``DeviceMesh`` the same functions
run sharded (``models.specs`` has the design).  Parameters, train state and
caches are ``DTensor``s placed by their spec trees (``distribute``,
``init_cache``).  Each call splits its global batch by ``batch_specs`` and
runs its own rows, each layer's weights gathered over the ``fsdp`` axes and
the compute split over "model" where the plan says so.  Prefill and decode
hand back global logits, tokens and positions (all-gathered over the
data-parallel axes) and keep each rank's span of the cache.  The train
step's loss is the mean over the data-parallel ranks of their local means;
its gradients are reduced onto the shards (a weight's gather does it in
its backward, or ``_placed_like`` after it), and the optimizer runs on the
``DTensor``s, so its global norm and the int8 scale stay global.
The functions read the scope when they are called, on the calling thread.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor import zeros as dtensor_zeros

from repro_torch.configs.base import ArchConfig, PlanConfig, ShapeConfig
from repro_torch.core.tables import resolve_device
from repro_torch.models import encdec, hybrid, partition, ssm, ssm_lm, vlm
from repro_torch.models import specs as _specs
from repro_torch.models import transformer as T
from repro_torch.models.partition import NamedSharding, P
from repro_torch.tree import (tree_leaves, tree_map, tree_map_with_path,
                              tree_unflatten)
from repro_torch.optim.compression import int8_ef_compress, int8_ef_init

F32_SENSITIVE = {"router", "A_log", "dt_bias", "Dskip"}
PORTED_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")
EXPERT_LEAVES = {"we1", "we2", "we3"}      # routed experts' weights


def _family(cfg: ArchConfig) -> str:
    """The family's route: "transformer" (dense and MoE), "vlm", "ssm",
    "hybrid" or "encdec"."""
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(cfg.family)
    return "transformer" if cfg.family in ("dense", "moe") else cfg.family


def init_params(cfg: ArchConfig, gen, plan: PlanConfig = PlanConfig(),
                device=None):
    """Parameters at the reference init's distributions, drawn from the
    ``torch.Generator`` ``gen`` (on ``device``).  ``device=None`` means the
    CUDA card; ``"meta"`` gives shapes only and reads no generator."""
    init = {"transformer": T.init_lm, "vlm": vlm.init_vlm,
            "ssm": ssm_lm.init_ssm_lm, "hybrid": hybrid.init_hybrid,
            "encdec": encdec.init_encdec}[_family(cfg)]
    return init(cfg, gen, plan, device=resolve_device(device))


def cast_params(params, dtype):
    """Floating leaves cast to ``dtype``, except the float32-sensitive ones
    (``F32_SENSITIVE``), which keep their dtype."""
    def one(name, p):
        if isinstance(p, dict):
            return {k: one(k, v) for k, v in p.items()}
        if name in F32_SENSITIVE or not p.is_floating_point():
            return p
        return p.to(dtype)
    return {k: one(k, v) for k, v in params.items()}


def get_loss_fn(cfg: ArchConfig, plan: PlanConfig):
    family = _family(cfg)
    if family == "transformer":
        return lambda p, b: T.lm_loss(cfg, plan, p, b["tokens"])
    if family == "vlm":
        return lambda p, b: vlm.vlm_loss(cfg, plan, p, b["patch_embeds"],
                                         b["tokens"])
    if family == "hybrid":
        return lambda p, b: hybrid.hybrid_loss(cfg, plan, p, b["tokens"])
    if family == "encdec":
        return lambda p, b: encdec.encdec_loss(cfg, plan, p, b["frames"],
                                               b["tokens"])
    return lambda p, b: ssm_lm.ssm_lm_loss(cfg, plan, p, b["tokens"])


def make_prefill(cfg: ArchConfig, shape: ShapeConfig, plan: PlanConfig):
    fn = _family_prefill(cfg, shape, plan)

    def prefill(p, b):
        env = partition.ranks_env()
        if env is None:
            with torch.inference_mode():
                return fn(p, b)
        local, entry = _split_batch(b)
        with torch.no_grad(), env.splitting(entry):
            logits, cache, pos = fn(p, local)
            return (partition.gather_rows(logits),
                    _cache_layout(cache, b["tokens"].shape[0],
                                  _heads_leaves(cfg)),
                    partition.gather_rows(pos))
    return prefill


def _family_prefill(cfg: ArchConfig, shape: ShapeConfig, plan: PlanConfig):
    max_len = shape.seq_len
    family = _family(cfg)
    if family == "transformer":
        fn = lambda p, b: T.lm_prefill(cfg, plan, p, b["tokens"], max_len)
    elif family == "vlm":
        fn = lambda p, b: vlm.vlm_prefill(cfg, plan, p, b["patch_embeds"],
                                          b["tokens"], max_len)
    elif family == "hybrid":
        fn = lambda p, b: hybrid.hybrid_prefill(cfg, plan, p, b["tokens"],
                                                max_len)
    elif family == "encdec":
        fn = lambda p, b: encdec.encdec_prefill(cfg, plan, p, b["frames"],
                                                b["tokens"], max_len)
    else:
        fn = lambda p, b: ssm_lm.ssm_prefill(cfg, plan, p, b["tokens"])
    return fn


def make_decode_step(cfg: ArchConfig, shape: ShapeConfig, plan: PlanConfig):
    step = {"transformer": T.lm_decode_step, "vlm": vlm.vlm_decode_step,
            "ssm": ssm_lm.ssm_decode_step,
            "hybrid": hybrid.hybrid_decode_step,
            "encdec": encdec.encdec_decode_step}[_family(cfg)]

    def decode(p, c, t, pos):
        env = partition.ranks_env()
        if env is None:
            with torch.inference_mode():
                return step(cfg, plan, p, c, t, pos)
        entry = partition.batch_entry(t.shape[0])
        with torch.no_grad(), env.splitting(entry):
            nxt, c = step(cfg, plan, p, c, partition.local_rows(t, entry),
                          partition.local_rows(pos, entry))
            return partition.gather_rows(nxt), c
    return decode


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, device):
    """The decode cache of a family: the KV cache (GQA or MLA), the SSM
    states, both (hybrid), or the self-attention KV cache and
    ``encdec.DECODE_ENC_LEN`` rows of encoder keys and values (encdec).
    Under a scope with ranks: ``DTensor`` zeros in the layout of
    ``cache_specs``, each rank allocating only its span (``device`` must
    be of the mesh's device type)."""
    env = partition.ranks_env()
    if env is None:
        return _family_cache(cfg, batch, max_len, dtype, device)
    dev = resolve_device(device)
    if dev.type != env.mesh.device_type:
        raise ValueError(f"a cache on {dev.type} for a "
                         f"{env.mesh.device_type} mesh")
    shapes = _family_cache(cfg, batch, max_len, dtype, "meta")
    return tree_map_with_path(
        lambda path, leaf: dtensor_zeros(
            tuple(leaf.shape), dtype=leaf.dtype, device_mesh=env.mesh,
            placements=_cache_sharding(env.mesh, path,
                                       leaf.shape).placements),
        shapes)


def _family_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, device):
    family = _family(cfg)
    if family in ("transformer", "vlm"):
        return T.init_cache(cfg, batch, max_len, dtype, device=device)
    if family == "hybrid":
        return hybrid.init_hybrid_cache(cfg, batch, max_len, dtype,
                                        device=device)
    if family == "encdec":
        return encdec.init_encdec_cache(cfg, batch, max_len,
                                        encdec.DECODE_ENC_LEN, dtype,
                                        device=device)
    return ssm_lm.init_ssm_cache(cfg, batch, dtype, device=device)


def make_serve_step(cfg: ArchConfig, shape: ShapeConfig, plan: PlanConfig):
    """Decode-mode step: (params, cache, tokens, pos) -> (next_tokens,
    cache)."""
    return make_decode_step(cfg, shape, plan)


def example_cache(cfg: ArchConfig, shape: ShapeConfig, plan: PlanConfig,
                  batch=None):
    """The cache of a decode cell (capacity ``shape.seq_len``, ``batch``
    rows or the shape's global batch) on ``meta``: ``init_cache``'s
    shapes and dtypes in ``plan.param_dtype``, nothing allocated.  The
    reference gives ``ShapeDtypeStruct``s."""
    B = batch if batch is not None else shape.global_batch
    return _family_cache(cfg, B, shape.seq_len,
                         getattr(torch, plan.param_dtype), "meta")


def example_batch(cfg: ArchConfig, shape: ShapeConfig, plan: PlanConfig):
    """A cell's inputs on ``meta``: tokens (and a decode cell's positions)
    in int32, a vlm's patch embeddings before its tokens, an encdec's
    frames (the cell's ``seq_len`` of them; the decoder's prompt is the
    whole sequence to train, its first token to prefill) in
    ``plan.param_dtype``."""
    B, S = shape.global_batch, shape.seq_len
    dt = getattr(torch, plan.param_dtype)
    tok = lambda *s: torch.empty(s, dtype=torch.int32, device="meta")
    if shape.mode == "decode":
        return {"tokens": tok(B), "pos": tok(B)}
    if cfg.family == "vlm":
        Pf = cfg.num_frontend_tokens
        return {"patch_embeds": torch.empty((B, Pf, cfg.d_model), dtype=dt,
                                            device="meta"),
                "tokens": tok(B, S - Pf)}
    if cfg.family == "encdec":
        S_dec = S if shape.mode == "train" else 1
        return {"frames": torch.empty((B, S, cfg.d_model), dtype=dt,
                                      device="meta"),
                "tokens": tok(B, S_dec)}
    return {"tokens": tok(B, S)}


# --------------------------------------------------------------------------
# train step
# --------------------------------------------------------------------------

def init_train_state(cfg: ArchConfig, plan: PlanConfig, gen, optimizer,
                     device=None):
    """Master parameters in ``plan.master_dtype`` drawn from ``gen`` (as
    ``init_params``), the optimizer's state, a 0-d int32 step and, with
    ``grad_compression == "int8_ef"``, the error-feedback residuals.
    ``device=None`` means the CUDA card."""
    mplan = plan.with_(param_dtype=plan.master_dtype)
    master = init_params(cfg, gen, mplan, device)
    state = {"master": master, "opt": optimizer.init(master),
             "step": torch.zeros((), dtype=torch.int32,
                                 device=tree_leaves(master)[0].device)}
    if plan.grad_compression == "int8_ef":
        state["ef"] = int8_ef_init(master)
    return state


def make_train_step(cfg: ArchConfig, plan: PlanConfig, optimizer):
    """``train_step(state, batch) -> (new_state, {"loss", "grad_norm",
    "lr"})``: the loss of the master cast to ``plan.compute_dtype``, its
    float32 gradient (summed over ``plan.accum`` microbatches, one after
    the other, then averaged), the optional int8 error-feedback
    compression, and the optimizer's update.  The state passed in is not
    changed."""
    loss_fn = get_loss_fn(cfg, plan)
    compute_dt = getattr(torch, plan.compute_dtype)

    def value_and_grad(master, mb):
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(True)
                      for p in tree_leaves(master)]
            loss = loss_fn(cast_params(tree_unflatten(master, leaves),
                                       compute_dt), mb)
            # split over n ranks: each takes 1/n of its rows' mean, and the
            # gathers' backward sums the ranks' gradients
            n = _split_ranks()
            grads = torch.autograd.grad(loss if n == 1 else loss / n, leaves)
        return loss.detach(), tree_unflatten(
            master, [_placed_like(g, p).to(torch.float32)
                     for g, p in zip(grads, leaves)])

    def train_step(state, batch):
        env = partition.ranks_env()
        if env is None:
            return step(state, batch)
        local, entry = _split_batch(batch)
        with env.splitting(entry):
            new_state, metrics = step(state, local)
            metrics = {k: partition.mean_over_split(v) if k == "loss"
                       else _local(v) for k, v in metrics.items()}
        return new_state, metrics

    def step(state, batch):
        master = state["master"]
        if plan.accum > 1:
            A = plan.accum
            mbs = tree_map(lambda x: x.reshape((A, x.shape[0] // A)
                                               + tuple(x.shape[1:])), batch)
            loss, grads = None, None
            for i in range(A):
                l, g = value_and_grad(master,
                                      tree_map(lambda x: x[i], mbs))
                loss = l if loss is None else loss + l
                grads = g if grads is None else tree_map(torch.add, grads, g)
            loss = loss / A
            grads = tree_map(lambda g: g / A, grads)
        else:
            loss, grads = value_and_grad(master, batch)

        new_state = dict(state)
        if plan.grad_compression == "int8_ef":
            grads, new_state["ef"] = int8_ef_compress(grads, state["ef"])
        new_master, new_opt, stats = optimizer.update(grads, state["opt"],
                                                      master)
        new_state.update(master=new_master, opt=new_opt,
                         step=state["step"] + 1)
        return new_state, {"loss": loss, **stats}

    return train_step


def _placed_like(g, p):
    """A gradient in its parameter's placements: a weight gathered with no
    ``redistribute`` (``partition.gather_leaf``) hands its gradient back
    in its gather's gradient placements (partial sums over the axes that
    split the batch), which are reduced here onto the parameter's."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _split_ranks() -> int:
    """The number of ranks that split the current step's batch."""
    env = partition.ranks_env()
    return 1 if env is None else env.axes_size(env.split)


def _local(t):
    """A replicated ``DTensor`` (a metric) as a plain tensor."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    """Analytic N from the parameter shapes (made on the ``meta`` device:
    nothing is allocated).  ``active_only``: the routed experts' weights
    count top_k / num_experts of their size, as the reference's."""
    shapes = init_params(cfg, None, PlanConfig(), "meta")
    total = sum(math.prod(t.shape) for t in tree_leaves(shapes))
    if active_only and cfg.moe is not None:
        def routed(tree):
            return sum(math.prod(v.shape) if k in EXPERT_LEAVES
                       else routed(v) if isinstance(v, dict) else 0
                       for k, v in tree.items())
        n = routed(shapes)
        total = total - n + int(n * (cfg.moe.top_k / cfg.moe.num_experts))
    return total


# --------------------------------------------------------------------------
# partition-spec rules (see models/specs.py for the rule tables)
# --------------------------------------------------------------------------

_leaf_name = _specs.leaf_name


def param_specs(cfg: ArchConfig, plan: PlanConfig, params_shapes):
    """PartitionSpec tree for a param tree (must run under plan_scope)."""
    def one(path, leaf):
        shape = tuple(leaf.shape)
        rule = _specs.rule_for(_leaf_name(path), shape, plan.moe_ep)
        if rule is None:
            return P()                    # norms, scalars: replicate
        return _specs.trailing_spec(shape, rule)
    return tree_map_with_path(one, params_shapes)


def _cache_spec(path, shape) -> P:
    rule = _specs.CACHE_RULES.get(_leaf_name(path))
    if rule is None:
        return P()
    return _specs.trailing_spec(tuple(shape), rule)


def cache_specs(cfg: ArchConfig, plan: PlanConfig, cache_shapes):
    return tree_map_with_path(lambda path, leaf: _cache_spec(path, leaf.shape),
                              cache_shapes)


def batch_specs(cfg: ArchConfig, plan: PlanConfig, batch_shapes):
    def one(path, leaf):
        fn = _specs.BATCH_RULES.get(_leaf_name(path))
        if fn is None:
            return P()
        return partition.spec(tuple(leaf.shape), fn(len(leaf.shape)))
    return tree_map_with_path(one, batch_shapes)


def train_state_specs(cfg: ArchConfig, plan: PlanConfig, state_shapes):
    ps = param_specs(cfg, plan, state_shapes["master"])
    out = {"master": ps,
           "opt": {"m": ps, "v": ps, "count": P()},
           "step": P()}
    if "ef" in state_shapes:
        out["ef"] = ps
    return out


def to_shardings(mesh, spec_tree):
    """A tree of ``NamedSharding``s (each with its ``DTensor`` placements)
    of a spec tree on ``mesh``."""
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree)


def distribute(tree, shardings):
    """``tree`` placed on the mesh by ``shardings`` (``to_shardings``): each
    leaf a ``DTensor`` of which every rank keeps only its shard.  A leaf
    must be whole and equal on every rank (a seeded init, a restored
    checkpoint); a ``DTensor`` leaf is gathered whole first, so a tree
    moves from one mesh to another."""
    def one(t, sh):
        if isinstance(t, DTensor):
            t = t.full_tensor()
        try:      # each rank takes its own chunk: no broadcast from rank 0
            return distribute_tensor(t, sh.mesh, sh.placements,
                                     src_data_rank=None)
        except TypeError:
            return distribute_tensor(t, sh.mesh, sh.placements)
    return tree_map(one, tree, shardings)


def _cache_sharding(mesh, path, shape) -> NamedSharding:
    return NamedSharding(mesh, _cache_spec(path, tuple(shape)))


def _split_batch(batch: dict) -> tuple:
    """(this rank's rows of each leaf of a global batch, split by
    ``batch_specs``, and the spec entry that split its tokens)."""
    specs = batch_specs(None, None, batch)
    local = {k: partition.local_rows(v, specs[k][0] if len(specs[k]) else None)
             for k, v in batch.items()}
    return local, specs["tokens"][0]


SSM_STATES = frozenset({"ssm", "ssm_g", "ssm_t"})


def _heads_leaves(cfg: ArchConfig) -> frozenset:
    """The cache leaves that a prefill hands back as this rank's share
    over "model": the SSM states, on the rank's heads, where the Mamba
    mixer splits."""
    split = cfg.ssm is not None and partition.tp_active() \
        and ssm.mixer_splits(cfg)
    return SSM_STATES if split else frozenset()


def _cache_layout(cache, batch: int, heads=frozenset()):
    """A prefill's cache, this rank's rows whole along the other
    dimensions (the leaves named in ``heads``: still split over "model",
    as its spec splits them), as ``DTensor``s in the layout of
    ``cache_specs`` for a global batch of ``batch`` rows: each rank keeps
    its span."""
    env = partition.ranks_env()

    def one(path, t):
        name = _leaf_name(path)
        rule = _specs.CACHE_RULES.get(name)
        shape = list(t.shape)
        if rule is not None:
            shape[t.ndim - len(rule)] = batch
        if name in heads:           # the whole H, of which t holds a share
            shape[t.ndim - len(rule) + rule.index("tp")] *= \
                env.axis_size[env.resolve("tp")]
        pl = _cache_sharding(env.mesh, path, shape).placements
        rows = DTensor.from_local(
            t.contiguous(), env.mesh,
            partition.rows_placements(env.axis_names, pl,
                                      keep_tp=name in heads),
            run_check=False)
        span = rows.redistribute(env.mesh, pl).to_local().contiguous()
        return DTensor.from_local(span, env.mesh, pl, run_check=False)
    return tree_map_with_path(one, cache)
