"""Multi-rank properties of the port's sharding, run on gloo ranks on the
CPU (``tests/test_torch_sharding.py`` starts this script in a subprocess).

    python tests/_torch_ranks.py <scenario> <work dir>

spawns the scenario's ranks (``torch.multiprocessing``), each of which
opens a gloo process group from a ``FileStore`` in the work dir, builds
its meshes with ``launch.mesh.make_mesh_compat(..., "cpu")`` and checks
its properties; a failed check fails its rank and the script.  The
reference's results that a scenario compares with are computed by the
test beforehand and read from ``<work dir>/inputs.npz``.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

CP_TOL = dict(rtol=1e-5, atol=5e-6)          # the reference's CP test
LOSS_RTOL = 1e-4
MASTER_TOL = dict(rtol=2e-3, atol=2e-4)      # the reference's sharded step
GRAD_TOL = 1e-4      # the port's gradient leaf against the reference's
LR = 1e-3


def nest(flat: dict) -> dict:
    """A tree of nested dicts from {"a/b/c": leaf}."""
    out = {}
    for path, leaf in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def flat_full(tree) -> dict:
    from repro_torch.ckpt.checkpoint import _flatten
    return {k: full(v) for k, v in _flatten(tree).items()}


def assert_trees_close(got, want, what, flip=None, **tol):
    """Every leaf within ``tol``; with ``flip``, all but 0.1% of each leaf's
    elements, and those within ``flip`` + atol (the port's rule for int8
    error feedback against the JAX package, ``test_torch_train_grads``:
    where the two packages' float32 sums put a value on either side of a
    rounding boundary, one int8 code differs by one, and Adam's first step
    there may take the other sign, at most 2 lr apart)."""
    g, w = flat_full(got), flat_full(want)
    assert sorted(g) == sorted(w), (what, sorted(g), sorted(w))
    for k in w:
        a, b = g[k].float().numpy(), w[k].float().numpy()
        if flip is None:
            np.testing.assert_allclose(a, b, err_msg=f"{what}: {k}", **tol)
            continue
        diff = np.abs(a - b)
        off = diff > tol["atol"] + tol["rtol"] * np.abs(b)
        assert off.mean() <= 1e-3, (what, k, off.mean())
        assert diff.max() <= flip + tol["atol"], (what, k, diff.max())


def assert_steps_close(got, want, what):
    """Two states after one AdamW step from one state: each leaf's
    gradient (its first moment m = (1 - b1) g) within ``GRAD_TOL`` of the
    reference leaf's largest |m|, and each master within ``MASTER_TOL``
    but where the reference's gradient is within that gradient tolerance
    of zero.  There the comparison cannot tell its sign, and Adam's first
    step, g / (|g| + eps), is up to lr of whichever sign the float32 sums
    gave it: within 2 lr.  (zamba2 smoke's sharded step has one such
    ``out_proj`` element, whose gradient takes the other sign on the
    meshes.)"""
    gm, wm = flat_full(got["opt"]["m"]), flat_full(want["opt"]["m"])
    ga, wa = flat_full(got["master"]), flat_full(want["master"])
    assert sorted(gm) == sorted(wm) == sorted(ga) == sorted(wa), what
    for k in wm:
        g, w = gm[k].float().numpy(), wm[k].float().numpy()
        scale = np.abs(w).max()
        err = np.abs(g - w).max()
        assert err <= GRAD_TOL * scale, (what, k, "gradient", err, scale)
        a, b = ga[k].float().numpy(), wa[k].float().numpy()
        diff = np.abs(a - b)
        off = diff > MASTER_TOL["atol"] + MASTER_TOL["rtol"] * np.abs(b)
        free = np.abs(w) <= GRAD_TOL * scale
        assert not (off & ~free).any(), (what, k, diff[off & ~free].max())
        assert diff.max() <= 2 * LR + MASTER_TOL["atol"], (what, k)


def fill_pattern(shape):
    """The reference CP test's cache fill: (arange % 7 - 3) / 10."""
    n = int(np.prod(shape))
    return torch.from_numpy(
        (np.arange(n, dtype=np.float32).reshape(tuple(shape)) % 7 - 3) / 10)


# -- scenarios --------------------------------------------------------------

def placement_order(mesh):
    """A distributed arange over ("data", "model") gives rank (d, m) the
    block d * 4 + m; the batch split and its gather are inverses."""
    from repro_torch.configs import PlanConfig
    from repro_torch.models import api, partition
    from repro_torch.models.partition import P
    k = 3
    x = torch.arange(8 * k, dtype=torch.float32)
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    sh = api.to_shardings(mesh, P(("data", "model")))
    local = api.distribute(x, sh).to_local()
    blk = d * 4 + m
    assert torch.equal(local, x[blk * k:(blk + 1) * k]), (d, m, local)
    try:
        partition.spec_placements(mesh.mesh_dim_names, P(("model", "data")))
    except ValueError:
        pass
    else:
        raise AssertionError("an entry against the mesh order was accepted")
    rows = torch.arange(8 * 5).reshape(8, 5)
    with partition.plan_scope(mesh, PlanConfig(tp=False)) as env:
        entry = partition.batch_entry(8)
        assert entry == ("data", "model"), entry
        mine = partition.local_rows(rows, entry)
        assert torch.equal(mine, rows[blk:blk + 1]), mine
        with env.splitting(entry):
            assert torch.equal(partition.gather_rows(mine), rows)


def cp_decode(mesh, name):
    """CP decode equals naive decode on the sharded cache (the reference's
    inputs and tolerances), and both equal the single-device step; the CP
    run combines once a layer, the naive run never."""
    from repro_torch.configs import PlanConfig, ShapeConfig, get_arch
    from repro_torch.models import api, layers
    from repro_torch.models.partition import plan_scope
    from repro_torch.tree import tree_map
    cfg = get_arch(name).smoke()
    plan = PlanConfig(param_dtype="float32", compute_dtype="float32",
                      remat="none")
    shape = ShapeConfig("d", "decode", 32, 4)
    params = api.init_params(cfg, torch.Generator().manual_seed(0), plan,
                             "cpu")
    tok = torch.tensor([3, 5, 7, 9], dtype=torch.int32)
    pos = torch.tensor([9, 17, 4, 30], dtype=torch.int32)
    filled = tree_map(lambda t: fill_pattern(t.shape),
                      api.init_cache(cfg, 4, 32, torch.float32, "meta"))
    t_one, c_one = api.make_decode_step(cfg, shape, plan)(
        params, tree_map(torch.clone, filled), tok, pos)
    out = {}
    for cp in (False, True):
        p2 = plan.with_(decode_cp=cp)
        with plan_scope(mesh, p2):
            sp = api.distribute(params, api.to_shardings(
                mesh, api.param_specs(cfg, p2, params)))
            cache = api.distribute(filled, api.to_shardings(
                mesh, api.cache_specs(cfg, p2, filled)))
            layers.reset_cp_combines()
            nt, nc = api.make_decode_step(cfg, shape, p2)(sp, cache, tok,
                                                          pos)
            out[cp] = (nt, nc, layers.cp_combines())
    (t0, c0, n0), (t1, c1, n1) = out[False], out[True]
    assert n0 == 0, n0
    attn_layers = cfg.num_layers if cfg.family == "dense" \
        else cfg.num_layers // cfg.attn_period
    assert n1 == attn_layers, (n1, attn_layers)
    assert torch.equal(t0, t1), (t0, t1)
    assert torch.equal(t0, t_one), (t0, t_one)
    assert_trees_close(c1, c0, f"{name} cp vs naive", **CP_TOL)
    assert_trees_close(c0, c_one, f"{name} naive vs one device", **CP_TOL)


def split_work(mesh):
    """Under the split on (2, 4) (internlm2 smoke: H 4 over 4 ranks, KV 2
    replicated by the guard, d_ff 256, vocabulary 512): a layer's gather
    keeps every "model" shard (this rank's query head, its 64 d_ff
    columns) and redistributes only over "data"; a prefill's blocks end in
    one g and one reduce-scatter each, a decode step's in two g; the
    prefill's logits and cache equal the single device's."""
    from torch.distributed.tensor import Shard
    from repro_torch.configs import PlanConfig, ShapeConfig, get_arch
    from repro_torch.models import api, partition
    from repro_torch.models.partition import plan_scope
    from repro_torch.models.specs import gather_fsdp
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_arch("internlm2-1.8b").smoke()
    plan = PlanConfig(param_dtype="float32", compute_dtype="float32",
                      remat="none")
    L, D, H, hd = cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.head_dim
    params = api.init_params(cfg, torch.Generator().manual_seed(4), plan,
                             "cpu")
    shape = ShapeConfig("p", "prefill", 32, 2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(4))
    want = api.make_prefill(cfg, shape, plan)(params, {"tokens": tokens})
    with plan_scope(mesh, plan):
        sp = api.distribute(params, api.to_shardings(
            mesh, api.param_specs(cfg, plan, params)))
        layer = tree_map(lambda a: a[0], sp["blocks"])
        on_data = sum(any(isinstance(pl, Shard) and n > 1 for pl, n in
                          zip(t.placements[:1], mesh.shape[:1]))
                      for t in tree_leaves(layer))
        partition.reset_weight_gathers()
        lp = gather_fsdp(layer)
        assert partition.weight_gathers() == on_data > 0, \
            (partition.weight_gathers(), on_data)
        assert tuple(lp["attn"]["wq"].shape) == (D, H // 4, hd)
        assert tuple(lp["attn"]["wo"].shape) == (H // 4, hd, D)
        assert tuple(lp["attn"]["wk"].shape) == (D, cfg.num_kv_heads, hd)
        assert tuple(lp["mlp"]["w1"].shape) == (D, cfg.d_ff // 4)
        assert tuple(lp["mlp"]["w2"].shape) == (cfg.d_ff // 4, D)
        for t, g in zip(tree_leaves(layer), tree_leaves(lp)):
            whole = list(t.shape)
            for pl, name in zip(t.placements, mesh.mesh_dim_names):
                if name == "model" and isinstance(pl, Shard):
                    whole[pl.dim] //= 4
            assert list(g.shape) == whole, (g.shape, whole)
        partition.reset_tp_collectives()
        got = api.make_prefill(cfg, shape, plan)(sp, {"tokens": tokens})
        n = partition.tp_collectives()
        # the embedding's g, then per block the attention's g and the MLP's
        # reduce-scatter (sp_boundary: S 16 over 4 ranks)
        assert n["g"] == L + 1 and n["seq_exit"] == L, n
        assert n["f"] == 2 * L and n["gather"] == L + 2, n
        np.testing.assert_allclose(got[0].numpy(), want[0].numpy(),
                                   **CP_TOL)
        assert_trees_close(got[1], want[1], "split prefill cache", **CP_TOL)
        cache = api.init_cache(cfg, 2, 32, torch.float32, "cpu")
        partition.reset_tp_collectives()
        api.make_decode_step(cfg, ShapeConfig("d", "decode", 32, 2), plan)(
            sp, cache, tokens[:, 0], torch.tensor([0, 1], dtype=torch.int32))
        n = partition.tp_collectives()
        assert n["g"] == 2 * L + 1 and n["seq_exit"] == 0, n


def split_vocabulary(mesh):
    """The vocabulary split over "model" (512 rows, 128 a rank): the
    embedding lookup equals the whole one bit for bit, and the decode
    argmax breaks a tie that straddles two ranks' ranges (rows 127 and
    128) toward the lower index, as ``torch.argmax`` does."""
    from repro_torch.configs import PlanConfig, get_arch
    from repro_torch.models import api
    from repro_torch.models import layers as Lyr
    from repro_torch.models import transformer as T
    from repro_torch.models.partition import plan_scope
    from repro_torch.models.specs import gather_fsdp
    cfg = get_arch("internlm2-1.8b").smoke()
    plan = PlanConfig(param_dtype="float32")
    params = api.init_params(cfg, torch.Generator().manual_seed(6), plan,
                             "cpu")
    tokens = torch.arange(0, 512, 3, dtype=torch.int32).reshape(1, -1)
    x = torch.randn((3, cfg.d_model), generator=torch.Generator()
                    .manual_seed(6))
    head = params["head"].clone()
    head[128] = head[127]
    head[127] *= 50.0 / float(x[0] @ head[127])
    head[128] = head[127]
    head[300] = head[127]
    want = torch.argmax(x @ head.T, dim=-1).to(torch.int32)
    assert int(want[0]) == 127, want
    with plan_scope(mesh, plan):
        sp = api.distribute({**params, "head": head}, api.to_shardings(
            mesh, api.param_specs(cfg, plan, {**params, "head": head})))
        with torch.no_grad():
            e = T.embed_tokens(cfg, sp, tokens)
            local = gather_fsdp(sp["head"])
            assert local.shape[0] == 128, local.shape
            got = Lyr.greedy(x, local, 512)
    assert torch.equal(e, params["emb"][tokens.long()])
    assert torch.equal(got, want), (got, want)


def _train_step_check(mesh, name, plan, inp, prefix, batch,
                      moments=False):
    """One sharded train step from the state ``<prefix>state/...`` of
    ``inp`` against the port's single-device step and, where ``inp`` has
    them, the JAX package's loss and masters; with ``moments``, its
    gradients and masters by ``assert_steps_close`` (``inp`` then has the
    JAX package's moments, ``<prefix>jax_m/...``).  Returns the sharded
    state."""
    from repro_torch.configs import get_arch
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.models import api
    from repro_torch.models.partition import plan_scope
    from repro_torch.optim import AdamW
    cfg = get_arch(name).smoke()
    opt = AdamW(learning_rate=LR)
    state = train_state_from_numpy(nest(
        {k[len(prefix + "state/"):]: v for k, v in inp.items()
         if k.startswith(prefix + "state/")}), "cpu")
    s1, m1 = api.make_train_step(cfg, plan, opt)(state, batch)
    with plan_scope(mesh, plan):
        sh = api.to_shardings(mesh, api.train_state_specs(cfg, plan, state))
        s2, m2 = api.make_train_step(cfg, plan, opt)(
            api.distribute(state, sh), batch)
    l1, l2 = float(m1["loss"]), float(m2["loss"])
    np.testing.assert_allclose(l2, l1, rtol=LOSS_RTOL, err_msg=prefix)
    if moments:
        assert_steps_close(s2, s1, f"{prefix} vs one device")
    else:
        assert_trees_close(s2["master"], s1["master"],
                           f"{prefix} vs one device", **MASTER_TOL)
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(m2[k]), float(m1[k]), rtol=1e-5,
                                   err_msg=prefix + k)
    if prefix + "jax_loss" in inp:
        np.testing.assert_allclose(l2, float(inp[prefix + "jax_loss"]),
                                   rtol=LOSS_RTOL, err_msg=prefix + "jax")
        want = {k[len(prefix + "jax_master/"):]: torch.from_numpy(v)
                for k, v in inp.items()
                if k.startswith(prefix + "jax_master/")}
        if moments:
            m = {k[len(prefix + "jax_m/"):]: torch.from_numpy(v)
                 for k, v in inp.items() if k.startswith(prefix + "jax_m/")}
            assert_steps_close(s2, {"master": nest(want),
                                    "opt": {"m": nest(m)}},
                               f"{prefix} vs jax")
            return s2, sh
        flip = 2 * LR if plan.grad_compression == "int8_ef" else None
        assert_trees_close(s2["master"], nest(want), f"{prefix} vs jax",
                           flip=flip, **MASTER_TOL)
    return s2, sh


def elastic_checkpoint(state, work):
    """A state saved from the (2, 4) mesh restores at (4, 2) with every
    leaf equal; rank 0 also writes the whole leaves for the test, which
    restores the checkpoint on one process."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import PlanConfig, get_arch
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import api
    from repro_torch.models.partition import plan_scope
    ck = CheckpointManager(os.path.join(work, "ckpt"))
    ck.save(1, state, blocking=True)
    mesh2 = make_mesh_compat((4, 2), ("data", "model"), "cpu")
    cfg = get_arch("internlm2-1.8b").smoke()
    plan = PlanConfig(param_dtype="float32")
    with plan_scope(mesh2, plan):
        sh = api.to_shardings(mesh2, api.train_state_specs(cfg, plan, state))
        back, step = ck.restore(state, shardings=sh)
    assert step == 1
    a, b = flat_full(back), flat_full(state)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        leaf = back
        for part in k.split("/"):
            leaf = leaf[part]
        assert tuple(leaf.device_mesh.shape) == (4, 2), k
    if dist.get_rank() == 0:
        np.savez(os.path.join(work, "saved.npz"),
                 **{k: v.numpy() for k, v in b.items()})


def scenario_dense(work):
    """8 ranks, (2, 4): placement order, the split's shapes, gathers and
    collectives, the split vocabulary, the Mamba mixer split four ways
    (``mixer_split``: mamba2, zamba2), CP decode (internlm2, zamba2),
    internlm2's sharded train step (sp_boundary, sp_residual, neither;
    int8_ef under block remat) against one device and the JAX package,
    an elastic checkpoint."""
    from repro_torch.configs import PlanConfig
    from repro_torch.launch.mesh import make_mesh_compat
    mesh = make_mesh_compat((2, 4), ("data", "model"), "cpu")
    placement_order(mesh)
    split_work(mesh)
    split_vocabulary(mesh)
    _mixer_scenarios(mesh, work)
    for name in ("internlm2-1.8b", "zamba2-7b"):
        cp_decode(mesh, name)
    inp = dict(np.load(os.path.join(work, "inputs.npz")))
    batch = {"tokens": torch.from_numpy(inp["tokens"])}
    plan = PlanConfig(param_dtype="float32", compute_dtype="float32",
                      master_dtype="float32", loss_chunk=8, remat="none")
    from repro_torch.models import partition
    layers = 4
    # the step's exits: the embedding's g, the loss's two a chunk (S 16 in
    # chunks of 8) in its forward and again in its recompute, and per
    # block two g or reduce-scatters
    for p, g, rs in ((plan, layers, layers), (plan.with_(sp_residual=True),
                                                0, 2 * layers),
                     (plan.with_(sp_boundary=False), 2 * layers, 0)):
        partition.reset_tp_collectives()
        s, _ = _train_step_check(mesh, "internlm2-1.8b", p, inp, "", batch)
        n = partition.tp_collectives()
        assert n["g"] == g + 1 + 2 * 2 * 2 and n["seq_exit"] == rs, (p, n)
        if p is plan:
            state = s
    _train_step_check(mesh, "internlm2-1.8b",
                      plan.with_(grad_compression="int8_ef", remat="block"),
                      inp, "ef_", batch)
    elastic_checkpoint(state, work)


def scenario_moe(work):
    """4 ranks, (2, 2): deepseek-v2-lite (MoE, MLA) smoke, one sharded
    train step and one decode step at 4 slots against one device, with
    the experts split over "model" whole (``ep``: 2 of 4 a rank) and on
    ``d_ff`` (``moe_ep=False``: 32 of 64 columns)."""
    from repro_torch.configs import PlanConfig, ShapeConfig, get_arch
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import api
    from repro_torch.models.partition import plan_scope
    from repro_torch.optim import AdamW
    from repro_torch.tree import tree_map
    name = "deepseek-v2-lite-16b"
    mesh = make_mesh_compat((2, 2), ("data", "model"), "cpu")
    cfg = get_arch(name).smoke()
    plan = PlanConfig(param_dtype="float32", compute_dtype="float32",
                      master_dtype="float32", loss_chunk=8, remat="none")
    gen = torch.Generator().manual_seed(0)
    state = api.init_train_state(cfg, plan, gen, AdamW(LR), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (4, 16), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    flat = {"state/" + k: v.numpy() for k, v in flat_full(state).items()}
    from repro_torch.models import partition
    from repro_torch.models.specs import gather_fsdp
    m = cfg.moe
    counts = []
    for p, local in ((plan, (m.num_experts // 2, cfg.d_model, m.d_ff_expert)),
                     (plan.with_(moe_ep=False),
                      (m.num_experts, cfg.d_model, m.d_ff_expert // 2))):
        with plan_scope(mesh, p):
            sp = api.distribute(state["master"], api.to_shardings(
                mesh, api.param_specs(cfg, p, state["master"])))
            lp = gather_fsdp(tree_map(lambda a: a[0], sp["blocks"]), p.moe_ep)
            assert tuple(lp["moe"]["we1"].shape) == local, lp["moe"]["we1"].shape
            assert lp["attn"]["wq"].shape[-2] == cfg.num_heads // 2
        partition.reset_tp_collectives()
        _train_step_check(mesh, name, p, flat, "", {"tokens": tokens})
        counts.append(partition.tp_collectives())
        # decode: the slots of both data ranks route as one group
        _decode_check(mesh, cfg, p, state["master"], name)
    # each MoE layer: ep all-gathers its experts' outputs; a d_ff split
    # enters its experts and its combine (two f) and ends in g
    moe_layers = cfg.num_layers - m.first_dense_layers
    (ep, ff) = counts
    assert ep["gather"] - ff["gather"] == moe_layers, counts
    assert ff["f"] - ep["f"] == 2 * moe_layers, counts
    assert ff["g"] - ep["g"] == moe_layers, counts


MIXER_NAMES = ("mamba2-370m", "zamba2-7b")


def _mixer_counts(what, cfg, n, gathers):
    """A split mixer's collectives: one gated-norm sum a Mamba layer (every
    layer of mamba2 and of zamba2's backbone), its entry and exit (f and
    g, or the sequence pair), and of its weights only the conv's gathered
    over "model", once a layer."""
    layers = cfg.num_layers
    assert n["sum"] == layers, (what, n)
    assert n["f"] + n["seq_enter"] >= layers, (what, n)
    assert n["g"] + n["seq_exit"] >= layers, (what, n)
    assert gathers == {"conv_w": layers, "conv_b": layers}, (what, gathers)


def mixer_split(mesh, name, inp, plan, batch):
    """A Mamba mixer split over "model" (the smoke configs' 16 heads over
    the mesh's "model" ranks; their 288 conv channels split evenly off
    the heads): the decision says so, and one sharded train step (under
    ``plan``: the default ``sp_boundary``, S 16 on the rank's rows) equals
    the single-device step and the JAX package's, with one gated-norm sum
    a Mamba layer and no gather over "model" of a weight but the conv's;
    one decode step equals the unsharded one, with the same counts."""
    from repro_torch.configs import get_arch
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.models import partition, ssm
    from repro_torch.models.partition import plan_scope
    cfg = get_arch(name).smoke()
    tp = mesh.shape[mesh.mesh_dim_names.index("model")]
    with plan_scope(mesh, plan):
        assert ssm.mixer_splits(cfg), (name, tp)
        assert partition.seq_splits(batch["tokens"].shape[1]), name
    pre = name + " "
    partition.reset_tp_collectives()
    partition.reset_weight_gathers()
    _train_step_check(mesh, name, plan, inp, pre, batch, moments=True)
    _mixer_counts(pre + "train", cfg, partition.tp_collectives(),
                  partition.model_gathers())
    state = train_state_from_numpy(nest(
        {k[len(pre + "state/"):]: v for k, v in inp.items()
         if k.startswith(pre + "state/")}), "cpu")
    partition.reset_tp_collectives()
    partition.reset_weight_gathers()
    _decode_check(mesh, cfg, plan, state["master"], name)
    _mixer_counts(pre + "decode", cfg, partition.tp_collectives(),
                  partition.model_gathers())


def _decode_check(mesh, cfg, plan, params, what):
    """One decode step at 4 slots on the mesh (the reference CP test's
    tokens, positions and cache fill) against the single-device step:
    tokens equal, every cache leaf within the CP tolerances."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.models import api
    from repro_torch.models.partition import plan_scope
    from repro_torch.tree import tree_map
    shape = ShapeConfig("d", "decode", 32, 4)
    tok = torch.tensor([3, 5, 7, 9], dtype=torch.int32)
    pos = torch.tensor([9, 17, 4, 30], dtype=torch.int32)
    filled = tree_map(lambda t: fill_pattern(t.shape),
                      api.init_cache(cfg, 4, 32, torch.float32, "meta"))
    t_one, c_one = api.make_decode_step(cfg, shape, plan)(
        params, tree_map(torch.clone, filled), tok, pos)
    with plan_scope(mesh, plan):
        sp = api.distribute(params, api.to_shardings(
            mesh, api.param_specs(cfg, plan, params)))
        cache = api.distribute(filled, api.to_shardings(
            mesh, api.cache_specs(cfg, plan, filled)))
        nt, nc = api.make_decode_step(cfg, shape, plan)(sp, cache, tok, pos)
    assert torch.equal(nt, t_one), (what, nt, t_one)
    assert_trees_close(nc, c_one, f"{what} decode", **CP_TOL)


def _stub_inputs(cfg, batch, seed):
    """The frontend stub's seeded inputs of a smoke config: patch
    embeddings (vlm) or 12 frames (encdec); none for the others."""
    gen = torch.Generator().manual_seed(seed)
    if cfg.family == "vlm":
        shape = (batch, cfg.num_frontend_tokens, cfg.d_model)
        return {"patch_embeds": torch.randn(shape, generator=gen)}
    if cfg.family == "encdec":
        return {"frames": torch.randn((batch, 12, cfg.d_model),
                                      generator=gen)}
    return {}


def restarts_on_the_mesh(mesh, work):
    """``Trainer.run_with_restarts`` with a failure injected, restoring
    onto the mesh by ``shardings``, gives the uninterrupted run's losses
    and final state (mamba2 smoke, a checkpoint every 2 steps)."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import PlanConfig, get_arch
    from repro_torch.models import api
    from repro_torch.models.partition import plan_scope
    from repro_torch.optim import AdamW
    from repro_torch.runtime import FailureInjector, Trainer
    cfg = get_arch("mamba2-370m").smoke()
    plan = PlanConfig(param_dtype="float32", compute_dtype="float32",
                      master_dtype="float32", loss_chunk=8)
    opt = AdamW(LR)
    state = api.init_train_state(cfg, plan, torch.Generator().manual_seed(2),
                                 opt, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (6, 4, 16), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(3))
    batch_fn = lambda i: {"tokens": tokens[i]}
    with plan_scope(mesh, plan):
        sh = api.to_shardings(mesh, api.train_state_specs(cfg, plan, state))
        placed = api.distribute(state, sh)
        step = api.make_train_step(cfg, plan, opt)
        clean = Trainer(step, batch_fn, CheckpointManager(
            os.path.join(work, "clean")), ckpt_every=2)
        final_clean = clean.run(placed, 6)
        faulty = Trainer(step, batch_fn, CheckpointManager(
            os.path.join(work, "faulty")), ckpt_every=2,
            injector=FailureInjector({3}))
        final, restarts = faulty.run_with_restarts(placed, 6, shardings=sh)
    assert restarts == 1, restarts
    a, b = clean.losses(), faulty.losses()
    assert len(a) == len(b) == 6
    np.testing.assert_allclose(b, a, rtol=1e-6)
    assert_trees_close(final, final_clean, "restarted", rtol=0, atol=0)


def batch_server_on_a_mesh(mesh_split):
    """``BatchServer`` on a (1, 4) mesh (the cache's seq dimension split
    over "model", CP decode across the 4 ranks) and on a (2, 2) mesh that
    splits its slots over the data ranks (each rank copies the rows of the
    requests in its slots, and decodes them) gives the unsharded server's
    tokens; so does zamba2 smoke on the (1, 4) mesh, its Mamba mixer split
    four ways (the SSM states on the rank's heads, the conv states' spans
    off the heads, the shared block's KV cache split on seq; the 16-token
    prompt's prefill on the rank's rows of the sequence)."""
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import partition
    mesh = make_mesh_compat((1, 4), ("data", "model"), "cpu")
    serve, want = _server("internlm2-1.8b", (9, 3, 14))
    got = serve(mesh)
    assert got == want, (got, want)
    got = serve(mesh_split, slots_split=True)
    assert got == want, (got, want)
    serve, want = _server("zamba2-7b", (9, 3, 16))
    partition.reset_tp_collectives()
    got = serve(mesh)
    assert got == want, (got, want)
    n = partition.tp_collectives()
    assert n["sum"] > 0 and n["seq_exit"] > 0, n


def _server(name, lengths):
    """(serve(mesh) -> each request's tokens from a ``BatchServer`` on the
    mesh, the unsharded server's tokens) for ``name``'s smoke config and
    prompts of ``lengths`` tokens, 5 new tokens each, 2 slots of 32."""
    from repro_torch.configs import PlanConfig, ShapeConfig, get_arch
    from repro_torch.models import api, layers
    from repro_torch.models.partition import plan_scope
    from repro_torch.runtime import BatchServer, Request
    cfg = get_arch(name).smoke()
    plan = PlanConfig(param_dtype="float32", compute_dtype="float32",
                      remat="none", decode_cp=True)
    shape = ShapeConfig("serve", "decode", 32, 2)
    params = api.init_params(cfg, torch.Generator().manual_seed(5), plan,
                             "cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]

    def serve(p):
        prefill = api.make_prefill(cfg, shape, plan)
        srv = BatchServer(slots=2, max_len=32, params=p,
                          prefill_fn=lambda q, t: prefill(q, {"tokens": t}),
                          decode_fn=api.make_decode_step(cfg, shape, plan),
                          init_cache_fn=lambda b, n: api.init_cache(
                              cfg, b, n, torch.float32, "cpu"))
        reqs = [Request(i, q, 5) for i, q in enumerate(prompts)]
        srv.run(reqs)
        return [r.out_tokens for r in reqs]

    def on(mesh, slots_split=False):
        with plan_scope(mesh, plan):
            placed = api.distribute(params, api.to_shardings(
                mesh, api.param_specs(cfg, plan, params)))
            if slots_split:
                cache = api.init_cache(cfg, 2, 32, torch.float32, "cpu")
                assert cache["main"]["k"].to_local().shape[1] == 1
            else:
                layers.reset_cp_combines()
            got = serve(placed)
            if not slots_split:
                assert layers.cp_combines() > 0
        return got

    return on, serve(params)


def _mixer_scenarios(mesh, work):
    """``mixer_split`` of mamba2 and zamba2 smoke (the test's JAX steps in
    ``inputs.npz``: zamba2's LoRA factors ``b_*`` seeded, as the init's
    are zero, which would leave the ``a_*`` without a gradient)."""
    from repro_torch.configs import PlanConfig
    inp = dict(np.load(os.path.join(work, "inputs.npz")))
    plan = PlanConfig(param_dtype="float32", compute_dtype="float32",
                      master_dtype="float32", loss_chunk=8, remat="none")
    for name in MIXER_NAMES:
        batch = {"tokens": torch.from_numpy(inp[name + " tokens"])}
        mixer_split(mesh, name, inp, plan, batch)
    mixer_groups(mesh, plan)


def mixer_groups(mesh, plan):
    """mamba2 smoke with 2 groups of B and C (8 heads each): on 2 "model"
    ranks each holds one whole group, on 4 its heads fall inside one
    group.  A prefill (logits and cache) and a decode step on the mesh
    equal the single device's."""
    import dataclasses
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.models import api, ssm
    from repro_torch.models.partition import plan_scope
    base = get_arch("mamba2-370m").smoke()
    cfg = dataclasses.replace(base, ssm=dataclasses.replace(base.ssm,
                                                            n_groups=2))
    params = api.init_params(cfg, torch.Generator().manual_seed(7), plan,
                             "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (4, 16), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(7))
    shape = ShapeConfig("p", "prefill", 16, 4)
    want = api.make_prefill(cfg, shape, plan)(params, {"tokens": tokens})
    with plan_scope(mesh, plan):
        assert ssm.mixer_splits(cfg)
        sp = api.distribute(params, api.to_shardings(
            mesh, api.param_specs(cfg, plan, params)))
        got = api.make_prefill(cfg, shape, plan)(sp, {"tokens": tokens})
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), **CP_TOL)
    assert_trees_close(got[1], want[1], "groups prefill cache", **CP_TOL)
    _decode_check(mesh, cfg, plan, params, "groups")


def scenario_families(work):
    """4 ranks, (2, 2): mamba2 (SSM) and zamba2 (hybrid) with the mixer
    split (``mixer_split``), seamless (encdec) and internvl2 (vlm) smoke,
    one sharded train step and one decode step each against one device;
    restarts onto the mesh."""
    from repro_torch.configs import PlanConfig, get_arch
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import api
    from repro_torch.optim import AdamW
    mesh = make_mesh_compat((2, 2), ("data", "model"), "cpu")
    _mixer_scenarios(mesh, work)
    plan = PlanConfig(param_dtype="float32", compute_dtype="float32",
                      master_dtype="float32", loss_chunk=8, remat="none")
    for seed, name in ((1, "seamless-m4t-medium"), (2, "internvl2-26b")):
        cfg = get_arch(name).smoke()
        state = api.init_train_state(cfg, plan,
                                     torch.Generator().manual_seed(seed),
                                     AdamW(LR), "cpu")
        batch = {"tokens": torch.randint(
            0, cfg.vocab_size, (4, 16), dtype=torch.int32,
            generator=torch.Generator().manual_seed(10 + seed)),
            **_stub_inputs(cfg, 4, 20 + seed)}
        pre = name + " "
        flat = {pre + "state/" + k: v.numpy()
                for k, v in flat_full(state).items()}
        _train_step_check(mesh, name, plan, flat, pre, batch)
        _decode_check(mesh, cfg, plan, state["master"], name)
    restarts_on_the_mesh(mesh, work)
    batch_server_on_a_mesh(mesh)


SCENARIOS = {"dense": (scenario_dense, 8), "moe": (scenario_moe, 4),
             "families": (scenario_families, 4)}


def rank_main(rank, scenario, work, world):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(work, "store"),
        rank=rank, world_size=world)
    try:
        SCENARIOS[scenario][0](work)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(f"RANKS_OK {scenario}", flush=True)


if __name__ == "__main__":
    scenario, work = sys.argv[1], sys.argv[2]
    import torch.multiprocessing as mp
    world = SCENARIOS[scenario][1]
    mp.spawn(rank_main, args=(scenario, work, world), nprocs=world)
