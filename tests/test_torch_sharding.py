"""Sharding on the port (``repro_torch.models.partition`` and ``specs``, the
spec helpers of ``models.api``, ``launch.mesh``) against the reference.

Spec parity runs in this process with no ranks: every config at full
size, both production meshes and six plans; the port resolves its specs
under an ``AbstractMesh`` on ``meta`` shapes, the reference under a
``PlanEnv`` over a stub mesh (axis names and sizes, all its ``PlanEnv``
reads) on ``jax.eval_shape`` shapes, and the two spec trees must be equal
path by path.

The multi-rank properties run as gloo ranks on the CPU in a subprocess
(``tests/_torch_ranks.py``), as the reference's run on forced host devices
(``tests/test_distributed.py``): no process group is opened in the pytest
process.  Their plans split the compute over "model" (``tp``, the
default), so they hold the tensor-parallel model code to the single
device.  The test computes the JAX package's single-device train steps
beforehand and hands them to the ranks as an ``.npz``.  Tolerances are the
reference's: CP decode rtol 1e-5 / atol 5e-6, a train step's loss rtol
1e-4 and masters rtol 2e-3 / atol 2e-4; under int8 error feedback the
sharded masters against the JAX package's take the port's int8 rule of
``test_torch_train_grads`` (all but 0.1% of each leaf, the rest within
2 lr), as the port's single-device step does, and against the port's
single-device step the plain tolerances.
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS, SHAPES, PlanConfig
from repro.models import api as japi
from repro.models import partition as jpart
from repro.optim import AdamW as JAdamW
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import PlanConfig as TPlan
from repro_torch.configs import get_arch as tget
from repro_torch.models import api as tapi
from repro_torch.models import partition as tpart
from repro_torch.optim import AdamW
from repro_torch.tree import tree_map, tree_map_with_path

REPO = Path(__file__).resolve().parent.parent
MESHES = {"single_pod": (("data", "model"), (16, 16)),
          "multi_pod": (("pod", "data", "model"), (2, 16, 16))}
PLANS = {"defaults": {}, "tp_off": {"tp": False}, "fsdp_off": {"fsdp": False},
         "moe_ep_off": {"moe_ep": False},
         "cache_seq_shard_off": {"cache_seq_shard": False},
         "sp_boundary_off": {"sp_boundary": False}}
DECODE = next(s for s in SHAPES if s.name == "decode_32k")


class _StubMesh:
    """What the reference's ``PlanEnv`` reads of a mesh."""

    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


def _jax_paths(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(leaf) for path, leaf in flat}


def _port_paths(tree) -> dict:
    out = {}
    tree_map_with_path(lambda path, s: out.__setitem__(
        "/".join(str(k) for k in path), tuple(s)), tree)
    return out


@functools.lru_cache(maxsize=None)
def _ref_shapes(name):
    """The reference's parameter, decode-cache, batch and train-state
    shapes of a full-size config (no allocation)."""
    cfg = ARCHS[name]
    plan = PlanConfig(grad_compression="int8_ef")
    params = jax.eval_shape(lambda: japi.init_params(
        cfg, jax.random.PRNGKey(0), plan))
    cache = japi.example_cache(cfg, DECODE, plan)
    state = jax.eval_shape(lambda: japi.init_train_state(
        cfg, plan, jax.random.PRNGKey(0), JAdamW()))
    batches = {s.mode: japi.example_batch(cfg, s, plan) for s in SHAPES
               if s.name != "long_500k"}
    return params, cache, state, batches


@functools.lru_cache(maxsize=None)
def _port_shapes(name):
    cfg = tget(name)
    plan = TPlan(grad_compression="int8_ef")
    params = tapi.init_params(cfg, None, plan, "meta")
    cache = tapi.init_cache(cfg, DECODE.global_batch, DECODE.seq_len,
                            torch.bfloat16, "meta")
    state = tapi.init_train_state(cfg, plan, None, AdamW(), "meta")
    return params, cache, state


def _meta(shape_struct):
    return torch.empty(tuple(shape_struct.shape), device="meta")


@pytest.mark.parametrize("plan_name", list(PLANS))
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", list(ARCHS))
def test_specs_equal_the_reference(name, mesh_name, plan_name):
    """param, cache (decode_32k: B 128, S 32768), batch (train, prefill,
    decode) and train-state (with and without int8_ef) specs, entry by
    entry and path by path."""
    names, sizes = MESHES[mesh_name]
    jplan = PlanConfig(**PLANS[plan_name])
    tplan = TPlan(**PLANS[plan_name])
    jparams, jcache, jstate, jbatches = _ref_shapes(name)
    tparams, tcache, tstate = _port_shapes(name)
    cfg, tcfg = ARCHS[name], tget(name)
    prev = getattr(jpart._ENV, "env", None)
    jpart._ENV.env = jpart.PlanEnv(_StubMesh(names, sizes), jplan)
    try:
        want = {"params": japi.param_specs(cfg, jplan, jparams),
                "cache": japi.cache_specs(cfg, jplan, jcache),
                "state": japi.train_state_specs(cfg, jplan, jstate),
                "state_no_ef": japi.train_state_specs(
                    cfg, jplan, {k: v for k, v in jstate.items()
                                 if k != "ef"}),
                **{f"batch_{m}": japi.batch_specs(cfg, jplan, b)
                   for m, b in jbatches.items()}}
    finally:
        jpart._ENV.env = prev
    with tpart.plan_scope(tpart.AbstractMesh(names, sizes), tplan):
        got = {"params": tapi.param_specs(tcfg, tplan, tparams),
               "cache": tapi.cache_specs(tcfg, tplan, tcache),
               "state": tapi.train_state_specs(tcfg, tplan, tstate),
               "state_no_ef": tapi.train_state_specs(
                   tcfg, tplan, {k: v for k, v in tstate.items()
                                 if k != "ef"}),
               **{f"batch_{m}": tapi.batch_specs(
                   tcfg, tplan, tree_map(_meta, b))
                  for m, b in jbatches.items()}}
    for part in want:
        w, g = _jax_paths(want[part]), _port_paths(got[part])
        assert sorted(g) == sorted(w), (part, sorted(set(g) ^ set(w)))
        for path in w:
            assert g[path] == w[path], (part, path, g[path], w[path])


def test_placements_follow_the_mesh_order():
    """A tuple entry shards one dimension over its axes in mesh order; an
    axis that does not divide the dimension leaves it replicated."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = tpart.AbstractMesh(("pod", "data", "model"), (2, 4, 8))
    with tpart.plan_scope(mesh, TPlan(tp=False)):
        assert tpart.placements((64, 6), ("dp", "tp")) == (
            Shard(0), Shard(0), Shard(0))
        assert tpart.placements((63, 6), ("dp", None)) == (Replicate(),) * 3
    with tpart.plan_scope(mesh, TPlan()):
        assert tpart.placements((16, 8, 3), ("fsdp", "tp", None)) == (
            Shard(0), Shard(0), Shard(1))
        assert tpart.spec((16, 4), ("fsdp", "tp")) == tpart.P(
            ("pod", "data"), None)
    with pytest.raises(ValueError, match="mesh's axis order"):
        tpart.spec_placements(mesh.mesh_dim_names,
                              tpart.P(("data", "pod")))


def test_remat_recomputes_under_the_forward_scope():
    """Block remat's recompute sees the plan scope of the forward even when
    the backward pass runs on another thread, as it does on the card."""
    import threading
    from repro_torch.models.util import remat
    seen = []

    def body(x):
        seen.append(tpart.current_env())
        return torch.sin(x)

    x = torch.ones(3, requires_grad=True)
    with tpart.plan_scope(tpart.AbstractMesh(("data",), (2,)), TPlan()) \
            as env:
        y = remat(body)(x).sum()
    out = []
    t = threading.Thread(target=lambda: out.append(
        torch.autograd.grad(y, [x])[0]))
    t.start()
    t.join()
    assert seen == [env, env]
    torch.testing.assert_close(out[0], torch.cos(x.detach()))


def test_tp_helpers_are_the_identity_without_a_split():
    """Outside a scope, and under a scope without ranks, every collective
    of the split returns its input and counts nothing."""
    x = torch.arange(24.0).reshape(2, 4, 3)
    helpers = (tpart.tp_enter, tpart.tp_exit, tpart.seq_enter,
               tpart.seq_exit, tpart.tp_max, tpart.tp_sum,
               lambda t: tpart.tp_split(t, 1), lambda t: tpart.tp_gather(t, 1))
    tpart.reset_tp_collectives()
    for scope in (None, tpart.AbstractMesh(("data", "model"), (2, 4))):
        with tpart.plan_scope(scope, TPlan()):
            assert not tpart.tp_active()
            assert tpart.tp_rank() == 0 and not tpart.tp_splits(16)
            for fn in helpers:
                assert fn(x) is x
    assert not any(tpart.tp_collectives().values())


@pytest.mark.parametrize("d_model, groups, sizes, plan, want", [
    (128, 1, (2, 4), {}, True),          # smoke: H 16 over 4
    (128, 1, (2, 2), {}, True),
    (128, 1, (4, 16), {}, True),         # H 16 over 16: one head a rank
    (120, 1, (2, 4), {}, False),         # H 15 over 4: not whole heads
    (128, 1, (8, 1), {}, False),         # "model" of one rank
    (128, 1, (2, 4), {"tp": False}, False),
    (128, 2, (2, 4), {}, True),          # 4 heads inside a group of 8
    (128, 4, (2, 2), {}, True),          # 8 heads: two whole groups
    (96, 3, (2, 2), {}, False),          # H 12: 6 heads over groups of 4
])
def test_the_mixer_splits_on_whole_heads(d_model, groups, sizes, plan, want):
    """``ssm.mixer_splits`` under an ``AbstractMesh`` (no ranks): the
    mixer runs on the rank's heads where "tp" splits d_inner into whole
    heads that fall inside whole groups of B and C (or hold whole
    groups); d_model 120 gives d_inner 240, which 4 divides, but 15 heads,
    which it does not, so the layer is computed whole.  Every SSM config
    splits on both production meshes."""
    import dataclasses
    from repro_torch.models import ssm as tssm
    smoke = tget("zamba2-7b").smoke()
    cfg = dataclasses.replace(smoke, d_model=d_model, ssm=dataclasses.replace(
        smoke.ssm, n_groups=groups))
    mesh = tpart.AbstractMesh(("data", "model"), sizes)
    with tpart.plan_scope(mesh, TPlan(**plan)):
        assert tssm.mixer_splits(cfg) is want
    for name in ("mamba2-370m", "zamba2-7b"):
        for names, mesh_sizes in MESHES.values():
            with tpart.plan_scope(tpart.AbstractMesh(names, mesh_sizes),
                                  TPlan()):
                assert tssm.mixer_splits(tget(name))


@pytest.mark.parametrize("H, KV, Hl, rank, want", [
    (4, 2, 1, 3, [1]),           # internlm2 smoke at tp 4
    (16, 8, 4, 1, [2, 3]),       # internlm2 at tp 4, KV split too
    (48, 8, 3, 2, [1]),          # a group of 6 over 16 ranks
    (48, 8, 12, 1, [2, 3]),
    (12, 3, 3, 1, None),         # heads 3-5 straddle two groups: raises
])
def test_rank_kv_reads_the_kv_heads_of_the_rank_query_heads(
        monkeypatch, H, KV, Hl, rank, want):
    """Query head h reads KV head h // (H // KV): the rank's heads read a
    contiguous range, taken as a view where GQA's equal groups hold; a
    split that straddles groups unevenly raises."""
    from repro_torch.models import layers as TL
    monkeypatch.setattr(tpart, "tp_rank", lambda: rank)
    k = torch.arange(KV, dtype=torch.float32)[None, :, None].expand(
        2, KV, 5).contiguous()
    if want is None:
        with pytest.raises(ValueError, match="unevenly"):
            TL.rank_kv(k, H, KV, Hl)
        return
    got = TL.rank_kv(k, H, KV, Hl)
    assert got._base is k
    heads = got[0, :, 0].tolist()
    assert heads == want and Hl % len(want) == 0
    rep = Hl // len(want)
    assert [heads[j // rep] for j in range(Hl)] == [
        (rank * Hl + j) // (H // KV) for j in range(Hl)]


@pytest.mark.parametrize("name", list(ARCHS))
def test_every_leaf_replicated_over_model_says_where_its_gradient_sums(name):
    """Each parameter whose rule keeps no "tp" entry is either read inside
    a region split over "model" (``specs.TP_PARTIAL``: its gradient a
    partial sum there) or outside every one (``specs.TP_WHOLE``), so that
    a new replicated leaf cannot take a wrong gradient unnoticed."""
    from repro_torch.models import specs as tspecs
    partial = frozenset().union(*tspecs.TP_PARTIAL.values())
    assert not partial & tspecs.TP_WHOLE
    names = set()
    tree_map_with_path(lambda path, t: names.add(tspecs.leaf_name(path)),
                       _port_shapes(name)[0])
    replicated = {n for n in names
                  if "tp" not in (tspecs.rule_for(n, (8,) * 4) or ())}
    assert replicated <= partial | tspecs.TP_WHOLE, (
        replicated - partial - tspecs.TP_WHOLE)


def test_vocabulary_helpers_without_a_split_are_the_plain_ops():
    """The embedding lookup, the logits and the greedy token of a whole
    vocabulary are the plain ones."""
    from repro_torch.models import layers as TL
    g = torch.Generator().manual_seed(0)
    emb = torch.randn((512, 16), generator=g)
    x = torch.randn((3, 16), generator=g)
    tok = torch.tensor([[0, 511, 7]], dtype=torch.int32)
    assert torch.equal(TL.embed(emb, tok, 512), emb[tok.long()])
    assert torch.equal(TL.vocab_logits(x, emb, 512), x @ emb.T)
    assert torch.equal(TL.greedy(x, emb, 512),
                       torch.argmax(x @ emb.T, -1).to(torch.int32))


def test_importing_the_mesh_module_opens_no_group():
    code = ("import torch.distributed as d, repro_torch.launch.mesh as m; "
            "assert not d.is_initialized(); "
            "assert m.mesh_devices() == 256 and "
            "m.mesh_devices(multi_pod=True) == 512; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# -- multi-rank properties on gloo ranks ------------------------------------

def _run_ranks(scenario, work):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"),
                                           str(REPO / "tests")]))
    out = subprocess.run([sys.executable, str(REPO / "tests" /
                                              "_torch_ranks.py"),
                          scenario, str(work)],
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-8000:]
    assert f"RANKS_OK {scenario}" in out.stdout


def _jax_step(plan, tokens):
    """The JAX package's state before and after one single-device train
    step of internlm2 smoke, and its loss."""
    cfg = ARCHS["internlm2-1.8b"].smoke()
    opt = JAdamW(learning_rate=1e-3)
    state = japi.init_train_state(cfg, plan, jax.random.PRNGKey(0), opt)
    s1, m1 = jax.jit(japi.make_train_step(cfg, plan, opt))(
        state, {"tokens": jnp.asarray(tokens)})
    return state, s1, float(m1["loss"])


def _flat_np(tree, prefix) -> dict:
    from repro_torch.ckpt.checkpoint import _flatten
    return {prefix + k: np.asarray(v) for k, v in _flatten(
        jax.tree.map(np.asarray, tree)).items()}


@functools.lru_cache(maxsize=None)
def _mixer_inputs() -> dict:
    """The JAX package's state before and after one single-device train
    step of mamba2 and zamba2 smoke (zamba2's LoRA factors ``b_*`` seeded
    N(0, 0.1²): the init's are zero), its first moments, its loss and its
    (4, 16) tokens, keyed "<name> ..." for the ranks' ``mixer_split``."""
    plan = PlanConfig(param_dtype="float32", compute_dtype="float32",
                      master_dtype="float32", loss_chunk=8, remat="none")
    out = {}
    for seed, name in enumerate(("mamba2-370m", "zamba2-7b")):
        cfg = ARCHS[name].smoke()
        opt = JAdamW(learning_rate=1e-3)
        state = japi.init_train_state(cfg, plan, jax.random.PRNGKey(seed),
                                      opt)
        if "lora" in state["master"]:
            rng = np.random.default_rng(30 + seed)
            lora = {k: (jnp.asarray(0.1 * rng.standard_normal(v.shape),
                                    v.dtype) if k.startswith("b_") else v)
                    for k, v in state["master"]["lora"].items()}
            state = dict(state, master=dict(state["master"], lora=lora))
        tokens = np.random.default_rng(10 + seed).integers(
            0, cfg.vocab_size, (4, 16)).astype(np.int32)
        s1, m1 = jax.jit(japi.make_train_step(cfg, plan, opt))(
            state, {"tokens": jnp.asarray(tokens)})
        pre = name + " "
        out.update(_flat_np(state, pre + "state/"))
        out.update(_flat_np(s1["master"], pre + "jax_master/"))
        out.update(_flat_np(s1["opt"]["m"], pre + "jax_m/"))
        out[pre + "jax_loss"] = np.float32(m1["loss"])
        out[pre + "tokens"] = tokens
    return out


def test_dense_sharding_on_8_gloo_ranks(tmp_path):
    """Mesh (2, 4) ("data", "model"), the compute split over "model":
    placement order; a layer's gather keeps its "model" shards (the
    rank's query head and d_ff columns) and its prefill and decode end
    each block in two g or reduce-scatters; the vocabulary's lookup is
    the whole one bit for bit and its argmax breaks a tie across ranks to
    the lower index; the Mamba mixer of mamba2 and zamba2 smoke split four
    ways (4 of 16 heads a rank, the conv's 288 channels split off the
    heads), its sharded train step equal to the single-device step and
    the JAX package's and its decode step to the unsharded one, with one
    gated-norm all-reduce a Mamba layer and no weight but the conv's
    gathered over "model"; CP decode equals naive decode (internlm2 and zamba2
    smoke); internlm2 smoke's sharded train step equals the port's
    single-device step and the JAX package's, under sp_boundary (the
    default), sp_residual, neither, and int8_ef (with block remat); a
    state saved from the mesh restores at (4, 2) and here, on one
    process, with every leaf equal."""
    tokens = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (8, 16), 0,
        ARCHS["internlm2-1.8b"].smoke().vocab_size), np.int32)
    inp = {"tokens": tokens}
    base = PlanConfig(param_dtype="float32", compute_dtype="float32",
                      master_dtype="float32", attn_chunk=8, loss_chunk=8,
                      remat="none")
    for prefix, plan in (("", base),
                         ("ef_", base.with_(grad_compression="int8_ef",
                                            remat="block"))):
        state, s1, loss = _jax_step(plan, tokens)
        inp.update(_flat_np(state, prefix + "state/"))
        inp.update(_flat_np(s1["master"], prefix + "jax_master/"))
        inp[prefix + "jax_loss"] = np.float32(loss)
    inp.update(_mixer_inputs())
    np.savez(tmp_path / "inputs.npz", **inp)
    _run_ranks("dense", tmp_path)
    saved = dict(np.load(tmp_path / "saved.npz"))
    from _torch_ranks import nest
    like = nest({k: torch.from_numpy(v) for k, v in saved.items()})
    back, step = CheckpointManager(str(tmp_path / "ckpt")).restore(
        like, device="cpu")
    assert step == 1
    from repro_torch.ckpt.checkpoint import _flatten
    for k, v in _flatten(back).items():
        assert torch.equal(v, torch.from_numpy(saved[k])), k


def test_moe_sharding_on_4_gloo_ranks(tmp_path):
    """Mesh (2, 2): deepseek-v2-lite smoke (MoE with MLA), one sharded
    train step and one decode step at 4 slots (the slots of both data
    ranks routed as one group) against the single-device ones, the
    experts split over "model" whole (ep) and on d_ff."""
    _run_ranks("moe", tmp_path)


def test_other_families_on_4_gloo_ranks(tmp_path):
    """Mesh (2, 2): mamba2 (SSM) and zamba2 (hybrid) smoke with the Mamba
    mixer split two ways (8 of 16 heads a rank, states split over "model"
    by head), their sharded train step equal to the single-device step
    and the JAX package's, their decode step to the unsharded one, with
    the mixer's counts; seamless (encdec: frames split with the batch,
    the encoder cache's spans gathered) and internvl2 (vlm: patches split
    with the batch) smoke, one sharded train step and one decode step each
    against the single-device ones; ``Trainer.run_with_restarts`` with a
    failure injected, restoring onto the mesh by ``shardings``, against an
    uninterrupted run (sharded saves: rank 0 writes whole leaves); and
    ``BatchServer`` on a (1, 4) mesh under ``decode_cp`` (internlm2, and
    zamba2 with its mixer split four ways) and on the (2, 2) mesh, which
    splits its slots, against the unsharded server's tokens."""
    np.savez(tmp_path / "inputs.npz", **_mixer_inputs())
    _run_ranks("families", tmp_path)
