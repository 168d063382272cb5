"""The port's training support against the reference: schedules, AdamW,
int8 error feedback, the token stream and loader, checkpoints in both
directions, the trainer with restarts, and context-parallel decode
without a mesh.

Inputs come from numpy with a seed and go through both packages.
Tolerances: schedules 1e-7 and 2 float32 ulps; AdamW 1e-6;
int8 codes bit for bit; tokens bit for bit; a 12-step loss trajectory
1e-4 relative, as ``tests/test_runtime.py`` holds a restarted run to an
uninterrupted one.  The gradients, losses and train steps of the models
are in ``tests/test_torch_train_grads.py``."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JCkpt
from repro.configs import PlanConfig, get_arch
from repro.data import TokenStream as JTokenStream
from repro.models import api as japi
from repro.optim import AdamW as JAdamW
from repro.optim import compression as jcomp
from repro.optim import cosine_schedule as jcosine
from repro.optim import constant_schedule as jconstant
from repro.runtime import FailureInjector as JFailureInjector
from repro.runtime import Trainer as JTrainer
from _torch_parity import assert_cp_decode_parity
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import PlanConfig as TPlan
from repro_torch.configs import get_arch as tget
from repro_torch.convert import train_state_from_numpy
from repro_torch.data import ShardedLoader, TokenStream
from repro_torch.models import api as tapi
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.optim import (AdamW, constant_schedule, cosine_schedule,
                               int8_ef_compress, int8_ef_init)
from repro_torch.optim import compression as tcomp
from repro_torch.runtime import FailureInjector, Trainer

PLAN = PlanConfig(param_dtype="float32", compute_dtype="float32",
                  master_dtype="float32", attn_chunk=8, loss_chunk=8,
                  remat="none")
TPLAN = TPlan(param_dtype="float32", compute_dtype="float32",
              master_dtype="float32", attn_chunk=8, loss_chunk=8,
              remat="none")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel workers beside timing-based tests of the reference, and idle
    OpenMP threads spinning here would add noise to their timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    """numpy leaves of a tree of either package (bf16 as float32)."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(torch.float32).numpy() \
            if tree.dtype == torch.bfloat16 else tree.detach().numpy()
    a = np.asarray(tree)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _same_tree(port, ref, **tol):
    p, r = _paths(_np_tree(port)), _paths(_np_tree(ref))
    assert sorted(p) == sorted(r)
    for k in r:
        assert p[k].shape == r[k].shape, k
        if tol:
            np.testing.assert_allclose(p[k], r[k], err_msg=k, **tol)
        else:
            np.testing.assert_array_equal(p[k], r[k], err_msg=k)


# -- schedules ----------------------------------------------------------------

@pytest.mark.parametrize("which", ["cosine", "constant", "cosine_no_warmup"])
def test_schedules_equal_the_reference(which):
    if which == "cosine":
        j, t = jcosine(3e-4, 10, 30), cosine_schedule(3e-4, 10, 30)
    elif which == "cosine_no_warmup":
        j, t = jcosine(1e-3, 0, 25, 0.2), cosine_schedule(1e-3, 0, 25, 0.2)
    else:
        j, t = jconstant(2e-3), constant_schedule(2e-3)
    for c in range(41):
        want = np.float32(j(jnp.asarray(c, jnp.int32)))
        got = t(torch.tensor(c, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7,
                                   err_msg=f"count {c}")
        # and no more than 2 float32 units in the last place apart (the
        # two packages' cosines may round differently)
        np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=2)


# -- AdamW --------------------------------------------------------------------

def _opt_tree(rng):
    return {"a": rng.standard_normal((6, 5)).astype(np.float32),
            "b": {"w": rng.standard_normal((3, 4, 2)).astype(np.float32),
                  "s": rng.standard_normal((7,)).astype(np.float32)}}


ADAM_CASES = {
    "clipped": dict(learning_rate=1e-2, clip_norm=1.0),
    "unclipped": dict(learning_rate=1e-2, clip_norm=0.0),
    "weight_decay": dict(learning_rate=3e-3, weight_decay=0.01),
    "bf16_moments": dict(learning_rate=1e-2, moment_dtype="bfloat16"),
}


@pytest.mark.parametrize("case", sorted(ADAM_CASES))
def test_adamw_update_equals_the_reference(case):
    """Three updates from the same tree, each package on its own outputs;
    gradients at scale 3 so that clipping bites."""
    kw = ADAM_CASES[case]
    jopt, topt = JAdamW(**kw), AdamW(**kw)
    rng = np.random.default_rng(5)
    p0 = _opt_tree(rng)
    jp, tp = jax.tree.map(jnp.asarray, p0), tree_map(torch.from_numpy, p0)
    js, ts = jopt.init(jp), topt.init(tp)
    _same_tree(ts, js)
    for _ in range(3):
        g = tree_map(lambda a: 3 * a, _opt_tree(rng))
        jp, js, jst = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tst = topt.update(tree_map(torch.from_numpy, g), ts, tp)
        _same_tree(tp, jp, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(float(tst["grad_norm"]),
                                   float(jst["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tst["lr"]), float(jst["lr"]),
                                   rtol=1e-7)
        assert int(ts["count"]) == int(js["count"])
        assert ts["count"].dtype == torch.int32
        for part in ("m", "v"):
            for k, leaf in _paths(js[part]).items():
                mine = _paths(ts[part])[k]
                assert str(mine.dtype) == f"torch.{leaf.dtype}", k
                if kw.get("moment_dtype") == "bfloat16":
                    # the same bits after the cast to bfloat16
                    np.testing.assert_array_equal(
                        mine.view(torch.int16).numpy(),
                        np.asarray(leaf).view(np.int16), err_msg=k)
                else:
                    np.testing.assert_allclose(mine.numpy(), np.asarray(leaf),
                                               rtol=1e-6, atol=1e-6,
                                               err_msg=k)


def test_adamw_update_changes_none_of_its_arguments():
    opt = AdamW(learning_rate=1e-2)
    rng = np.random.default_rng(1)
    p = tree_map(torch.from_numpy, _opt_tree(rng))
    g = tree_map(torch.from_numpy, _opt_tree(rng))
    s = opt.init(p)
    before = [t.clone() for t in tree_leaves((p, g, s))]
    opt.update(g, s, p)
    for a, b in zip(before, tree_leaves((p, g, s))):
        assert torch.equal(a, b)


def test_adamw_takes_a_schedule():
    sched = (jcosine(1e-2, 2, 6), cosine_schedule(1e-2, 2, 6))
    jopt, topt = JAdamW(learning_rate=sched[0]), AdamW(learning_rate=sched[1])
    rng = np.random.default_rng(2)
    p0 = _opt_tree(rng)
    jp, tp = jax.tree.map(jnp.asarray, p0), tree_map(torch.from_numpy, p0)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(5):
        g = _opt_tree(rng)
        jp, js, jst = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tst = topt.update(tree_map(torch.from_numpy, g), ts, tp)
        np.testing.assert_allclose(float(tst["lr"]), float(jst["lr"]),
                                   rtol=1e-7)
    _same_tree(tp, jp, rtol=1e-6, atol=1e-6)


# -- int8 error feedback ------------------------------------------------------

def test_int8_codes_equal_the_reference_bit_for_bit():
    """Values on the half-way points of the grid too: both round half to
    even."""
    rng = np.random.default_rng(3)
    for g in (rng.standard_normal(1000).astype(np.float32),
              (np.arange(-254, 255) / 2).astype(np.float32),
              np.zeros(5, np.float32)):
        jq, js = jcomp._quant(jnp.asarray(g))
        tq, ts = tcomp._quant(torch.from_numpy(g))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert float(ts) == float(js)


def test_int8_ef_compress_equals_the_reference():
    rng = np.random.default_rng(4)
    t0 = _opt_tree(rng)
    jef = jcomp.int8_ef_init(jax.tree.map(jnp.asarray, t0))
    tef = int8_ef_init(tree_map(torch.from_numpy, t0))
    for _ in range(4):
        g = _opt_tree(rng)
        jdq, jef = jcomp.int8_ef_compress(jax.tree.map(jnp.asarray, g), jef)
        tdq, tef = int8_ef_compress(tree_map(torch.from_numpy, g), tef)
        _same_tree(tdq, jdq)
        _same_tree(tef, jef)


def test_int8_ef_compression_converges():
    """Error feedback keeps SGD converging on a quadratic (the reference's
    ``test_int8_ef_compression_converges``)."""
    w = torch.tensor([2.0, -3.0, 1.5])
    target = torch.tensor([0.5, 0.5, 0.5])
    ef = int8_ef_init({"w": w})
    for _ in range(200):
        g = {"w": 2 * (w - target)}
        gq, ef = int8_ef_compress(g, ef)
        w = w - 0.1 * gq["w"]
    np.testing.assert_allclose(w.numpy(), target.numpy(), atol=1e-2)


# -- tokens and loader --------------------------------------------------------

@pytest.mark.parametrize("seed,vocab,batch,seq", [(0, 512, 2, 16),
                                                  (7, 92544, 3, 40),
                                                  (3, 100, 4, 8)])
def test_token_stream_equals_the_reference_bit_for_bit(seed, vocab, batch,
                                                       seq):
    j = JTokenStream(vocab_size=vocab, batch=batch, seq_len=seq, seed=seed)
    t = TokenStream(vocab_size=vocab, batch=batch, seq_len=seq, seed=seed)
    for step in (0, 1, 17):
        got = t.batch_at(step)
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(j.batch_at(step)))
    assert not torch.equal(t.batch_at(17), t.batch_at(18))


def test_loader_keeps_order_and_state():
    stream = TokenStream(vocab_size=50, batch=2, seq_len=4, seed=1)
    loader = ShardedLoader(lambda s: {"tokens": stream.batch_at(s)},
                           start_step=3, device="cpu")
    try:
        assert loader.state() == {"step": 3}
        for want in (3, 4, 5):
            b = next(loader)
            assert torch.equal(b["tokens"], stream.batch_at(want))
            assert loader.state() == {"step": want + 1}
    finally:
        loader.close()
    assert not loader._thread.is_alive()


def test_loader_raises_what_the_batch_function_raised():
    def batch_fn(step):
        if step == 1:
            raise ValueError("no batch 1")
        return {"tokens": torch.zeros((1, 2), dtype=torch.int32)}

    loader = ShardedLoader(batch_fn, device="cpu")
    try:
        next(loader)
        with pytest.raises(ValueError, match="no batch 1"):
            next(loader)
    finally:
        loader.close()


def test_loader_wants_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedLoader(lambda s: {}, device=None)


# -- checkpoints --------------------------------------------------------------

def _state_pair(cfg_name="internlm2-1.8b", seed=0, plan=PLAN):
    """(reference train state, the port's from its numpy copy)."""
    cfg = get_arch(cfg_name).smoke()
    js = japi.init_train_state(cfg, plan, jax.random.PRNGKey(seed),
                               JAdamW(learning_rate=1e-3))
    return js, train_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")


def test_train_state_from_numpy_is_name_for_name():
    js, ts = _state_pair(plan=PLAN.with_(grad_compression="int8_ef"))
    assert sorted(ts) == ["ef", "master", "opt", "step"]
    _same_tree(ts, js)
    for k, leaf in _paths(js).items():
        assert str(_paths(ts)[k].dtype) == f"torch.{leaf.dtype}", k


def test_checkpoint_round_trip_with_a_bf16_leaf(tmp_path):
    _, state = _state_pair()
    state["extra_bf16"] = torch.randn((5, 3)).to(torch.bfloat16)
    mgr = CheckpointManager(str(tmp_path), keep_last=3)
    mgr.save(3, state, blocking=True)
    restored, step = mgr.restore(state, device="cpu")
    assert step == 3
    assert sorted(_paths(restored)) == sorted(_paths(state))
    for k, a in _paths(state).items():
        b = _paths(restored)[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert torch.equal(a, b), k


def test_checkpoint_cleanup_keeps_the_last(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    state = {"x": torch.arange(4)}
    for s in (1, 2, 3, 4):
        mgr.save(s, state, blocking=True)
    assert mgr.steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_restore_checks_shapes_and_leaves(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros((2, 3))}, blocking=True)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"w": torch.zeros((3, 2))}, device="cpu")
    with pytest.raises(KeyError, match="missing leaf v"):
        mgr.restore({"v": torch.zeros((2, 3))}, device="cpu")
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({}, device="cpu")


def test_a_reference_checkpoint_restores_into_the_port(tmp_path):
    js, ts = _state_pair(seed=1)
    JCkpt(str(tmp_path)).save(5, js, blocking=True)
    like = train_state_from_numpy(jax.tree.map(np.zeros_like,
                                               jax.tree.map(np.asarray, js)),
                                  "cpu")
    restored, step = CheckpointManager(str(tmp_path)).restore(like,
                                                              device="cpu")
    assert step == 5
    _same_tree(restored, js)
    for k, leaf in _paths(js).items():
        assert str(_paths(restored)[k].dtype) == f"torch.{leaf.dtype}", k


def test_a_port_checkpoint_restores_into_the_reference(tmp_path):
    js, ts = _state_pair(seed=2)
    CheckpointManager(str(tmp_path)).save(7, ts, blocking=True)
    restored, step = JCkpt(str(tmp_path)).restore(jax.eval_shape(lambda: js))
    assert step == 7
    _same_tree(ts, restored)
    for k, leaf in _paths(restored).items():
        assert str(_paths(ts)[k].dtype) == f"torch.{leaf.dtype}", k


def test_a_reference_bf16_leaf_restores_with_its_bits(tmp_path):
    """The reference's ``np.save`` writes a bfloat16 leaf as 2-byte voids;
    the port reads the bits back as bfloat16, and writes them back with
    the reference's manifest."""
    x = jnp.asarray(np.random.default_rng(0).standard_normal((4, 6)),
                    jnp.bfloat16)
    JCkpt(str(tmp_path / "ref")).save(1, {"x": x}, blocking=True)
    mgr = CheckpointManager(str(tmp_path / "ref"))
    got, _ = mgr.restore({"x": torch.zeros((4, 6), dtype=torch.bfloat16)},
                         device="cpu")
    assert got["x"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["x"].view(torch.int16).numpy(),
                                  np.asarray(x).view(np.int16))
    CheckpointManager(str(tmp_path / "port")).save(1, got, blocking=True)
    np.testing.assert_array_equal(
        np.load(tmp_path / "port" / "step_1" / "x.npy").view(np.int16),
        np.asarray(x).view(np.int16))
    ref_m = json.loads((tmp_path / "ref" / "step_1" /
                        "manifest.json").read_text())
    port_m = json.loads((tmp_path / "port" / "step_1" /
                         "manifest.json").read_text())
    assert port_m["leaves"] == ref_m["leaves"]
    assert port_m["treedef"] == ref_m["treedef"]


def test_a_failed_write_is_raised_by_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))

    def refuse(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(np, "save", refuse)
    mgr.save(1, {"w": torch.zeros(2)})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.steps() == []


# -- trainer ------------------------------------------------------------------

def _trainers(tmp_path, fail_at=()):
    """The reference's ``tests/test_runtime.py`` setup in both packages,
    from one initial state."""
    cfg = get_arch("internlm2-1.8b").smoke()
    tcfg = tget("internlm2-1.8b").smoke()
    jopt, topt = JAdamW(learning_rate=1e-3), AdamW(learning_rate=1e-3)
    js = japi.init_train_state(cfg, PLAN, jax.random.PRNGKey(0), jopt)
    ts = train_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    jstream = JTokenStream(vocab_size=cfg.vocab_size, batch=2, seq_len=16,
                           seed=7)
    tstream = TokenStream(vocab_size=cfg.vocab_size, batch=2, seq_len=16,
                          seed=7)
    inj = lambda cls: cls(set(fail_at)) if fail_at else None
    jt = JTrainer(jax.jit(japi.make_train_step(cfg, PLAN, jopt)),
                  lambda s: {"tokens": jstream.batch_at(s)},
                  JCkpt(str(tmp_path / "ref"), 3), ckpt_every=5,
                  injector=inj(JFailureInjector))
    tt = Trainer(tapi.make_train_step(tcfg, TPLAN, topt),
                 lambda s: {"tokens": tstream.batch_at(s)},
                 CheckpointManager(str(tmp_path / "port"), 3), ckpt_every=5,
                 injector=inj(FailureInjector))
    return (js, jt), (ts, tt)


def test_trainer_trajectory_equals_the_reference(tmp_path):
    (js, jt), (ts, tt) = _trainers(tmp_path)
    jt.run(js, 12)
    final = tt.run(ts, 12)
    assert [h["step"] for h in tt.history] == list(range(12))
    np.testing.assert_allclose(tt.losses(), jt.losses(), rtol=1e-4)
    assert int(final["step"]) == 12
    assert tt.ckpt.steps() == [5, 10, 12]
    assert sorted(tt.history[0]) == sorted(jt.history[0])


def test_restart_reproduces_uninterrupted_run(tmp_path):
    """The reference's headline property on the port: failures at steps 7
    and 11 with a checkpoint every 5 steps give the loss trajectory and the
    final state of an uninterrupted run."""
    _, (ts, clean) = _trainers(tmp_path / "clean")
    final_clean = clean.run(ts, 12)
    _, (ts2, faulty) = _trainers(tmp_path / "faulty", fail_at=(7, 11))
    final_faulty, restarts = faulty.run_with_restarts(ts2, 12)
    assert restarts == 2
    a = {h["step"]: h["loss"] for h in clean.history}
    b = {h["step"]: h["loss"] for h in faulty.history}
    assert set(a) == set(b) == set(range(12))
    for s in a:
        np.testing.assert_allclose(a[s], b[s], rtol=1e-4, atol=1e-5)
    for x, y in zip(tree_leaves(final_clean), tree_leaves(final_faulty)):
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy(),
                                   rtol=1e-4, atol=1e-5)


# -- context-parallel decode without a mesh ----------------------------------

@pytest.mark.parametrize("name", ["internlm2-1.8b", "zamba2-7b"])
def test_unported_families_raise_naming_their_item(name):
    """Context-parallel decode, the LM path that used to raise here, is
    ported: with no plan scope, ``decode_cp=True`` falls back to naive
    decode in both packages and gives the reference's tokens and cache
    (the multi-rank CP route: ``test_torch_sharding``)."""
    assert_cp_decode_parity(name)


def test_init_train_state_has_the_reference_tree():
    cfg = get_arch("mamba2-370m").smoke()
    plan = PLAN.with_(grad_compression="int8_ef", moment_dtype="bfloat16")
    js = japi.init_train_state(cfg, plan, jax.random.PRNGKey(0),
                               JAdamW(moment_dtype="bfloat16"))
    ts = tapi.init_train_state(tget("mamba2-370m").smoke(),
                               TPlan(**{f: getattr(plan, f) for f in
                                        plan.__dataclass_fields__}),
                               torch.Generator().manual_seed(0),
                               AdamW(moment_dtype="bfloat16"), "cpu")
    jp, tp = _paths(js), _paths(ts)
    assert sorted(jp) == sorted(tp)
    for k, leaf in jp.items():
        assert tuple(tp[k].shape) == leaf.shape, k
        assert str(tp[k].dtype) == f"torch.{leaf.dtype}", k
