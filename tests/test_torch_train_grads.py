"""The port's LM training path against the reference, on the smoke configs
of internlm2-1.8b (dense GQA), mamba2-370m (SSM), deepseek-v2-lite-16b (MoE
with MLA), grok-1-314b (MoE with GQA), zamba2-7b (hybrid; in its own
test with non-zero LoRA deltas), internvl2-26b (patch embeddings
prepended, the loss on text positions) and seamless-m4t-medium
(encoder-decoder over frames) in float32: losses (with the MoE
aux loss),
every gradient leaf (``torch.autograd.grad`` against ``jax.grad``), block
remat, 3-step train states (plain, accumulated, int8 error feedback,
bfloat16 compute), and the backward passes of the flash-attention and SSD
``autograd.Function``s.

The reference's train state goes through ``convert.train_state_from_numpy``
into the port, and the same numpy tokens (and patch embeddings or frames)
through both packages.
Tolerances: loss 1e-5 relative; each gradient leaf 1e-4 of its largest
magnitude; train steps: loss 1e-4 relative and masters atol 1e-3 / rtol
3e-3, the reference's own allowance for a reordered first Adam step
(``tests/test_models_smoke.py``), 2e-2 with bfloat16 compute, and with
int8 error feedback all but 0.1% of each leaf, the rest within 2 lr a
step (an int8 code on a rounding boundary may differ by one), and each
master leaf's largest step at least half the reference's; the
attention backward 1e-5 (float32) and 2e-2 (bfloat16) of each gradient's
largest magnitude."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PlanConfig, get_arch
from repro.models import api as japi
from repro.optim import AdamW as JAdamW
from repro_torch.configs import PlanConfig as TPlan
from repro_torch.configs import get_arch as tget
from repro_torch.convert import params_from_numpy, train_state_from_numpy
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import api as tapi
from repro_torch.tree import tree_leaves, tree_unflatten
from repro_torch.optim import AdamW

NAMES = ["internlm2-1.8b", "mamba2-370m", "deepseek-v2-lite-16b",
         "grok-1-314b", "zamba2-7b", "internvl2-26b", "seamless-m4t-medium"]
PLAN = PlanConfig(param_dtype="float32", compute_dtype="float32",
                  master_dtype="float32", attn_chunk=8, loss_chunk=8,
                  remat="none")


def _tplan(plan: PlanConfig) -> TPlan:
    return TPlan(**{f: getattr(plan, f) for f in plan.__dataclass_fields__})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel workers beside timing-based tests of the reference, and idle
    OpenMP threads spinning here would add noise to their timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _batch(cfg, shape, seed=0):
    """A train batch as numpy: tokens of ``shape`` (B, S), and the frontend
    stub's standard-normal inputs of the vision-language family (patch
    embeddings) and the encoder-decoder (frames, longer than the tokens)."""
    B, S = shape
    out = {"tokens": _tokens(cfg, shape, seed)}
    rng = np.random.default_rng(1000 + seed)
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal(
            (B, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (B, S + 5, cfg.d_model)).astype(np.float32)
    return out


def _jax(batch, dtype="float32"):
    """The batch in JAX, its float arrays in ``dtype`` (the compute dtype:
    the reference's encoder carries the frames' dtype through its scan)."""
    return {k: jnp.asarray(a, dtype if a.dtype.kind == "f" else a.dtype)
            for k, a in batch.items()}


def _torch(batch, dtype="float32"):
    """The batch in PyTorch, rounded as ``_jax`` rounds it."""
    return {k: torch.from_numpy(a).to(getattr(torch, dtype))
            if a.dtype.kind == "f" else torch.from_numpy(a)
            for k, a in batch.items()}


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(a, np.float32)


def _with_lora_deltas(jp, seed=7):
    """A hybrid's reference parameters with the LoRA ``b_*`` (zero in the
    reference's init) set to seeded N(0, 0.1²) values."""
    rng = np.random.default_rng(seed)
    lora = {k: (jnp.asarray(0.1 * rng.standard_normal(v.shape), v.dtype)
                if k.startswith("b_") else v)
            for k, v in jp["lora"].items()}
    return dict(jp, lora=lora)


def _port_value_and_grad(tcfg, plan, params, batch):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = tapi.get_loss_fn(tcfg, plan)(tree_unflatten(params, leaves),
                                        _torch(batch))
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def _close_per_leaf(port, ref, frac):
    """Each leaf within ``frac`` of the reference leaf's largest magnitude."""
    p, r = _paths(port), _paths(ref)
    assert sorted(p) == sorted(r)
    for k in r:
        a, b = _f32(p[k]), _f32(r[k])
        assert a.shape == b.shape, k
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a - b).max())
        assert err <= frac * scale, (k, err, scale)


# -- losses and gradients -----------------------------------------------------

@pytest.mark.parametrize("seq", [16, 20])
@pytest.mark.parametrize("name", NAMES)
def test_loss_and_every_gradient_equal_the_reference(name, seq):
    """S 16 takes two loss chunks of 8; S 20, not a multiple of 8, one."""
    _loss_and_every_gradient_equal_the_reference(name, seq)


def _loss_and_every_gradient_equal_the_reference(name, seq, lora=False):
    cfg, tcfg = get_arch(name).smoke(), tget(name).smoke()
    jp = japi.init_params(cfg, jax.random.PRNGKey(1), PLAN)
    if lora:
        jp = _with_lora_deltas(jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    batch = _batch(cfg, (2, seq), seed=seq)
    jl, jg = jax.jit(jax.value_and_grad(japi.get_loss_fn(cfg, PLAN)))(
        jp, _jax(batch))
    tl, tg = _port_value_and_grad(tcfg, _tplan(PLAN), tp, batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _close_per_leaf(tg, jg, 1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_block_remat_gives_the_same_loss_and_gradients(name):
    tcfg = tget(name).smoke()
    params = tapi.init_params(tcfg, torch.Generator().manual_seed(3),
                              _tplan(PLAN), "cpu")
    batch = _batch(tcfg, (2, 16), seed=2)
    l0, g0 = _port_value_and_grad(tcfg, _tplan(PLAN), params, batch)
    l1, g1 = _port_value_and_grad(tcfg, _tplan(PLAN.with_(remat="block")),
                                  params, batch)
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


# -- train steps --------------------------------------------------------------

STEP_CASES = {
    "plain": (PLAN, 1e-3),
    "accum2": (PLAN.with_(accum=2), 1e-3),
    "int8_ef": (PLAN.with_(grad_compression="int8_ef"), 1e-3),
    "bf16_compute": (PLAN.with_(compute_dtype="bfloat16",
                                param_dtype="bfloat16"), 1e-3),
}


# deepseek's smoke config with int8 error feedback takes one step
# (test_one_int8_ef_step_of_mla_and_moe_equals_the_reference): over three,
# its codes are chaotic, not the port's sums: the port against itself, its
# masters perturbed by 1e-6 relative, differs in 0.6% of the MLA prefix
# layer's 6,144 wkv_a residuals after three steps, past the 0.1% below.
# The hybrid's takes one too (test_one_int8_ef_step_of_the_hybrid_...): the
# port against itself so perturbed differs in 0.46% of the 1,728 conv_b
# residuals of its groups at the third step (against the reference 0.17%),
# and at the second one code of the 96 Dskip residuals flips (1.0%)
STEP_PAIRS = [(name, case) for name in NAMES for case in sorted(STEP_CASES)
              if (name, case) not in (("deepseek-v2-lite-16b", "int8_ef"),
                                      ("zamba2-7b", "int8_ef"))]


@pytest.mark.parametrize("name,case", STEP_PAIRS)
def test_three_train_steps_equal_the_reference(name, case):
    _train_steps_equal_the_reference(name, case, 3)


def test_one_int8_ef_step_of_mla_and_moe_equals_the_reference():
    _train_steps_equal_the_reference("deepseek-v2-lite-16b", "int8_ef", 1)


def test_one_int8_ef_step_of_the_hybrid_equals_the_reference():
    _train_steps_equal_the_reference("zamba2-7b", "int8_ef", 1)


@pytest.mark.parametrize("what", ["gradients", "train_steps"])
def test_hybrid_with_lora_deltas_trains_as_the_reference(what):
    """Non-zero LoRA ``b_*`` in both packages: the loss and every gradient
    leaf (the ``a_*`` gradients are zero at the reference's init), and
    three plain AdamW steps."""
    if what == "gradients":
        _loss_and_every_gradient_equal_the_reference("zamba2-7b", 16,
                                                     lora=True)
    else:
        _train_steps_equal_the_reference("zamba2-7b", "plain", 3, lora=True)


def _train_steps_equal_the_reference(name, case, steps, lora=False):
    plan, lr = STEP_CASES[case]
    bf16 = plan.compute_dtype == "bfloat16"
    cfg, tcfg = get_arch(name).smoke(), tget(name).smoke()
    jopt, topt = JAdamW(learning_rate=lr), AdamW(learning_rate=lr)
    js = japi.init_train_state(cfg, plan, jax.random.PRNGKey(4), jopt)
    if lora:
        js = dict(js, master=_with_lora_deltas(js["master"]))
    ts = train_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    jstep = jax.jit(japi.make_train_step(cfg, plan, jopt))
    tstep = tapi.make_train_step(tcfg, _tplan(plan), topt)
    for i in range(steps):
        batch = _batch(cfg, (4, 16), seed=10 + i)
        j0, t0 = _paths(js["master"]), _paths(ts["master"])
        js, jm = jstep(js, _jax(batch, plan.compute_dtype))
        ts, tm = tstep(ts, _torch(batch, plan.compute_dtype))
        _every_leaf_moves(t0, _paths(ts["master"]), j0, _paths(js["master"]),
                          what=f"step {i}")
        assert sorted(tm) == sorted(jm) == ["grad_norm", "loss", "lr"]
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=2e-2 if bf16 else 1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]),
                                   rtol=2e-2 if bf16 else 1e-3)
        rtol, atol = (2e-2, 2e-2) if bf16 else (3e-3, 1e-3)
        jmaster, tmaster = _paths(js["master"]), _paths(ts["master"])
        assert sorted(jmaster) == sorted(tmaster)
        for k in jmaster:
            # int8 codes are a step function of the gradient: where the two
            # packages' float32 sums put a value on either side of a
            # rounding boundary, one code differs by one, and Adam's step
            # there (about lr, whatever the gradient's size) may take the
            # other sign: at most 2 lr a step apart
            _close_but_flips(_f32(tmaster[k]), _f32(jmaster[k]), rtol, atol,
                             flips="ef" in js, flip=2 * lr * (i + 1),
                             what=f"step {i}: {k}")
    assert int(ts["step"]) == int(js["step"]) == steps
    assert int(ts["opt"]["count"]) == steps
    if "ef" in js:
        for k, leaf in _paths(js["ef"]).items():
            # a residual is at most half a quantization step, and a flipped
            # code moves it by one step
            b = _f32(leaf)
            _close_but_flips(_f32(_paths(ts["ef"])[k]), b, 3e-3, 1e-3,
                             flips=True, flip=4 * float(np.abs(b).max()),
                             what=f"ef {k}")


def _every_leaf_moves(port0, port1, ref0, ref1, *, what):
    """Each master leaf's largest step is at least half the reference's.
    Adam moves every element with a gradient by about lr, so a leaf whose
    gradient is lost reads 0 here, whatever the masters' tolerance."""
    for k in ref0:
        ref = float(np.abs(_f32(ref1[k]) - _f32(ref0[k])).max())
        port = float(np.abs(_f32(port1[k]) - _f32(port0[k])).max())
        assert port >= 0.5 * ref, (what, k, port, ref)


def _close_but_flips(a, b, rtol, atol, *, flips, flip, what):
    """``a`` within atol + rtol |b| of ``b``; where ``flips``, all but 0.1%
    of the elements, and those within ``flip`` + atol."""
    diff = np.abs(a - b)
    off = diff > atol + rtol * np.abs(b)
    if not flips:
        assert not off.any(), (what, diff.max())
        return
    assert off.mean() <= 1e-3, (what, off.mean())
    assert diff.max() <= flip + atol, (what, diff.max(), flip)


@pytest.mark.parametrize("name", NAMES)
def test_accum_matches_single(name):
    """The reference's ``test_accum_matches_single`` on the port."""
    tcfg = tget(name).smoke()
    opt = AdamW(learning_rate=1e-2, clip_norm=0.0)
    state = tapi.init_train_state(tcfg, _tplan(PLAN),
                                  torch.Generator().manual_seed(3), opt,
                                  "cpu")
    batch = _torch(_batch(tcfg, (2, 16), seed=3))
    s1, m1 = tapi.make_train_step(tcfg, _tplan(PLAN), opt)(state, batch)
    s2, m2 = tapi.make_train_step(tcfg, _tplan(PLAN.with_(accum=2)),
                                  opt)(state, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=2e-4)
    for a, b in zip(tree_leaves(s1["master"]), tree_leaves(s2["master"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-3,
                                   atol=1e-3)


def test_train_step_leaves_the_old_state_and_runs_outside_inference_mode():
    tcfg = tget("mamba2-370m").smoke()
    opt = AdamW(learning_rate=1e-2)
    state = tapi.init_train_state(tcfg, _tplan(PLAN),
                                  torch.Generator().manual_seed(0), opt,
                                  "cpu")
    before = [t.clone() for t in tree_leaves(state)]
    batch = {"tokens": torch.from_numpy(_tokens(tcfg, (2, 16)))}
    new, metrics = tapi.make_train_step(tcfg, _tplan(PLAN), opt)(state,
                                                                 batch)
    for a, b in zip(before, tree_leaves(state)):
        assert torch.equal(a, b)
    assert int(new["step"]) == 1
    assert not any(t.requires_grad for t in tree_leaves(new))
    assert all(np.isfinite(float(v)) for v in metrics.values())


# -- the kernels' autograd Functions ------------------------------------------

def _attn_inputs(layout, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if layout == "3d":
        shapes = [(3, 37, 16), (3, 37, 16), (3, 37, 16)]
    elif layout == "3d_cross":
        shapes = [(2, 21, 24), (2, 33, 24), (2, 33, 24)]
    else:                                     # (B, S, H, d), KV heads 2 of 4
        shapes = [(2, 37, 4, 16), (2, 37, 2, 16), (2, 37, 2, 16)]
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dtype).requires_grad_(True) for s in shapes]


ATTN_CASES = [("3d", True), ("3d", False), ("3d_cross", False),
              ("gqa", True), ("gqa", False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout,causal", ATTN_CASES)
def test_flash_backward_equals_autograd_of_the_plain_version(layout, causal,
                                                             dtype):
    """Query blocks of 16 rows over 37 (or 21) queries: ragged last block,
    and under the causal mask blocks that read a prefix of the keys."""
    q, k, v = _attn_inputs(layout, dtype)
    o = tflash.flash_attention_ref(q, k, v, causal=causal)
    do = torch.from_numpy(np.random.default_rng(9).standard_normal(
        tuple(o.shape)).astype(np.float32)).to(dtype)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = tflash.flash_attention_bwd(q.detach(), k.detach(), v.detach(),
                                     o.detach(), do, causal=causal, block=16)
    frac = 2e-2 if dtype == torch.bfloat16 else 1e-5
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= frac * scale, \
            name


def test_ssd_backward_equals_autograd_of_the_plain_version():
    rng = np.random.default_rng(1)
    b, Q, h, p, g, n = 3, 8, 4, 6, 2, 5
    x, B, C = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .requires_grad_(True)
               for s in ((b, Q, h, p), (b, Q, g, n), (b, Q, g, n)))
    da = torch.from_numpy(-rng.uniform(0.01, 0.3, (b, Q, h))
                          .astype(np.float32)).requires_grad_(True)
    outs = tssd.ssd_intra_ref(x, da, B, C)
    cots = [torch.from_numpy(rng.standard_normal(tuple(o.shape))
                             .astype(np.float32)) for o in outs]
    want = torch.autograd.grad(outs, (x, da, B, C), cots)
    got = tssd.ssd_intra_bwd(x.detach(), da.detach(), B.detach(),
                             C.detach(), *cots)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-6, atol=1e-6)


def _stand_in_kernels(mp):
    """CPU tensors routed as CUDA ones, with the plain versions standing in
    for the kernels behind counting wrappers: the autograd Functions'
    wiring, reached on the CPU.  Returns the counts."""
    counts = {"flash": 0, "ssd": 0}

    def flash(q, k, v, *, causal=True):
        counts["flash"] += 1
        with torch.no_grad():
            return tflash.flash_attention_ref(q, k, v, causal=causal)

    def ssd(x, da, B, C):
        counts["ssd"] += 1
        with torch.no_grad():
            return tssd.ssd_intra_ref(x, da, B, C)

    mp.setattr(ops, "_route", lambda t, op: True)
    for mod in (ops, tflash):
        mp.setattr(mod, "flash_attention_cuda", flash)
    for mod in (ops, tssd):
        mp.setattr(mod, "ssd_intra_cuda", ssd)
    return counts


@pytest.fixture
def stand_in_kernels(monkeypatch):
    return _stand_in_kernels(monkeypatch)


def test_the_functions_are_applied_when_a_gradient_is_wanted(
        stand_in_kernels):
    q, k, v = _attn_inputs("gqa", torch.float32)
    out = ops.flash_attention(q, k, v, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    with torch.no_grad():
        assert ops.flash_attention(q, k, v, causal=True).grad_fn is None
    x = torch.zeros((2, 8, 4, 6), requires_grad=True)
    outs = ops.ssd_intra(x, torch.zeros((2, 8, 4)), torch.zeros((2, 8, 1, 5)),
                         torch.zeros((2, 8, 1, 5)))
    assert all(type(o.grad_fn).__name__ == "SSDIntraBackward" for o in outs)
    assert stand_in_kernels == {"flash": 2, "ssd": 1}


def test_the_plain_versions_take_cpu_tensors_with_gradients():
    q, k, v = _attn_inputs("gqa", torch.float32)
    out = ops.flash_attention(q, k, v, causal=True)
    assert type(out.grad_fn).__name__ != "FlashAttentionBackward"
    assert out.grad_fn is not None


@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("name", NAMES)
def test_model_gradients_through_the_functions_equal_the_plain_path(
        name, remat, monkeypatch):
    """A loss and its gradients through the Functions (kernels stood in by
    the plain versions) equal those through the plain path; each kernel
    runs once per layer that holds it, twice under block remat (the
    recompute), but in the hybrid's tail, which is not rematerialized."""
    tcfg = tget(name).smoke()
    plan = _tplan(PLAN.with_(remat=remat))
    params = tapi.init_params(tcfg, torch.Generator().manual_seed(5), plan,
                              "cpu")
    batch = _batch(tcfg, (2, 16), seed=7)
    l0, g0 = _port_value_and_grad(tcfg, plan, params, batch)
    counts = _stand_in_kernels(monkeypatch)
    l1, g1 = _port_value_and_grad(tcfg, plan, params, batch)
    times = 2 if remat == "block" else 1
    if tcfg.family == "hybrid":
        G = tcfg.num_layers // tcfg.attn_period
        T = tcfg.num_layers - G * tcfg.attn_period
        want = {"flash": G * times,
                "ssd": G * tcfg.attn_period * times + T}
    elif tcfg.family == "ssm":
        want = {"flash": 0, "ssd": tcfg.num_layers * times}
    elif tcfg.family == "encdec":
        # the encoder's self-attention, the decoder's self- and cross-
        want = {"flash": (tcfg.encoder_layers + 2 * tcfg.num_layers)
                * times, "ssd": 0}
    else:
        want = {"flash": tcfg.num_layers * times, "ssd": 0}
    assert counts == want
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    _close_per_leaf(g1, g0, 1e-5)
