"""The port's LM serving path against the reference, on the smoke configs
of internlm2-1.8b (dense GQA), mamba2-370m (SSM), deepseek-v2-lite-16b (MoE
with MLA and a dense first layer), grok-1-314b (MoE with GQA), zamba2-7b
(hybrid: Mamba2 layers and a shared attention block with LoRA deltas, in
its own test also non-zero ones), internvl2-26b (vision-language: patch
embeddings prepended) and seamless-m4t-medium (encoder-decoder over
frames, with cross-attention) in float32.

The reference's parameters (``repro.models.api.init_params``) go through
``convert.params_from_numpy`` into the port, and the same numpy tokens,
patch embeddings and frames go through both packages.  Tolerance 1e-4 in
float32 (the two frameworks sum in different orders); generated tokens
must be equal, and int32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PlanConfig, ShapeConfig, get_arch
from repro.models import api as japi
from repro.models import encdec as JE
from repro.models import hybrid as JH
from repro.models import layers as JL
from repro.models import ssm as JM
from repro.models import ssm_lm as JS
from repro.models import transformer as JT
from repro.runtime.server import BatchServer as JBatchServer
from repro.runtime.server import Request as JRequest
from _torch_parity import assert_cp_decode_parity
from repro_torch.configs import PlanConfig as TPlan
from repro_torch.configs import get_arch as tget
from repro_torch.convert import params_from_numpy
from repro_torch.models import api as tapi
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TM
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.runtime import BatchServer as TBatchServer
from repro_torch.runtime import Request as TRequest

TOL = dict(rtol=1e-4, atol=1e-4)
PLAN = PlanConfig(param_dtype="float32", compute_dtype="float32",
                  attn_chunk=8, remat="none")
TPLAN = TPlan(param_dtype="float32", compute_dtype="float32", remat="none")
NAMES = ["internlm2-1.8b", "mamba2-370m", "deepseek-v2-lite-16b",
         "grok-1-314b", "zamba2-7b", "internvl2-26b", "seamless-m4t-medium",
         "qwen2-72b", "glm4-9b", "codeqwen1.5-7b"]
# encoder frames of the encoder-decoder's prefills: not the decoder
# prompt's length, so the cross-attention has Sq != Sk
FRAMES = 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel workers beside timing-based tests of the reference, and idle
    OpenMP threads spinning here would add noise to their timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name):
    return get_arch(name).smoke(), tget(name).smoke()


def _params(cfg, seed=0, lora=False):
    jp = japi.init_params(cfg, jax.random.PRNGKey(seed), PLAN)
    if lora:
        jp = _with_lora_deltas(jp)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _with_lora_deltas(jp, seed=7):
    """A hybrid's reference parameters with the LoRA ``b_*`` (zero in the
    reference's init) set to seeded N(0, 0.1²) values, so that the deltas
    W + a·b move every shared-block weight."""
    rng = np.random.default_rng(seed)
    lora = {k: (jnp.asarray(0.1 * rng.standard_normal(v.shape), v.dtype)
                if k.startswith("b_") else v)
            for k, v in jp["lora"].items()}
    return dict(jp, lora=lora)


def _close(port, ref, **tol):
    ref = np.asarray(ref)
    got = port.detach().numpy()
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, **(tol or TOL))


def _cache_leaves(cache):
    """{path: leaf} of a nested cache dict of either package."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(prefix + (k,), v)
        else:
            out[prefix] = node
    walk((), cache)
    return out


def _same_cache(tcache, jcache):
    t, j = _cache_leaves(tcache), _cache_leaves(jcache)
    assert sorted(t) == sorted(j)
    for path in j:
        _close(t[path], j[path])


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _stub(cfg, batch, seed, frames=FRAMES):
    """The frontend stub's inputs of a family, as numpy: patch embeddings
    (vlm) or frames (encdec), standard normal; none for the others."""
    rng = np.random.default_rng(1000 + seed)
    if cfg.family == "vlm":
        shape = (batch, cfg.num_frontend_tokens, cfg.d_model)
        return {"patch_embeds": rng.standard_normal(shape)
                .astype(np.float32)}
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal((batch, frames, cfg.d_model))
                .astype(np.float32)}
    return {}


def test_configs_are_the_reference_configs():
    """Every config of the registry, and its smoke variant, field for
    field (the port copies the config files)."""
    from repro.configs import ARCHS
    from repro_torch.configs import ARCHS as TARCHS
    assert sorted(TARCHS) == sorted(ARCHS)
    for name in ARCHS:
        for n in (name, name + "-smoke"):
            assert repr(tget(n)) == repr(get_arch(n)), n


@pytest.mark.parametrize("name", NAMES)
def test_param_count_matches_reference(name):
    """Full-size configs: the port's shapes give the reference's count (no
    parameter is allocated on either side)."""
    assert tget(name).param_count() == get_arch(name).param_count()


def test_cast_params_keeps_the_f32_sensitive_leaves():
    cfg, _ = _cfgs("mamba2-370m")
    jp, tp = _params(cfg)
    jc = japi.cast_params(jp, jnp.bfloat16)
    tc = tapi.cast_params(tp, torch.bfloat16)
    for name, leaf in jc["blocks"].items():
        assert str(tc["blocks"][name].dtype) == f"torch.{leaf.dtype}", name


@pytest.mark.parametrize("name", NAMES)
def test_params_from_numpy_keeps_bfloat16_bits(name):
    """bfloat16 leaves (numpy's ml_dtypes) arrive bit for bit; ``dtype=``
    casts float32 leaves as ``cast_params`` does."""
    cfg, _ = _cfgs(name)
    jp = japi.init_params(cfg, jax.random.PRNGKey(1),
                          PlanConfig(param_dtype="bfloat16"))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in jl:
        got = tp
        for key in path:
            got = got[key.key]
        assert str(got.dtype) == f"torch.{leaf.dtype}", path
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(leaf, np.float32))
    jp32, tp32 = _params(cfg)
    cast = params_from_numpy(jax.tree.map(np.asarray, jp32), "cpu",
                             dtype=torch.bfloat16)
    for a, b in zip(tree_leaves(cast), tree_leaves(
            tapi.cast_params(tp32, torch.bfloat16))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_expand_kv_is_repeat_not_tile():
    """Query head h reads KV head h // (H/KV), as ``jnp.repeat``."""
    k = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    _close(TL._expand_kv(torch.from_numpy(k), 3),
           JL._expand_kv(jnp.asarray(k), 3), rtol=0, atol=0)


@pytest.mark.parametrize("ndim", [4, 3])
def test_rope_apply_prefill_and_decode_broadcast(ndim):
    rng = np.random.default_rng(ndim)
    if ndim == 4:                    # prefill: (B, S, H, rd), positions (S,)
        x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
        pos = np.arange(5)
    else:                            # decode: (B, H, rd), positions (B,)
        x = rng.normal(size=(4, 3, 8)).astype(np.float32)
        pos = np.array([0, 3, 17, 250])
    got = TL.rope_apply(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    want = JL.rope_apply(jnp.asarray(x), jnp.asarray(pos), 1e6)
    _close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S,causal,Sk,rope", [
    pytest.param(13, True, None, True, id="13"),
    pytest.param(16, True, None, True, id="16"),
    # the encoder's self-attention
    pytest.param(13, False, None, True, id="13-noncausal"),
    # the decoder's cross-attention (no RoPE), Sq < Sk, Sq > Sk, and a
    # 1-token prompt
    pytest.param(13, False, 21, False, id="13-cross-21"),
    pytest.param(21, False, 9, False, id="21-cross-9"),
    pytest.param(1, False, 21, False, id="1-cross-21"),
    # xkv with positions: k rotated at arange(Sk), as the reference
    pytest.param(13, False, 21, True, id="13-xkv-21-rope"),
])
def test_attention_apply_matches_reference(S, causal, Sk, rope):
    """The port's prefill attention (the flash path; 13 positions: ragged)
    against the reference's query-chunked jnp path (chunks of 8): causal
    and not, and with k and v projected from ``xkv`` of another length."""
    cfg, tcfg = _cfgs("internlm2-1.8b")
    assert cfg.num_heads != cfg.num_kv_heads          # GQA on the path
    jp, tp = _params(cfg)
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    tl = tree_map(lambda a: a[0], tp["blocks"]["attn"])
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    xkv = None if Sk is None else \
        rng.normal(size=(2, Sk, cfg.d_model)).astype(np.float32)
    jo, (jk, jv) = JL.attention_apply(
        jl, cfg, jnp.asarray(x), jnp.arange(S) if rope else None,
        causal=causal, chunk=8,
        xkv=None if xkv is None else jnp.asarray(xkv))
    to, (tk, tv) = TL.attention_apply(
        tl, tcfg, torch.from_numpy(x), torch.arange(S) if rope else None,
        causal=causal, xkv=None if xkv is None else torch.from_numpy(xkv))
    _close(to, jo)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("s,init", [(20, False), (19, True), (8, True)])
def test_ssd_chunked_matches_reference(s, init):
    """Padding to a multiple of the chunk (dt = 0) and a carried initial
    state."""
    rng = np.random.default_rng(s)
    b, h, p, g, n, chunk = 2, 4, 6, 2, 5, 8
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(h,)) * 0.3).astype(np.float32)
    B = rng.normal(size=(b, s, g, n)).astype(np.float32)
    C = rng.normal(size=(b, s, g, n)).astype(np.float32)
    st = rng.normal(size=(b, h, n, p)).astype(np.float32) if init else None
    jy, jf = JM.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), chunk,
                            None if st is None else jnp.asarray(st))
    ty, tf = TM.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C)), chunk,
                            None if st is None else torch.from_numpy(st))
    _close(ty, jy)
    _close(tf, jf)


def _prefill_both(name, S, batch=1, max_len=32, lora=False):
    cfg, tcfg = _cfgs(name)
    jp, tp = _params(cfg, lora=lora)
    toks = _tokens(cfg, (batch, S), S)
    shape = ShapeConfig("serve", "prefill", max_len, batch)
    stub = _stub(cfg, batch, S)
    if cfg.family == "ssm":
        jout = JS.ssm_prefill(cfg, PLAN, jp, jnp.asarray(toks))
    elif cfg.family in ("dense", "moe"):
        jout = JT.lm_prefill(cfg, PLAN, jp, jnp.asarray(toks), max_len)
    else:       # the hybrid's is inline in the reference's api
        jout = japi.make_prefill(cfg, shape, PLAN)(
            jp, {"tokens": jnp.asarray(toks),
                 **{k: jnp.asarray(a) for k, a in stub.items()}})
    tout = tapi.make_prefill(tcfg, shape, TPLAN)(
        tp, {"tokens": torch.from_numpy(toks),
             **{k: torch.from_numpy(a) for k, a in stub.items()}})
    return cfg, tcfg, jp, tp, jout, tout


@pytest.mark.parametrize("name", NAMES)
def test_prefill_matches_reference(name):
    """Logits, next position and every cache leaf; S = 21 is not a multiple
    of the SSM chunk (8)."""
    *_, (jl, jc, jpos), (tl, tc, tpos) = _prefill_both(name, 21, batch=2)
    _close(tl, jl)
    _close(tpos, jpos, rtol=0, atol=0)
    _same_cache(tc, jc)


@pytest.mark.parametrize("name", NAMES)
def test_decode_step_matches_reference(name):
    _decode_step_matches_reference(name)


def _decode_step_matches_reference(name, lora=False):
    cfg, tcfg, jp, tp, (jl, jc, jpos), (tl, tc, tpos) = _prefill_both(
        name, 11, batch=2, lora=lora)
    tok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    shape = ShapeConfig("serve", "decode", 32, 2)
    jn, jc2 = japi.make_decode_step(cfg, shape, PLAN)(jp, jc, tok, jpos)
    tn, tc2 = tapi.make_decode_step(tcfg, shape, TPLAN)(
        tp, tc, torch.from_numpy(np.array(tok)), tpos)
    assert tn.dtype == torch.int32
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tc2 is tc                         # the cache is updated in place
    _same_cache(tc2, jc2)


def test_unported_families_raise():
    """Every family and now context-parallel decode are ported: with no
    plan scope, a ``decode_cp=True`` step of the dense and the hybrid
    smoke configs gives the reference's tokens and cache (both fall back
    to naive decode)."""
    for name in ("internlm2-1.8b", "zamba2-7b"):
        assert_cp_decode_parity(name)


def _serve_both(name, lengths, new_tokens=5, slots=3, max_len=40,
                lora=False, frames=FRAMES, enc_len=FRAMES):
    """Both packages' BatchServers on the same prompts.  A vision-language
    or encoder-decoder prefill is a closure over one stub tensor shared by
    the requests (the servers pass a prefill only the tokens); the
    encoder-decoder's cache holds ``enc_len`` encoder rows, which
    ``_write_rows`` zero-fills past ``frames``."""
    cfg, tcfg = _cfgs(name)
    jp, tp = _params(cfg, lora=lora)
    shape = ShapeConfig("serve", "decode", max_len, slots)
    stub = _stub(cfg, 1, 0, frames)
    jstub = {k: jnp.asarray(a) for k, a in stub.items()}
    tstub = {k: torch.from_numpy(a) for k, a in stub.items()}
    if cfg.family == "ssm":
        jpre = jax.jit(lambda p, t: JS.ssm_prefill(cfg, PLAN, p, t))
        jinit = lambda b, ml: JS.init_ssm_cache(cfg, b, jnp.float32)
    elif cfg.family in ("dense", "moe"):
        jpre = jax.jit(lambda p, t: JT.lm_prefill(cfg, PLAN, p, t, max_len))
        jinit = lambda b, ml: JT.init_cache(cfg, b, ml, jnp.float32)
    else:
        jpre_b = japi.make_prefill(cfg, shape, PLAN)
        jpre = jax.jit(lambda p, t: jpre_b(p, {"tokens": t, **jstub}))
        if cfg.family == "hybrid":
            jinit = lambda b, ml: JH.init_hybrid_cache(cfg, b, ml,
                                                       jnp.float32)
        elif cfg.family == "encdec":
            jinit = lambda b, ml: JE.init_encdec_cache(cfg, b, ml, enc_len,
                                                       jnp.float32)
        else:
            jinit = lambda b, ml: JT.init_cache(cfg, b, ml, jnp.float32)
    jsrv = JBatchServer(slots=slots, max_len=max_len, prefill_fn=jpre,
                        decode_fn=jax.jit(japi.make_decode_step(cfg, shape,
                                                                PLAN)),
                        params=jp, init_cache_fn=jinit)
    tpre = tapi.make_prefill(tcfg, shape, TPLAN)
    if cfg.family == "encdec":
        from repro_torch.models import encdec as TE
        tinit = lambda b, ml: TE.init_encdec_cache(tcfg, b, ml, enc_len,
                                                   torch.float32,
                                                   device="cpu")
    else:
        tinit = lambda b, ml: tapi.init_cache(tcfg, b, ml, torch.float32,
                                              "cpu")
    tsrv = TBatchServer(
        slots=slots, max_len=max_len,
        prefill_fn=lambda p, t: tpre(p, {"tokens": t, **tstub}),
        decode_fn=tapi.make_decode_step(tcfg, shape, TPLAN), params=tp,
        init_cache_fn=tinit)
    prompts = [_tokens(cfg, (n,), 100 + i) for i, n in enumerate(lengths)]
    jreqs = [JRequest(i, p, new_tokens) for i, p in enumerate(prompts)]
    treqs = [TRequest(i, p, new_tokens) for i, p in enumerate(prompts)]
    jsrv.run(jreqs)
    tsrv.run(treqs)
    return jsrv, tsrv, jreqs, treqs


@pytest.mark.parametrize("name,lengths", [
    ("internlm2-1.8b", [13, 1, 13, 1]),
    # 2 tokens < conv_width - 1: the reference's short conv tail, padded at
    # the end by _write_rows, is copied as it is
    ("mamba2-370m", [13, 2, 13, 2]),
    # MoE decode routes all three slots as one group, the idle one too
    ("deepseek-v2-lite-16b", [13, 1, 13, 1]),
    ("grok-1-314b", [13, 1, 13, 1]),
    ("zamba2-7b", [13, 1, 13, 1]),
    # the hybrid's Mamba layers carry the short conv tail too
    ("zamba2-7b", [13, 2, 13, 2]),
    # the server places a request at its prompt's length, not the patches'
    # and the prompt's (a quirk of the reference that the port copies)
    ("internvl2-26b", [13, 1, 13, 1]),
    ("seamless-m4t-medium", [13, 1, 13, 1]),
])
def test_batch_server_gives_the_reference_tokens(name, lengths):
    """Four requests on three slots (one waits for a free slot), two prompt
    lengths (two prefill compiles on the reference side)."""
    _batch_server_gives_the_reference_tokens(name, lengths)


def _batch_server_gives_the_reference_tokens(name, lengths, lora=False,
                                             **kw):
    jsrv, tsrv, jreqs, treqs = _serve_both(name, lengths, lora=lora, **kw)
    assert all(r.done for r in treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert all(len(r.out_tokens) == 5 for r in treqs)
    assert tsrv.stats["prefills"] == jsrv.stats["prefills"] == 4
    assert tsrv.stats["decode_steps"] == jsrv.stats["decode_steps"]
    _same_cache(tsrv.cache, jsrv.cache)


def test_encdec_frames_shorter_than_the_cache_serve_as_the_reference():
    """Frames shorter than the cache's encoder rows: ``_write_rows``
    zero-fills the rest of ``xk``/``xv``, and the unmasked decode
    cross-attention gives those rows weight (score 0), so decode is not the
    function that the prefill computed.  A quirk of the reference that the
    port copies: both servers give the same tokens and caches."""
    jsrv, tsrv, jreqs, treqs = _serve_both("seamless-m4t-medium",
                                           [13, 1, 13, 1], frames=10,
                                           enc_len=16)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert all(len(r.out_tokens) == 5 for r in treqs)
    assert tsrv.cache["xk"].shape[2] == 16
    assert not tsrv.cache["xk"][:, :, 10:].any()
    assert tsrv.cache["xk"][:, :, 9].any()
    _same_cache(tsrv.cache, jsrv.cache)


def test_vlm_server_decodes_from_the_prompt_length():
    """``BatchServer`` places a request at its prompt's length L, not at
    the P + L rows its prefill wrote (a quirk of the reference that the
    port copies: the servers' tokens agree above), so decode writes over
    the last P rows: each decoded token is the one that a prefill over the
    first L rows of [patches; prompt] and the tokens decoded before it
    predicts (chip_smoke's ``decode_vs_prefill`` for the family)."""
    _, tcfg = _cfgs("internvl2-26b")
    _, tp = _params(_cfgs("internvl2-26b")[0])
    stub = {k: torch.from_numpy(a) for k, a in _stub(tcfg, 1, 0).items()}
    P = tcfg.num_frontend_tokens
    prompt = _tokens(tcfg, (13,), 5)
    shape = ShapeConfig("serve", "decode", 40, 1)
    pre = tapi.make_prefill(tcfg, shape, TPLAN)
    srv = TBatchServer(
        slots=1, max_len=40,
        prefill_fn=lambda p, t: pre(p, {"tokens": t, **stub}),
        decode_fn=tapi.make_decode_step(tcfg, shape, TPLAN), params=tp,
        init_cache_fn=lambda b, ml: tapi.init_cache(tcfg, b, ml,
                                                    torch.float32, "cpu"))
    req = TRequest(0, prompt, 6)
    srv.run([req])
    kept = prompt[:len(prompt) - P]
    for k in range(1, 6):
        toks = np.concatenate([kept, np.asarray(req.out_tokens[:k],
                                                np.int32)])
        logits, _, _ = pre(tp, {"tokens": torch.from_numpy(toks[None]),
                                **stub})
        assert int(logits[0].argmax()) == req.out_tokens[k], k


@pytest.mark.parametrize("step", ["prefill", "decode", "batch_server"])
def test_hybrid_with_lora_deltas_matches_reference(step):
    """The hybrid with non-zero LoRA ``b_*`` in both packages, so that
    ``_shared_effective``'s W + a·b moves every group's shared block:
    prefill logits and every cache leaf, a decode step, and BatchServer
    tokens with a 2-token prompt."""
    if step == "prefill":
        *_, (jl, jc, jpos), (tl, tc, tpos) = _prefill_both(
            "zamba2-7b", 21, batch=2, lora=True)
        _close(tl, jl)
        _close(tpos, jpos, rtol=0, atol=0)
        _same_cache(tc, jc)
        *_, (jl0, _, _), _ = _prefill_both("zamba2-7b", 21, batch=2)
        assert float(np.abs(np.asarray(jl) - np.asarray(jl0)).max()) > 1e-2
    elif step == "decode":
        _decode_step_matches_reference("zamba2-7b", lora=True)
    else:
        _batch_server_gives_the_reference_tokens("zamba2-7b", [13, 2, 13, 2],
                                                 lora=True)


def _constructors():
    """The model-module constructors, each with its arguments but the
    device."""
    from repro_torch.models import encdec as TE
    from repro_torch.models import hybrid as TH
    from repro_torch.models import moe as TMoE
    from repro_torch.models import ssm_lm as TS
    from repro_torch.models import transformer as TT
    dense, ssm = tget("internlm2-1.8b").smoke(), tget("mamba2-370m").smoke()
    moe = tget("deepseek-v2-lite-16b").smoke()
    hyb = tget("zamba2-7b").smoke()
    ed = tget("seamless-m4t-medium").smoke()
    gen = torch.Generator()
    return {
        "init_encdec": lambda **kw: TE.init_encdec(ed, gen, TPLAN, **kw),
        "init_encdec_cache": lambda **kw: TE.init_encdec_cache(
            ed, 2, 8, 6, torch.float32, **kw),
        "init_hybrid": lambda **kw: TH.init_hybrid(hyb, gen, TPLAN, **kw),
        "init_hybrid_cache": lambda **kw: TH.init_hybrid_cache(
            hyb, 2, 8, torch.float32, **kw),
        "init_lm": lambda **kw: TT.init_lm(dense, gen, TPLAN, **kw),
        "init_cache": lambda **kw: TT.init_cache(dense, 2, 8, torch.float32,
                                                 **kw),
        "init_ssm_lm": lambda **kw: TS.init_ssm_lm(ssm, gen, TPLAN, **kw),
        "init_ssm_cache": lambda **kw: TS.init_ssm_cache(ssm, 2,
                                                         torch.float32, **kw),
        "init_mamba_state": lambda **kw: TM.init_mamba_state(ssm, 2, **kw),
        "init_mla": lambda **kw: TL.init_mla(gen, moe, torch.float32, **kw),
        "init_moe": lambda **kw: TMoE.init_moe(gen, moe, torch.float32, **kw),
    }


@pytest.mark.parametrize("name", ["init_lm", "init_cache", "init_ssm_lm",
                                  "init_ssm_cache", "init_mamba_state",
                                  "init_mla", "init_moe", "init_hybrid",
                                  "init_hybrid_cache", "init_encdec",
                                  "init_encdec_cache"])
def test_constructors_take_no_default_device(name):
    """A caller that skips ``api`` names the device: no constructor falls
    back to the CPU."""
    make = _constructors()[name]
    with pytest.raises(TypeError, match="device"):
        make()
    leaves = tree_leaves(make(device=torch.device("meta")))
    assert leaves and all(t.device.type == "meta" for t in leaves)


def test_batch_server_serve_matches_run():
    """Pool-parallel prefill (``serve``) gives what ``run`` gives."""
    cfg, tcfg = _cfgs("internlm2-1.8b")
    _, tp = _params(cfg)
    shape = ShapeConfig("serve", "decode", 40, 2)
    pre = tapi.make_prefill(tcfg, shape, TPLAN)

    def server():
        return TBatchServer(
            slots=2, max_len=40, prefill_fn=lambda p, t: pre(p, {"tokens": t}),
            decode_fn=tapi.make_decode_step(tcfg, shape, TPLAN), params=tp,
            init_cache_fn=lambda b, ml: tapi.init_cache(
                tcfg, b, ml, torch.float32, "cpu"))
    prompts = [_tokens(cfg, (n,), n) for n in (5, 9, 3)]
    a = server().run([TRequest(i, p, 4) for i, p in enumerate(prompts)])
    b = server().serve([TRequest(i, p, 4) for i, p in enumerate(prompts)],
                       workers=2)
    assert [r.out_tokens for r in a] == [r.out_tokens for r in b]
