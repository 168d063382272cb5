"""The port's MoE layer and MLA attention against the reference, on the
smoke configs of deepseek-v2-lite-16b (MLA, 4 experts top-2 with shared
experts, a dense first layer) and grok-1-314b (GQA, 4 experts top-2, no
shared experts) in float32.

The reference's parameters go through ``convert.params_from_numpy`` and
the same numpy inputs through both packages.  Tolerance 1e-4 in float32,
as ``tests/test_torch_models.py``.  ``moe_apply`` is compared by its
output and aux loss (its expert-slot indices are internal)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch.configs import get_arch as tget
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import api as tapi
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT

TOL = dict(rtol=1e-4, atol=1e-4)
DEEPSEEK, GROK = "deepseek-v2-lite-16b", "grok-1-314b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (see
    ``tests/test_torch_models.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(port, ref, **tol):
    ref = np.asarray(ref)
    got = port.detach().numpy()
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, **(tol or TOL))


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# -- moe_apply ----------------------------------------------------------------

# (model, input, group_size, capacity_factor): prefill (B, S, D), decode
# (B, D), the sequence routed in groups of 8, and a capacity so small that
# tokens are dropped
MOE_CASES = {
    "prefill_shared": (DEEPSEEK, (2, 16), 0, None),
    "prefill_unshared": (GROK, (2, 16), 0, None),
    "decode_shared": (DEEPSEEK, (8,), 0, None),
    "decode_unshared": (GROK, (3,), 0, None),
    "groups_shared": (DEEPSEEK, (2, 16), 8, None),
    "groups_unshared": (GROK, (2, 16), 8, None),
    "drops": (DEEPSEEK, (2, 16), 0, 0.25),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_reference(case):
    name, lead, group, cf = MOE_CASES[case]
    cfg, tcfg = get_arch(name).smoke(), tget(name).smoke()
    if cf is not None:
        cfg, tcfg = (dataclasses.replace(
            c, moe=dataclasses.replace(c.moe, capacity_factor=cf))
            for c in (cfg, tcfg))
        m, T = cfg.moe, lead[1]
        # every expert's C slots together hold fewer than the T·K routings
        assert m.num_experts * JM._capacity(T, m) < T * m.top_k
    assert TM._capacity(lead[-1], tcfg.moe) == JM._capacity(lead[-1],
                                                             cfg.moe)
    jp = JM.init_moe(jax.random.PRNGKey(3), cfg, jnp.float32)
    assert ("shared" in jp) == (name == DEEPSEEK)
    x = _normal(lead + (cfg.d_model,), seed=len(case))
    jo, jaux = JM.moe_apply(jp, cfg, jnp.asarray(x), group_size=group)
    to, taux = TM.moe_apply(_port(jp), tcfg, torch.from_numpy(x),
                            group_size=group)
    _close(to, jo)
    _close(taux, jaux)


def test_top_k_puts_equal_values_lower_index_first():
    """The two top-k selections order ties as ``lax.top_k``: with fewer
    routed tokens than capacity, an expert's slots past them are
    zero-weight ties."""
    x = np.array([[0.0, 0.5, 0.0, 0.5, 0.0, 0.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 5)
    tv, ti = TM._top_k(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# -- MLA ----------------------------------------------------------------------

def _mla_params(seed=0):
    cfg, tcfg = get_arch(DEEPSEEK).smoke(), tget(DEEPSEEK).smoke()
    jp = JL.init_mla(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return cfg, tcfg, jp, _port(jp)


@pytest.mark.parametrize("S", [13, 16])
def test_mla_apply_matches_reference(S):
    """Prefill MLA (13 positions: ragged against the reference's chunks of
    8) through the flash path with v at its own width, against the
    reference's ``sdpa_chunked``."""
    cfg, tcfg, jp, tp = _mla_params()
    x = _normal((2, S, cfg.d_model), seed=S)
    jo, (jc, jkr) = JL.mla_apply(jp, cfg, jnp.asarray(x), jnp.arange(S),
                                 chunk=8)
    to, (tc, tkr) = TL.mla_apply(tp, tcfg, torch.from_numpy(x),
                                 torch.arange(S))
    _close(to, jo)
    _close(tc, jc)
    _close(tkr, jkr)


def test_mla_apply_gives_the_kernel_one_width(monkeypatch):
    """q and k reach the flash entry point at one width (qk_nope +
    qk_rope), v at its own v_head_dim, unpadded: the last columns of the
    kv projection, a view read in place (the reference's ``sdpa_chunked``
    takes v at that width too)."""
    cfg, tcfg, jp, tp = _mla_params()
    m = tcfg.mla
    seen = []
    real = ops.flash_attention

    def spy(q, k, v, *, causal=True):
        seen.append((tuple(q.shape), tuple(k.shape), v))
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(ops, "flash_attention", spy)
    out, _ = TL.mla_apply(tp, tcfg, torch.from_numpy(
        _normal((1, 5, cfg.d_model), 1)), torch.arange(5))
    ((qs, ks, v),) = seen
    width = m.qk_nope_head_dim + m.qk_rope_head_dim
    assert qs == ks == (1, 5, cfg.num_heads, width)
    assert tuple(v.shape) == (1, 5, cfg.num_heads, m.v_head_dim)
    assert v.stride(-1) == 1 and v.stride(-2) == m.qk_nope_head_dim \
        + m.v_head_dim                       # a view of kv's columns
    assert torch.count_nonzero(v) > 0
    assert tuple(out.shape) == (1, 5, cfg.d_model)


def test_mla_decode_matches_reference_and_writes_in_place():
    """The absorbed decode over a filled latent cache at per-slot positions;
    the port writes the new rows into the cache it was given."""
    cfg, tcfg, jp, tp = _mla_params(seed=1)
    m, B, Smax = cfg.mla, 3, 12
    x = _normal((B, cfg.d_model), seed=2)
    c = _normal((B, Smax, m.kv_lora_rank), seed=3)
    kr = _normal((B, Smax, m.qk_rope_head_dim), seed=4)
    pos = np.array([0, 5, 11], np.int32)
    jo, jc, jkr = JL.mla_decode(jp, cfg, jnp.asarray(x), jnp.asarray(c),
                                jnp.asarray(kr), jnp.asarray(pos))
    tc, tkr = torch.from_numpy(c), torch.from_numpy(kr)
    to, tc2, tkr2 = TL.mla_decode(tp, tcfg, torch.from_numpy(x), tc, tkr,
                                  torch.from_numpy(pos))
    assert tc2 is tc and tkr2 is tkr
    _close(to, jo)
    _close(tc, jc)
    _close(tkr, jkr)


@pytest.mark.parametrize("name", [DEEPSEEK, GROK])
def test_init_cache_has_the_reference_layout(name):
    """Full configs on the ``meta`` device: deepseek's MLA latent cache in
    a prefix group (its dense first layer) and the main group; grok's GQA
    cache."""
    cfg = get_arch(name)
    want = jax.eval_shape(lambda: JT.init_cache(cfg, 8, 4096, jnp.bfloat16))
    got = TT.init_cache(tget(name), 8, 4096, torch.bfloat16, device="meta")
    assert sorted(got) == sorted(want)
    for grp in want:
        assert sorted(got[grp]) == sorted(want[grp])
        for k, leaf in want[grp].items():
            assert tuple(got[grp][k].shape) == leaf.shape, (grp, k)


@pytest.mark.parametrize("name", [DEEPSEEK, GROK])
def test_active_param_count_matches_reference(name):
    """Full configs: the routed experts count top_k / num_experts."""
    assert tget(name).active_param_count() \
        == get_arch(name).active_param_count()
    assert tapi.count_params(tget(name), active_only=True) \
        < tapi.count_params(tget(name))


def test_cast_params_keeps_the_router_float32():
    cfg = tget(DEEPSEEK).smoke()
    params = tapi.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    cast = tapi.cast_params(params, torch.bfloat16)
    assert cast["blocks"]["moe"]["router"].dtype == torch.float32
    assert cast["blocks"]["moe"]["we1"].dtype == torch.bfloat16
    assert cast["prefix_blocks"]["mlp"]["w1"].dtype == torch.bfloat16
