"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``):
build the same containers in both packages from one set of numpy arrays,
and compare a reference container with the port's."""
import numpy as np
import jax.numpy as jnp
import torch

from repro.core import tables as rt
from repro_torch.convert import from_numpy_container
from repro_torch.core import tables as tt


def ref_container(obj):
    """A numpy-leafed container as the reference builds it: dense leaves on
    JAX's device, triple formats left numpy (as its casts leave them)."""
    if isinstance(obj, rt.DenseTensor):
        return rt.DenseTensor(jnp.asarray(obj.data), obj.valid_count,
                              obj.fill)
    if isinstance(obj, rt.StreamBuffer):
        return rt.StreamBuffer(jnp.asarray(obj.data), obj.t0)
    return obj


def both(obj):
    """(reference container, port container on the CPU) of one
    numpy-leafed reference container."""
    return ref_container(obj), from_numpy_container(obj, "cpu")


def _leaves(obj):
    if obj.kind == "dense":
        return {"data": obj.data}
    if obj.kind == "stream":
        return {"data": obj.data}
    if obj.kind == "columnar":
        out = {f"col:{c}": v for c, v in obj.columns.items()}
        out["valid"] = obj.valid
        return out
    return {"rows": obj.rows, "cols": obj.cols, "vals": obj.vals}


def assert_same(ref, port, rtol=1e-5, atol=1e-5, exact=False):
    """Same kind, leaves, dtypes, shapes, ``valid_count`` and ``nbytes``;
    values equal (``exact``) or within the stated tolerance."""
    assert ref.kind == port.kind
    rl, pl = _leaves(ref), _leaves(port)
    assert list(rl) == list(pl)
    for name in rl:
        r = np.asarray(rl[name])
        p = tt.to_numpy(pl[name])
        assert r.dtype == p.dtype, (name, r.dtype, p.dtype)
        assert r.shape == p.shape, (name, r.shape, p.shape)
        if exact or r.dtype.kind in "biu":
            np.testing.assert_array_equal(p, r, err_msg=name)
        else:
            np.testing.assert_allclose(p, r, rtol=rtol, atol=atol,
                                       err_msg=name)
    assert ref.nbytes == port.nbytes
    if ref.kind == "dense":
        assert ref.valid_count == port.valid_count
    if ref.kind == "coo":
        assert tuple(ref.shape) == tuple(port.shape)
    if ref.kind == "stream":
        assert ref.t0 == port.t0


def bf16_pair(x: np.ndarray):
    """The same bfloat16 values in both frameworks (both round to nearest
    even from float32)."""
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def cp_decode_step(name):
    """One decode step under ``decode_cp=True`` on the CPU, with no plan
    scope, in both packages on the same inputs: the smoke config of
    ``name`` in float32, the reference's parameters carried into the port,
    tokens [3, 5, 7, 9] at positions [9, 17, 4, 30] over a cache of 32
    rows filled with ``(arange % 7 - 3) / 10`` (the reference's CP test).
    Both fall back to naive decode there.  Returns ((reference tokens,
    cache leaves), (port tokens, cache leaves)) as numpy, the leaves in
    sorted-path order."""
    import jax
    from repro.configs import PlanConfig as JPlan
    from repro.configs import ShapeConfig as JShape
    from repro.configs import get_arch as jget
    from repro.models import api as japi
    from repro_torch.configs import PlanConfig, ShapeConfig, get_arch
    from repro_torch.convert import params_from_numpy
    from repro_torch.ckpt.checkpoint import _flatten
    from repro_torch.models import api
    from repro_torch.tree import tree_map

    jcfg, tcfg = jget(name).smoke(), get_arch(name).smoke()
    jplan = JPlan(param_dtype="float32", compute_dtype="float32",
                  attn_chunk=8, remat="none", decode_cp=True)
    tplan = PlanConfig(param_dtype="float32", compute_dtype="float32",
                       remat="none", decode_cp=True)
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0), jplan)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tok = np.array([3, 5, 7, 9], np.int32)
    pos = np.array([9, 17, 4, 30], np.int32)

    def fill(c):
        shape = tuple(c.shape)
        n = int(np.prod(shape))
        return (np.arange(n, dtype=np.float32).reshape(shape) % 7 - 3) / 10
    jc = jax.tree.map(lambda s: jnp.asarray(fill(s)),
                      japi.example_cache(jcfg, JShape("d", "decode", 32, 4),
                                         jplan))
    tc = tree_map(lambda t: torch.from_numpy(fill(t)),
                  api.init_cache(tcfg, 4, 32, torch.float32, "meta"))
    jn, jc2 = japi.make_decode_step(jcfg, JShape("d", "decode", 32, 4),
                                    jplan)(jp, jc, jnp.asarray(tok),
                                           jnp.asarray(pos))
    tn, tc2 = api.make_decode_step(tcfg, ShapeConfig("d", "decode", 32, 4),
                                   tplan)(tp, tc, torch.from_numpy(tok),
                                          torch.from_numpy(pos))
    jl = [np.asarray(v) for _, v in sorted(_flatten(
        jax.tree.map(np.asarray, jc2)).items())]
    tl = [v.numpy() for _, v in sorted(_flatten(tc2).items())]
    return (np.asarray(jn), jl), (tn.numpy(), tl)


def assert_cp_decode_parity(name):
    """``cp_decode_step``'s two sides agree: tokens equal, every cache
    leaf within rtol 1e-5 / atol 5e-6 (the reference's CP tolerances)."""
    (jn, jl), (tn, tl) = cp_decode_step(name)
    np.testing.assert_array_equal(tn, jn)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=5e-6)
