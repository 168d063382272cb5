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


def cp_decode_step(tcfg):
    """A decode step of the port's config ``tcfg`` under
    ``decode_cp=True`` on the CPU, as a call of no arguments: the one LM
    path the port does not have yet (it raises naming its ROADMAP item)."""
    from repro_torch.configs import PlanConfig, ShapeConfig
    from repro_torch.models import api
    plan = PlanConfig(param_dtype="float32", decode_cp=True)
    params = api.init_params(tcfg, torch.Generator().manual_seed(0), plan,
                             "cpu")
    cache = api.init_cache(tcfg, 1, 4, torch.float32, "cpu")
    step = api.make_decode_step(tcfg, ShapeConfig("serve", "decode", 4, 1),
                                plan)
    zero = torch.zeros((1,), dtype=torch.int32)
    return lambda: step(params, cache, zero, zero)
