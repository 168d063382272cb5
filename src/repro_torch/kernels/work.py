"""One count of the work that a step does: the hand kernels' bytes and
operations from their shapes, and every other aten op's from dispatch.

``flash_work`` and ``ssd_work`` give the bytes (inputs read once, outputs
written once) and the operations (a multiply-add is two) that one call of
a kernel needs; ``chip_smoke.py`` bounds the kernels' times with them, and
``launch.dryrun`` counts a step's cost with them.  A backward pass
(``flash_bwd_work``, ``ssd_bwd_work``) is credited as its products: flash
attention's recomputes the scores and makes dV, dP, dQ and dK (five
products where the forward has two); the SSD's, the vector-Jacobian
product of the intra-chunk formula, twice the forward's operations.  Each
reads and writes twice the forward's bytes (the inputs, the outputs and
their gradients).

``count()`` counts everything that runs inside it, on this thread and on
autograd's (the state is the process's, not a thread's): the floating
point operations of each aten op by ``torch.utils.flop_counter``'s
formulas (products and convolutions; elementwise ops count none), and the
bytes of its operands and result, which is what XLA's "bytes accessed"
approximates.  Views, allocations and collectives move no bytes of their
own (collectives are tallied by ``models.partition``).  A ``DTensor``
counts as its local shard: this rank's work.  The hand kernels are ctypes
launches that dispatch never sees: their ``autograd.Function``s
(``FlashAttention``, ``SSDIntra``) run the kernel, or while the work is
counted on the CPU the plain version, and its backward inside
``kernel``, which adds the formula's work and counts nothing that runs
inside, so the count is the same on either device.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.flop_counter import flop_registry


def flash_work(b, sq, sk, h, kv, d, causal, esize, vd=None) -> tuple:
    """(bytes, operations) of one attention call: q, k and v read once and
    o written once (k and v at their KV heads); the query-key pairs that
    the mask keeps (causal, top-left aligned: query i sees min(i + 1, Sk)
    keys; else Sq x Sk), a multiply-add a pair and width in each product.
    v and o are ``vd`` wide (d by default): MLA's v before its padding."""
    vd = d if vd is None else vd
    nbytes = (b * sq * h * (d + vd) + b * sk * kv * (d + vd)) * esize
    return nbytes, 2.0 * b * h * (d + vd) * _pairs(sq, sk, causal)


def flash_bwd_work(b, sq, sk, h, kv, d, causal, esize, vd=None) -> tuple:
    """(bytes, operations) of attention's backward: q, k, v, o and dO read,
    dQ, dK and dV written; S = q·kᵀ recomputed, dV = Pᵀ·dO, dP = dO·vᵀ,
    dQ = dS·k and dK = dSᵀ·q over the pairs the mask keeps."""
    vd = d if vd is None else vd
    nbytes = 2 * flash_work(b, sq, sk, h, kv, d, causal, esize, vd)[0]
    return nbytes, 2.0 * b * h * (3 * d + 2 * vd) * _pairs(sq, sk, causal)


def _pairs(sq, sk, causal) -> float:
    if not causal:
        return sq * sk
    if sq <= sk:
        return sq * (sq + 1) / 2
    return sk * (sk + 1) / 2 + (sq - sk) * sk


def ssd_work(b, q, h, p, g, n) -> tuple:
    """(bytes, operations) the intra-chunk SSD needs: inputs read and
    outputs written once; C·Bᵀ on and under the diagonal once per group,
    the masked decay and M·x per head, the decayed Bᵀ·x per head."""
    tri = q * (q + 1) / 2
    nbytes = 4.0 * (b * q * h * p * 2 + b * q * h + 2 * b * q * g * n
                    + b * h * n * p + b * h)
    ops_count = (2.0 * b * g * n * tri
                 + b * h * (2.0 * p * tri + tri + 2.0 * q * n * p + q * p))
    return nbytes, ops_count


def ssd_bwd_work(b, q, h, p, g, n) -> tuple:
    nbytes, ops_count = ssd_work(b, q, h, p, g, n)
    return 2 * nbytes, 2 * ops_count


def flash_shapes(q, k, v, causal) -> tuple:
    """``flash_work``'s arguments for a call on q, k, v in either layout
    (``kernels.flash_attention``)."""
    if q.ndim == 3:
        (bh, sq, d), sk = q.shape, k.shape[1]
        return bh, sq, sk, 1, 1, d, causal, q.element_size(), v.shape[-1]
    b, sq, h, d = q.shape
    return (b, sq, k.shape[1], h, k.shape[2], d, causal, q.element_size(),
            v.shape[-1])


def ssd_shapes(x, B) -> tuple:
    b, q, h, p = x.shape
    return b, q, h, p, B.shape[2], B.shape[3]


class Tally:
    """Floating point operations and bytes counted so far."""

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.kernel_flops = 0.0       # of which credited to the hand kernels
        self.suspended = 0

    def as_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "kernel_flops": self.kernel_flops}


_ACTIVE = None          # the Tally of the open ``count()``, process-wide
_NO_BYTES = ("c10d", "_c10d_functional", "_dtensor", "profiler")


def counting() -> bool:
    return _ACTIVE is not None


def _local(x):
    local = getattr(x, "_local_tensor", None)     # a DTensor's shard
    return local if local is not None else x


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class _CountMode(TorchDispatchMode):

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        tally = _ACTIVE
        if tally is None or tally.suspended:
            return out
        largs, lkwargs, lout = tree_map(_local, (args, kwargs, out))
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            tally.flops += float(formula(*largs, **lkwargs, out_val=lout))
        name = func.name()
        if not (func.is_view or func.namespace in _NO_BYTES
                or name.split("::")[-1].startswith(("empty", "_empty"))):
            tally.bytes += _nbytes((largs, lkwargs)) + _nbytes(lout)
        return out


@contextmanager
def count():
    """Yield a ``Tally`` of the work run inside the block (not nested)."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("work.count() is already open")
    tally = _ACTIVE = Tally()
    try:
        with _CountMode():
            yield tally
    finally:
        _ACTIVE = None


@contextmanager
def kernel(work_of):
    """Inside ``count()``: credit ``work_of()`` (bytes, operations), a hand
    kernel's or its backward's, and count nothing that runs inside; else
    nothing (``work_of`` is not called)."""
    tally = _ACTIVE
    if tally is None:
        yield
        return
    nbytes, ops_count = work_of()
    tally.bytes += nbytes
    tally.flops += ops_count
    tally.kernel_flops += ops_count
    tally.suspended += 1
    try:
        yield
    finally:
        tally.suspended -= 1
