"""Operations and bytes of one call of the flash-attention kernel, from its
shapes: a frozen copy of the port's ``kernels/work.py`` ``flash_work``, so
that a change to the program cannot move the yardstick."""
from __future__ import annotations


def flash_work(b, sq, sk, h, kv, d, causal, esize, vd=None) -> tuple:
    """(bytes, operations) of one attention call: q, k and v read once and
    o written once (k and v at their KV heads); the query-key pairs that
    the mask keeps (causal, top-left aligned: query i sees min(i + 1, Sk)
    keys; else Sq x Sk), a multiply-add a pair and width in each product.
    v and o are ``vd`` wide (d by default): MLA's v at 128 beside 192."""
    vd = d if vd is None else vd
    nbytes = (b * sq * h * (d + vd) + b * sk * kv * (d + vd)) * esize
    return nbytes, 2.0 * b * h * (d + vd) * pairs(sq, sk, causal)


def pairs(sq, sk, causal) -> float:
    if not causal:
        return sq * sk
    if sq <= sk:
        return sq * (sq + 1) / 2
    return sk * (sk + 1) / 2 + (sq - sk) * sk


def bound_seconds(nbytes: float, operations: float, peaks: dict) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the memory's."""
    return max(operations / peaks["bf16_flops"],
               nbytes / peaks["hbm_bytes_per_s"])
