"""The decode step's attention over a grouped-query cache on the CPU:
``ops.decode_attention``'s plain version (``decode_attention_ref``) against
the formula it replaced (repeat the KV heads to the query heads, then two
einsums), and its dispatch.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``)."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _expanded(q, k, v, pos):
    """The decode attention the port ran before the kernel: every KV head
    repeated to its query heads, float32 scores over sqrt(hd), masked
    softmax, the weights cast to q's dtype before the product with v."""
    n_rep = q.shape[1] // k.shape[2]
    ke = torch.repeat_interleave(k, n_rep, dim=-2)
    ve = torch.repeat_interleave(v, n_rep, dim=-2)
    s = torch.einsum("bhk,bshk->bhs", q, ke).to(torch.float32) \
        / math.sqrt(q.shape[-1])
    mask = torch.arange(ke.shape[1])[None, :] <= pos[:, None]
    s = s.masked_fill(~mask[:, None, :], float("-inf"))
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhs,bshk->bhk", w, ve)


def _inputs(G, KV, B=4, S=37, hd=32, seed=0, narrow=False):
    """q (B, G KV, hd), a cache k, v (B, S, KV, hd) and ragged positions
    (0, S - 1 and two between); with ``narrow``, k and v are views of the
    middle KV heads of a wider cache, as ``layers.rank_kv`` gives a rank."""
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.from_numpy(
        rng.normal(size=shape).astype(np.float32))
    q = t(B, G * KV, hd)
    if narrow:
        k, v = t(B, S, KV + 2, hd)[:, :, 1:-1], t(B, S, KV + 2, hd)[:, :, 1:-1]
    else:
        k, v = t(B, S, KV, hd), t(B, S, KV, hd)
    pos = torch.tensor([0, S - 1, S // 2, 5][:B], dtype=torch.int32)
    return q, k, v, pos


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("KV", [2, 3])
@pytest.mark.parametrize("G", [1, 2, 6])
def test_plain_decode_equals_the_expanded_formula_bit_for_bit(G, KV, narrow):
    """float32, ragged positions: each query head against its group's KV
    head gives every bit of the repeated heads' products."""
    q, k, v, pos = _inputs(G, KV, narrow=narrow)
    got = tref.decode_attention_ref(q, k, v, pos)
    assert got.shape == q.shape and got.dtype == q.dtype
    assert torch.equal(got, _expanded(q, k, v, pos))


def test_plain_decode_reads_only_rows_up_to_the_position():
    """Rows past a slot's position take no part: K's as NaN and V's as
    other values change no bit of the output."""
    q, k, v, pos = _inputs(2, 2)
    want = tref.decode_attention_ref(q, k, v, pos)
    past = torch.arange(k.shape[1])[None, :, None, None] \
        > pos[:, None, None, None]
    got = tref.decode_attention_ref(q, k.masked_fill(past, float("nan")),
                                    torch.where(past, v + 1, v), pos)
    assert torch.equal(got, want)


def test_plain_decode_in_bf16_is_the_float32_decode_within_bf16():
    """bfloat16 inputs: scores and softmax in float32, the weights and the
    output rounded to bfloat16, so within bfloat16's resolution (3e-2, the
    reference tests' attention tolerance) of the float32 decode."""
    q, k, v, pos = _inputs(6, 2, seed=1)
    got = tref.decode_attention_ref(*(t.to(torch.bfloat16)
                                      for t in (q, k, v)), pos)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(),
                               tref.decode_attention_ref(q, k, v, pos),
                               rtol=3e-2, atol=3e-2)


def test_decode_op_takes_the_plain_version_for_cpu_tensors(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA launcher")
    monkeypatch.setattr(tops, "decode_attention_cuda", boom)
    tops.reset_launches()
    q, k, v, pos = _inputs(2, 2)
    assert torch.equal(tops.decode_attention(q, k, v, pos),
                       tref.decode_attention_ref(q, k, v, pos))
    assert tops.launches()["decode_attention"] == 0
    assert tops.LAUNCHES["decode_attention"] == (tdec.decode_attention_cuda,
                                                 "launches")


def test_decode_op_refuses_other_devices():
    q = torch.empty((2, 4, 32), device="meta")
    k = torch.empty((2, 8, 2, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tops.decode_attention(q, k, k, torch.empty((2,), device="meta"))


def test_decode_launcher_refuses_cpu_tensors_before_building():
    q, k, v, pos = _inputs(2, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tdec.decode_attention_cuda(q, k, v, pos)
