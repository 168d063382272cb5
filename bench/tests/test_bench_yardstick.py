"""The yardstick's frozen pieces against numbers worked out by hand: the
flash kernel's operations and bytes, the kinds of device work, the model
FLOP formulas, the chip's peaks and the traffic generator."""
import json

import numpy as np
import pytest
import torch

from conftest import BENCH
from harness import check, flops, kinds, traffic, work
from harness.peaks import PEAKS


def _config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_flash_work_at_the_train_shape():
    # B 4, S 2048, 16 query over 8 KV heads, d 128, causal, bf16
    nbytes, ops = work.flash_work(4, 2048, 2048, 16, 8, 128, True, 2)
    assert nbytes == (4 * 2048 * 16 * 256 + 4 * 2048 * 8 * 256) * 2
    assert nbytes == 100_663_296
    assert ops == 2.0 * 4 * 16 * 256 * (2048 * 2049 / 2)
    assert ops == 68_753_031_168.0
    # operations bound it: 69.5 us at 989 TFLOP/s, 30 us of bytes
    assert work.bound_seconds(nbytes, ops, PEAKS) == pytest.approx(
        68_753_031_168 / 989e12)


def test_flash_work_mla_and_masks():
    # MLA: q/k 192, v 128, 16 heads, one sequence of 1000
    nbytes, ops = work.flash_work(1, 1000, 1000, 16, 16, 192, True, 2, 128)
    assert nbytes == (1000 * 16 * 320 * 2) * 2
    assert ops == 2.0 * 16 * 320 * 500_500
    assert work.pairs(3, 5, True) == 6
    assert work.pairs(5, 3, True) == 6 + 2 * 3
    assert work.pairs(4, 6, False) == 24


@pytest.mark.parametrize("name, want", [
    ("flash_fwd_wgmma<128, 128>", "hand"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", "gemm"),
    ("void cutlass::Kernel2<foo>", "gemm"),
    ("void at::native::radixSortKVInPlace", "sort"),
    ("void at::native::index_elementwise_kernel<128, 4>", "gather"),
    ("void at::native::direct_copy_kernel_cuda", "copy"),
    ("Memcpy DtoH (Device -> Pinned)", "copy"),
    ("void at::native::reduce_kernel<512, 1>", "reduce"),
    ("void at::native::vectorized_elementwise_kernel<4, silu>", "elementwise"),
    ("ncclDevKernel_SendRecv", "other"),
])
def test_kinds(name, want):
    assert kinds.kind(name) == want


def test_internlm2_train_step_flops():
    cfg = _config("internlm2-1.8b")
    per_layer = (2048 * 16 * 128 + 2 * 2048 * 8 * 128 + 16 * 128 * 2048
                 + 3 * 2048 * 8192)
    assert per_layer == 62_914_560
    assert flops.layer_params(cfg) == 24 * per_layer
    assert flops.head_params(cfg) == 92_544 * 2048
    attention = 24 * 2.0 * 16 * 256 * (2048 * 2049 / 2)    # one sequence
    want = 6.0 * (24 * per_layer + 92_544 * 2048) * 4 * 2048 \
        + 3 * 4 * attention
    assert flops.train_step(cfg, 4, 2048) == pytest.approx(want, rel=1e-12)
    assert flops.train_step(cfg, 4, 2048) == pytest.approx(8.85e13,
                                                           rel=2e-3)


def test_deepseek_prefill_flops():
    cfg = _config("deepseek-v2-lite-16b")
    mla = (2048 * 16 * 192 + 2048 * (512 + 64) + 512 * 16 * 256
           + 16 * 128 * 2048)
    moe = 2048 * 64 + (6 + 2) * 3 * 2048 * 1408
    dense = 3 * 2048 * 10944
    assert flops.layer_params(cfg) == 27 * mla + 26 * moe + dense
    # about 4.5 GFLOP a token of active work
    assert 2 * flops.layer_params(cfg) == pytest.approx(4.48e9, rel=5e-3)
    n = 2048
    want = (2.0 * flops.layer_params(cfg) * n + 2.0 * 102_400 * 2048
            + 27 * 2.0 * 16 * 320 * (n * (n + 1) / 2))
    assert flops.prefill(cfg, n) == pytest.approx(want, rel=1e-12)
    assert flops.attention_dims(cfg) == (16, 16, 192, 128)


def test_peaks():
    assert PEAKS == {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}


def test_quantiles():
    assert traffic.quantiles({"dist": "uniform", "low": 0, "high": 10},
                             5) == [1, 3, 5, 7, 9]
    q = traffic.quantiles({"dist": "loguniform", "low": 512, "high": 4096},
                          32)
    assert q == sorted(q) and 512 <= q[0] and q[-1] <= 4096
    assert q[16] == round(512 * 8 ** (16.5 / 32))
    assert traffic.quantiles({"dist": "fixed", "value": 7}, 3) == [7] * 3


@pytest.mark.parametrize("mix", ["serve-longprompt", "serve-decode"])
def test_every_seed_sends_the_same_sizes(mix):
    tr = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    n = tr["round"]
    rounds = {}
    for seed in (0, 2 ** 31 + 7, 3 * 2 ** 40):
        s = traffic.RequestStream(tr, 1000, seed)
        reqs = [s.next() for _ in range(2 * n)]
        assert all(r[0].dtype == np.int32 and 0 <= r[0].min()
                   and r[0].max() < 1000 for r in reqs)
        rounds[seed] = [sorted((len(ids), out) for ids, out in reqs[:n]),
                        [len(ids) for ids, _ in reqs]]
    first = next(iter(rounds.values()))
    for lengths, _ in rounds.values():
        assert sorted(x for x, _ in lengths) == sorted(x for x, _ in first[0])
        assert sorted(o for _, o in lengths) == sorted(o for _, o in first[0])
    orders = {tuple(o) for _, o in rounds.values()}
    assert len(orders) == 3


def test_sample_takes_prefixes_of_many_requests():
    rng = np.random.default_rng(0)
    done = [{"prompt": np.zeros(10 + i, np.int32), "out": list(range(20)),
             "slot": i % 8} for i in range(30)]
    picked = check.sample(done, 60, rng, prefix=4)
    assert picked[0]["prompt"].shape[0] == 39 and picked[0]["upto"] == 20
    assert [r["upto"] for r in picked[1:]] == [4] * 10
    assert len({len(r["prompt"]) for r in picked}) == 11
    whole = check.sample(done, 60, np.random.default_rng(0))
    assert [r["upto"] for r in whole] == [20, 20, 20]
    assert check.sample([], 60, rng) == []


def test_same_seed_same_requests():
    tr = json.loads((BENCH / "traffic" / "serve-decode.json").read_text())
    a, b = (traffic.RequestStream(tr, 5000, 2 ** 31 + 1) for _ in range(2))
    for _ in range(70):
        (ia, oa), (ib, ob) = a.next(), b.next()
        assert oa == ob and np.array_equal(ia, ib)
    fr = a.staggered(8)
    assert sorted(fr) == [(i + 0.5) / 8 for i in range(8)]


def test_train_batches():
    tr = {"batch": 2, "seq_len": 16}
    big = 2 ** 31 + 99
    a = traffic.train_batch(tr, 50, big, 3, "cpu")
    assert a.dtype == torch.int32 and a.shape == (2, 16)
    assert torch.equal(a, traffic.train_batch(tr, 50, big, 3, "cpu"))
    assert not torch.equal(a, traffic.train_batch(tr, 50, big, 4, "cpu"))
    assert int(a.min()) >= 0 and int(a.max()) < 50
    assert traffic.mix(big, "x") != traffic.mix(big + 1, "x")
    assert 0 <= traffic.mix(-5, "x") < 2 ** 63
