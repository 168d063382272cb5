"""The reduction of a traced window and the per-layer readers, on
records made by hand."""
import json
from types import SimpleNamespace

import pytest

from conftest import BENCH
from harness import flops, spec, work
from harness.peaks import PEAKS
from harness.trace import SPAN, Traced


def _traced():
    t = Traced()
    t.t0_s, t.window_s = 10.0, 1.0
    t.device = [("flash_fwd_wgmma<128>", 10.1, 10.3),
                ("nvjet_gemm", 10.2, 10.4),       # overlaps the first
                ("flash_fwd_combine", 10.6, 10.7)]
    t.host = [(SPAN + "window", 10.0, 11.0),
              (SPAN + "decode_step", 10.3, 10.9),
              ("aten::einsum", 10.45, 10.55),
              ("cudaLaunchKernel", 10.8, 10.85)]
    return t


def test_busy_gaps_and_labels():
    t = _traced()
    assert t.busy_s() == pytest.approx(0.4)
    assert t.gaps() == pytest.approx([(10.0, 10.1), (10.4, 10.6),
                                      (10.7, 11.0)])
    labels = t.gap_labels()
    assert labels == pytest.approx({"window / no host op": 0.1,
                                    "decode_step / aten::einsum": 0.2,
                                    "decode_step / cudaLaunchKernel": 0.3})
    b = t.breakdown()
    assert b["device_ops"][0] == ["hand: flash_fwd_wgmma<128>",
                                  pytest.approx(0.2)]
    assert b["idle_gaps"][0][0] == "decode_step / cudaLaunchKernel"
    assert t.by_kind() == pytest.approx({"hand": 0.3, "gemm": 0.2})


def _read(name, **rec):
    cfg = json.loads((BENCH / "configs" / f"{rec.pop('config')}.json")
                     .read_text())
    run = SimpleNamespace(cfg=cfg, traffic={}, peaks=PEAKS, **rec)
    return spec.metric_reader(name)(run)


def test_idle_shares():
    for name in ("idle_share.train", "idle_share.serve",
                 "idle_share.prefill"):
        assert _read(name, config="internlm2-1.8b",
                     traced=_traced()) == pytest.approx(60.0)
        assert _read(name, config="internlm2-1.8b", traced=None) is None


def test_flash_rooflines():
    t = _traced()           # 0.3 s of flash kernels
    got = _read("flash_roofline.train", config="internlm2-1.8b", traced=t,
                trace_launches={"flash_attention_tc": 48}, batch=4,
                seq=2048)
    bound = work.bound_seconds(*work.flash_work(4, 2048, 2048, 16, 8, 128,
                                                True, 2), PEAKS)
    assert got == pytest.approx(100 * 48 * bound / 0.3)
    got = _read("flash_roofline.prefill", config="deepseek-v2-lite-16b",
                traced=t, trace_launches={"flash_attention_tc": 54},
                trace_prefills=[1000, 3000])
    b = [work.bound_seconds(*work.flash_work(1, n, n, 16, 16, 192, True, 2,
                                             128), PEAKS)
         for n in (1000, 3000)]
    assert got == pytest.approx(100 * 54 * (b[0] + b[1]) / 2 / 0.3)
    assert _read("flash_roofline.prefill", config="deepseek-v2-lite-16b",
                 traced=t, trace_launches={}, trace_prefills=[]) is None


def test_host_readers():
    cfg = json.loads((BENCH / "configs" / "internlm2-1.8b.json").read_text())
    assert _read("train_mfu", config="internlm2-1.8b", train_steps=10,
                 batch=4, seq=2048, window_s=8.0) == pytest.approx(
        100 * 10 * flops.train_step(cfg, 4, 2048) / (8.0 * 989e12))
    pre = [(0.1, 1000), (0.3, 3000), (0.2, 2000)]
    assert _read("prefill_ms_p50.prefill", config="internlm2-1.8b",
                 prefills=pre) == pytest.approx(200.0)
    assert _read("prefill_mfu", config="internlm2-1.8b",
                 prefills=pre) == pytest.approx(
        100 * sum(flops.prefill(cfg, n) for _, n in pre) / (0.6 * 989e12))
    assert _read("decode_step_ms.serve", config="internlm2-1.8b",
                 decode_seconds=2.0, decode_steps=40) == pytest.approx(50.0)
    assert _read("decode_step_ms.serve", config="internlm2-1.8b",
                 decode_seconds=0.0, decode_steps=0) is None
