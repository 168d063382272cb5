"""The per-layer readers of the port's own regions and work counters, on
traced windows made by hand: each reads its number where the regions and
counters are there, and None where they are not (a port without them)."""
import json
from types import SimpleNamespace

import pytest

from conftest import BENCH
from harness import spec
from harness.trace import SPAN, Traced

R = "repro_torch."


def _read(name, **rec):
    cfg = json.loads((BENCH / "configs" / "deepseek-v2-lite-16b.json")
                     .read_text())
    return spec.metric_reader(name)(SimpleNamespace(cfg=cfg, **rec))


def _serving():
    """Two decode steps (10.1-10.4, 10.5-10.9) in a window of 10.0-11.0 s:
    their launches 10.1-10.2 and 10.5-10.8, each with its MoE block, and a
    prefill's MoE block at 10.42-10.48."""
    t = Traced()
    t.t0_s, t.window_s = 10.0, 1.0
    t.device = [("gemm", 10.15, 10.3), ("gather", 10.55, 10.6),
                ("flash_fwd_wgmma", 10.7, 10.95)]
    t.host = [(SPAN + "window", 10.0, 11.0),
              (R + "serve.decode", 10.1, 10.4),
              (R + "serve.decode.launch", 10.1, 10.2),
              (R + "model.moe", 10.12, 10.19),
              ("cudaLaunchKernel", 10.13, 10.131),
              ("cudaLaunchKernelExC", 10.14, 10.141),
              ("cudaMemcpyAsync", 10.15, 10.151),
              (R + "serve.decode.wait", 10.2, 10.39),
              ("cudaMemsetAsync", 10.3, 10.301),      # outside any launch
              (R + "model.moe", 10.42, 10.48),
              ("cudaLaunchKernel", 10.43, 10.431),
              (R + "serve.decode", 10.5, 10.9),
              (R + "serve.decode.launch", 10.5, 10.8),
              (R + "model.moe", 10.5, 10.65),
              ("cuLaunchKernel", 10.51, 10.511),
              ("cudaGraphLaunch", 10.52, 10.521),
              ("aten::mm", 10.53, 10.54),              # no enqueue call
              ("cuLaunchKernelEx", 10.8, 10.801)]     # at the launch's end
    return t


def _no_regions():
    t = _serving()
    t.host = [e for e in t.host if not e[0].startswith(R)]
    return t


def _train():
    t = Traced()
    t.t0_s, t.window_s = 0.0, 2.0
    t.device = [("gemm", 0.0, 1.9)]
    t.host = [(SPAN + "train_step", 0.0, 1.0), (SPAN + "train_step", 1.0,
                                                2.0)]
    for k in range(2):
        a = k + 0.8
        t.host.append((R + "train.optimizer", a, a + 0.1))
        t.host += [("cudaLaunchKernel", a + 0.001 * i, a + 0.001 * i)
                   for i in range(1, 1 + 30 + 10 * k)]
        t.host.append(("cudaLaunchKernel", a + 0.15, a + 0.151))
    return t


def test_expand_kv_gigabytes_a_decode_step():
    launches = {"expand_kv_bytes": 51_539_607_552}
    assert _read("expand_kv_gb.serve", traced=_serving(),
                 trace_launches=launches) == pytest.approx(25.769803776)
    assert _read("expand_kv_gb.serve", traced=_no_regions(),
                 trace_launches=launches) is None
    assert _read("expand_kv_gb.serve", traced=_serving(),
                 trace_launches={"flash_attention_tc": 3}) is None
    assert _read("expand_kv_gb.serve", traced=None) is None


@pytest.mark.parametrize("name", ["decode_launch_ms.serve",
                                  "decode_launch_ms.prefill"])
def test_decode_launch_milliseconds(name):
    assert _read(name, traced=_serving()) == pytest.approx(200.0)
    assert _read(name, traced=_no_regions()) is None
    assert _read(name, traced=None) is None


def test_decode_launches_count_enqueue_calls_inside_the_launch():
    """Three enqueue calls in the first launch, two and one at its very end
    in the second; none of an operator, a wait or a prefill."""
    assert _read("decode_launches.prefill", traced=_serving()) == 3.0
    assert _read("decode_launches.prefill", traced=_no_regions()) is None
    assert _read("decode_launches.prefill", traced=None) is None


def test_idle_in_moe():
    """Idle gaps 10.0-10.15, 10.3-10.55, 10.6-10.7 and 10.95-11.0 meet the
    MoE blocks at 10.12-10.15, 10.42-10.48, 10.5-10.55 and 10.6-10.65."""
    assert _read("idle_in_moe.prefill", traced=_serving()) == \
        pytest.approx(100 * (0.03 + 0.06 + 0.05 + 0.05))
    assert _read("idle_in_moe.prefill", traced=_no_regions()) is None
    empty = _serving()
    empty.device = []
    assert _read("idle_in_moe.prefill", traced=empty) is None


def test_idle_in_moe_merges_overlapping_regions():
    t = _serving()
    t.host.append((R + "model.moe", 10.13, 10.17))   # inside another
    assert _read("idle_in_moe.prefill", traced=t) == \
        pytest.approx(100 * (0.03 + 0.06 + 0.05 + 0.05))


def test_moe_useful_rows():
    launches = {"moe_rows_computed": 64 * 4096, "moe_rows_routed": 6 * 4096}
    assert _read("moe_useful_rows.prefill",
                 trace_launches=launches) == 9.375
    assert _read("moe_useful_rows.prefill",
                 trace_launches={"flash_attention_tc": 3}) is None
    assert _read("moe_useful_rows.prefill", trace_launches={
        "moe_rows_computed": 0, "moe_rows_routed": 0}) is None


def test_optimizer_launches():
    """30 and 40 enqueue calls inside the two optimizer regions, one after
    each: 35 a step."""
    assert _read("optimizer_launches.train", traced=_train()) == 35.0
    t = _train()
    t.host = [e for e in t.host if not e[0].startswith(R)]
    assert _read("optimizer_launches.train", traced=t) is None
    assert _read("optimizer_launches.train", traced=None) is None
