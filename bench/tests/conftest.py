"""Fixtures of the benchmark's tests: the benchmark's modules and the port
on ``sys.path``, and a copy of the benchmark whose configurations and
traffic mixes are cut to a size the CPU runs in seconds (same cell names,
same limits).

    PYTHONPATH=src python -m pytest -q bench/tests

Tests marked ``gpu`` need a CUDA card and skip without one.
"""
import copy
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_TRAFFIC = {
    "train": {"batch": 2, "seq_len": 32, "check_steps": 3, "trace_steps": 1},
    "serve": {"slots": 4, "max_len": 96, "round": 8, "rate": 20.0,
              "prompt_len": {"dist": "uniform", "low": 8, "high": 48},
              "output_len": {"dist": "uniform", "low": 4, "high": 12},
              "check_tokens": 20, "trace_seconds": 1},
}


def tiny_config(cfg: dict) -> dict:
    """A configuration of the same kind at a width and depth that the CPU
    runs at once: its published keys and its ``port`` group alike."""
    cfg = copy.deepcopy(cfg)
    port = cfg["port"]
    cfg.update(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               vocab_size=300)
    port.update(d_model=64, num_layers=2, num_heads=4, vocab_size=300)
    if "kv_lora_rank" in cfg:
        cfg.update(num_key_value_heads=4, kv_lora_rank=32,
                   qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                   n_routed_experts=8, num_experts_per_tok=2,
                   n_shared_experts=1, moe_intermediate_size=32,
                   intermediate_size=96, first_k_dense_replace=1)
        port.update(num_kv_heads=4, head_dim=16, d_ff=32)
        port["mla"].update(kv_lora_rank=32, qk_nope_head_dim=16,
                           qk_rope_head_dim=8, v_head_dim=16)
        port["moe"].update(num_experts=8, top_k=2, num_shared_experts=1,
                           d_ff_expert=32, d_ff_shared=32,
                           capacity_factor=4.0, first_dense_layers=1,
                           d_ff_dense=96)
    else:
        cfg.update(num_key_value_heads=2, intermediate_size=128, head_dim=16)
        port.update(num_kv_heads=2, head_dim=16, d_ff=128)
    return cfg


def make_tiny(dest: Path) -> Path:
    """A checkout-like copy at ``dest`` (``BENCHMARK.json`` and ``bench``)
    with every configuration and traffic mix cut by ``tiny_config`` and
    ``TINY_TRAFFIC``."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(BENCH, dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for f in (dest / "bench" / "configs").glob("*.json"):
        f.write_text(json.dumps(tiny_config(json.loads(f.read_text()))))
    for f in (dest / "bench" / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t.update(TINY_TRAFFIC[t["kind"]])
        f.write_text(json.dumps(t))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
