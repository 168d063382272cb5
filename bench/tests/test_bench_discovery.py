"""The harness finds every configuration, traffic mix, limit and per-layer
metric by the name that ``BENCHMARK.json`` gives it, so that a later cell
or metric is added by adding files and entries; and ``BENCHMARK.json``
keeps the shape that the benchmark's contract gives it."""
import json
import re
import shutil
from types import SimpleNamespace

import pytest

from conftest import BENCH, ROOT
from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return spec.load_benchmark(ROOT)


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = root / "bench"
    cfg = json.loads((b / "configs" / "internlm2-1.8b.json").read_text())
    cfg["name"] = cfg["port"]["name"] = "later-model"
    (b / "configs" / "later-model.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "serve-decode.json").read_text())
    mix["rate"] = 0.5
    (b / "traffic" / "later-mix.json").write_text(json.dumps(mix))
    (b / "metrics" / "later_metric.serve.py").write_text(
        "def read(run):\n    return 2.0 * run.decode_steps\n")
    (b / "limits" / "later-model.later-mix.json").write_text(
        json.dumps({"gap_max": {"limit": 1.0}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "later-model", "source": "x",
                             "file": "bench/configs/later-model.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "later-model.later-mix",
                               "config": "later-model",
                               "traffic": "later-mix", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "later_metric.serve", "unit": "ms",
                               "better": "lower",
                               "source": "program_counter",
                               "layer": "serving", "moves":
                               "output_tokens_per_s",
                               "workloads": ["later-model.later-mix"]})
    for m in bench["end_to_end"]:
        if m["name"] == "output_tokens_per_s":
            m["workloads"].append("later-model.later-mix")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell(root, "later-model.later-mix", b)
    assert cell.config["name"] == "later-model"
    assert cell.traffic["rate"] == 0.5
    assert cell.limits == {"gap_max": {"limit": 1.0}}
    assert [m["name"] for m in cell.end_to_end] == ["output_tokens_per_s",
                                                     "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["later_metric.serve"]
    read = spec.metric_reader("later_metric.serve", b)
    assert read(SimpleNamespace(decode_steps=4)) == 8.0
    # the cells that were there are found as before
    old = spec.load_cell(root, "internlm2-1.8b.serve-decode", b)
    assert old.traffic["rate"] != 0.5
    with pytest.raises(KeyError):
        spec.load_cell(root, "no-such-cell", b)


def test_every_name_in_benchmark_json_has_its_files():
    bench = _bench()
    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        cell = spec.load_cell(ROOT, w["name"])
        assert cell.config["name"] == w["config"]
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (BENCH / "limits" / f"{w['name']}.json").exists()
        assert configs[w["config"]]["file"].startswith("bench/configs/")
    for m in bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_benchmark_json_keeps_the_contract():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "bench/run.py"]
    assert bench["paths"] == ["bench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert 2 + 14 * 24 * (bench["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for group, want in keys.items():
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names))
        for e in bench[group]:
            assert set(e) - {"workloads"} == want, e["name"]
            assert NAME.match(e["name"]), e["name"]
            for k in ("why", "layer", "source"):
                if k in e and group != "end_to_end" and group != "per_layer":
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
    cells = {w["name"]: w for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        for c in m.get("workloads", cells):
            assert c in e2e[m["moves"]].get("workloads", cells)
    for name, w in cells.items():
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        own = [m for m in bench["end_to_end"] if name in
               m.get("workloads", cells)]
        assert len(own) >= 2 and "setup_s" in [m["name"] for m in own]
        assert any(name in m.get("workloads", cells)
                   for m in bench["per_layer"])
    for c in bench["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in cells.values())
    assert len(json.dumps(bench)) <= 64 * 1024


def test_configs_keep_their_published_keys():
    """A configuration's published keys, each the port's as it runs, and
    any published key changed from the source named under ``reduced``
    (``changed`` also says why the port's own settings, which no
    published key gives, are what they are)."""
    bench = _bench()
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        port = cfg["port"]
        assert cfg["source"] == c["source"]
        assert set(c["reduced"]) == {k for k in cfg["changed"] if k in cfg}
        assert port["d_model"] == cfg["hidden_size"]
        assert port["num_layers"] == cfg["num_hidden_layers"]
        assert port["num_heads"] == cfg["num_attention_heads"]
        assert port["vocab_size"] == cfg["vocab_size"]
        assert port["norm_eps"] == cfg["rms_norm_eps"]
        assert port["rope_theta"] == cfg["rope_theta"]
        assert port.get("tie_embeddings", False) == cfg["tie_word_embeddings"]
        if "mla" in port:
            m, e = port["mla"], port["moe"]
            assert (m["kv_lora_rank"], m["qk_nope_head_dim"],
                    m["qk_rope_head_dim"], m["v_head_dim"]) == (
                cfg["kv_lora_rank"], cfg["qk_nope_head_dim"],
                cfg["qk_rope_head_dim"], cfg["v_head_dim"])
            assert (e["num_experts"], e["top_k"], e["num_shared_experts"],
                    e["d_ff_expert"], e["d_ff_shared"],
                    e["first_dense_layers"], e["d_ff_dense"]) == (
                cfg["n_routed_experts"], cfg["num_experts_per_tok"],
                cfg["n_shared_experts"], cfg["moe_intermediate_size"],
                cfg["n_shared_experts"] * cfg["moe_intermediate_size"],
                cfg["first_k_dense_replace"], cfg["intermediate_size"])
            # every expert may take every token: routing drops nothing
            assert e["capacity_factor"] * e["top_k"] >= e["num_experts"] \
                - 1e-9
        else:
            assert port["num_kv_heads"] == cfg["num_key_value_heads"]
            assert port["d_ff"] == cfg["intermediate_size"]
            assert port["head_dim"] == cfg["hidden_size"] // cfg[
                "num_attention_heads"]


def test_deepseek_holds_the_catalog_config():
    """Every number of the public config.json under its own key, changed
    only where ``reduced`` says (the catalog row, copied here)."""
    published = {
        "attention_bias": False, "first_k_dense_replace": 1,
        "hidden_size": 2048, "intermediate_size": 10944,
        "kv_lora_rank": 512, "max_position_embeddings": 163840,
        "moe_intermediate_size": 1408, "moe_layer_freq": 1, "n_group": 1,
        "n_routed_experts": 64, "n_shared_experts": 2,
        "norm_topk_prob": False, "num_attention_heads": 16,
        "num_experts_per_tok": 6, "num_hidden_layers": 27,
        "num_key_value_heads": 16, "q_lora_rank": None,
        "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
        "rms_norm_eps": 1e-06, "rope_theta": 10000,
        "routed_scaling_factor": 1, "seq_aux": True,
        "tie_word_embeddings": False, "topk_group": 1, "v_head_dim": 128,
        "vocab_size": 102400,
        "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                         "mscale": 0.707, "mscale_all_dim": 0.707,
                         "original_max_position_embeddings": 4096,
                         "type": "yarn"}}
    c = next(c for c in _bench()["configs"]
             if c["name"] == "deepseek-v2-lite-16b")
    cfg = json.loads((ROOT / c["file"]).read_text())
    for k, v in published.items():
        assert cfg[k] == v or k in c["reduced"], k
        # a group is copied whole; a width in it never changes
        if isinstance(v, dict):
            assert set(cfg[k]) == set(v), k
            for sub, x in v.items():
                if sub.endswith(("_dim", "_rank")):
                    assert cfg[k][sub] == x, (k, sub)
