"""The plain reference against the port's CPU path in float32, at a tiny
seeded size of each configuration: a prefill's logits, decoding through
the server's cache (the tokens each the reference's greedy choice), and
one train step's loss, gradients and masters.  So the reference that
decides ``correct`` on the card is itself held to something."""
import json

import numpy as np
import pytest
import torch

from conftest import BENCH, tiny_config
from harness import check, port, traffic, weights
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import api
from reference import transformer as ref

CONFIGS = ["internlm2-1.8b", "deepseek-v2-lite-16b"]
SEED = 2 ** 31 + 5


def _tiny(name):
    cfg = tiny_config(json.loads((BENCH / "configs" / f"{name}.json")
                                 .read_text()))
    a = port.arch(cfg)
    return cfg, a, weights.make(port.param_shapes(a, "float32"), SEED,
                                "cpu")


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_logits(name):
    cfg, a, params = _tiny(name)
    rng = np.random.default_rng(1)
    for n in (1, 7, 40):
        ids = torch.as_tensor(rng.integers(0, cfg["vocab_size"], n),
                              dtype=torch.int32)[None]
        prefill = api.make_prefill(a, ShapeConfig("t", "decode", 64, 1),
                                   port.plan("float32"))
        got = prefill(params, {"tokens": ids})[0][0]
        want = ref.logits_at(cfg, params, [(ids[0].long(), n - 1)])[0][0]
        assert got.shape == want.shape
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("name", CONFIGS)
def test_decode_through_the_cache(name):
    cfg, a, params = _tiny(name)
    srv = port.server(a, params, 4, 80, "cpu", torch.float32)
    rng = np.random.default_rng(2)
    reqs = []
    for i, n in enumerate((5, 17, 30, 11)):
        ids = rng.integers(0, cfg["vocab_size"], n).astype(np.int32)
        req = port.Request(i, ids, max_new_tokens=12)
        assert srv.submit(req)
        reqs.append(req)
    while any(not r.done for r in reqs):
        srv.step()
    served = [{"prompt": r.prompt, "out": r.out_tokens, "want": 12}
              for r in reqs]
    out = check.served_gaps(cfg, params, served, "cpu")
    assert len(out["gaps"]) == 48
    # every served token is the reference's greedy choice, to float32
    # rounding of the logits (a near-tie may pick either)
    assert out["gap_max"] <= 1e-4


@pytest.mark.parametrize("name", CONFIGS)
def test_one_train_step(name):
    cfg, a, master = _tiny(name)
    tr = json.loads((BENCH / "traffic" / "train-b4s2048.json").read_text())
    tr.update(batch=2, seq_len=24)
    opt = port.adamw(tr["optimizer"])
    step = port.train_step(a, opt, "float32")
    tokens = traffic.train_batch(tr, cfg["vocab_size"], SEED, 0, "cpu")
    state, m = step(port.train_state(master, opt), {"tokens": tokens})
    mine = weights.make(port.param_shapes(a, "float32"), SEED, "cpu")
    got = ref.train(cfg, mine, [tokens], tr["optimizer"])
    lr = tr["optimizer"]["learning_rate"]
    loss = float(m["loss"])
    if cfg.get("n_routed_experts"):
        return _moe_step(state, got, loss, opt)
    assert loss == pytest.approx(got["losses"][0], rel=1e-5)
    for path, p in weights.flatten(state["master"]):
        key = ".".join(path)
        g = float(torch.linalg.vector_norm(
            _at(state["opt"]["m"], path))) / (1 - opt.b1)
        assert g == pytest.approx(got["grad_norms"][key], rel=1e-3,
                                  abs=1e-9), key
        diff = (p - _at(mine, path).detach()).abs()
        # AdamW's first step moves each weight by about lr: a gradient
        # that is nought to rounding may move either way
        assert float(diff.max()) <= 2 * lr + 1e-6, key
        assert float((diff > 1e-6).float().mean()) <= 1e-3, key


def _moe_step(state, got, loss, opt):
    """The port's MoE loss adds 0.01 x the experts' balance loss, which
    the reference (a loss of served tokens, never trained here) leaves
    out: its loss is held a little apart, and the gradients of the
    attention (where the balance loss reaches only through the router's
    input) closely."""
    assert loss == pytest.approx(got["losses"][0], rel=2e-2)
    assert loss >= got["losses"][0]
    for path, _ in weights.flatten(state["master"]):
        if path[-1] in ("wq", "wo"):
            key = ".".join(path)
            g = float(torch.linalg.vector_norm(
                _at(state["opt"]["m"], path))) / (1 - opt.b1)
            assert g == pytest.approx(got["grad_norms"][key], rel=5e-2), key


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("factor,ok", [(1, True), (40, False)])
def test_spec_takes_yarn_only_where_it_is_plain_rope(factor, ok):
    """The published YaRN group at factor 1 is plain RoPE and is run; at
    the source's 40 the reference has no such rotation and refuses it."""
    cfg = json.loads((BENCH / "configs" / "deepseek-v2-lite-16b.json")
                     .read_text())
    cfg = dict(cfg, rope_scaling=dict(cfg["rope_scaling"], factor=factor))
    if ok:
        assert ref.spec(cfg).theta == cfg["rope_theta"]
    else:
        with pytest.raises(ValueError):
            ref.spec(cfg)
