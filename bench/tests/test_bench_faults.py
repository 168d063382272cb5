"""A run with the timed path broken underneath reads ``correct`` false.

Each test drives the rest of a run (the look for a card skipped) on the
CPU at the tiny size of ``conftest.make_tiny``, with the cells' own
limits, and plants one fault that the cell can have: a train step that
returns its state unchanged; a train step that leaves out half of the
batch and takes the mean over the rest; a state unchanged only once
set-up is over; a served token altered where it is produced, in every
slot or in one.  (No cell spans chips, so none can leave out an exchange between
them.)  The same runs without a fault read every number.
"""
import json
import time

import pytest

from conftest import make_tiny
from harness import port, spec
from harness.cell import run_cell

TRAIN = "internlm2-1.8b.train-b4s2048"
SERVE = ["deepseek-v2-lite-16b.serve-longprompt",
         "internlm2-1.8b.serve-decode"]
SEED = 2 ** 31 + 17


def _run(root, cell):
    result, rec = run_cell(root, cell, SEED, 1.5, False, "cpu",
                           time.perf_counter(), bench_dir=root / "bench")
    return result, rec


def _limits_set(result):
    return all(c["limit"] is not None for c in result["compared"].values())


def test_train_state_unchanged(tiny_root, monkeypatch):
    real = port.train_step

    def broken(*a, **k):
        step = real(*a, **k)
        return lambda state, batch: (state, step(state, batch)[1])
    monkeypatch.setattr(port, "train_step", broken)
    result, rec = _run(tiny_root, TRAIN)
    assert rec["readings"]["change_gap"] == pytest.approx(1.0)
    assert _limits_set(result) and result["correct"] is False


def test_train_half_batch(tiny_root, monkeypatch):
    real = port.train_step

    def broken(*a, **k):
        step = real(*a, **k)

        def half(state, batch):
            t = batch["tokens"]
            return step(state, {"tokens": t[: t.shape[0] // 2]})
        return half
    monkeypatch.setattr(port, "train_step", broken)
    result, _ = _run(tiny_root, TRAIN)
    assert _limits_set(result) and result["correct"] is False


def test_train_state_unchanged_after_setup(tiny_root, monkeypatch):
    """The step is sound through set-up's checked steps and returns its
    state unchanged from the window on: only the step after the window
    can see it."""
    real = port.train_step
    sound = spec.load_cell(tiny_root, TRAIN).traffic["check_steps"]

    def broken(*a, **k):
        step, calls = real(*a, **k), [0]

        def later(state, batch):
            calls[0] += 1
            if calls[0] <= sound:
                return step(state, batch)
            return state, step(state, batch)[1]
        return later
    monkeypatch.setattr(port, "train_step", broken)
    result, rec = _run(tiny_root, TRAIN)
    assert rec["readings"]["change_gap"] <= 0.05
    late = result["compared"]["late_change_gap"]
    assert late["value"] == pytest.approx(1.0) and late["value"] > late["limit"]
    assert _limits_set(result) and result["correct"] is False


def test_served_token_altered_in_one_slot(tmp_path, monkeypatch):
    """One slot of the decode batch goes wrong; the sample's prefixes of
    many requests reach it."""
    root = make_tiny(tmp_path)
    mix = root / "bench" / "traffic" / "serve-decode.json"
    tr = json.loads(mix.read_text())
    tr.update(check_tokens=1000, check_prefix=2)
    mix.write_text(json.dumps(tr))
    real = port.server

    def broken(*a, **k):
        srv = real(*a, **k)
        decode, rows = srv.decode_fn, srv.params["head"].shape[0]

        def altered(p, c, t, pos):
            nxt, c = decode(p, c, t, pos)
            nxt = nxt.clone()
            nxt[1] = (nxt[1] + 1) % rows
            return nxt, c
        srv.decode_fn = altered
        return srv
    monkeypatch.setattr(port, "server", broken)
    result, rec = _run(root, SERVE[1])
    assert rec["checked"]["slots"] == tr["slots"]
    assert _limits_set(result) and result["correct"] is False


@pytest.mark.parametrize("cell", SERVE)
def test_served_token_altered(tiny_root, monkeypatch, cell):
    real = port.server

    def broken(*a, **k):
        srv = real(*a, **k)
        decode, rows = srv.decode_fn, srv.params["head"].shape[0]

        def altered(p, c, t, pos):
            nxt, c = decode(p, c, t, pos)
            return (nxt + 1) % rows, c
        srv.decode_fn = altered
        return srv
    monkeypatch.setattr(port, "server", broken)
    result, rec = _run(tiny_root, cell)
    assert rec["checked"]["tokens"] > 0
    assert _limits_set(result) and result["correct"] is False


@pytest.mark.parametrize("cell", [TRAIN] + SERVE)
def test_sound_runs_read_every_number(tiny_root, cell):
    result, rec = _run(tiny_root, cell)
    assert rec["attempted"] > 0 and rec["failed"] == 0
    for name, c in result["compared"].items():
        assert c["value"] is not None and c["value"] >= 0, name
    want = {m["name"] for m in spec.load_cell(tiny_root, cell).end_to_end}
    assert set(result["metrics"]) == want
