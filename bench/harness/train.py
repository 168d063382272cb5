"""A training cell: the port's train step called back to back.

Set-up makes the float32 masters from the seed, builds the one train step
with its AdamW state, and drives that same object through its first
``check_steps`` steps through the window's own call and feed (which also
warms every shape the window uses); it keeps each step's loss, each
leaf's norm of the first gradient as AdamW took it (its first moment
over 1 - b1) and, after the last, each leaf's norm of the change from
the masters it started with (drawn again from the seed, a leaf at a
time).  The window then calls the step on fresh batches until its time
is up, reading each step's loss one step late so that the host never
waits on the device between steps.

After the window the same object takes one more step through the same
call and feed, from the state that the window left (the step returns a
new state and changes none of its arguments, so the state before it is
kept as it was).  The plain reference takes that step from that state
too: it can only follow the program so far from the program's own
masters and moments, which is why the first steps, from the seed, are
checked by themselves.  Its readings are the ``late_`` numbers.  Then
the program's state is freed and the reference follows the first steps
from the same weights and batches.
"""
from __future__ import annotations

import math
import time

import torch

from harness import check, port, traffic, weights
from harness import device as dev
from harness.trace import span, window


def _norms(tree, scale=1.0) -> dict:
    return {".".join(p): float(torch.linalg.vector_norm(
        t.to(torch.float32))) * scale for p, t in weights.flatten(tree)}


def _step_readings(after: dict, before: dict, loss, b1: float) -> dict:
    """The program's readings of one step from ``before`` to ``after``:
    its loss, each leaf's norm of the gradient as AdamW took it (from the
    first moment before and after) and of the leaf's change."""
    m0 = dict(weights.flatten(before["opt"]["m"]))
    m1 = dict(weights.flatten(after["opt"]["m"]))
    p0 = dict(weights.flatten(before["master"]))
    p1 = dict(weights.flatten(after["master"]))
    key = ".".join
    return {"losses": [float(loss)],
            "grad_norms": {key(k): float(torch.linalg.vector_norm(
                m1[k].float() - b1 * m0[k].float())) / (1.0 - b1)
                for k in m0},
            "change_norms": {key(k): float(torch.linalg.vector_norm(
                p1[k] - p0[k])) for k in p0}}


def _copy(tree: dict) -> dict:
    return weights.unflatten((p, t.clone()) for p, t in weights.flatten(tree))


def _late(gaps: dict) -> dict:
    return {"late_" + k: v for k, v in gaps.items()}


def run(cell, seed: int, seconds: float, trace: bool, device,
        control: bool = False) -> dict:
    cfg, tr = cell.config, cell.traffic
    a = port.arch(cfg)
    opt = port.adamw(tr["optimizer"])
    shapes = port.param_shapes(a, "float32")
    state = port.train_state(weights.make(shapes, seed, device), opt)
    step = port.train_step(a, opt)
    vocab = cfg["vocab_size"]

    def feed(k):
        return {"tokens": traffic.train_batch(tr, vocab, seed, k, device)}

    prog = {"losses": []}
    n_check = tr["check_steps"]
    for k in range(n_check):
        with span("train_step"):
            state, m = step(state, feed(k))
        prog["losses"].append(float(m["loss"]))
        if k == 0:
            prog["grad_norms"] = _norms(state["opt"]["m"],
                                        1.0 / (1.0 - opt.b1))
    prog["change_norms"] = {
        ".".join(p): float(torch.linalg.vector_norm(
            t - weights.leaf(p, tuple(t.shape), t.dtype, seed, device)))
        for p, t in weights.flatten(state["master"])}
    dev.sync(device)

    t0 = time.perf_counter()
    deadline, k, steps, bad, last = t0 + seconds, n_check, 0, 0, None
    while time.perf_counter() < deadline:
        with span("train_step"):
            state, m = step(state, feed(k))
        if last is not None:
            bad += not math.isfinite(float(last))
        last, k, steps = m["loss"], k + 1, steps + 1
    bad += not math.isfinite(float(last))
    dev.sync(device)
    t_end = time.perf_counter()
    B, S = tr["batch"], tr["seq_len"]
    rec = {"t0": t0, "window_s": t_end - t0, "train_steps": steps,
           "batch": B, "seq": S, "attempted": steps, "failed": bad,
           "e2e": {"train_tokens_per_s": steps * B * S / (t_end - t0)},
           "traced": None}
    if trace:
        port.reset_launches()
        with window(device) as traced:
            for _ in range(tr.get("trace_steps", 2)):
                with span("train_step"):
                    state, m = step(state, feed(k))
                k += 1
            float(m["loss"])
        rec.update(traced=traced, trace_launches=port.launches(),
                   trace_steps=tr.get("trace_steps", 2))
    rec["memory_peak_bytes"] = dev.peak(device)

    before, late = state, feed(k)["tokens"]
    state, m = step(before, {"tokens": late})
    prog_late = _step_readings(state, before, m["loss"], opt.b1)
    prog_late["grad_norm"] = float(m["grad_norm"])
    del state, m, step
    dev.free(device)
    ref = check.reference(cfg)

    def follow_late(prec="float32", rows=None):
        out = ref.train(cfg, _copy(before["master"]), [late[:rows]],
                        tr["optimizer"], prec, state=before["opt"])
        dev.free(device)
        return out

    truth_late = follow_late()
    readings = _late(check.train_gaps(prog_late, truth_late))
    if control:
        rec["control"] = _late(check.train_gaps(follow_late("fp8"),
                                                truth_late))
        rec["fault_half_batch"] = _late(check.train_gaps(
            follow_late(rows=B // 2), truth_late))
    late_worst = check.train_worst(prog_late, truth_late)
    del before
    dev.free(device)

    batches = [feed(i)["tokens"] for i in range(n_check)]

    def follow(prec="float32", rows=None):
        out = ref.train(cfg, weights.make(shapes, seed, device),
                        [b[:rows] for b in batches], tr["optimizer"], prec)
        dev.free(device)
        return out

    truth = follow()
    rec["readings"] = {**check.train_gaps(prog, truth), **readings}
    rec["checked"] = {"steps": n_check, "losses": prog["losses"],
                      "reference_losses": truth["losses"],
                      "late_step": k + 1,
                      "late_loss": [prog_late["losses"][0],
                                    truth_late["losses"][0]],
                      "late_grad_norm": [prog_late["grad_norm"],
                                         truth_late["grad_norm"][0]],
                      "worst": {k: w for k, (_, w) in
                                check.train_worst(prog, truth).items()},
                      "late_worst": {k: w for k, (_, w) in
                                     late_worst.items()},
                      "late_grad_leaves": check.grad_leaf_gaps(prog_late,
                                                               truth_late)}
    if control:
        rec["control"].update(check.train_gaps(follow("fp8"), truth))
        rec["fault_half_batch"].update(check.train_gaps(
            follow(rows=B // 2), truth))
    return rec
