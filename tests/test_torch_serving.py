"""The port's serving stack (``repro_torch.runtime.{server,fault}``,
``Session.server()``, ``connect(resilient=True)``) on the CPU, held to the
invariants of the reference's serving tests and, where the two can run the
same input, to the reference itself.

Racing cold requests train once and input order is kept; bounded admission
sheds with an ``Overloaded`` that names its policy; the AIMD bound grows,
halves and caps, and degrades before it sheds; ``stats`` is a view over the
metrics registry; ``StragglerDetector`` flags the reference's steps; an
engine outage fails over and recovery restores the incumbent plan; a warm
restart from ``QueryServer.persist()`` enumerates no plan; a traced warm
serve is one connected span tree with the fused segment in it.
"""
import os
import time
from collections import Counter

import numpy as np
import pytest
import torch

import repro_torch.core as T
import repro_torch.core.middleware as tmw
from repro.runtime.fault import StragglerDetector as RStragglerDetector
from repro_torch.core.health import CLOSED, OPEN
from repro_torch.core.middleware import _plan_from_key
from repro_torch.runtime import (EngineFaultInjector, Overloaded,
                                 QueryServer, Shed, SimulatedFailure,
                                 StatsView, StragglerDetector)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op torch thread: the suite runs beside timing-based tests
    of the reference, and idle OpenMP threads add noise to their timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _waves(n=16, t=64, seed=0):
    return np.random.default_rng(seed).normal(size=(n, t)).astype(np.float32)


def _bd(tmp_path=None, **kw):
    monitor = T.Monitor(str(tmp_path / "monitor.json")) if tmp_path else None
    bd = T.BigDAWG(monitor=monitor, train_plans=2, train_repeats=1,
                   device="cpu", **kw)
    bd.register("waves", T.DenseTensor(torch.from_numpy(_waves(24))),
                engine="dense_array")
    return bd


_SHAPES = [
    lambda: T.array.tfidf(T.array.haar(
        T.relational.select("waves", column="value", lo=0.0), levels=2)),
    lambda: T.array.count(T.relational.select("waves", column="value",
                                              lo=0.5)),
]


def test_racing_cold_requests_train_once(tmp_path):
    bd = _bd(tmp_path)
    srv = QueryServer(bd)
    reports = srv.submit_many([_SHAPES[0]() for _ in range(8)], workers=4)
    modes = Counter(r.mode for r in reports)
    assert modes["training"] == 1 and modes["production"] == 7
    assert srv.stats["trainings"] == 1 and srv.stats["requests"] == 8
    assert len(bd.plan_cache) == 1
    # tfidf of signed Haar coefficients differs between engines, so only
    # serves of one plan are held equal
    first = reports[0]
    for r in reports[1:]:
        if r.plan_key == first.plan_key:
            np.testing.assert_allclose(r.result.data.numpy(),
                                       first.result.data.numpy(),
                                       rtol=1e-5, atol=1e-5)


def test_submit_many_preserves_input_order(tmp_path):
    srv = QueryServer(_bd(tmp_path))
    qs = [_SHAPES[i % 2]() for i in range(6)]
    want = [len(q.nodes()) for q in qs]
    reports = srv.submit_many(qs, workers=3)
    assert [len(_plan_from_key(r.plan_key).assignment)
            for r in reports] == want


def test_session_server_sheds_beyond_max_pending():
    s = T.connect(device="cpu", train_plans=2, train_repeats=1)
    s.register("waves", T.DenseTensor(torch.from_numpy(_waves())),
               engine="dense_array")
    q = _SHAPES[0]()
    s.execute(q)                                   # warm the signature
    srv = s.server(max_pending=1)
    assert isinstance(srv, QueryServer) and srv.bd is s.bigdawg
    srv._pending = 1                               # one request in flight
    out = srv.submit_many([q, q], workers=1)
    assert all(isinstance(r, Overloaded) for r in out)
    assert out[0].reason == "max_pending" and out[0].status == "shed"
    assert srv.stats["shed"] == 2
    srv._pending = 0
    res = srv.serve([q] * 4, workers=2)
    assert res["shed"] + sum(1 for r in res["reports"]
                             if not isinstance(r, Overloaded)) == 4
    assert srv.stats["shed"] == 2 + res["shed"]
    assert Shed is Overloaded
    with pytest.raises(ValueError):
        s.server(max_pending=0)


class _FakeReport:
    def __init__(self, mode="production"):
        self.mode = mode
        self.cache_hit = mode == "production"
        self.replanned = False
        self.explored = False
        self.degraded = False
        self.failovers = 0
        self.status = "ok"


class _FakeBD:
    """Stand-in middleware: instant (or slow) serves, records degrade
    flags."""

    def __init__(self, mode="production", delay=0.0, health=None):
        self.mode = mode
        self.delay = delay
        self.health = health
        self.degrade_calls = []

    def execute(self, query, mode="auto", degrade=False):
        self.degrade_calls.append(degrade)
        if self.delay:
            time.sleep(self.delay)
        return _FakeReport(self.mode)


def test_aimd_bound_grows_halves_and_caps():
    srv = QueryServer(_FakeBD(), latency_target_s=10.0)
    b0 = srv._bound
    for _ in range(5):
        srv.submit("q")
    assert srv._bound == b0 + 5 and srv.stats["latency_ewma"] > 0.0
    slow = QueryServer(_FakeBD(delay=0.002), latency_target_s=1e-6)
    for _ in range(12):
        slow.submit("q")
    assert slow._bound == 1.0
    capped = QueryServer(_FakeBD(), max_pending=9, latency_target_s=10.0)
    for _ in range(5):
        capped.submit("q")
    assert capped._bound == 9.0
    train = QueryServer(_FakeBD(mode="training"), latency_target_s=10.0)
    b0 = train._bound
    train.submit("q")
    assert train.stats["latency_ewma"] == 0.0 and train._bound == b0


def test_degrade_before_shed():
    bd = _FakeBD(health=object())
    srv = QueryServer(bd, latency_target_s=10.0)
    bound = int(srv._bound)
    srv._pending = bound
    assert srv._try_admit() == "degrade"
    srv._pending = 2 * bound
    assert srv._try_admit() is None and srv.stats["shed"] == 1
    srv._pending = bound
    out = srv.submit_many(["q"], workers=1)
    assert not isinstance(out[0], Overloaded) and bd.degrade_calls == [True]
    assert srv._pending == bound
    srv._pending = 2 * int(srv._bound)          # the serve grew the bound
    out = srv.submit_many(["q"], workers=1)
    assert isinstance(out[0], Shed) and out[0].reason == "latency_target"
    no_health = QueryServer(_FakeBD(health=None), latency_target_s=10.0)
    no_health._pending = int(no_health._bound)
    assert no_health._try_admit() is None


def test_stats_is_a_view_over_the_metrics_registry():
    bd = _bd()
    srv = QueryServer(bd)
    assert srv.metrics is bd.metrics and isinstance(srv.stats, StatsView)
    q = _SHAPES[1]()
    srv.submit(q)
    srv.submit(q)
    assert srv.stats["requests"] == 2 and srv.stats["trainings"] == 1
    assert srv.stats["cache_hits"] >= 1
    assert isinstance(srv.stats["seconds"], float)
    d = dict(srv.stats)
    assert d["requests"] == 2 and "breaker_trips" in d
    assert srv.stats() == d and len(srv.stats) == len(d)
    with pytest.raises(KeyError):
        srv.stats["nope"]
    assert srv.metrics.histogram("server.latency").count == 2


def test_straggler_detector_flags_the_references_steps():
    rng = np.random.default_rng(3)
    times = 0.010 + 0.001 * rng.random(64)
    times[[9, 20, 21, 40, 63]] = [0.2, 0.05, 0.3, 0.014, 1.0]
    mine, ref = StragglerDetector(warmup=4), RStragglerDetector(warmup=4)
    got = [mine.observe(i, float(t)) for i, t in enumerate(times)]
    want = [ref.observe(i, float(t)) for i, t in enumerate(times)]
    assert got == want and mine.flagged == ref.flagged
    assert {9, 20, 21, 63} <= set(mine.flagged)
    assert (mine.n, mine.mean, mine.m2) == pytest.approx(
        (ref.n, ref.mean, ref.m2))


def _portable_query():
    """Every node has at least two capable engines."""
    return T.array.tfidf(T.array.haar("waves", levels=2))


def test_failover_and_recovery_restore_incumbent():
    t = [0.0]
    inj = EngineFaultInjector()
    health = T.EngineHealth(failure_threshold=2, cooldown_s=5.0,
                            time_fn=lambda: t[0], injector=inj)
    # one trained plan, so the monitor knows no rival that wall-clock
    # noise could rank above the incumbent (the reference's version of this
    # test flakes on that under load), and no online re-plan
    s = T.connect(device="cpu", health=health, train_plans=1,
                  train_repeats=1)
    s.bigdawg.replan_factor = float("inf")
    s.register("waves", T.DenseTensor(torch.from_numpy(_waves())),
               engine="dense_array")
    q = _portable_query()
    s.execute(q, mode="training")
    r_ok = s.execute(q)
    assert r_ok.status == "ok" and not r_ok.degraded
    incumbent = r_ok.plan_key
    down = {eng for _, eng in _plan_from_key(incumbent).assignment}
    for eng in down:
        inj.fail_engine(eng)
    r_deg = s.execute(q)
    assert r_deg.status == "degraded" and r_deg.failovers >= 1
    assert not {e for _, e in _plan_from_key(r_deg.plan_key).assignment} \
        & down
    assert all(health.state(eng) == OPEN for eng in down)
    np.testing.assert_allclose(r_deg.value.data.numpy(),
                               r_ok.value.data.numpy(), rtol=1e-4,
                               atol=1e-4)
    r_deg2 = s.execute(q)
    assert r_deg2.status == "degraded" and r_deg2.failovers == 0
    for eng in down:
        inj.recover(eng)
    t[0] += 5.0
    r_rec = s.execute(q)
    assert r_rec.status == "ok" and r_rec.plan_key == incumbent
    assert all(health.state(eng) == CLOSED for eng in down)
    assert inj.faults_fired > 0
    with pytest.raises(SimulatedFailure):
        inj.fail_engine("stream")
        inj.before_op("stream", "haar")


def test_resilient_session_serves():
    """``connect(resilient=True)`` attaches a health registry whose
    straggler watch now runs: the session trains and serves."""
    s = T.connect(device="cpu", resilient=True, train_plans=2,
                  train_repeats=1)
    s.register("waves", T.DenseTensor(torch.from_numpy(_waves())),
               engine="dense_array")
    q = _portable_query()
    res = [s.execute(q) for _ in range(4)]
    assert [r.mode for r in res] == ["training"] + ["production"] * 3
    assert all(r.status == "ok" for r in res)
    assert s.bigdawg.health._stragglers     # detectors were built


def test_persisted_server_restarts_warm(tmp_path, monkeypatch):
    state = str(tmp_path / "monitor.json")

    def session():
        s = T.connect(state, device="cpu", train_plans=2, train_repeats=1)
        s.register("waves", T.DenseTensor(torch.from_numpy(_waves())),
                   engine="dense_array")
        return s

    srv = session().server()
    first = srv.submit(_SHAPES[1]())
    assert first.mode == "training"
    srv.persist()
    for name in ("monitor.json", "monitor.calib.json", "monitor.plans.json"):
        assert os.path.exists(tmp_path / name)

    def no_enumeration(*a, **k):
        raise AssertionError("warm production must not enumerate plans")

    monkeypatch.setattr(tmw, "dp_plans", no_enumeration)
    s2 = session()
    s2.bigdawg.replan_factor = float("inf")
    s2.bigdawg.monitor.DRIFT_THRESHOLD = float("inf")
    reports = s2.server().submit_many([_SHAPES[1]()] * 4, workers=2)
    assert [r.mode for r in reports] == ["production"] * 4
    assert [int(r.result.data) for r in reports] == \
        [int(first.result.data)] * 4


def test_traced_warm_serve_holds_the_fused_segment():
    """Tracing turned on after training: a warm serve's trace is one
    connected span tree with a fused_segment span whose engine_op children
    are the segment's members (dense_array-only ops, so every plan is the
    all-dense one and the whole chain fuses)."""
    s = T.connect(device="cpu", train_plans=2, train_repeats=1)
    s.register("X", T.DenseTensor(torch.from_numpy(_waves(8, 16))),
               engine="dense_array")
    s.register("B", T.DenseTensor(torch.from_numpy(_waves(8, 16, seed=1))),
               engine="dense_array")
    a = T.array
    q = a.scale(a.add(a.transpose(a.transpose("X")), "B"), factor=2.0)
    s.execute(q, mode="training")
    s.bigdawg.tracer.enabled = True
    res = s.execute(q)
    assert res.mode == "production" and res.trace is not None
    assert res.fused_segments == ((0, 1, 2, 3),)
    spans = res.trace.spans
    sids = {sp["sid"] for sp in spans}
    assert sum(1 for sp in spans if sp["parent"] is None) == 1
    assert all(sp["parent"] in sids for sp in spans
               if sp["parent"] is not None)
    (seg,) = res.trace.find("fused_segment")
    kids = [sp for sp in spans if sp["parent"] == seg["sid"]]
    assert all(k["name"] == "engine_op" for k in kids)
    assert [k["attrs"]["op"] for k in kids] == ["transpose", "transpose",
                                                "add", "scale"]


def test_unported_process_pool_still_raises(monkeypatch):
    """The process pool is ported now: ``processes=2`` lifts a CPU
    middleware into a 2-worker pool behind the same admission logic, and
    ``connect(processes=2)`` opens a pool-backed session; both give the
    in-process result."""
    # one OpenMP thread in the spawned workers: the suite runs beside
    # timing-based tests of the reference
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    bd = _bd()
    q = T.array.count(T.relational.select("waves", column="value", lo=0.5))
    want = int(bd.execute(q, mode="training").result.data)
    srv = QueryServer(bd, processes=2)
    try:
        assert isinstance(srv.bd, T.ProcPool) and srv.bd.n == 2
        reports = srv.submit_many([q, q], workers=2)
        assert [int(r.result.data) for r in reports] == [want, want]
        assert srv.stats["requests"] == 2
    finally:
        srv.close()
    with T.connect(device="cpu", processes=2, train_plans=1) as s:
        s.register("waves", T.DenseTensor(torch.from_numpy(_waves(24))),
                   engine="dense_array")
        assert int(s.execute(q).value.data) == want
