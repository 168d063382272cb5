"""The port's main path end to end through ``connect()`` on the CPU, held
against the reference package on the same data.

Plan choice depends on timing, so results are compared for the plan the
port chose: the reference runs ``execute_plan`` with that plan key on the
same catalog, and the neighbour indices (analytic) must be identical, the
quickstart product equal within 1e-4.  Warm restarts — from the port's own
state files and from a state directory the reference wrote — must serve
production with zero plan enumerations."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as R
import repro_torch.core as T
import repro_torch.core.middleware as tmw
from repro.core.engines import _da_bin_hist as r_bin_hist
from repro.core.middleware import _plan_from_key as r_plan_from_key
from repro.kernels.ref import haar_ref as r_haar
from repro_torch.data import ecg_waveforms

REPO = Path(__file__).resolve().parents[1]

LEVELS, NBINS, K = 3, 8, 5
ANALYTIC = (f"ARRAY(knn(tfidf(bin_hist(haar(waves, levels={LEVELS}), "
            f"nbins={NBINS}, levels={LEVELS})), test_hist, k={K}))")
QUICKSTART = ("ARRAY(matmul(RELATIONAL(select(A, column=value, lo=-0.5, "
              "hi=2.0)), B))")


def _no_enumeration(*a, **k):
    raise AssertionError("warm production must not enumerate plans")


def _pin_serving(bd):
    """Isolate a serving check from the two adaptive loops whose triggers
    are environmental here, as the reference's serving tests and
    benchmarks do: online re-planning (millisecond timing noise) and
    usage-drift retraining (peak RSS only grows within a test process)."""
    bd.replan_factor = float("inf")
    bd.monitor.DRIFT_THRESHOLD = float("inf")


def test_analytic_matches_reference_for_the_chosen_plan():
    waves, labels = ecg_waveforms(48 + 8, 256, seed=0)
    train_w, test_w = waves[:48], waves[48:]
    test_hists = np.array(r_bin_hist(
        {"nbins": NBINS, "levels": LEVELS},
        R.DenseTensor(r_haar(jnp.asarray(test_w), LEVELS))).data)
    s = T.connect(device="cpu", train_plans=8)
    _pin_serving(s.bigdawg)
    s.register("waves", T.DenseTensor(torch.from_numpy(train_w)),
               engine="dense_array")
    rb = R.BigDAWG(fuse=False)
    rb.register("waves", R.DenseTensor(jnp.asarray(train_w)), "dense_array")
    modes = []
    for i in range(len(test_w)):
        s.register("test_hist", T.DenseTensor(
            torch.from_numpy(test_hists[i:i + 1])), engine="dense_array")
        rb.register("test_hist", R.DenseTensor(test_hists[i:i + 1]),
                    "dense_array")
        res = s.execute(ANALYTIC)
        modes.append(res.mode)
        got = res.value.data
        assert got.dtype == torch.int32 and tuple(got.shape) == (1, K)
        ref = R.execute_plan(R.bigdawg(ANALYTIC),
                             r_plan_from_key(res.plan_key), rb.catalog)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref.value.data))
    assert modes[0] == "training" and set(modes[1:]) == {"production"}


def _quickstart_session(state, device="cpu", pkg=T):
    rng = np.random.default_rng(0)
    A = rng.normal(size=(32, 32)).astype(np.float32)
    B = rng.normal(size=(32, 8)).astype(np.float32)
    if pkg is T:
        s = T.connect(os.path.join(state, "monitor.json"), device=device,
                      train_plans=4)
        s.register("A", T.DenseTensor(torch.from_numpy(A)), engine="columnar")
        s.register("B", T.DenseTensor(torch.from_numpy(B)),
                   engine="dense_array")
    else:
        s = R.connect(os.path.join(state, "monitor.json"), fuse=False,
                      train_plans=4)
        s.register("A", R.DenseTensor(jnp.asarray(A)), engine="columnar")
        s.register("B", R.DenseTensor(jnp.asarray(B)), engine="dense_array")
    return s


def test_quickstart_matches_reference_and_restarts_warm(tmp_path,
                                                        monkeypatch):
    state = str(tmp_path)
    s = _quickstart_session(state)
    res = s.execute(QUICKSTART, mode="training")
    assert res.mode == "training" and res.report.plans_tried >= 2
    assert tuple(res.value.data.shape) == (32, 8)
    rs = _quickstart_session(str(tmp_path / "ref"), pkg=R)
    ref = R.execute_plan(R.bigdawg(QUICKSTART),
                         r_plan_from_key(res.plan_key), rs.catalog)
    np.testing.assert_allclose(res.value.data.numpy(),
                               np.asarray(ref.value.data), rtol=1e-4,
                               atol=1e-4)
    s.persist()
    for name in ("monitor.json", "monitor.calib.json", "monitor.plans.json"):
        assert (tmp_path / name).exists()
    monkeypatch.setattr(tmw, "dp_plans", _no_enumeration)
    s2 = _quickstart_session(state)
    _pin_serving(s2.bigdawg)
    for _ in range(4):
        res2 = s2.execute(QUICKSTART)
        assert res2.mode == "production"
    assert res2.plan_key == res.plan_key
    np.testing.assert_allclose(res2.value.data.numpy(),
                               res.value.data.numpy(), rtol=1e-5, atol=1e-5)


def test_port_serves_a_reference_state_directory_warm(tmp_path, monkeypatch):
    state = str(tmp_path)
    rs = _quickstart_session(state, pkg=R)
    rres = rs.execute(QUICKSTART, mode="training")
    rs.persist()
    monkeypatch.setattr(tmw, "dp_plans", _no_enumeration)
    s = _quickstart_session(state)
    _pin_serving(s.bigdawg)
    assert s.bigdawg.cost_model.calibrated == rs.bigdawg.cost_model.calibrated
    # the port counts the CPU as one device, as the reference does on a
    # plain CPU host (a test process may have forced more host devices
    # into JAX, so the recorded value is not compared here)
    assert T.usage_snapshot("cpu")["devices"] == 1.0
    assert rres.plan_key in s.bigdawg.monitor.known_plans(rres.sig)
    for _ in range(3):
        res = s.execute(QUICKSTART)
        assert res.mode == "production"
        assert res.sig == rres.sig
        assert res.plan_key == rres.plan_key
    np.testing.assert_allclose(res.value.data.numpy(),
                               np.asarray(rres.value.data), rtol=1e-4,
                               atol=1e-4)


def test_unported_hooks_raise_not_implemented():
    with pytest.raises(NotImplementedError, match="fusion"):
        T.connect(device="cpu", fuse=True)
    with pytest.raises(NotImplementedError, match="procpool"):
        T.connect(device="cpu", processes=2)
    s = T.connect(device="cpu")
    with pytest.raises(NotImplementedError, match="server"):
        s.server()
    s.bigdawg.fuse = True              # flipped at runtime: the next
    with pytest.raises(NotImplementedError, match="fusion"):   # serve says so
        s.bigdawg._fused_for(None, None, None)
    health = T.EngineHealth()
    with pytest.raises(NotImplementedError, match="fault"):
        health.after_plan([("dense_array", 0.1)])


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_port_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "import importlib, pkgutil, repro_torch; "
            "[importlib.import_module(m.name) for m in pkgutil.walk_packages("
            "repro_torch.__path__, 'repro_torch.')]; "
            "assert 'repro.core' not in sys.modules; print('ok')")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
