"""The port's launch tooling and tensor plans (``repro_torch.launch.dryrun``,
``sweep``, ``hillclimb``, ``repro_torch.core.tensorplan``, the ``api``
helpers ``example_batch`` / ``example_cache`` / ``make_serve_step``)
against the reference, on the CPU.

What carries over from ``tests/test_dryrun_infra.py``: the probe depths,
the 40-cell grid and the default plans.  The HLO parse has no counterpart
(the port tallies its collectives where it issues them); the default plans
differ from the reference's only in the accumulation depth and the
moments' dtype, which are the card's (``tensorplan._TRAIN_ACCUM``,
``_MOMENT_DTYPE``).

``run_cell(device="cpu")`` opens its own fake process group of 4 ranks (a
(2, 2) mesh) in this process and closes it before it returns; the fake
group's collectives move nothing, so the tests hold shapes, records and
counts, no value.  Every count here is exact (tolerance 0) but the
extrapolated float sums, held at a relative 1e-12.
"""
import dataclasses
import json
import math
import os
import subprocess

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCHS, SHAPES, PlanConfig, get_arch, shape_applicable
from repro.core import tensorplan as jtp
from repro.core.monitor import Monitor as JMonitor
from repro.launch import dryrun as jdry
from repro.launch import hillclimb as jhill
from repro.launch import sweep as jsweep
from repro.models import api as japi
from repro.models import partition as jpart
from repro.optim import AdamW as JAdamW
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import SHAPES as TSHAPES
from repro_torch.configs import PlanConfig as TPlan
from repro_torch.configs import ShapeConfig as TShape
from repro_torch.configs import get_arch as tget
from repro_torch.configs import shape_applicable as tapplicable
from repro_torch.core import tensorplan as ttp
from repro_torch.core.monitor import Monitor as TMonitor
from repro_torch.kernels import ops, work
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import hillclimb as thill
from repro_torch.launch import sweep as tsweep
from repro_torch.models import api as tapi
from repro_torch.models import partition as tpart
from repro_torch.tree import tree_leaves, tree_map_with_path

CELLS = [(a, s.name) for a in ARCHS for s in SHAPES]
TRAIN_4K = next(s for s in SHAPES if s.name == "train_4k")
CPU = torch.device("cpu")
# small cells of each mode for run_cell on the CPU: the names keep the
# production shapes' (the monitor signature), the sizes are the tests'
SMALL = {"train": TShape("train_4k", "train", 32, 8),
         "prefill": TShape("prefill_32k", "prefill", 32, 4),
         "decode": TShape("decode_32k", "decode", 32, 4)}
FAMILIES = {"dense": "codeqwen1.5-7b", "moe": "deepseek-v2-lite-16b",
            "ssm": "mamba2-370m", "hybrid": "zamba2-7b",
            "vlm": "internvl2-26b", "encdec": "seamless-m4t-medium"}
# the reference record's keys of a single-pod cell with costs
REF_KEYS = {"arch", "shape", "mesh", "plan", "applicable", "skip_reason",
            "params", "active_params", "memory", "hbm_bytes_per_device",
            "fits_16g", "probes", "cost", "roofline"}
REF_MEMORY = {"arg_bytes", "out_bytes", "temp_bytes", "alias_bytes",
              "flops", "bytes", "coll_bytes", "coll_breakdown", "hlo_chars",
              "compile_s"}
REF_ROOFLINE = {"t_compute", "t_memory", "t_collective", "dominant",
                "model_flops_per_device", "useful_flops_ratio",
                "roofline_fraction"}
REF_PROBES = {"train": {"g1", "g2", "opt"}, "serve": {"s1", "s2"}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite's workers run
    timing-based tests of the reference beside it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(name):
    """A family's smoke config; an encdec's with as many encoder layers as
    decoder layers, as the full config has (the probes scale both)."""
    cfg = tget(name).smoke()
    if cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, encoder_layers=cfg.num_layers)
    return cfg


def _small_plan(cfg, shape):
    return ttp.default_plan(cfg, shape).with_(attn_chunk=8, loss_chunk=8)


# -- probes, grid, plans ------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ARCHS))
def test_probe_cfgs_and_scan_depth_equal_the_reference(name):
    jcfg, tcfg = get_arch(name), tget(name)
    assert tdry.scan_depth(tcfg) == jdry.scan_depth(jcfg) >= 2
    for d in (1, 2):
        j, t = jdry._probe_cfg(jcfg, d), tdry._probe_cfg(tcfg, d)
        assert (t.num_layers, t.encoder_layers) == \
            (j.num_layers, j.encoder_layers)
        assert dataclasses.asdict(t) == dataclasses.asdict(
            dataclasses.replace(tcfg, num_layers=j.num_layers,
                                encoder_layers=j.encoder_layers))


def test_cell_grid_is_40_with_8_skips_as_the_reference():
    cells = [(a.name, s.name, tapplicable(a, s)) for a in TARCHS.values()
             for s in TSHAPES]
    assert len(cells) == 40
    assert sum(not ok for _, _, (ok, _) in cells) == 8
    assert [(a, s, ok) for a, s, (ok, _) in cells] == \
        [(a.name, s.name, shape_applicable(a, s)[0])
         for a in ARCHS.values() for s in SHAPES]
    assert tsweep.ORDER == jsweep.ORDER


def _fields(plan, drop=("accum", "moment_dtype")):
    return {k: v for k, v in dataclasses.asdict(plan).items()
            if k not in drop}


def _card_accum(name, shape):
    return ttp._TRAIN_ACCUM.get(name, 1) if shape.mode == "train" else 1


@pytest.mark.parametrize("name,shape_name", CELLS)
def test_default_plan_and_variants_equal_the_reference(name, shape_name):
    """Every field but the accumulation and the moments' dtype, which are
    the port's own table's (the card's)."""
    shape = next(s for s in SHAPES if s.name == shape_name)
    tshape = next(s for s in TSHAPES if s.name == shape_name)
    jcfg, tcfg = get_arch(name), tget(name)
    jp, tp = jtp.default_plan(jcfg, shape), ttp.default_plan(tcfg, tshape)
    assert _fields(tp) == _fields(jp)
    assert tp.accum == _card_accum(name, shape)
    assert tp.moment_dtype == ttp._MOMENT_DTYPE.get(name, "float32")
    jv = {v.name: v for v in jtp.enumerate_variants(jcfg, shape)}
    tv = {v.name: v for v in ttp.enumerate_variants(tcfg, tshape)}
    accum = lambda names: {n for n in names if n.startswith("accum")}
    assert set(tv) - accum(tv) == set(jv) - accum(jv)
    assert accum(tv) == {f"accum{a}" for a in (1, 2, 4, 8, 16)
                         if shape.mode == "train" and a != tp.accum
                         and shape.global_batch % a == 0}
    listed = ttp.enumerate_variants(tcfg, tshape)
    assert len(tv) == len(listed) and listed[0] == tp
    for vname, v in tv.items():
        assert v.moment_dtype == tp.moment_dtype
        if vname.startswith("accum"):
            assert v.accum == int(vname[5:])
            assert _fields(v) == _fields(tp.with_(name=vname))
        else:
            assert v.accum == tp.accum
            assert _fields(v) == _fields(jv[vname])


def test_cell_signature_and_selector_pick_as_the_reference(tmp_path):
    """The same roofline terms recorded in both monitors give the same
    signature and the same production pick."""
    terms = {"baseline": (0.3, 0.5, 0.1), "accum2": (0.3, 0.4, 0.2),
             "no_sp": (0.6, 0.2, 0.1), "no_tp": (0.2, 0.45, 0.3)}
    picks = []
    for mod, mon, cfg, shape, plan in (
            (jtp, JMonitor(str(tmp_path / "j.json")), get_arch("qwen2-72b"),
             TRAIN_4K, PlanConfig()),
            (ttp, TMonitor(str(tmp_path / "t.json")), tget("qwen2-72b"),
             TSHAPES[0], TPlan())):
        sel = mod.TensorPlanSelector(mon)
        for name, (c, m, k) in terms.items():
            sel.record(cfg, shape, "pod_16x16", plan.with_(name=name),
                       {"t_compute": c, "t_memory": m, "t_collective": k})
        key, stats = sel.best(cfg, shape, "pod_16x16")
        picks.append((mod.cell_signature(cfg, shape, "pod_16x16"), key,
                      stats.mean_seconds))
    # the pick is the lowest dominant term: accum2's 0.4
    assert picks[0] == picks[1] == ("cell:qwen2-72b|train_4k|pod_16x16",
                                    "accum2", 0.4)


# -- api helpers ---------------------------------------------------------------

def _jax_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): (tuple(v.shape), str(v.dtype))
            for path, v in flat}


def _port_leaves(tree) -> dict:
    out = {}

    def one(path, t):
        assert t.device.type == "meta"
        out["/".join(str(k) for k in path)] = (
            tuple(t.shape), str(t.dtype).replace("torch.", ""))
    tree_map_with_path(one, tree)
    return out


@pytest.mark.parametrize("name,shape_name", CELLS)
def test_example_batch_and_cache_equal_the_reference(name, shape_name):
    """Shapes and dtypes, leaf by leaf, of ``eval_shape``'s structs and the
    port's ``meta`` tensors; the cache at the cell's capacity."""
    shape = next(s for s in SHAPES if s.name == shape_name)
    tshape = next(s for s in TSHAPES if s.name == shape_name)
    jcfg, tcfg = get_arch(name), tget(name)
    jplan, tplan = jtp.default_plan(jcfg, shape), \
        ttp.default_plan(tcfg, tshape)
    assert _port_leaves(tapi.example_batch(tcfg, tshape, tplan)) == \
        _jax_leaves(japi.example_batch(jcfg, shape, jplan))
    if shape.mode == "decode":
        assert _port_leaves(tapi.example_cache(tcfg, tshape, tplan)) == \
            _jax_leaves(japi.example_cache(jcfg, shape, jplan))


def test_make_serve_step_is_the_decode_step():
    cfg, shape = tget("mamba2-370m").smoke(), SMALL["decode"]
    plan = TPlan(param_dtype="float32", compute_dtype="float32")
    params = tapi.init_params(cfg, torch.Generator().manual_seed(0), plan,
                              "cpu")
    tok = torch.tensor([3, 5], dtype=torch.int32)
    pos = torch.zeros((2,), dtype=torch.int32)
    outs = []
    for make in (tapi.make_serve_step, tapi.make_decode_step):
        cache = tapi.init_cache(cfg, 2, 8, torch.float32, "cpu")
        nxt, cache = make(cfg, shape, plan)(params, cache, tok, pos)
        outs.append((nxt, [t.clone() for t in tree_leaves(cache)]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


# -- the rank's state ------------------------------------------------------------

class _StubMesh:
    """What the reference's ``PlanEnv`` reads of a mesh."""

    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


def _ref_local_bytes(tree, specs, sizes) -> int:
    """A rank's bytes of a reference tree under its specs: each dimension
    divided by the sizes of the axes its entry names."""
    total = 0
    flat = jax.tree_util.tree_leaves(tree)
    flat_specs = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    for leaf, spec in zip(flat, flat_specs):
        shape = list(leaf.shape)
        for i, entry in enumerate(spec):
            for axis in (entry if isinstance(entry, tuple) else (entry,)):
                if axis is not None:
                    assert shape[i] % sizes[axis] == 0
                    shape[i] //= sizes[axis]
        total += math.prod(shape) * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_state_bytes_at_train_4k_on_the_production_mesh(name):
    """One rank's train state and batch rows at train_4k on (16, 16), from
    ``meta`` shapes and the specs (no allocation), equal the reference's
    shapes divided by its specs under the same plan."""
    names, sizes = ("data", "model"), (16, 16)
    tcfg, jcfg = tget(name), get_arch(name)
    tplan = ttp.default_plan(tcfg, TSHAPES[0])
    jplan = PlanConfig(**dataclasses.asdict(tplan))
    mesh = tpart.AbstractMesh(names, sizes)
    total, parts = tdry.state_bytes(tcfg, TSHAPES[0], tplan, mesh)
    state = jax.eval_shape(lambda: japi.init_train_state(
        jcfg, jplan, jax.random.PRNGKey(0),
        JAdamW(moment_dtype=jplan.moment_dtype)))
    batch = japi.example_batch(jcfg, TRAIN_4K, jplan)
    prev = getattr(jpart._ENV, "env", None)
    jpart._ENV.env = jpart.PlanEnv(_StubMesh(names, sizes), jplan)
    try:
        want = {"state": _ref_local_bytes(
                    state, japi.train_state_specs(jcfg, jplan, state),
                    dict(zip(names, sizes))),
                "batch": _ref_local_bytes(
                    batch, japi.batch_specs(jcfg, jplan, batch),
                    dict(zip(names, sizes)))}
    finally:
        jpart._ENV.env = prev
    assert parts == want
    assert total == sum(want.values())


def test_placed_local_shapes_equal_distribute():
    """``dryrun.place`` from ``meta`` shapes gives each leaf the local
    shape and placements that ``api.distribute`` gives the whole tree."""
    cfg = tget("zamba2-7b").smoke()
    plan = TPlan(param_dtype="float32")
    with tdry._rank_zero(4):
        mesh = tdry._mesh(False, (2, 2), "cpu")
        with tpart.plan_scope(mesh, plan):
            whole = tapi.init_params(cfg, torch.Generator().manual_seed(0),
                                     plan, "cpu")
            sh = tapi.to_shardings(mesh, tapi.param_specs(cfg, plan, whole))
            dist = tapi.distribute(whole, sh)
            meta = tapi.init_params(cfg, None, plan, "meta")
            placed = tdry.place(meta, sh, CPU)
        got = [(tuple(t.shape), tuple(t.to_local().shape), t.placements)
               for t in tree_leaves(placed)]
        want = [(tuple(t.shape), tuple(t.to_local().shape), t.placements)
                for t in tree_leaves(dist)]
        assert got == want
        assert tdry.local_bytes(meta, sh) == sum(
            t.to_local().numel() * t.to_local().element_size()
            for t in tree_leaves(dist))


# -- run_cell on the CPU -----------------------------------------------------------

def _keys(rec) -> set:
    out = set(rec)
    out |= {f"memory.{k}" for k in rec.get("memory", {})}
    out |= {f"probes.{k}" for k in rec.get("probes", {})}
    return out


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_run_cell_on_the_cpu(family, mode):
    """A smoke config of each family on a (2, 2) fake mesh: the record has
    the reference's keys but those only XLA has, finite costs and
    roofline, the state's bytes of ``state_bytes``, no peaks on the CPU,
    and a collective tally that agrees with the split's counts."""
    cfg, shape = _small(FAMILIES[family]), SMALL[mode]
    plan = _small_plan(cfg, shape)
    rec = tdry.run_cell(cfg, shape, multi_pod=False, plan=plan,
                        device="cpu", mesh_shape=(2, 2))
    probes = REF_PROBES["train" if mode == "train" else "serve"]
    want = REF_KEYS | {f"memory.{k}" for k in REF_MEMORY} | \
        {f"probes.{k}" for k in probes}
    missing = {k for k in want - _keys(rec)
               if k not in tdry.NO_COUNTERPART}
    assert not missing
    assert set(REF_ROOFLINE) <= set(rec["roofline"])
    assert rec["mesh"] == "mesh_2x2" and rec["applicable"]
    assert rec["device"] == {"type": "cpu"}
    assert rec["fits"] is None and rec["hbm_bytes_per_device"] is None
    assert rec["memory"]["peak_allocated_bytes"] is None
    total, parts = tdry.state_bytes(
        cfg, shape, TPlan(**rec["plan"]),
        tpart.AbstractMesh(("data", "model"), (2, 2)))
    assert rec["state_bytes"] == total and rec["memory"]["state_parts"] \
        == parts
    # the placed shards hold all but the batch, a zero-strided view
    assert rec["memory"]["placed_bytes"] == total - parts["batch"]
    assert rec["memory"]["oom"] is None
    assert all(math.isfinite(v) and v > 0 for v in rec["cost"].values())
    rf = rec["roofline"]
    assert all(math.isfinite(rf[k]) for k in REF_ROOFLINE if k != "dominant")
    assert rf["dominant"] in ("compute", "memory", "collective")
    assert rec["step"]["launches"] == {}          # no card: plain versions
    coll = rec["memory"]["coll_breakdown"]
    tp = rec["step"]["tp_collectives"]
    assert coll.get("reduce-scatter", {}).get("count", 0) >= tp["seq_exit"]
    assert coll.get("all-reduce", {}).get("count", 0) >= \
        tp["g"] + tp["sum"] + tp["max"]
    assert rec["memory"]["coll_bytes"] == sum(v["bytes"]
                                              for v in coll.values())
    json.dumps(rec)                                # a JSON record


@pytest.mark.parametrize("mode", ["train", "prefill"])
@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid", "moe",
                                    "encdec"])
def test_probe_extrapolation_equals_a_full_depth_count(family, mode):
    """The counts of the depth-1 and depth-2 probes, extrapolated to the
    smoke config's depth, equal a count of the full-depth step: the counts
    are linear in depth (a train cell at accumulation 1, where the full
    step is one gradient and one update)."""
    cfg, shape = _small(FAMILIES[family]), SMALL[mode]
    plan = _small_plan(cfg, shape)
    rec = {}
    with tdry._rank_zero(4):
        mesh = tdry._mesh(False, (2, 2), "cpu")
        cost = tdry._costs(cfg, shape, plan, mesh, CPU, rec)
        full, _ = tdry._probe(cfg, shape, plan, mesh, CPU)
    for k in tdry.COST_KEYS:
        assert cost[k] == pytest.approx(full[k], rel=1e-12, abs=0), k


def test_run_cell_accum_is_clamped_to_the_data_parallel_rows():
    """As the reference: microbatches must still split over the data
    axes, so a train cell's accumulation is at most its rows a rank."""
    cfg = _small("internlm2-1.8b")
    rec = tdry.run_cell(cfg, SMALL["train"], multi_pod=False,
                        plan=_small_plan(cfg, SMALL["train"]).with_(accum=16),
                        device="cpu", mesh_shape=(2, 2), skip_cost=True)
    assert rec["plan"]["accum"] == SMALL["train"].global_batch // 2
    assert "cost" not in rec and rec["memory"]["step_s"] > 0


def test_skipped_cell_and_no_card():
    """A cell that does not apply returns before any device is asked for;
    one that does raises without a card unless the CPU is asked for."""
    rec = tdry.run_cell("internlm2-1.8b", "long_500k", multi_pod=False,
                        plan=TPlan())
    assert rec["applicable"] is False and "memory" not in rec
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdry.run_cell(_small("internlm2-1.8b"), SMALL["decode"],
                          multi_pod=False, plan=TPlan(), mesh_shape=(2, 2))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdry.main(["--arch", "mamba2-370m", "--shape", "decode_32k",
                       "--skip-cost"])
    assert not torch.distributed.is_initialized()


def test_parse_overrides_as_the_reference():
    pairs = ["accum=4", "sp_boundary=false", "tp=True", "remat=none"]
    assert tdry._parse_overrides(pairs) == jdry._parse_overrides(pairs)


# -- kernel work ----------------------------------------------------------------------

@pytest.mark.parametrize("gqa", [False, True])
def test_credited_flash_flops_equal_flop_counter(gqa):
    """A non-causal plain call under ``work.count``: the credited flops
    equal ``FlopCounterMode``'s count of the plain version, and nothing
    inside the call is counted besides."""
    gen = torch.Generator().manual_seed(0)
    kv = 2 if gqa else 4
    q = torch.randn((2, 16, 4, 32), generator=gen)
    k, v = (torch.randn((2, 24, kv, 32), generator=gen) for _ in range(2))
    with work.count() as tally:
        got = ops.flash_attention(q, k, v, causal=False)
    with FlopCounterMode(display=False) as fc:
        want = flash_attention_ref(q, k, v, causal=False)
    assert tally.flops == tally.kernel_flops == fc.get_total_flops()
    assert tally.bytes == work.flash_work(2, 16, 24, 4, kv, 32, False, 4)[0]
    assert torch.equal(got, want)


def test_credited_kernels_keep_their_gradients():
    """Under ``work.count`` the plain routes' gradients are the plain
    versions' (``flash_attention_bwd``, ``ssd_intra_bwd``), within 1e-5,
    and each call credits its backward's work."""
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((1, 12, 2, 16), generator=gen,
                           requires_grad=True) for _ in range(3))
    with work.count() as tally:
        ops.flash_attention(q, k, v, causal=True).square().sum().backward()
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    flash_attention_ref(q, k, v, causal=True).square().sum().backward()
    for a, t in zip(got, (q, k, v)):
        torch.testing.assert_close(a, t.grad, rtol=1e-5, atol=1e-5)
    shapes = (1, 12, 12, 2, 2, 16, True, 4, 16)
    assert tally.kernel_flops == work.flash_work(*shapes)[1] + \
        work.flash_bwd_work(*shapes)[1]
    x = torch.randn((2, 8, 4, 16), generator=gen, requires_grad=True)
    da = -torch.rand((2, 8, 4), generator=gen)
    B, C = (torch.randn((2, 8, 1, 16), generator=gen) for _ in range(2))
    with work.count() as tally:
        y, s, _ = ops.ssd_intra(x, da, B, C)
        (y.sum() + s.square().sum()).backward()
    gx = x.grad.clone()
    x.grad = None
    y, s, _ = ops.ssd_intra(x, da, B, C)
    (y.sum() + s.square().sum()).backward()
    torch.testing.assert_close(gx, x.grad, rtol=1e-5, atol=1e-5)
    f, b = work.ssd_work(2, 8, 4, 16, 1, 16), work.ssd_bwd_work(2, 8, 4, 16,
                                                                 1, 16)
    assert tally.kernel_flops == f[1] + b[1]


# -- sweep and hillclimb with the subprocess stubbed ------------------------------------

def _stub_run(fail=()):
    """A stand-in for ``subprocess.run`` of a dry run: writes a record to
    ``--out`` with roofline terms from the plan's name, or fails for the
    cells in ``fail``."""
    def run(cmd, capture_output=True, text=True, timeout=None, env=None):
        args, it = {}, iter(cmd[3:])
        for a in it:
            if a in ("--arch", "--shape", "--out", "--plan-name"):
                args[a] = next(it)
        if (args["--arch"], args["--shape"]) in fail:
            return subprocess.CompletedProcess(cmd, 1, "", "boom")
        name = args.get("--plan-name", "baseline")
        seed = sum(map(ord, name)) % 7
        rf = {"t_compute": 0.1 * (seed + 1), "t_memory": 0.05 * (7 - seed),
              "t_collective": 0.02 * seed, "dominant": "compute",
              "roofline_fraction": 0.5}
        rec = {"arch": args["--arch"], "shape": args["--shape"],
               "memory": {}, "roofline": rf,
               "hbm_bytes_per_device": 1e9 * (seed + 1),
               "fits": True, "fits_16g": True}
        os.makedirs(os.path.dirname(args["--out"]), exist_ok=True)
        with open(args["--out"], "w") as f:
            json.dump(rec, f)
        return subprocess.CompletedProcess(cmd, 0, "", "")
    return run


def _lines(out: str) -> list:
    """The sweep's per-cell lines without their seconds."""
    return [line.split(" (")[0] for line in out.splitlines() if line]


def test_sweep_runs_skips_and_resumes_as_the_reference(tmp_path, capsys,
                                                       monkeypatch):
    """Both sweeps over the 40-cell grid with the dry run stubbed: the same
    cells run, skip (8) and fail (one, with a .err file); run again, the
    same cells are kept (HAVE) and only the failed one runs again."""
    fail = {("glm4-9b", "prefill_32k")}
    got = {}
    for mod, label in ((jsweep, "j"), (tsweep, "t")):
        monkeypatch.setattr(mod.subprocess, "run", _stub_run(fail))
        outdir = str(tmp_path / label)
        runs = []
        for _ in range(2):
            mod.main(["--mesh", "pod", "--outdir", outdir])
            runs.append(_lines(capsys.readouterr().out))
        files = sorted(os.listdir(outdir))
        got[label] = (runs, files)
    assert got["t"] == got["j"]
    runs, files = got["t"]
    assert sum(line.startswith("SKIP") for line in runs[0]) == 8
    assert sum(line.startswith("OK") for line in runs[0]) == 31
    assert "FAIL glm4-9b x prefill_32k x pod" in runs[0]
    assert sum(line.startswith("HAVE") for line in runs[1]) == 31
    assert "glm4-9b.prefill_32k.pod.err" in files


def test_hillclimb_records_and_picks_as_the_reference(tmp_path, capsys,
                                                      monkeypatch):
    """Both hillclimbs over the same variants with the dry run stubbed
    record the same terms in their monitors and make the same pick."""
    variants = ["baseline", "accum2:accum=2", "nosp:sp_boundary=false",
                "notp:tp=false"]
    picks = {}
    for mod, label in ((jhill, "j"), (thill, "t")):
        outdir = str(tmp_path / label)
        monkeypatch.setattr(mod, "OUTDIR", outdir)
        monkeypatch.setattr(mod, "DBPATH",
                            os.path.join(outdir, "tensorplan_monitor.json"))
        monkeypatch.setattr(mod.subprocess, "run", _stub_run())
        argv = ["--arch", "qwen2-72b", "--shape", "train_4k"]
        for v in variants:
            argv += ["--variant", v]
        mod.main(argv)
        out = capsys.readouterr().out
        picks[label] = out.strip().splitlines()[-1]
        with open(os.path.join(outdir, "tensorplan_monitor.json")) as f:
            db = json.load(f)["plans"]
        picks[label + "_db"] = {
            sig: {k: v["mean_seconds"] for k, v in plans.items()}
            for sig, plans in db.items()}
    assert picks["t"] == picks["j"]
    assert picks["t_db"] == picks["j_db"]
    assert picks["t"].startswith(
        "production pick for cell:qwen2-72b|train_4k|pod_16x16:")
