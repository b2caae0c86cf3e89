"""The port's tracer (hypre_tpu_torch/core/trace.py) on the CPU: the span
tree of a PCG + BoomerAMG solve through setup_device, the setup's stage
spans, and that the tracer changes no result and, while off, does
nothing at all."""
import pytest
import torch

from hypre_tpu_torch import Config, get_config, set_config
from hypre_tpu_torch.core import trace
from hypre_tpu_torch.solvers import AmgConfig, BoomerAMG, krylov
from torch_port_helpers import LAPLACE_7PT

torch.set_num_threads(1)

N = 12
CONFIGS = {"jacobi": dict(interp_type=6, relax_type=18),
           "cheby": dict(interp_type=6, relax_type=16)}
STAGES = ("setup.strength", "setup.pmis", "setup.interp", "setup.rap",
          "setup.pack")


@pytest.fixture(autouse=True)
def _cpu_and_tracer_off():
    """The tracer is global state: every test starts and ends with it
    off and empty, and the program's configuration as it was."""
    saved = get_config()
    set_config(Config(device="cpu"))
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()
    set_config(saved)


def _setup(kind, **extra):
    return BoomerAMG(AmgConfig(**CONFIGS[kind], **extra)).setup_device(
        stencil=((N, N, N), LAPLACE_7PT))


def _solve(amg):
    b = torch.linspace(-1.0, 1.0, N ** 3, dtype=torch.float64)
    return krylov.pcg(amg.hierarchy.levels[0].A, b, M=amg, tol=1e-8)


_RUNS = {}


def _runs(kind):
    """Setup and solve with the tracer off, then both again with it on;
    the records of the traced setup and the traced solve."""
    if kind not in _RUNS:
        amg = _setup(kind)
        plain = _solve(amg)
        trace.enable()
        amg_t = _setup(kind)
        setup_recs = trace.drain()
        traced = _solve(amg)
        solve_recs = trace.drain()
        trace.disable()
        _RUNS[kind] = dict(amg=amg, amg_t=amg_t, plain=plain, traced=traced,
                           setup=setup_recs, solve=solve_recs)
    return _RUNS[kind]


def _named(recs, name):
    return [r for r in recs if r["name"] == name]


def _check_one_solve(run):
    (s,) = _named(run["solve"], "pcg.solve")
    assert s["parent"] is None and s["solve"] == s["id"]
    assert s["attrs"] == {"iters": run["traced"].iters}


def _check_iters(run):
    its = _named(run["solve"], "pcg.iter")
    assert len(its) == run["traced"].iters > 0
    for r in its:
        # the plain kernels run on the CPU: no launches are counted
        assert r["attrs"] == {"stencil_matvec": 0, "csr_spmv": 0}


def _check_cycles(run):
    (s,) = _named(run["solve"], "pcg.solve")
    cycles = _named(run["solve"], "amg.cycle")
    assert len(cycles) == run["traced"].iters + 1
    iter_ids = {r["id"] for r in _named(run["solve"], "pcg.iter")}
    # the first application precedes the loop; the others are in it
    assert cycles[0]["parent"] == s["id"]
    assert all(c["parent"] in iter_ids for c in cycles[1:])
    assert all(c["device_ms"] is None for c in cycles)


def _check_levels(run):
    nl = len(run["amg"].hierarchy.levels)
    cycle_ids = [c["id"] for c in _named(run["solve"], "amg.cycle")]
    levels = _named(run["solve"], "amg.level")
    assert len(levels) == len(cycle_ids) * (2 * (nl - 1) + 1)
    want = ([(l, "down") for l in range(nl - 1)] + [(nl - 1, "coarse")]
            + [(l, "up") for l in range(nl - 2, -1, -1)])
    for c in cycle_ids:
        mine = [r for r in levels if r["parent"] == c]
        assert [(r["attrs"]["level"], r["attrs"]["phase"])
                for r in mine] == want


def _check_syncs(run):
    syncs = _named(run["solve"], "pcg.sync")
    assert len(syncs) == run["traced"].iters + 2


def _check_solve_ids(run):
    (s,) = _named(run["solve"], "pcg.solve")
    assert all(r["solve"] == s["id"] for r in run["solve"])
    ids = {r["id"] for r in run["solve"]}
    assert all(r["parent"] in ids for r in run["solve"] if r is not s)


def _check_closed_and_nested(run):
    by_id = {r["id"]: r for r in run["solve"]}
    for r in run["solve"]:
        assert r["t0_ns"] <= r["t1_ns"]
        if r["parent"] is not None:
            p = by_id[r["parent"]]
            assert p["t0_ns"] <= r["t0_ns"] and r["t1_ns"] <= p["t1_ns"]


SOLVE_CHECKS = {f.__name__[len("_check_"):]: f for f in (
    _check_one_solve, _check_iters, _check_cycles, _check_levels,
    _check_syncs, _check_solve_ids, _check_closed_and_nested)}


@pytest.mark.parametrize("check", sorted(SOLVE_CHECKS))
@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_solve_span_tree(kind, check):
    SOLVE_CHECKS[check](_runs(kind))


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_tracer_changes_no_result(kind):
    run = _runs(kind)
    assert run["traced"].iters == run["plain"].iters
    assert run["traced"].relres == run["plain"].relres
    assert torch.equal(run["traced"].x, run["plain"].x)
    assert run["amg_t"].level_sizes == run["amg"].level_sizes
    for a, b in zip(run["amg_t"].hierarchy.levels,
                    run["amg"].hierarchy.levels):
        assert torch.equal(a.dinv, b.dinv) if a.dinv is not None \
            else b.dinv is None
    assert torch.equal(run["amg_t"].hierarchy.c_lu, run["amg"].hierarchy.c_lu)


def _check_stage_set(run):
    nl = len(run["amg_t"].hierarchy.levels)
    # a level too small to coarsen further is the coarsest, and PMIS's
    # try on it is the last strength and PMIS stage
    tried = len(run["amg_t"].setup_stats)
    assert tried in (nl - 1, nl)
    for name in STAGES:
        want = tried if name in ("setup.strength", "setup.pmis") else nl - 1
        assert [r["attrs"]["level"] for r in _named(run["setup"], name)] \
            == list(range(want)), name
    (lu,) = _named(run["setup"], "setup.coarse_lu")
    assert lu["attrs"] == {"level": nl - 1}
    pmis = _named(run["setup"], "setup.pmis")
    assert [r["attrs"]["rounds"] for r in pmis] == \
        [st["pmis_rounds"] for st in run["amg_t"].setup_stats]
    # K4 runs only on the card
    assert all(r["attrs"]["btake"] == 0 for r in run["setup"]
               if r["name"] in STAGES)


def _check_setup_stats(run):
    def untimed(stats):
        return [{k: v for k, v in st.items() if not k.endswith("_s")}
                for st in stats]

    assert untimed(run["amg_t"].setup_stats) == \
        untimed(run["amg"].setup_stats)
    assert [sorted(st) for st in run["amg_t"].setup_stats] == \
        [sorted(st) for st in run["amg"].setup_stats]
    # one clock reading, two views
    for name in STAGES:
        key = name.split(".")[1] + "_s"
        for r in _named(run["setup"], name):
            st = run["amg_t"].setup_stats[r["attrs"]["level"]]
            assert (r["t1_ns"] - r["t0_ns"]) / 1e9 == st[key]


def _check_setup_tree(run):
    (whole,) = _named(run["setup"], "amg.setup_device")
    assert whole["parent"] is None and whole["solve"] is None
    rest = [r for r in run["setup"] if r is not whole]
    assert rest and all(r["parent"] == whole["id"] for r in rest)
    assert all(whole["t0_ns"] <= r["t0_ns"] <= r["t1_ns"] <= whole["t1_ns"]
               for r in rest)
    assert {r["name"] for r in rest} == set(STAGES) | {"setup.coarse_lu"}


SETUP_CHECKS = {f.__name__[len("_check_"):]: f for f in (
    _check_stage_set, _check_setup_stats, _check_setup_tree)}


@pytest.mark.parametrize("check", sorted(SETUP_CHECKS))
@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_setup_spans(kind, check):
    SETUP_CHECKS[check](_runs(kind))


def _raise(*a, **k):
    raise AssertionError("the tracer did work while it was off")


@pytest.mark.parametrize("what", ["setup", "solve"])
def test_off_records_nothing(monkeypatch, what):
    amg = _setup("cheby") if what == "solve" else None
    monkeypatch.setattr(trace, "perf_counter_ns", _raise)
    monkeypatch.setattr(trace, "record_function", _raise)
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    if what == "setup":
        _setup("cheby")
    else:
        _solve(amg)
    assert trace.drain() == []


def test_drain_empties_the_buffer():
    trace.enable()
    tok = trace.begin("outer", level=1)
    trace.add("inner", 5, 7, level=2)
    trace.end(tok, n=3)
    recs = trace.drain()
    assert [r["name"] for r in recs] == ["outer", "inner"]
    assert recs[1]["parent"] == recs[0]["id"]
    assert recs[1]["t0_ns"] == 5 and recs[1]["t1_ns"] == 7
    assert recs[0]["attrs"] == {"level": 1, "n": 3}
    assert trace.drain() == []


def test_mirror_names_profiler_ranges():
    amg = _setup("jacobi")
    from torch.profiler import ProfilerActivity, profile

    trace.enable(mirror=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _solve(amg)
    recs = trace.drain()
    names = {e.name for e in prof.events()}
    nl = len(amg.hierarchy.levels)
    assert {"pcg.solve", "pcg.iter", "pcg.sync", "amg.cycle",
            "amg.level/0/down", f"amg.level/{nl - 1}/coarse",
            "amg.level/0/up"} <= names
    assert len(_named(recs, "pcg.iter")) == res.iters


def test_additive_cycle_records_only_the_cycle():
    amg = _setup("jacobi", additive=0)
    trace.enable()
    res = _solve(amg)
    recs = trace.drain()
    assert len(_named(recs, "amg.cycle")) == res.iters + 1
    assert not _named(recs, "amg.level")


def test_graph_replay_is_one_coarse_span(monkeypatch):
    """A CUDA graph's replay of levels >= 1 (a stand-in graph here) is
    one ``amg.level`` span, level 1, phase "graph", which the span take
    files under the coarse levels; it adds the replayed launches."""
    from torch.profiler import ProfilerActivity, profile

    from hypre_tpu_torch.ops.spmv import csr_spmv
    from hypre_tpu_torch.solvers.amg import CoarseGraph, amg_cycle
    from portbench.spans import category

    class Graph:
        replayed = 0

        def replay(self):
            self.replayed += 1

    monkeypatch.setattr(csr_spmv, "launches", 10)
    monkeypatch.setattr(amg_cycle, "replays", 0)
    g = CoarseGraph(Graph(), torch.zeros(4, dtype=torch.float64),
                    torch.ones(4, dtype=torch.float64), ((csr_spmv, 3),))
    fc = torch.arange(4, dtype=torch.float64)
    trace.enable(mirror=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = g(fc)
    recs = trace.drain()
    assert [(r["name"], r["attrs"]) for r in recs] == \
        [("amg.level", {"level": 1, "phase": "graph"})]
    assert "amg.level/1/graph" in {e.name for e in prof.events()}
    assert category("amg.level/1/graph") == "coarse"
    assert out is g.u_out and torch.equal(g.f_in, fc)
    assert g.graph.replayed == 1
    assert csr_spmv.launches == 13 and amg_cycle.replays == 1
