"""The V-cycle's levels >= 1 as one CUDA graph (solvers/amg.py
``CoarseGraph``): which hierarchies take it, and on the card that the
graphed cycle is the eager one bit for bit.

The CPU tests hold the eligibility predicate (``graphable``) to each
condition, and a CPU cycle to the eager path with no graph and no
counter but ``amg_cycle.eager`` moved.  The tests marked ``cuda`` skip
where torch.cuda.is_available() is false; on a machine with an NVIDIA
GPU and nvcc run them with

    python -m pytest tests/test_torch_cycle_graph.py -m cuda --noconftest

(the conftest imports jax, which this file does not need).  On the card
each graphed cycle is compared with ``torch.equal`` to the eager
``_cycle_at(h, 0, f, "V")`` on five right-hand sides in a row (relax 18
at 64^3, Chebyshev relax 16 and relax 18 with relax_order=1 at
64x64x32); PCG with M=BoomerAMG gives the eager run's iterations and x;
the launch counters count a replay as the eager cycle's kernels;
W-cycles, additive cycles, exact GS (relax 13) and 2-D inputs run
eagerly; two live hierarchies keep their own graphs, a new setup
captures afresh, a returned correction survives later cycles, a
checkpoint of a replayed hierarchy loads and cycles alike, and a
capture that raises leaves the hierarchy on the eager path."""
import dataclasses

import pytest
import torch
from torch_port_helpers import LAPLACE_7PT

from hypre_tpu_torch import Config, get_config, set_config
from hypre_tpu_torch.core import checkpoint
from hypre_tpu_torch.gen import laplacian
from hypre_tpu_torch.ops.spmv import csr_spmv
from hypre_tpu_torch.solvers import AmgConfig, BoomerAMG, pcg
from hypre_tpu_torch.solvers import amg as amg_mod
from hypre_tpu_torch.solvers.amg import (
    GRAPH_RELAX, _additive_cycle, _cycle_at, amg_cycle, graphable,
)

torch.set_num_threads(1)
cuda = pytest.mark.cuda

COUNTERS = ("captures", "replays", "eager")


def counters() -> dict:
    return {k: getattr(amg_cycle, k) for k in COUNTERS}


def moved(before: dict) -> dict:
    return {k: v - before[k] for k, v in counters().items()}


def setup_device(grid, **kw):
    return BoomerAMG(AmgConfig(interp_type=6, **kw)).setup_device(
        stencil=(grid, LAPLACE_7PT))


def rhs(n, k, device):
    g = torch.Generator(device=device)
    g.manual_seed(1000 + k)
    return torch.rand(n, generator=g, dtype=torch.float64,
                      device=device) * 2 - 1


# -- CPU ---------------------------------------------------------------


@pytest.fixture
def cpu():
    saved = get_config()
    set_config(Config(device="cpu"))
    yield
    set_config(saved)


_CPU = {}


def cpu_hierarchy():
    if "h" not in _CPU:
        _CPU["h"] = setup_device((10, 10, 10)).hierarchy
    return _CPU["h"]


def _variant(case):
    h = cpu_hierarchy()
    kind, value = case
    if kind == "relax":
        return dataclasses.replace(h, relax_type=value)
    if kind == "levels":
        return dataclasses.replace(h, levels=h.levels[-value:])
    return dataclasses.replace(h, **{kind: value})


GRAPHABLE = {f"relax{r}": (("relax", r), True) for r in GRAPH_RELAX}
GRAPHABLE.update({f"relax{r}": (("relax", r), False)
                  for r in (3, 4, 6, 8, 10, 13, 14)})
GRAPHABLE.update({
    "cycleW": (("cycle_type", "W"), False),
    "cycleF": (("cycle_type", "F"), False),
    "additive": (("additive", 0), False),
    "simple": (("simple", 0), False),
    "levels2": (("levels", 2), False),
    "levels3": (("levels", 3), True),
})


@pytest.mark.parametrize("case", sorted(GRAPHABLE))
def test_graphable(cpu, case):
    change, want = GRAPHABLE[case]
    assert len(cpu_hierarchy().levels) >= 4
    assert graphable(_variant(change)) is want


def test_cpu_cycle_is_eager_and_uncached(cpu):
    h = cpu_hierarchy()
    assert graphable(h)
    f = rhs(h.levels[0].A.n_rows, 0, "cpu")
    launches = csr_spmv.launches
    before = counters()
    u = amg_cycle(h, f)
    assert moved(before) == {"captures": 0, "replays": 0, "eager": 1}
    assert csr_spmv.launches == launches
    assert "_cycle_graphs" not in h.__dict__
    assert torch.equal(u, _cycle_at(h, 0, f, "V"))


# -- the card ------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    saved = get_config()
    set_config(Config(device="cuda"))
    yield torch.device("cuda")
    set_config(saved)


CASES = {"jacobi": ((64, 64, 64), dict(relax_type=18)),
         "cheby": ((64, 64, 32), dict(relax_type=16)),
         "order": ((64, 64, 32), dict(relax_type=18, relax_order=1))}


def graph_and_eager(h, fs):
    """Each f through amg_cycle, then through the eager V-cycle."""
    got = [amg_cycle(h, f) for f in fs]
    want = [_cycle_at(h, 0, f, "V") for f in fs]
    return got, want


@cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_cycle_is_the_eager_cycle(card, case):
    grid, kw = CASES[case]
    h = setup_device(grid, **kw).hierarchy
    assert graphable(h)
    fs = [rhs(h.levels[0].A.n_rows, k, card) for k in range(5)]
    before = counters()
    got, want = graph_and_eager(h, fs)
    torch.cuda.synchronize()
    assert moved(before) == {"captures": 1, "replays": 5, "eager": 0}
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert len(h._cycle_graphs) == 1


@cuda
def test_pcg_with_the_graph_is_the_eager_pcg(card):
    amg = setup_device((64, 64, 32), relax_type=16)
    h = amg.hierarchy
    b = rhs(h.levels[0].A.n_rows, 7, card)
    eager = pcg(h.levels[0].A, b, M=lambda r: _cycle_at(h, 0, r, "V"),
                tol=1e-8)
    before = counters()
    graphed = pcg(h.levels[0].A, b, M=amg, tol=1e-8)
    assert moved(before) == {"captures": 1, "replays": graphed.iters + 1,
                             "eager": 0}
    assert graphed.iters == eager.iters
    assert graphed.relres == eager.relres
    assert torch.equal(graphed.x, eager.x)


@cuda
def test_replay_counts_the_eager_launches(card):
    h = setup_device((64, 64, 64), relax_type=18).hierarchy
    fs = [rhs(h.levels[0].A.n_rows, k, card) for k in range(5)]
    k2 = csr_spmv.launches
    for f in fs:
        _cycle_at(h, 0, f, "V")
    eager = csr_spmv.launches - k2
    k2 = csr_spmv.launches
    before = counters()
    for f in fs:
        amg_cycle(h, f)
    assert csr_spmv.launches - k2 == eager > 0
    assert moved(before) == {"captures": 1, "replays": 5, "eager": 0}
    (g,) = h._cycle_graphs.values()
    assert dict((fn.__name__, n) for fn, n in g.launches)["csr_spmv"] \
        == eager // 5 - 2   # level 0 runs K2 for R and P alone


def _ineligible(kind, device):
    if kind == "W":
        h = setup_device((32, 32, 32), relax_type=18,
                         cycle_type="W").hierarchy
        return h, None, lambda f: _cycle_at(h, 0, f, "W")
    if kind == "additive":
        h = setup_device((32, 32, 32), relax_type=18, additive=0).hierarchy
        return h, None, lambda f: _additive_cycle(h, f)
    if kind == "relax13":
        amg = BoomerAMG(AmgConfig(interp_type=6, relax_type=13)).setup(
            laplacian(16, 16, 16))
        h = amg.hierarchy
        return h, None, lambda f: _cycle_at(h, 0, f, "V")
    h = setup_device((32, 32, 32), relax_type=18).hierarchy
    n = h.levels[0].A.n_rows
    f2 = torch.stack([rhs(n, 0, device), rhs(n, 1, device)], dim=1)
    return h, f2, lambda f: _cycle_at(h, 0, f, "V")


@cuda
@pytest.mark.parametrize("kind", ["W", "additive", "relax13", "2d"])
def test_ineligible_cycles_run_eagerly(card, kind):
    h, f2, today = _ineligible(kind, card)
    before = counters()
    if f2 is not None:
        with pytest.raises(RuntimeError):
            amg_cycle(h, f2)
        with pytest.raises(RuntimeError):
            today(f2)
    else:
        f = rhs(h.levels[0].A.n_rows, 3, card)
        assert torch.equal(amg_cycle(h, f), today(f))
    assert moved(before) == {"captures": 0, "replays": 0, "eager": 1}
    assert "_cycle_graphs" not in h.__dict__


@cuda
def test_two_hierarchies_keep_their_own_graphs(card):
    ha = setup_device((64, 64, 32), relax_type=18).hierarchy
    hb = setup_device((64, 64, 32), relax_type=16).hierarchy
    n = ha.levels[0].A.n_rows
    before = counters()
    for k in range(3):
        f = rhs(n, k, card)
        za, zb = amg_cycle(ha, f), amg_cycle(hb, f)
        assert torch.equal(za, _cycle_at(ha, 0, f, "V"))
        assert torch.equal(zb, _cycle_at(hb, 0, f, "V"))
        assert not torch.equal(za, zb)
    assert moved(before) == {"captures": 2, "replays": 6, "eager": 0}
    (ga,), (gb,) = ha._cycle_graphs.values(), hb._cycle_graphs.values()
    assert ga is not gb and ga.u_out.data_ptr() != gb.u_out.data_ptr()


@cuda
def test_a_new_setup_captures_afresh(card):
    amg = setup_device((64, 64, 32), relax_type=18)
    f = rhs(amg.hierarchy.levels[0].A.n_rows, 4, card)
    first = amg.precondition(f)
    old = amg.hierarchy
    amg.setup_device(stencil=((64, 64, 32), LAPLACE_7PT))
    assert amg.hierarchy is not old
    before = counters()
    again = amg.precondition(f)
    assert moved(before) == {"captures": 1, "replays": 1, "eager": 0}
    assert torch.equal(again, first)
    assert torch.equal(again, _cycle_at(amg.hierarchy, 0, f, "V"))


@cuda
def test_a_returned_correction_survives_later_cycles(card):
    h = setup_device((64, 64, 32), relax_type=16).hierarchy
    n = h.levels[0].A.n_rows
    z = amg_cycle(h, rhs(n, 0, card))
    kept = z.clone()
    (g,) = h._cycle_graphs.values()
    assert z.data_ptr() != g.u_out.data_ptr()
    for k in range(1, 4):
        amg_cycle(h, rhs(n, k, card))
    assert torch.equal(z, kept)


@cuda
def test_checkpoint_of_a_replayed_hierarchy(card, tmp_path):
    amg = setup_device((64, 64, 32), relax_type=16)
    n = amg.hierarchy.levels[0].A.n_rows
    fs = [rhs(n, k, card) for k in range(3)]
    zs = [amg.precondition(f) for f in fs]
    path = str(tmp_path / "amg.npz")
    checkpoint.save_amg(amg, path)
    back = checkpoint.load_amg(path)
    assert "_cycle_graphs" not in back.hierarchy.__dict__
    before = counters()
    for f, z in zip(fs, zs):
        assert torch.equal(back.precondition(f), z)
    assert moved(before) == {"captures": 1, "replays": 3, "eager": 0}


@cuda
def test_a_failed_capture_runs_eagerly(card, monkeypatch):
    h = setup_device((64, 64, 32), relax_type=18).hierarchy
    n = h.levels[0].A.n_rows

    def refuse(*a, **k):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(amg_mod.torch.cuda, "graph", refuse)
    launches = csr_spmv.launches
    _cycle_at(h, 0, rhs(n, 0, card), "V")
    per_cycle = csr_spmv.launches - launches
    before = counters()
    launches = csr_spmv.launches
    for k in range(2):
        f = rhs(n, k, card)
        assert torch.equal(amg_cycle(h, f), _cycle_at(h, 0, f, "V"))
    assert moved(before) == {"captures": 0, "replays": 0, "eager": 2}
    assert csr_spmv.launches - launches == 4 * per_cycle
    (err,) = h._cycle_graphs.values()
    assert "not permitted" in err
