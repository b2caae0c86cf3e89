"""The span metrics (spans.py and its readers) on synthetic takes with
the program's spans as profiler ranges, and on a CPU run at a small
grid."""
import copy

import pytest
import torch

from portbench import harness, spans, trace
from test_pb_trace import SERVED, _take

ITER = [(10.0, 500.0, "pcg.iter"), (100.0, 400.0, "amg.cycle"),
        (110.0, 200.0, "amg.level/0/down"), (200.0, 250.0,
                                              "amg.level/1/coarse"),
        (250.0, 390.0, "amg.level/0/up"), (450.0, 500.0, "pcg.sync")]


def _synthetic(n_iters=1):
    """Iterations 1000 us apart inside one pcg.solve: per iteration a
    launch in each layer, each record (500 us after the iteration's
    start, on the device's timeline) after a gap of a known length."""
    events, spans_, corr = [], [(0.0, 1000.0 * n_iters + 600.0,
                                 "pcg.solve")], 0
    # (launch time, record start, record length): gaps fine 5, coarse 7,
    # none at 70 (record starts as the last ends), cycle 3, krylov 5
    plan = [(20.0, 30.0, 10.0), (120.0, 45.0, 10.0), (210.0, 62.0, 8.0),
            (300.0, 70.0, 10.0), (395.0, 83.0, 2.0), (460.0, 90.0, 5.0)]
    for i in range(n_iters):
        off = 1000.0 * i
        spans_ += [(s + off, e + off, n) for s, e, n in ITER]
        for launch, ts, dur in plan:
            corr += 1
            events.append({"cat": "runtime", "name": "cudaLaunchKernel",
                           "ts": launch + off, "dur": 1.0, "corr": corr,
                           "grid": None, "block": None})
            events.append({"cat": "kernel", "name": "k",
                           "ts": 500.0 + off + ts,
                           "dur": dur, "corr": corr, "grid": [1, 1, 1],
                           "block": [32, 1, 1]})
        # a copy inside the iteration is no kernel launch
        events.append({"cat": "runtime", "name": "cudaMemcpyAsync",
                       "ts": 30.0 + off, "dur": 1.0, "corr": None,
                       "grid": None, "block": None})
    # a record whose launch lies outside every span, 5 us after the last
    corr += 1
    last = max(e["ts"] + e["dur"] for e in events if e["cat"] == "kernel")
    events += [{"cat": "runtime", "name": "cudaLaunchKernel",
                "ts": 1000.0 * n_iters + 900.0, "dur": 1.0, "corr": corr,
                "grid": None, "block": None},
               {"cat": "kernel", "name": "k", "ts": last + 5.0, "dur": 1.0,
                "corr": corr, "grid": [1, 1, 1], "block": [32, 1, 1]}]
    return events, sorted(spans_)


@pytest.mark.parametrize("n_iters", [1, 3])
def test_idle_split_by_layer(n_iters):
    events, sp = _synthetic(n_iters)
    t = spans.split(events, sp, wall_s=1e-3 * (n_iters + 1))
    assert t["iters"] == n_iters
    # between iterations: the first record of the next one starts 935 us
    # after the last ends, launched inside pcg.iter
    between = (n_iters - 1) * 935.0
    want = {"krylov": 5.0 * n_iters + between, "fine": 5.0 * n_iters,
            "coarse": 7.0 * n_iters, "cycle": 3.0 * n_iters, "none": 5.0}
    assert t["idle_s"] == pytest.approx({k: v / 1e6
                                         for k, v in want.items()})
    ctx = {"spans": {"window": [], "take": t}}
    for cat in ("krylov", "fine", "coarse"):
        reader = harness.reader(f"{cat}_idle_ms.p95")
        assert reader.read(ctx) == pytest.approx(
            1e3 * want[cat] / 1e6 / n_iters)


@pytest.mark.parametrize("n_iters", [1, 3])
def test_launches_per_iter(n_iters):
    events, sp = _synthetic(n_iters)
    t = spans.split(events, sp, wall_s=1e-3)
    # six launches an iteration; the copy and the launch outside every
    # span do not count
    assert t["launches_in_iters"] == 6 * n_iters
    ctx = {"spans": {"window": [], "take": t}}
    assert harness.reader("launches_per_iter.solve").read(ctx) == 6.0


def test_launch_before_the_first_solve_is_not_the_takes():
    """The take's warm-up launch (before the first pcg.solve) and its
    record change nothing."""
    events, sp = _synthetic(1)
    bare = spans.split(events, sp, wall_s=1e-3)
    warm = [{"cat": "runtime", "name": "cudaLaunchKernel", "ts": -50.0,
             "dur": 1.0, "corr": 999, "grid": None, "block": None},
            {"cat": "kernel", "name": "k", "ts": 400.0, "dur": 1.0,
             "corr": 999, "grid": [1, 1, 1], "block": [32, 1, 1]}]
    assert spans.split(warm + events, sp, wall_s=1e-3) == bare


def test_gap_with_no_enclosing_span():
    events, _ = _synthetic(1)
    t = spans.split(events, [], wall_s=1e-3)
    total = (5 + 7 + 3 + 5 + 5) / 1e6
    assert t["iters"] == 0 and t["launches_in_iters"] == 0
    assert t["idle_s"]["none"] == pytest.approx(total)
    assert sum(t["idle_s"].values()) == pytest.approx(total)
    ctx = {"spans": {"window": [], "take": t}}
    # no iteration: the idle readers find nothing to read
    assert harness.reader("fine_idle_ms.solve").read(ctx) is None


def test_no_idle_reads_zero():
    events = [{"cat": "runtime", "name": "cudaLaunchKernel", "ts": 20.0,
               "dur": 1.0, "corr": 1, "grid": None, "block": None},
              {"cat": "kernel", "name": "k", "ts": 30.0, "dur": 10.0,
               "corr": 1, "grid": [1, 1, 1], "block": [32, 1, 1]}]
    t = spans.split(events, [(10.0, 500.0, "pcg.iter")], wall_s=1e-3)
    ctx = {"spans": {"window": [], "take": t}}
    for cat in ("krylov", "fine", "coarse"):
        assert harness.reader(f"{cat}_idle_ms.solve").read(ctx) == 0.0


@pytest.mark.parametrize("kind", ["plain", "lost_k1", "lost_one"])
def test_takes_of_the_trace_tests_read_as_before(kind):
    """The synthetic takes of test_pb_trace.py: take_summary reads them
    as before, and with no spans every gap is charged to none."""
    tk = _take(lose_k1=kind == "lost_k1", lose_one=kind == "lost_one")
    before = trace.take_summary(tk, SERVED)
    t = spans.split(tk["events"], [], tk["wall"])
    assert t["busy_s"] == before["busy_s"]
    assert t["lost"] == before["lost"]
    assert t["idle_s"]["none"] == pytest.approx(
        sum(before["gaps_s"].values()))
    if kind == "plain":
        # 40 records 1 us apart, the take's own idle 39 us
        assert before["busy_s"] == pytest.approx(130e-6)
        assert t["idle_s"]["none"] == pytest.approx(39e-6)


@pytest.mark.parametrize("category_of", [
    ("amg.level/0/down", "fine"), ("amg.level/0/up", "fine"),
    ("amg.level/2/up", "coarse"), ("amg.level/8/coarse", "coarse"),
    ("pcg.iter", "krylov"), ("pcg.sync", "krylov"),
    ("pcg.solve", "krylov"), ("amg.cycle", "cycle"), (None, "none"),
    ("aten::mul", "none")])
def test_category(category_of):
    label, cat = category_of
    assert spans.category(label) == cat


def test_window_and_setup_readers():
    window = [{"name": "amg.cycle", "t0_ns": 0, "t1_ns": 2_000_000,
               "device_ms": 4.0},
              {"name": "amg.level", "t0_ns": 0, "t1_ns": 1, "device_ms": None},
              {"name": "amg.cycle", "t0_ns": 0, "t1_ns": 4_000_000,
               "device_ms": 6.0}]
    setup = [{"name": "setup.pmis", "t0_ns": 0, "t1_ns": 1_500_000_000},
             {"name": "setup.pmis", "t0_ns": 0, "t1_ns": 500_000_000},
             {"name": "setup.rap", "t0_ns": 10, "t1_ns": 250_000_010}]
    ctx = {"spans": {"window": window, "take": None}, "setup_spans": setup}
    assert harness.reader("cycle_ms.solve").read(ctx) == 5.0
    assert harness.reader("cycle_host_ms.p95").read(ctx) == 3.0
    assert harness.reader("setup_pmis_s").read(ctx) == 2.0
    assert harness.reader("setup_rap_s").read(ctx) == 0.25
    assert harness.reader("setup_interp_s").read(ctx) == 0.0
    assert harness.reader("launches_per_iter.solve").read(ctx) is None


def _small_spec(cell):
    s = copy.deepcopy(harness.cell_spec(cell))
    s["config"]["grid"] = [11, 10, 9]
    return s


@pytest.mark.parametrize("cell", ["out14.solve", "out22.solve"])
def test_probe_on_the_cpu(cell):
    """The whole probe at a small grid: setup spans cover the setup,
    the span take has every iteration, and the CPU gives no device
    time (no CUDA events, no device records)."""
    out = spans.measure(_small_spec(cell), 1234567890123, 0.2,
                        torch.device("cpu"), cost_rounds=2)
    m = out["metrics"]
    suffix = ".solve" if cell == "out14.solve" else ".p95"
    assert m["cycle_ms" + suffix] is None
    assert m["cycle_host_ms" + suffix] > 0
    assert m["launches_per_iter" + suffix] == 0.0
    assert out["take"]["iters"] > 0 and out["take"]["busy_s"] == 0.0
    assert all(m[f"{c}_idle_ms{suffix}"] == 0.0
               for c in ("krylov", "fine", "coarse"))
    assert all(m[f"setup_{s}_s"] > 0 for s in ("pmis", "interp", "rap"))
    assert 0.5 < out["setup_covered"] <= 1.0
    assert [r["level"] for r in out["stages"]] == \
        list(range(len(out["stages"])))
    assert len(out["tracing"]["on_s"]) == len(out["tracing"]["off_s"]) == 2


def test_program_without_a_tracer_gives_nothing(monkeypatch):
    monkeypatch.setattr(spans, "tracer", lambda: None)
    assert spans.span_window(None, [1]) is None
    assert spans.span_take(None, [1], torch.device("cpu")) is None
    assert spans.setup_spans(lambda: 7) == (7, None)
    for name in spans.NAMES:
        full = name if name.startswith("setup_") else name + ".solve"
        assert harness.reader(full).read({}) is None
