"""The roofline and busy arithmetic on synthetic traces: a take that
lost every record of one kernel is retaken, never read short."""
import pytest
import torch

from portbench import roofline, trace

SERVED = [
    {"key": "A0", "kernel": "stencil_matvec", "type_name": "double",
     "threads": None, "bytes": 2_000_000},
    {"key": "P0", "kernel": "csr_spmv", "type_name": "double",
     "threads": 1000 * 2, "bytes": 500_000},
    {"key": "A1", "kernel": "csr_spmv", "type_name": "double",
     "threads": 300 * 16, "bytes": 900_000},
]
K1 = "void stencil_matvec_tile_kernel<double, false>(double const*)"
K2 = "void csr_spmv_kernel<double, {g}>(long, long const*)"


def _kernel(name, ts, dur, corr, grid, block=(256, 1, 1)):
    return {"cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "corr": corr, "grid": list(grid), "block": list(block)}


def _take(lose_k1=False, lose_one=False):
    """One synthetic take: per 'iteration' one K1 (2 us), one K2 on P0
    (grid 8 x 256 threads >= 2000), one on A1 (grid 19 x 256 >= 4800),
    one elementwise kernel (1 us), 1 us idle between records."""
    evs, ts, corr = [], 0.0, 0
    counts = {"stencil_matvec": 0, "csr_spmv": 0}
    for _ in range(10):
        for name, dur, grid, fam in (
                (K1, 2.0, (8, 16, 16), "stencil_matvec"),
                (K2.format(g=2), 4.0, (8, 1, 1), "csr_spmv"),
                (K2.format(g=16), 6.0, (19, 1, 1), "csr_spmv"),
                ("void elementwise_kernel<double>()", 1.0, (4, 1, 1), None)):
            corr += 1
            evs.append({"cat": "runtime", "name": "cudaLaunchKernel",
                        "ts": ts - 0.5, "dur": 0.2, "corr": corr,
                        "grid": None, "block": None})
            if fam:
                counts[fam] += 1
            lost = (lose_k1 and fam == "stencil_matvec") or \
                (lose_one and corr == 6)
            if not lost:
                evs.append(_kernel(name, ts, dur, corr, grid))
            ts += dur + 1.0
    return {"events": evs, "wall": ts / 1e6, "counts": counts}


def test_attribution_by_thread_count():
    e = _kernel(K2.format(g=16), 0.0, 1.0, 1, (19, 1, 1))
    assert trace.attribute(e, SERVED)["key"] == "A1"
    e = _kernel(K2.format(g=2), 0.0, 1.0, 1, (8, 1, 1))
    assert trace.attribute(e, SERVED)["key"] == "P0"
    assert trace.attribute(_kernel(K2.format(g=2), 0, 1, 1, (99, 1, 1)),
                           SERVED) is None
    e = _kernel(K1, 0.0, 1.0, 1, (8, 16, 16))
    assert trace.attribute(e, SERVED)["key"] == "A0"


def test_take_that_lost_a_kernel_is_retaken():
    takes = iter([_take(lose_k1=True), _take()])
    calls = []

    def fake(run_solve, k, n, device, program):
        calls.append(k)
        return next(takes)

    p = trace.profile_solves(None, 5, {"solves_per_take": 2,
                                       "min_launches_per_op": 10,
                                       "max_takes": 4},
                             SERVED, torch.device("cpu"), None, take=fake)
    assert calls == [5, 7] and p["takes"] == 2 and p["complete"]
    assert p["ops"]["A0"] == {"traced": 10, "us": 20.0}
    assert p["ops"]["A1"] == {"traced": 20, "us": 120.0}
    # take 1: 40 records - 10 lost; busy = union + lost x mean kernel
    mean1 = (10 * 4 + 10 * 6 + 10 * 1) / 30
    assert p["busy_s"] == pytest.approx(
        (110 + 10 * mean1) / 1e6 + 130 / 1e6)
    assert p["window_s"] == pytest.approx(2 * 170 / 1e6)
    assert p["busy_s"] < p["window_s"]
    assert p["launches"] == {
        "takes": 2, "traced": {"stencil_matvec": 10, "csr_spmv": 40},
        "counted": {"stencil_matvec": 20, "csr_spmv": 40},
        "lost_records": 10, "unattributed": 0}
    assert p["breakdown"]["device_ops"][0][0] == K2.format(g=16)


def test_too_few_launches_give_no_metric(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    p = trace.profile_solves(None, 0, {"solves_per_take": 1,
                                       "min_launches_per_op": 10,
                                       "max_takes": 3},
                             SERVED, torch.device("cpu"), None,
                             take=lambda *a: _take(lose_k1=True))
    assert p["takes"] == 3 and not p["complete"]
    ctx = {"profile": p, "counts": {"stencil_matvec": 500, "csr_spmv": 1000},
           "traffic": {"trace": {"min_launches_per_op": 10}},
           "device": torch.device("cpu")}
    assert roofline.kernel_share(ctx, "stencil_matvec") is None
    share = roofline.kernel_share(ctx, "csr_spmv")
    # half the launches each: (5e5 + 9e5) B / 3.35e12 over (4 + 6) us
    assert share == pytest.approx(100 * 1.4e6 / 3.35e12 / 10e-6)


def test_lost_k2_record_still_reads_from_counts(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    p = trace.profile_solves(None, 0, {"solves_per_take": 1,
                                       "min_launches_per_op": 5,
                                       "max_takes": 3},
                             SERVED, torch.device("cpu"), None,
                             take=lambda *a: _take(lose_one=True))
    assert p["takes"] == 1 and p["ops"]["P0"]["traced"] == 9
    ctx = {"profile": p, "counts": {"stencil_matvec": 10, "csr_spmv": 20},
           "traffic": {"trace": {"min_launches_per_op": 5}},
           "device": torch.device("cpu")}
    n_p, n_a = 20 * 9 / 19, 20 * 10 / 19
    want = 100 * (n_p * 5e5 + n_a * 9e5) / 3.35e12 \
        / ((n_p * 4 + n_a * 6) * 1e-6)
    assert roofline.kernel_share(ctx, "csr_spmv") == pytest.approx(want)


def test_no_share_on_a_card_without_a_published_peak(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 PCIe")
    p = trace.profile_solves(None, 0, {"solves_per_take": 1,
                                       "min_launches_per_op": 5,
                                       "max_takes": 1},
                             SERVED, torch.device("cpu"), None,
                             take=lambda *a: _take())
    ctx = {"profile": p, "counts": {"stencil_matvec": 10, "csr_spmv": 20},
           "traffic": {"trace": {"min_launches_per_op": 5}},
           "device": torch.device("cpu")}
    assert roofline.kernel_share(ctx, "csr_spmv") is None
