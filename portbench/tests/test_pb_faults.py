"""A run driven past the look for a card, with the timed path broken
underneath, comes out not correct; a sound one comes out correct; the
control (the program's float32 path) fails every number; and a run
with no card fails instead of falling back to the CPU."""
import copy
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness
from portbench.control import readings


def spec(cell="out14.solve", grid=(11, 10, 9)):
    s = copy.deepcopy(harness.cell_spec(cell))
    s["config"]["grid"] = list(grid)
    return s


def run(s, seed=1234567890123):
    return harness.run_cell(s, seed, 0.3, False, time.perf_counter(),
                            torch.device("cpu"))


@pytest.mark.parametrize("cell", ["out14.solve", "out22.solve"])
def test_sound_run_is_correct(cell):
    s = spec(cell)
    out = run(s)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in s["end_to_end"]}
    assert {"setup_s", "solve_p95_s"} <= set(out["metrics"])


def _patch_pcg(monkeypatch, change):
    from hypre_tpu_torch.solvers import krylov

    orig = krylov.pcg

    def broken(*a, **k):
        return change(orig(*a, **k), a, k)

    monkeypatch.setattr(krylov, "pcg", broken)


def test_solve_that_returns_its_state_unchanged(monkeypatch):
    from hypre_tpu_torch.solvers.krylov import KrylovResult

    _patch_pcg(monkeypatch, lambda res, a, k: KrylovResult(
        x=torch.zeros_like(res.x), iters=res.iters, relres=res.relres))
    out = run(spec())
    assert not out["correct"] and out["checks"]["relres_max"]["value"] > 0.5


def test_answer_altered_where_produced(monkeypatch):
    def alter(res, a, k):
        x = res.x.clone()
        x[x.numel() // 3] += 1e-4 * x.abs().max()
        return res._replace(x=x)

    _patch_pcg(monkeypatch, alter)
    out = run(spec())
    assert not out["correct"]
    assert out["checks"]["relres_max"]["value"] > 1e-8


@pytest.mark.parametrize("cell", ["out14.solve", "out22.solve"])
def test_cycle_altered(monkeypatch, cell):
    """Every application of the cycle off by ten times its limit."""
    from hypre_tpu_torch.solvers.amg import BoomerAMG

    s = spec(cell)
    limit = s["config"]["limits"]["cycle_rel_diff"]
    orig = BoomerAMG.precondition
    monkeypatch.setattr(BoomerAMG, "precondition",
                        lambda self, r: orig(self, r) * (1 + 10 * limit))
    out = run(s)
    assert not out["correct"]
    assert out["checks"]["cycle_rel_diff"]["value"] > limit


@pytest.mark.parametrize("part", ["P", "A"])
def test_setup_altered(monkeypatch, part):
    """One entry of level 0's P, or of level 1's A, off by 1e-8."""
    from hypre_tpu_torch.solvers.amg import BoomerAMG

    orig = BoomerAMG.setup_device

    def broken(self, *a, **k):
        amg = orig(self, *a, **k)
        op = getattr(amg.hierarchy.levels[0 if part == "P" else 1], part)
        vals = op.values if hasattr(op, "values") else op.vals.view(-1)
        nz = torch.nonzero(vals).flatten()
        vals[nz[::7]] *= 1 + 1e-8
        return amg

    monkeypatch.setattr(BoomerAMG, "setup_device", broken)
    out = run(spec(grid=(14, 14, 14)))
    assert not out["correct"]
    name = "interp_rel_diff" if part == "P" else "galerkin_rel_diff"
    assert out["checks"][name]["value"] > 1e-10


@pytest.mark.parametrize("cell", ["out14.solve", "out22.solve"])
def test_control_is_not_correct(cell):
    """The program's float32 path fails every number: its solution, and
    its hierarchy, whose rounded coarse operators decide tied strengths
    another way, so that the reference's own hierarchy splits unlike
    the program's on a coarse level (a gap of 1e300)."""
    s = spec(cell, grid=(14, 13, 12))
    got = readings(s, torch.float32, [5, 2 ** 31 + 11], 0.3,
                   torch.device("cpu"))
    limits = s["config"]["limits"]
    for g in got:
        for name in limits:
            assert g["values"][name] > limits[name], (name, g["values"])
        # where the levels still agree, float32's rounding
        assert 1e-9 < g["detail"]["levels"][0][0] < 1e-6


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "out14.solve", "--seed", "1", "--seconds", "1"],
                       cwd=harness.ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]


def test_only_the_benchmark_files_is_no_run(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "out14.solve", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]


@pytest.mark.cuda
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "out22.solve", "--seed", "2147483659", "--seconds",
                        "2", "--trace", "1"], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=900)
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert p.returncode == 0 and out["correct"], p.stderr[-2000:]
    assert set(out["metrics"]) == {
        m["name"] for m in harness.cell_spec("out22.solve")["per_layer"]}
