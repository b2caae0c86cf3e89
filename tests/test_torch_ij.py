"""The port's ij driver and golden harness.

Every row of tests/golden/solvers.jobs (lines 2-19: every AMG option of
the file with solvers 1-4 and 9, and solvers 16, 51, 20 and 43) goes
through hypre_tpu_torch.testing.runtest against
tests/golden/solvers.saved, which is the reference's own output, by the
reference harness's rule: equal iterations (iter_slack 0) and a residual
no worse than the golden one by more than rtol 1e-3.  The driver's
level formats at 24^3 equal the reference's (CSR standing in for
GST-ELL), and -exec_host leaves the caller's Config as it was.  The
driver's I/O and LOBPCG flags are held against the reference's in
tests/test_torch_ij_io.py."""
from pathlib import Path

import numpy as np
import pytest
import torch

from hypre_tpu.drivers import ij as ref_ij
from hypre_tpu.gen import laplacian as ref_laplacian
from hypre_tpu.solvers import amg as ref_amg
from hypre_tpu_torch import Config, get_config, set_config
from hypre_tpu_torch.drivers import ij
from hypre_tpu_torch.testing import runtest

torch.set_num_threads(1)
GOLDEN = Path(__file__).parent / "golden"
JOBS = runtest.read_jobs(GOLDEN / "solvers.jobs")
SAVED = runtest.read_golden(GOLDEN / "solvers.saved")
# solvers.jobs lines 2-19 (its first line is a comment)
PORTED_ROWS = list(range(18))
PORT_CLASS = {"DenseMatrix": "DenseMatrix", "DiaMatrix": "DiaMatrix",
              "GstEllMatrix": "CsrMatrix", "EllMatrix": "CsrMatrix"}


@pytest.fixture(autouse=True)
def _cpu():
    set_config(Config(device="cpu"))
    yield


def test_rows_the_port_runs():
    assert len(JOBS) == len(SAVED)
    assert [i for i, job in enumerate(JOBS) if runtest.ported(job)] \
        == PORTED_ROWS


@pytest.mark.parametrize("row", PORTED_ROWS, ids=[JOBS[i] for i in
                                                  PORTED_ROWS])
def test_golden_row(row):
    job = JOBS[row]
    assert not runtest.compare(job, runtest.run_job(job), SAVED[row],
                               iter_slack=0, res_rtol=1e-3)


def test_parser_is_the_references():
    def actions(p):
        return [(a.option_strings, a.dest, a.default, a.nargs, a.type)
                for a in p._actions]

    assert actions(ij.build_parser()) == actions(ref_ij.build_parser())


def test_level_formats_match_reference():
    n = 24
    ref = ref_amg.BoomerAMG(ref_amg.AmgConfig(
        coarsen_type="hmis", interp_type=6, relax_type=13)).setup(
        ref_laplacian(n, n, n))
    want = [PORT_CLASS[type(lvl.A).__name__] for lvl in ref.hierarchy.levels]
    out = ij.run(ij.build_parser().parse_args(
        ["-n", str(n), str(n), str(n), "-exec_host"]))
    assert out["level_formats"] == want
    assert want[0] == "DiaMatrix"
    assert out["amg"].level_sizes == ref.level_sizes


def test_exec_host_keeps_the_callers_config():
    caller = Config(real_dtype=torch.float32, device="cpu")
    set_config(caller)
    out = ij.run(ij.build_parser().parse_args(
        ["-n", "12", "12", "12", "-solver", "2", "-exec_host"]))
    assert get_config() is caller
    assert out["x"].dtype == torch.float64 and out["x"].device.type == "cpu"
    # without -exec_host the run takes the caller's Config
    out = ij.run(ij.build_parser().parse_args(
        ["-n", "12", "12", "12", "-solver", "2"]))
    assert get_config() is caller
    assert out["x"].dtype == torch.float32
    assert np.isfinite(out["relres"]) and out["relres"] <= 1e-8
