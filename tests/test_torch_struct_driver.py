"""The port's struct driver against hypre_tpu's, in f64 on the CPU.

* All 4 rows of tests/golden/struct_solvers.jobs through the port's
  driver (``testing/runtest``): equal iterations, residual within rtol
  1e-3 of struct_solvers.saved, the reference's own output.
* The PFMG-based and plain solver ids (1, 11, 17, 18, 19) at small
  sizes through both drivers: equal iterations, the final relative
  residual to 1e-11 (rounding alone parts the two; ~1e-13 measured).
  SMG's ids (0, 10) are held by the golden rows (the reference's SMG
  compiles take minutes a size).
* ``run`` returns the run's objects and, under -exec_host, restores the
  caller's Config; an unknown solver id raises ValueError.
"""
import contextlib
import io
import pathlib
import re

import numpy as np
import pytest
import torch

from hypre_tpu.drivers import struct as ref_struct
from hypre_tpu_torch import Config, get_config, set_config
from hypre_tpu_torch.drivers import struct
from hypre_tpu_torch.struct import PFMG, StructMatrix, struct_matvec
from hypre_tpu_torch.testing import runtest

torch.set_num_threads(1)
GOLDEN = pathlib.Path(__file__).parent / "golden"
JOBS = runtest.read_jobs(GOLDEN / "struct_solvers.jobs")
SAVED = runtest.read_golden(GOLDEN / "struct_solvers.saved")


def _tail(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) in (0, None)
    out = buf.getvalue()
    return (int(re.search(r"Iterations = (\d+)", out).group(1)),
            float(re.search(r"Final Relative Residual Norm = (\S+)",
                            out).group(1)))


@pytest.mark.parametrize("row", range(len(JOBS)))
def test_struct_golden_row(row):
    job = JOBS[row]
    assert runtest.ported(job)
    assert runtest.compare(job, runtest.run_job(job), SAVED[row]) == []


@pytest.mark.parametrize("flags", [
    "-n 10 10 10 -solver 11", "-n 12 9 7 -solver 1",
    "-n 10 10 10 -solver 1 -relax 2", "-n 24 24 1 -solver 11 -relax 0",
    "-n 10 10 10 -solver 17", "-n 10 10 10 -solver 18",
    "-n 8 8 8 -solver 19 -max_iter 40", "-n 10 10 10 -solver 11 -c 1 1 10",
])
def test_driver_matches_reference(flags):
    argv = flags.split() + ["-exec_host"]
    it_ref, rel_ref = _tail(ref_struct.main, argv)
    it, rel = _tail(struct.main, argv)
    assert it == it_ref
    assert abs(rel - rel_ref) <= 1e-11 + 1e-6 * rel_ref


def test_run_returns_objects_and_restores_config():
    caller = Config(real_dtype=torch.float32, device="cpu")
    set_config(caller)
    try:
        out = struct.run(struct.build_parser().parse_args(
            "-n 8 8 8 -solver 11 -exec_host".split()))
        assert get_config() is caller
    finally:
        set_config(Config(real_dtype=torch.float64, device="cpu"))
    assert isinstance(out["A"], StructMatrix) and isinstance(out["mg"], PFMG)
    assert out["x"].shape == (8, 8, 8) and out["x"].dtype == torch.float64
    assert out["level_shapes"][0] == (8, 8, 8)
    assert out["relres"] <= 1e-6 and out["iters"] > 0
    r = out["b"] - struct_matvec(out["A"], out["x"])
    assert float(r.norm() / out["b"].norm()) <= 1e-6
    assert np.isfinite(out["setup_s"]) and np.isfinite(out["solve_s"])


def test_unknown_solver_raises():
    with pytest.raises(ValueError, match="solver id 5"):
        struct.run(struct.build_parser().parse_args(
            "-n 4 4 4 -solver 5 -exec_host".split()))
    with pytest.raises(ValueError):
        runtest.ported("struct -n 4 4 4 -solver 5")
