"""Golden-file regression harness of the port.

Counterpart of hypre_tpu/testing/runtest.py (itself the analog of
hypre's src/test/runtest.sh:27-46 with TEST_ij/solvers.jobs and
solvers.saved): a job file lists driver invocations, the runner
executes each one through the port's driver, extracts the output tail
(Iterations / Final Relative Residual Norm) and compares it with the
golden file, which holds the reference's own output.

Job file format (one case per line, '#' comments):
    ij -n 33 33 1 -solver 1 -exec_host
    struct -n 32 32 32 -solver 11 -exec_host

Golden file format (one block per job line):
    # <job line>
    Iterations = <int>
    Final Relative Residual Norm = <float>

The port's ij and struct drivers run every solver id and flag of the
reference's.

    python -m hypre_tpu_torch.testing.runtest tests/golden/solvers.jobs
    python -m hypre_tpu_torch.testing.runtest tests/golden/struct_solvers.jobs
check the rows of a job file against its .saved file.
"""
from __future__ import annotations

import contextlib
import io
import re
from pathlib import Path

ITER_RE = re.compile(r"Iterations = (\d+)")
RES_RE = re.compile(r"Final Relative Residual Norm = ([0-9.eE+-]+)")


def _driver(line: str):
    """The port's driver module of a job line, and its arguments."""
    parts = line.split()
    driver, argv = parts[0], parts[1:]
    if driver == "ij":
        from hypre_tpu_torch.drivers import ij as mod
    elif driver == "struct":
        from hypre_tpu_torch.drivers import struct as mod
    else:
        raise ValueError(f"unknown driver {driver!r}")
    return mod, argv


def run_job(line: str) -> tuple[int, float]:
    """Run one driver job in-process; return (iterations, residual)."""
    mod, argv = _driver(line)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    out = buf.getvalue()
    if rc not in (0, None):
        raise RuntimeError(f"job failed rc={rc}: {line}\n{out}")
    it = ITER_RE.search(out)
    res = RES_RE.search(out)
    if not it or not res:
        raise RuntimeError(f"no golden tail in output of: {line}\n{out}")
    return int(it.group(1)), float(res.group(1))


def ported(line: str) -> bool:
    """Whether the port runs this job: its driver's parser takes its
    flags and the solver id is known (an unknown id raises ValueError;
    nothing is run)."""
    mod, argv = _driver(line)
    mod.check_flags(mod.build_parser().parse_args(argv))
    return True


def read_jobs(path: Path) -> list[str]:
    return [ln.strip() for ln in Path(path).read_text().splitlines()
            if ln.strip() and not ln.strip().startswith("#")]


def read_golden(path: Path) -> list[tuple[int, float]]:
    out = []
    it = None
    for ln in Path(path).read_text().splitlines():
        m = ITER_RE.search(ln)
        if m:
            it = int(m.group(1))
        m = RES_RE.search(ln)
        if m:
            out.append((it, float(m.group(1))))
    return out


def compare(job: str, result: tuple[int, float], golden: tuple[int, float],
            iter_slack: int = 0, res_rtol: float = 1e-3) -> list[str]:
    """runtest.sh's -rtol rule: iterations within iter_slack, and a
    residual no worse than the golden one by more than res_rtol (a
    better residual passes).  Returns the failures."""
    (it, res), (git, gres) = result, golden
    failures = []
    if abs(it - git) > iter_slack:
        failures.append(f"{job}: iterations {it} != golden {git}")
    if gres != 0 and abs(res - gres) / abs(gres) > res_rtol and res > gres:
        failures.append(f"{job}: residual {res:e} vs golden {gres:e}")
    return failures


def check_suite(jobs_path: Path, golden_path: Path, iter_slack: int = 0,
                res_rtol: float = 1e-3) -> list[str]:
    """Run every job that the port runs and compare it with its golden
    block.  Returns the failures (empty = pass)."""
    jobs = read_jobs(jobs_path)
    golden = read_golden(golden_path)
    assert len(jobs) == len(golden), "jobs/golden length mismatch"
    failures = []
    for job, gold in zip(jobs, golden):
        if ported(job):
            failures += compare(job, run_job(job), gold, iter_slack,
                                res_rtol)
    return failures


if __name__ == "__main__":
    import sys

    fails = []
    for jp in (Path(p) for p in sys.argv[1:]):
        fails += check_suite(jp, jp.with_suffix(".saved"))
    for f in fails:
        print("FAIL:", f)
    sys.exit(1 if fails else 0)
