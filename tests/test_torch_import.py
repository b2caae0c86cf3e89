"""The port stands alone: importing it pulls in neither jax nor
hypre_tpu, and with no card it refuses to run unless asked for the
CPU.  Both checks run in a fresh interpreter: this process has imported
jax already (tests/conftest.py)."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "hypre_tpu_torch"


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


def test_import_leaves_out_jax_and_reference():
    code = (
        "import sys\n"
        "import hypre_tpu_torch, hypre_tpu_torch.convert, "
        "hypre_tpu_torch.core, hypre_tpu_torch.gen, hypre_tpu_torch.ops, "
        "hypre_tpu_torch.setup, hypre_tpu_torch.csrc.build, "
        "hypre_tpu_torch.solvers.amg, hypre_tpu_torch.solvers.krylov, "
        "hypre_tpu_torch.solvers.krylov_more, hypre_tpu_torch.ops.dia, "
        "hypre_tpu_torch.ops.trisolve, hypre_tpu_torch.drivers.ij, "
        "hypre_tpu_torch.testing.runtest, hypre_tpu_torch.struct, "
        "hypre_tpu_torch.sstruct, hypre_tpu_torch.drivers.struct, "
        "hypre_tpu_torch.ops.tridiag, hypre_tpu_torch.solvers.ams, "
        "hypre_tpu_torch.solvers.maxwell, hypre_tpu_torch.solvers.refine, "
        "hypre_tpu_torch.hypre_compat, hypre_tpu_torch.core.checkpoint, "
        "hypre_tpu_torch.examples.ex5, hypre_tpu_torch.examples.ex11, "
        "hypre_tpu_torch.examples.ex_struct, "
        "hypre_tpu_torch.examples.ex3_pfmg, "
        "hypre_tpu_torch.examples.ex15_ams, "
        "hypre_tpu_torch.examples.ex9_systems, "
        "hypre_tpu_torch.examples.ex_lobpcg, "
        "hypre_tpu_torch.examples.ex6_multibox, "
        "hypre_tpu_torch.examples.ex_capi, hypre_tpu_torch.parallel, "
        "hypre_tpu_torch.parallel.par_setup, "
        "hypre_tpu_torch.parallel.ij_par, hypre_tpu_torch.parallel.amgdd, "
        "hypre_tpu_torch.solvers.par_amg, hypre_tpu_torch.struct.par_struct, "
        "hypre_tpu_torch.examples.ex_multichip\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'hypre_tpu' or m.startswith('hypre_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_sources_never_name_jax_or_reference_modules():
    pattern = re.compile(r"^\s*(import|from)\s+jax\b|hypre_tpu\.", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "compare_kernels.py"]
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders


@pytest.mark.parametrize("call", ["setup", "pcg", "operator", "pfmg", "smg",
                                  "struct_driver", "ams", "maxwell", "capi",
                                  "par_amg"])
def test_default_device_without_card_raises(call):
    """The default device is cuda; with no card, entry points raise
    instead of running on the CPU."""
    code = (
        "import numpy as np, torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "from hypre_tpu_torch.core.errors import HypreTpuError\n"
        "from hypre_tpu_torch.gen import laplacian\n"
        "from hypre_tpu_torch.ops import sparse_op_from_scipy\n"
        "from hypre_tpu_torch.solvers import AmgConfig, BoomerAMG, pcg\n"
        "from hypre_tpu_torch.drivers import struct\n"
        "from hypre_tpu_torch.struct import PFMG, SMG, StructMatrix\n"
        "from hypre_tpu_torch import hypre_compat as H\n"
        "from hypre_tpu_torch.solvers.ams import AMS, maxwell_3d\n"
        "from hypre_tpu_torch.sstruct import SStructMaxwell\n"
        "A = laplacian(6, 6, 6)\n"
        "Ae, G, Pi = maxwell_3d(3)\n"
        "S = StructMatrix(torch.ones(1, 4, 4, 4, dtype=torch.float64),\n"
        "                 ((0, 0, 0),), (4, 4, 4))\n"
        "calls = {'setup': lambda: BoomerAMG(AmgConfig()).setup(A),\n"
        "         'pcg': lambda: pcg(lambda v: v, np.ones(216)),\n"
        "         'operator': lambda: sparse_op_from_scipy(A),\n"
        "         'pfmg': lambda: PFMG().setup(S),\n"
        "         'smg': lambda: SMG().setup(S),\n"
        "         'struct_driver': lambda: struct.run(\n"
        "             struct.build_parser().parse_args(['-n', '4', '4', '4',\n"
        "                                               '-solver', '11'])),\n"
        "         'ams': lambda: AMS().setup(Ae, G, Pi),\n"
        "         'maxwell': lambda: SStructMaxwell().setup(Ae, G),\n"
        "         'capi': lambda: H.HYPRE_BoomerAMGSetup(\n"
        "             H.HYPRE_BoomerAMGCreate(), A),\n"
        "         'par_amg': lambda: __import__(\n"
        "             'hypre_tpu_torch.solvers.par_amg', fromlist=['x'])\n"
        "             .ParBoomerAMG(8, AmgConfig()).setup(A)}\n"
        "try:\n"
        f"    calls[{call!r}]()\n"
        "except HypreTpuError as e:\n"
        "    print('raised', e)\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert "raised" in out.stdout and "cuda" in out.stdout.lower()


def test_cpu_on_request():
    code = (
        "import numpy as np\n"
        "from hypre_tpu_torch import Config, set_config\n"
        "set_config(Config(device='cpu'))\n"
        "from hypre_tpu_torch.core.config import get_device\n"
        "print(get_device())\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "cpu"
