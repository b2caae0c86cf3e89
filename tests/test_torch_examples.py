"""The port's examples (hypre_tpu_torch/examples) at the sizes and with
the assertions of tests/test_examples.py, on the CPU, each held to the
reference's iteration count where its main returns one.

The reference's counts (and ex_lobpcg's eigenvalues) come from
``python tools/ams_reference_counts.py examples 0``, which runs
examples/*.py at these sizes in its own process (~40 s: running them
here too would double this file's time)."""
import numpy as np
import pytest
import torch

from hypre_tpu_torch import Config, set_config
from hypre_tpu_torch.examples import (
    ex3_pfmg, ex5, ex6_multibox, ex9_systems, ex11, ex15_ams, ex_capi,
    ex_lobpcg, ex_struct,
)

torch.set_num_threads(1)
REF_ITERS = {"ex5": 11, "ex11": 20, "ex_struct": 7, "ex3_pfmg": 20,
             "ex15_ams": 16, "ex9_systems": [13, 13], "ex6_multibox": 28,
             "ex_capi": 5}
REF_LOBPCG = [0.06810760126439289, 0.1691093418234848, 0.16910934182348777]


@pytest.fixture(autouse=True)
def _cpu():
    set_config(Config(device="cpu"))
    yield


def test_ex5():
    res = ex5.main(n=20)
    assert float(res.relres) < 1e-7
    assert res.iters == REF_ITERS["ex5"]


def test_ex11():
    res = ex11.main(n=16, m=2)
    assert res.resnorms.max() < 1e-6
    assert res.iters == REF_ITERS["ex11"]


def test_ex_struct():
    res = ex_struct.main(n=16)
    assert float(res.relres) < 1e-7
    assert res.iters == REF_ITERS["ex_struct"]


def test_ex3_pfmg():
    it = ex3_pfmg.main(n=32)
    assert it < 40 and it == REF_ITERS["ex3_pfmg"]


def test_ex15_ams():
    it = ex15_ams.main(n=6)
    assert it < 60 and it == REF_ITERS["ex15_ams"]


def test_ex9_systems():
    it24 = ex9_systems.main(n=24)
    it48 = ex9_systems.main(n=48)
    # mesh-independent systems-AMG convergence
    assert it48 <= it24 + 4
    assert [it24, it48] == REF_ITERS["ex9_systems"]


def test_ex_lobpcg():
    got = ex_lobpcg.main(n=16, nev=3)
    np.testing.assert_allclose(got, REF_LOBPCG, rtol=1e-6)


def test_ex6_multibox():
    iters, rel = ex6_multibox.main(n=12)
    assert rel < 1e-7 and iters == REF_ITERS["ex6_multibox"]


def test_ex_capi():
    it = ex_capi.main(n=20)
    assert it < 40 and it == REF_ITERS["ex_capi"]
