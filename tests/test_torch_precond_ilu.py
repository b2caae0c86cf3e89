"""The port's ILU family against hypre_tpu's.

Factors: L, U and the pivots of ILU(0), ILU(1) and ILUT equal the
reference's bit for bit, with the native setup on (both packages'
ilu_factor, the same C++) and off (both packages' numpy twin), on a
6^3 convection-diffusion operator (the twin is a Python loop).

Applies: the port's ILU rebuilt from the reference's factors
(hypre_tpu_torch.convert.ilu_from_numpy) applies within 1e-13 relative
of the reference's, with exact (wavefront) and truncated-Jacobi
triangular solves.

Solves: ILU-PCG (type 0, the ij driver's -solver 81) on the 13^3
Laplacian and ILU-GMRES (types 0, 1, 10, 20, 30 and 50; -solver 80
with -ilu_type) on a 13^3 convection-diffusion operator take the
reference's iteration counts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import set_native

from hypre_tpu.ops import sparse_op_from_scipy as ref_op
from hypre_tpu.solvers import ilu as ref_ilu
from hypre_tpu.solvers import krylov as ref_krylov
from hypre_tpu.solvers import krylov_more as ref_krylov_more
from hypre_tpu_torch import Config, convert, set_config
from hypre_tpu_torch.gen import difconv, laplacian
from hypre_tpu_torch.ops import sparse_op_from_scipy
from hypre_tpu_torch.solvers import ilu, krylov, krylov_more

torch.set_num_threads(1)
N = 13


@pytest.fixture(autouse=True)
def _cpu():
    set_config(Config(device="cpu"))
    yield


def _difconv(n):
    return difconv(n, n, n, ax=2.0, ay=-1.0, az=0.5)


FACTORS = {"ilu0": {}, "ilu1": {"fill_level": 1},
           "ilut": {"ilu_type": 1, "drop_tol": 1e-2}}


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("name", list(FACTORS))
def test_factors_are_the_references(monkeypatch, name, native):
    set_native(monkeypatch, native)
    A = _difconv(6)
    kw = FACTORS[name]
    want = ref_ilu.ILU(ref_ilu.IluConfig(**kw)).setup(A)._LU_scipy
    got = ilu.ILU(ilu.IluConfig(**kw)).setup(A)._LU_scipy
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        assert np.array_equal(g.indptr, w.indptr)
        assert np.array_equal(g.indices, w.indices)
        assert np.array_equal(g.data, w.data)
    assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("tri_solve", ["exact", "jacobi"])
def test_apply_from_reference_factors(tri_solve):
    A = _difconv(N)
    ref = ref_ilu.ILU(ref_ilu.IluConfig(tri_solve=tri_solve)).setup(A)
    L, ud, U = ref._LU_scipy
    port = convert.ilu_from_numpy(L, ud, U, ilu.IluConfig(
        tri_solve=tri_solve))
    r = np.random.default_rng(2).standard_normal(N ** 3)
    # jitted: eagerly the reference compiles one op per wavefront shape
    want = np.asarray(jax.jit(ref.precondition)(jnp.asarray(r)))
    got = port.precondition(torch.from_numpy(r)).numpy()
    assert np.linalg.norm(got - want) <= 1e-13 * np.linalg.norm(want)


@pytest.mark.parametrize("ilu_type", [0, 1, 10, 20, 30, 50, "pcg"])
def test_ilu_krylov_iterations(ilu_type):
    if ilu_type == "pcg":
        A, cfg = laplacian(N, N, N), {}
    else:
        A, cfg = _difconv(N), {"ilu_type": ilu_type}
    b = np.random.default_rng(7).standard_normal(N ** 3)
    ref_M = ref_ilu.ILU(ref_ilu.IluConfig(**cfg)).setup(A)
    port_M = ilu.ILU(ilu.IluConfig(**cfg)).setup(A)
    if ilu_type == "pcg":
        want = ref_krylov.pcg(ref_op(A), jnp.asarray(b),
                              M=ref_M.precondition, tol=1e-8, max_iter=500)
        got = krylov.pcg(sparse_op_from_scipy(A), b, M=port_M.precondition,
                         tol=1e-8, max_iter=500)
    else:
        want = ref_krylov_more.gmres(ref_op(A), jnp.asarray(b),
                                     M=ref_M.precondition, tol=1e-8,
                                     max_iter=500)
        got = krylov_more.gmres(sparse_op_from_scipy(A), b,
                                M=port_M.precondition, tol=1e-8,
                                max_iter=500)
    assert got.iters == int(want.iters) and got.relres <= 1e-8
