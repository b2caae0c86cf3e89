"""The port's LOBPCG and matmat against hypre_tpu's.

LOBPCG: the 13^3 Laplacian stored as CSR in the port (GST-ELL in the
reference, prefer_dia=False), so the block products run K2-NV's plain
version against the reference's vmapped SpMV; a block of 4 from a numpy
seed; preconditioned by BoomerAMG (HMIS, ext+i, l1-Jacobi) or by the
diagonal.  Iterations must be equal and the eigenvalues agree to 1e-10
relative.  Residual norms agree to 1e-6 relative plus 1e-10, taken as
one norm per cluster of equal eigenvalues: the second eigenvalue is
triple, and inside its eigenspace the split of the residual among the
three Ritz vectors depends on the basis, which rounding turns (the
single norms part by 3% with AMG).  The 1e-10 floor is four decades
under the stop tolerance: after ~60 diagonally scaled iterations the
triple's norm of 8.3e-7 parts by 1.4e-11 between the packages, the
last-bit differences of their dots grown over the run, and residuals of
~1e-10 (the first pair's with AMG) are that close to round-off.

matmat: Y = A X on CSR, DIA and dense operators at nv = 1, 3 and 12
against the reference's matmat (1e-13 of the largest |A| |X| term; the
sums run in other orders).  The vector and multivector vtables
(ops/vector.py, ops/multivector.py) against the reference's, to 1e-14
relative (dots and Gram blocks sum in other orders)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.gen import laplacian as ref_laplacian
from hypre_tpu.ops import formats as ref_formats
from hypre_tpu.ops import multivector as ref_multivector
from hypre_tpu.ops import vector as ref_vector
from hypre_tpu.solvers import amg as ref_amg
from hypre_tpu.solvers.lobpcg import lobpcg as ref_lobpcg
from hypre_tpu_torch import Config, set_config
from hypre_tpu_torch.gen import laplacian
from hypre_tpu_torch.ops import formats, multivector, vector
from hypre_tpu_torch.ops.dia import DiaMatrix
from hypre_tpu_torch.ops.spmv import CsrMatrix
from hypre_tpu_torch.solvers import amg as port_amg
from hypre_tpu_torch.solvers.lobpcg import lobpcg

torch.set_num_threads(1)
N = 13
AMG = dict(coarsen_type="hmis", interp_type=6, relax_type=18)


@pytest.fixture(autouse=True)
def _cpu():
    set_config(Config(device="cpu"))
    yield


def _clusters(lam):
    """Index groups of eigenvalues equal to 1e-8 relative."""
    groups = [[0]]
    for i in range(1, len(lam)):
        if abs(lam[i] - lam[groups[-1][0]]) <= 1e-8 * abs(lam[i]):
            groups[-1].append(i)
        else:
            groups.append([i])
    return groups


@pytest.mark.parametrize("precond", ["amg", "ds"])
def test_lobpcg_matches_reference(precond):
    A = ref_laplacian(N, N, N)
    X0 = np.random.RandomState(7).rand(N ** 3, 4)
    if precond == "amg":
        ref_M = ref_amg.BoomerAMG(ref_amg.AmgConfig(**AMG)).setup(A)
        port_M = port_amg.BoomerAMG(port_amg.AmgConfig(**AMG)).setup(
            laplacian(N, N, N))
    else:
        dinv = 1.0 / A.diagonal()
        ref_M = lambda r: jnp.asarray(dinv) * r  # noqa: E731
        port_M = lambda r: torch.from_numpy(dinv) * r  # noqa: E731
    want = ref_lobpcg(ref_formats.sparse_op_from_scipy(A, prefer_dia=False),
                      X0, M=ref_M, tol=1e-6, max_iter=100)
    op = formats.sparse_op_from_scipy(laplacian(N, N, N), prefer_dia=False)
    assert isinstance(op, CsrMatrix)
    got = lobpcg(op, X0, M=port_M, tol=1e-6, max_iter=100)
    assert got.iters == int(want.iters) and got.iters < 99
    lam_w = np.asarray(want.eigenvalues)
    np.testing.assert_allclose(got.eigenvalues.numpy(), lam_w, rtol=1e-10)
    res_g, res_w = got.resnorms.numpy(), np.asarray(want.resnorms)
    for idx in _clusters(lam_w):
        g, w = np.linalg.norm(res_g[idx]), np.linalg.norm(res_w[idx])
        assert abs(g - w) <= 1e-6 * w + 1e-10
    assert max(res_g) < 1e-6


def _operators(kind):
    if kind == "dense":
        A = laplacian(10, 10, 10)
        return A, ref_formats.sparse_op_from_scipy(A), \
            formats.sparse_op_from_scipy(A), formats.DenseMatrix
    if kind == "dia":
        A = laplacian(N, N, N)
        return A, ref_formats.sparse_op_from_scipy(A), \
            formats.sparse_op_from_scipy(A), DiaMatrix
    rng = np.random.default_rng(3)
    A = laplacian(N, N, N).tocsr()
    A.data = A.data * (1.0 + rng.random(A.nnz))     # unequal entries
    return A, ref_formats.sparse_op_from_scipy(A, prefer_dia=False), \
        formats.sparse_op_from_scipy(A, prefer_dia=False), CsrMatrix


@pytest.mark.parametrize("nv", [1, 3, 12])
@pytest.mark.parametrize("kind", ["csr", "dia", "dense"])
def test_matmat_matches_reference(kind, nv):
    A, ref_op, op, cls = _operators(kind)
    assert isinstance(op, cls)
    X = np.random.default_rng(nv).standard_normal((A.shape[1], nv))
    want = np.asarray(ref_formats.matmat(ref_op, jnp.asarray(X)))
    got = formats.matmat(op, torch.from_numpy(X)).numpy()
    scale = np.abs(A) @ np.abs(X)
    assert got.shape == want.shape == (A.shape[0], nv)
    assert np.abs(got - want).max() <= 1e-13 * scale.max()


VTABLE = {"vector": ["dot", "norm2", "axpy", "scale", "copy", "clear"],
          "multivector": ["multi_inner_prod", "multi_inner_prod_diag",
                          "multi_vec_mat", "multi_axpy", "multi_scale",
                          "multi_clear"]}


def _vtable_args(name, rng):
    x, y = rng.standard_normal(50), rng.standard_normal(50)
    X, Y = rng.standard_normal((50, 4)), rng.standard_normal((50, 4))
    return {"dot": (x, y), "norm2": (x,), "axpy": (0.7, x, y),
            "scale": (-1.3, x), "copy": (x,), "clear": (x,),
            "multi_inner_prod": (X, Y), "multi_inner_prod_diag": (X, Y),
            "multi_vec_mat": (X, rng.standard_normal((4, 3))),
            "multi_axpy": (0.7, X, Y), "multi_scale": (rng.random(4), X),
            "multi_clear": (X,)}[name]


@pytest.mark.parametrize("module,name", [(m, f) for m, fs in VTABLE.items()
                                         for f in fs])
def test_vtable_matches_reference(module, name):
    args = _vtable_args(name, np.random.default_rng(len(name)))
    ref = {"vector": ref_vector, "multivector": ref_multivector}[module]
    port = {"vector": vector, "multivector": multivector}[module]
    want = np.asarray(getattr(ref, name)(*[
        jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]))
    got = getattr(port, name)(*[
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a
        for a in args])
    got = np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14)
