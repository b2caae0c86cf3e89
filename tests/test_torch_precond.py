"""The port's FSAI, ParaSails, Schwarz, hybrid and MGR against hypre_tpu's.

Setups: FSAI's G (adaptive and static) and ParaSails' M (nonsymmetric;
the symmetric mode is FSAI's static G) equal the reference's bit for
bit, native setup on and off: the port solves the little systems with
the LAPACK and BLAS calls of the reference's jnp.linalg.solve
(hypre_tpu_torch/setup/lapack.py).  Schwarz's block inverses are
numpy's in both, bit for bit.

Applies: each preconditioner is rebuilt in the port from the
reference's own state (hypre_tpu_torch.convert) and applied to one
vector: within 1e-13 relative of the reference's apply (the sums run in
other orders).

Solves: FSAI-PCG, ParaSails-PCG/GMRES, Schwarz-PCG, the hybrid solver
and MGR-GMRES take the reference's iteration counts (the hybrid solver
both its DSCG and PCG counts).  Operators: the 13^3 Laplacian (DIA in
both packages; G, M and the Schwarz blocks CSR) and, for MGR,
tests/test_mgr.py's two-field system."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from test_mgr import coupled_system as ref_coupled_system
from torch_port_helpers import set_native

from hypre_tpu.gen import laplacian as ref_laplacian
from hypre_tpu.ops import sparse_op_from_scipy as ref_op
from hypre_tpu.solvers import amg as ref_amg
from hypre_tpu.solvers import fsai as ref_fsai
from hypre_tpu.solvers import hybrid as ref_hybrid
from hypre_tpu.solvers import krylov as ref_krylov
from hypre_tpu.solvers import krylov_more as ref_krylov_more
from hypre_tpu.solvers import mgr as ref_mgr
from hypre_tpu.solvers import parasails as ref_parasails
from hypre_tpu.solvers import schwarz as ref_schwarz
from hypre_tpu_torch import Config, convert, set_config
from hypre_tpu_torch.gen import laplacian
from hypre_tpu_torch.ops import sparse_op_from_scipy
from hypre_tpu_torch.solvers import (
    amg as port_amg, fsai, hybrid, krylov, krylov_more, mgr, parasails,
    schwarz,
)

torch.set_num_threads(1)
N = 13
AMG = dict(coarsen_type="hmis", interp_type=6, relax_type=18)


@pytest.fixture(autouse=True)
def _cpu():
    set_config(Config(device="cpu"))
    yield


@pytest.fixture(scope="module")
def lap():
    return laplacian(N, N, N)


def _b(n, seed=11):
    return np.random.default_rng(seed).standard_normal(n)


def assert_same_matrix(got, want):
    got, want = sp.csr_matrix(got), sp.csr_matrix(want)
    got.sort_indices()
    want.sort_indices()
    assert np.array_equal(got.indptr, want.indptr)
    assert np.array_equal(got.indices, want.indices)
    assert np.array_equal(got.data, want.data)


def assert_apply_close(got, want, tol=1e-13):
    want = np.asarray(want)
    assert np.linalg.norm(got.numpy() - want) <= tol * np.linalg.norm(want)


FSAI_CONFIGS = {"adaptive": {}, "static": {"algo_type": "static"},
                "static2": {"algo_type": "static", "num_levels": 2,
                            "max_row_nnz": 12}}


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("name", list(FSAI_CONFIGS))
def test_fsai_g_matches_reference(monkeypatch, name, native):
    set_native(monkeypatch, native)
    # the native-off twin solves system by system: a smaller grid
    lap = laplacian(*((N, N, N) if native else (9, 9, 9)))
    kw = FSAI_CONFIGS[name]
    want = ref_fsai.FSAI(ref_fsai.FsaiConfig(**kw)).setup(lap)._G_scipy
    got = fsai.FSAI(fsai.FsaiConfig(**kw)).setup(lap)._G_scipy
    assert_same_matrix(got, want)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("sym", [False, True])
def test_parasails_matches_reference(monkeypatch, sym, native):
    set_native(monkeypatch, native)
    lap = laplacian(*((N, N, N) if native else (9, 9, 9)))
    cfg = dict(sym=sym)
    ref = ref_parasails.ParaSails(ref_parasails.ParaSailsConfig(**cfg))
    got = parasails.ParaSails(parasails.ParaSailsConfig(**cfg)).setup(lap)
    ref.setup(lap)
    if sym:
        assert_same_matrix(got._fsai._G_scipy, ref._fsai._G_scipy)
    else:
        assert_same_matrix(got._M_scipy, ref._M_scipy)


def test_schwarz_block_inverses_are_the_references(lap):
    want = ref_schwarz.Schwarz().setup(lap)
    got = schwarz.Schwarz().setup(lap)
    assert np.array_equal(got.block_inv.numpy(), np.asarray(want.block_inv))
    assert np.array_equal(got.starts, want.starts)
    assert got._damp == want._damp


def _ref_preconditioners(lap):
    f = ref_fsai.FSAI().setup(lap)
    p = ref_parasails.ParaSails().setup(lap)
    ps = ref_parasails.ParaSails(ref_parasails.ParaSailsConfig(
        sym=True)).setup(lap)
    out = {"fsai": (f, convert.fsai_from_numpy(f._G_scipy)),
           "parasails": (p, convert.parasails_from_numpy(M=p._M_scipy)),
           "parasails_sym": (ps, convert.parasails_from_numpy(
               G=ps._fsai._G_scipy))}
    for variant in ("additive", "multiplicative", "sym-multiplicative"):
        s = ref_schwarz.Schwarz(ref_schwarz.SchwarzConfig(
            variant=variant)).setup(lap)
        out[f"schwarz_{variant}"] = (s, convert.schwarz_from_numpy(
            np.asarray(s.block_inv), s.starts, s.n,
            schwarz.SchwarzConfig(variant=variant), A=lap))
    return out


APPLIES = ["fsai", "parasails", "parasails_sym", "schwarz_additive",
           "schwarz_multiplicative", "schwarz_sym-multiplicative"]


@pytest.fixture(scope="module")
def ref_preconditioners(lap):
    set_config(Config(device="cpu"))
    return _ref_preconditioners(lap)


@pytest.mark.parametrize("name", APPLIES)
def test_apply_from_reference_state(ref_preconditioners, name):
    ref, port = ref_preconditioners[name]
    r = _b(N ** 3)
    assert_apply_close(port.precondition(torch.from_numpy(r)),
                       ref.precondition(jnp.asarray(r)))


# ij solver id: (preconditioner, Krylov solver)
SOLVES = {43: ("fsai", "pcg"), 8: ("parasails_sym", "pcg"),
          18: ("parasails", "gmres"), 12: ("schwarz_additive", "pcg")}


def _build(pkg_fsai, pkg_parasails, pkg_schwarz, name, A):
    if name == "fsai":
        return pkg_fsai.FSAI().setup(A)
    if name.startswith("parasails"):
        return pkg_parasails.ParaSails(pkg_parasails.ParaSailsConfig(
            sym=name.endswith("sym"))).setup(A)
    return pkg_schwarz.Schwarz().setup(A)


@pytest.mark.parametrize("solver_id", list(SOLVES))
def test_preconditioned_solve_iterations(lap, solver_id):
    name, method = SOLVES[solver_id]
    b = _b(N ** 3, seed=solver_id)
    ref_fn = ref_krylov.pcg if method == "pcg" else ref_krylov_more.gmres
    port_fn = krylov.pcg if method == "pcg" else krylov_more.gmres
    want = ref_fn(ref_op(lap), jnp.asarray(b), M=_build(
        ref_fsai, ref_parasails, ref_schwarz, name, lap).precondition,
        tol=1e-8, max_iter=500)
    got = port_fn(sparse_op_from_scipy(lap), b, M=_build(
        fsai, parasails, schwarz, name, lap).precondition, tol=1e-8,
        max_iter=500)
    assert got.iters == int(want.iters) and got.relres <= 1e-8


@pytest.mark.parametrize("cf_tol,switch", [(0.8, True), (0.9, False)])
def test_hybrid_iterations(cf_tol, switch):
    A = laplacian(N, N, N)
    b = _b(N ** 3, seed=3)
    want = ref_hybrid.hybrid_solve(A, b, ref_hybrid.HybridConfig(
        cf_tol=cf_tol, amg=ref_amg.AmgConfig(**AMG)))
    got = hybrid.hybrid_solve(A, b, hybrid.HybridConfig(
        cf_tol=cf_tol, amg=port_amg.AmgConfig(**AMG)))
    assert (got.dscg_iters, got.pcg_iters) == (want.dscg_iters,
                                               want.pcg_iters)
    assert (got.pcg_iters > 0) == switch and got.relres <= 1e-8


MGR_CONFIGS = {"jacobi": {},
               "l1jacobi_diag": {"f_relax_type": "l1jacobi",
                                 "restrict_type": 2, "f_relax_sweeps": 2},
               "amg_frelax": {"f_relax_type": "amg", "interp_type": 0}}


@pytest.mark.parametrize("name", list(MGR_CONFIGS))
def test_mgr_gmres_iterations(name):
    A, c_mask = ref_coupled_system(16)
    b = np.ones(A.shape[0])
    kw = MGR_CONFIGS[name]
    want_mgr = ref_mgr.MGR(ref_mgr.MgrConfig(**kw)).setup(A, c_mask)
    want = ref_krylov_more.gmres(ref_op(A), jnp.asarray(b),
                                 M=want_mgr.precondition, tol=1e-8,
                                 max_iter=200)
    got_mgr = mgr.MGR(mgr.MgrConfig(**kw)).setup(A, c_mask)
    got = krylov_more.gmres(sparse_op_from_scipy(A), b,
                            M=got_mgr.precondition, tol=1e-8, max_iter=200)
    assert got_mgr.level_sizes == want_mgr.level_sizes
    assert got.iters == int(want.iters) and got.relres <= 1e-8


def test_chip_smoke_rebuilds_the_mgr_system():
    import chip_smoke

    A, c_mask = ref_coupled_system(16)
    got, got_mask = chip_smoke.mgr_coupled_system(16)
    assert (got != A).nnz == 0 and np.array_equal(got_mask, c_mask)
