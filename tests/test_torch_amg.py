"""The port's V-cycle against hypre_tpu's amg_cycle, f64 rel 1e-12.

Two routes: the reference hierarchy carried across by
convert.hierarchy_from_numpy (every level format the reference builds
on the CPU: GST-ELL, DIA, dense; the coarse LU with its pivots), and
the port's own setup.  Both cycles see the same right-hand side."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import LAPLACE_7PT, hierarchy_dicts, rel_diff

from hypre_tpu.gen import laplacian as ref_laplacian
from hypre_tpu.solvers import amg as ref_amg
from hypre_tpu_torch import Config, set_config
from hypre_tpu_torch.convert import hierarchy_from_numpy, lu_pivots_from_jax
from hypre_tpu_torch.gen import laplacian
from hypre_tpu_torch.solvers import amg as port_amg

torch.set_num_threads(1)
N = 24


@pytest.fixture(autouse=True)
def _cpu():
    set_config(Config(device="cpu"))
    yield


def _ref_setup(interp, coarsen, stencil, relax=18):
    A = ref_laplacian(N, N, N)
    cfg = ref_amg.AmgConfig(interp_type=interp, coarsen_type=coarsen,
                            relax_type=relax)
    return ref_amg.BoomerAMG(cfg).setup(
        A, fine_stencil=((N, N, N), LAPLACE_7PT) if stencil else None)


def _rhs():
    return np.random.default_rng(11).standard_normal(N ** 3)


CASES = [(6, "pmis", True), (6, "pmis", False), (3, "pmis", True),
         (6, "hmis", False), (3, "hmis", True)]


@pytest.mark.parametrize("interp,coarsen,stencil", CASES)
def test_carried_hierarchy_cycle_matches_reference(interp, coarsen,
                                                   stencil):
    ref = _ref_setup(interp, coarsen, stencil)
    h = ref.hierarchy
    port_h = hierarchy_from_numpy(hierarchy_dicts(h), np.asarray(h.c_lu),
                                  np.asarray(h.c_piv),
                                  relax_weight=h.relax_weight,
                                  num_sweeps=h.num_sweeps)
    f = _rhs()
    want = np.asarray(ref_amg.amg_cycle(h, jnp.asarray(f)))
    got = port_amg.amg_cycle(port_h, torch.from_numpy(f)).numpy()
    assert rel_diff(got, want) <= 1e-12


@pytest.mark.parametrize("relax", [18, 0, 7])
@pytest.mark.parametrize("interp,coarsen,stencil", CASES)
def test_port_setup_cycle_matches_reference(interp, coarsen, stencil,
                                            relax):
    ref = _ref_setup(interp, coarsen, stencil, relax)
    port = port_amg.BoomerAMG(port_amg.AmgConfig(
        interp_type=interp, coarsen_type=coarsen, relax_type=relax)).setup(
        laplacian(N, N, N),
        fine_stencil=((N, N, N), LAPLACE_7PT) if stencil else None)
    assert port.level_sizes == ref.level_sizes
    assert port.level_nnz == ref.level_nnz
    assert port.operator_complexity == ref.operator_complexity
    f = _rhs()
    want = np.asarray(ref.precondition(jnp.asarray(f)))
    got = port.precondition(torch.from_numpy(f)).numpy()
    assert rel_diff(got, want) <= 1e-12


def test_level_formats():
    port = port_amg.BoomerAMG(port_amg.AmgConfig(interp_type=6)).setup(
        laplacian(N, N, N), fine_stencil=((N, N, N), LAPLACE_7PT))
    assert port.level_formats == ["StencilOp", "CsrMatrix"] + \
        ["DenseMatrix"] * (len(port.level_sizes) - 2)
    plain = port_amg.BoomerAMG(port_amg.AmgConfig(interp_type=6)).setup(
        laplacian(N, N, N))
    # without the stencil, level 0 is stored as the reference stores it
    ref = _ref_setup(6, "pmis", False)
    assert type(ref.hierarchy.levels[0].A).__name__ == "DiaMatrix"
    assert plain.level_formats[0] == "DiaMatrix"


def test_lu_pivots_carry_across():
    """JAX's 0-based pivots, shifted to torch's 1-based convention,
    solve the system that JAX factored (a matrix that must pivot)."""
    rng = np.random.default_rng(2)
    M = rng.standard_normal((9, 9))
    M[0, 0] = 1e-12
    lu, piv = jax.scipy.linalg.lu_factor(jnp.asarray(M))
    assert int(np.asarray(piv)[-1]) == 8      # 0-based: last row is 8
    tpiv = lu_pivots_from_jax(piv)
    assert tpiv.dtype == torch.int32 and int(tpiv[-1]) == 9
    b = rng.standard_normal(9)
    x = torch.linalg.lu_solve(torch.from_numpy(np.array(lu)), tpiv,
                              torch.from_numpy(b)[:, None])[:, 0]
    np.testing.assert_allclose(M @ x.numpy(), b, rtol=1e-12, atol=1e-12)
    _, torch_piv = torch.linalg.lu_factor(torch.from_numpy(M))
    np.testing.assert_array_equal(tpiv.numpy(), torch_piv.numpy())


def test_standalone_solve_matches_reference():
    ref = _ref_setup(6, "pmis", True)
    port = port_amg.BoomerAMG(port_amg.AmgConfig(interp_type=6)).setup(
        laplacian(N, N, N), fine_stencil=((N, N, N), LAPLACE_7PT))
    b = np.ones(N ** 3)
    x_ref, it_ref, rel_ref = ref.solve(b, tol=1e-8, max_iter=50)
    x, it, rel = port.solve(b, tol=1e-8, max_iter=50)
    assert it == int(it_ref)
    assert abs(rel - float(rel_ref)) <= 1e-3 * float(rel_ref)
    assert rel_diff(x.numpy(), np.asarray(x_ref)) <= 1e-10
