"""The port's AMS, ADS and AME against hypre_tpu's, in f64 on the CPU.

* Builders: maxwell_2d, derham_3d, maxwell_3d, rt0_3d and rt0_2d give
  the reference's CSR matrices (indptr, indices, data) bit for bit.
* AMS setup at maxwell_3d(5): the auxiliary matrices G^T A G and
  Pi^T A Pi with the reference's shifts, bit for bit, and their
  BoomerAMG hierarchies (CF, A, P, R on every level) bit for bit; the
  level sizes of both sub-AMGs equal the reference AMS's.
* One application: the port's AMS rebuilt from the reference's own
  state (convert.ams_from_numpy) and applied to one vector, within
  1e-12 relative of the reference's application (the sums run in other
  orders), at maxwell_3d(5) (dense operators) and maxwell_3d(9) (CSR
  transfers, DIA and CSR levels); an ADS likewise, with its inner AMS
  at rt0_3d(4) and with the 2D fallback's plain AMG at rt0_2d(10).
* Solves: AMS-PCG, ADS-PCG (2D fallback and 3D with the inner AMS) take
  the reference's iterations; AME at maxwell_3d(4) takes its iterations
  and its eigenvalues to 1e-8 relative.

The reference's cycles run inside its jitted PCG; its precondition
calls are jitted once here (eagerly XLA compiles one op at a time).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch_port_helpers import (
    assert_csr_equal, check_host_hierarchy, hierarchy_dicts, rel_diff,
)

from hypre_tpu.ops import sparse_op_from_scipy as ref_op
from hypre_tpu.solvers import ams as ref_ams
from hypre_tpu.solvers import pcg as ref_pcg
from hypre_tpu_torch import Config, convert, set_config
from hypre_tpu_torch.ops import sparse_op_from_scipy
from hypre_tpu_torch.solvers import ams, pcg

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    set_config(Config(device="cpu"))
    yield


BUILDERS = [("maxwell_2d", (6,)), ("maxwell_2d", (5, 0.25)),
            ("derham_3d", (4,)), ("maxwell_3d", (3, 0.5)),
            ("rt0_3d", (3,)), ("rt0_2d", (5,))]


@pytest.mark.parametrize("name,args", BUILDERS)
def test_builders_bit_for_bit(name, args):
    got = getattr(ams, name)(*args)
    want = getattr(ref_ams, name)(*args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert_csr_equal(g, w)


def _ref_shifted(M, rel):
    """The reference's inline shift (ams.py:66, :74), as it writes it."""
    return (M + sp.identity(M.shape[0]) * rel * abs(M.diagonal()).max()
            ).tocsr()


def test_ams_sub_hierarchies_bit_for_bit():
    A, G, Pi = ams.maxwell_3d(5)
    AG = ams.gradient_matrix(A, G)
    API = ams.nodal_vector_matrix(A, Pi)
    assert_csr_equal(AG, _ref_shifted((G.T @ A @ G).tocsr(), 1e-12))
    assert_csr_equal(API, _ref_shifted((Pi.T @ A @ Pi).tocsr(), 1e-10))
    check_host_hierarchy(AG, interp_type=6)
    check_host_hierarchy(API, interp_type=6)
    port = ams.AMS().setup(A, G, Pi)
    ref = ref_ams.AMS().setup(A, G, Pi)
    assert port.bg.level_sizes == ref.bg.level_sizes
    assert port.bpi.level_sizes == ref.bpi.level_sizes
    np.testing.assert_array_equal(port.dinv.numpy(), np.asarray(ref.dinv))


def _amg_dict(amg) -> dict:
    h = amg.hierarchy
    return {"levels": hierarchy_dicts(h), "c_lu": np.asarray(h.c_lu),
            "c_piv": np.asarray(h.c_piv)}


@pytest.mark.parametrize("n", [5, 9])
def test_ams_application_on_reference_state(n):
    A, G, Pi = ams.maxwell_3d(n)
    ref = ref_ams.AMS().setup(A, G, Pi)
    port = convert.ams_from_numpy(_amg_dict(ref.bg), _amg_dict(ref.bpi),
                                  G, Pi, np.asarray(ref.dinv), A=A)
    r = np.random.default_rng(3).standard_normal(A.shape[0])
    want = np.asarray(jax.jit(ref.precondition)(jnp.asarray(r)))
    got = port.precondition(torch.from_numpy(r)).numpy()
    assert rel_diff(got, want) <= 1e-12
    # the port's own setup makes the same application
    own = ams.AMS().setup(A, G, Pi).precondition(torch.from_numpy(r))
    assert rel_diff(own.numpy(), want) <= 1e-12


@pytest.mark.parametrize("dim", [2, 3])
def test_ads_application_on_reference_state(dim):
    if dim == 3:
        A, C, Pi, G, Pi_e = ams.rt0_3d(4)
        ref = ref_ams.ADS().setup(A, C, Pi, G=G, Pi_e=Pi_e)
        r_in = ref.bc_ams
        inner = convert.ams_from_numpy(
            _amg_dict(r_in.bg), _amg_dict(r_in.bpi), G, Pi_e,
            np.asarray(r_in.dinv))
    else:
        A, C, Pi = ams.rt0_2d(10)
        ref = ref_ams.ADS().setup(A, C, Pi)
        inner = _amg_dict(ref.bc_amg)
    port = convert.ams_from_numpy(None, _amg_dict(ref.bpi), C, Pi,
                                  np.asarray(ref.dinv), inner=inner)
    assert isinstance(port, ams.ADS)
    r = np.random.default_rng(4).standard_normal(A.shape[0])
    want = np.asarray(jax.jit(ref.precondition)(jnp.asarray(r)))
    got = port.precondition(torch.from_numpy(r)).numpy()
    assert rel_diff(got, want) <= 1e-12


def _iters(A, port_M, ref_M, max_iter=300):
    b = np.ones(A.shape[0])
    got = pcg(sparse_op_from_scipy(A), b, M=port_M, tol=1e-8,
              max_iter=max_iter)
    want = ref_pcg(ref_op(A), b, M=ref_M, tol=1e-8, max_iter=max_iter)
    x = got.x.numpy()
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) <= 1e-8
    assert rel_diff(x, np.asarray(want.x)) <= 1e-10
    return got.iters, int(want.iters)


AMS_CASES = [("maxwell_2d", 16, 1.0), ("maxwell_2d", 12, 0.01),
             ("maxwell_3d", 3, 1.0), ("maxwell_3d", 5, 1.0)]


@pytest.mark.parametrize("builder,n,beta", AMS_CASES)
def test_ams_pcg_iterations(builder, n, beta):
    A, G, Pi = getattr(ams, builder)(n, beta)
    got, want = _iters(A, ams.AMS().setup(A, G, Pi).precondition,
                       ref_ams.AMS().setup(A, G, Pi).precondition)
    assert got == want


def test_ads_2d_pcg_iterations():
    A, C, Pi = ams.rt0_2d(14)
    port = ams.ADS().setup(A, C, Pi)
    assert port.bc_amg is not None and port.bc_ams is None
    got, want = _iters(A, port.precondition,
                       ref_ams.ADS().setup(A, C, Pi).precondition)
    assert got == want


def test_ads_3d_pcg_iterations():
    A, C, Pi_f, G, Pi_e = ams.rt0_3d(3)
    port = ams.ADS().setup(A, C, Pi_f, G=G, Pi_e=Pi_e)
    ref = ref_ams.ADS().setup(A, C, Pi_f, G=G, Pi_e=Pi_e)
    assert port.bpi.level_sizes == ref.bpi.level_sizes
    assert port.bc_ams.bg.level_sizes == ref.bc_ams.bg.level_sizes
    got, want = _iters(A, port.precondition, ref.precondition)
    assert got == want


def test_ame_eigenvalues_and_iterations():
    A, G, Pi = ams.maxwell_3d(4)
    got = ams.AME().setup(A, G, Pi).solve(3, tol=1e-6, max_iter=80)
    want = ref_ams.AME().setup(A, G, Pi).solve(3, tol=1e-6, max_iter=80)
    assert got.iters == int(want.iters)
    lam, ref_lam = got.eigenvalues.numpy(), np.asarray(want.eigenvalues)
    np.testing.assert_allclose(lam, ref_lam, rtol=1e-8)
    assert (lam > 1.05).all()
