"""The port's SStruct Maxwell solver against hypre_tpu's, in f64 on the
CPU.

* The Reitzinger-Schoeberl pieces: ``_strongest_col`` and
  ``_rs_edge_interp`` bit for bit, and the commuting relation
  Pe G_c = G P_agg of tests/test_maxwell.py on the port's output.
* The edge hierarchy at maxwell_3d(6): each level's A, G and Pe bit for
  bit (the same host setup: the port's strength, PMIS and direct
  interpolation are the reference's), the inverse l1 norms bit for bit,
  the coarse pseudo-inverse to 1e-12 relative.
* One V-cycle within 1e-12 relative of the reference's, from the port's
  own setup and from the reference's state (convert.maxwell_from_numpy).
* SStructMaxwell-PCG takes the reference's iterations at (8, beta 1) and
  (6, beta 0.01).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch_port_helpers import assert_csr_equal, op_dict, rel_diff

from hypre_tpu.ops import sparse_op_from_scipy as ref_op
from hypre_tpu.solvers import maxwell as ref_maxwell
from hypre_tpu.solvers import pcg as ref_pcg
from hypre_tpu.solvers.ams import derham_3d, maxwell_3d
from hypre_tpu_torch import Config, convert, set_config
from hypre_tpu_torch.ops import sparse_op_from_scipy
from hypre_tpu_torch.ops.formats import DenseMatrix
from hypre_tpu_torch.ops.spmv import CsrMatrix
from hypre_tpu_torch.solvers import maxwell, pcg
from hypre_tpu_torch.sstruct import MaxwellConfig, SStructMaxwell

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    set_config(Config(device="cpu"))
    yield


def test_sstruct_reexports_maxwell():
    assert SStructMaxwell is maxwell.SStructMaxwell
    assert MaxwellConfig is maxwell.MaxwellConfig


@pytest.mark.parametrize("seed", [0, 1])
def test_strongest_col_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    P = sp.random(300, 80, density=0.04, random_state=rng, format="csr")
    P.data -= 0.5
    # ties in |entry|: the first column in the row wins in both
    P.data[::7] = 0.25
    np.testing.assert_array_equal(maxwell._strongest_col(P),
                                  ref_maxwell._strongest_col(P))


def test_rs_edges_bit_for_bit_and_commute():
    G, C, D, Pi_e, Pi_f = derham_3d(4)
    nn = G.shape[1]
    agg = (np.arange(nn) // 5) % (nn // 5 + 1)
    n_c = int(agg.max()) + 1
    Gc, Pe = maxwell._rs_edge_interp(G, agg, n_c)
    Gc_ref, Pe_ref = ref_maxwell._rs_edge_interp(G, agg, n_c)
    assert_csr_equal(Gc, Gc_ref)
    assert_csr_equal(Pe, Pe_ref)
    v = np.random.RandomState(0).rand(n_c)
    assert np.allclose(Pe @ (Gc @ v), G @ v[agg], atol=1e-12)


def _dense(op) -> np.ndarray:
    if isinstance(op, DenseMatrix):
        return op.vals.numpy()
    assert isinstance(op, CsrMatrix)
    return sp.csr_matrix((op.values.numpy(), op.indices.numpy(),
                          op.indptr.numpy()), shape=op.shape).toarray()


def _ref_dense(op) -> np.ndarray:
    return _dense(convert.operator_from_numpy(op_dict(op)))


@pytest.fixture(scope="module")
def mx6():
    set_config(Config(device="cpu"))
    A, G, _ = maxwell_3d(6)
    return (A, G, SStructMaxwell().setup(A, G),
            ref_maxwell.SStructMaxwell().setup(A, G))


def test_levels_bit_for_bit(mx6):
    A, G, port, ref = mx6
    assert len(port.levels) == len(ref.levels) >= 3
    for got, want in zip(port.levels, ref.levels):
        for key in ("A", "G", "GT", "Pe", "PeT"):
            if want[key] is None:
                assert got[key] is None
                continue
            np.testing.assert_array_equal(_dense(got[key]),
                                          _ref_dense(want[key]))
        for key in ("de", "dn"):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
    assert rel_diff(port.c_inv.numpy(), np.asarray(ref.c_inv)) <= 1e-12


def _ref_levels(ref) -> list:
    return [{k: (None if lvl[k] is None else op_dict(lvl[k]))
             for k in ("A", "G", "GT", "Pe", "PeT")}
            | {"de": np.asarray(lvl["de"]), "dn": np.asarray(lvl["dn"])}
            for lvl in ref.levels]


def test_cycle_matches_reference(mx6):
    A, G, port, ref = mx6
    r = np.random.default_rng(5).standard_normal(A.shape[0])
    want = np.asarray(jax.jit(ref.precondition)(jnp.asarray(r)))
    got = port.precondition(torch.from_numpy(r)).numpy()
    assert rel_diff(got, want) <= 1e-12
    carried = convert.maxwell_from_numpy(_ref_levels(ref),
                                         np.asarray(ref.c_inv))
    got = carried.precondition(torch.from_numpy(r)).numpy()
    assert rel_diff(got, want) <= 1e-12


@pytest.mark.parametrize("n,beta", [(8, 1.0), (6, 0.01)])
def test_pcg_iterations(n, beta):
    A, G, _ = maxwell_3d(n, beta)
    b = np.ones(A.shape[0])
    got = pcg(sparse_op_from_scipy(A), b,
              M=SStructMaxwell().setup(A, G).precondition, tol=1e-8,
              max_iter=150)
    want = ref_pcg(ref_op(A), b,
                   M=ref_maxwell.SStructMaxwell().setup(A, G).precondition,
                   tol=1e-8, max_iter=150)
    assert got.iters == int(want.iters)
    x = got.x.numpy()
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) <= 1e-8
    assert rel_diff(x, np.asarray(want.x)) <= 1e-10
