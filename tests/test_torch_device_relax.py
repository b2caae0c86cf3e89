"""The port's setup_device with relax 16 (Chebyshev) and 11 (two-stage
GS) against hypre_tpu's device setup, on the CPU.

The reference side chains hypre_tpu's stage functions
(torch_port_helpers.ref_device_hierarchy; its own setup_device pads
every level to 262,144 lanes and takes minutes here), then runs its
_chebyshev_setup_device on each level with the operator its
setup_device would hand it (the analytic stencil on level 0, its packed
DEll above).  The hierarchy must be the same bit for bit (CF, A, P, R
at every level and the coarsest A); the l1 diagonal bit for bit; L
and U are the strict triangles of A bit for bit; ds = 1/sqrt(|diag|)
bit for bit numpy's (the port's square root is correctly rounded,
core/ieee.py) and within 1e-15 relative of the reference's (XLA's CPU
1/sqrt is not correctly rounded, so an entry may part from numpy's in
the last bits); the Chebyshev bounds within 1e-12 relative, since the
power iteration's matvecs and norms sum in another order.  The start vector
is JAX's uniform draw, which core/threefry.py reproduces exactly
(test_torch_threefry.py)."""
import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch_port_helpers import (
    LAPLACE_7PT, assert_csr_equal, assert_ops_close, ref_device_hierarchy,
)

from hypre_tpu.ops.gstell import gstell_from_stencil
from hypre_tpu.ops.gstell_device import sparse_op_from_dell as ref_pack
from hypre_tpu.setup import device_amg as ref
from hypre_tpu.solvers import amg as ref_amg
from hypre_tpu_torch import Config, set_config
from hypre_tpu_torch.setup import device_amg as dev
from hypre_tpu_torch.solvers import AmgConfig, BoomerAMG, pcg

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    set_config(Config(device="cpu"))
    yield


@functools.lru_cache(maxsize=None)
def _ref_side(n):
    # the relax type does not change the hierarchy: one reference run
    # (most of this file's time, JAX compiles) serves every test
    return ref_device_hierarchy((n, n, n), LAPLACE_7PT)


def _setups(n, relax):
    shape = (n, n, n)
    ref_side = _ref_side(n)
    cfg = AmgConfig(interp_type=6, relax_type=relax)
    items = list(dev.iter_device_hierarchy(
        dev.dell_stencil(shape, LAPLACE_7PT), cfg))
    amg = BoomerAMG(cfg).setup_device(stencil=(shape, LAPLACE_7PT))
    return ref_side, items, amg


def _check_hierarchy(ref_side, items, amg):
    levels, coarsest = ref_side
    assert len(items) - 1 == len(levels) >= 2
    for lv, it in zip(levels, items[:-1]):
        np.testing.assert_array_equal(it[3].numpy(), lv[3])
        for k in range(3):
            assert_ops_close(lv[k], dev.dell_to_scipy(it[k]), tol=0.0)
    assert_ops_close(coarsest[0], dev.dell_to_scipy(items[-1]), tol=0.0)
    assert amg.level_sizes == [lv[0].shape[0] for lv in levels] + \
        [coarsest[0].shape[0]]


def test_device_chebyshev_matches_reference():
    n = 10
    ref_side, items, amg = _setups(n, 16)
    _check_hierarchy(ref_side, items, amg)
    for l, lv in enumerate(ref_side[0]):
        Md = ref.dell_from_scipy(lv[0], np.float64)
        A_op = (gstell_from_stencil((n, n, n), LAPLACE_7PT, np.float64)
                if l == 0 else ref_pack(Md, np.float64))
        ds_ref, b_ref = ref_amg._chebyshev_setup_device(A_op, Md, 0.3, 20)
        lvl = amg.hierarchy.levels[l]
        np.testing.assert_array_equal(
            lvl.cheby_ds.numpy(), 1.0 / np.sqrt(np.abs(lv[0].diagonal())))
        np.testing.assert_allclose(lvl.cheby_ds.numpy(), np.asarray(ds_ref),
                                   rtol=1e-15, atol=0)
        np.testing.assert_allclose(lvl.cheby_bounds, np.asarray(b_ref),
                                   rtol=1e-12, atol=0)
        np.testing.assert_array_equal(
            lvl.dinv.numpy(), 1.0 / np.asarray(ref.device_l1_norms(Md, 5)))
    res = pcg(amg.hierarchy.levels[0].A, np.ones(n ** 3), M=amg, tol=1e-8)
    assert res.relres <= 1e-8 and res.iters <= 12


@pytest.mark.parametrize("relax", [11, 12])
def test_device_two_stage_matches_reference(relax):
    n = 10
    ref_side, items, amg = _setups(n, relax)
    _check_hierarchy(ref_side, items, amg)
    for l, lv in enumerate(ref_side[0]):
        lvl = amg.hierarchy.levels[l]
        np.testing.assert_array_equal(lvl.L.vals.numpy(),
                                      np.tril(lv[0].toarray(), -1))
        np.testing.assert_array_equal(lvl.U.vals.numpy(),
                                      np.triu(lv[0].toarray(), 1))
    res = pcg(amg.hierarchy.levels[0].A, np.ones(n ** 3), M=amg, tol=1e-8)
    assert res.relres <= 1e-8 and res.iters <= 15


def test_device_two_stage_csr_levels():
    """Above 2048 rows L and U are CSR (kernel K2 on the card); the first
    row of L and the last of U are empty."""
    n = 14
    amg = BoomerAMG(AmgConfig(interp_type=6, relax_type=11)).setup_device(
        stencil=((n, n, n), LAPLACE_7PT))
    lvl = amg.hierarchy.levels[0]
    assert type(lvl.L).__name__ == "CsrMatrix"
    A = sp.csr_matrix(dev.dell_to_scipy(dev.dell_stencil((n, n, n),
                                                         LAPLACE_7PT)))
    for op, want in ((lvl.L, sp.tril(A, -1)), (lvl.U, sp.triu(A, 1))):
        got = sp.csr_matrix((op.values.numpy(), op.indices.numpy(),
                             op.indptr.numpy()), shape=op.shape)
        assert_csr_equal(got, want.tocsr())
    assert int(lvl.L.indptr[1]) == 0
    assert int(lvl.U.indptr[-1] - lvl.U.indptr[-2]) == 0
