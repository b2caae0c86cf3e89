"""ops/block_ell.py (plain torch) against hypre_tpu/ops/block_ell.py on
the coupled systems problem of tests/test_systems.py, f64: the packed
arrays exactly, the block matvec, matmat, diagonal-block inverses and a
block-Jacobi sweep to 1e-13 relative (einsum sums in its own order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import coupled_system, rel_diff

from hypre_tpu.ops import block_ell as ref
from hypre_tpu_torch import Config, set_config
from hypre_tpu_torch.ops import block_ell as port

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    set_config(Config(device="cpu"))
    yield


@pytest.mark.parametrize("nf", [2, 3])
def test_block_ell_matches_reference(nf):
    A = coupled_system(7, nf=nf, eps=0.2)
    R = ref.block_ell_from_scipy(A, nf, np.float64)
    B = port.block_ell_from_scipy(A, nf)
    np.testing.assert_array_equal(B.cols.numpy(), np.asarray(R.cols))
    np.testing.assert_array_equal(B.vals.numpy(), np.asarray(R.vals))
    assert B.shape == R.shape == A.shape
    rng = np.random.default_rng(nf)
    x = rng.standard_normal(A.shape[1])
    X = rng.standard_normal((A.shape[1], 4))
    y = port.block_matvec(B, torch.from_numpy(x)).numpy()
    assert rel_diff(y, A @ x) <= 1e-13
    assert rel_diff(y, np.asarray(ref.block_matvec(R, jnp.asarray(x)))) \
        <= 1e-13
    assert rel_diff(port.block_matmat(B, torch.from_numpy(X)).numpy(),
                    np.asarray(ref.block_matmat(R, jnp.asarray(X)))) <= 1e-13
    D = port.block_diag_inv(B)
    D_ref = np.asarray(ref.block_diag_inv(R))
    assert rel_diff(D.numpy(), D_ref) <= 1e-13
    b = rng.standard_normal(A.shape[0])
    u = port.block_jacobi(B, D, torch.from_numpy(b), weight=0.8, sweeps=3)
    u_ref = ref.block_jacobi(R, jnp.asarray(D_ref), jnp.asarray(b),
                             weight=0.8, sweeps=3)
    assert rel_diff(u.numpy(), np.asarray(u_ref)) <= 1e-13
