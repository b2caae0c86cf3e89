"""The plain versions of the port's kernels against hypre_tpu's.

K1 (stencil matvec): stencil_matvec_plain against hypre_tpu's
stencil_matvec_reference, 7-pt and 27-pt stencils on grids that are not
powers of two, f64 and f32.  K2 (CSR SpMV): csr_spmv_plain on a real
24^3 level-1 operator carried across from its GST-ELL pack, against
gstell_matvec_reference on that pack.  Tolerances are relative to the
largest |A| |x| term: f64 1e-13, f32 1e-6 (the two sum in other orders).
K3 (DIA) has its own file, tests/test_torch_dia.py.  The kernels
themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch_port_helpers import (
    LAPLACE_27PT, LAPLACE_7PT, SPARSE_ARMS, STAR_13PT, assert_csr_equal,
    op_dict,
)

from hypre_tpu.ops import formats as ref_formats
from hypre_tpu.ops.gstell import gstell_from_scipy, gstell_matvec_reference
from hypre_tpu.ops.stencil_pallas import stencil_matvec_reference
from hypre_tpu.ops.stencil_pallas import stencil_op as ref_stencil_op
from hypre_tpu.solvers import amg as ref_amg
from hypre_tpu_torch import Config, set_config
from hypre_tpu_torch import convert
from hypre_tpu_torch.core.errors import HypreTpuError
from hypre_tpu_torch.gen import laplacian
from hypre_tpu_torch.ops import formats
from hypre_tpu_torch.ops.spmv import (
    CsrMatrix, csr_spmv, csr_spmv_plain, group_size,
)
from hypre_tpu_torch.ops.stencil import (
    kernel_instance, stencil_matvec, stencil_matvec_plain, stencil_op,
)

torch.set_num_threads(1)
TOL = {np.float64: 1e-13, np.float32: 1e-6}
TORCH = {np.float64: torch.float64, np.float32: torch.float32}


@pytest.fixture(autouse=True)
def _cpu():
    set_config(Config(device="cpu"))
    yield
    set_config(Config(device="cpu"))


def _close(y, y_ref, scale, dtype):
    y, y_ref, scale = (np.asarray(a).astype(np.float64)
                       for a in (y, y_ref, scale))
    err = np.abs(y - y_ref).max()
    assert err <= TOL[dtype] * np.abs(scale).max(), err


@pytest.fixture(scope="module")
def level1():
    """Level-1 operator (ext+i RAP) of the 24^3 Laplacian."""
    it = ref_amg.iter_host_hierarchy(laplacian(24, 24, 24),
                                     ref_amg.AmgConfig(interp_type=6))
    next(it)
    return next(it)[0]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("stencil", [LAPLACE_7PT, LAPLACE_27PT],
                         ids=["7pt", "27pt"])
@pytest.mark.parametrize("grid", [(13, 9, 7), (5, 11, 3), (1, 1, 17),
                                  (16, 8, 4)])
def test_stencil_plain_matches_reference(grid, stencil, dtype):
    x = np.random.default_rng(3).standard_normal(np.prod(grid)).astype(dtype)
    port = stencil_op(grid, stencil, dtype=TORCH[dtype])
    ref = ref_stencil_op(grid, stencil, dtype=dtype)
    y = stencil_matvec_plain(port, torch.from_numpy(x))
    y_ref = stencil_matvec_reference(ref, jnp.asarray(x))
    scale = stencil_matvec_plain(
        stencil_op(grid, [(d, abs(v)) for d, v in stencil],
                   dtype=torch.float64),
        torch.from_numpy(np.abs(x).astype(np.float64)))
    assert y.dtype == TORCH[dtype]
    _close(y, y_ref, scale, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("stencil", [SPARSE_ARMS, STAR_13PT],
                         ids=["sparse_arms", "star13"])
@pytest.mark.parametrize("grid", [(13, 9, 7), (2, 3, 1), (5, 1, 9)])
def test_stencil_plain_matches_reference_any_reach(grid, stencil, dtype):
    """The plain version on the stencils of K1's two instances: arms
    missing (reach 1) and a 13-pt star of reach 2, whose arms leave
    the (2, 3, 1) and (5, 1, 9) grids wholly."""
    x = np.random.default_rng(9).standard_normal(np.prod(grid)).astype(dtype)
    y = stencil_matvec_plain(stencil_op(grid, stencil, dtype=TORCH[dtype]),
                             torch.from_numpy(x))
    y_ref = stencil_matvec_reference(ref_stencil_op(grid, stencil,
                                                    dtype=dtype),
                                     jnp.asarray(x))
    scale = stencil_matvec_plain(
        stencil_op(grid, [(d, abs(v)) for d, v in stencil],
                   dtype=torch.float64),
        torch.from_numpy(np.abs(x).astype(np.float64)))
    _close(y, y_ref, scale, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("stencil", [LAPLACE_7PT, LAPLACE_27PT, SPARSE_ARMS,
                                     STAR_13PT, []],
                         ids=["7pt", "27pt", "sparse_arms", "star13",
                              "empty"])
def test_stencil_launch_args_keep_the_entries(stencil, dtype):
    """K1's packed argument: the offsets and values in the entries'
    order, in the op's type, built once per op."""
    op = stencil_op((9, 8, 7), stencil, dtype=dtype)
    args = op.launch_args
    k = len(stencil)
    assert args.dxyz.dtype == np.int32 and args.dxyz.shape == (max(k, 1), 3)
    assert args.vals.dtype == {torch.float64: np.float64,
                               torch.float32: np.float32}[dtype]
    assert [tuple(r) for r in args.dxyz[:k]] == [d for d, _ in stencil]
    np.testing.assert_array_equal(
        args.vals[:k], np.array([v for _, v in stencil], args.vals.dtype))
    assert args.dxyz_ptr == args.dxyz.ctypes.data
    assert args.vals_ptr == args.vals.ctypes.data
    assert op.launch_args is args
    assert args.instance == ("row" if stencil is STAR_13PT else "tile")


@pytest.mark.parametrize("grid,stencil,reach,instance", [
    ((256, 256, 256), LAPLACE_7PT, 1, "tile"),
    ((256, 256, 256), LAPLACE_27PT, 1, "tile"),
    ((13, 9, 7), STAR_13PT, 2, "row"),
    ((13, 9, 7), [((0, 0, -3), 1.0)], 3, "row"),
    ((13, 9, 7), [], 0, "tile"),
    ((1, 1_048_560, 1), LAPLACE_7PT, 1, "tile"),
    ((1, 1_048_561, 1), LAPLACE_7PT, 1, "row"),
    ((65_535, 32_768, 1), LAPLACE_7PT, 1, "tile"),
    ((65_536, 32_768, 1), LAPLACE_7PT, 1, "row"),
])
def test_stencil_kernel_instance(grid, stencil, reach, instance):
    """The tile instance takes reach 1, x-y planes under 2^31 cells and
    at most 65,535 tiles of 16 rows in y; the row instance the rest."""
    op = stencil_op(grid, stencil)
    assert op.reach == reach
    assert kernel_instance(op) == instance


def test_stencil_op_matches_generated_matrix():
    grid = (7, 6, 5)
    x = np.random.default_rng(4).standard_normal(np.prod(grid))
    A = laplacian(*grid)
    y = stencil_matvec_plain(stencil_op(grid, LAPLACE_7PT), torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), A @ x, rtol=1e-14, atol=1e-13)
    assert stencil_op(grid, LAPLACE_7PT).nnz == A.nnz


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_csr_plain_matches_gstell_reference(level1, dtype):
    packed = gstell_from_scipy(level1, dtype)
    assert packed is not None
    csr = convert.operator_from_numpy(op_dict(packed), dtype=TORCH[dtype])
    assert isinstance(csr, CsrMatrix)
    assert csr.indptr.dtype == torch.int64
    assert csr.indices.dtype == torch.int32
    x = np.random.default_rng(5).standard_normal(level1.shape[1]).astype(
        dtype)
    y = csr_spmv_plain(csr, torch.from_numpy(x))
    y_ref = gstell_matvec_reference(packed, jnp.asarray(x))
    scale = abs(level1) @ np.abs(x.astype(np.float64))
    _close(y, y_ref, scale, dtype)


def test_gstell_conversion_recovers_the_matrix(level1):
    packed = gstell_from_scipy(level1, np.float64)
    A = convert.scipy_from_gstell(np.asarray(packed.base),
                                  np.asarray(packed.locs),
                                  np.asarray(packed.vals), packed.n_rows,
                                  packed.n_cols)
    assert_csr_equal(A, level1.tocsr())


def test_ell_and_dia_conversions_recover_the_matrix(level1):
    ell = ref_formats.ell_from_scipy(level1, np.float64)
    assert_csr_equal(convert.scipy_from_ell(np.asarray(ell.cols),
                                            np.asarray(ell.vals),
                                            ell.n_cols), level1)
    A = laplacian(9, 8, 7)
    dia = ref_formats.dia_from_scipy(A, np.float64)
    port = convert.operator_from_numpy(op_dict(dia))
    assert isinstance(port, formats.DiaMatrix) and port.offsets == dia.offsets
    np.testing.assert_array_equal(port.vals.numpy(), np.asarray(dia.vals))
    x = np.random.default_rng(8).standard_normal(A.shape[1])
    np.testing.assert_allclose(formats.matvec(port, torch.from_numpy(x)),
                               A @ x, rtol=1e-13, atol=1e-13)


def test_stencil_and_dense_conversions():
    grid = (6, 5, 4)
    ref = ref_stencil_op(grid, LAPLACE_27PT, dtype=np.float64)
    port = convert.operator_from_numpy(op_dict(ref))
    assert port.grid == grid and port.entries == ref.entries
    B = sp.random(300, 170, density=0.05, random_state=1, format="csr")
    dense = convert.operator_from_numpy(
        op_dict(ref_formats.dense_from_scipy(B, np.float64)))
    assert isinstance(dense, formats.DenseMatrix) and dense.shape == B.shape
    np.testing.assert_array_equal(dense.vals.numpy(), B.toarray())


def test_sparse_op_dispatch_and_matvec(level1):
    small = laplacian(8, 8, 8)                       # 512 rows: dense
    op = formats.sparse_op_from_scipy(small)
    assert isinstance(op, formats.DenseMatrix)
    big = formats.sparse_op_from_scipy(level1)
    assert isinstance(big, CsrMatrix)
    x = np.random.default_rng(6).standard_normal(level1.shape[1])
    for A, M in ((op, small), (big, level1)):
        y = formats.matvec(A, torch.as_tensor(x[:M.shape[1]]))
        np.testing.assert_allclose(y.numpy(), M @ x[:M.shape[1]],
                                   rtol=1e-13, atol=1e-12)


def test_group_size_follows_mean_row_nnz():
    assert [group_size(100, 100 * k) for k in (1, 3, 4, 7, 8, 20, 40, 64,
                                                500)] == \
        [2, 2, 2, 4, 4, 8, 16, 32, 32]


def test_wrappers_take_the_plain_version_on_cpu():
    stencil_matvec.launches = csr_spmv.launches = 0
    op = stencil_op((4, 4, 4), LAPLACE_7PT)
    x = torch.ones(64, dtype=torch.float64)
    assert torch.equal(stencil_matvec(op, x), stencil_matvec_plain(op, x))
    A = formats.sparse_op_from_scipy(laplacian(64, 64, 1),
                                     prefer_dia=False)
    assert torch.equal(csr_spmv(A, torch.ones(4096, dtype=torch.float64)),
                       csr_spmv_plain(A, torch.ones(4096,
                                                    dtype=torch.float64)))
    assert stencil_matvec.launches == csr_spmv.launches == 0


def test_wrappers_raise_without_a_kernel():
    """Neither a CPU fallback nor a silent path: a tensor that is not on
    the CPU and has no kernel raises."""
    op = stencil_op((4, 4, 4), LAPLACE_7PT)
    with pytest.raises(HypreTpuError):
        stencil_matvec(op, torch.empty(64, dtype=torch.float64,
                                       device="meta"))
    A = formats.sparse_op_from_scipy(laplacian(64, 64, 1),
                                     prefer_dia=False)
    with pytest.raises(HypreTpuError):
        csr_spmv(A, torch.empty(4096, dtype=torch.float64, device="meta"))
