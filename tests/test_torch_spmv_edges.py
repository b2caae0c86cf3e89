"""K2's thread groups and the plain CSR matvec on the row-length
patterns that K2 must handle, on the CPU.

group_size gives each operator the threads a row that K2 runs with: a
power of two in [2, 32], the same from both packers (csr_from_scipy and,
through the device setup's DEll, csr_from_dell).  The plain version,
csr_spmv_plain, is held against scipy and, where the reference packs
the matrix as GST-ELL, against hypre_tpu's gstell_matvec_reference, on
empty rows, a row of 100,003 nonzeros among short ones, rows of
thousands of nonzeros beside one-entry rows, one row and no rows
(tolerance: 1e-13 of the largest |A| |x| term in f64, 1e-6 in f32; the
sums run in other orders).  The kernel itself runs on these patterns in
tests/test_torch_cuda.py.

K2-NV's plain version, csr_spmm_plain, is held on the same patterns
against scipy's A X and, column by column, against csr_spmv_plain (bit
for bit: it is K2's plain version on each column), at nv = 1, 3, 12,
with the column panels K2-NV launches for each nv (nv_panels) covering
it."""
import numpy as np
import pytest
import torch
from torch_port_helpers import EDGE_CSR, edge_csr

from hypre_tpu.ops.gstell import gstell_from_scipy, gstell_matvec_reference
from hypre_tpu_torch import Config, set_config
from hypre_tpu_torch.gen import laplacian
from hypre_tpu_torch.ops.formats import csr_from_dell
from hypre_tpu_torch.ops.spmv import (
    MAX_PIECES, csr_from_scipy, csr_spmm_plain, csr_spmv_plain, group_size,
    nv_panels,
)
from hypre_tpu_torch.setup import device_amg as dev

torch.set_num_threads(1)
TORCH = {np.float64: torch.float64, np.float32: torch.float32}


@pytest.fixture(autouse=True)
def _cpu():
    set_config(Config(device="cpu"))
    yield
    set_config(Config(device="cpu"))


@pytest.mark.parametrize("name", EDGE_CSR)
def test_group_is_a_power_of_two_in_range(name):
    A = edge_csr(name)
    g = csr_from_scipy(A, torch.float64, "cpu").group
    assert g in (2, 4, 8, 16, 32)
    assert g == group_size(A.shape[0], A.nnz)


@pytest.mark.parametrize("name", ["empty_rows", "long_next_to_short",
                                  "one_row", "all_empty", "laplacian"])
def test_packers_give_the_same_operator(name):
    A = laplacian(9, 8, 7) if name == "laplacian" else edge_csr(
        name, long_len=3000)
    a = csr_from_scipy(A, torch.float64, "cpu")
    b = csr_from_dell(dev.dell_from_scipy(A, device="cpu"), torch.float64)
    assert torch.equal(a.indptr, b.indptr)
    assert torch.equal(a.indices, b.indices)
    assert torch.equal(a.values, b.values)
    assert a.group == b.group


def test_group_grows_with_the_row_length():
    gs = [group_size(1000, 1000 * k) for k in range(1, 200)]
    assert gs == sorted(gs) and gs[0] == 2 and gs[-1] == 32


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", [n for n in EDGE_CSR if n != "no_rows"])
def test_csr_plain_on_edge_rows(name, dtype):
    A = edge_csr(name, seed=3)
    x = np.random.default_rng(4).standard_normal(A.shape[1]).astype(dtype)
    M = csr_from_scipy(A, TORCH[dtype], "cpu")
    y = csr_spmv_plain(M, torch.from_numpy(x)).numpy().astype(np.float64)
    scale = max(float((abs(A) @ np.abs(x.astype(np.float64))).max(
        initial=0.0)), 1e-300)
    tol = {np.float64: 1e-13, np.float32: 1e-6}[dtype]
    assert np.abs(y - A.astype(dtype) @ x).max(initial=0.0) <= tol * scale
    packed = gstell_from_scipy(A, dtype) if A.nnz else None
    if packed is not None:
        y_ref = np.asarray(gstell_matvec_reference(packed, x))
        assert np.abs(y - y_ref).max(initial=0.0) <= tol * scale


def test_csr_plain_with_no_rows():
    A = edge_csr("no_rows")
    M = csr_from_scipy(A, torch.float64, "cpu")
    y = csr_spmv_plain(M, torch.ones(A.shape[1], dtype=torch.float64))
    assert y.shape == (0,)


@pytest.mark.parametrize("nv", [1, 3, 12])
@pytest.mark.parametrize("name", [n for n in EDGE_CSR if n != "long_row"])
def test_csr_spmm_plain_on_edge_rows(name, nv):
    A = edge_csr(name, seed=5, long_len=3000)
    X = np.random.default_rng(nv).standard_normal((A.shape[1], nv))
    M = csr_from_scipy(A, torch.float64, "cpu")
    Y = csr_spmm_plain(M, torch.from_numpy(X))
    assert Y.shape == (A.shape[0], nv)
    for k in range(nv):
        assert torch.equal(Y[:, k], csr_spmv_plain(M, torch.from_numpy(
            np.ascontiguousarray(X[:, k]))))
    scale = max(float((abs(A) @ np.abs(X)).max(initial=0.0)), 1e-300)
    assert np.abs(Y.numpy() - A @ X).max(initial=0.0) <= 1e-13 * scale


@pytest.mark.parametrize("nv", [1, 2, 3, 4, 5, 8, 12, 13, 16, 24, 31])
def test_nv_pieces_cover_the_block(nv):
    """K2-NV's panels tile the block in order, each at most MAX_PIECES
    16-byte pieces wide (16 columns in f64, 32 in f32), all but the last
    full: a block of at most one panel's width is one launch."""
    for item in (8, 4):
        width = MAX_PIECES * 16 // item
        panels = nv_panels(nv, item)
        assert [k for k, _ in panels] == list(range(0, nv, width))
        assert sum(w for _, w in panels) == nv
        assert all(w == width for _, w in panels[:-1])
        assert 0 < panels[-1][1] <= width
        assert (nv <= width) == (len(panels) == 1)
