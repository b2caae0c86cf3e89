"""DIA storage and its plain matvec (K3's spec) against hypre_tpu.

dia_from_scipy must give the reference's offsets and values bit for
bit; the plain matvec sums the diagonals in the reference's order, so
it is held bit for bit too (both add one rounded product a diagonal,
in offset order, from zero).  sparse_op_from_scipy must pick the
reference's format, with CSR standing in for GST-ELL and ELL."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from hypre_tpu.gen import difconv as ref_difconv
from hypre_tpu.gen import laplacian as ref_laplacian
from hypre_tpu.gen import laplacian_9pt as ref_laplacian_9pt
from hypre_tpu.gen import laplacian_27pt as ref_laplacian_27pt
from hypre_tpu.ops import formats as ref_formats
from hypre_tpu_torch import Config, set_config
from hypre_tpu_torch.core.errors import HypreTpuError
from hypre_tpu_torch.ops import formats
from hypre_tpu_torch.ops.dia import (
    MAX_DIAGS, DiaMatrix, dia_from_scipy, dia_matvec, dia_matvec_plain,
)

torch.set_num_threads(1)
TORCH = {np.float64: torch.float64, np.float32: torch.float32}
# the reference's classes, as the port stores them
PORT_CLASS = {"DenseMatrix": "DenseMatrix", "DiaMatrix": "DiaMatrix",
              "GstEllMatrix": "CsrMatrix", "EllMatrix": "CsrMatrix"}


@pytest.fixture(autouse=True)
def _cpu():
    set_config(Config(device="cpu"))
    yield


def _rect():
    """A rectangular operator whose offsets reach past either end."""
    rng = np.random.default_rng(3)
    n_rows, n_cols = 61, 47
    offs = [-70, -12, -1, 0, 2, 30, 52]
    rows, cols = [], []
    for d in offs:
        i = np.arange(n_rows)
        ok = (i + d >= 0) & (i + d < n_cols)
        rows.append(i[ok])
        cols.append(i[ok] + d)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return sp.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                         shape=(n_rows, n_cols))


MATRICES = {
    "7pt_10x9x8": lambda: ref_laplacian(10, 9, 8),
    "27pt_6": lambda: ref_laplacian_27pt(6, 6, 6),
    "9pt_13x11": lambda: ref_laplacian_9pt(13, 11),
    "difconv": lambda: ref_difconv(7, 6, 5, ax=1.3, ay=0.4),
    "rect": _rect,
}


def _band(n, offsets, seed=0):
    rng = np.random.default_rng(seed)
    return sp.diags([rng.standard_normal(n - abs(d)) + 4.0 for d in offsets],
                    offsets, shape=(n, n), format="csr")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", list(MATRICES))
def test_dia_from_scipy_matches_reference(name, dtype):
    A = MATRICES[name]()
    ref = ref_formats.dia_from_scipy(A, dtype)
    port = dia_from_scipy(A, TORCH[dtype], "cpu")
    assert port.offsets == ref.offsets
    assert port.n_cols == ref.n_cols and port.shape == A.shape
    assert port.vals.dtype == TORCH[dtype]
    np.testing.assert_array_equal(port.vals.numpy(), np.asarray(ref.vals))


@pytest.mark.parametrize("n_diags,max_diags", [(32, 32), (33, 32), (40, 40),
                                               (41, 40)])
def test_dia_from_scipy_refuses_past_max_diags(n_diags, max_diags):
    A = _band(300, list(range(-(n_diags // 2), n_diags - n_diags // 2)))
    ref = ref_formats.dia_from_scipy(A, np.float64, max_diags=max_diags)
    port = dia_from_scipy(A, torch.float64, "cpu", max_diags=max_diags)
    assert (ref is None) == (port is None) == (n_diags > max_diags)


def test_dia_from_scipy_sampled_reject():
    """Past 2^20 entries a sample of the offsets is tested first."""
    n, k = 70_000, 16
    cols = np.random.default_rng(4).integers(0, n, size=n * k)
    A = sp.csr_matrix((np.ones(n * k), cols, np.arange(0, n * k + 1, k)),
                      shape=(n, n))
    assert A.nnz > 1 << 20
    assert ref_formats.dia_from_scipy(A, np.float64) is None
    assert dia_from_scipy(A, torch.float64, "cpu") is None


@pytest.mark.parametrize("name", list(MATRICES))
def test_dia_matvec_plain_matches_reference(name):
    A = MATRICES[name]()
    ref = ref_formats.dia_from_scipy(A, np.float64)
    port = dia_from_scipy(A, torch.float64, "cpu")
    x = np.random.default_rng(5).standard_normal(A.shape[1])
    want = np.asarray(ref_formats.dia_matvec(ref, jnp.asarray(x)))
    got = dia_matvec_plain(port, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, A @ x, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("n_diags,max_diags", [(40, 40), (41, 41)])
@pytest.mark.parametrize("n", [301, 302, 304])
def test_dia_matvec_plain_matches_reference_wide(n, n_diags, max_diags):
    """Bands of K3's by-value limit (40) and one past it, on row counts
    odd, 2 mod 4 and 0 mod 4."""
    offs = list(range(-(n_diags // 2), n_diags - n_diags // 2))
    A = _band(n, [3 * d for d in offs], seed=n)
    ref = ref_formats.dia_from_scipy(A, np.float64, max_diags=max_diags)
    port = dia_from_scipy(A, torch.float64, "cpu", max_diags=max_diags)
    assert len(port.offsets) == n_diags
    x = np.random.default_rng(6).standard_normal(n)
    want = np.asarray(ref_formats.dia_matvec(ref, jnp.asarray(x)))
    np.testing.assert_array_equal(
        dia_matvec_plain(port, torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("name", list(MATRICES) + ["band40", "band41",
                                                   "empty"])
def test_dia_launch_args(name):
    """K3's packed argument: {min offset, max offset, offsets...} as
    int64, built once per matrix; the by-value instance up to
    MAX_DIAGS diagonals, the wide one past it."""
    if name.startswith("band"):
        k = int(name[4:])
        A = dia_from_scipy(_band(500, list(range(-20, k - 20))),
                           torch.float64, "cpu", max_diags=k)
    elif name == "empty":
        A = DiaMatrix(vals=torch.zeros((0, 7), dtype=torch.float64),
                      offsets=(), n_cols=7)
    else:
        A = dia_from_scipy(MATRICES[name](), torch.float64, "cpu")
    args = A.launch_args
    offs = list(A.offsets)
    assert args.packed.dtype == np.int64
    assert args.packed.tolist() == ([min(offs), max(offs)] + offs
                                    if offs else [0, 0])
    assert args.packed_ptr == args.packed.ctypes.data
    assert A.launch_args is args
    assert args.instance == ("param" if len(offs) <= MAX_DIAGS else "wide")
    assert MAX_DIAGS == 40


def _formats(A):
    ref = type(ref_formats.sparse_op_from_scipy(A, np.float64)).__name__
    port = type(formats.sparse_op_from_scipy(A, torch.float64)).__name__
    return PORT_CLASS[ref], port


@pytest.mark.parametrize("case", ["dense_2048", "dia_2049", "thin_diagonal",
                                  "offsets_32", "offsets_33", "no_prefer"])
def test_sparse_op_picks_the_reference_format(case):
    if case == "dense_2048":
        A, want = ref_laplacian(2048), "DenseMatrix"
    elif case == "dia_2049":
        A, want = ref_laplacian(2049), "DiaMatrix"
    elif case == "thin_diagonal":
        # the density test: 3 offsets, two of them one entry each
        A = sp.eye(2100, format="lil")
        A[0, 1000] = A[1000, 0] = 0.5
        A, want = A.tocsr(), "CsrMatrix"
    elif case == "offsets_32":
        A, want = _band(2500, list(range(-16, 16))), "DiaMatrix"
    elif case == "offsets_33":
        A, want = _band(2500, list(range(-16, 17))), "CsrMatrix"
    else:
        A = ref_laplacian(30, 30, 3)
        ref = ref_formats.sparse_op_from_scipy(A, np.float64, prefer_dia=False)
        port = formats.sparse_op_from_scipy(A, torch.float64, prefer_dia=False)
        assert (PORT_CLASS[type(ref).__name__], type(port).__name__) \
            == ("CsrMatrix", "CsrMatrix")
        return
    assert _formats(A) == (want, want)


def test_dia_column_limit_is_the_references():
    """The reference's 5 MiB f32 operand limit: DIA up to 1,310,720
    columns, CSR past it.  Checked on the port alone: past the edge the
    reference packs GST-ELL, which the comparisons above cover."""
    for n_cols, want in ((1_310_720, DiaMatrix), (1_310_721,
                                                  formats.CsrMatrix)):
        A = sp.eye(3000, n_cols, format="csr")
        assert isinstance(formats.sparse_op_from_scipy(A, torch.float64),
                          want)


def test_dia_wrapper_takes_the_plain_version_on_cpu_and_raises_elsewhere():
    A = dia_from_scipy(ref_laplacian(6, 5, 4), torch.float64, "cpu")
    x = torch.ones(A.n_cols, dtype=torch.float64)
    dia_matvec.launches = 0
    assert torch.equal(dia_matvec(A, x), dia_matvec_plain(A, x))
    assert torch.equal(formats.matvec(A, x), dia_matvec_plain(A, x))
    assert dia_matvec.launches == 0
    with pytest.raises(HypreTpuError):
        dia_matvec(A, torch.empty(A.n_cols, dtype=torch.float64,
                                  device="meta"))
