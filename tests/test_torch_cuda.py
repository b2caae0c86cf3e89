"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where torch.cuda.is_available() is false.
On a machine with an NVIDIA GPU and nvcc run them with

    python -m pytest tests/test_torch_cuda.py -m cuda

(the first test builds the kernels).  Tolerance: max |kernel - plain|
over the largest |A| |x| term, f64 1e-12, f32 1e-5 — the two sum in
other orders and the kernels contract multiply-adds.  K4 (a gather) and
the device setup are held to bit-for-bit equality.  K3 (DIA) runs on a
7-pt and a 27-pt operator, a rectangular one whose offsets reach past
either end, and one of 40 diagonals.  Both instances of K1 (tile: reach
1; row: reach 2) run on grids that are not multiples of the tile or of
the z chunk, on a stencil with arms missing and on an x that is not
16-byte aligned (the tile kernel's cell-by-cell staging); both
instances of K3
(by-value offsets; wide: 41 diagonals) on 0, 1 and 3 rows, row counts
odd, 2 mod 4 and 0 mod 4 against K3's 2 (f64) or 4 (f32) rows a thread,
and x and vals at addresses that are not 16-byte aligned.  K2-NV
(csr_spmm) runs at every block width nv from 1 to 16 and at 17, 24 and
32 (two panels in f64) on a random CSR, on X given as a column slice of
a wider block (rows not 16-byte aligned) and on the edge-row patterns,
each column of Y bit for bit K2's on that column of X;
LOBPCG and ILU-PCG run on the card and on the CPU at 16^3 (the same
iterations; eigenvalues to 1e-10, x to 1e-10 relative), and so does the
struct driver (CG+PFMG, 2-D and 3-D CG+SMG, PFMG RB-GS: the same
iterations, x to 1e-10 relative) and the auxiliary-space solvers
(AMS and SStructMaxwell at maxwell_3d(12), ADS with its inner AMS at
rt0_3d(8): the same iterations, x to 1e-10 relative)."""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch_port_helpers import (
    EDGE_CSR, LAPLACE_27PT, LAPLACE_7PT, SPARSE_ARMS, STAR_13PT, edge_csr,
    rel_diff,
)

from hypre_tpu_torch import Config, set_config
from hypre_tpu_torch.core.errors import HypreTpuError
from hypre_tpu_torch.gen import laplacian
from hypre_tpu_torch.ops.btake import btake_rows, btake_rows_plain
from hypre_tpu_torch.ops.dia import (
    DiaMatrix, dia_from_scipy, dia_matvec, dia_matvec_plain,
)
from hypre_tpu_torch.ops.formats import CsrMatrix, DenseMatrix
from hypre_tpu_torch.ops.spmv import (
    csr_from_scipy, csr_spmm, csr_spmm_plain, csr_spmv, csr_spmv_plain,
    nv_panels,
)
from hypre_tpu_torch.setup import device_amg as dev
from hypre_tpu_torch.ops.stencil import (
    StencilOp, kernel_instance, stencil_matvec, stencil_matvec_plain,
    stencil_op,
)
from hypre_tpu_torch.solvers import AmgConfig, BoomerAMG, pcg

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    set_config(Config(device="cuda"))
    yield torch.device("cuda")
    set_config(Config(device="cuda"))


def _check(y, y_ref, scale, dtype):
    err = float((y - y_ref).abs().max())
    assert err <= TOL[dtype] * float(scale.abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("stencil", [LAPLACE_7PT, LAPLACE_27PT],
                         ids=["7pt", "27pt"])
@pytest.mark.parametrize("grid", [(13, 9, 7), (1, 1, 33), (64, 32, 16)])
def test_stencil_kernel_matches_plain(card, grid, stencil, dtype):
    op = stencil_op(grid, stencil, dtype=dtype)
    x = torch.randn(op.n_rows, dtype=dtype, device=card,
                    generator=torch.Generator(card).manual_seed(1))
    before = stencil_matvec.launches
    y = stencil_matvec(op, x)
    torch.cuda.synchronize()
    assert stencil_matvec.launches == before + 1
    absop = stencil_op(grid, [(d, abs(v)) for d, v in stencil], dtype=dtype)
    _check(y, stencil_matvec_plain(op, x),
           stencil_matvec_plain(absop, x.abs()), dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("stencil,instance",
                         [(LAPLACE_7PT, "tile"), (LAPLACE_27PT, "tile"),
                          (SPARSE_ARMS, "tile"), (STAR_13PT, "row")],
                         ids=["7pt", "27pt", "sparse_arms", "star13"])
@pytest.mark.parametrize("grid", [(1, 1, 33), (2, 3, 1), (33, 9, 70),
                                  (45, 13, 20)])
def test_stencil_kernel_instances(card, grid, stencil, instance, dtype):
    """(33, 9, 70): z is no multiple of the 16-plane chunk; (45, 13, 20):
    x and y are no multiples of the 32 x 8 tile."""
    op = stencil_op(grid, stencil, dtype=dtype)
    assert kernel_instance(op) == instance
    x = torch.randn(op.n_rows, dtype=dtype, device=card,
                    generator=torch.Generator(card).manual_seed(3))
    before = stencil_matvec.launches
    y = stencil_matvec(op, x)
    torch.cuda.synchronize()
    assert stencil_matvec.launches == before + 1
    absop = stencil_op(grid, [(d, abs(v)) for d, v in stencil], dtype=dtype)
    _check(y, stencil_matvec_plain(op, x),
           stencil_matvec_plain(absop, x.abs()), dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("stencil", [LAPLACE_7PT, LAPLACE_27PT],
                         ids=["7pt", "27pt"])
def test_stencil_kernel_on_unaligned_x(card, stencil, dtype):
    """x one element past a 16-byte boundary on a grid whose rows are
    16-byte multiples: the tile kernel must copy cell by cell."""
    grid = (64, 32, 16)
    op = stencil_op(grid, stencil, dtype=dtype)
    xb = torch.randn(op.n_rows + 1, dtype=dtype, device=card,
                     generator=torch.Generator(card).manual_seed(8))
    x = xb[1:]
    assert x.data_ptr() % 16
    y = stencil_matvec(op, x)
    torch.cuda.synchronize()
    absop = stencil_op(grid, [(d, abs(v)) for d, v in stencil], dtype=dtype)
    _check(y, stencil_matvec_plain(op, x),
           stencil_matvec_plain(absop, x.abs()), dtype)


def _check_csr(M, x, dtype):
    before = csr_spmv.launches
    y = csr_spmv(M, x)
    torch.cuda.synchronize()
    assert csr_spmv.launches == before + 1
    assert y.shape == (M.n_rows,)
    absM = dataclasses.replace(M, values=M.values.abs())
    _check(y, csr_spmv_plain(M, x), csr_spmv_plain(absM, x.abs()), dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("group", [2, 4, 8, 16, 32])
def test_csr_kernel_matches_plain(card, group, dtype):
    rng = np.random.default_rng(group)
    A = sp.random(5003, 4001, density=0.01, random_state=rng, format="csr")
    M = dataclasses.replace(csr_from_scipy(A, dtype, card), group=group)
    x = torch.as_tensor(rng.standard_normal(4001), dtype=dtype, device=card)
    _check_csr(M, x, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("group", [2, 32, None])
@pytest.mark.parametrize("name", EDGE_CSR)
def test_csr_kernel_on_edge_rows(card, name, group, dtype):
    """Empty rows, a row of 100,003 nonzeros among short rows, rows of
    thousands of nonzeros beside one-entry rows, one row, no rows, rows
    that are all empty; at the fewest and most threads a row and at the
    operator's own group (None)."""
    A = edge_csr(name, seed=5)
    M = csr_from_scipy(A, dtype, card)
    if group is not None:
        M = dataclasses.replace(M, group=group)
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(A.shape[1]),
                        dtype=dtype, device=card)
    if M.n_rows:
        _check_csr(M, x, dtype)
    else:
        assert csr_spmv(M, x).shape == (0,)


NV = list(range(1, 17)) + [17, 24, 32]


def _check_spmm(M, X, dtype):
    """K2-NV against its plain version, one launch a panel, and each
    column of Y bit for bit K2's on that column of X."""
    before = csr_spmm.launches
    Y = csr_spmm(M, X)
    torch.cuda.synchronize()
    assert Y.shape == (M.n_rows, X.shape[1])
    assert csr_spmm.launches == before + len(
        nv_panels(X.shape[1], X.element_size()))
    absM = dataclasses.replace(M, values=M.values.abs())
    _check(Y, csr_spmm_plain(M, X), csr_spmm_plain(absM, X.abs()), dtype)
    for k in range(X.shape[1]):
        assert torch.equal(Y[:, k], csr_spmv(M, X[:, k].contiguous())), k


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nv", NV)
def test_csr_spmm_kernel_matches_plain(card, nv, dtype):
    rng = np.random.default_rng(nv)
    A = sp.random(5003, 4001, density=0.01, random_state=rng, format="csr")
    M = csr_from_scipy(A, dtype, card)
    X = torch.as_tensor(rng.standard_normal((4001, nv)), dtype=dtype,
                        device=card)
    _check_spmm(M, X, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("first", [1, 3])
@pytest.mark.parametrize("nv", [1, 2, 4, 7, 12, 16, 17])
def test_csr_spmm_kernel_on_column_slices(card, nv, first, dtype):
    """X = W[:, first:first + nv] of a wider block W of 40 columns: its
    rows start one or three values past a 16-byte boundary, so K2-NV
    moves every piece in scalar loads and stores; on the 128^3
    operator's row pattern (7-pt, group 4) cut to 12^3."""
    rng = np.random.default_rng(100 * nv + first)
    M = csr_from_scipy(laplacian(12, 12, 12), dtype, card)
    W = torch.as_tensor(rng.standard_normal((M.n_cols, 40)), dtype=dtype,
                        device=card)
    X = W[:, first:first + nv]
    assert X.data_ptr() % 16
    _check_spmm(M, X, dtype)
    assert torch.equal(csr_spmm(M, X), csr_spmm(M, X.contiguous()))


@pytest.mark.parametrize("nv", [1, 3, 5, 12, 16, 17, 24, 32])
@pytest.mark.parametrize("group", [2, 32, None])
@pytest.mark.parametrize("name", EDGE_CSR)
def test_csr_spmm_kernel_on_edge_rows(card, name, group, nv):
    """K2-NV gives a unit a quarter of K2's lanes (at group 2, half),
    each with 4 (2) slots that hold K2's order: group 32 has long rows
    in several passes and shuffles across 8 lanes."""
    A = edge_csr(name, seed=5)
    M = csr_from_scipy(A, torch.float64, card)
    if group is not None:
        M = dataclasses.replace(M, group=group)
    X = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (A.shape[1], nv)), dtype=torch.float64, device=card)
    if M.n_rows:
        _check_spmm(M, X, torch.float64)
    else:
        assert csr_spmm(M, X).shape == (0, nv)


def test_csr_spmm_refuses_a_column_stride(card):
    M = csr_from_scipy(laplacian(4, 4, 4), torch.float64, card)
    X = torch.ones((4, M.n_cols), dtype=torch.float64, device=card).T
    with pytest.raises(HypreTpuError, match="unit column stride"):
        csr_spmm(M, X)


def _dia_case(name, dtype, device):
    """A DIA operator; rect and 40_offsets are built directly, with
    values on every slot, so that the masks of x's ends are tested
    (rect holds offsets that fall wholly past either end)."""
    from hypre_tpu_torch.gen import laplacian_27pt

    if name == "7pt":
        return dia_from_scipy(laplacian(31, 17, 13), dtype, device)
    if name == "27pt":
        return dia_from_scipy(laplacian_27pt(15, 11, 9), dtype, device)
    rng = np.random.default_rng(7)
    if name == "rect":
        offs = [-12000, -300, -1, 0, 5, 2500, 9000]
        n_rows, n_cols = 10_007, 7_001
    else:
        offs = sorted(rng.choice(np.arange(-2000, 2000), 40, replace=False))
        n_rows = n_cols = 20_011
    vals = rng.standard_normal((len(offs), n_rows))
    return DiaMatrix(vals=torch.as_tensor(vals, dtype=dtype, device=device),
                     offsets=tuple(int(d) for d in offs), n_cols=n_cols)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["7pt", "27pt", "rect", "40_offsets"])
def test_dia_kernel_matches_plain(card, name, dtype):
    A = _dia_case(name, dtype, card)
    x = torch.randn(A.n_cols, dtype=dtype, device=card,
                    generator=torch.Generator(card).manual_seed(2))
    before = dia_matvec.launches
    y = dia_matvec(A, x)
    torch.cuda.synchronize()
    assert dia_matvec.launches == before + 1
    absA = dataclasses.replace(A, vals=A.vals.abs())
    _check(y, dia_matvec_plain(A, x), dia_matvec_plain(absA, x.abs()), dtype)


def _dia_random(offs, n_rows, n_cols, dtype, device, seed=0):
    vals = np.random.default_rng(seed).standard_normal((len(offs), n_rows))
    return DiaMatrix(vals=torch.as_tensor(vals, dtype=dtype, device=device),
                     offsets=tuple(offs), n_cols=n_cols)


def _check_dia(A, x, dtype):
    before = dia_matvec.launches
    y = dia_matvec(A, x)
    torch.cuda.synchronize()
    assert dia_matvec.launches == before + 1
    assert y.shape == (A.n_rows,)
    if A.n_rows:
        absA = dataclasses.replace(A, vals=A.vals.abs())
        _check(y, dia_matvec_plain(A, x), dia_matvec_plain(absA, x.abs()),
               dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n_rows", [0, 1, 3, 1001, 1002, 1004])
@pytest.mark.parametrize("shape", ["square", "rect"])
def test_dia_kernel_on_row_counts(card, shape, n_rows, dtype):
    """Row counts odd, 2 mod 4 and 0 mod 4, and the smallest; offsets
    that reach past either end of x."""
    n_cols = n_rows if shape == "square" else 700
    offs = [-1200, -33, -2, -1, 0, 1, 4, 31, 900]
    A = _dia_random(offs, n_rows, n_cols, dtype, card, seed=n_rows)
    assert A.launch_args.instance == "param"
    x = torch.randn(n_cols, dtype=dtype, device=card,
                    generator=torch.Generator(card).manual_seed(4))
    _check_dia(A, x, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n_diags,instance", [(40, "param"), (41, "wide")])
@pytest.mark.parametrize("n_rows", [20_011, 20_012])
def test_dia_kernel_instances(card, n_rows, n_diags, instance, dtype):
    offs = sorted(np.random.default_rng(n_diags).choice(
        np.arange(-3000, 3000), n_diags, replace=False).tolist())
    A = _dia_random(offs, n_rows, n_rows, dtype, card, seed=1)
    assert A.launch_args.instance == instance
    x = torch.randn(n_rows, dtype=dtype, device=card,
                    generator=torch.Generator(card).manual_seed(5))
    _check_dia(A, x, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dia_kernel_on_unaligned_operands(card, dtype):
    """x and vals one element past a 16-byte boundary (contiguous views):
    K3 must not take its 16-byte loads."""
    n, offs = 40_000, [-200, -1, 0, 1, 200]
    flat = torch.randn(len(offs) * n + 1, dtype=dtype, device=card,
                       generator=torch.Generator(card).manual_seed(6))
    A = DiaMatrix(vals=flat[1:].view(len(offs), n), offsets=tuple(offs),
                  n_cols=n)
    xb = torch.randn(n + 1, dtype=dtype, device=card,
                     generator=torch.Generator(card).manual_seed(7))
    assert A.vals.data_ptr() % 16 and xb[1:].data_ptr() % 16
    _check_dia(A, xb[1:], dtype)


def test_pcg_on_card_matches_cpu(card):
    n = 16
    out = {}
    for device in ("cuda", "cpu"):
        set_config(Config(device=device))
        amg = BoomerAMG(AmgConfig(interp_type=6)).setup(
            laplacian(n, n, n), fine_stencil=((n, n, n), LAPLACE_7PT))
        res = pcg(amg.hierarchy.levels[0].A, np.ones(n ** 3), M=amg)
        out[device] = (res.iters, res.x.cpu().numpy())
    assert out["cuda"][0] == out["cpu"][0]
    assert rel_diff(out["cuda"][1], out["cpu"][1]) <= 1e-10


def test_lobpcg_on_card_matches_cpu(card):
    from hypre_tpu_torch.ops import sparse_op_from_scipy
    from hypre_tpu_torch.solvers.lobpcg import lobpcg

    n = 16
    X0 = np.random.RandomState(3).rand(n ** 3, 4)
    out = {}
    for device in ("cuda", "cpu"):
        set_config(Config(device=device))
        A = laplacian(n, n, n)
        amg = BoomerAMG(AmgConfig(interp_type=6)).setup(A)
        res = lobpcg(sparse_op_from_scipy(A, prefer_dia=False), X0, M=amg,
                     tol=1e-6)
        out[device] = (res.iters, res.eigenvalues.cpu().numpy())
    assert out["cuda"][0] == out["cpu"][0]
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-10)


def test_ilu_pcg_on_card_matches_cpu(card):
    from hypre_tpu_torch.ops import sparse_op_from_scipy
    from hypre_tpu_torch.solvers.ilu import ILU

    n = 16
    out = {}
    for device in ("cuda", "cpu"):
        set_config(Config(device=device))
        A = laplacian(n, n, n)
        M = ILU().setup(A)
        res = pcg(sparse_op_from_scipy(A), np.ones(n ** 3),
                  M=M.precondition)
        out[device] = (res.iters, res.x.cpu().numpy())
    assert out["cuda"][0] == out["cpu"][0]
    assert rel_diff(out["cuda"][1], out["cpu"][1]) <= 1e-10


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.float64,
                                   torch.bool])
def test_btake_kernel_matches_plain(card, dtype, K):
    g = torch.Generator(card).manual_seed(K)
    n_src, S, n = 70_001, 9, 50_003
    idx = torch.randint(-1, n_src, (S, n), generator=g, device=card,
                        dtype=torch.int32)
    X = torch.randint(-1000, 1000, (K, n_src), generator=g,
                      device=card).to(dtype)
    before = btake_rows.launches
    Y = btake_rows(idx, X, fill=-1 if dtype == torch.int32 else 0)
    torch.cuda.synchronize()
    assert btake_rows.launches == before + 1
    assert torch.equal(Y, btake_rows_plain(
        idx, X, fill=-1 if dtype == torch.int32 else 0))


@pytest.mark.parametrize("dtype", [torch.bool, torch.int32, torch.float32,
                                   torch.float64, torch.int64])
@pytest.mark.parametrize("K,S,n,c0", [(64, 3, 1001, 1), (5, 40, 4099, 3),
                                      (2, 17, 17, 7), (1, 1, 1, 0),
                                      (33, 7, 12_345, 13)])
def test_btake_kernel_on_windows(card, dtype, K, S, n, c0):
    """idx and X as row windows of larger arrays starting at odd
    offsets, n not a multiple of the vector width, K up to 64, S up to
    40, banded indices with -1 holes: bit for bit the plain version."""
    g = torch.Generator(card).manual_seed(K * 1000 + S)
    n_src = 3 * n + 101
    big_idx = torch.randint(-1, n_src, (S, n + c0 + 5), generator=g,
                            device=card, dtype=torch.int32)
    band = (torch.arange(n + c0 + 5, device=card) * 3)[None] + torch.randint(
        -50, 51, (S, n + c0 + 5), generator=g, device=card)
    big_idx[:, ::2] = band.clamp(-1, n_src - 1).to(torch.int32)[:, ::2]
    idx = big_idx[:, c0:c0 + n]
    big_X = torch.randint(-1000, 1000, (K + 1, n_src + 2 * c0 + 3),
                          generator=g, device=card).to(dtype)
    X = big_X[1:, c0 + 1:c0 + 1 + n_src]
    fill = True if dtype == torch.bool else 7
    before = btake_rows.launches
    Y = btake_rows(idx, X, fill)
    torch.cuda.synchronize()
    assert btake_rows.launches == before + 1
    assert Y.shape == (K, S, n) and Y.is_contiguous()
    assert torch.equal(Y, btake_rows_plain(idx, X, fill))


def test_setup_device_on_card_matches_cpu(card):
    """16^3: the card's device hierarchy equals the CPU's bit for bit
    (CF, A, P, R), and setup_device reports the same shape."""
    n = 16
    out = {}
    for device in ("cuda", "cpu"):
        set_config(Config(device=device))
        items = list(dev.iter_device_hierarchy(
            dev.dell_stencil((n, n, n), LAPLACE_7PT),
            AmgConfig(interp_type=6)))
        amg = BoomerAMG(AmgConfig(interp_type=6)).setup_device(
            stencil=((n, n, n), LAPLACE_7PT))
        out[device] = (items, amg.level_sizes, amg.level_nnz)
    (gi, gs, gn), (ci, cs, cn) = out["cuda"], out["cpu"]
    assert gs == cs and gn == cn
    for g_lvl, c_lvl in zip(gi[:-1], ci[:-1]):
        for a, b in zip(g_lvl, c_lvl):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a.cpu(), b)
            else:
                assert torch.equal(a.cols.cpu(), b.cols)
                assert torch.equal(a.vals.cpu(), b.vals)


@pytest.mark.parametrize("relax,fields", [(11, ("L", "U")), (30, ("AT",))])
def test_smoother_operators_on_card(card, relax, fields):
    """K2 on the smoothers' own operators of a 24^3 host hierarchy: the
    strict triangles of relax 11 (the first row of L and the last of U
    are empty) and A^T of relax 30, f64 and f32, against the plain
    version; at least one of each is CSR."""
    amg = BoomerAMG(AmgConfig(interp_type=6, relax_type=relax)).setup(
        laplacian(24, 24, 24))
    n_csr = 0
    for lvl in amg.hierarchy.levels[:-1]:
        for name in fields:
            A = getattr(lvl, name)
            if not isinstance(A, CsrMatrix):
                continue
            n_csr += 1
            for dtype in (torch.float64, torch.float32):
                Ad = A if dtype == A.dtype else A.to(dtype)
                x = torch.randn(A.n_cols, dtype=dtype, device=card,
                                generator=torch.Generator(card).manual_seed(3))
                before = csr_spmv.launches
                y = csr_spmv(Ad, x)
                torch.cuda.synchronize()
                assert csr_spmv.launches == before + 1
                absA = dataclasses.replace(Ad, values=Ad.values.abs())
                _check(y, csr_spmv_plain(Ad, x), csr_spmv_plain(absA, x.abs()),
                       dtype)
    assert n_csr >= len(fields)


def test_sqrt_rn_on_card_matches_numpy(card):
    """core/ieee.py's square root on the card: bit for bit numpy's, on
    random doubles of every exponent and on the doubles around squares."""
    from hypre_tpu_torch.core.ieee import sqrt_rn

    rng = np.random.default_rng(12)
    n = 1_000_000
    bits = (rng.integers(1, 0x7FE, n, dtype=np.int64) << 52) \
        | rng.integers(0, 1 << 52, n, dtype=np.int64)
    sq = np.arange(1, n + 1, dtype=np.float64) ** 2
    d = np.concatenate([bits.view(np.float64), rng.uniform(0.5, 64.0, n),
                        sq, np.nextafter(sq, 0), np.nextafter(sq, 2 * sq)])
    got = sqrt_rn(torch.from_numpy(d).to(card)).cpu().numpy()
    np.testing.assert_array_equal(got, np.sqrt(d))


@pytest.mark.parametrize("relax", [16, 11])
def test_setup_device_relax_on_card_matches_cpu(card, relax):
    """32^3, relax 16 and 11 on the device setup: the card's hierarchy
    equals the CPU's bit for bit (level sizes, nonzeros, every packed
    A, P, R, the l1 diagonal), and so do relax 11's L and U and
    Chebyshev's ds = 1/sqrt(|diag|) (core/ieee.py's square root is
    correctly rounded on both); the Chebyshev bounds to 1e-12 (the power
    iteration's norms sum in another order on the card)."""
    n = 32
    levels = {}
    for device in ("cuda", "cpu"):
        set_config(Config(device=device))
        amg = BoomerAMG(AmgConfig(interp_type=6, relax_type=relax)) \
            .setup_device(stencil=((n, n, n), LAPLACE_7PT))
        levels[device] = (amg.level_sizes, amg.level_nnz,
                          amg.hierarchy.levels[:-1])
    (gs, gn, gl), (cs, cn, cl) = levels["cuda"], levels["cpu"]
    assert gs == cs and gn == cn

    def same(a, b):
        if isinstance(a, torch.Tensor):
            return torch.equal(a.cpu(), b)
        if isinstance(a, CsrMatrix):
            return all(torch.equal(getattr(a, k).cpu(), getattr(b, k))
                       for k in ("indptr", "indices", "values"))
        if isinstance(a, DenseMatrix):
            return torch.equal(a.vals.cpu(), b.vals)
        return type(a) is type(b) and (a is None or isinstance(a, StencilOp))

    for g, c in zip(gl, cl):
        for name in ("A", "P", "R", "dinv", "L", "U"):
            assert same(getattr(g, name), getattr(c, name)), name
        if relax == 16:
            assert torch.equal(g.cheby_ds.cpu(), c.cheby_ds)
            for a, b in zip(g.cheby_bounds, c.cheby_bounds):
                assert abs(a - b) <= 1e-12 * abs(b)


@pytest.mark.parametrize("flags", ["-n 16 16 16 -solver 11",
                                   "-n 64 64 1 -solver 10",
                                   "-n 12 12 12 -solver 10",
                                   "-n 16 16 16 -solver 1 -relax 2"])
def test_struct_driver_on_card_matches_cpu(card, flags):
    """The struct path (plain torch on the card: struct_matvec, the
    PFMG/SMG cycles, cyclic reduction, the per-plane and device coarsest
    inverses) against the same run on the CPU: equal iterations, x to
    1e-10 relative."""
    from hypre_tpu_torch.drivers import struct

    args = struct.build_parser().parse_args(flags.split())
    out = struct.run(args)
    cpu = struct.run(struct.build_parser().parse_args(
        flags.split() + ["-exec_host"]))
    assert out["x"].device.type == "cuda"
    assert out["iters"] == cpu["iters"]
    assert rel_diff(out["x"].cpu().numpy(), cpu["x"].numpy()) <= 1e-10


AUX_CASES = {
    # ex15's AMS: CSR edge matrix, DIA B_G level 0, CSR transfers
    "ams": lambda: _aux_solve("ams", 12),
    # ADS with the inner AMS: B_Pi one dense level (the coarse LU)
    "ads": lambda: _aux_solve("ads", 8),
    "maxwell": lambda: _aux_solve("maxwell", 12),
}


def _aux_solve(kind: str, n: int):
    from hypre_tpu_torch.ops import sparse_op_from_scipy
    from hypre_tpu_torch.solvers.ams import ADS, AMS, maxwell_3d, rt0_3d
    from hypre_tpu_torch.sstruct import SStructMaxwell

    if kind == "ads":
        A, C, Pi_f, G, Pi_e = rt0_3d(n)
        M = ADS().setup(A, C, Pi_f, G=G, Pi_e=Pi_e)
    else:
        A, G, Pi = maxwell_3d(n)
        M = AMS().setup(A, G, Pi) if kind == "ams" \
            else SStructMaxwell().setup(A, G)
    res = pcg(sparse_op_from_scipy(A), np.ones(A.shape[0]),
              M=M.precondition, tol=1e-8, max_iter=200)
    return res.iters, res.x.cpu().numpy()


@pytest.mark.parametrize("kind", sorted(AUX_CASES))
def test_aux_space_solvers_on_card_match_cpu(card, kind):
    """AMS, ADS and SStructMaxwell PCG: the card takes the CPU's
    iterations, x within 1e-10 relative."""
    out = {}
    for device in ("cuda", "cpu"):
        set_config(Config(device=device))
        out[device] = AUX_CASES[kind]()
    assert out["cuda"][0] == out["cpu"][0]
    assert rel_diff(out["cuda"][1], out["cpu"][1]) <= 1e-10
