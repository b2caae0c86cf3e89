"""The port's device setup (hypre_tpu_torch/setup/device_amg.py) against
hypre_tpu's (hypre_tpu/setup/device_amg.py), stage by stage, on the CPU.

Both packages get the same operator: the reference's DEll arrays cross
over through hypre_tpu_torch.convert.dell_from_numpy, and the
reference's intermediate results (strong mask, CF) feed the port's next
stage.  The reference's stage functions run with explicit small chunks
(its own defaults pad even tiny levels to 262,144 lanes).  Tolerances:
masks, CF and the hash bit for bit; operators 1e-12 of their largest
entry; l1 norms 1e-14 relative.  The port sums in the reference's order,
so the operators in fact agree exactly.  ext+i interpolation has a file
of its own (test_torch_device_extpi.py), to keep each file's run
short."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from hypre_tpu.gen.laplace import laplacian
from hypre_tpu.setup import device_amg as ref
from hypre_tpu_torch import Config, set_config
from hypre_tpu_torch.ops.formats import (
    CsrMatrix, DenseMatrix, sparse_op_from_dell,
)
from hypre_tpu_torch.ops.spmv import csr_spmv_plain
from hypre_tpu_torch.setup import device_amg as dev
from hypre_tpu_torch.solvers import AmgConfig, BoomerAMG, pcg
from torch_port_helpers import (
    LAPLACE_7PT, assert_ops_close as _close, dell_to_port as _port,
    rand_csr as _rand_csr, stage_operators,
)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    set_config(Config(device="cpu"))
    yield


def _ref(M: dev.DEll):
    return ref.DEll(cols=jnp.asarray(M.cols.numpy()),
                    vals=jnp.asarray(M.vals.numpy()), n_cols=M.n_cols)


OPS = stage_operators()


def test_dell_roundtrip_and_generators():
    A = _rand_csr(57, 43, 0.1, 0)
    M = dev.dell_from_scipy(A)
    assert abs(A - dev.dell_to_scipy(M)).max() == 0
    ref_M = ref.dell_from_scipy(A, np.float64)
    assert np.array_equal(M.cols.numpy(), np.asarray(ref_M.cols))
    assert np.array_equal(M.vals.numpy(), np.asarray(ref_M.vals))
    for shape in ((5, 4, 3), (8, 8, 1), (6, 1, 1)):
        Md = dev.dell_laplacian(*shape)
        Mr = ref.dell_laplacian(*shape, dtype=jnp.float64)
        assert np.array_equal(Md.cols.numpy(), np.asarray(Mr.cols))
        assert np.array_equal(Md.vals.numpy(), np.asarray(Mr.vals))
        assert abs(laplacian(*shape) - dev.dell_to_scipy(Md)).max() == 0
    Mw = dev.dell_pad_width(dev.dell_from_scipy(_rand_csr(30, 30, 0.3, 1)))
    assert Mw.width in (8, 16, 24) and \
        np.array_equal(np.asarray(ref.dell_pad_width(_ref(Mw)).cols),
                       Mw.cols.numpy())


@pytest.mark.parametrize("theta,mrs", [(0.25, 0.9), (0.5, 1.0)])
@pytest.mark.parametrize("name", list(OPS))
def test_strength_mask_equal(name, theta, mrs):
    M = OPS[name]
    s_ref = np.asarray(ref.device_strength(M, theta, mrs))
    s = dev.device_strength(_port(M), theta, mrs, chunk=37).numpy()
    assert np.array_equal(s, s_ref)


@pytest.mark.parametrize("seed", [2747, 0, 0xFFFFFFFF, 123456789])
def test_pmis_hash32_bitwise(seed):
    ids = np.concatenate([np.arange(5000), [2**31 - 1, 2**24, 7 << 20]])
    h_ref = np.asarray(ref.pmis_hash32(jnp.asarray(ids, jnp.int32), seed))
    h = dev.pmis_hash32(torch.as_tensor(ids, dtype=torch.int32),
                        seed).numpy()
    assert h.dtype == np.float32
    assert np.array_equal(h.view(np.uint32), h_ref.view(np.uint32))
    assert np.array_equal(h, ref.pmis_hash32_np(ids, seed))


@pytest.mark.parametrize("name", list(OPS))
def test_pmis_cf_equal(name):
    M = OPS[name]
    strong = ref.device_strength(M, 0.25, 0.9)
    cf_ref = np.asarray(ref.device_pmis(M, strong, seed=2747))
    stats = {}
    cf = dev.device_pmis(_port(M), torch.as_tensor(np.array(strong)),
                         seed=2747, chunk=29, stats=stats).numpy()
    assert np.array_equal(cf, cf_ref)
    assert stats["pmis_rounds"] >= 1


def _strong_cf(M):
    strong = ref.device_strength(M, 0.25, 0.9)
    cf = ref.device_pmis(M, strong, seed=2747)
    return strong, cf, int(jnp.sum(cf == ref.C_PT))


@pytest.mark.parametrize("name", ["lap7", "difconv", "rand_spd"])
def test_direct_interp_equal(name):
    M = OPS[name]
    strong, cf, nc = _strong_cf(M)
    P_ref = ref.device_direct_interp(M, strong, cf, n_coarse=nc,
                                     trunc_factor=0.0, max_elmts=4)
    P = dev.device_direct_interp(
        _port(M), torch.as_tensor(np.array(strong)),
        torch.as_tensor(np.array(cf)), n_coarse=nc, trunc_factor=0.0,
        max_elmts=4, chunk=41)
    _close(dev.dell_to_scipy(P), ref.dell_to_scipy(P_ref))


@pytest.mark.parametrize("tf,me", [(0.2, 0), (0.0, 2), (0.1, 3)])
def test_truncate_equal(tf, me):
    rng = np.random.default_rng(11)
    P = _rand_csr(80, 30, 0.15, 9)
    P.data = rng.permutation(np.linspace(0.1, 2.0, P.nnz)) \
        * rng.choice([-1.0, 1.0], P.nnz)
    Pr = ref.dell_from_scipy(P, np.float64)
    out_ref = ref.dell_to_scipy(ref.device_truncate(Pr, tf, me))
    out = dev.dell_to_scipy(dev.device_truncate(_port(Pr), tf, me,
                                                chunk=17))
    _close(out, out_ref)


def test_spgemm_equal():
    A = ref.dell_from_scipy(_rand_csr(70, 50, 0.15, 1), np.float64)
    B = ref.dell_from_scipy(_rand_csr(50, 60, 0.15, 2), np.float64)
    w_ref = ref.device_spgemm_width(A, B, chunk=32)
    C_ref = ref.device_spgemm(A, B, w_ref, chunk=32)
    # one pass, C's width taken from the chunks: the reference's width
    # and slots, whatever the chunk
    for chunk in (23, 19, None):
        C = dev.device_spgemm(_port(A), _port(B), chunk=chunk)
        assert C.width == w_ref
        _close(dev.dell_to_scipy(C), ref.dell_to_scipy(C_ref))
        assert np.array_equal(C.cols.numpy(), np.asarray(C_ref.cols))


def test_transpose_equal():
    A = ref.dell_from_scipy(_rand_csr(40, 70, 0.1, 5), np.float64)
    w_ref = ref.device_transpose_width(A)
    T_ref = ref.device_transpose(A, w_ref)
    w = dev.device_transpose_width(_port(A))
    T = dev.device_transpose(_port(A), w)
    assert w == w_ref
    # the same slots: rows ascend within each output row
    assert np.array_equal(T.cols.numpy(), np.asarray(T_ref.cols))
    assert np.array_equal(T.vals.numpy(), np.asarray(T_ref.vals))


@pytest.mark.parametrize("option", [1, 4, 5])
def test_l1_norms_equal(option):
    M = OPS["difconv"]
    l1_ref = np.asarray(ref.device_l1_norms(M, option=option))
    l1 = dev.device_l1_norms(_port(M), option=option).numpy()
    assert np.allclose(l1, l1_ref, rtol=1e-14, atol=0)


def test_chunking_does_not_change_results():
    """Row chunks of any size give the same bits (sizes set by the
    memory budget on the card, here forced small)."""
    M = _port(OPS["lap27"])
    s = dev.device_strength(M, 0.25, 0.9)
    cf = dev.device_pmis(M, s)
    nc = int((cf == dev.C_PT).sum())
    outs = [dev.device_extpi_interp(M, s, cf, n_coarse=nc, chunk=c)
            for c in (None, 1, 7, 64)]
    for P in outs[1:]:
        assert torch.equal(P.cols, outs[0].cols)
        assert torch.equal(P.vals, outs[0].vals)
    assert torch.equal(dev.device_pmis(M, s, chunk=5), cf)


def test_pack_into_solve_formats():
    """sparse_op_from_dell: dense at 2048 or fewer, CSR above; the same
    operator as the DEll."""
    small = dev.dell_from_scipy(_rand_csr(50, 40, 0.1, 4))
    D = sparse_op_from_dell(small, torch.float64)
    assert isinstance(D, DenseMatrix)
    assert np.array_equal(D.vals.numpy(),
                          dev.dell_to_scipy(small).toarray())
    big = dev.dell_laplacian(14, 13, 12)
    C = sparse_op_from_dell(big, torch.float64)
    assert isinstance(C, CsrMatrix)
    A = dev.dell_to_scipy(big)
    assert np.array_equal(C.indptr.numpy(), A.indptr)
    assert np.array_equal(C.indices.numpy(), A.indices)
    x = torch.linspace(-1, 1, A.shape[1], dtype=torch.float64)
    assert np.allclose(csr_spmv_plain(C, x).numpy(), A @ x.numpy(),
                       rtol=0, atol=1e-14)


def test_setup_device_pcg_converges():
    """The port's device setup + PCG at 12^3 on the CPU (the bound
    tests/test_device_amg.py:183-196 asks of the reference)."""
    n = 12
    amg = BoomerAMG(AmgConfig(interp_type=6, relax_type=18)).setup_device(
        stencil=((n, n, n), LAPLACE_7PT))
    assert amg.level_formats[0] == "StencilOp"
    res = pcg(amg.hierarchy.levels[0].A, np.ones(n ** 3), M=amg, tol=1e-8,
              max_iter=60)
    assert res.relres < 1e-8 and res.iters <= 30
    # a scipy input gives the same hierarchy, level 0 then stored as CSR
    amg2 = BoomerAMG(AmgConfig(interp_type=6, relax_type=18)).setup_device(
        laplacian(n, n, n))
    assert amg2.level_sizes == amg.level_sizes
    assert amg2.level_nnz == amg.level_nnz
    assert [s["pmis_rounds"] for s in amg.setup_stats] == \
        [s["pmis_rounds"] for s in amg2.setup_stats]


@pytest.mark.parametrize("relax,exc", [(16, None), (11, None), (12, None),
                                       (3, ValueError), (13, ValueError)])
def test_setup_device_relax_types(relax, exc):
    """The reference's device smoothers build (amg.py:553-556); the
    exact-GS types need host factors and raise."""
    amg = BoomerAMG(AmgConfig(relax_type=relax))
    if exc is None:
        amg.setup_device(laplacian(4, 4, 4))
        assert amg.hierarchy.relax_type == relax
    else:
        with pytest.raises(exc):
            amg.setup_device(laplacian(4, 4, 4))
