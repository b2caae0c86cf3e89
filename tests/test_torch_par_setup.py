"""The port's distributed setup (8 stacked shards) against hypre_tpu's.

The reference's iter_par_hierarchy and setup_distributed take minutes
on the 8 virtual devices, so their C/F splits, operators and counts are
read from tests/golden/par_reference.npz (tools/par_reference_counts.
py); its pardell conversion, strength, PMIS and transpose are called
directly.  The port's distributed hierarchy also equals its own
single-device device setup's, bit for bit."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from torch_port_helpers import (
    LAPLACE_7PT, golden_csr, mesh8, par_golden, part_dict,
)

torch.set_num_threads(1)

from hypre_tpu_torch import Config, set_config  # noqa: E402

set_config(Config(device="cpu"))

from hypre_tpu_torch.convert import pardell_from_numpy  # noqa: E402
from hypre_tpu_torch.gen import laplacian  # noqa: E402
from hypre_tpu_torch.parallel import (  # noqa: E402
    GenPartition, RowPartition, StackedComm,
)
from hypre_tpu_torch.parallel.par_setup import (  # noqa: E402
    C_PT, build_level_comm, iter_par_hierarchy, level_halo, par_pmis,
    par_spgemm, par_strength, par_transpose, pardell_from_scipy,
    pardell_to_scipy, real_rows,
)
from hypre_tpu_torch.setup import device_amg as dev  # noqa: E402
from hypre_tpu_torch.solvers import BoomerAMG, pcg  # noqa: E402
from hypre_tpu_torch.solvers.amg import AmgConfig  # noqa: E402
from hypre_tpu_torch.solvers.par_amg import ParBoomerAMG  # noqa: E402


@pytest.fixture(scope="module")
def golden():
    return par_golden()


def _rand_sparse(n, m, seed):
    """The reference test's banded random pattern (test_par_setup.py)."""
    rng = np.random.RandomState(seed)
    bw = max(m // 4, 2)
    rows = np.repeat(np.arange(n), 3)
    cols = np.clip((rows * m) // n + rng.randint(-bw, bw + 1, rows.shape),
                   0, m - 1)
    A = sp.csr_matrix((rng.rand(rows.size) + 0.1, (rows, cols)),
                      shape=(n, m))
    A.sum_duplicates()
    return A


def test_pardell_roundtrip_matches_reference():
    from hypre_tpu.parallel.par_setup import pardell_from_scipy as ref_pd
    from hypre_tpu.parallel.partition import RowPartition as RefRow

    A = _rand_sparse(37, 53, 0)
    mine = pardell_from_scipy(A, RowPartition.create(37, 8),
                              RowPartition.create(53, 8))
    theirs = ref_pd(A, RefRow.create(37, 8), RefRow.create(53, 8))
    np.testing.assert_array_equal(mine.cols.numpy(), np.asarray(theirs.cols))
    np.testing.assert_array_equal(mine.vals.numpy(), np.asarray(theirs.vals))
    assert abs(pardell_to_scipy(mine) - A).max() == 0


def test_par_transpose_matches_reference():
    """R = M^T onto an unequal (GenPartition) output partition: scipy's
    exactly, and the reference's par_transpose slot for slot."""
    from hypre_tpu.parallel.par_setup import (
        par_transpose as ref_t, pardell_from_scipy as ref_pd,
    )
    from hypre_tpu.parallel.partition import (
        GenPartition as RefGen, RowPartition as RefRow,
    )

    A = _rand_sparse(41, 29, 1)
    counts = [5, 3, 6, 2, 4, 4, 3, 2]
    M = pardell_from_scipy(A, RowPartition.create(41, 8),
                           GenPartition.create(counts))
    R = par_transpose(M)
    assert abs(pardell_to_scipy(R) - A.T.tocsr()).max() == 0
    Rr = ref_t(ref_pd(A, RefRow.create(41, 8), RefGen.create(counts)),
               mesh8())
    np.testing.assert_array_equal(R.cols.numpy(), np.asarray(Rr.cols))
    np.testing.assert_array_equal(R.vals.numpy(), np.asarray(Rr.vals))


def test_par_spgemm_matches_scipy():
    A = _rand_sparse(40, 32, 2)
    B = _rand_sparse(32, 24, 3)
    X = pardell_from_scipy(A, RowPartition.create(40, 8),
                           RowPartition.create(32, 8))
    Y = pardell_from_scipy(B, RowPartition.create(32, 8),
                           RowPartition.create(24, 8))
    C = pardell_to_scipy(par_spgemm(X, Y))
    np.testing.assert_allclose(C.toarray(), (A @ B).toarray(), atol=1e-12)


def test_strength_and_pmis_match_reference():
    """par_strength and par_pmis on the reference's own level-0 ParDEll
    (convert.pardell_from_numpy): the same strong mask and C/F split."""
    from hypre_tpu.gen import laplacian as ref_lap
    from hypre_tpu.parallel.par_setup import (
        build_level_comm as ref_blc, par_pmis as ref_pmis,
        par_strength as ref_strength, pardell_from_scipy as ref_pd,
    )
    from hypre_tpu.parallel.partition import RowPartition as RefRow

    A = ref_lap(12, 12, 12)
    part = RefRow.create(A.shape[0], 8)
    Ar = ref_pd(A, part, real_dtype=np.float64)
    ce, cp = ref_blc(Ar)
    st_r = np.asarray(ref_strength(ce, Ar.vals))
    cf_r = np.asarray(ref_pmis(ce, ref_strength(ce, Ar.vals), cp, part,
                               mesh8()))
    M = pardell_from_numpy(np.asarray(Ar.cols), np.asarray(Ar.vals),
                           part_dict(part), part_dict(part), StackedComm(8))
    ce_p, cp_p = build_level_comm(M)
    np.testing.assert_array_equal(ce_p.numpy(), np.asarray(ce))
    np.testing.assert_array_equal(cp_p.send_idx, np.asarray(cp.send_idx))
    strong = par_strength(M)
    ns, w, nl = M.cols.shape
    np.testing.assert_array_equal(
        strong.reshape(w, ns, nl).permute(1, 0, 2).numpy(), st_r)
    cf = par_pmis(M, level_halo(M, M.communicator), strong)
    np.testing.assert_array_equal(cf.numpy(), cf_r)


@pytest.mark.parametrize("interp", [3, 6])
def test_par_hierarchy_matches_reference_and_device(golden, interp):
    """12^3, 3 levels: the C/F splits equal the reference's distributed
    ones exactly and its operators to atol 1e-10; and every level equals
    the port's single-device device setup bit for bit."""
    n = 12
    A = laplacian(n, n, n)
    cfg = AmgConfig(interp_type=interp, relax_type=18, max_levels=3)
    Ap = pardell_from_scipy(A, RowPartition.create(A.shape[0], 8))
    items = list(iter_par_hierarchy(Ap, cfg))
    dev_items = list(dev.iter_device_hierarchy(dev.dell_from_scipy(A), cfg))
    assert len(items) == len(dev_items)
    for l, ((Al, Pl, Rl, cf), (Ad, Pd, Rd, cfd)) in enumerate(
            zip(items[:-1], dev_items[:-1])):
        cf_true = cf.reshape(-1)[real_rows(Al.row_part, "cpu").reshape(-1)]
        np.testing.assert_array_equal(cf_true.numpy(),
                                      golden[f"hier{interp}/L{l}/cf"])
        assert torch.equal(cf_true, cfd)
        for name, M, Md in (("A", Al, Ad), ("P", Pl, Pd), ("R", Rl, Rd)):
            S = pardell_to_scipy(M)
            G = golden_csr(golden, f"hier{interp}/L{l}/{name}")
            assert S.shape == G.shape
            assert abs(S - G).max() <= 1e-10 if S.nnz else G.nnz == 0
            assert abs(S - dev.dell_to_scipy(Md)).max() == 0, name
    S = pardell_to_scipy(items[-1])
    assert abs(S - golden_csr(golden, f"hier{interp}/final")).max() <= 1e-9
    assert abs(S - dev.dell_to_scipy(dev_items[-1])).max() == 0


def test_par_hierarchy_never_materializes_global():
    """Every level's stacked arrays hold n_local rows a shard
    (test_par_setup.py:177): no shard-level buffer scales with the
    global size."""
    A = laplacian(10, 10, 10)
    cfg = AmgConfig(interp_type=3, relax_type=18, max_levels=3)
    Ap = pardell_from_scipy(A, RowPartition.create(A.shape[0], 8))
    for item in iter_par_hierarchy(Ap, cfg):
        if isinstance(item, tuple):
            Al = item[0]
            n_glob = Al.row_part.n_global
            assert Al.cols.shape[2] <= 2 * -(-n_glob // 8)
            assert Al.cols.shape[1] * Al.cols.shape[2] < n_glob * \
                Al.cols.shape[1]


@pytest.mark.parametrize("key,kw,stencil", [
    ("pcg_12", {}, False), ("stencil_12_l4", {"max_levels": 4}, True)])
def test_setup_distributed_solve(golden, key, kw, stencil):
    """setup_distributed then the distributed PCG at 12^3 (interp 6,
    relax 18): the reference's count and x, and within one iteration of
    the port's single-device device setup."""
    n = 12
    A = laplacian(n, n, n)
    b = np.ones(A.shape[0])
    cfg = AmgConfig(interp_type=6, relax_type=18, **kw)
    fine = ((n, n, n), LAPLACE_7PT) if stencil else None
    par = ParBoomerAMG(8, cfg).setup_distributed(A, fine_stencil=fine)
    assert (par.hierarchy.levels[0].stencil is not None) == stencil
    x, it, rel = par.solve(b, tol=1e-8, max_iter=200)
    g = f"dist/{key}"
    assert it == int(golden[f"{g}/iters"])
    assert par.level_sizes == golden[f"{g}/levels"].tolist()
    assert np.abs(x - golden[f"{g}/x"]).max() <= 1e-10 * np.abs(
        golden[f"{g}/x"]).max()
    assert abs(rel - float(golden[f"{g}/relres"])) <= 1e-6 * rel
    ref = BoomerAMG(cfg).setup_device(stencil=((n, n, n), LAPLACE_7PT))
    res = pcg(ref.hierarchy.levels[0].A, b, M=ref, tol=1e-8, max_iter=200)
    assert abs(it - res.iters) <= 1
    for cfp, lvl in zip(par.level_cf, range(len(par.level_cf))):
        assert int((cfp == C_PT).sum()) == par.level_sizes[lvl + 1]


def test_setup_distributed_refuses_host_smoothers():
    with pytest.raises(ValueError):
        ParBoomerAMG(8, AmgConfig(relax_type=13)).setup_distributed(
            laplacian(6, 6, 6))
