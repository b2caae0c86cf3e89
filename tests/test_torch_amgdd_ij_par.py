"""The port's distributed IJ assembly and AMG-DD against hypre_tpu's.

ParIJ assembly and AMG-DD's composite grids are compared with the
reference's called directly (its assembly is one jitted reduce, its
AMG-DD setup host numpy); the reference's AMG-DD solves and the
distributed setup on the assembled operator are read from
tests/golden/par_reference.npz (tools/par_reference_counts.py)."""
import numpy as np
import pytest
import torch

from torch_port_helpers import mesh8, par_golden

torch.set_num_threads(1)

from hypre_tpu_torch import Config, set_config  # noqa: E402

set_config(Config(device="cpu"))

from hypre_tpu_torch.gen import laplacian  # noqa: E402
from hypre_tpu_torch.parallel.amgdd import AmgDD, _bfs  # noqa: E402
from hypre_tpu_torch.parallel.ij_par import (  # noqa: E402
    ParIJMatrix, ParIJVector,
)
from hypre_tpu_torch.parallel.par_setup import pardell_to_scipy  # noqa: E402
from hypre_tpu_torch.solvers.amg import AmgConfig  # noqa: E402
from hypre_tpu_torch.solvers.par_amg import ParBoomerAMG  # noqa: E402


@pytest.fixture(scope="module")
def golden():
    return par_golden()


def _both_ij(n_global, n_shards, calls):
    """The port's and the reference's ParIJMatrix after the same calls
    (shard, "set" | "add", rows, cols, values); both assembled."""
    from hypre_tpu.parallel.ij_par import ParIJMatrix as RefIJ

    mine, ref = ParIJMatrix(n_global, n_shards), RefIJ(n_global, n_shards)
    for shard, kind, r, c, v in calls:
        for ij in (mine, ref):
            getattr(ij, "set_values" if kind == "set" else
                    "add_to_values")(shard, r, c, v)
    return mine.assemble(), ref.assemble()


def test_offproc_assembly_matches_reference():
    """Every entry inserted from the wrong shard (test_ij_par.py:12):
    routed to its owner; the ParDEll equals the reference's array for
    array and scipy's matrix exactly."""
    A = laplacian(6, 6, 6).tocoo()
    calls = [((s + 3) % 8, "add", A.row[A.row % 8 == s],
              A.col[A.row % 8 == s], A.data[A.row % 8 == s])
             for s in range(8)]
    M, R = _both_ij(216, 8, calls)
    np.testing.assert_array_equal(M.cols.numpy(), np.asarray(R.cols))
    np.testing.assert_array_equal(M.vals.numpy(), np.asarray(R.vals))
    assert abs(pardell_to_scipy(M) - A.tocsr()).max() == 0


def test_set_overrides_add_matches_reference():
    """hypre's sequence semantics (test_ij_par.py:27): a later SET
    overrides, ADDs accumulate on the last SET, in (shard, call) order;
    a duplicated set of random values on top."""
    rng = np.random.RandomState(4)
    calls = [(0, "add", [1], [2], [5.0]), (1, "set", [1], [2], [7.0]),
             (2, "add", [1], [2], [1.0]), (0, "add", [3], [3], [2.0]),
             (3, "add", [3], [3], [4.0])]
    for k in range(20):
        r = rng.randint(0, 16, 5)
        calls.append((k % 4, "set" if k % 3 == 0 else "add", r,
                      rng.randint(0, 16, 5), rng.randn(5)))
    M, R = _both_ij(16, 4, calls)
    B = pardell_to_scipy(M)
    np.testing.assert_array_equal(M.cols.numpy(), np.asarray(R.cols))
    np.testing.assert_array_equal(M.vals.numpy(), np.asarray(R.vals))
    M2, _ = _both_ij(16, 4, calls[:5])
    B2 = pardell_to_scipy(M2)
    assert B2[1, 2] == 8.0 and B2[3, 3] == 6.0
    assert B.nnz > 0


def test_par_ij_vector_matches_reference():
    from hypre_tpu.parallel.ij_par import ParIJVector as RefVec

    v, r = ParIJVector(12, 4), RefVec(12, 4)
    for obj in (v, r):
        obj.set_values(0, [5], [3.0])
        obj.add_to_values(2, [5], [2.0])
        obj.add_to_values(1, [0, 11], [1.5, -2.0])
        obj.set_values(3, [11], [4.0])
    np.testing.assert_array_equal(v.assemble(), r.assemble())


def test_assembled_matrix_drives_distributed_amg(golden):
    """The 10^3 Laplacian assembled shard by shard drives
    setup_distributed (interp 3) and the PCG (test_ij_par.py:41): the
    reference's count and x."""
    n = 10
    A = laplacian(n, n, n)
    Ac = A.tocoo()
    ij = ParIJMatrix(A.shape[0], 8)
    owner = Ac.row * 8 // A.shape[0]
    for s in range(8):
        sel = owner == s
        ij.add_to_values(s, Ac.row[sel], Ac.col[sel], Ac.data[sel])
    par = ParBoomerAMG(8, AmgConfig(interp_type=3, relax_type=18)
                       ).setup_distributed(ij.assemble())
    b = np.ones(A.shape[0])
    x, it, rel = par.solve(b, method="pcg", tol=1e-8, max_iter=100)
    assert it == int(golden["dist/ij_10/iters"])
    xr = golden["dist/ij_10/x"]
    assert np.abs(x - xr).max() <= 1e-10 * np.abs(xr).max()
    assert abs(rel - float(golden["dist/ij_10/relres"])) <= 1e-6 * rel


def test_composite_grids_match_reference():
    """AMG-DD's composite index sets and stacked per-level arrays equal
    the reference's (its setup is host numpy): owned rows, the padding
    ring and the ghost layer (test_amgdd.py:16)."""
    from hypre_tpu.gen import laplacian as ref_lap
    from hypre_tpu.parallel.amgdd import AmgDD as RefDD
    from hypre_tpu.solvers.amg import AmgConfig as RefCfg

    n = 10
    ref = RefDD(mesh8(), RefCfg(interp_type=3, relax_type=18),
                padding=1).setup(ref_lap(n, n, n))
    A = laplacian(n, n, n)
    dd = AmgDD(8, AmgConfig(interp_type=3, relax_type=18), padding=1).setup(A)
    assert len(dd.levels) == len(ref.levels)
    for p in range(8):
        np.testing.assert_array_equal(dd.comp_gids0[p], ref.comp_gids0[p])
    for mine, theirs in zip(dd.levels, ref.levels):
        for f in ("dinv", "real_mask"):
            np.testing.assert_array_equal(getattr(mine, f).numpy(),
                                          np.asarray(getattr(theirs, f)))
        ac, av = np.asarray(theirs.a_cols), np.asarray(theirs.a_vals)
        ns, w, m = ac.shape
        rows = np.broadcast_to((np.arange(ns)[:, None, None] * m
                                + np.arange(m)[None, None, :]), ac.shape)
        keep = ac >= 0
        import scipy.sparse as sp

        ref_A = sp.csr_matrix((av[keep], (rows[keep], (ac + np.arange(ns)[
            :, None, None] * m)[keep])), shape=(ns * m, ns * m))
        mine_A = sp.csr_matrix((mine.A.values.numpy(), mine.A.indices.numpy(),
                                mine.A.indptr.numpy()), shape=mine.A.shape)
        assert abs(ref_A - mine_A).max() == 0
    assert dd.comm_pkg.n_ghost == ref.comm.n_ghost
    nl = dd.fine_part.n_local
    for p, ids in enumerate(dd.comp_gids0):
        owned = np.arange(p * nl, min((p + 1) * nl, A.shape[0]))
        assert np.isin(_bfs(A.tocsr(), owned, 1), ids).all()
        assert len(ids) < 0.6 * A.shape[0]


def test_amgdd_converges_with_one_composite_gather_per_iteration(golden):
    """12^3, padding 1, 2 FAC cycles: the reference's relative residual
    after each of the first 5 outer iterations and its converged count
    and x; exactly one composite gather (the fine-level exchange onto
    the composite grids) an iteration (test_amgdd.py:33)."""
    n = 12
    A = laplacian(n, n, n)
    b = np.ones(A.shape[0])
    dd = AmgDD(8, AmgConfig(interp_type=6, relax_type=18), padding=1,
               fac_cycles=2).setup(A)
    hist = []
    for k in range(1, 6):
        hist.append(dd.solve(b, tol=1e-30, max_iter=k)[2])
    np.testing.assert_allclose(hist, golden["amgdd/hist_12"], rtol=1e-6)
    dd.composite_gathers = 0
    x, it, rel = dd.solve(b, tol=1e-8, max_iter=120)
    assert dd.composite_gathers == it
    assert it == int(golden["amgdd/solve_12/iters"])
    xr = golden["amgdd/solve_12/x"]
    assert np.abs(x - xr).max() <= 1e-10 * np.abs(xr).max()
    assert abs(rel - float(golden["amgdd/solve_12/relres"])) <= 1e-6 * rel
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-7


def test_amgdd_padding_improves_rate(golden):
    """Padding 2 converges in fewer outer iterations than padding 1
    (test_amgdd.py:53), both in the reference's counts."""
    n = 10
    A = laplacian(n, n, n)
    b = np.ones(A.shape[0])
    its = []
    for eta in (1, 2):
        dd = AmgDD(8, AmgConfig(interp_type=3, relax_type=18), padding=eta,
                   fac_cycles=1).setup(A)
        _, it, rel = dd.solve(b, tol=1e-6, max_iter=200)
        assert rel <= 1e-6
        assert it == int(golden[f"amgdd/pad{eta}_10/iters"])
        its.append(it)
    assert its[1] < its[0]
