"""The port's partitions, CommPkg, ParCSR, stencil operator and the two
communicators against hypre_tpu's distributed layer.

The reference runs its shard_map programs on the 8 virtual CPU devices
of tests/conftest.py; the port runs every shard stacked in this process
(StackedComm), and one test runs it on four gloo ranks (DistComm)."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from torch_port_helpers import (
    LAPLACE_7PT, comm_dict, mesh8, parcsr_dict, ref_shard_matvec,
)

torch.set_num_threads(1)

from hypre_tpu_torch import Config, set_config  # noqa: E402

set_config(Config(device="cpu"))

from hypre_tpu_torch.convert import parcsr_from_numpy  # noqa: E402
from hypre_tpu_torch.gen import laplacian  # noqa: E402
from hypre_tpu_torch.parallel import (  # noqa: E402
    GenPartition, RowPartition, StackedComm, build_comm_pkg, par_matvec,
    parcsr_from_scipy, shard_vector, unshard_vector,
)
from hypre_tpu_torch.parallel.parcsr import (  # noqa: E402
    par_stencil_matvec, par_stencil_op,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _rect(seed=2):
    rng = np.random.RandomState(seed)
    return sp.random(200, 77, density=0.05, random_state=rng,
                     format="csr"), rng.randn(77)


CASES = {"square": lambda: (laplacian(12, 12, 12), np.random.RandomState(
             0).randn(1728)),
         "unaligned": lambda: (laplacian(13, 7), np.random.RandomState(
             1).randn(91)),
         "rectangular": _rect}


def _port_matvec(A, x, n_shards=8):
    Ap = parcsr_from_scipy(A, n_shards)
    y = par_matvec(Ap, torch.as_tensor(shard_vector(x, Ap.col_part)))
    return unshard_vector(y.numpy(), Ap.row_part), Ap


def test_partitions_match_reference():
    from hypre_tpu.parallel.partition import (
        GenPartition as RefGen, RowPartition as RefRow,
    )

    gids = np.arange(0, 60)
    for a, b in ((RowPartition.create(53, 8), RefRow.create(53, 8)),
                 (GenPartition.create([5, 3, 6, 2, 0, 4, 3, 2]),
                  RefGen.create([5, 3, 6, 2, 0, 4, 3, 2]))):
        assert a.n_local == b.n_local and a.n_padded == b.n_padded
        np.testing.assert_array_equal(a.owner(gids), b.owner(gids))
        np.testing.assert_array_equal(a.local_index(gids),
                                      b.local_index(gids))
        np.testing.assert_array_equal(a.shard_starts(), b.shard_starts())


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_comm_pkg_matches_reference(case):
    """The port's schedule equals the reference's array for array."""
    from hypre_tpu.parallel.comm import build_comm_pkg as ref_build
    from hypre_tpu.parallel.parcsr import parcsr_from_scipy as ref_parcsr
    from hypre_tpu.parallel.partition import RowPartition as RefRow

    A, _ = CASES[case]()
    ref = ref_parcsr(A, 8)
    # the ghost lists the reference compressed, rebuilt from its offd
    ghosts = []
    cp = RefRow.create(A.shape[1], 8)
    for p in range(8):
        rows = A.tocsr()[min(p * ref.row_part.n_local, A.shape[0]):
                         min((p + 1) * ref.row_part.n_local, A.shape[0])]
        c = rows.tocoo().col
        ghosts.append(np.unique(c[cp.owner(c) != p]))
    mine = build_comm_pkg(ghosts, RowPartition.create(A.shape[1], 8))
    theirs = ref_build(ghosts, cp)
    for k in ("send_idx", "send_mask", "recv_idx"):
        np.testing.assert_array_equal(getattr(mine, k),
                                      np.asarray(getattr(theirs, k)))
    assert mine.offsets == theirs.offsets
    assert mine.n_ghost == theirs.n_ghost
    d = comm_dict(ref.comm)
    np.testing.assert_array_equal(mine.recv_idx, d["recv_idx"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_parcsr_blocks_match_reference(case):
    """parcsr_from_scipy's stacked CSR blocks equal the reference's ELL
    blocks carried across (convert.parcsr_from_numpy)."""
    from hypre_tpu.parallel.parcsr import parcsr_from_scipy as ref_parcsr

    A, _ = CASES[case]()
    mine = parcsr_from_scipy(A, 8)
    theirs = parcsr_from_numpy(parcsr_dict(ref_parcsr(A, 8)),
                               mine.communicator)
    for blk in ("diag", "offd"):
        a, b = getattr(mine, blk), getattr(theirs, blk)
        assert a.shape == b.shape
        for f in ("indptr", "indices", "values"):
            torch.testing.assert_close(getattr(a, f), getattr(b, f),
                                       rtol=0, atol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_par_matvec_matches_reference(case):
    """8 shards, square / unaligned / rectangular (test_parallel.py:
    39-70): the reference's shard_map par_matvec and the port's stacked
    one agree to 1e-14 relative; both equal scipy's to 1e-12."""
    from hypre_tpu.parallel.parcsr import (
        par_matvec as ref_matvec, parcsr_from_scipy as ref_parcsr,
        shard_vector as ref_shard,
    )

    A, x = CASES[case]()
    y, Ap = _port_matvec(A, x)
    Ar = ref_parcsr(A, 8)
    yr = unshard_vector(ref_shard_matvec(ref_matvec, Ar, ref_shard(
        x, Ar.col_part)), Ap.row_part)
    scale = np.abs(A) @ np.abs(x)
    assert np.abs(y - yr).max() <= 1e-14 * scale.max()
    np.testing.assert_allclose(y, A @ x, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_par_matvec_any_shard_count(n_shards):
    A, x = CASES["square"]()
    y, _ = _port_matvec(A, x, n_shards)
    np.testing.assert_allclose(y, A @ x, rtol=1e-12, atol=1e-13)


def test_par_stencil_matvec_matches_reference():
    """The matrix-free stencil fine level (test_parallel.py:169) on 8
    slabs: the reference's shard_map and the port's exchange halo agree
    and equal the stored operator."""
    from hypre_tpu.parallel.parcsr import (
        ParStencilOp as RefOp, par_stencil_matvec as ref_st,
    )

    nx, ny, nz = 16, 16, 8
    A = laplacian(nx, ny, nz)
    part = RowPartition.create(A.shape[0], 8)
    x = np.random.RandomState(3).randn(A.shape[0])
    comm = StackedComm(8)
    op = par_stencil_op((nx, ny, nz), LAPLACE_7PT, part.n_local, comm,
                        torch.float64)
    y = unshard_vector(par_stencil_matvec(op, torch.as_tensor(
        shard_vector(x, part))).numpy(), part)
    ref = RefOp(shape=(nx, ny, nz), arms=tuple(
        (tuple(d), v) for d, v in LAPLACE_7PT), n_local=part.n_local,
        n_shards=8)
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    f = jax.jit(jax.shard_map(lambda v: ref_st(ref, v[0])[None, :],
                              mesh=mesh8(), in_specs=(P("p", None),),
                              out_specs=P("p", None), check_vma=False))
    yr = unshard_vector(np.asarray(f(jax.device_put(
        shard_vector(x, part), NamedSharding(mesh8(), P("p", None))))), part)
    np.testing.assert_allclose(y, yr, rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(y, A @ x, rtol=1e-12, atol=1e-13)


def test_exchange_rev_sums_in_round_order():
    """The reverse exchange adds every ghost contribution into its owner
    row; duplicates (a row that is a ghost of several shards) sum."""
    A = laplacian(12, 12, 12)
    Ap = parcsr_from_scipy(A, 8)
    comm = Ap.communicator
    cp = Ap.comm
    g = torch.ones((8, cp.n_ghost), dtype=torch.float64)
    out = comm.exchange_rev(g, cp, Ap.col_part.n_local)
    # each row is counted once a shard that holds it as a ghost
    expect = np.zeros((8, Ap.col_part.n_local))
    for p in range(8):
        for r, off in enumerate(cp.offsets):
            k = int((cp.recv_idx[p, r] != cp.n_ghost).sum())
            q = p + off
            if 0 <= q < 8 and k:
                np.add.at(expect[q], cp.send_idx[q, r, :k], 1.0)
    np.testing.assert_array_equal(out.numpy(), expect)


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """One 4-rank gloo group (file:// rendezvous in a temporary
    directory, so xdist workers never share a port)."""
    tmp = tmp_path_factory.mktemp("gloo")
    out = tmp / "rank0.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT), str(ROOT / "tests")]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         "import torch_port_helpers as h; "
         f"h.gloo_worker({r}, 4, {str(tmp / 'rdv')!r}, {str(out)!r})"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(4)]
    errs = [p.communicate(timeout=120)[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), [e.decode()[-2000:]
                                                  for e in errs]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def test_gloo_dist_comm_equals_stacked(gloo_run):
    """DistComm on 4 gloo ranks against StackedComm(4): every level's A,
    P and R products and a reverse exchange bit for bit, the 12^3 PCG in
    the same iterations with x to 1e-12."""
    from torch_port_helpers import gloo_products

    from hypre_tpu_torch.parallel.parcsr import to_device_shards
    from hypre_tpu_torch.solvers.amg import AmgConfig
    from hypre_tpu_torch.solvers.par_amg import ParBoomerAMG

    ref = gloo_products(ParBoomerAMG(StackedComm(4), AmgConfig()), laplacian,
                        par_matvec, to_device_shards)
    assert set(ref) == set(gloo_run)
    for k in ref:
        if k in ("x", "iters", "relres"):
            continue
        if k == "exchange_rev":     # a row held by 2 shards: 2 terms
            np.testing.assert_allclose(gloo_run[k], ref[k], rtol=0,
                                       atol=1e-15)
            continue
        np.testing.assert_array_equal(gloo_run[k], ref[k], err_msg=k)
    assert int(gloo_run["iters"]) == int(ref["iters"])
    np.testing.assert_allclose(gloo_run["x"], ref["x"], rtol=0,
                               atol=1e-12 * np.abs(ref["x"]).max())
