"""The port's distributed struct solvers (8 stacked z-slab shards)
against hypre_tpu's on 8 virtual devices and against the single-device
solvers.

The reference's ParPFMG, ParSMG and ParSysPFMG compile for tens of
seconds each, so their counts, residuals and solutions are read from
tests/golden/par_reference.npz (tools/par_reference_counts.py)."""
import numpy as np
import pytest
import torch

from torch_port_helpers import par_golden

torch.set_num_threads(1)

from hypre_tpu_torch import Config, set_config  # noqa: E402

set_config(Config(device="cpu"))

from hypre_tpu_torch.parallel import StackedComm  # noqa: E402
from hypre_tpu_torch.solvers import pcg  # noqa: E402
from hypre_tpu_torch.struct import (  # noqa: E402
    PFMG, SMG, PfmgConfig, SysPFMG, struct_laplacian,
    struct_matrix_from_stencil, struct_matvec,
)
from hypre_tpu_torch.struct.par_struct import (  # noqa: E402
    ParPFMG, ParSMG, ParSysPFMG, par_struct_pcg,
)
from hypre_tpu_torch.struct.smg import SmgConfig  # noqa: E402

LAP7 = [((0, 0, 0), 6.0), ((0, 0, -1), -1.0), ((0, 0, 1), -1.0),
        ((0, -1, 0), -1.0), ((0, 1, 0), -1.0),
        ((-1, 0, 0), -1.0), ((1, 0, 0), -1.0)]


@pytest.fixture(scope="module")
def golden():
    return par_golden()


def _coupled(shape, c=0.15):
    L = struct_laplacian(*shape)
    B = struct_matrix_from_stencil(shape, [((0, 0, 0), c),
                                           ((0, 0, 1), 0.5 * c)])
    Bt = struct_matrix_from_stencil(shape, [((0, 0, 0), c),
                                            ((0, 0, -1), 0.5 * c)])
    return {(0, 0): L, (0, 1): B, (1, 0): Bt, (1, 1): L}


def _rel(a, b):
    a = a.numpy().ravel() if hasattr(a, "numpy") else np.ravel(a)
    return np.abs(a - np.ravel(b)).max() / np.abs(b).max()


def _hold_to_both(golden, par, one, x, it, rel):
    """Held to the reference's partitioned run (`par`) and to its
    single-chip run (`one`) of the same problem: equal counts; x and
    relres each within twice the gap between those two runs (and never
    worse than 1e-10 / rtol 1e-6 where that gap is smaller).  The
    reference's partitioner reorders sums, so its two runs part by ~2e-10
    in x and 1% in relres on PFMG (test_par_struct.py:34 bounds that gap
    absolutely); the port, whose sums follow neither, can be held no
    closer than they agree with each other."""
    assert it == int(golden[f"{par}/iters"]) == int(golden[f"{one}/iters"])
    x_gap = max(_rel(golden[f"{one}/x"], golden[f"{par}/x"]), 5e-11)
    r_one = float(golden[f"{one}/relres"])
    r_par = float(golden[f"{par}/relres"])
    r_gap = max(abs(r_one - r_par), 1e-6 * r_one)
    for key, r in ((one, r_one), (par, r_par)):
        assert _rel(x, golden[f"{key}/x"]) <= 2 * x_gap
        assert abs(rel - r) <= 2 * r_gap


def test_par_pfmg_matches_reference(golden):
    """(32, 16, 16) on 8 slabs against the reference's ParPFMG and its
    single-chip PFMG."""
    A = struct_matrix_from_stencil((32, 16, 16), LAP7)
    x, it, rel = ParPFMG(8, PfmgConfig(tol=1e-7, max_iter=60)).setup(
        A).solve(np.ones((32, 16, 16)))
    _hold_to_both(golden, "struct/pfmg_32_16_16",
                  "struct_single/pfmg_32_16_16", x, it, rel)


def test_par_struct_pcg_matches_reference(golden):
    """CG + the distributed PFMG cycle at 16^3, against the reference's
    par_struct_pcg and its single-chip CG + PFMG."""
    A = struct_matrix_from_stencil((16, 16, 16), LAP7)
    res = par_struct_pcg(ParPFMG(8, PfmgConfig()).setup(A),
                         np.ones((16, 16, 16)), tol=1e-7, max_iter=60)
    _hold_to_both(golden, "struct/pcg_16", "struct_single/pcg_16", res.x,
                  res.iters, res.relres)


def test_par_smg_matches_reference(golden):
    A = struct_matrix_from_stencil((32, 8, 8), LAP7)
    x, it, rel = ParSMG(8, SmgConfig(tol=1e-7, max_iter=40)).setup(
        A).solve(np.ones((32, 8, 8)))
    key = "struct/smg_32_8_8"
    assert it == int(golden[f"{key}/iters"])
    assert _rel(x, golden[f"{key}/x"]) <= 1e-10
    assert abs(rel - float(golden[f"{key}/relres"])) <= 1e-6 * rel


def test_par_sys_pfmg_matches_reference(golden):
    shape = (16, 8, 8)
    x, it, rel = ParSysPFMG(8, PfmgConfig(tol=1e-7, max_iter=60)).setup(
        _coupled(shape), 2, shape).solve(np.ones((2,) + shape))
    key = "struct/sys_16_8_8"
    assert it == int(golden[f"{key}/iters"])
    assert _rel(x, golden[f"{key}/x"]) <= 1e-10
    assert abs(rel - float(golden[f"{key}/relres"])) <= 1e-6 * rel


@pytest.mark.parametrize("shape", [(32, 16, 16), (30, 12, 10), (17, 9, 8),
                                   (6, 8, 8)])
def test_par_pfmg_equals_single_device(shape):
    """The slab engine computes the single-device cycle's values bit for
    bit, with padded slabs (30, 17) and with level 0 replicated (6 < 8
    shards)."""
    A = struct_matrix_from_stencil(shape, LAP7)
    b = np.ones(shape)
    x1, it1, _ = PFMG(PfmgConfig(tol=1e-7, max_iter=60)).setup(A).solve(b)
    x2, it2, _ = ParPFMG(8, PfmgConfig(tol=1e-7, max_iter=60)).setup(
        A).solve(b)
    assert it1 == it2
    assert torch.equal(x1, x2)


@pytest.mark.parametrize("shape", [(32, 8, 8), (20, 6, 6)])
def test_par_smg_equals_single_device(shape):
    A = struct_matrix_from_stencil(shape, LAP7)
    cfg = SmgConfig(tol=1e-7, max_iter=40)
    x1, it1, _ = SMG(cfg).setup(A).solve(np.ones(shape))
    x2, it2, _ = ParSMG(8, cfg).setup(A).solve(np.ones(shape))
    assert it1 == it2
    assert torch.equal(x1, x2)


def test_par_sys_pfmg_equals_single_device():
    shape = (24, 6, 6)
    blocks = _coupled(shape)
    cfg = PfmgConfig(tol=1e-7, max_iter=60)
    x1, it1, _ = SysPFMG(cfg).setup(blocks, 2, shape).solve(
        np.ones((2,) + shape))
    x2, it2, _ = ParSysPFMG(8, cfg).setup(blocks, 2, shape).solve(
        np.ones((2,) + shape))
    assert it1 == it2
    assert torch.equal(x1, x2)


def test_par_struct_cg_pfmg_converges():
    A = struct_matrix_from_stencil((16, 16, 16), LAP7)
    res = par_struct_pcg(ParPFMG(8, PfmgConfig()).setup(A),
                         np.ones((16, 16, 16)), tol=1e-7, max_iter=60)
    b = torch.ones((16, 16, 16), dtype=torch.float64)
    r = b - struct_matvec(A, res.x)
    assert float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b)) \
        <= 1e-7
    assert res.iters <= 15
    m = PFMG(PfmgConfig()).setup(A)
    ref = pcg(lambda v: struct_matvec(A, v), b, M=m.precondition, tol=1e-7,
              max_iter=60)
    assert ref.iters == res.iters


@pytest.mark.parametrize("kind", ["pfmg", "smg"])
def test_cycle_halos_are_exchanges(kind):
    """The analog of the reference's "halo is collective-permute" checks
    (test_par_struct.py:38, test_par_smg.py:36): one cycle moves its
    halos by exchanges of one plane a side, and its only all_gather is
    the restriction into the first replicated level, no larger than that
    level in slabs."""
    comm = StackedComm(8)
    if kind == "pfmg":
        A = struct_matrix_from_stencil((32, 16, 16), LAP7)
        par = ParPFMG(comm, PfmgConfig()).setup(A)
    else:
        A = struct_matrix_from_stencil((32, 8, 8), LAP7)
        par = ParSMG(comm, SmgConfig()).setup(A)
    b = par.to_level0(torch.ones((1,) + tuple(A.shape),
                                 dtype=torch.float64))
    comm.exchanges, comm.gathered = 0, []
    par.cycle(b)
    sharded = [p for p in par.levels if p.slabs is not None]
    assert comm.exchanges > 0
    for p in sharded:
        # a halo is one plane a side, of every variable
        ny, nx = p.slabs.plane
        assert p.slabs.halo.n_ghost == 2 * p.slabs.nv * ny * nx
    assert len(comm.gathered) == 1
    first_rep = par.levels[len(sharded)].level
    rep_size = int(np.prod(first_rep.fine_shape))
    last = sharded[-1]
    assert comm.gathered[0] <= 8 * max(last.slabs.nzl // 2, 1) \
        * rep_size // first_rep.fine_shape[0]
    assert comm.gathered[0] < int(np.prod(last.level.fine_shape)) * 2
