"""The port's multi-box grids, SparseMSG, SysPFMG, FAC and sstruct layer
against hypre_tpu's, in f64 on the CPU.

* Boxes: the box algebra, owner lookup and StructGrid's masked operator
  (L-domain, periodic axes, identity rows) equal; PFMG on the L-domain
  takes the reference's iterations.
* SparseMSG: the lattice bit for bit (each grid's transfer levels:
  coefficients, wm, wp, dinv; the visit masks; children), the coarsest
  inverse to 1e-12; one cycle to 1e-12 relative and the standalone
  solve's iterations equal.  The reference's side of the cycle and the
  solve comes from tests/golden/struct_reference.npz
  (``python tools/struct_reference_counts.py fixtures``, its own
  process): the reference's SparseMSG can NaN in a process that ran the
  stencil transpose of tests/test_btake.py first, which an xdist draw
  may do, and its compiles take a minute a 16^3 case.
* SysPFMG: the hierarchy bit for bit (blocks, wm, wp, dinv), the
  coarsest inverse to 1e-12, one cycle to 1e-12 relative, iterations
  equal for relax 1 and 2.
* FAC: the composite operator, R, P and the Galerkin coarse operator
  bit for bit; one cycle to 1e-12 relative, the standalone solve's
  iterations equal.
* sstruct: the assembled CSR bit for bit; the Split-preconditioned and
  the BoomerAMG-preconditioned PCG take the reference's iterations.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (
    assert_csr_equal, assert_rel_close, assert_struct_level_equal,
)

from hypre_tpu.ops import sparse_op_from_scipy as ref_op
from hypre_tpu.solvers import AmgConfig as RefAmgConfig
from hypre_tpu.solvers import BoomerAMG as RefBoomerAMG
from hypre_tpu.solvers import pcg as ref_pcg
from hypre_tpu import sstruct as ref_sstruct
from hypre_tpu.struct import boxes as ref_boxes
from hypre_tpu.struct import fac as ref_fac
from hypre_tpu.struct import grid as ref_grid
from hypre_tpu.struct import pfmg as ref_pfmg
from hypre_tpu.struct import sparse_msg as ref_msg
from hypre_tpu.struct import sys_pfmg as ref_sys
from hypre_tpu_torch import Config, set_config
from hypre_tpu_torch import sstruct
from hypre_tpu_torch.ops import sparse_op_from_scipy
from hypre_tpu_torch.solvers import AmgConfig, BoomerAMG, pcg
from hypre_tpu_torch.struct import boxes, fac, grid, pfmg, sparse_msg, sys_pfmg

torch.set_num_threads(1)
# final relative residuals part by rounding alone (~1e-13 measured)
RELRES_ATOL = 1e-11
LAP7 = [((0, 0, 0), 6.0), ((0, 0, -1), -1.0), ((0, 0, 1), -1.0),
        ((0, -1, 0), -1.0), ((0, 1, 0), -1.0),
        ((-1, 0, 0), -1.0), ((1, 0, 0), -1.0)]
L5 = [((0, 0, 0), 4.0), ((0, 0, -1), -1.0), ((0, 0, 1), -1.0),
      ((0, -1, 0), -1.0), ((0, 1, 0), -1.0)]


@pytest.fixture(autouse=True)
def _cpu():
    set_config(Config(real_dtype=torch.float64, device="cpu"))


@pytest.fixture(scope="module")
def ref():
    """The reference's stored side (tools/struct_reference_counts.py
    fixtures)."""
    return np.load(pathlib.Path(__file__).parent / "golden" /
                   "struct_reference.npz")


# -- boxes -------------------------------------------------------------

def test_box_algebra_and_owner_lookup_match():
    pairs = [((0, 0, 0), (7, 7, 7)), ((4, 4, 4), (11, 11, 11)),
             ((2, 9, 0), (5, 12, 3))]
    for lo_a, hi_a in pairs:
        for lo_b, hi_b in pairs:
            ra, rb = ref_boxes.Box(lo_a, hi_a), ref_boxes.Box(lo_b, hi_b)
            pa, pb = boxes.Box(lo_a, hi_a), boxes.Box(lo_b, hi_b)
            ri, pi = ra.intersect(rb), pa.intersect(pb)
            assert (ri is None) == (pi is None)
            if ri is not None:
                assert (ri.imin, ri.imax) == (pi.imin, pi.imax)
            assert [(f.imin, f.imax) for f in ra.subtract(rb)] == \
                [(f.imin, f.imax) for f in pa.subtract(pb)]
    arr_r = ref_boxes.BoxArray([ref_boxes.Box(*p) for p in pairs])
    arr_p = boxes.BoxArray([boxes.Box(*p) for p in pairs])
    assert arr_r.volume == arr_p.volume
    assert [(b.imin, b.imax) for b in arr_r.union_disjoint()] == \
        [(b.imin, b.imax) for b in arr_p.union_disjoint()]
    q = np.random.default_rng(4).integers(-1, 13, size=(200, 3))
    bm_r, bm_p = ref_boxes.BoxManager(), boxes.BoxManager()
    for i, p in enumerate(pairs):
        bm_r.add_entry(ref_boxes.Box(*p), i)
        bm_p.add_entry(boxes.Box(*p), i)
    np.testing.assert_array_equal(bm_r.owners_of(q), bm_p.owners_of(q))


@pytest.mark.parametrize("case", ["L-domain", "periodic"])
def test_struct_grid_operator_matches(case):
    if case == "L-domain":
        args = ([((0, 0, 0), (7, 15, 15)), ((8, 0, 0), (15, 15, 7))],)
        kw = {}
    else:
        args = ([((0, 0, 0), (3, 5, 9))],)
        kw = {"periodic": (0, 1, 1)}
    g_r = ref_boxes.StructGrid([ref_boxes.Box(*b) for b in args[0]], **kw)
    g_p = boxes.StructGrid([boxes.Box(*b) for b in args[0]], **kw)
    A_r, A_p = g_r.matrix_from_stencil(LAP7), g_p.matrix_from_stencil(LAP7)
    assert A_p.periodic == tuple(A_r.periodic)
    np.testing.assert_array_equal(np.asarray(A_r.coefs), A_p.coefs.numpy())
    np.testing.assert_array_equal(g_r.vector(1.0), g_p.vector(1.0))
    u = np.random.default_rng(5).standard_normal(g_r.shape)
    assert_rel_close(ref_grid.struct_matvec(A_r, jnp.asarray(u)),
                     grid.struct_matvec(A_p, torch.as_tensor(u)), 1e-14)
    if case == "L-domain":
        b = g_r.vector(1.0)
        _, it_r, rel_r = ref_pfmg.PFMG(ref_pfmg.PfmgConfig()).setup(
            A_r).solve(b, tol=1e-8, max_iter=60)
        _, it, rel = pfmg.PFMG(pfmg.PfmgConfig()).setup(A_p).solve(
            b, tol=1e-8, max_iter=60)
        assert it == int(it_r)
        assert rel <= 1e-8 and abs(rel - float(rel_r)) <= RELRES_ATOL


# -- SparseMSG ---------------------------------------------------------

MSG_CASES = {"8^3": ((8, 8, 8), (1.0, 1.0, 1.0), 0),
             "16^3 jump 1": ((16, 16, 16), (1.0, 1.0, 1.0), 1),
             "16^3 anisotropic": ((16, 16, 16), (100.0, 1.0, 0.01), 0),
             "2-D 32^2 jump 1": ((1, 32, 32), (1.0, 1.0, 1.0), 1)}


def _msg(case):
    shape, c, jump = MSG_CASES[case]
    return sparse_msg.SparseMSG(sparse_msg.SparseMSGConfig(jump=jump)).setup(
        grid.struct_laplacian(*shape, *c))


@pytest.mark.parametrize("case", ["8^3", "2-D 32^2 jump 1"])
def test_sparse_msg_lattice_bit_for_bit(case):
    shape, c, jump = MSG_CASES[case]
    ref = ref_msg.SparseMSG(ref_msg.SparseMSGConfig(jump=jump)).setup(
        ref_grid.struct_laplacian(*shape, *c))
    port = _msg(case)
    assert port.fronts == ref.fronts
    assert list(port.grids) == list(ref.grids)
    for l, g_r in ref.grids.items():
        g_p = port.grids[l]
        assert g_p["children"] == g_r["children"]
        assert list(g_p["dirs"]) == list(g_r["dirs"])
        for d, lvl in g_r["dirs"].items():
            assert_struct_level_equal(lvl, g_p["dirs"][d],
                                      ("wm", "wp", "dinv", "rb_mask"))
        assert list(g_p["visit"]) == list(g_r["visit"])
        for d, m in g_r["visit"].items():
            np.testing.assert_array_equal(np.asarray(m),
                                          g_p["visit"][d].numpy())
    assert port._coarsest == ref._coarsest
    assert_rel_close(ref._c_inv, port._c_inv, 1e-12)


@pytest.mark.parametrize("case", list(MSG_CASES))
def test_sparse_msg_cycle_and_iterations(case, ref):
    shape = MSG_CASES[case][0]
    msg = _msg(case)
    b = np.random.default_rng(6).standard_normal(shape)
    assert_rel_close(ref[f"msg cycle {case}"], msg.cycle(torch.as_tensor(b)),
                     1e-12)
    it_ref, rel_ref = ref[f"msg solve {case}"]
    _, it, rel = msg.solve(np.ones(shape), tol=1e-8, max_iter=80)
    assert it == int(it_ref)
    assert rel <= 1e-8 and abs(rel - rel_ref) <= RELRES_ATOL


# -- SysPFMG -----------------------------------------------------------

def _coupled(g, shape, c=0.15):
    L = g.struct_laplacian(*shape)
    B = g.struct_matrix_from_stencil(shape,
                                     [((0, 0, 0), c), ((0, 0, 1), 0.5 * c)])
    Bt = g.struct_matrix_from_stencil(shape,
                                      [((0, 0, 0), c), ((0, 0, -1), 0.5 * c)])
    return {(0, 0): L, (0, 1): B, (1, 0): Bt, (1, 1): L}


@pytest.mark.parametrize("shape,relax", [((6, 8, 8), 1), ((4, 6, 6), 2)])
def test_sys_pfmg_matches(shape, relax):
    cfg = dict(relax_type=relax)
    ref = ref_sys.SysPFMG(ref_pfmg.PfmgConfig(**cfg)).setup(
        _coupled(ref_grid, shape), 2, shape)
    port = sys_pfmg.SysPFMG(pfmg.PfmgConfig(**cfg)).setup(
        _coupled(grid, shape), 2, shape)
    h_r, h_p = ref.hierarchy, port.hierarchy
    assert port.level_shapes == [tuple(s) for s in ref.level_shapes]
    for lr, lp in zip(h_r.levels, h_p.levels):
        assert lr.cdir == lp.cdir and lr.nvars == lp.nvars
        for br, bp in zip(lr.blocks, lp.blocks):
            assert (br is None) == (bp is None)
            if br is not None:
                assert tuple(br.offsets) == bp.offsets
                np.testing.assert_array_equal(np.asarray(br.coefs),
                                              bp.coefs.numpy())
        np.testing.assert_array_equal(np.asarray(lr.dinv), lp.dinv.numpy())
        for f in ("wm", "wp"):
            wr, wp_ = getattr(lr, f), getattr(lp, f)
            assert (wr is None) == (wp_ is None)
            for a, b in zip(wr or (), wp_ or ()):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert_rel_close(h_r.c_dense_inv, h_p.c_dense_inv, 1e-12)
    b = np.random.default_rng(3).standard_normal((2,) + shape)
    assert_rel_close(jax.jit(ref_sys.sys_pfmg_cycle)(h_r, jnp.asarray(b)),
                     sys_pfmg.sys_pfmg_cycle(h_p, torch.as_tensor(b)), 1e-12)
    _, it_r, rel_r = ref.solve(b, tol=1e-9, max_iter=60)
    _, it, rel = port.solve(b, tol=1e-9, max_iter=60)
    assert it == int(it_r)
    assert rel <= 1e-9 and abs(rel - float(rel_r)) <= RELRES_ATOL


# -- FAC ---------------------------------------------------------------

def test_fac_matches():
    n = 32
    patch = ((0, 8, 8), (1, 24, 24))
    fine = [(o, 4.0 * v) for o, v in L5]
    ref = ref_fac.FAC(ref_grid.struct_matrix_from_stencil((1, n, n), L5),
                      fine, *patch, ref_fac.FacConfig())
    port = fac.FAC(grid.struct_matrix_from_stencil((1, n, n), L5), fine,
                   *patch, fac.FacConfig())
    for name in ("A_comp", "R", "P", "A_cc"):
        assert_csr_equal(getattr(ref, name), getattr(port, name))
    assert port.n_cout == ref.n_cout and port.fine_shape == ref.fine_shape
    b = ref.composite_rhs(np.ones((1, n, n)), np.ones((1, n, n)) * 2.0)
    np.testing.assert_array_equal(
        b, port.composite_rhs(np.ones((1, n, n)), np.ones((1, n, n)) * 2.0))
    x0 = np.random.default_rng(8).standard_normal(b.shape)
    assert_rel_close(ref.cycle(b, x0),
                     port.cycle(torch.as_tensor(b), torch.as_tensor(x0)),
                     1e-12)
    _, it_r, rel_r = ref.solve(b, tol=1e-6, max_iter=80)
    _, it, rel = port.solve(b, tol=1e-6, max_iter=80)
    assert it == it_r
    assert rel <= 1e-6 and abs(rel - rel_r) <= RELRES_ATOL


# -- sstruct -----------------------------------------------------------

def _two_parts(mod, n):
    g = mod.SStructGrid()
    g.add_part((1, n, n), L5)
    g.add_part((1, n, n), L5)
    M = mod.SStructMatrix(g)
    for y in range(n):
        M.add_graph_entry(0, (0, y, n - 1), 1, (0, y, 0), -1.0)
        M.add_graph_entry(1, (0, y, 0), 0, (0, y, n - 1), -1.0)
    return M


@pytest.mark.parametrize("precond", ["split pfmg", "split smg", "amg"])
def test_sstruct_solves_match(precond):
    n = 10 if precond == "amg" else 8
    M_r, M_p = _two_parts(ref_sstruct, n), _two_parts(sstruct, n)
    A = M_r.assemble_parcsr()
    assert_csr_equal(A, M_p.assemble_parcsr())
    b = np.ones(A.shape[0])
    if precond == "amg":
        P_r = RefBoomerAMG(RefAmgConfig(interp_type=6)).setup(A)
        P_p = BoomerAMG(AmgConfig(interp_type=6)).setup(A)
    else:
        kind = precond.split()[1]
        P_r = ref_sstruct.SplitSolver(M_r, kind).setup().precondition
        P_p = sstruct.SplitSolver(M_p, kind).setup().precondition
    res_r = ref_pcg(ref_op(A), b, M=P_r, tol=1e-8, max_iter=100)
    res = pcg(sparse_op_from_scipy(A), b, M=P_p, tol=1e-8, max_iter=100)
    assert res.iters == int(res_r.iters)
    assert_rel_close(res_r.x, res.x, 1e-10)
