"""The port's struct matrix, cyclic reduction, PFMG and SMG against
hypre_tpu's, in f64 on the CPU.

The same seeded inputs go through both packages:

* struct_matvec to 1e-14 relative (random coefficients, with and
  without periodic axes); the matrix builders and the host stencil
  product bit for bit;
* tridiag_solve to 1e-12 at n = 1, 2 (the direct solve alone), odd and
  even n (the identity-row padding);
* pcg with a callable A on a (nz, ny, nx) right-hand side: the port's
  inner products flatten as jnp.vdot does (torch.dot takes 1-D tensors
  only), and CG+PFMG at 12^3 gives the reference's iterations and x to
  1e-12;
* the PFMG and SMG hierarchies bit for bit (level shapes, cdirs, each
  level's coefficients, wm, wp, dinv, the line coefficients, the nested
  plane hierarchies), except the coarsest inverses, held to 1e-12
  relative: SMG's top level against the reference's c_dense_inv, its
  nested ones (per-plane blocks) against the diagonal blocks of the
  reference's, whose other entries are zero;
* one cycle to 1e-12 relative and equal iteration counts, 8^3 to 16^3
  and 2-D at 32^2.

The reference's cycles are jitted: an eager pfmg_cycle at 16^3 aborts
XLA:CPU (malloc: invalid size).  Its SMG compiles take 25-130 s a case,
so the reference's SMG cycles and solves come from
tests/golden/struct_reference.npz, which
``python tools/struct_reference_counts.py fixtures`` writes from the
same inputs (the hierarchies are compared here, in this process).
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (
    assert_rel_close, assert_struct_level_equal, struct_to_port,
)

from hypre_tpu.ops import tridiag as ref_tridiag
from hypre_tpu.solvers.krylov import pcg as ref_pcg
from hypre_tpu.struct import grid as ref_grid
from hypre_tpu.struct import pfmg as ref_pfmg
from hypre_tpu.struct import smg as ref_smg
from hypre_tpu_torch import Config, set_config
from hypre_tpu_torch.ops import tridiag
from hypre_tpu_torch.solvers.krylov import pcg
from hypre_tpu_torch.struct import grid, pfmg, smg

torch.set_num_threads(1)
# the two packages' final relative residuals differ by rounding alone:
# ~1e-13 measured at 16^3 after 30 PFMG cycles (0.001% of the 1e-8
# tolerance); this bound is 0.1% of it
RELRES_ATOL = 1e-11
ref_tridiag_solve = jax.jit(ref_tridiag.tridiag_solve)
ref_pfmg_cycle = jax.jit(ref_pfmg.pfmg_cycle)


@pytest.fixture(autouse=True)
def _cpu():
    set_config(Config(real_dtype=torch.float64, device="cpu"))


@pytest.fixture(scope="module")
def ref():
    """The reference's stored side (tools/struct_reference_counts.py
    fixtures)."""
    return np.load(pathlib.Path(__file__).parent / "golden" /
                   "struct_reference.npz")


def _random_struct(shape, seed, periodic=(0, 0, 0)):
    """A 27-pt operator with random coefficients (zero where a neighbour
    leaves the grid on a non-periodic axis)."""
    rng = np.random.default_rng(seed)
    entries = [((dz, dy, dx), 0.0) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
               for dx in (-1, 0, 1)]
    variable = {off: rng.standard_normal(shape) for off, _ in entries}
    A = ref_grid.struct_matrix_from_stencil(shape, entries,
                                            variable=variable)
    coefs = np.asarray(A.coefs).copy()
    if any(periodic):
        # wrap: every arm live along a periodic axis
        coefs = np.stack([variable[off] for off, _ in entries])
        for k, off in enumerate(A.offsets):
            for d in range(3):
                if off[d] and not periodic[d]:
                    sl = [slice(None)] * 3
                    sl[d] = 0 if off[d] < 0 else -1
                    coefs[k][tuple(sl)] = 0.0
    return ref_grid.StructMatrix(coefs=jnp.asarray(coefs), offsets=A.offsets,
                                 shape=shape, periodic=periodic)


@pytest.mark.parametrize("periodic", [(0, 0, 0), (1, 0, 1), (0, 1, 0)])
def test_struct_matvec_matches_reference(periodic):
    shape = (5, 6, 7)
    A = _random_struct(shape, 1, periodic)
    u = np.random.default_rng(2).standard_normal(shape)
    y_ref = np.asarray(ref_grid.struct_matvec(A, jnp.asarray(u)))
    y = grid.struct_matvec(struct_to_port(A), torch.as_tensor(u))
    assert_rel_close(y_ref, y, 1e-14)


def test_struct_builders_and_stencil_product_match():
    shape = (4, 6, 5)
    entries = [((0, 0, 0), 6.5), ((0, 0, -1), -1.0), ((0, 1, 0), -2.0),
               ((1, 0, 1), -0.5), ((-1, -1, 0), -0.25)]
    var = {(0, 1, 0): np.random.default_rng(3).standard_normal(shape)}
    for r, p in ((ref_grid.struct_matrix_from_stencil(shape, entries,
                                                      variable=var),
                  grid.struct_matrix_from_stencil(shape, entries,
                                                  variable=var)),
                 (ref_grid.struct_laplacian(4, 6, 5, 2.0, 1.0, 0.5),
                  grid.struct_laplacian(4, 6, 5, 2.0, 1.0, 0.5)),
                 (ref_grid.struct_laplacian(1, 6, 5),
                  grid.struct_laplacian(1, 6, 5))):
        assert tuple(r.offsets) == p.offsets and tuple(r.shape) == p.shape
        np.testing.assert_array_equal(np.asarray(r.coefs), p.coefs.numpy())
    Ar = ref_grid.host_coefs(ref_grid.struct_matrix_from_stencil(
        shape, entries, variable=var))
    Ap = grid.host_coefs(grid.struct_matrix_from_stencil(shape, entries,
                                                         variable=var))
    prod_r = ref_grid.stencil_multiply(Ar, Ar, shape)
    prod_p = grid.stencil_multiply(Ap, Ap, shape)
    assert list(prod_r) == list(prod_p)
    for off in prod_r:
        np.testing.assert_array_equal(prod_r[off], prod_p[off])


@pytest.mark.parametrize("n", [1, 2, 3, 8, 37])
def test_tridiag_solve_matches_reference(n):
    rng = np.random.default_rng(n)
    a, c, d = (rng.standard_normal((3, 4, n)) for _ in range(3))
    b = rng.standard_normal((3, 4, n)) + 6.0
    x_ref = ref_tridiag_solve(a, b, c, d)
    x = tridiag.tridiag_solve(*(torch.as_tensor(v) for v in (a, b, c, d)))
    assert_rel_close(x_ref, x, 1e-12)


def test_pcg_on_grid_vectors():
    """torch.dot refuses a (nz, ny, nx) tensor, which the port's pcg
    took its inner products with; now they flatten as jnp.vdot does,
    and CG+PFMG on grid vectors is the reference's."""
    n = 12
    u = torch.ones((n, n, n), dtype=torch.float64)
    with pytest.raises(RuntimeError, match="1D tensors"):
        torch.dot(u, u)
    A_ref = ref_grid.struct_laplacian(n, n, n)
    pf_ref = ref_pfmg.PFMG(ref_pfmg.PfmgConfig()).setup(A_ref)
    b = np.ones((n, n, n))
    res_ref = ref_pcg(A=lambda v: ref_grid.struct_matvec(A_ref, v), b=b,
                      M=pf_ref.precondition, tol=1e-7, max_iter=50)
    A = grid.struct_laplacian(n, n, n)
    pf = pfmg.PFMG(pfmg.PfmgConfig()).setup(A)
    res = pcg(A=lambda v: grid.struct_matvec(A, v), b=torch.as_tensor(b),
              M=pf.precondition, tol=1e-7, max_iter=50)
    assert res.x.shape == (n, n, n)
    assert res.iters == int(res_ref.iters)
    assert_rel_close(res_ref.x, res.x, 1e-12)


PFMG_CASES = {
    "12^3": ((12, 12, 12), {}),
    "9x10x11": ((9, 10, 11), {}),
    "16^3 cz=100": ((16, 16, 16), {"cz": 100.0}),
    "2-D 32^2": ((1, 32, 32), {}),
}


def _laplacians(shape, kw):
    return (ref_grid.struct_laplacian(*shape, **kw),
            grid.struct_laplacian(*shape, **kw))


@pytest.mark.parametrize("case", list(PFMG_CASES))
def test_pfmg_hierarchy_bit_for_bit(case):
    shape, kw = PFMG_CASES[case]
    A_ref, A = _laplacians(shape, kw)
    h_ref = ref_pfmg.PFMG(ref_pfmg.PfmgConfig()).setup(A_ref).hierarchy
    h = pfmg.PFMG(pfmg.PfmgConfig()).setup(A).hierarchy
    assert len(h.levels) == len(h_ref.levels)
    for lr, lp in zip(h_ref.levels, h.levels):
        assert_struct_level_equal(lr, lp, ("wm", "wp", "dinv", "rb_mask"))
    assert_rel_close(h_ref.c_dense_inv, h.c_dense_inv, 1e-12)


@pytest.mark.parametrize("relax", [1, 2])
@pytest.mark.parametrize("case", ["12^3", "2-D 32^2"])
def test_pfmg_cycle_matches(case, relax):
    shape, kw = PFMG_CASES[case]
    A_ref, A = _laplacians(shape, kw)
    cfg = dict(relax_type=relax)
    h_ref = ref_pfmg.PFMG(ref_pfmg.PfmgConfig(**cfg)).setup(A_ref).hierarchy
    h = pfmg.PFMG(pfmg.PfmgConfig(**cfg)).setup(A).hierarchy
    b = np.random.default_rng(5).standard_normal(shape)
    assert_rel_close(ref_pfmg_cycle(h_ref, jnp.asarray(b)),
                     pfmg.pfmg_cycle(h, torch.as_tensor(b)), 1e-12)


@pytest.mark.parametrize("shape,relax", [((8, 8, 8), 1), ((8, 8, 8), 2),
                                         ((16, 16, 16), 1), ((1, 32, 32), 2)])
def test_pfmg_iterations_equal(shape, relax):
    A_ref, A = _laplacians(shape, {})
    cfg = dict(relax_type=relax)
    b = np.ones(shape)
    _, it_ref, rel_ref = ref_pfmg.PFMG(ref_pfmg.PfmgConfig(**cfg)).setup(
        A_ref).solve(b, tol=1e-8)
    x, it, rel = pfmg.PFMG(pfmg.PfmgConfig(**cfg)).setup(A).solve(b, tol=1e-8)
    assert it == int(it_ref)
    assert rel <= 1e-8 and abs(rel - float(rel_ref)) <= RELRES_ATOL


SMG_CASES = {"8^3": (8, 8, 8), "12x10x9": (12, 10, 9), "2-D 32^2": (1, 32, 32)}


def _smg_pair(shape):
    A_ref, A = _laplacians(shape, {})
    return (ref_smg.SMG(ref_smg.SmgConfig()).setup(A_ref),
            smg.SMG(smg.SmgConfig()).setup(A))


def _check_smg_hierarchy(h_ref, h, nested: bool):
    assert h.dim == h_ref.dim and len(h.levels) == len(h_ref.levels)
    for lr, lp in zip(h_ref.levels, h.levels):
        assert_struct_level_equal(lr, lp, ("wm", "wp", "line_a", "line_b",
                                           "line_c"))
        assert (lr.plane2d is None) == (lp.plane2d is None)
        if lr.plane2d is not None:
            _check_smg_hierarchy(lr.plane2d, lp.plane2d, nested=True)
    c_ref = np.asarray(h_ref.c_dense_inv)
    if not nested:
        assert_rel_close(c_ref, h.c_dense_inv, 1e-12)
        return
    # per-plane blocks: the reference's diagonal blocks, nothing beside
    nz, m, _ = h.c_dense_inv.shape
    assert c_ref.shape == (nz * m, nz * m)
    blocks = c_ref.reshape(nz, m, nz, m)
    diag = np.stack([blocks[z, :, z, :] for z in range(nz)])
    assert_rel_close(diag, h.c_dense_inv, 1e-12)
    off_block = blocks.copy()
    for z in range(nz):
        off_block[z, :, z, :] = 0.0
    assert not off_block.any()


@pytest.mark.parametrize("case", list(SMG_CASES))
def test_smg_hierarchy_bit_for_bit(case):
    s_ref, s = _smg_pair(SMG_CASES[case])
    _check_smg_hierarchy(s_ref.hierarchy, s.hierarchy, nested=False)


@pytest.mark.parametrize("case", list(SMG_CASES))
def test_smg_cycle_matches(case, ref):
    shape = SMG_CASES[case]
    s = smg.SMG(smg.SmgConfig()).setup(grid.struct_laplacian(*shape))
    b = np.random.default_rng(6).standard_normal(shape)
    assert_rel_close(ref[f"smg cycle {case}"],
                     smg.smg_cycle(s.hierarchy, torch.as_tensor(b)), 1e-12)


@pytest.mark.parametrize("case", ["8^3", "16^3", "2-D 32^2"])
def test_smg_iterations_equal(case, ref):
    shape = (16, 16, 16) if case == "16^3" else SMG_CASES[case]
    it_ref, rel_ref = ref[f"smg solve {case}"]
    s = smg.SMG(smg.SmgConfig()).setup(grid.struct_laplacian(*shape))
    x, it, rel = s.solve(np.ones(shape), tol=1e-8)
    assert it == int(it_ref)
    assert rel <= 1e-8 and abs(rel - rel_ref) <= RELRES_ATOL
