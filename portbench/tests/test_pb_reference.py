"""The plain reference against scipy and against the program at small
grids on the CPU."""
import copy

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from portbench import harness, reference as ref

ST = [((0, 0, 0), 6.0), ((-1, 0, 0), -1.0), ((1, 0, 0), -1.0),
      ((0, -1, 0), -1.0), ((0, 1, 0), -1.0), ((0, 0, -1), -1.0),
      ((0, 0, 1), -1.0)]
CHECKS = harness.module("checks", "boomeramg_stencil")


def scipy_laplacian(nx, ny, nz):
    def d1(n):
        return sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                        [-1, 0, 1])
    ix, iy, iz = sp.identity(nx), sp.identity(ny), sp.identity(nz)
    return (sp.kron(iz, sp.kron(iy, d1(nx))) + sp.kron(iz, sp.kron(d1(ny), ix))
            + sp.kron(d1(nz), sp.kron(iy, ix))).tocsr()


def to_scipy(M: ref.Csr):
    return sp.csr_matrix((M.values.numpy(), M.indices.numpy(),
                          M.indptr.numpy()), shape=(M.n_rows, M.n_cols))


def from_scipy(M) -> ref.Csr:
    M = M.tocsr()
    M.sort_indices()
    return ref.Csr(torch.as_tensor(M.indptr, dtype=torch.int64),
                   torch.as_tensor(M.indices, dtype=torch.int64),
                   torch.as_tensor(M.data, dtype=torch.float64), M.shape[1])


@pytest.fixture(scope="module", params=["out14.solve", "out22.solve"])
def program(request):
    from hypre_tpu_torch import get_config, set_config

    saved = get_config()
    cfg = copy.deepcopy(harness.cell_spec(request.param)["config"])
    cfg["grid"] = [16, 15, 14]
    prog = harness.build_program(cfg, torch.device("cpu"))
    yield cfg, prog
    set_config(saved)


def test_stencil_matches_scipy():
    grid = (5, 4, 3)
    A = scipy_laplacian(*grid)
    x = np.random.default_rng(0).standard_normal(A.shape[0])
    y = ref.stencil_apply(grid, ST, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, A @ x, rtol=0, atol=1e-13)
    cols, vals = ref.stencil_ell(grid, ST, "cpu")
    assert abs(to_scipy(ref.csr_from_ell(cols, vals)) - A).max() == 0


@pytest.mark.parametrize("shape", [(40, 30, 25), (1, 7, 7), (9, 1, 3)])
def test_spgemm_and_transpose_match_scipy(shape):
    rng = np.random.default_rng(sum(shape))
    m, k, n = shape
    A = sp.random(m, k, density=0.2, random_state=rng, format="csr")
    B = sp.random(k, n, density=0.3, random_state=rng, format="csr")
    got = to_scipy(ref.spgemm(from_scipy(A), from_scipy(B), budget=16))
    assert abs(got - A @ B).max() <= 1e-15
    assert abs(to_scipy(ref.transpose(from_scipy(A))) - A.T).max() == 0


def test_row_gap():
    A = sp.csr_matrix(np.array([[2.0, -1.0, 0.0], [0.0, 4.0, 1.0],
                                [0.0, 0.0, 0.0]]))
    B = A.copy()
    B[1, 2] = 1.0 + 4e-6
    assert ref.row_gap(from_scipy(B), from_scipy(A)) == pytest.approx(1e-6)
    B[2, 0] = 1.0
    assert ref.row_gap(from_scipy(B), from_scipy(A)) == ref.MISMATCH
    assert ref.row_gap(from_scipy(A[:2]), from_scipy(A)) == ref.MISMATCH


def test_pmis_and_hash_match_the_program(program):
    from hypre_tpu_torch.setup import device_amg as dev

    cfg, prog = program
    a = cfg["amg"]
    ids = torch.arange(5000)
    assert torch.equal(ref.fmix32_measure(ids, 2747),
                       dev.pmis_hash32(ids, 2747))
    cols, vals = ref.stencil_ell(cfg["grid"], ST, "cpu")
    strong, tie = ref.strength(cols, vals, 0.25, 0.9)
    assert not bool(tie.any())
    A = dev.dell_stencil(cfg["grid"], ST, torch.float64, "cpu")
    want = dev.device_pmis(A, dev.device_strength(A, 0.25, 0.9),
                           seed=a["seed"])
    got = ref.pmis(cols, strong, a["seed"])
    assert torch.equal(got.to(torch.int32), want)


def test_threefry_matches_the_program():
    from hypre_tpu_torch.core.threefry import uniform

    assert np.array_equal(ref.threefry_uniform(7919, 4099),
                          uniform(7919, 4099, torch.float64).numpy())


def hierarchy(cfg, prog):
    """The reference's hierarchy, ties taken as the program's."""
    levels = prog.amg.hierarchy.levels
    return ref.hierarchy(
        cfg["grid"], cfg["stencil"], cfg["amg"], "cpu",
        lambda l: CHECKS.prog_csr(levels[l].P, "cpu"),
        lambda l: CHECKS.prog_csr(levels[l].A, "cpu") if l else None)


def test_own_hierarchy_matches_the_program(program):
    """Every row of every level's P and coarse A, built from the stencil
    alone (ties of strength and truncation taken as the program's)."""
    cfg, prog = program
    levels = prog.amg.hierarchy.levels
    mine, coarse = hierarchy(cfg, prog)
    assert len(mine) + 1 == len(levels) >= 4
    interp, galerkin = CHECKS.hierarchy_gaps(levels, mine, coarse, "cpu")
    assert interp < 1e-13 and galerkin < 1e-13
    # the Galerkin operators are scipy's P^T A P of the reference's own
    A = scipy_laplacian(*cfg["grid"])
    for l, lv in enumerate(mine):
        P = to_scipy(lv.P)
        want = P.T @ A @ P
        A = to_scipy(mine[l + 1].A if l + 1 < len(mine) else coarse)
        assert abs(A - want).max() <= 1e-14 * abs(want).max()


def test_ties_are_what_the_program_decides(program):
    """Without the program's tie-breaks the reference splits another
    way at this size; with them it agrees, and a fault in the program's
    coarse operator is still read as one."""
    cfg, prog = program
    levels = prog.amg.hierarchy.levels
    own, c_own = ref.hierarchy(cfg["grid"], cfg["stencil"], cfg["amg"],
                               "cpu")
    assert CHECKS.hierarchy_gaps(levels, own, c_own, "cpu")[0] > 1e-3
    A1 = CHECKS.prog_csr(levels[1].A, "cpu")
    bad = A1._replace(values=A1.values * (1 + 1e-8))
    mine, coarse = ref.hierarchy(
        cfg["grid"], cfg["stencil"], cfg["amg"], "cpu",
        lambda l: CHECKS.prog_csr(levels[l].P, "cpu"),
        lambda l: bad if l == 1 else (CHECKS.prog_csr(levels[l].A, "cpu")
                                      if l else None))
    assert ref.row_gap(bad, mine[1].A) > 5e-9


def test_v_cycle_matches_scipy(program):
    """The reference's V-cycle against the same cycle written with
    scipy matrices of the reference's own hierarchy (l1-Jacobi), or
    against the program's cycle (Chebyshev)."""
    cfg, prog = program
    a = cfg["amg"]
    mine, coarse = hierarchy(cfg, prog)
    mats = [to_scipy(lv.A) for lv in mine] + [to_scipy(coarse)]
    Ps = [to_scipy(lv.P) for lv in mine]

    def cyc(l, f):
        A = mats[l]
        if l == len(mats) - 1:
            return np.linalg.solve(A.toarray(), f)
        d = A.diagonal()
        l1 = np.asarray(abs(A).sum(1)).ravel() * np.sign(d)
        u = f / l1
        uc = cyc(l + 1, Ps[l].T @ (f - A @ u))
        u = u + Ps[l] @ uc
        return u + (f - A @ u) / l1

    f = np.random.default_rng(3).standard_normal(mats[0].shape[0])
    levels = ref.cycle_levels(mine, cfg["grid"], cfg["stencil"], a)
    z = ref.v_cycle(levels, coarse.sparse().to_dense(), a,
                    torch.as_tensor(f)).numpy()
    if a["relax_type"] == 18:
        want = cyc(0, f)
        assert np.abs(z - want).max() <= 1e-12 * np.abs(want).max()
    r = torch.as_tensor(f)
    gap = CHECKS.cycle_rel_diff(mine, coarse, cfg, (r, prog.precondition(r)),
                                "cpu")
    assert gap < 1e-12


def loop_extpi_row(i, row, cf, strong_of) -> dict:
    """Row i of ext+i before truncation, one row at a time: the loop
    that `reference._extpi_rows` does over all rows at once."""
    cols, vals = row(i)
    st = strong_of(i)
    strong_f = [(int(k), float(a)) for k, a, s in zip(cols, vals, st)
                if s and cf[k] == ref.F_PT]
    chat = {int(j) for j, s in zip(cols, st) if s and cf[j] == ref.C_PT}
    for k, _ in strong_f:
        kc, _ = row(k)
        chat.update(int(j) for j, s in zip(kc, strong_of(k))
                    if s and cf[j] == ref.C_PT)
    d, num = 0.0, {}
    sf = {k for k, _ in strong_f}
    for j, a in zip(cols.tolist(), vals.tolist()):
        if j == i:
            d += a
        elif j in chat:
            num[j] = num.get(j, 0.0) + a
        elif j not in sf and cf[j] != ref.SF_PT:
            d += a
    for k, a_ik in strong_f:
        kc, kv = row(k)
        sgn = np.sign(kv[kc == k].sum())
        use = [(int(l), float(a)) for l, a in zip(kc, kv)
               if l != k and sgn * a < 0 and (l in chat or l == i)]
        den = sum(a for _, a in use)
        if den == 0.0:
            d += a_ik
            continue
        for l, a in use:
            if l == i:
                d += a_ik / den * a
            else:
                num[l] = num.get(l, 0.0) + a_ik / den * a
    scale = -d if d != 0.0 else 1.0
    return {j: v / scale for j, v in num.items()}


def loop_truncated(q: dict, max_elmts: int) -> dict:
    """q cut to its max_elmts entries of largest magnitude (ties to the
    lower column), rescaled to keep its sum."""
    if len(q) <= max_elmts:
        return dict(q)
    keep = sorted(q, key=lambda j: (-abs(q[j]), j))[:max_elmts]
    kept = sum(q[j] for j in keep)
    s = sum(q.values()) / kept if kept != 0.0 else 1.0
    return {j: q[j] * s for j in keep}


@pytest.mark.parametrize("level", [0, 1])
def test_vectorised_interpolation_matches_the_loop(program, level):
    cfg, prog = program
    a = cfg["amg"]
    lv = hierarchy(cfg, prog)[0][level]
    strong, _ = ref.strength(lv.cols, lv.vals, a["strong_threshold"],
                             a["max_row_sum"])
    n = lv.cols.shape[1]
    ucol, q = ref._extpi_rows(lv.cols, lv.vals, strong, lv.cf, 0, n)
    cmap = torch.cumsum((lv.cf == ref.C_PT).to(torch.int64), 0) - 1
    keep, qt = ref._truncate(ucol, q, cmap, a, None)
    c, v, st = lv.cols.numpy(), lv.vals.numpy(), strong.numpy()
    cf = lv.cf.numpy()

    def row(k):
        ok = c[:, k] >= 0
        return c[ok, k], v[ok, k]

    def strong_of(k):
        return st[c[:, k] >= 0, k]

    uc, qn, qtn, kp = ucol.numpy(), q.numpy(), qt.numpy(), keep.numpy()
    f_rows = np.flatnonzero(cf == ref.F_PT)
    assert len(f_rows) > 100
    for i in f_rows.tolist():
        ok = uc[:, i] < ref._BIG
        got = dict(zip(uc[ok, i].tolist(), qn[ok, i].tolist()))
        want = loop_extpi_row(i, row, cf, strong_of)
        assert set(got) == set(want)
        scale = max((abs(x) for x in want.values()), default=1.0)
        assert all(abs(got[j] - want[j]) <= 1e-13 * scale for j in got)
        # truncation of the same numbers
        cut = dict(zip(uc[kp[:, i], i].tolist(), qtn[kp[:, i], i].tolist()))
        want = loop_truncated(got, a["p_max_elmts"])
        assert set(cut) == set(want)
        assert all(abs(cut[j] - want[j]) <= 1e-15 * scale for j in cut)
