"""The port's ParBoomerAMG (8 stacked shards) against hypre_tpu's on 8
virtual devices.

The reference's shard_map solves compile for seconds to minutes each,
so their iterations, residuals and solutions are read from
tests/golden/par_reference.npz (tools/par_reference_counts.py); the
reference is called directly only for its host setup and one cycle."""
import numpy as np
import pytest
import torch

from torch_port_helpers import LAPLACE_7PT, mesh8, par_golden, parcsr_dict

torch.set_num_threads(1)

from hypre_tpu_torch import Config, set_config  # noqa: E402

set_config(Config(device="cpu"))

from hypre_tpu_torch.gen import laplacian  # noqa: E402
from hypre_tpu_torch.parallel import StackedComm  # noqa: E402
from hypre_tpu_torch.solvers import BoomerAMG, krylov_more, pcg  # noqa: E402
from hypre_tpu_torch.solvers.amg import AmgConfig  # noqa: E402
from hypre_tpu_torch.solvers.par_amg import (  # noqa: E402
    ParBoomerAMG, par_amg_cycle,
)

# key: (AmgConfig kwargs, method, grid) as tools/par_reference_counts.py
SOLVES = {
    "v18_pcg": ({}, "pcg", 12), "v0_pcg": ({"relax_type": 0}, "pcg", 12),
    "v7_pcg": ({"relax_type": 7}, "pcg", 12),
    "v16_pcg": ({"relax_type": 16}, "pcg", 12),
    "v3_pcg": ({"relax_type": 3}, "pcg", 12),
    "v4_pcg": ({"relax_type": 4}, "pcg", 12),
    "v6_pcg": ({"relax_type": 6}, "pcg", 12),
    "v8_pcg": ({"relax_type": 8}, "pcg", 12),
    "v13_pcg": ({"relax_type": 13}, "pcg", 12),
    "v14_pcg": ({"relax_type": 14}, "pcg", 12),
    "v11_pcg": ({"relax_type": 11}, "pcg", 12),
    "v12_pcg": ({"relax_type": 12}, "pcg", 12),
    "w18_pcg": ({"cycle_type": "W"}, "pcg", 12),
    "f18_pcg": ({"cycle_type": "F"}, "pcg", 12),
    "w18_gmres": ({"cycle_type": "W"}, "gmres", 12),
    "f13_bicgstab": ({"cycle_type": "F", "relax_type": 13}, "bicgstab", 12),
    "v18_gmres": ({}, "gmres", 12), "v18_bicgstab": ({}, "bicgstab", 12),
    "v18_flexgmres": ({}, "flexgmres", 12),
    "v18_lgmres": ({}, "lgmres", 12), "v18_cogmres": ({}, "cogmres", 12),
    "v18_cgnr": ({}, "cgnr", 12),
    "order1_pcg": ({"relax_order": 1}, "pcg", 12),
    "v18_pcg_16": ({}, "pcg", 16),
    "ex_multichip_16": ({"interp_type": 6}, "pcg", 16),
}


@pytest.fixture(scope="module")
def golden():
    return par_golden()


# CGNR iterates on the normal equations, whose condition number is the
# square of A's: the order of the per-shard sums (the reference's psum of
# XLA's vdot, the port's sum of torch's) moves its x by ~1.5e-10
# relative and its residual by ~0.5% at the same iteration count, where
# every other method agrees to 1e-10 and 1e-6
CGNR_TOL = {"x": 1e-8, "relres": 1e-2}


def _check(g, key, x, it, rel, A=None, x_tol=1e-10, rel_tol=1e-6):
    xr = g[f"{key}/x"]
    assert it == int(g[f"{key}/iters"]), (it, int(g[f"{key}/iters"]))
    assert np.abs(x - xr).max() <= x_tol * np.abs(xr).max()
    ref_rel = float(g[f"{key}/relres"])
    # below rtol 1e-6, the residual's own rounding level: a relres far
    # under the tolerance (COGMRES runs whole restarts, 2e-11) is
    # ||b - A x|| computed in f64, good to eps ||A|| ||x|| / ||b||
    floor = 0.0
    if A is not None:
        floor = 8 * np.finfo(float).eps * abs(A).sum(1).max() \
            * np.linalg.norm(xr) / np.sqrt(len(xr))
    assert abs(rel - ref_rel) <= rel_tol * ref_rel + floor


@pytest.mark.parametrize("key", sorted(SOLVES))
def test_par_solve_matches_reference(golden, key):
    """V/W/F cycles, relax 18/0/7/16/3/4/6/8/13/14/11/12, the C/F order
    and every Krylov method on 8 stacked shards: the reference's
    iterations, x to 1e-10 relative, relres to rtol 1e-6."""
    kw, method, n = SOLVES[key]
    A = laplacian(n, n, n)
    b = np.ones(A.shape[0])
    pamg = ParBoomerAMG(8, AmgConfig(**kw)).setup(A)
    x, it, rel = pamg.solve(b, method=method, tol=1e-8, max_iter=300)
    tol = ({"x_tol": CGNR_TOL["x"], "rel_tol": CGNR_TOL["relres"]}
           if method == "cgnr" else {})
    _check(golden, f"solve/{key}", x, it, rel, A=A, **tol)
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-6


@pytest.mark.parametrize("key", ["v18_pcg", "v16_pcg", "w18_pcg",
                                 "v18_gmres", "v18_bicgstab", "order1_pcg"])
def test_par_count_equals_single_device(key):
    """Where the reference holds its mesh count equal to one chip's
    (test_parallel.py:134-167), the port's stacked count equals its own
    single-device count."""
    kw, method, n = SOLVES[key]
    A = laplacian(n, n, n)
    b = np.ones(A.shape[0])
    cfg = AmgConfig(**kw)
    _, it, _ = ParBoomerAMG(8, cfg).setup(A).solve(b, method=method,
                                                  tol=1e-8, max_iter=300)
    amg = BoomerAMG(cfg).setup(A)
    fn = pcg if method == "pcg" else getattr(krylov_more, method)
    from hypre_tpu_torch.ops import sparse_op_from_scipy

    res = fn(sparse_op_from_scipy(A), b, M=amg, tol=1e-8, max_iter=300)
    assert it == res.iters


def test_par_stencil_fine_level(golden):
    """The matrix-free ParStencilOp fine level (test_parallel.py:169):
    the reference's count and x, and the stored fine level's count."""
    nx, ny, nz = 16, 16, 8
    A = laplacian(nx, ny, nz)
    b = np.ones(A.shape[0])
    st = ParBoomerAMG(8, AmgConfig()).setup(
        A, fine_stencil=((nx, ny, nz), LAPLACE_7PT))
    assert st.hierarchy.levels[0].stencil is not None
    assert st.hierarchy.levels[0].A is None
    x1, it1, rel1 = st.solve_pcg(b, tol=1e-8, max_iter=200)
    _check(golden, "solve/stencil_16_16_8", x1, it1, rel1)
    x2, it2, _ = ParBoomerAMG(8, AmgConfig()).setup(A).solve_pcg(b, tol=1e-8)
    assert it1 == it2
    np.testing.assert_allclose(x1, x2, rtol=1e-8, atol=1e-10)


def test_exchanges_per_iteration_do_not_grow_with_shards():
    """The stacked executor runs one exchange per operator product and
    one all_gather per coarse solve, whatever the shard count."""
    A = laplacian(12, 12, 12)
    counts = []
    for ns in (2, 4, 8):
        comm = StackedComm(ns)
        pamg = ParBoomerAMG(comm, AmgConfig()).setup(A)
        r = pamg.shard(np.ones(A.shape[0]))
        comm.exchanges = comm.all_gathers = 0
        pamg.precondition(r)
        pamg.fine_matvec(r)
        counts.append((comm.exchanges, comm.all_gathers))
    assert counts[0] == counts[1] == counts[2]
    assert counts[0][1] == 1


@pytest.mark.parametrize("relax_type", [13, 16])
def test_cycle_from_reference_state(relax_type):
    """The reference's ParAmgHierarchy carried across (convert.
    par_hierarchy_from_numpy): one port cycle equals one reference cycle
    (its shard_map) to 1e-12, and the port's own setup's cycle."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hypre_tpu.gen import laplacian as ref_lap
    from hypre_tpu.solvers.amg import AmgConfig as RefCfg
    from hypre_tpu.solvers.par_amg import (
        ParBoomerAMG as RefPar, hierarchy_specs, par_amg_cycle as ref_cycle,
    )
    from hypre_tpu_torch.convert import par_hierarchy_from_numpy

    n = 12
    ref = RefPar(mesh8(), RefCfg(relax_type=relax_type)).setup(
        ref_lap(n, n, n))
    h = ref.hierarchy
    comm = StackedComm(8)

    def arr(a):
        return None if a is None else np.asarray(a)

    levels = [{"A": parcsr_dict(l.A), "P": parcsr_dict(l.P),
               "R": parcsr_dict(l.R), "dinv": arr(l.dinv),
               "cheby_ds": arr(l.cheby_ds), "cheby_bounds": arr(
                   l.cheby_bounds), "gs_lo": arr(l.gs_lo),
               "gs_up": arr(l.gs_up)} for l in h.levels]
    hp = par_hierarchy_from_numpy(levels, np.asarray(h.c_lu),
                                  np.asarray(h.c_piv), comm,
                                  relax_type=relax_type)
    r = np.random.RandomState(5).randn(8, ref.fine_part.n_local)
    u = par_amg_cycle(hp, torch.as_tensor(r)).numpy()
    specs = hierarchy_specs(h)
    f = jax.jit(jax.shard_map(lambda hh, v: ref_cycle(hh, v[0])[None, :],
                              mesh=mesh8(), in_specs=(specs, P("p", None)),
                              out_specs=P("p", None), check_vma=False))
    ur = np.asarray(f(h, jax.device_put(r, NamedSharding(mesh8(),
                                                         P("p", None)))))
    assert np.abs(u - ur).max() <= 1e-12 * np.abs(ur).max()
    own = ParBoomerAMG(comm, AmgConfig(relax_type=relax_type)).setup(
        laplacian(n, n, n))
    u2 = own.precondition(torch.as_tensor(r)).numpy()
    assert np.abs(u2 - u).max() <= 1e-13 * np.abs(u).max()


def test_ex_multichip_and_dryrun():
    """The example (devices, Iterations, Final Relative Residual Norm)
    and the dryrun analog's counts: MULTICHIP_r05.json's 15 / 13 / 12
    and levels [1728, 597, 126, 24, 2] at 8 shards, the same at 2."""
    from hypre_tpu_torch.examples.ex_multichip import dryrun_multichip, main

    _, it, rel = main(12)
    assert rel <= 1e-8 and it > 0
    for ns in (8, 2):
        out = dryrun_multichip(ns)
        assert (out["pcg"], out["gmres_w"], out["dist_pcg"]) == (15, 13, 12)
        assert out["levels"] == [1728, 597, 126, 24, 2]
        assert abs(out["relres"] - 6.888729040473871e-09) <= \
            1e-6 * 6.888729040473871e-09


def test_ex_multichip_matches_reference(golden):
    """ex_multichip's configuration (interp 6) at 16^3: the reference's
    count and solution."""
    from hypre_tpu_torch.examples.ex_multichip import main

    x, it, rel = main(16)
    _check(golden, "solve/ex_multichip_16", x, it, rel)
