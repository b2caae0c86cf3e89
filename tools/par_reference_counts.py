"""The reference's (hypre_tpu's) outputs for the distributed layer.

The port's tests (tests/test_torch_par_*.py, test_torch_amgdd_ij_par.py)
hold hypre_tpu_torch's distributed layer against hypre_tpu's.  The
reference's distributed setup and its shard_map solves compile for
minutes on a virtual 8-device CPU mesh, so their outputs are computed
once here and stored:

    python tools/par_reference_counts.py fixtures

writes tests/golden/par_reference.npz (f64 on the CPU, 8 virtual
devices; about 10 min in its own process; ``fixtures SECTION ...``
recomputes only the named sections into the stored file):

* ``solve/<case>/{iters,relres,x}`` — ParBoomerAMG solves at 12^3 (and
  one at 16^3) on 8 shards: V-PCG with relax 18/0/7/16/3/4/6/8/13/14/
  11/12, W and F cycles, GMRES, FlexGMRES, LGMRES, COGMRES, BiCGSTAB,
  CGNR, the C/F relax order, the stencil fine level;
* ``hier<interp>/L<l>/{cf,A,P,R}`` and ``hier<interp>/final`` — the
  per-level C/F splits and operators of iter_par_hierarchy at 12^3, 3
  levels, interp 3 and 6 (a matrix as ``<key>/indptr|indices|data|
  shape``);
* ``dist/<case>/{iters,relres,x}`` — setup_distributed's PCG at 12^3
  (interp 6, with and without the stencil fine level) and the 10^3
  ParIJ-assembled operator (interp 3);
* ``struct/<case>/{iters,relres,x}`` — ParPFMG, ParSMG, ParSysPFMG and
  par_struct_pcg at the reference tests' sizes, and
  ``struct_single/<case>/...`` the single-chip PFMG and CG+PFMG solves
  of the same problems;
* ``amgdd/<case>/...`` — AMG-DD's relative residual after 1-5 outer
  iterations and its converged (iters, relres, x) at 12^3, and the
  padding-1/2 counts at 10^3.

    python tools/par_reference_counts.py card

prints the counts the card's ``distributed`` phase holds (chip_smoke.py
``REF_PAR_*``): the dryrun at 12^3 (V-PCG, W-GMRES, setup_distributed
PCG, levels); ``card_struct [N]`` those of its row (f): CG + PFMG at N^3
(default 128; a few minutes) and AMG-DD at 64^3.
"""
from __future__ import annotations

import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

OUT = ROOT / "tests" / "golden" / "par_reference.npz"
ST7 = [((0, 0, 0), 6.0), ((-1, 0, 0), -1.0), ((1, 0, 0), -1.0),
       ((0, -1, 0), -1.0), ((0, 1, 0), -1.0),
       ((0, 0, -1), -1.0), ((0, 0, 1), -1.0)]
LAP7Z = [((0, 0, 0), 6.0), ((0, 0, -1), -1.0), ((0, 0, 1), -1.0),
         ((0, -1, 0), -1.0), ((0, 1, 0), -1.0),
         ((-1, 0, 0), -1.0), ((1, 0, 0), -1.0)]
# (key, AmgConfig kwargs, method, grid)
SOLVES = [
    ("v18_pcg", {}, "pcg", 12), ("v0_pcg", {"relax_type": 0}, "pcg", 12),
    ("v7_pcg", {"relax_type": 7}, "pcg", 12),
    ("v16_pcg", {"relax_type": 16}, "pcg", 12),
    ("v3_pcg", {"relax_type": 3}, "pcg", 12),
    ("v4_pcg", {"relax_type": 4}, "pcg", 12),
    ("v6_pcg", {"relax_type": 6}, "pcg", 12),
    ("v8_pcg", {"relax_type": 8}, "pcg", 12),
    ("v13_pcg", {"relax_type": 13}, "pcg", 12),
    ("v14_pcg", {"relax_type": 14}, "pcg", 12),
    ("v11_pcg", {"relax_type": 11}, "pcg", 12),
    ("v12_pcg", {"relax_type": 12}, "pcg", 12),
    ("w18_pcg", {"cycle_type": "W"}, "pcg", 12),
    ("f18_pcg", {"cycle_type": "F"}, "pcg", 12),
    ("w18_gmres", {"cycle_type": "W"}, "gmres", 12),
    ("f13_bicgstab", {"cycle_type": "F", "relax_type": 13}, "bicgstab",
     12),
    ("v18_gmres", {}, "gmres", 12), ("v18_bicgstab", {}, "bicgstab", 12),
    ("v18_flexgmres", {}, "flexgmres", 12),
    ("v18_lgmres", {}, "lgmres", 12), ("v18_cogmres", {}, "cogmres", 12),
    ("v18_cgnr", {}, "cgnr", 12),
    ("order1_pcg", {"relax_order": 1}, "pcg", 12),
    ("v18_pcg_16", {}, "pcg", 16),
    ("ex_multichip_16", {"interp_type": 6}, "pcg", 16),
]


def mesh8():
    return Mesh(np.array(jax.devices()[:8]), ("p",))


def fresh_solver_cache():
    """The reference's compiled-solver cache key leaves out relax_order
    (par_amg.py:640-642), so a program built for another hierarchy could
    be reused; every solve here starts from an empty cache."""
    from hypre_tpu.solvers import par_amg

    par_amg._solver_cache.clear()


def put_csr(d, key, M):
    M = M.tocsr()
    M.sort_indices()
    d[f"{key}/indptr"] = M.indptr
    d[f"{key}/indices"] = M.indices
    d[f"{key}/data"] = M.data
    d[f"{key}/shape"] = np.asarray(M.shape)


def put_solve(d, key, x, it, rel):
    d[f"{key}/x"] = np.asarray(x).reshape(-1)
    d[f"{key}/iters"] = np.asarray(int(it))
    d[f"{key}/relres"] = np.asarray(float(rel))
    print(f"  {key}: {int(it)} iterations, relres {float(rel):.6e}",
          flush=True)


def solves(d):
    from hypre_tpu.gen import laplacian
    from hypre_tpu.solvers.amg import AmgConfig
    from hypre_tpu.solvers.par_amg import ParBoomerAMG

    for key, kw, method, n in SOLVES:
        t0 = time.time()
        fresh_solver_cache()
        A = laplacian(n, n, n)
        b = np.ones(A.shape[0])
        p = ParBoomerAMG(mesh8(), AmgConfig(**kw)).setup(A)
        x, it, rel = p.solve(b, method=method, tol=1e-8, max_iter=300)
        put_solve(d, f"solve/{key}", x, it, rel)
        print(f"    {time.time() - t0:.1f} s", flush=True)
    nx, ny, nz = 16, 16, 8
    A = laplacian(nx, ny, nz)
    fresh_solver_cache()
    p = ParBoomerAMG(mesh8(), AmgConfig()).setup(
        A, fine_stencil=((nx, ny, nz), ST7))
    x, it, rel = p.solve_pcg(np.ones(A.shape[0]), tol=1e-8, max_iter=200)
    put_solve(d, "solve/stencil_16_16_8", x, it, rel)


def hierarchies(d):
    from hypre_tpu.gen import laplacian
    from hypre_tpu.parallel.par_setup import (
        iter_par_hierarchy, pardell_from_scipy, pardell_to_scipy,
    )
    from hypre_tpu.parallel.partition import RowPartition
    from hypre_tpu.solvers.amg import AmgConfig

    A = laplacian(12, 12, 12)
    for interp in (3, 6):
        t0 = time.time()
        cfg = AmgConfig(interp_type=interp, relax_type=18, max_levels=3)
        part = RowPartition.create(A.shape[0], 8)
        Ap = pardell_from_scipy(A, part, real_dtype=np.float64)
        lvl = 0
        for item in iter_par_hierarchy(Ap, cfg, mesh8()):
            if not isinstance(item, tuple):
                put_csr(d, f"hier{interp}/final", pardell_to_scipy(item))
                continue
            Al, Pl, Rl, cf = item
            rp = Al.row_part
            st = np.minimum(np.asarray(rp.shard_starts()), rp.n_global)
            cnt = np.diff(st)
            cf = np.asarray(cf)
            d[f"hier{interp}/L{lvl}/cf"] = np.concatenate(
                [cf[p, :cnt[p]] for p in range(8)])
            for name, M in (("A", Al), ("P", Pl), ("R", Rl)):
                put_csr(d, f"hier{interp}/L{lvl}/{name}",
                        pardell_to_scipy(M))
            lvl += 1
        print(f"  hierarchy interp {interp}: {lvl} levels, "
              f"{time.time() - t0:.1f} s", flush=True)


def distributed(d):
    from hypre_tpu.gen import laplacian
    from hypre_tpu.parallel.ij_par import ParIJMatrix
    from hypre_tpu.solvers.amg import AmgConfig
    from hypre_tpu.solvers.par_amg import ParBoomerAMG

    A = laplacian(12, 12, 12)
    b = np.ones(A.shape[0])
    for key, kw, st in (
            ("pcg_12", {}, None),
            ("stencil_12_l4", {"max_levels": 4}, ((12, 12, 12), ST7))):
        t0 = time.time()
        fresh_solver_cache()
        cfg = AmgConfig(interp_type=6, relax_type=18, **kw)
        p = ParBoomerAMG(mesh8(), cfg).setup_distributed(A, fine_stencil=st)
        x, it, rel = p.solve(b, method="pcg", tol=1e-8, max_iter=200)
        put_solve(d, f"dist/{key}", x, it, rel)
        d[f"dist/{key}/levels"] = np.asarray(p.level_sizes)
        print(f"    {time.time() - t0:.1f} s", flush=True)
    n = 10
    A = laplacian(n, n, n)
    Ac = A.tocoo()
    ij = ParIJMatrix(A.shape[0], 8)
    owner = Ac.row * 8 // A.shape[0]
    for s in range(8):
        sel = owner == s
        ij.add_to_values(s, Ac.row[sel], Ac.col[sel], Ac.data[sel])
    fresh_solver_cache()
    p = ParBoomerAMG(mesh8(), AmgConfig(interp_type=3, relax_type=18)
                     ).setup_distributed(ij.assemble())
    x, it, rel = p.solve(np.ones(A.shape[0]), method="pcg", tol=1e-8,
                         max_iter=100)
    put_solve(d, "dist/ij_10", x, it, rel)


def struct(d):
    from hypre_tpu.struct.grid import (
        struct_laplacian, struct_matrix_from_stencil,
    )
    from hypre_tpu.struct.par_struct import (
        ParPFMG, ParSMG, ParSysPFMG, par_struct_pcg,
    )
    from hypre_tpu.struct.pfmg import PfmgConfig
    from hypre_tpu.struct.smg import SmgConfig

    A = struct_matrix_from_stencil((32, 16, 16), LAP7Z)
    x, it, rel = ParPFMG(mesh8(), PfmgConfig(tol=1e-7, max_iter=60)
                         ).setup(A).solve(np.ones((32, 16, 16)))
    put_solve(d, "struct/pfmg_32_16_16", x, it, rel)
    A = struct_matrix_from_stencil((16, 16, 16), LAP7Z)
    par = ParPFMG(mesh8(), PfmgConfig()).setup(A)
    res = par_struct_pcg(par, np.ones((16, 16, 16)), tol=1e-7, max_iter=60)
    put_solve(d, "struct/pcg_16", res.x, res.iters, res.relres)
    A = struct_matrix_from_stencil((32, 8, 8), LAP7Z)
    x, it, rel = ParSMG(mesh8(), SmgConfig(tol=1e-7, max_iter=40)
                        ).setup(A).solve(np.ones((32, 8, 8)))
    put_solve(d, "struct/smg_32_8_8", x, it, rel)
    shape = (16, 8, 8)
    c = 0.15
    L = struct_laplacian(*shape)
    B = struct_matrix_from_stencil(shape, [((0, 0, 0), c),
                                           ((0, 0, 1), 0.5 * c)])
    Bt = struct_matrix_from_stencil(shape, [((0, 0, 0), c),
                                            ((0, 0, -1), 0.5 * c)])
    blocks = {(0, 0): L, (0, 1): B, (1, 0): Bt, (1, 1): L}
    x, it, rel = ParSysPFMG(mesh8(), PfmgConfig(tol=1e-7, max_iter=60)
                            ).setup(blocks, 2, shape).solve(
                                np.ones((2,) + shape))
    put_solve(d, "struct/sys_16_8_8", x, it, rel)


def struct_single(d):
    """The reference's single-chip struct solves of the same problems:
    its ParPFMG's GSPMD partitioning reorders sums (test_par_struct.py:34
    bounds the gap), so the single-chip run is the port's second
    yardstick."""
    from hypre_tpu.solvers.krylov import pcg
    from hypre_tpu.struct.grid import struct_matrix_from_stencil, \
        struct_matvec
    from hypre_tpu.struct.pfmg import PFMG, PfmgConfig, pfmg_cycle

    A = struct_matrix_from_stencil((32, 16, 16), LAP7Z)
    x, it, rel = PFMG(PfmgConfig(tol=1e-7, max_iter=60)).setup(A).solve(
        np.ones((32, 16, 16)))
    put_solve(d, "struct_single/pfmg_32_16_16", x, it, rel)
    A = struct_matrix_from_stencil((16, 16, 16), LAP7Z)
    h = PFMG(PfmgConfig()).setup(A).hierarchy
    cyc = jax.jit(pfmg_cycle)
    res = pcg(jax.jit(lambda v: struct_matvec(A, v)),
              np.ones((16, 16, 16)), M=lambda r: cyc(h, r), tol=1e-7,
              max_iter=60)
    put_solve(d, "struct_single/pcg_16", res.x, res.iters, res.relres)


def amgdd(d):
    from hypre_tpu.gen import laplacian
    from hypre_tpu.parallel.amgdd import AmgDD
    from hypre_tpu.solvers.amg import AmgConfig

    A = laplacian(12, 12, 12)
    b = np.ones(A.shape[0])
    dd = AmgDD(mesh8(), AmgConfig(interp_type=6, relax_type=18),
               padding=1, fac_cycles=2).setup(A)
    hist = []
    for k in range(1, 6):
        _, it, rel = dd.solve(b, tol=1e-30, max_iter=k)
        hist.append(rel)
    d["amgdd/hist_12"] = np.asarray(hist)
    x, it, rel = dd.solve(b, tol=1e-8, max_iter=120)
    put_solve(d, "amgdd/solve_12", x, it, rel)
    A = laplacian(10, 10, 10)
    b = np.ones(A.shape[0])
    for eta in (1, 2):
        dd = AmgDD(mesh8(), AmgConfig(interp_type=3, relax_type=18),
                   padding=eta, fac_cycles=1).setup(A)
        x, it, rel = dd.solve(b, tol=1e-6, max_iter=200)
        put_solve(d, f"amgdd/pad{eta}_10", x, it, rel)


SECTIONS = {"solves": solves, "hierarchies": hierarchies,
            "distributed": distributed, "struct": struct,
            "struct_single": struct_single, "amgdd": amgdd}


def fixtures(*only) -> None:
    """All sections, or only the named ones added to the stored file."""
    d = {}
    if only:
        with np.load(OUT) as z:
            d = {k: z[k] for k in z.files}
    for name, fn in SECTIONS.items():
        if only and name not in only:
            continue
        t0 = time.time()
        print(f"{name} ...", flush=True)
        fn(d)
        print(f"{name}: {time.time() - t0:.1f} s", flush=True)
        np.savez_compressed(OUT, **d)       # kept as it grows
    print(f"wrote {OUT} ({len(d)} arrays)")


def card_struct(n: int = 128) -> None:
    """(f): the reference's single-chip CG + PFMG at n^3 (tol 1e-6, b =
    ones; its ParPFMG takes the same count), and AMG-DD at 64^3 (interp
    6, relax 18, padding 1, one FAC cycle; tol 1e-8)."""
    from hypre_tpu.gen import laplacian
    from hypre_tpu.parallel.amgdd import AmgDD
    from hypre_tpu.solvers.amg import AmgConfig
    from hypre_tpu.solvers.krylov import pcg
    from hypre_tpu.struct.grid import struct_matrix_from_stencil, \
        struct_matvec
    from hypre_tpu.struct.pfmg import PFMG, PfmgConfig, pfmg_cycle

    n = int(n)
    A = struct_matrix_from_stencil((n, n, n), LAP7Z)
    h = PFMG(PfmgConfig()).setup(A).hierarchy
    cyc = jax.jit(pfmg_cycle)
    res = pcg(jax.jit(lambda v: struct_matvec(A, v)), np.ones((n, n, n)),
              M=lambda r: cyc(h, r), tol=1e-6, max_iter=100)
    print(f"REF_PAR_PFMG_CG = ({n}, {int(res.iters)})  # relres "
          f"{float(res.relres)!r}", flush=True)
    A = laplacian(64, 64, 64)
    dd = AmgDD(mesh8(), AmgConfig(interp_type=6, relax_type=18), padding=1,
               fac_cycles=1).setup(A)
    _, it, rel = dd.solve(np.ones(A.shape[0]), tol=1e-8, max_iter=200)
    print(f"REF_PAR_AMGDD = (64, {it})  # relres {rel!r}")


def card() -> None:
    """The counts of chip_smoke.py's distributed phase (a)."""
    from hypre_tpu.gen import laplacian
    from hypre_tpu.solvers.amg import AmgConfig
    from hypre_tpu.solvers.par_amg import ParBoomerAMG

    A = laplacian(12, 12, 12)
    b = np.ones(A.shape[0])
    p = ParBoomerAMG(mesh8(), AmgConfig()).setup(A)
    _, it, rel = p.solve_pcg(b, tol=1e-8, max_iter=200)
    pw = ParBoomerAMG(mesh8(), AmgConfig(cycle_type="W")).setup(A)
    _, it_w, _ = pw.solve(b, method="gmres", tol=1e-8, max_iter=200)
    pd = ParBoomerAMG(mesh8(), AmgConfig(interp_type=6, relax_type=18)
                      ).setup_distributed(
        A, fine_stencil=((12, 12, 12), ST7))
    _, it_d, _ = pd.solve_pcg(b, tol=1e-8, max_iter=200)
    print(f"REF_PAR_DRYRUN = {{'pcg': {it}, 'relres': {rel!r}, "
          f"'gmres_w': {it_w}, 'dist_pcg': {it_d}, "
          f"'levels': {p.level_sizes}}}")


if __name__ == "__main__":
    {"fixtures": fixtures, "card": card,
     "card_struct": card_struct}[sys.argv[1]](*sys.argv[2:])
