#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (hypre_tpu_torch) on one GPU.

Run from the root of the repository, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — the card's name; nvidia-smi's name and power limit.
2. build   — the CUDA kernels (nvcc, one process per source, started
             together) and the host OpenMP setup library (g++); fails
             unless native setup is on.
3. kernel_checks (synthetic) — K1 stencil_matvec, K2 csr_spmv and K3
             dia_matvec against their plain PyTorch versions on the card,
             f32 and f64: K1 on 7-pt, 27-pt and sparse-armed stencils (the
             tile instance) and a reach-2 13-pt star (the row instance)
             over odd grids, (2, 3, 1), (33, 9, 70) and 256^3; K2 on random
             CSR at every thread-group size; K3 on 7-pt and 27-pt
             operators with odd, 2 mod 4 and 0 mod 4 row counts, a 2D 9-pt
             operator, rectangular operators with offsets past either end,
             40 diagonals and 41 (the wide instance); K4 btake_rows bit
             for bit: int32/f32/f64, K = 1 and 3, random and banded index
             sets with -1 holes, sources smaller and larger than the
             50 MB L2; bool/int32/f64 at K = 18, S = 30 with idx and X
             row windows at odd offsets.
4. main_path — hypre's out.14 problem through the port's entry points:
             laplacian, BoomerAMG(AmgConfig(interp_type=6, relax_type=18))
             .setup(A, fine_stencil=...), one warm-up and three timed
             pcg(tol=1e-8) solves in f64 with b on the card.  Launch
             counts are zeroed just before and read just after.  Fails
             unless the level sizes and operator complexity match the
             reference's and the true relative residual is <= 1e-8.
5. kernel_checks (hierarchy) — K2 on the hierarchy's own operators
             (every CSR A, P and R), f32 and f64.
6. kernel_timing — each kernel on its 256^3 operators, two times:
             `ms`, the CUDA-event median of 20 calls, each with its Python
             wrapper (comparable with earlier runs), and `kernel_ms`, the
             kernel's own device time (torch.profiler, median of 20
             back-to-back launches); beside them its plain version, one
             PyTorch library call computing the same function, and the
             bound (bytes moved over the card's memory rate), the share
             of the bound taken from `kernel_ms`.  K1 on the 7-pt f64
             main-path operator, 27-pt f64 and 7-pt f32, and its wrapper's
             host cost a call; K2 per operator.
7. profile — one more solve under torch.profiler: device time by kernel
             and by kind, and the device's busy share of the wall time.
8. small_input — the port at 24^3 on the card against the port's CPU
             path (the plain versions, held against hypre_tpu by the
             tests): same PCG iterations, x to rel 1e-10.
9. device_setup — the device-resident path at 256^3, not cut: the host
             hierarchy is dropped and the peak-memory counter reset, then
             BoomerAMG(...).setup_device(stencil=...) builds the whole
             hierarchy on the card, and one warm-up and three timed
             pcg(tol=1e-8) solves run with b on the card.  Launch counts
             are zeroed before the setup and read after it (K4), and
             zeroed before the solves and read after them (K1, K2).
             Fails unless true relres <= 1e-8 in <= 30 iterations and
             K4, K1 and K2 were launched.
10. device_setup_parity — 32^3: setup_device on the card equals the
             port's CPU path (level sizes, CF bit for bit, P and A to
             1e-12 relative); 16^3: the card's level sizes and operator
             complexity equal hypre_tpu's device hierarchy (REF_DEVICE_*).
             Relax 16 and 11 on the device setup at 16^3: the
             Chebyshev bounds and ds norms equal hypre_tpu's
             (REF_DEVICE_CHEBY_*) to 1e-12 and L, U hold
             REF_DEVICE_TRI_NNZ nonzeros a level.
11. kernel_timing (K4) — btake_rows on the 256^3 device path's own index
             sets: the level-1 PMIS neighbour read (A1's cols; f64 and
             int32 sources) and one chunk of level 0's P^T (A P) row
             expansion, `ms` and `kernel_ms` beside its plain version,
             index_select and the bound, each case with its share.
12. ij_driver — hypre's ij driver through hypre_tpu_torch.drivers.ij.run
             at -n 100 100 100 (10^6 rows, the largest round cube under
             the reference's DIA limit) in f64 on the card: (a) -solver 1
             with the driver's defaults (HMIS, ext+i, relax 13/14, PCG,
             tol 1e-8), (b) -solver 2 (DS-PCG).  Launch counts are zeroed
             just before each run and read just after it; then three more
             timed solves.  Fails unless level 0 is a DiaMatrix, K3 was
             launched, the true relative residual is <= 1e-8, the
             iteration count equals the reference's (REF_IJ_ITERS) and,
             for (a), the levels and formats are the reference's.  Then
             every A, P and R of (a)'s hierarchy against its kernel's
             plain version, f64 and f32 (K3 on the DIA levels 0-1, K2 on
             the rest; phase kernel_checks), and one V-cycle and one A x
             of (a) under torch.profiler (phase profile).
13. golden_on_card — every row of tests/golden/solvers.jobs (18: lines
             2-19), without -exec_host, on the card, against
             solvers.saved by runtest's rule (equal iterations, residual
             no worse than rtol 1e-3).
14. kernel_timing (K3) — dia_matvec on levels 0 and 1 of (a) (both
             DIA), f64 and f32, `ms` and `kernel_ms` beside its plain
             version, torch.sparse.mm and the bound; its wrapper's host
             cost a call (1,000 calls on a 16^3 operator).
15. amg_breadth — hypre's out.22 (256x256x128 7-pt, PMIS, ext+i,
             Chebyshev relax 16, PCG tol 1e-8; not cut) in f64 on the
             card, (a) through setup(A, fine_stencil=...) and (b)
             through setup_device(stencil=...): one warm-up and three
             timed solves each, launch counts zeroed before the setup
             and read after it, zeroed before the solves and read after
             them, one solve of each profiled.  Fails unless (a) takes the
             reference's iterations (REF_OUT22_ITERS), (b) at most 30,
             and both reach a true relres <= 1e-8.  (b)'s setup runs once
             more with every gather it makes held against K4's plain
             version, bit for bit.  Then relax 11 (two-stage GS) through
             setup_device at 64^3; the L and U of a relax-11 and the A^T
             of a relax-30 host hierarchy at 64^3; and out.17's
             configuration (27-pt, relax 7 w 0.85, aggressive coarsening
             with 2-stage interp 5) at 128x128x64, whose levels and
             iterations must be the reference's (REF_OUT17_*).  Each
             run's level-0 operator is held against K1's plain version,
             and each hierarchy's A, P, R (L and U for relax 11, A^T for
             relax 30) against K2's or K3's, f64 and f32.

16. ij_solvers — the ij driver's remaining solvers through
             drivers.ij.run in f64 on the card, b = ones, the driver's
             defaults: (a) every solver id that ij_driver does not run
             (5, 6, 8, 12, 16, 17, 18, 20, 43, 50, 51, 60, 61, 80, 81)
             at -n 100 100 100 (level 0 DIA on K3), AMG-CGNR (5) at 64^3
             (CGNR_GRID, a cut of depth) and the ParaSails, FSAI and ILU
             ids 8, 18, 43, 80 at 64^3 (PRECOND_GRID, a cut of depth for
             the time limit: their host setups and ILU's 783 iterations
             took 150-200 s at 100^3), the other AMG ids on one
             shared setup, each held to the reference's iterations
             (REF_IJ_SOLVER_ITERS; AMG-CGNR, whose count wanders with
             rounding, within 2%: REF_IJ_SOLVER_SLACK; 6, 17 and 60
             stop unconverged at 1000 in the reference too and are held
             to its residual, rtol 1e-3); (b) -lobpcg -solver 1 at
             128^3 (2,097,152 rows, past the DIA limit, so A is CSR and
             the block products run K2-NV), held to the reference's
             iterations and to the
             analytic eigenvalues of the Dirichlet Laplacian within
             1e-6 relative, one step's work profiled; (c) MGR-GMRES on
             tests/test_mgr.py's two-field system at 2,097,152 rows and
             at a 16th of that, whose iterations must be the port's and
             the reference's on the CPU (coarse AMG with max_row_sum
             1.0: see MGR_AMG); (d) -printsystem at 24^3 in a
             temporary directory, read back with -fromfile and
             -rhsfromfile in the same iterations.  Launch counts are
             zeroed just before each run and read just after; (b) may
             launch K2-NV at most once an iteration and once more.
             Then K2-NV (csr_spmm) against its plain version at nv in
             NV_CHECK, f64 and f32, on (b)'s A, every CSR A, P, R of the
             100^3 hierarchy and a random CSR with empty and long rows,
             and on column slices of a wider block (rows not 16-byte
             aligned) of the random CSR: each column of Y bit for bit
             K2's on that column of X, one launch a column panel.  Then
             its timing at (b)'s shape (nv = 4, 8, 12, 16, f64 and f32)
             beside its plain version, nv K2 launches, torch.sparse.mm
             and the bound.

17. struct — hypre's struct driver rows through
             hypre_tpu_torch.drivers.struct.run in f64 on the card, tol
             1e-6, b = ones, each with three more timed solves: (a) out.7
             (-n 256 256 256 -solver 11, CG+PFMG), (b) out.5 (-n 2048 2048 1
             -solver 11), (c) out.1 (-n 2048 2048 1 -solver 10, CG+SMG), each
             held to the reference's iterations (REF_STRUCT_ITERS); then
             struct_matvec (plain torch: a zeros and one addcmul_ an offset)
             timed at 256^3 with 7 offsets and on (a)'s first 27-offset
             level beside its bytes bound, and one CG+PFMG iteration of (a)
             profiled (busy share, struct_matvec against the transfers and
             the relaxation, launches); (d) out.3 (CG+SMG) at OUT3_HELD's
             size, held to the reference's count, and at its 128^3, where
             the reference cannot build its 32768^2 host inverses (the
             count printed beside hypre's 5); (e) the 4 rows of
             tests/golden/struct_solvers.jobs on the card; (f) PFMG alone
             with RB-GS at 256^3 (-solver 1 -relax 2), the reference's
             count; (g) SparseMSG at MSG_HELD's size (the reference's
             count) and at 100^3 (343 lattice grids), SysPFMG on a
             two-variable coupled system at 2x80^3, FAC on a 768^2 grid
             refined on its middle half (FAC_CYCLES cycles, held to the
             reference's residual to rtol 1e-3), the sstruct Split solver
             on two 708^2 parts (PCG); each prints setup and solve seconds,
             iterations, relres and peak memory beside hypre's published
             figures where there are some; FAC's and Split's operators are
             held against K2's or K3's plain version.  Every run checks
             the true relative residual against the tolerance.
18. maxwell — the auxiliary-space solvers and the API surface in f64 on
             the card, b = ones, tol 1e-8: (a) ex15, AMS-PCG on
             maxwell_3d(100) (3,060,300 edges; B_G's level 0 DIA on K3,
             the edge matrix, G, G^T, Pi, Pi^T and the other levels on
             K2), one warm-up and three timed solves, the sub-AMGs'
             levels and formats, launches a PCG iteration, peak memory,
             and one application profiled; (b) ADS-PCG with the inner
             AMS on rt0_3d(ADS_GRID) (a cut: the reference's B_Pi is one
             dense level, PERF.md), one application profiled; (c)
             SStructMaxwell-PCG on
             maxwell_3d(100), its edge levels; (d) AME, the 3 smallest
             non-gradient eigenpairs of maxwell_3d(AME_GRID) (a cut),
             held to the reference's iterations and its eigenvalues to
             1e-6 relative; (e) every CSR and DIA operator of (a) and
             (b) (A, G, G^T, Pi, Pi^T, C, C^T, each sub-hierarchy's A, P
             and R) against its kernel's plain version, f64 and f32;
             (f) the ex_capi HYPRE_* flow at CAPI_GRID^3 (a cut of
             depth for the time limit), a save_amg/load_amg
             round trip at 128^3 (the same iterations, x bit for bit),
             ir_solve with an f32 inner AMG-PCG at 128^3 to 1e-8 in f64,
             and every ported example at its test size.  Rows (a)-(c)
             also run at the size the reference finishes on a CPU
             (REF_AMS, REF_ADS, REF_MAXWELL), held to its count; at the
             card size the count may be 2 more (mesh independence).
             Every other count equals the reference's
             (tools/ams_reference_counts.py).

19. distributed — the distributed layer (hypre_tpu_torch/parallel,
             solvers/par_amg.py, struct/par_struct.py) in f64 on the card,
             every shard stacked in one process (StackedComm): (a) the
             repository's dryrun_multichip analog at 12^3 on 8 shards
             (ex_multichip.dryrun_multichip), held to MULTICHIP_r05.json's
             15 / 13 / 12 iterations, relres and levels; the same V-PCG at
             2, 4 and 8 shards with its launches a PCG iteration, which
             must not change with the shard count; (b) ex_multichip at
             24^3; (c) out.14 (256^3, the main path's AmgConfig and stencil
             fine level) on 8 stacked shards through ParBoomerAMG.setup and
             solve_sharded: the reference's levels and operator
             complexity, the main path's iterations, true relres <= 1e-8,
             setup_s, solve_s (median of 3 after a warm-up) and peak memory
             beside the main path's; K2 against its plain version on every
             stacked diag and offd block of every A, P and R, f64 and f32;
             (e) the 128^3 Laplacian assembled by ParIJMatrix from
             off-process entries only, exactly scipy's; (d)
             setup_distributed on it (interp 6, relax 18, stencil fine
             level): C/F splits equal at every level to those of
             setup_device on the same matrix (its slots in the same
             order), the PCG count within 1 of its, K2 on every block;
             (f) CG + ParPFMG at 128^3 (REF_PAR_PFMG_CG), CG +
             ParSMG at 32^3 (OUT3_HELD) and 64^3 (the single-device
             count), ParSysPFMG at 2 x 80^3 (REF_G["sys"]), each with its
             exchanges and all_gathers a cycle, and AMG-DD at 64^3
             (REF_PAR_AMGDD) with one composite gather an outer iteration
             and K2 on its composite operators; (g) a DistComm on a
             world-size-1 NCCL group, (a)'s V-PCG equal to the stacked run
             with 1 shard.  The phase prints its wall_s.

Then the kernels line, nvidia-smi's line, and the last line
{"ok": true, "device": {...}}.  Any failed check raises: nothing is
caught and carried on.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from hypre_tpu_torch import Config, hypre_compat as H, set_config
from hypre_tpu_torch.core.checkpoint import load_amg, save_amg
from hypre_tpu_torch.csrc import build
from hypre_tpu_torch.examples import (
    ex3_pfmg, ex5, ex6_multibox, ex9_systems, ex11, ex15_ams, ex_capi,
    ex_lobpcg, ex_struct,
)
from hypre_tpu_torch.gen import laplacian
from hypre_tpu_torch.drivers import ij
from hypre_tpu_torch.gen import laplacian_9pt, laplacian_27pt
from hypre_tpu_torch.ops.btake import btake_rows, btake_rows_plain
from hypre_tpu_torch.ops.dia import (
    DiaMatrix, dia_from_scipy, dia_matvec, dia_matvec_plain,
)
from hypre_tpu_torch.ops.formats import (
    CsrMatrix, DenseMatrix, matmat, matvec,
)
from hypre_tpu_torch.ops.spmv import (
    csr_from_scipy, csr_spmm, csr_spmm_plain, csr_spmv, csr_spmv_plain,
)
from hypre_tpu_torch.ops.stencil import (
    stencil_matvec, stencil_matvec_plain, stencil_op,
)
from hypre_tpu_torch.setup import device_amg as dev
from hypre_tpu_torch.setup.utils import native_enabled
from hypre_tpu_torch.solvers import AmgConfig, BoomerAMG, pcg
from hypre_tpu_torch.solvers.ams import ADS, AME, AMS, maxwell_3d, rt0_3d
from hypre_tpu_torch.solvers.par_amg import ParBoomerAMG
from hypre_tpu_torch.solvers.refine import ir_solve, stencil_apply_f64
from hypre_tpu_torch.drivers import struct as struct_driver
from hypre_tpu_torch.ops.formats import sparse_op_from_scipy
from hypre_tpu_torch.sstruct import (
    SplitSolver, SStructGrid, SStructMatrix, SStructMaxwell,
)
from hypre_tpu_torch.struct import (
    FAC, FacConfig, PfmgConfig, SparseMSG, SparseMSGConfig, SysPFMG,
    struct_laplacian, struct_matrix_from_stencil, struct_matvec,
)
from hypre_tpu_torch.struct.sys_pfmg import _sys_matvec as sys_matvec
from hypre_tpu_torch.testing import runtest

LAPLACE_7PT = [((0, 0, 0), 6.0), ((-1, 0, 0), -1.0), ((1, 0, 0), -1.0),
               ((0, -1, 0), -1.0), ((0, 1, 0), -1.0),
               ((0, 0, -1), -1.0), ((0, 0, 1), -1.0)]
LAPLACE_27PT = [((dx, dy, dz), 26.0 if dx == dy == dz == 0 else -1.0)
                for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                for dx in (-1, 0, 1)]
# reach 2 (K1's row instance): a 13-pt star
STAR_13PT = [((0, 0, 0), 12.0)] + [
    (tuple(s * r if a == ax else 0 for a in range(3)), -1.0 / r)
    for ax in range(3) for r in (1, 2) for s in (-1, 1)]
# reach 1 with arms missing, in no canonical order (K1's tile instance)
SPARSE_ARMS = [((0, 0, 1), -0.5), ((0, 0, 0), 4.0), ((-1, 1, -1), -0.25),
               ((1, 0, 0), -1.0), ((0, -1, 0), -1.5)]
GRID = 256        # out.14: -n 256 256 256 (BASELINE.md:20), not cut
# BENCH_r05.json:19-31, the reference's host setup at 256^3
REF_LEVELS = [16777216, 5156632, 684520, 71646, 8141, 969, 183, 27, 5]
REF_OPERATOR_COMPLEXITY = 2.775
# hypre_tpu's device hierarchy of the 16^3 7-pt Laplacian (interp 6,
# relax 18), computed on the CPU with jax_enable_x64 by chaining
# hypre_tpu/setup/device_amg.py's stage functions as its
# iter_device_hierarchy does (ref_device_hierarchy in
# tests/torch_port_helpers.py shows how); nonzeros are the DEll's valid
# slots
REF_DEVICE_LEVELS = [4096, 1383, 213, 30, 4]
REF_DEVICE_NNZ = [27136, 33519, 9333, 732, 16]
REF_DEVICE_OPERATOR_COMPLEXITY = 2.6067216981132075
# hypre_tpu's ij driver (hypre_tpu/drivers/ij.py, run as a module) at
# 100^3 on the CPU in f64:
#   -n 100 100 100 -solver 1 -exec_host
#     Iterations = 12, Final Relative Residual Norm = 7.407588e-09
#   -n 100 100 100 -solver 2 -exec_host
#     Iterations = 249, Final Relative Residual Norm = 8.735489e-09
IJ_GRID = 100
REF_IJ_ITERS = {1: 12, 2: 249}
# the reference's hierarchy of the same setup (its BoomerAMG with the
# driver's defaults, hypre_tpu/solvers/amg.py, on the CPU): sizes, and
# formats as the port stores them (GstEllMatrix -> CsrMatrix)
REF_IJ_LEVELS = [1000000, 500000, 157080, 46078, 7914, 1141, 153, 33, 15, 6]
REF_IJ_FORMATS = ["DiaMatrix"] * 2 + ["CsrMatrix"] * 3 + ["DenseMatrix"] * 5
# hypre_tpu's device Chebyshev setup (hypre_tpu/solvers/amg.py:730) on
# each level of the 16^3 hierarchy above, run on the CPU with
# jax_enable_x64 on the operator its setup_device packs: bounds
# [lmax, lmin] and the 2-norm of ds = 1/sqrt(|diag|); and the nonzeros
# of the strict lower (= upper) triangle of each level's A, the L and U
# of relax 11
REF_DEVICE_CHEBY_BOUNDS = [[2.0015502666689815, 0.6004650800006944],
                           [1.3402839450807114, 0.4020851835242134],
                           [1.2972807465436234, 0.389184223963087],
                           [1.296751567441647, 0.38902547023249406]]
REF_DEVICE_CHEBY_DS_NORM = [26.12789058968724, 15.890579991445751,
                            5.658437690785739, 2.006044825667334]
REF_DEVICE_TRI_NNZ = [11520, 16068, 4560, 351]
# hypre's TEST_bench out.22 (benchmark_ij.jobs:80): the 7-pt Laplacian
# at -n 256 256 128, PMIS, ext+i, relax 16 (Chebyshev, order 2), PCG at
# tol 1e-8, as tools/golden_cases.py case 22 configures it; not cut.
# hypre_tpu's count at this size on the CPU in f64, measured with
#   python tools/golden_cases.py 22
#     out.22: 14 iters (golden 13) relres 2.76e-09
OUT22_GRID = (256, 256, 128)
REF_OUT22_ITERS = 14
# out.17's configuration (golden_cases.py case 17: 27-pt, relax 7 w 0.85,
# aggressive coarsening on 1 level with 2-stage interp 5, ext+i, PMIS)
# at 128x128x64, an eighth of the published 256x256x128 (PERF.md §4);
# hypre_tpu's host setup and pcg at this size on the CPU in f64:
# 19 iterations, relres 3.868637865326376e-09
OUT17_GRID = (128, 128, 64)
REF_OUT17_ITERS = 19
REF_OUT17_LEVELS = [1048576, 14762, 1750, 223, 28]
# hypre_tpu's ij driver (hypre_tpu/drivers/ij.py, run as a module) at
# 100^3 on the CPU in f64, every solver id that the ij_driver phase does
# not run, each with -n 100 100 100 -solver S -exec_host: iterations, and
# the final relative residual it printed (6, 17 and 60 stop at
# -max_iter 1000 unconverged).  -solver 5 (AMG-CGNR, two exact-GS
# V-cycles an iteration) runs at CGNR_GRID: at 100^3 its 200 iterations
# took 127 s on an H100 (700 W), and with the struct phase the whole run
# would pass ~1000 s, so its depth is cut to 64^3.  The reference's
# driver does not compile it (the while_loop inlines the exact-GS cycle
# twice and LLVM runs out of mapped memory); its count is the reference's
# cgnr with the cycle jitted once, python tools/ij_reference_counts.py
# cgnr 64: 100 iterations, relres 9.722794e-09 (203 at 100^3).  Since
# PR 10 ParaSails-PCG/GMRES (8, 18), FSAI-PCG (43) and ILU-GMRES (80) run
# at PRECOND_GRID too, a cut of depth that keeps the whole run well
# inside its limit with the maxwell phase: their host setups and ILU's
# 783 GMRES iterations took 150-250 s at 100^3 (PERF.md); their counts
# there were 152, 1000 (unconverged, relres 1.574823e-04), 117 and 783.
CGNR_GRID = 64
PRECOND_GRID = 64
PRECOND_CUT = (8, 18, 43, 80)
REF_IJ_SOLVER_ITERS = {5: 100, 6: 1000, 8: 98, 12: 272, 16: 15, 17: 1000,
                       18: 908, 20: 14, 43: 81, 50: 525, 51: 12,
                       60: 1000, 61: 13, 80: 341, 81: 98}
REF_IJ_SOLVER_RELRES = {5: 9.722794e-09, 6: 6.954759e-01, 8: 8.732218e-09,
                        12: 9.222296e-09, 16: 6.981601e-11,
                        17: 6.211218e-02, 18: 9.935590e-09,
                        20: 6.990455e-09, 43: 9.082759e-09,
                        50: 9.794265e-09, 51: 7.466335e-09,
                        60: 6.211218e-02, 61: 2.237597e-09,
                        80: 9.896696e-09, 81: 9.144086e-09}
# AMG-CGNR's count wanders with rounding: CG on the normal equations
# takes ~200 iterations at 100^3, and the port took 201 there on the CPU
# (its driver with -exec_host) and 200 on the card, where the reference
# takes 203; at 64^3 the port takes 99 on the CPU, the reference 100.
# It is held within 2% of the reference's; tests/test_torch_krylov_
# breadth.py holds AMG-CGNR to the reference's exact count at 13^3.
# Every other id is held exactly.
REF_IJ_SOLVER_SLACK = {5: 2}
# the same driver in LOBPCG mode at 128^3 (-lobpcg -solver 1), whose
# eager V-cycles take hours on the CPU; the reference's lobpcg with the
# cycle jitted once gives the driver's output digit for digit at 10^3:
# python tools/ij_reference_counts.py lobpcg 128
#   LOBPCG iterations = 20 (eigenvalues 1.779180929163656e-03 and
#   3 x 3.5580101377963e-03)
LOBPCG_GRID = 128
REF_LOBPCG_ITERS = 20
# MGR-GMRES on tests/test_mgr.py's two-field system (mgr_coupled_system):
# at n = 1024 (2,097,152 rows) on the card, and at n = 256 (131,072
# rows, a 16th) on the card against the counts of the same solve on the
# CPU in f64, by the port and by hypre_tpu (the same config).  Its
# coarse AMG takes max_row_sum 1.0: with MGR's default 0.9 the coarse
# pressure operators, diagonally dominant through the identity block,
# stop coarsening at a 4,967-row level at n = 256 and a ~76k-row one at
# n = 1024, whose dense LU (46.5 GiB) does not fit the card
MGR_N, MGR_SMALL_N = 1024, 256
MGR_AMG = AmgConfig(interp_type=6, max_row_sum=1.0)
REF_MGR_SMALL_ITERS = 10
PORT_MGR_SMALL_ITERS = 10
# the round trip of the ij driver's -printsystem, -fromfile and
# -rhsfromfile
IO_GRID = 24
# K2-NV's block widths: every width LOBPCG's block of 4 gives (4, 8, 12),
# odd widths (a scalar tail, rows not 16-byte aligned: 1, 3, 5), one
# launch's widest block in f64 (16) and two panels in f64 (17)
NV_CHECK = (1, 2, 3, 4, 5, 8, 12, 16, 17)
GOLDEN = Path(__file__).resolve().parent / "tests" / "golden"
# tolerance of a kernel against its plain version: max |kernel - plain|
# over max(|A| |x|), the size of the terms summed (order of summation
# and FMA contraction differ between the two)
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
F64 = torch.float64


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_peaks(name: str) -> dict:
    """Published peaks (NVIDIA data sheets) of the card's variant:
    memory bytes/s and non-tensor-core f64 and f32 FLOP/s."""
    if "H200" in name:
        return {"variant": "H200 SXM", "bytes_s": 4.8e12,
                "f64": 34e12, "f32": 67e12}
    if "PCIe" in name:
        return {"variant": "H100 PCIe", "bytes_s": 2.0e12,
                "f64": 26e12, "f32": 51e12}
    if "NVL" in name:
        return {"variant": "H100 NVL", "bytes_s": 3.9e12,
                "f64": 30e12, "f32": 60e12}
    return {"variant": "H100 SXM", "bytes_s": 3.35e12,
            "f64": 34e12, "f32": 67e12}


def bound_ms(peaks, n_bytes: float, flops: float, dtype) -> tuple:
    t_bytes = n_bytes / peaks["bytes_s"] * 1e3
    t_ops = flops / peaks["f64" if dtype == F64 else "f32"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def time_ms(fn, reps: int = 20) -> float:
    """Median device time of one call, CUDA events around each call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def kernel_ms(fn, match: str, reps: int = 20, lead: int = 5,
              sessions: int = 5) -> float:
    """Median device time of one launch of the kernel whose name holds
    `match`, over `reps` back-to-back calls of `fn` under torch.profiler:
    CUPTI's record of each kernel's own start and end, so no host time
    (wrapper, launch) is counted, unlike time_ms.  The tracer can drop
    records (seen on the H100: 18 of 20 kernels, 11 of 25 copies
    traced), so each session makes `lead` + `reps` calls and sessions
    repeat, their records pooled, until `reps` are in hand."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    durs = []
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(lead + reps):
                fn()
            torch.cuda.synchronize()
        durs += [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and match in e.name]
        if len(durs) >= reps:
            return statistics.median(durs[-reps:]) / 1e3
    raise AssertionError(f"kernel_ms: {len(durs)} launches of {match!r} "
                         f"traced in {sessions} sessions of {lead + reps}")


def wrapper_us(fn, calls: int = 1000) -> float:
    """Host time a call: a host clock around `calls` calls ending in one
    synchronize.  On an operator whose kernel takes a few µs the host
    is the slower side, so this is the wrapper's cost a call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def reset_counts() -> None:
    stencil_matvec.launches = 0
    csr_spmv.launches = 0
    csr_spmm.launches = 0
    dia_matvec.launches = 0
    btake_rows.launches = 0


def read_counts() -> dict:
    return {"stencil_matvec": stencil_matvec.launches,
            "csr_spmv": csr_spmv.launches, "csr_spmm": csr_spmm.launches,
            "dia_matvec": dia_matvec.launches,
            "btake_rows": btake_rows.launches}


def rel_err(y, y_ref, scale) -> tuple[float, float]:
    err = float((y - y_ref).abs().max())
    return err, err / max(float(scale.abs().max()), 1e-300)


def check_stencil(op, x) -> dict:
    y = stencil_matvec(op, x)
    torch.cuda.synchronize()
    y_ref = stencil_matvec_plain(op, x)
    scale = stencil_matvec_plain(
        dataclasses.replace(op, entries=tuple(
            (d, abs(v)) for d, v in op.entries)), x.abs())
    err, rel = rel_err(y, y_ref, scale)
    ok = rel <= TOL[op.dtype] and bool(torch.isfinite(y).all())
    if not ok:
        raise AssertionError(f"stencil_matvec {op.grid} {op.dtype}: "
                             f"rel err {rel:.3e} > {TOL[op.dtype]:g}")
    return {"grid": list(op.grid), "entries": len(op.entries),
            "reach": op.reach, "instance": op.launch_args.instance,
            "dtype": str(op.dtype), "max_abs_err": err, "rel_err": rel}


def check_csr(A: CsrMatrix, x, label: str) -> dict:
    y = csr_spmv(A, x)
    torch.cuda.synchronize()
    y_ref = csr_spmv_plain(A, x)
    scale = csr_spmv_plain(dataclasses.replace(A, values=A.values.abs()),
                           x.abs())
    err, rel = rel_err(y, y_ref, scale)
    if not (rel <= TOL[A.dtype] and bool(torch.isfinite(y).all())):
        raise AssertionError(f"csr_spmv {label} {A.dtype}: rel err "
                             f"{rel:.3e} > {TOL[A.dtype]:g}")
    return {"op": label, "shape": list(A.shape), "nnz": A.nnz,
            "group": A.group, "dtype": str(A.dtype), "max_abs_err": err,
            "rel_err": rel}


def check_dia(A: DiaMatrix, x, label: str) -> dict:
    y = dia_matvec(A, x)
    torch.cuda.synchronize()
    y_ref = dia_matvec_plain(A, x)
    scale = dia_matvec_plain(dataclasses.replace(A, vals=A.vals.abs()),
                             x.abs())
    err, rel = rel_err(y, y_ref, scale)
    if not (rel <= TOL[A.dtype] and bool(torch.isfinite(y).all())):
        raise AssertionError(f"dia_matvec {label} {A.dtype}: rel err "
                             f"{rel:.3e} > {TOL[A.dtype]:g}")
    return {"op": label, "shape": list(A.shape), "n_diags": len(A.offsets),
            "instance": A.launch_args.instance, "dtype": str(A.dtype),
            "max_abs_err": err, "rel_err": rel}


def dia_synthetic(gen, dtype) -> list:
    """K3 on stencil operators over grids whose row counts are odd, 2
    mod 4 and 0 mod 4 (K3 takes 2 rows a thread in f64, 4 in f32), a 2D
    9-pt operator, and five built with values on every slot (so the
    masks at x's ends are read): two rectangular ones whose offsets fall
    wholly past either end, two of 40 diagonals (dia_from_scipy's most,
    K3's by-value limit) and one of 41 (the wide instance)."""
    dev_ = torch.device("cuda")
    rng = np.random.default_rng(11)
    ops = [(f"7pt {g}", dia_from_scipy(laplacian(*g), dtype, dev_))
           for g in ((13, 9, 7), (101, 37, 29), (101, 37, 30),
                     (100, 50, 20))]
    ops += [(f"27pt {g}", dia_from_scipy(laplacian_27pt(*g), dtype, dev_))
            for g in ((13, 9, 7), (65, 33, 17), (64, 32, 16))]
    ops.append(("9pt 2D (301, 207)",
                dia_from_scipy(laplacian_9pt(301, 207), dtype, dev_)))
    rect = (-1_100_000, -400_000, -1, 0, 7, 250_000, 800_000)
    off40 = tuple(sorted(int(d) for d in rng.choice(
        np.arange(-20_000, 20_000), 40, replace=False)))
    off41 = tuple(sorted(int(d) for d in rng.choice(
        np.arange(-20_000, 20_000), 41, replace=False)))
    for label, offs, n_rows, n_cols in (
            ("rect", rect, 1_000_003, 700_001),
            ("rect", rect, 1_000_004, 700_001),
            ("40 offsets", off40, 2_000_003, 2_000_003),
            ("40 offsets", off40, 2_000_004, 2_000_004),
            ("41 offsets", off41, 2_000_003, 2_000_003)):
        vals = torch.randn((len(offs), n_rows), generator=gen, device=dev_,
                           dtype=dtype)
        ops.append((f"{label} ({n_rows} rows)",
                    DiaMatrix(vals=vals, offsets=offs, n_cols=n_cols)))
    out = []
    for label, A in ops:
        x = torch.randn(A.n_cols, generator=gen, dtype=dtype, device=dev_)
        out.append(check_dia(A, x, label))
    if {r["instance"] for r in out} != {"param", "wide"}:
        raise AssertionError("K3's synthetic cases missed an instance")
    return out


def random_csr(n_rows, n_cols, max_row, band, rng):
    import scipy.sparse as sp

    counts = rng.integers(0, max_row + 1, size=n_rows)
    rows = np.repeat(np.arange(n_rows), counts)
    center = (rows * (n_cols / n_rows)).astype(np.int64)
    cols = np.clip(center + rng.integers(-band, band + 1, size=len(rows)),
                   0, n_cols - 1)
    vals = rng.standard_normal(len(rows))
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n_rows, n_cols))
    A.sum_duplicates()
    return A


def mgr_coupled_system(n):
    """tests/test_mgr.py's two-field system, rebuilt with the port's
    generator: [[L + I, eps I], [eps I, D]] on an n x n grid, dofs
    interleaved (2i pressure, 2i+1 saturation), the pressure dofs the
    coarse block."""
    import scipy.sparse as sp

    L = laplacian(n, n)
    m = L.shape[0]
    rng = np.random.RandomState(0)
    D = sp.diags(1.0 + rng.rand(m))
    eps = 0.1
    A = sp.bmat([[L + sp.identity(m), eps * sp.identity(m)],
                 [eps * sp.identity(m), D]]).tocsr()
    perm = np.argsort(np.concatenate([2 * np.arange(m),
                                      2 * np.arange(m) + 1]))
    P = sp.identity(2 * m).tocsr()[perm]
    A = (P @ A @ P.T).tocsr()
    c_mask = np.zeros(2 * m, bool)
    c_mask[0::2] = True
    return A, c_mask


def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    peaks = card_peaks(name)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "peaks_used": peaks})
    return {"name": name, "smi": smi, "peaks": peaks}


def ptxas_report(log: str) -> list[str]:
    """One line a kernel from nvcc's -Xptxas -v log: its name with the
    mangled template arguments, registers, spill bytes."""
    out, name, spill = [], "?", ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?\d+([a-z_]+_kernel)"
                      r"(?:I(\w+?)EE)?", ln)
        if m:
            name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
            spill = ""
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = f"spill {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.append(f"{name}: {m.group(1)} registers, {spill}")
    return out


def phase_build() -> None:
    t0 = time.perf_counter()
    report = build.build_cuda()
    t_cuda = time.perf_counter() - t0
    t0 = time.perf_counter()
    build.load()
    t_host = time.perf_counter() - t0
    native = native_enabled()
    emit({"phase": "build", "cuda_s": {s: r["seconds"]
                                       for s, r in report.items()},
          "cuda_total_s": t_cuda, "host_setup_kernels_s": t_host,
          "native_setup": native,
          "ptxas": {s: ptxas_report(r["log"]) for s, r in report.items()}})
    if not native:
        raise AssertionError("native setup did not run")


def check_btake(idx, X, fill, label: str) -> dict:
    """K4 against its plain version: a gather is exact, so bit for bit."""
    Y = btake_rows(idx, X, fill)
    torch.cuda.synchronize()
    Y_ref = btake_rows_plain(idx, X, fill)
    if not torch.equal(Y, Y_ref):
        raise AssertionError(f"btake_rows {label} {X.dtype}: differs from "
                             f"its plain version")
    err = float((Y.double() - Y_ref.double()).abs().max()) \
        if Y.numel() else 0.0
    return {"case": label, "S": idx.shape[0], "n": idx.shape[1],
            "K": X.shape[0], "n_src": X.shape[1], "dtype": str(X.dtype),
            "max_abs_err": err, "rel_err": 0.0}


def btake_synthetic(gen) -> list:
    dev_ = torch.device("cuda")
    out = []
    # n_src of 100k (0.8 MB as f64) fits the 50 MB L2; 20M (160 MB) not
    for n_src in (100_003, 20_000_000):
        for S, n in ((7, 300_007), (64, 50_021)):
            rnd = torch.randint(-1, n_src, (S, n), generator=gen,
                                device=dev_, dtype=torch.int32)
            center = (torch.arange(n, device=dev_) * (n_src / n)).long()
            band = (center[None] + torch.randint(
                -500, 501, (S, n), generator=gen, device=dev_)).clamp(
                0, n_src - 1).to(torch.int32)
            band[torch.rand((S, n), generator=gen, device=dev_) < 0.2] = -1
            for kind, idx in (("random", rnd), ("banded", band)):
                for dtype in (torch.int32, torch.float32, torch.float64):
                    for K in (1, 3):
                        X = (torch.randn((K, n_src), generator=gen,
                                         device=dev_) * 1e4).to(dtype)
                        out.append(check_btake(
                            idx, X, -1 if dtype == torch.int32 else 0,
                            f"{kind} n_src={n_src}"))
                        del X
    # the device setup's expansion shape: K = 18 source rows, S = 30
    # slots, idx and X as row windows at odd offsets, n odd
    n_src, S, n, K = 1_000_003, 30, 200_001, 18
    big = torch.randint(-1, n_src, (S, n + 8), generator=gen, device=dev_,
                        dtype=torch.int32)
    for dtype in (torch.bool, torch.int32, torch.float64):
        Xb = (torch.randn((K + 1, n_src + 5), generator=gen, device=dev_)
              * 1e4).to(dtype)
        out.append(check_btake(big[:, 3:3 + n], Xb[1:, 1:1 + n_src],
                               0, "windows at odd offsets"))
        del Xb
    return out


def phase_synthetic_checks(gen) -> None:
    dev = torch.device("cuda")
    results = []
    for dtype in (torch.float64, torch.float32):
        for grid in ((13, 9, 7), (31, 17, 5), (1, 1, 33), (2, 3, 1),
                     (33, 9, 70), (256, 256, 256)):
            for ents in (LAPLACE_7PT, LAPLACE_27PT, SPARSE_ARMS, STAR_13PT):
                op = stencil_op(grid, ents, dtype=dtype)
                x = torch.randn(op.n_rows, generator=gen, dtype=dtype,
                                device=dev)
                results.append(check_stencil(op, x))
                if results[-1]["instance"] != ("row" if ents is STAR_13PT
                                               else "tile"):
                    raise AssertionError(f"K1 {grid}: instance "
                                         f"{results[-1]['instance']}")
        rng = np.random.default_rng(7)
        A = random_csr(100_003, 90_001, 70, 600, rng)
        base = csr_from_scipy(A, dtype, dev)
        x = torch.randn(A.shape[1], generator=gen, dtype=dtype, device=dev)
        for g in (2, 4, 8, 16, 32):
            results.append(check_csr(dataclasses.replace(base, group=g), x,
                                     f"random G={g}"))
        results += dia_synthetic(gen, dtype)
        torch.cuda.synchronize()
    results += btake_synthetic(gen)
    reset_counts()
    emit({"phase": "kernel_checks", "set": "synthetic",
          "kernel_names": ["stencil_matvec", "csr_spmv", "dia_matvec",
                           "btake_rows"],
          "n_checks": len(results),
          "worst_rel_err": max(r["rel_err"] for r in results),
          "checks": results})


def timed_solves(op, M, plain, max_iter: int = 100) -> dict:
    """One warm-up and three timed pcg(tol=1e-8) solves with b = ones
    (scaled a little each time) on the card; the true relative residual
    of the last, with A x by `plain`."""
    b = torch.ones(op.n_rows, dtype=F64, device="cuda")
    warm = pcg(op, b, M=M, tol=1e-8, max_iter=max_iter)
    iters, times = [warm.iters], []
    for t in range(3):
        bt = b * (1.0 + 0.0137 * (t + 1))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = pcg(op, bt, M=M, tol=1e-8, max_iter=max_iter)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        iters.append(res.iters)
    x = res.x
    if not bool(torch.isfinite(x).all()) or x.shape != (op.n_rows,):
        raise AssertionError("solution is not finite or has a wrong shape")
    true_relres = float(torch.linalg.vector_norm(bt - plain(op, x))
                        / torch.linalg.vector_norm(bt))
    solve_s = statistics.median(times)
    return {"iters": res.iters, "iters_all_solves": iters,
            "relres": res.relres, "true_relres": true_relres,
            "solve_s": solve_s, "solve_times_s": times,
            "per_iter_ms": solve_s / max(res.iters, 1) * 1e3}


def phase_main_path() -> dict:
    set_config(Config(real_dtype=F64, device="cuda"))
    n = GRID
    t0 = time.perf_counter()
    A = laplacian(n, n, n)
    gen_s = time.perf_counter() - t0
    # print_level=1: per-level host-build and upload times on stderr
    cfg = AmgConfig(interp_type=6, relax_type=18, print_level=1)
    reset_counts()
    t0 = time.perf_counter()
    amg = BoomerAMG(cfg).setup(A, fine_stencil=((n, n, n), LAPLACE_7PT))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    op = amg.hierarchy.levels[0].A
    sol = timed_solves(op, amg, stencil_matvec_plain)
    launches = read_counts()
    out = {
        "phase": "main_path", "grid": [n, n, n],
        "dtype": "float64", "levels": amg.level_sizes,
        "operator_complexity": round(amg.operator_complexity, 3),
        "operator_complexity_raw": amg.operator_complexity,
        "level_formats": amg.level_formats, "gen_s": gen_s,
        "setup_s": setup_s, **sol, "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "v100_reference": {"setup_s": 0.706, "solve_s": 0.580,
                           "iters": 20},
    }
    emit(out)
    if sol["true_relres"] > 1e-8:
        raise AssertionError(f"true relative residual "
                             f"{sol['true_relres']:.3e}")
    if amg.level_sizes != REF_LEVELS or round(
            amg.operator_complexity, 3) != REF_OPERATOR_COMPLEXITY:
        raise AssertionError("hierarchy differs from the reference's")
    for name in ("stencil_matvec", "csr_spmv"):
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched on the main path")
    return {"amg": amg, "op": op, "launches": launches, "out": out}


def hierarchy_ops(amg, kinds=(CsrMatrix,),
                  names=("A", "P", "R")) -> list[tuple[str, object]]:
    ops = []
    for l, lvl in enumerate(amg.hierarchy.levels):
        for name in names:
            m = getattr(lvl, name)
            if isinstance(m, kinds):
                ops.append((f"{name}{l}", m))
    return ops


def phase_hierarchy_checks(amg, gen, path: str,
                           names=("A", "P", "R")) -> dict:
    """Every DIA and CSR operator of the hierarchy (A, P, R of each
    level, or the fields `names`) against its kernel's plain version,
    f64 and f32; returns the largest f64 error by kernel."""
    return phase_ops_checks(hierarchy_ops(amg, (CsrMatrix, DiaMatrix),
                                          names), gen, path)


def phase_ops_checks(ops, gen, path: str) -> dict:
    """Each (label, DIA or CSR operator) against its kernel's plain
    version, f64 and f32; returns the largest f64 error by kernel, and
    under "<kernel> rel" the largest f64 error relative to |A| |x|."""
    results = []
    for label, A in ops:
        for dtype in (torch.float64, torch.float32):
            if isinstance(A, DiaMatrix):
                Ad = A if dtype == A.dtype else dataclasses.replace(
                    A, vals=A.vals.to(dtype))
                check, kernel = check_dia, "dia_matvec"
            else:
                Ad = A if dtype == A.dtype else A.to(dtype)
                check, kernel = check_csr, "csr_spmv"
            x = torch.randn(A.n_cols, generator=gen, dtype=dtype,
                            device="cuda")
            results.append(dict(check(Ad, x, label), kernel=kernel))
            del Ad
    torch.cuda.synchronize()
    kernels = sorted({r["kernel"] for r in results})
    emit({"phase": "kernel_checks", "set": "hierarchy", "path": path,
          "kernel_names": kernels, "n_checks": len(results),
          "checks": results})
    out = {}
    for k in kernels:
        f64 = [r for r in results
               if r["kernel"] == k and r["dtype"] == str(torch.float64)]
        out[k] = max(r["max_abs_err"] for r in f64)
        out[f"{k} rel"] = max(r["rel_err"] for r in f64)
    return out


def launches_per_iter(precondition, op) -> dict:
    """Kernel launches of one PCG iteration: one A·p plus one
    application of the preconditioner."""
    r = torch.ones(op.n_rows, dtype=F64, device="cuda")
    reset_counts()
    precondition(r)
    matvec(op, r)
    torch.cuda.synchronize()
    out = read_counts()
    reset_counts()
    return out


def k1_timing(op, x, peaks) -> dict:
    """K1 on `op` (reach 1): both times, its plain version, conv3d and
    the bound (x read and y written once)."""
    k_ms = time_ms(lambda: stencil_matvec(op, x))
    k_kms = kernel_ms(lambda: stencil_matvec(op, x), "stencil_matvec_")
    k_plain = time_ms(lambda: stencil_matvec_plain(op, x))
    w = torch.zeros((1, 1, 3, 3, 3), dtype=op.dtype, device="cuda")
    for (dx, dy, dz), v in op.entries:
        w[0, 0, dz + 1, dy + 1, dx + 1] = v
    nx, ny, nz = op.grid
    x5 = x.reshape(1, 1, nz, ny, nx)
    conv = torch.nn.functional.conv3d
    y_conv = conv(x5, w, padding=1).reshape(-1)
    conv_err = float((y_conv - stencil_matvec(op, x)).abs().max())
    k_lib = time_ms(lambda: conv(x5, w, padding=1))
    # a copy of x into y moves the bytes the bound counts: the practical
    # floor of a kernel that reads x and writes y
    y = torch.empty_like(x)
    copy_kms = kernel_ms(lambda: y.copy_(x), "Memcpy DtoD")
    n = op.n_rows
    k_bound, k_by = bound_ms(peaks, 2 * n * x.element_size(),
                             2 * len(op.entries) * n, op.dtype)
    return {"grid": list(op.grid), "entries": len(op.entries),
            "dtype": str(op.dtype), "instance": op.launch_args.instance,
            "ms": k_ms, "kernel_ms": k_kms, "plain_ms": k_plain,
            "library_ms": k_lib,
            "library": "torch.nn.functional.conv3d (3x3x3, zero padding)",
            "library_max_abs_diff": conv_err, "bound_ms": k_bound,
            "bound_by": k_by, "copy_kernel_ms": copy_kms,
            "share_of_bound": k_bound / k_kms,
            "share_of_bound_with_wrapper": k_bound / k_ms}


def phase_timing(amg, op, peaks, gen) -> dict:
    per_iter = launches_per_iter(amg.precondition, op)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n = op.n_rows
    x = torch.randn(n, generator=gen, dtype=F64, device="cuda")
    # K1 at the main path's shape, then 27-pt f64 and 7-pt f32 beside it
    k1 = k1_timing(op, x, peaks)
    k1["per_pcg_iter"] = per_iter["stencil_matvec"]
    k1_rows = [k1]
    for ents, dtype in ((LAPLACE_27PT, F64), (LAPLACE_7PT, torch.float32)):
        k1_rows.append(k1_timing(stencil_op(op.grid, ents, dtype=dtype),
                                 x.to(dtype), peaks))
    small = stencil_op((16, 16, 16), LAPLACE_7PT, dtype=F64)
    xs = torch.randn(small.n_rows, generator=gen, dtype=F64, device="cuda")
    k1["wrapper_us"] = wrapper_us(lambda: stencil_matvec(small, xs))
    reset_counts()
    # K2 on every CSR operator of one V-cycle: A twice, P and R once
    ops = []
    for label, A in hierarchy_ops(amg):
        per_cycle = 2 if label.startswith("A") else 1
        xa = torch.randn(A.n_cols, generator=gen, dtype=F64, device="cuda")
        crow = A.indptr.to(torch.int32)
        lib_A = torch.sparse_csr_tensor(crow, A.indices, A.values,
                                        size=A.shape, check_invariants=False)
        xa2 = xa.unsqueeze(1)
        lib_err = float((torch.sparse.mm(lib_A, xa2)[:, 0]
                         - csr_spmv(A, xa)).abs().max())
        t_k = time_ms(lambda: csr_spmv(A, xa))
        t_kk = kernel_ms(lambda: csr_spmv(A, xa), "csr_spmv_kernel")
        t_p = time_ms(lambda: csr_spmv_plain(A, xa))
        t_l = time_ms(lambda: torch.sparse.mm(lib_A, xa2))
        n_bytes = ((A.n_rows + 1) * 8 + A.nnz * (4 + 8)
                   + A.n_cols * 8 + A.n_rows * 8)
        t_b, by = bound_ms(peaks, n_bytes, 2 * A.nnz, F64)
        ops.append({"op": label, "shape": list(A.shape), "nnz": A.nnz,
                    "group": A.group, "per_cycle": per_cycle, "ms": t_k,
                    "kernel_ms": t_kk, "plain_ms": t_p, "library_ms": t_l,
                    "library_max_abs_diff": lib_err, "bound_ms": t_b,
                    "bound_by": by, "share_of_bound": t_b / t_kk,
                    "share_of_bound_with_wrapper": t_b / t_k})
        del lib_A, crow
    reset_counts()

    def cycle_sum(key):
        return sum(o[key] * o["per_cycle"] for o in ops)

    k2 = {"ms": cycle_sum("ms"), "kernel_ms": cycle_sum("kernel_ms"),
          "plain_ms": cycle_sum("plain_ms"),
          "library_ms": cycle_sum("library_ms"),
          "library": "torch.sparse.mm on a sparse_csr tensor",
          "bound_ms": cycle_sum("bound_ms"),
          "share_of_bound": cycle_sum("bound_ms") / cycle_sum("kernel_ms"),
          "share_of_bound_with_wrapper": cycle_sum("bound_ms")
          / cycle_sum("ms"),
          "bound_by": ("bytes" if all(o["bound_by"] == "bytes" for o in ops)
                       else "operations"),
          "per_pcg_iter": per_iter["csr_spmv"],
          "note": "sums over the CSR launches of one V-cycle"}
    emit({"phase": "kernel_timing", "dtype": "float64",
          "stencil_matvec": k1, "stencil_matvec_rows": k1_rows,
          "csr_spmv": k2, "csr_spmv_ops": ops})
    return {"stencil_matvec": k1, "csr_spmv": k2}


def _kind(name: str) -> str:
    if "stencil_matvec_" in name:
        return "K1 stencil_matvec"
    if "csr_spmv_kernel" in name:
        return "K2 csr_spmv"
    if "csr_spmm_kernel" in name:
        return "K2-NV csr_spmm"
    if "dia_matvec_" in name:
        return "K3 dia_matvec"
    if "btake_kernel" in name:
        return "K4 btake"
    if "index" in name.lower() or "gather" in name.lower():
        return "gathers (wavefront solve)"
    if "gemv" in name or "gemm" in name or "getrs" in name \
            or "trsm" in name or "trsv" in name or "laswp" in name:
        return "dense (torch.mv, lu_solve, solve_triangular)"
    if "reduce" in name.lower() or "dot" in name.lower():
        return "reductions (dot, norm)"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy/memset"
    return "elementwise"


def phase_profile(path: str, run, unit: str) -> None:
    """`run()` under torch.profiler: device time by kernel and kind, and
    the device's busy share of the (profiled) wall time.  `run` returns a
    dict of facts about the work it did."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        facts = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    reset_counts()
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        if us > 0:
            rows.append({"kernel": evt.key[:90], "ms": us / 1e3,
                         "count": evt.count, "kind": _kind(evt.key)})
    rows.sort(key=lambda r: -r["ms"])
    by_kind = {}
    for r in rows:
        by_kind[r["kind"]] = by_kind.get(r["kind"], 0.0) + r["ms"]
    busy = sum(r["ms"] for r in rows)
    emit({"phase": "profile", "path": path, "unit": unit, **facts,
          "wall_ms": wall_ms,
          "device_busy_ms": busy,
          "device_busy_share": busy / wall_ms if wall_ms else None,
          "by_kind_ms": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
          "top": rows[:12]})


def profile_solve(amg, op) -> None:
    """One whole out.14 solve under the profiler."""
    b = torch.ones(op.n_rows, dtype=F64, device="cuda")
    phase_profile("out.14 host setup", lambda: {"iters": pcg(
        op, b, M=amg, tol=1e-8, max_iter=100).iters}, "one pcg solve")


def profile_iteration(amg, op, path: str) -> None:
    """One PCG iteration's V-cycle and A x under the profiler: the ij
    (a) solve's ~50k launches an iteration make a whole solve's trace
    cost minutes to gather."""
    r = torch.ones(op.n_rows, dtype=F64, device="cuda")

    def run():
        amg.precondition(r)
        matvec(op, r)
        return {}

    phase_profile(path, run, "one V-cycle and one A x")


def phase_small_input() -> None:
    n = 24
    out = {}
    for device in ("cuda", "cpu"):
        set_config(Config(real_dtype=F64, device=device))
        A = laplacian(n, n, n)
        amg = BoomerAMG(AmgConfig(interp_type=6, relax_type=18)).setup(
            A, fine_stencil=((n, n, n), LAPLACE_7PT))
        res = pcg(amg.hierarchy.levels[0].A, np.ones(n ** 3), M=amg,
                  tol=1e-8)
        out[device] = (res.iters, res.x.cpu())
    set_config(Config(real_dtype=F64, device="cuda"))
    (it_g, x_g), (it_c, x_c) = out["cuda"], out["cpu"]
    rel = float(torch.linalg.vector_norm(x_g - x_c)
                / torch.linalg.vector_norm(x_c))
    emit({"phase": "small_input", "grid": [n, n, n], "iters_cuda": it_g,
          "iters_cpu": it_c, "x_rel_diff": rel})
    if it_g != it_c or not rel <= 1e-10:
        raise AssertionError("card and CPU paths disagree at 24^3")


def phase_device_setup(host_setup_s: float) -> dict:
    """The device-resident setup at 256^3 and its solves."""
    set_config(Config(real_dtype=F64, device="cuda"))
    n = GRID
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg = AmgConfig(interp_type=6, relax_type=18, print_level=1)
    reset_counts()
    t0 = time.perf_counter()
    amg = BoomerAMG(cfg).setup_device(stencil=((n, n, n), LAPLACE_7PT))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_launches = read_counts()
    setup_peak = torch.cuda.max_memory_allocated() / 1e9
    op = amg.hierarchy.levels[0].A
    reset_counts()
    sol = timed_solves(op, amg, stencil_matvec_plain)
    solve_launches = read_counts()
    split = [{k: st[k] for k in (
        "level", "n", "w", "n_coarse", "strength_s", "pmis_s", "pmis_rounds",
        "interp_s", "rap_s", "pack_s", "w_p", "w_ap", "w_pt", "w_ac")
        if k in st} for st in amg.setup_stats]
    out = {
        "phase": "device_setup", "grid": [n, n, n], "dtype": "float64",
        "levels": amg.level_sizes, "level_nnz": amg.level_nnz,
        "operator_complexity": amg.operator_complexity,
        "level_formats": amg.level_formats, "setup_s": setup_s,
        "host_setup_s": host_setup_s, "per_level": split,
        "stage_totals_s": {k: sum(st.get(k, 0.0) for st in split) for k in (
            "strength_s", "pmis_s", "interp_s", "rap_s", "pack_s")},
        **sol, "peak_mem_gb": setup_peak,
        "peak_mem_gb_with_solves": torch.cuda.max_memory_allocated() / 1e9,
        "launches_setup": setup_launches, "launches_solves": solve_launches,
    }
    emit(out)
    if sol["true_relres"] > 1e-8 or max(sol["iters_all_solves"]) > 30:
        raise AssertionError(f"device path: true relres "
                             f"{sol['true_relres']:.3e} in "
                             f"{sol['iters_all_solves']} iterations")
    if setup_launches["btake_rows"] == 0:
        raise AssertionError("btake_rows was not launched in setup_device")
    for name in ("stencil_matvec", "csr_spmv"):
        if solve_launches[name] == 0:
            raise AssertionError(f"{name} was not launched in the device "
                                 f"path's solves")
    return {"amg": amg, "launches": setup_launches, "out": out}


def phase_device_setup_parity() -> None:
    """32^3: card vs the port's CPU path; 16^3: card vs the reference
    package's device hierarchy (REF_DEVICE_*)."""
    n = 32
    built = {}
    for device in ("cuda", "cpu"):
        set_config(Config(real_dtype=F64, device=device))
        built[device] = list(dev.iter_device_hierarchy(
            dev.dell_stencil((n, n, n), LAPLACE_7PT),
            AmgConfig(interp_type=6, relax_type=18)))
    set_config(Config(real_dtype=F64, device="cuda"))
    g_items, c_items = built["cuda"], built["cpu"]
    sizes_g = [it[0].n_rows for it in g_items[:-1]] + [g_items[-1].n_rows]
    sizes_c = [it[0].n_rows for it in c_items[:-1]] + [c_items[-1].n_rows]
    cf_equal = all(torch.equal(g[3].cpu(), c[3])
                   for g, c in zip(g_items[:-1], c_items[:-1]))

    def rel(a, b):
        d = abs(dev.dell_to_scipy(a) - dev.dell_to_scipy(b))
        return (d.max() if d.nnz else 0.0) / abs(dev.dell_to_scipy(b)).max()

    a_rel = max([rel(g[0], c[0]) for g, c in zip(g_items[:-1], c_items[:-1])]
                + [rel(g_items[-1], c_items[-1])])
    p_rel = max(rel(g[1], c[1]) for g, c in zip(g_items[:-1], c_items[:-1]))
    bitwise = all(torch.equal(x.cols.cpu(), y.cols)
                  and torch.equal(x.vals.cpu(), y.vals)
                  for g, c in zip(g_items[:-1], c_items[:-1])
                  for x, y in zip(g[:3], c[:3]))
    del built, g_items, c_items
    m = 16
    amg = BoomerAMG(AmgConfig(interp_type=6, relax_type=18)).setup_device(
        stencil=((m, m, m), LAPLACE_7PT))
    out = {"phase": "device_setup_parity", "grid_card_vs_cpu": [n, n, n],
           "levels_card": sizes_g, "levels_cpu": sizes_c,
           "cf_bitwise": cf_equal, "A_max_rel_diff": a_rel,
           "P_max_rel_diff": p_rel, "A_P_R_bitwise": bitwise,
           "grid_vs_reference": [m, m, m], "levels": amg.level_sizes,
           "level_nnz": amg.level_nnz,
           "operator_complexity": amg.operator_complexity,
           "reference_levels": REF_DEVICE_LEVELS,
           "reference_operator_complexity": REF_DEVICE_OPERATOR_COMPLEXITY}
    out.update(device_relax_parity())
    emit(out)
    if sizes_g != sizes_c or not cf_equal or a_rel > 1e-12 or p_rel > 1e-12:
        raise AssertionError("device setup: card and CPU disagree at 32^3")
    if amg.level_sizes != REF_DEVICE_LEVELS \
            or amg.level_nnz != REF_DEVICE_NNZ \
            or amg.operator_complexity != REF_DEVICE_OPERATOR_COMPLEXITY:
        raise AssertionError("device setup: 16^3 hierarchy differs from "
                             "hypre_tpu's")


def _nonzeros(op) -> int:
    return int(((op.values if isinstance(op, CsrMatrix) else op.vals) != 0)
               .sum())


def device_relax_parity() -> dict:
    """Relax 16 and 11 on the device setup at 16^3: the card's Chebyshev
    bounds and ds norms equal hypre_tpu's (REF_DEVICE_CHEBY_*) to 1e-12
    relative and L, U hold REF_DEVICE_TRI_NNZ nonzeros a level.  (The
    card against the port's CPU path, bit for bit at 32^3, is
    tests/test_torch_cuda.py::test_setup_device_relax_on_card_matches_cpu.)"""
    m = 16
    lv16 = BoomerAMG(AmgConfig(interp_type=6, relax_type=16)).setup_device(
        stencil=((m, m, m), LAPLACE_7PT)).hierarchy.levels[:-1]
    lv11 = BoomerAMG(AmgConfig(interp_type=6, relax_type=11)).setup_device(
        stencil=((m, m, m), LAPLACE_7PT)).hierarchy.levels[:-1]
    bounds = [list(lv.cheby_bounds) for lv in lv16]
    ds_norm = [float(torch.linalg.vector_norm(lv.cheby_ds)) for lv in lv16]
    ref_rel = max(abs(a - b) / abs(b) for got, want in (
        (sum(bounds, []), sum(REF_DEVICE_CHEBY_BOUNDS, [])),
        (ds_norm, REF_DEVICE_CHEBY_DS_NORM)) for a, b in zip(got, want))
    tri_nnz = [[_nonzeros(lv.L), _nonzeros(lv.U)] for lv in lv11]
    out = {"relax16_bounds": bounds, "relax16_ds_norm": ds_norm,
           "relax16_max_rel_diff_vs_reference": ref_rel,
           "relax11_L_U_nonzeros": tri_nnz}
    if len(bounds) != len(REF_DEVICE_CHEBY_BOUNDS) or not ref_rel <= 1e-12 \
            or tri_nnz != [[k, k] for k in REF_DEVICE_TRI_NNZ]:
        raise AssertionError(f"device relax 16/11: 16^3 differs from "
                             f"hypre_tpu's: {out}")
    return out


def btake_timing_case(idx, X, fill, label, peaks) -> dict:
    t_k = time_ms(lambda: btake_rows(idx, X, fill))
    t_kk = kernel_ms(lambda: btake_rows(idx, X, fill), "btake_kernel")
    t_p = time_ms(lambda: btake_rows_plain(idx, X, fill))
    flat = idx.clamp_min(0).flatten()
    t_l = time_ms(lambda: X.index_select(1, flat))
    # bytes the gather must move: idx and Y once each, and each source
    # entry that the index set names, once
    item = X.element_size()
    used = int(torch.unique(idx[idx >= 0]).numel())
    n_bytes = idx.numel() * 4 + X.shape[0] * idx.numel() * item \
        + X.shape[0] * used * item
    t_b, by = bound_ms(peaks, n_bytes, 0, F64)
    err = check_btake(idx, X, fill, label)["max_abs_err"]
    del flat
    return {"case": label, "S": idx.shape[0], "n": idx.shape[1],
            "K": X.shape[0], "n_src": X.shape[1], "n_src_named": used,
            "dtype": str(X.dtype), "ms": t_k, "kernel_ms": t_kk,
            "plain_ms": t_p, "library_ms": t_l, "bound_ms": t_b,
            "bound_by": by, "share_of_bound": t_b / t_kk,
            "share_of_bound_with_wrapper": t_b / t_k, "bytes": n_bytes,
            "max_abs_err": err}


def phase_btake_timing(peaks, setup_launches) -> dict:
    """K4 on the 256^3 device path's own index sets.  Level 0's stages
    are run once more to get A1 (= P0^T A0 P0, padded as the level loop
    pads it), P0^T and A0 P0."""
    set_config(Config(real_dtype=F64, device="cuda"))
    n = GRID
    A0 = dev.dell_stencil((n, n, n), LAPLACE_7PT)
    strong = dev.device_strength(A0)
    cf = dev.device_pmis(A0, strong)
    nc = int((cf == dev.C_PT).sum())
    P0 = dev.device_extpi_interp(A0, strong, cf, n_coarse=nc)
    del strong, cf
    AP = dev.device_spgemm(A0, P0)
    PT = dev.device_transpose(P0, dev.device_transpose_width(P0))
    del A0, P0
    # the chunk of P^T (A P) that the level loop's first window takes
    c0, c1 = dev._chunks(PT.n_rows, dev._spgemm_row_bytes(PT.width,
                                                          AP.width))[0]
    cases = []
    idx = PT.cols[:, c0:c1]
    cases.append(btake_timing_case(idx, AP.cols, -1,
                                   "level-0 P^T (A P) expansion, cols", peaks))
    cases.append(btake_timing_case(idx, AP.vals, 0,
                                   "level-0 P^T (A P) expansion, vals", peaks))
    A1 = dev.dell_pad_width(dev.device_spgemm(PT, AP))
    del PT, AP, idx
    n1 = A1.n_rows
    g = torch.Generator(device="cuda").manual_seed(5)
    m = torch.rand(n1, generator=g, device="cuda", dtype=F64)
    gid = torch.arange(n1, dtype=torch.int32, device="cuda")
    cases.append(btake_timing_case(A1.cols, m[None], 0,
                                   "level-1 PMIS read, f64 source", peaks))
    cases.append(btake_timing_case(A1.cols, gid[None], -1,
                                   "level-1 PMIS read, int32 source", peaks))
    def total(key):
        return sum(c[key] for c in cases)

    out = {"ms": total("ms"), "kernel_ms": total("kernel_ms"),
           "plain_ms": total("plain_ms"), "library_ms": total("library_ms"),
           "library": "Tensor.index_select(1, idx.clamp_min(0).flatten())",
           "bound_ms": total("bound_ms"),
           "share_of_bound": total("bound_ms") / total("kernel_ms"),
           "share_of_bound_with_wrapper": total("bound_ms") / total("ms"),
           "bound_by": ("bytes" if all(c["bound_by"] == "bytes"
                                       for c in cases) else "operations"),
           "max_abs_err": max(c["max_abs_err"] for c in cases),
           "launches_per_setup": setup_launches["btake_rows"],
           "note": "sums over the four timed gathers (cases)"}
    del A1, m, gid
    reset_counts()
    emit({"phase": "kernel_timing", "kernel": "btake_rows", "dtype": "mixed",
          "btake_rows": out, "cases": cases})
    return out


def phase_ij_driver() -> dict:
    """(a) -solver 1 and (b) -solver 2 at 100^3 through drivers.ij.run."""
    set_config(Config(real_dtype=F64, device="cuda"))
    runs = {}
    n = str(IJ_GRID)
    for tag, solver in (("a", 1), ("b", 2)):
        args = ij.build_parser().parse_args(["-n", n, n, n, "-solver",
                                             str(solver)])
        reset_counts()
        out = ij.run(args)
        torch.cuda.synchronize()
        launches = read_counts()
        times, iters = [], [out["iters"]]
        for t in range(3):
            bt = out["b"] * (1.0 + 0.0137 * (t + 1))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = pcg(out["op"], bt, M=out["M"], tol=1e-8, max_iter=1000)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            iters.append(res.iters)
        reset_counts()
        b, x = out["b"], out["x"]
        true_relres = float(torch.linalg.vector_norm(
            b - dia_matvec_plain(out["op"], x)) / torch.linalg.vector_norm(b))
        amg = out["amg"]
        row = {
            "phase": "ij_driver", "run": tag,
            "command": f"ij -n {IJ_GRID} {IJ_GRID} {IJ_GRID} -solver {solver}",
            "dtype": "float64", "rows": out["n"], "nnz": out["nnz"],
            "levels": amg.level_sizes if amg else [out["n"]],
            "operator_complexity": amg.operator_complexity if amg else 1.0,
            "level_formats": out["level_formats"], "iters": out["iters"],
            "iters_all_solves": iters, "reference_iters": REF_IJ_ITERS[solver],
            "relres": out["relres"], "true_relres": true_relres,
            "setup_s": out["setup_s"], "first_solve_s": out["solve_s"],
            "solve_s": statistics.median(times) if times else out["solve_s"],
           "solve_times_s": times,
            "per_iter_ms": statistics.median(times) / max(out["iters"], 1)
            * 1e3,
            "launches": launches,
            "launches_per_pcg_iter": launches_per_iter(
                amg.precondition if amg else out["M"], out["op"])}
        emit(row)
        if not bool(torch.isfinite(x).all()) or x.shape != (out["n"],):
            raise AssertionError(f"ij ({tag}): solution not finite or "
                                 f"misshapen")
        if out["level_formats"][0] != "DiaMatrix":
            raise AssertionError(f"ij ({tag}): level 0 is "
                                 f"{out['level_formats'][0]}, not DIA")
        if launches["dia_matvec"] == 0:
            raise AssertionError(f"ij ({tag}): dia_matvec was not launched")
        if true_relres > 1e-8:
            raise AssertionError(f"ij ({tag}): true relres {true_relres:.3e}")
        if amg is not None and (amg.level_sizes != REF_IJ_LEVELS or
                                out["level_formats"] != REF_IJ_FORMATS):
            raise AssertionError(f"ij ({tag}): hierarchy differs from the "
                                 f"reference's")
        if set(iters) != {REF_IJ_ITERS[solver]}:
            raise AssertionError(f"ij ({tag}): iterations {iters}, the "
                                 f"reference's {REF_IJ_ITERS[solver]}")
        runs[tag] = {"out": out, "row": row}
    return runs


def phase_golden_rows(name: str) -> None:
    """The rows of tests/golden/<name>.jobs on the card (no -exec_host)
    against <name>.saved by runtest's rule."""
    set_config(Config(real_dtype=F64, device="cuda"))
    jobs = runtest.read_jobs(GOLDEN / f"{name}.jobs")
    saved = runtest.read_golden(GOLDEN / f"{name}.saved")
    rows, failures = [], []
    for job, gold in zip(jobs, saved):
        if not runtest.ported(job):
            continue
        card_job = " ".join(w for w in job.split() if w != "-exec_host")
        reset_counts()
        t0 = time.perf_counter()
        result = runtest.run_job(card_job)
        wall = time.perf_counter() - t0
        fails = runtest.compare(card_job, result, gold)
        failures += fails
        rows.append({"job": card_job, "iters": result[0],
                     "relres": result[1], "golden_iters": gold[0],
                     "golden_relres": gold[1], "ok": not fails,
                     "wall_s": wall, "launches": read_counts()})
    reset_counts()
    emit({"phase": "golden_on_card", "jobs": f"{name}.jobs",
          "n_rows": len(rows), "n_failed": len(failures), "rows": rows})
    hold(bool(failures), f"{name} rows on the card: " + "; ".join(failures))


def breadth_run(label: str, grid, entries, cfg: AmgConfig,
                device_setup: bool, gen) -> dict:
    """One configuration through the port's entry points on the card:
    BoomerAMG(cfg).setup(A, fine_stencil=...) or .setup_device(stencil=
    ...), then timed_solves.  Launch counts are zeroed just before the
    setup and read after it, and zeroed before the solves and read after
    them.  Then K1 on the run's level-0 operator against its plain
    version (`k1_err`)."""
    set_config(Config(real_dtype=F64, device="cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    A = None
    if not device_setup:
        A = (laplacian_27pt if len(entries) == 27 else laplacian)(*grid)
    gen_s = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    amg = BoomerAMG(cfg)
    if device_setup:
        amg.setup_device(stencil=(grid, entries))
    else:
        amg.setup(A, fine_stencil=(grid, entries))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    launches_setup = read_counts()
    del A
    op = amg.hierarchy.levels[0].A
    reset_counts()
    sol = timed_solves(op, amg, stencil_matvec_plain)
    launches = read_counts()
    row = {"phase": "amg_breadth", "run": label, "grid": list(grid),
           "stencil_points": len(entries), "dtype": "float64",
           "setup": "setup_device" if device_setup else "setup (host)",
           "config": {k: v for k, v in dataclasses.asdict(cfg).items()
                      if v != getattr(AmgConfig(), k)},
           "levels": amg.level_sizes,
           "operator_complexity": amg.operator_complexity,
           "level_formats": amg.level_formats, "gen_s": gen_s,
           "setup_s": setup_s, **sol,
           "launches_setup": launches_setup, "launches_solves": launches,
           "launches_per_pcg_iter": launches_per_iter(amg.precondition, op),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if device_setup:
        row["per_level"] = amg.setup_stats
    x = torch.randn(op.n_rows, generator=gen, dtype=F64, device="cuda")
    row["k1_check"] = check_stencil(op, x)
    reset_counts()
    del x
    emit(row)
    if sol["true_relres"] > 1e-8:
        raise AssertionError(f"{label}: true relres {sol['true_relres']:.3e}")
    for name in ("stencil_matvec", "csr_spmv"):
        if launches[name] == 0:
            raise AssertionError(f"{label}: {name} was not launched in the "
                                 f"solves")
    return {"amg": amg, "op": op, "row": row,
            "k1_err": row["k1_check"]["max_abs_err"]}


@contextlib.contextmanager
def gathers_checked(checks: list):
    """While open, every gather that setup/device_amg.py makes (btake,
    btake_rows) is held against btake_rows_plain on the same index set
    and source, bit for bit; each appends its case to `checks`."""
    rows, one = dev.btake_rows, dev.btake

    def held(Y, idx, X, fill):
        torch.cuda.synchronize()
        Y_ref = btake_rows_plain(idx, X, fill)
        if not torch.equal(Y, Y_ref):
            raise AssertionError(f"btake_rows in setup_device, S, n = "
                                 f"{tuple(idx.shape)}, {X.dtype}: differs "
                                 f"from its plain version")
        checks.append({"S": idx.shape[0], "n": idx.shape[1],
                       "K": X.shape[0], "dtype": str(X.dtype),
                       "max_abs_err": float((Y.double() - Y_ref.double())
                                            .abs().max()) if Y.numel()
                       else 0.0})

    def btake_rows_held(idx, X, fill=0):
        Y = rows(idx, X, fill)
        held(Y, idx, X, fill)
        return Y

    def btake_held(idx, x, fill=0):
        y = one(idx, x, fill)
        held(y[None], idx, x[None, :], fill)
        return y

    dev.btake_rows, dev.btake = btake_rows_held, btake_held
    try:
        yield checks
    finally:
        dev.btake_rows, dev.btake = rows, one


def phase_amg_breadth(gen) -> dict:
    """out.22 at its published size through the host setup (a) and the
    device setup (b), each with one solve profiled; relax 11 through the
    device setup at 64^3; the L, U and A^T of relax 11 and 30 host
    hierarchies at 64^3; out.17's configuration at 128x128x64.  Every
    run's level-0 operator on K1 and its hierarchy's operators (with
    relax 11's L and U) on K2 and K3, each against its plain version;
    (b)'s setup once more with each of its gathers held against K4's
    plain version.  Returns the rows and the largest f64 error by
    kernel."""
    errs = {}

    def fold(e):
        for k, v in e.items():
            errs[k] = max(v, errs.get(k, 0.0))

    cheby = dict(relax_type=16, interp_type=6, print_level=1)
    a = breadth_run("out.22 (a) host setup", OUT22_GRID, LAPLACE_7PT,
                    AmgConfig(**cheby), False, gen)
    iters = a["row"]["iters_all_solves"]
    if set(iters) != {REF_OUT22_ITERS}:
        raise AssertionError(f"out.22 (a): iterations {iters}, the "
                             f"reference's {REF_OUT22_ITERS}")
    b_ones = torch.ones(a["op"].n_rows, dtype=F64, device="cuda")
    phase_profile("out.22 (a) host setup", lambda: {"iters": pcg(
        a["op"], b_ones, M=a["amg"], tol=1e-8, max_iter=100).iters},
        "one pcg solve")
    fold({"stencil_matvec": a["k1_err"]})
    fold(phase_hierarchy_checks(a["amg"], gen, "out.22 (a) host setup"))
    del a["amg"], a["op"], b_ones
    torch.cuda.empty_cache()
    b = breadth_run("out.22 (b) device setup", OUT22_GRID, LAPLACE_7PT,
                    AmgConfig(**cheby), True, gen)
    if max(b["row"]["iters_all_solves"]) > 30:
        raise AssertionError(f"out.22 (b): iterations "
                             f"{b['row']['iters_all_solves']} > 30")
    if b["row"]["launches_setup"]["btake_rows"] == 0:
        raise AssertionError("out.22 (b): btake_rows was not launched")
    b_ones = torch.ones(b["op"].n_rows, dtype=F64, device="cuda")
    phase_profile("out.22 (b) device setup", lambda: {"iters": pcg(
        b["op"], b_ones, M=b["amg"], tol=1e-8, max_iter=100).iters},
        "one pcg solve")
    fold({"stencil_matvec": b["k1_err"]})
    fold(phase_hierarchy_checks(b["amg"], gen, "out.22 (b) device setup"))
    sizes = b["amg"].level_sizes
    del b["amg"], b["op"], b_ones
    torch.cuda.empty_cache()
    # (b)'s setup again, its gathers held against K4's plain version; the
    # same hierarchy must come out
    with gathers_checked([]) as gathers:
        again = BoomerAMG(AmgConfig(**cheby)).setup_device(
            stencil=(OUT22_GRID, LAPLACE_7PT))
    reset_counts()
    emit({"phase": "kernel_checks", "set": "setup gathers",
          "path": "out.22 (b) device setup", "kernel_names": ["btake_rows"],
          "n_checks": len(gathers),
          "dtypes": sorted({g["dtype"] for g in gathers}),
          "largest_S_n": max((g["S"] * g["n"], g["S"], g["n"])
                             for g in gathers)[1:],
          "max_abs_err": max(g["max_abs_err"] for g in gathers)})
    if again.level_sizes != sizes or not gathers:
        raise AssertionError(f"out.22 (b) with its gathers checked: levels "
                             f"{again.level_sizes}, {len(gathers)} gathers")
    fold({"btake_rows": max(g["max_abs_err"] for g in gathers)})
    del again, gathers
    torch.cuda.empty_cache()
    # two-stage GS end to end: the device setup's L and U on K2
    m = 64
    gs = breadth_run(f"relax 11 at {m}^3 device setup", (m, m, m),
                     LAPLACE_7PT, AmgConfig(interp_type=6, relax_type=11),
                     True, gen)
    if max(gs["row"]["iters_all_solves"]) > 30:
        raise AssertionError(f"relax 11: iterations "
                             f"{gs['row']['iters_all_solves']} > 30")
    fold({"stencil_matvec": gs["k1_err"]})
    fold(phase_hierarchy_checks(gs["amg"], gen, f"{m}^3 relax 11 device "
                                f"setup", ("A", "P", "R", "L", "U")))
    del gs
    # the smoothers' own operators, from host hierarchies at 64^3: L, U
    # (relax 11; the first row of L and the last of U are empty) and A^T
    # (relax 30)
    for rt, names in ((11, ("A", "P", "R", "L", "U")), (30, ("AT",))):
        h = BoomerAMG(AmgConfig(interp_type=6, relax_type=rt)).setup(
            laplacian(m, m, m))
        fold(phase_hierarchy_checks(h, gen, f"{m}^3 relax {rt}", names))
        del h
    c = breadth_run("out.17 configuration at 128x128x64", OUT17_GRID,
                    LAPLACE_27PT, AmgConfig(
                        relax_type=7, relax_weight=0.85, agg_num_levels=1,
                        agg_interp_type=5, interp_type=6, print_level=1),
                    False, gen)
    if c["row"]["levels"] != REF_OUT17_LEVELS \
            or set(c["row"]["iters_all_solves"]) != {REF_OUT17_ITERS}:
        raise AssertionError(f"out.17-128: levels {c['row']['levels']}, "
                             f"iterations {c['row']['iters_all_solves']}; "
                             f"the reference's {REF_OUT17_LEVELS}, "
                             f"{REF_OUT17_ITERS}")
    fold({"stencil_matvec": c["k1_err"]})
    fold(phase_hierarchy_checks(c["amg"], gen, "out.17 configuration at "
                                "128x128x64"))
    del c["amg"], c["op"]
    torch.cuda.empty_cache()
    return {"a": a["row"], "b": b["row"], "c": c["row"], "errs": errs}


def dia_library(D: DiaMatrix):
    """D's nonzeros as a sparse CSR tensor (int32 indices) on the card,
    for torch.sparse.mm."""
    ar = torch.arange(D.n_rows, device=D.vals.device)
    rows, cols, vals = [], [], []
    for k, off in enumerate(D.offsets):
        j = ar + off
        keep = (j >= 0) & (j < D.n_cols) & (D.vals[k] != 0)
        rows.append(ar[keep])
        cols.append(j[keep])
        vals.append(D.vals[k][keep])
    coo = torch.sparse_coo_tensor(
        torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
        size=D.shape, check_invariants=False).coalesce()
    csr = coo.to_sparse_csr()
    return torch.sparse_csr_tensor(
        csr.crow_indices().to(torch.int32), csr.col_indices().to(torch.int32),
        csr.values(), size=D.shape, check_invariants=False)


def dia_timing_row(D: DiaMatrix, peaks, gen, label: str) -> dict:
    x = torch.randn(D.n_cols, generator=gen, dtype=D.dtype, device="cuda")
    err = check_dia(D, x, label)["max_abs_err"]
    lib_A = dia_library(D)
    x2 = x.unsqueeze(1)
    lib_diff = float((torch.sparse.mm(lib_A, x2)[:, 0]
                      - dia_matvec(D, x)).abs().max())
    t_k = time_ms(lambda: dia_matvec(D, x))
    t_kk = kernel_ms(lambda: dia_matvec(D, x), "dia_matvec_")
    t_p = time_ms(lambda: dia_matvec_plain(D, x))
    t_l = time_ms(lambda: torch.sparse.mm(lib_A, x2))
    item = D.vals.element_size()
    n_bytes = (len(D.offsets) * D.n_rows * item + D.n_cols * item
               + D.n_rows * item + len(D.offsets) * 8)
    t_b, by = bound_ms(peaks, n_bytes, 2 * len(D.offsets) * D.n_rows,
                       D.dtype)
    return {"op": label, "shape": list(D.shape), "n_diags": len(D.offsets),
            "dtype": str(D.dtype), "instance": D.launch_args.instance,
            "ms": t_k, "kernel_ms": t_kk, "plain_ms": t_p, "library_ms": t_l,
            "library": "torch.sparse.mm on a sparse_csr tensor",
            "library_max_abs_diff": lib_diff, "bound_ms": t_b,
            "bound_by": by, "share_of_bound": t_b / t_kk,
            "share_of_bound_with_wrapper": t_b / t_k, "bytes": n_bytes,
            "max_abs_err": err}


def phase_dia_timing(amg, peaks, gen, per_iter) -> dict:
    """K3 on levels 0 and 1 of the ij (a) run (100^3 and its first
    coarse level, both DIA), f64 and f32; the wrapper's host cost a
    call on a 16^3 operator, whose kernel takes a few µs."""
    rows = []
    for lvl in (0, 1):
        op = amg.hierarchy.levels[lvl].A
        for dtype in (F64, torch.float32):
            D = op if dtype == op.dtype else dataclasses.replace(
                op, vals=op.vals.to(dtype))
            rows.append(dia_timing_row(D, peaks, gen, f"A{lvl}"))
            del D
    small = dia_from_scipy(laplacian(16, 16, 16), F64, torch.device("cuda"))
    xs = torch.randn(small.n_cols, generator=gen, dtype=F64, device="cuda")
    wrap = wrapper_us(lambda: dia_matvec(small, xs))
    reset_counts()
    out = dict(rows[0])
    out["per_pcg_iter"] = per_iter
    out["wrapper_us"] = wrap
    emit({"phase": "kernel_timing", "kernel": "dia_matvec",
          "wrapper_us": wrap, "dia_matvec": rows})
    return out


def plain_matvec(op, x):
    """A x by the plain version of op's kernel (true residuals)."""
    if isinstance(op, DiaMatrix):
        return dia_matvec_plain(op, x)
    if isinstance(op, CsrMatrix):
        return csr_spmv_plain(op, x)
    if isinstance(op, DenseMatrix):
        return op.vals @ x
    return stencil_matvec_plain(op, x)


def check_spmm(A: CsrMatrix, X, label: str) -> dict:
    """K2-NV against its plain version (K2's plain version a column),
    one launch a column panel, and each column of Y bit for bit K2's on
    that column of X."""
    from hypre_tpu_torch.ops.spmv import nv_panels

    before = csr_spmm.launches
    Y = csr_spmm(A, X)
    torch.cuda.synchronize()
    panels = len(nv_panels(X.shape[1], X.element_size()))
    if csr_spmm.launches - before != panels:
        raise AssertionError(f"csr_spmm {label} nv={X.shape[1]}: "
                             f"{csr_spmm.launches - before} launches for "
                             f"{panels} panels")
    Y_ref = csr_spmm_plain(A, X)
    scale = csr_spmm_plain(dataclasses.replace(A, values=A.values.abs()),
                           X.abs())
    err, rel = rel_err(Y, Y_ref, scale)
    if not (rel <= TOL[A.dtype] and bool(torch.isfinite(Y).all())):
        raise AssertionError(f"csr_spmm {label} nv={X.shape[1]} {A.dtype}: "
                             f"rel err {rel:.3e} > {TOL[A.dtype]:g}")
    for k in range(X.shape[1]):
        if not torch.equal(Y[:, k], csr_spmv(A, X[:, k].contiguous())):
            raise AssertionError(f"csr_spmm {label} nv={X.shape[1]} "
                                 f"{A.dtype}: column {k} is not K2's "
                                 f"result bit for bit")
    return {"op": label, "shape": list(A.shape), "nnz": A.nnz,
            "group": A.group, "nv": X.shape[1], "dtype": str(A.dtype),
            "ldx": X.stride(0), "max_abs_err": err, "rel_err": rel}


def random_csr_long_rows(rng):
    """random_csr's 100,003 x 90,001 operator (rows of 0 to 70 nonzeros,
    empty ones among them) with three rows of ~4,500 nonzeros put in."""
    import scipy.sparse as sp

    A = random_csr(100_003, 90_001, 70, 600, rng)
    long = sp.random(3, 90_001, density=0.05, random_state=rng,
                     format="csr")
    return sp.vstack([A[:50_000], long, A[50_000:]]).tocsr()


def phase_spmm_checks(ops, gen) -> float:
    """K2-NV against its plain version at every width NV_CHECK, f64 and
    f32, on each (label, CsrMatrix) of `ops`, and on X = W[:, 1:1 + nv]
    of a block W of 40 columns on the last of them (rows that start one
    value past a 16-byte boundary: scalar loads and stores); returns
    the largest f64 error."""
    results = []
    for i, (label, A) in enumerate(ops):
        for dtype in (F64, torch.float32):
            Ad = A if dtype == A.dtype else A.to(dtype)
            for nv in NV_CHECK:
                X = torch.randn((A.n_cols, nv), generator=gen, dtype=dtype,
                                device="cuda")
                results.append(check_spmm(Ad, X, label))
                if i == len(ops) - 1:
                    W = torch.randn((A.n_cols, 40), generator=gen,
                                    dtype=dtype, device="cuda")
                    results.append(check_spmm(Ad, W[:, 1:1 + nv],
                                              label + ", column slice"))
                    del W
                del X
            del Ad
    torch.cuda.synchronize()
    reset_counts()
    emit({"phase": "kernel_checks", "set": "csr_spmm", "kernel_names":
          ["csr_spmm"], "n_checks": len(results),
          "worst_rel_err": max(r["rel_err"] for r in results),
          "checks": results})
    return max(r["max_abs_err"] for r in results
               if r["dtype"] == str(F64))


def spmm_timing(A64: CsrMatrix, peaks, gen) -> dict:
    """K2-NV on (b)'s fine A at LOBPCG's block widths (4, 8, 12) and one
    launch's widest block in f64 (16), f64 and f32: both times, its
    plain version, nv K2 launches (one a column), torch.sparse.mm and
    the bound (A's values, indices and indptr once, X once, Y once).
    Returns the f64 row at nv = 12, LOBPCG's width."""
    rows = []
    for A, nv in [(A, nv) for A in (A64, A64.to(torch.float32))
                  for nv in (4, 8, 12, 16)]:
        lib_A = torch.sparse_csr_tensor(
            A.indptr.to(torch.int32), A.indices, A.values, size=A.shape,
            check_invariants=False)
        X = torch.randn((A.n_cols, nv), generator=gen, dtype=A.dtype,
                        device="cuda")
        cols = [X[:, k].contiguous() for k in range(nv)]
        lib_diff = float((torch.sparse.mm(lib_A, X)
                          - csr_spmm(A, X)).abs().max())
        item = X.element_size()
        n_bytes = ((A.n_rows + 1) * 8 + A.nnz * (4 + item)
                   + (A.n_cols + A.n_rows) * nv * item)
        t_b, by = bound_ms(peaks, n_bytes, 2 * A.nnz * nv, A.dtype)
        t_k = time_ms(lambda: csr_spmm(A, X))
        t_kk = kernel_ms(lambda: csr_spmm(A, X), "csr_spmm_kernel")
        rows.append({
            "op": "A (LOBPCG at 128^3)", "shape": list(A.shape),
            "nnz": A.nnz, "group": A.group, "nv": nv,
            "dtype": str(A.dtype), "ms": t_k,
            "kernel_ms": t_kk,
            "plain_ms": time_ms(lambda: csr_spmm_plain(A, X)),
            "k2_per_column_ms": time_ms(
                lambda: [csr_spmv(A, c) for c in cols]),
            "library_ms": time_ms(lambda: torch.sparse.mm(lib_A, X)),
            "library": "torch.sparse.mm on a sparse_csr tensor",
            "library_max_abs_diff": lib_diff, "bound_ms": t_b,
            "bound_by": by, "bytes": n_bytes, "share_of_bound": t_b / t_kk,
            "share_of_bound_with_wrapper": t_b / t_k})
        del X, cols, lib_A
    reset_counts()
    emit({"phase": "kernel_timing", "kernel": "csr_spmm", "csr_spmm": rows})
    return next(r for r in rows if r["nv"] == 12 and r["dtype"] == str(F64))


def ij_args(*flags):
    return ij.build_parser().parse_args([str(f) for f in flags])


def ij_solver_runs(amg, amg_setup_s: float) -> list:
    """(a): every solver id of REF_IJ_SOLVER_ITERS at 100^3 (-solver 5
    at CGNR_GRID, PRECOND_CUT at PRECOND_GRID) through drivers.ij.run,
    the AMG ids at 100^3 on one shared setup."""
    rows = []
    for solver in sorted(REF_IJ_SOLVER_ITERS):
        n = (CGNR_GRID if solver == 5 else PRECOND_GRID
             if solver in PRECOND_CUT else IJ_GRID)
        shared = solver in ij.NEED_AMG and n == IJ_GRID
        reset_counts()
        out = ij.run(ij_args("-n", n, n, n, "-solver", solver),
                     amg=amg if shared else None)
        torch.cuda.synchronize()
        launches = read_counts()
        reset_counts()
        b, x = out["b"], out["x"]
        true_relres = float(torch.linalg.vector_norm(
            b - plain_matvec(out["op"], x)) / torch.linalg.vector_norm(b))
        ref_it, ref_res = (REF_IJ_SOLVER_ITERS[solver],
                           REF_IJ_SOLVER_RELRES[solver])
        row = {"phase": "ij_solvers", "run": "a", "command":
               f"ij -n {n} {n} {n} -solver {solver}",
               "solver": ij.SOLVER_NAMES.get(solver, "Schwarz-PCG"),
               "dtype": "float64", "rows": out["n"],
               "iters": out["iters"], "reference_iters": ref_it,
               "relres": out["relres"], "reference_relres": ref_res,
               "true_relres": true_relres,
               "setup_s": amg_setup_s if shared else out["setup_s"],
               "amg_setup_shared": shared,
               "precond_setup_s": out.get("precond_setup_s"),
               "solve_s": out["solve_s"],
               "per_iter_ms": out["solve_s"] / max(out["iters"], 1) * 1e3,
               "level_formats": out["level_formats"], "launches": launches}
        if solver == 20:
            row.update(dscg_iters=out["dscg_iters"],
                       pcg_iters=out["pcg_iters"])
        emit(row)
        rows.append(row)
        if not bool(torch.isfinite(x).all()) or x.shape != (out["n"],):
            raise AssertionError(f"ij -solver {solver}: x not finite or "
                                 f"misshapen")
        if abs(out["iters"] - ref_it) > REF_IJ_SOLVER_SLACK.get(solver, 0):
            raise AssertionError(f"ij -solver {solver}: {out['iters']} "
                                 f"iterations, the reference's {ref_it}")
        if ref_res > 1e-8:
            # unconverged at -max_iter in the reference too: the same
            # residual, by runtest's rule
            if abs(out["relres"] - ref_res) > 1e-3 * ref_res:
                raise AssertionError(f"ij -solver {solver}: relres "
                                     f"{out['relres']:e}, the reference's "
                                     f"{ref_res:e}")
        elif out["relres"] > 1e-8 or true_relres > 1e-7:
            raise AssertionError(f"ij -solver {solver}: relres "
                                 f"{out['relres']:e}, true {true_relres:e}")
        if launches["dia_matvec"] == 0:
            raise AssertionError(f"ij -solver {solver}: dia_matvec was not "
                                 f"launched")
        if (shared or solver in (8, 18, 43)) and launches["csr_spmv"] == 0:
            raise AssertionError(f"ij -solver {solver}: csr_spmv was not "
                                 f"launched")
        del out, b, x
    return rows


def lobpcg_run() -> dict:
    """(b): ij -lobpcg -solver 1 at 128^3, A CSR (past the DIA limit), so
    the block products run K2-NV."""
    n = LOBPCG_GRID
    reset_counts()
    out = ij.run(ij_args("-n", n, n, n, "-lobpcg", "-solver", 1))
    torch.cuda.synchronize()
    launches = read_counts()
    reset_counts()
    lam = np.asarray(out["eigenvalues"], dtype=np.float64)
    # the unscaled Dirichlet 7-pt Laplacian: sum over the axes of
    # 2 (1 - cos(k pi / (n + 1)))
    mode = [2 * (1 - np.cos(k * np.pi / (n + 1))) for k in (1, 2)]
    exact = np.array([3 * mode[0]] + [mode[1] + 2 * mode[0]] * 3)
    rel = np.abs(lam - exact) / exact
    row = {"phase": "ij_solvers", "run": "b", "command":
           f"ij -n {n} {n} {n} -lobpcg -solver 1", "dtype": "float64",
           "rows": out["n"], "op": type(out["op"]).__name__,
           "levels": out["amg"].level_sizes, "iters": out["iters"],
           "reference_iters": REF_LOBPCG_ITERS,
           "eigenvalues": lam.tolist(), "analytic": exact.tolist(),
           "eigenvalue_rel_err": rel.tolist(),
           "resnorms": np.asarray(out["resnorms"]).tolist(),
           "setup_s": out["setup_s"], "solve_s": out["solve_s"],
           "launches": launches}
    emit(row)
    if not isinstance(out["op"], CsrMatrix):
        raise AssertionError("LOBPCG at 128^3: A is not CSR")
    if not 0 < launches["csr_spmm"] <= out["iters"] + 1:
        raise AssertionError(f"LOBPCG at 128^3: csr_spmm launched "
                             f"{launches['csr_spmm']} times in "
                             f"{out['iters']} iterations (one an "
                             f"iteration and one more at most)")
    if out["iters"] != REF_LOBPCG_ITERS:
        raise AssertionError(f"LOBPCG: {out['iters']} iterations, the "
                             f"reference's {REF_LOBPCG_ITERS}")
    if rel.max() > 1e-6 or not np.all(np.isfinite(out["resnorms"])) \
            or max(out["resnorms"]) >= 1e-6:
        raise AssertionError(f"LOBPCG: eigenvalues {lam} against "
                             f"{exact}, resnorms {out['resnorms']}")
    return {"out": out, "row": row}


def mgr_runs() -> list:
    """(c): MGR-GMRES (MGR(MgrConfig(amg=MGR_AMG)).setup(A, c_mask), gmres
    tol 1e-8) on the two-field system at n = 256 and 1024."""
    from hypre_tpu_torch.ops.formats import sparse_op_from_scipy
    from hypre_tpu_torch.solvers import MGR, MgrConfig, gmres

    rows = []
    for n in (MGR_SMALL_N, MGR_N):
        A, c_mask = mgr_coupled_system(n)
        b = torch.ones(A.shape[0], dtype=F64, device="cuda")
        reset_counts()
        t0 = time.perf_counter()
        op = sparse_op_from_scipy(A)
        mgr = MGR(MgrConfig(amg=MGR_AMG)).setup(A, c_mask)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = gmres(op, b, M=mgr.precondition, tol=1e-8, max_iter=200)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        launches = read_counts()
        reset_counts()
        true_relres = float(torch.linalg.vector_norm(
            b - plain_matvec(op, res.x)) / torch.linalg.vector_norm(b))
        row = {"phase": "ij_solvers", "run": "c",
               "problem": f"tests/test_mgr.py coupled_system({n})",
               "dtype": "float64", "rows": A.shape[0], "nnz": A.nnz,
               "op": type(op).__name__, "mgr_levels": mgr.level_sizes,
               "amg_levels": mgr.amg_h.level_sizes, "iters": res.iters,
               "relres": res.relres, "true_relres": true_relres,
               "setup_s": setup_s, "solve_s": solve_s, "launches": launches}
        if n == MGR_SMALL_N:
            row.update(port_cpu_iters=PORT_MGR_SMALL_ITERS,
                       reference_iters=REF_MGR_SMALL_ITERS)
        emit(row)
        rows.append(row)
        if true_relres > 1e-8 or res.relres > 1e-8:
            raise AssertionError(f"MGR-GMRES n={n}: true relres "
                                 f"{true_relres:.3e}")
        if n == MGR_SMALL_N and not (res.iters == PORT_MGR_SMALL_ITERS
                                     == REF_MGR_SMALL_ITERS):
            raise AssertionError(f"MGR-GMRES n={n}: {res.iters} iterations, "
                                 f"the CPU's {PORT_MGR_SMALL_ITERS}, the "
                                 f"reference's {REF_MGR_SMALL_ITERS}")
        del A, op, mgr, res, b
    return rows


def io_round_trip() -> dict:
    """(d): -printsystem at 24^3 in a temporary directory, then
    -fromfile/-rhsfromfile of what it wrote: the same iterations."""
    import os
    import tempfile

    n = IO_GRID
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            gen_run = ij.run(ij_args("-n", n, n, n, "-solver", 1, "-rhsrand",
                                     "-printsystem"))
            sizes = {f: os.path.getsize(f) for f in ("IJ.out.A", "IJ.out.b")}
            back = ij.run(ij_args("-fromfile", "IJ.out.A", "-rhsfromfile",
                                  "IJ.out.b", "-solver", 1))
        finally:
            os.chdir(cwd)
    row = {"phase": "ij_solvers", "run": "d", "grid": [n, n, n],
           "file_bytes": sizes, "iters_generated": gen_run["iters"],
           "iters_read_back": back["iters"], "relres_generated":
           gen_run["relres"], "relres_read_back": back["relres"],
           "rows_read_back": back["n"], "nnz_read_back": back["nnz"]}
    emit(row)
    if back["iters"] != gen_run["iters"] or back["n"] != n ** 3 \
            or back["relres"] > 1e-8:
        raise AssertionError("ij I/O round trip: the read-back solve "
                             "differs from the generated one")
    return row


def profile_lobpcg_step(out) -> None:
    """One LOBPCG step's work of (b) under the profiler: the block
    product of a 12-wide S (K2-NV) and the preconditioner on 4
    columns."""
    op, amg = out["op"], out["amg"]
    S = torch.ones((op.n_cols, 12), dtype=F64, device="cuda")
    r = torch.ones(op.n_rows, dtype=F64, device="cuda")

    def run():
        matmat(op, S)
        for _ in range(4):
            amg.precondition(r)
        return {}

    phase_profile("ij -lobpcg -solver 1 at 128^3", run,
                  "one A S (nv = 12) and four V-cycles")


def phase_ij_solvers(gen, peaks) -> dict:
    """The ij driver's remaining solvers on the card: (a) every solver id
    at 100^3, (b) LOBPCG at 128^3 on K2-NV, (c) MGR-GMRES at ~2M rows,
    (d) the -printsystem/-fromfile/-rhsfromfile round trip; then K2-NV
    against its plain version on (b)'s A, the coarse operators of the
    100^3 hierarchy and a random CSR with empty and long rows, and its
    timing at (b)'s shape."""
    set_config(Config(real_dtype=F64, device="cuda"))
    n = IJ_GRID
    base = ij_args("-n", n, n, n)
    A, _ = ij.build_problem(base)
    t0 = time.perf_counter()
    amg = BoomerAMG(ij.amg_config(base)).setup(A)
    torch.cuda.synchronize()
    amg_setup_s = time.perf_counter() - t0
    del A
    a_rows = ij_solver_runs(amg, amg_setup_s)
    lob = lobpcg_run()
    profile_lobpcg_step(lob["out"])
    fine = lob["out"]["op"]
    spmm_err = phase_spmm_checks(
        [("A (LOBPCG at 128^3)", fine)] + hierarchy_ops(amg)
        + [("random, empty and long rows", csr_from_scipy(
            random_csr_long_rows(np.random.default_rng(9)), F64,
            torch.device("cuda")))], gen)
    timing = spmm_timing(fine, peaks, gen)
    del amg, lob["out"], fine
    torch.cuda.empty_cache()
    c_rows = mgr_runs()
    d_row = io_round_trip()
    return {"a": a_rows, "b": lob["row"], "c": c_rows, "d": d_row,
            "spmm_err": spmm_err, "spmm_timing": timing}



# ---------------------------------------------------------------------------
# struct: hypre's struct driver rows and the struct solvers
# ---------------------------------------------------------------------------

# hypre's published struct rows (BASELINE.md:50-55; 4 GPUs a run, f64,
# the driver's tol 1e-6): setup and solve seconds, iterations
STRUCT_ROWS = {
    "a": ("out.7", "-n 256 256 256 -solver 11",
          {"v100_setup_solve_s": [0.051, 0.409],
           "mi250x_setup_solve_s": [0.054, 0.333], "iters": 10}),
    "b": ("out.5", "-n 2048 2048 1 -solver 11",
          {"v100_setup_solve_s": [0.0123, 0.138],
           "mi250x_setup_solve_s": [0.0120, 0.0956], "iters": None}),
    "c": ("out.1", "-n 2048 2048 1 -solver 10",
          {"v100_setup_solve_s": [0.121, 0.577],
           "mi250x_setup_solve_s": [0.092, 0.421], "iters": 6}),
    "d": ("out.3", "-n 128 128 128 -solver 10",
          {"v100_setup_solve_s": [1.198, 6.012],
           "mi250x_setup_solve_s": [0.862, 4.294], "iters": 5}),
    "f": ("PFMG RB-GS", "-n 256 256 256 -solver 1 -relax 2", {}),
}
# hypre_tpu's iterations at the same sizes, f64 on the CPU
# (python tools/struct_reference_counts.py out7 | out5 | out1 | rbgs).
# out.7's 52 against hypre's 10: the reference's PFMG coarsens x alone
# from 128^3 down to 2 (its _pick_cdir, level shapes in PERF.md §4);
# (f) stops at -max_iter 100 unconverged in the reference too and is
# held to its residual (rtol 1e-3, runtest's rule)
REF_STRUCT_ITERS = {"a": 52, "b": 10, "c": 7, "f": 100}
REF_STRUCT_RELRES = {"f": 0.01310655}
# out.3 at 128^3 needs two 32768^2 dense inverses on the host a 3-D level
# in the reference, which it cannot build on the CPU: its count is held
# at the largest size it finishes (tools/struct_reference_counts.py out3
# N: 5 iterations at 32^3 after 10.5 min; 64^3 had not finished after
# ~25 CPU-minutes), where the card's count must equal it; at 128^3 the
# card's count is printed beside hypre's published 5
OUT3_HELD = (32, 5)           # (N, iterations)
# (g): each at >= 10^6 unknowns (the host setups finish in seconds);
# SparseMSG's compile in the reference (343 lattice grids at 100^3) is
# out of reach on a CPU, so its count is held at MSG_HELD's size
MSG_GRID = 100
MSG_HELD = (32, 32)           # (N, iterations)
SYS_GRID = 80                 # 2 variables: 1,024,000 unknowns
FAC_GRID = 768                # composite 1,032,192 unknowns
FAC_CYCLES = 20
SPLIT_GRID = 708              # two 708^2 parts: 1,002,528 unknowns
# (iterations, relres) of tools/struct_reference_counts.py sys 80,
# fac 768 (FAC diverges at this size in the reference too), split 708
REF_G = {"sys": (15, 6.965598147451131e-07), "fac": (20, 2.89541678084891),
         "split": (110, 7.529976720714282e-07)}
STRUCT_TOL = 1e-6
# the maxwell phase (ex15 and its kin): sizes, and the reference's counts
# from tools/ams_reference_counts.py as (n, count) at the largest n it
# finishes on a CPU; a row run at a larger n is held to count + 2
AMS_GRID = 100                # ex15: 3,060,300 edges, not cut
ADS_GRID = 18                 # a cut: B_Pi is one dense level (PERF.md)
MAXWELL_GRID = 100
AME_GRID = 3                  # a cut of scale: AME's count is robust only
#                               while its residual floor sits well below
#                               the tolerance (PERF.md)
CAPI_GRID = 48                # a cut for the time limit (PERF.md)
CKPT_GRID = 128
IR_GRID = 128
REF_AMS = (40, 18)
REF_ADS = (18, 12)
REF_MAXWELL = (40, 19)
REF_AME = {"iters": 20, "eigenvalues": [2.17157287525381, 2.17157287525381,
                                        2.171572875254781]}
REF_CAPI = (48, 8)
REF_CKPT = 19
REF_IR = {"outer_iters": 2, "inner_iters_total": 26}
REF_EXAMPLES = {"ex5": 11, "ex11": 20, "ex_struct": 7, "ex3_pfmg": 20,
                "ex15_ams": 16, "ex9_systems": [13, 13], "ex6_multibox": 28,
                "ex_capi": 5}


L5 = [((0, 0, 0), 4.0), ((0, 0, -1), -1.0), ((0, 0, 1), -1.0),
      ((0, -1, 0), -1.0), ((0, 1, 0), -1.0)]


def hold(failed: bool, msg: str) -> None:
    """A check of the struct phase: raises when it failed."""
    if failed:
        raise AssertionError(msg)


def sys_coupled_system(n: int, c: float = 0.15) -> dict:
    """tests/test_sys_pfmg.py's two-variable system at n^3 (B = c (I +
    east shift)) with the identity added to each Laplacian block, which
    keeps it SPD at this size (tools/struct_reference_counts.py sys)."""
    L = struct_matrix_from_stencil((n, n, n), [
        ((0, 0, -1), -1.0), ((0, 0, 1), -1.0), ((0, -1, 0), -1.0),
        ((0, 1, 0), -1.0), ((-1, 0, 0), -1.0), ((1, 0, 0), -1.0),
        ((0, 0, 0), 7.0)])
    B = struct_matrix_from_stencil((n, n, n),
                                   [((0, 0, 0), c), ((0, 0, 1), 0.5 * c)])
    Bt = struct_matrix_from_stencil((n, n, n),
                                    [((0, 0, 0), c), ((0, 0, -1), 0.5 * c)])
    return {(0, 0): L, (0, 1): B, (1, 0): Bt, (1, 1): L}


def sstruct_two_parts(n: int):
    """tests/test_sstruct.py's two (1, n, n) 5-pt parts glued along an
    edge by graph entries."""
    grid = SStructGrid()
    grid.add_part((1, n, n), L5)
    grid.add_part((1, n, n), L5)
    M = SStructMatrix(grid)
    for y in range(n):
        M.add_graph_entry(0, (0, y, n - 1), 1, (0, y, 0), -1.0)
        M.add_graph_entry(1, (0, y, 0), 0, (0, y, n - 1), -1.0)
    return M


def struct_true_relres(A, b, x) -> float:
    return float(torch.linalg.vector_norm(b - struct_matvec(A, x))
                 / torch.linalg.vector_norm(b))


def struct_row(tag: str, flags: str, ref_iters, hypre: dict,
               solves: int = 3, ref_relres=None) -> dict:
    """One struct driver row through drivers.struct.run on the card, then
    `solves` more timed solves (pcg with the driver's preconditioner, or
    the standalone multigrid), b = ones scaled a little each time.  A
    row the reference leaves unconverged (ref_relres) is held to its
    residual, rtol 1e-3."""
    set_config(Config(real_dtype=F64, device="cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = struct_driver.run(struct_driver.build_parser().parse_args(
        flags.split()))
    launches = read_counts()
    A, mg, b = out["A"], out["mg"], out["b"]
    iters, times, x, bt = [out["iters"]], [], out["x"], b
    for t in range(solves):
        bt = b * (1.0 + 0.0137 * (t + 1))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if out["solver"] in (0, 1):
            x, it, _ = mg.solve(bt, tol=STRUCT_TOL)
        else:
            res = pcg(A=lambda u: struct_matvec(A, u), b=bt,
                      M=mg.precondition, tol=STRUCT_TOL, max_iter=100)
            x, it = res.x, res.iters
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        iters.append(it)
    true_relres = struct_true_relres(A, bt, x)
    row = {"phase": "struct", "run": tag, "command": f"struct {flags}",
           "dtype": "float64", "unknowns": out["n"],
           "level_shapes": [list(s) for s in out["level_shapes"]],
           "setup_s": out["setup_s"], "first_solve_s": out["solve_s"],
           "solve_s": statistics.median(times) if times else out["solve_s"],
           "solve_times_s": times,
           "iters": out["iters"], "iters_all_solves": iters,
           "reference_iters": ref_iters, "relres": out["relres"],
           "true_relres": true_relres, "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "hypre_published": hypre}
    emit(row)
    hold(not bool(torch.isfinite(x).all())
         or tuple(x.shape) != tuple(A.shape),
         f"struct ({tag}): solution not finite or misshapen")
    if ref_relres is None:
        hold(true_relres > STRUCT_TOL,
             f"struct ({tag}): true relres {true_relres:.3e}")
    else:
        hold(abs(out["relres"] - ref_relres) > 1e-3 * ref_relres,
             f"struct ({tag}): relres {out['relres']:e}, the reference's "
             f"{ref_relres:e}")
    hold(ref_iters is not None and set(iters) != {ref_iters},
         f"struct ({tag}): iterations {iters}, the reference's {ref_iters}")
    return {"out": out, "row": row}


def struct_matvec_timing(A, peaks, label: str, gen) -> dict:
    """struct_matvec (plain torch: one zeros and one addcmul_ a stencil
    offset) on A: CUDA-event time a call, the device time of its kernels
    (profiler; the tracer drops records on the card's machine, so
    sessions repeat until one traced every launch, else the most
    complete one is scaled up), and the bytes bound: coefficients, u and
    y, each once."""
    from torch.profiler import ProfilerActivity, profile

    u = torch.randn(A.shape, generator=gen, dtype=F64, device="cuda")
    ms = time_ms(lambda: struct_matvec(A, u))
    reps, launches = 10, 1 + len(A.offsets)
    best = (-1, 0.0)
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                struct_matvec(A, u)
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        traced = sum(e.count for e in evts)
        if traced > best[0]:
            best = (traced, sum(e.self_device_time_total for e in evts))
        if traced >= reps * launches:
            break
    traced, us = best
    dev_ms = us / 1e3 / reps * (reps * launches / max(traced, 1))
    n_bytes = (len(A.offsets) + 2) * A.n_rows * 8
    flops = 2 * len(A.offsets) * A.n_rows
    b_ms, b_by = bound_ms(peaks, n_bytes, flops, F64)
    return {"op": label, "shape": list(A.shape), "offsets": len(A.offsets),
            "ms": ms, "device_ms": dev_ms,
            "kernels_traced": [traced, reps * launches], "bound_ms": b_ms,
            "bound_by": b_by, "bound_bytes": n_bytes,
            "share_of_bound": b_ms / dev_ms if dev_ms else None,
            "launches_per_call": launches}


@contextlib.contextmanager
def struct_calls_counted(counts: dict):
    """While open, every struct_matvec the PFMG cycle makes is counted
    (calls, and launches: one zeros and one addcmul_ an offset) and
    traced as a profiler range, and so are its transfers and
    relaxation (their ranges include the matvecs they make)."""
    from torch.profiler import record_function

    from hypre_tpu_torch.struct import pfmg as pfmg_mod

    saved = {nm: getattr(pfmg_mod, nm) for nm in (
        "struct_matvec", "_restrict_apply", "_interp_apply", "_pfmg_relax")}

    def wrap(nm, fn):
        def inner(*a, **k):
            counts[nm] = counts.get(nm, 0) + 1
            if nm == "struct_matvec":
                counts["struct_matvec_launches"] = counts.get(
                    "struct_matvec_launches", 0) + 1 + len(a[0].offsets)
            with record_function(nm):
                return fn(*a, **k)
        return inner

    for nm, fn in saved.items():
        setattr(pfmg_mod, nm, wrap(nm, fn))
    try:
        yield counts
    finally:
        for nm, fn in saved.items():
            setattr(pfmg_mod, nm, fn)


def profile_struct_iteration(row_a: dict) -> dict:
    """One CG+PFMG iteration of (a) (one cycle and one A p) under the
    profiler: busy share, device time by kind and by range (struct_matvec,
    restriction, interpolation, relaxation), kernel launches."""
    from torch.profiler import ProfilerActivity, profile

    out = row_a["out"]
    A, mg = out["A"], out["mg"]
    r = torch.ones(A.shape, dtype=F64, device="cuda")
    best = None
    for _ in range(5):
        counts = {}
        with struct_calls_counted(counts):
            mg.precondition(r)                     # warm
            counts.clear()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                mg.precondition(r)
                counts["struct_matvec"] += 1
                counts["struct_matvec_launches"] += 1 + len(A.offsets)
                struct_matvec(A, r)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        # the tracer drops records: struct_matvec's addcmul_ launches,
        # counted on the host, say how complete a session is
        expected = counts["struct_matvec_launches"] - counts["struct_matvec"]
        traced = sum(e.count for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "addcmul" in e.key)
        if best is None or traced > best[0]:
            best = (traced, expected, prof, wall_ms, counts)
        if traced >= expected:
            break
    traced, expected, prof, wall_ms, counts = best
    kernels, launches, by_kind, ranges = 0.0, 0, {}, {}
    for evt in prof.key_averages():
        if evt.key in ("struct_matvec", "_restrict_apply", "_interp_apply",
                       "_pfmg_relax"):
            # the range as the card saw it (first to last kernel, summed
            # over calls), beside the host's record of it
            side = ("device_span_ms" if evt.device_type
                    == torch.autograd.DeviceType.CUDA else "host_device_ms")
            ranges.setdefault(evt.key, {"calls": evt.count})[side] = (
                evt.self_device_time_total if side == "device_span_ms"
                else evt.device_time_total) / 1e3
            continue
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        kernels += us / 1e3
        launches += evt.count
        kind = "struct_matvec (addcmul)" if "addcmul" in evt.key \
            else _kind(evt.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3
    row = {"phase": "profile", "path": "struct (a) out.7 CG+PFMG",
           "unit": "one PFMG cycle and one A p", "wall_ms": wall_ms,
           "device_busy_ms": kernels, "device_busy_share": kernels / wall_ms,
           "kernel_launches": launches,
           "addcmul_traced": [traced, expected], "calls": counts,
           "ranges_device_ms": ranges,
           "by_kind_ms": dict(sorted(by_kind.items(), key=lambda kv: -kv[1]))}
    emit(row)
    return row


def g_row(name: str, size, setup_s, solve_s, it, rel, true_rel, ref,
          launches, extra=None) -> dict:
    row = {"phase": "struct", "run": f"g {name}", "size": size,
           "setup_s": setup_s, "solve_s": solve_s, "iters": it,
           "relres": rel, "true_relres": true_rel, "reference": ref,
           "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           **(extra or {})}
    emit(row)
    return row


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def msg_run(n: int) -> tuple:
    torch.cuda.reset_peak_memory_stats()
    A = struct_laplacian(n, n, n)
    msg, setup_s = timed(lambda: SparseMSG(SparseMSGConfig(jump=0)).setup(A))
    b = torch.ones(A.shape, dtype=F64, device="cuda")
    (x, it, rel), solve_s = timed(lambda: msg.solve(b, tol=STRUCT_TOL))
    return msg, setup_s, solve_s, it, rel, struct_true_relres(A, b, x)


def struct_g_runs(gen) -> dict:
    """(g): SparseMSG, SysPFMG, FAC and the sstruct Split solver at >=
    10^6 unknowns, each held to the reference's count (SparseMSG: at
    MSG_HELD's size; FAC: the reference's residual after FAC_CYCLES);
    FAC's and Split's operators on K2/K3 against their plain versions."""
    set_config(Config(real_dtype=F64, device="cuda"))
    errs = {"csr_spmv": 0.0, "dia_matvec": 0.0}
    rows = {}
    # SparseMSG: the held size, then full size
    n_held, it_held = MSG_HELD
    _, s_s, v_s, it, rel, tr = msg_run(n_held)
    rows["msg_held"] = g_row("SparseMSG", [n_held] * 3, s_s, v_s, it, rel,
                             tr, it_held, None)
    hold(it != it_held or tr > STRUCT_TOL,
         f"SparseMSG {n_held}^3: {it} iterations (reference {it_held}), "
         f"true relres {tr:.3e}")
    msg, s_s, v_s, it, rel, tr = msg_run(MSG_GRID)
    rows["msg"] = g_row("SparseMSG", [MSG_GRID] * 3, s_s, v_s, it, rel, tr,
                        None, None, {"lattice_grids": len(msg.grids)})
    del msg
    hold(tr > STRUCT_TOL, f"SparseMSG {MSG_GRID}^3: true relres {tr:.3e}")
    # SysPFMG: the two-variable coupled system
    torch.cuda.reset_peak_memory_stats()
    n = SYS_GRID
    blocks = sys_coupled_system(n)
    sysmg, s_s = timed(lambda: SysPFMG(PfmgConfig()).setup(blocks, 2,
                                                           (n, n, n)))
    b = torch.ones((2, n, n, n), dtype=F64, device="cuda")
    (x, it, rel), v_s = timed(lambda: sysmg.solve(b, tol=STRUCT_TOL))
    tr = float(torch.linalg.vector_norm(b - sys_matvec(
        sysmg.hierarchy.levels[0], x)) / torch.linalg.vector_norm(b))
    ref_it, _ = REF_G["sys"]
    rows["sys"] = g_row("SysPFMG", [2, n, n, n], s_s, v_s, it, rel, tr,
                        ref_it, None,
                        {"level_shapes": [list(s) for s in
                                          sysmg.level_shapes]})
    del sysmg, blocks
    hold(it != ref_it or tr > STRUCT_TOL,
         f"SysPFMG: {it} iterations (reference {ref_it}), true relres "
         f"{tr:.3e}")
    # FAC: FAC_CYCLES composite cycles, the reference's residual
    torch.cuda.reset_peak_memory_stats()
    n = FAC_GRID
    Ac = struct_matrix_from_stencil((1, n, n), L5)
    fac, s_s = timed(lambda: FAC(Ac, [(o, 4.0 * v) for o, v in L5],
                                 (0, n // 4, n // 4),
                                 (1, 3 * n // 4, 3 * n // 4), FacConfig()))
    b = torch.as_tensor(fac.composite_rhs(np.ones((1, n, n)),
                                          np.ones(fac.fine_shape)),
                        dtype=F64, device="cuda")
    reset_counts()
    (x, it, rel), v_s = timed(lambda: fac.solve(b, tol=STRUCT_TOL,
                                                max_iter=FAC_CYCLES))
    launches = read_counts()
    ref_it, ref_rel = REF_G["fac"]
    x_cpu = x.cpu().numpy()
    tr = float(np.linalg.norm(fac.composite_rhs(
        np.ones((1, n, n)), np.ones(fac.fine_shape)) - fac.A_comp @ x_cpu)
        / np.linalg.norm(b.cpu().numpy()))
    fac_ops = [("FAC A_comp", fac.A_op), ("FAC R", fac.R_op),
               ("FAC P", fac.P_op)] + [
        (f"FAC coarse {nm}", op) for nm, op in hierarchy_ops(
            fac.coarse, (CsrMatrix, DiaMatrix))]
    rows["fac"] = g_row("FAC", {"coarse": [1, n, n],
                                "composite_unknowns": int(b.numel())},
                        s_s, v_s, it, rel, tr, [ref_it, ref_rel], launches,
                        {"formats": {nm: type(op).__name__
                                     for nm, op in fac_ops}})
    hold(it != ref_it or abs(rel - ref_rel) > 1e-3 * ref_rel,
         f"FAC: {it} cycles, relres {rel:.6e}; the reference's {ref_it}, "
         f"{ref_rel:.6e}")
    # Split: two parts glued along an edge, PCG
    torch.cuda.reset_peak_memory_stats()
    n = SPLIT_GRID
    M = sstruct_two_parts(n)
    A = M.assemble_parcsr()
    split, s_s = timed(lambda: SplitSolver(M).setup())
    op = sparse_op_from_scipy(A)
    b = torch.ones(A.shape[0], dtype=F64, device="cuda")
    reset_counts()
    res, v_s = timed(lambda: pcg(op, b, M=split.precondition,
                                 tol=STRUCT_TOL, max_iter=500))
    launches = read_counts()
    tr = float(np.linalg.norm(np.ones(A.shape[0]) - A @ res.x.cpu().numpy())
               / np.sqrt(A.shape[0]))
    ref_it, _ = REF_G["split"]
    rows["split"] = g_row("sstruct Split", [2, 1, n, n], s_s, v_s,
                          res.iters, res.relres, tr, ref_it, launches,
                          {"format": type(op).__name__})
    hold(res.iters != ref_it or tr > STRUCT_TOL,
         f"Split: {res.iters} iterations (reference {ref_it}), true relres "
         f"{tr:.3e}")
    # the hand kernels of FAC's and Split's operators on the card
    checks = []
    for label, op_ in fac_ops + [("Split A", op)]:
        if isinstance(op_, (CsrMatrix, DiaMatrix)):
            xk = torch.randn(op_.n_cols, generator=gen, dtype=F64,
                             device="cuda")
            c = (check_csr if isinstance(op_, CsrMatrix) else check_dia)(
                op_, xk, label)
            key = "csr_spmv" if isinstance(op_, CsrMatrix) else "dia_matvec"
            errs[key] = max(errs[key], c["max_abs_err"])
            checks.append(c)
    emit({"phase": "kernel_checks", "path": "struct (g) FAC and Split",
          "checks": checks})
    hold(launches["dia_matvec"] + launches["csr_spmv"] == 0
         or rows["fac"]["launches"]["csr_spmv"] == 0,
         "struct (g): K2/K3 not launched by FAC or Split")
    return {"rows": rows, "errs": errs}


def phase_struct(peaks, gen) -> dict:
    """hypre's struct rows (a)-(d), (f), the golden rows (e), the struct
    solvers (g) and struct_matvec's timing on the card.  Each row's
    objects are dropped before the next, so its peak memory is its own."""
    t0 = time.perf_counter()
    rows = {}
    name, flags, hypre = STRUCT_ROWS["a"]
    rows["a"] = struct_row("a", flags, REF_STRUCT_ITERS["a"],
                           {"case": name, **hypre})
    A0 = rows["a"]["out"]["A"]
    lvl27 = next(lvl.A for lvl in rows["a"]["out"]["mg"].hierarchy.levels
                 if len(lvl.A.offsets) == 27)
    timing = [struct_matvec_timing(A0, peaks, "out.7 level 0", gen),
              struct_matvec_timing(lvl27, peaks, "out.7 first 27-offset "
                                   "level", gen)]
    prof = profile_struct_iteration(rows["a"])
    emit({"phase": "struct_matvec_timing", "timing": timing,
          "calls_per_cg_pfmg_iter": prof["calls"]["struct_matvec"],
          "launches_per_cg_pfmg_iter":
              prof["calls"]["struct_matvec_launches"],
          "kernel_launches_per_cg_pfmg_iter": prof["kernel_launches"]})
    del A0, lvl27, rows["a"]["out"]
    torch.cuda.empty_cache()
    for tag in ("b", "c"):
        name, flags, hypre = STRUCT_ROWS[tag]
        rows[tag] = struct_row(tag, flags, REF_STRUCT_ITERS[tag],
                               {"case": name, **hypre})
        del rows[tag]["out"]
        torch.cuda.empty_cache()
    # (d): out.3 at the held size (the reference's count), then 128^3
    n_held, it_held = OUT3_HELD
    rows["d_held"] = struct_row("d (held size)",
                                f"-n {n_held} {n_held} {n_held} -solver 10",
                                it_held, {}, solves=0)
    del rows["d_held"]["out"]
    name, flags, hypre = STRUCT_ROWS["d"]
    rows["d"] = struct_row("d", flags, None, {"case": name, **hypre})
    del rows["d"]["out"]
    torch.cuda.empty_cache()
    phase_golden_rows("struct_solvers")
    name, flags, hypre = STRUCT_ROWS["f"]
    rows["f"] = struct_row("f", flags, REF_STRUCT_ITERS["f"],
                           {"case": name}, solves=0,
                           ref_relres=REF_STRUCT_RELRES["f"])
    del rows["f"]["out"]
    torch.cuda.empty_cache()
    g = struct_g_runs(gen)
    emit({"phase": "struct", "run": "all", "wall_s":
          time.perf_counter() - t0})
    return {"rows": {k: v["row"] for k, v in rows.items()},
            "g": g["rows"], "errs": g["errs"], "matvec_timing": timing}


# ---------------------------------------------------------------------------
# maxwell: the auxiliary-space solvers (AMS, ADS, AME), SStruct Maxwell
# and the API rows (hypre_compat, checkpoints, refinement, the examples)
# ---------------------------------------------------------------------------

def aux_true_relres(A_op, b, x) -> float:
    return float(torch.linalg.vector_norm(b - plain_matvec(A_op, x))
                 / torch.linalg.vector_norm(b))


def aux_solve(A_op, M, solves: int, max_iter: int = 200) -> dict:
    """One warm-up and `solves` timed pcg(tol=1e-8) solves on the card
    with b = ones (scaled a little each time), launch counts zeroed just
    before the warm-up and read just after it."""
    b = torch.ones(A_op.shape[0], dtype=F64, device="cuda")
    reset_counts()
    (warm, first_s) = timed(lambda: pcg(A_op, b, M=M, tol=1e-8,
                                        max_iter=max_iter))
    launches = read_counts()
    iters, times, x, bt = [warm.iters], [], warm.x, b
    for t in range(solves):
        bt = b * (1.0 + 0.0137 * (t + 1))
        res, s = timed(lambda: pcg(A_op, bt, M=M, tol=1e-8,
                                   max_iter=max_iter))
        times.append(s)
        iters.append(res.iters)
        x = res.x
    hold(not bool(torch.isfinite(x).all()) or x.shape != b.shape,
         "maxwell: solution not finite or misshapen")
    return {"iters": warm.iters, "iters_all_solves": iters,
            "relres": warm.relres, "true_relres": aux_true_relres(
                A_op, bt, x), "first_solve_s": first_s,
            "solve_s": statistics.median(times) if times else first_s,
            "solve_times_s": times, "launches": launches}


def hold_iters(tag: str, iters: list, ref: tuple, n: int) -> None:
    """ref = (n_ref, count): equal at the reference's own size, at most
    count + 2 at a larger one (the reference cannot finish it here)."""
    n_ref, count = ref
    if n == n_ref:
        hold(set(iters) != {count},
             f"maxwell ({tag}): iterations {iters}, the reference's "
             f"{count}")
    else:
        hold(max(iters) > count + 2,
             f"maxwell ({tag}): iterations {iters} at {n}, the "
             f"reference's {count} at {n_ref} (+2 allowed)")


def sub_amg_facts(prefix: str, amg) -> dict:
    return {f"{prefix}_levels": amg.level_sizes,
            f"{prefix}_formats": amg.level_formats,
            f"{prefix}_nnz0": amg.level_nnz[0]}


def ams_row(n: int, solves: int = 3) -> dict:
    """(a): ex15, AMS-PCG on maxwell_3d(n), beta 1."""
    set_config(Config(real_dtype=F64, device="cuda"))
    torch.cuda.reset_peak_memory_stats()
    (A, G, Pi), gen_s = timed(lambda: maxwell_3d(n))
    ams, setup_s = timed(lambda: AMS().setup(A, G, Pi))
    sol = aux_solve(ams.A_op, ams.precondition, solves)
    per_iter = launches_per_iter(ams.precondition, ams.A_op)
    row = {"phase": "maxwell", "run": "a", "case": f"ex15 AMS-PCG "
           f"maxwell_3d({n})", "dtype": "float64", "edges": A.shape[0],
           "nodes": G.shape[1], "nodal_vector": Pi.shape[1],
           "edge_nnz": A.nnz, "A_format": type(ams.A_op).__name__,
           "gen_s": gen_s, "setup_s": setup_s,
           **sub_amg_facts("bg", ams.bg), **sub_amg_facts("bpi", ams.bpi),
           **sol, "launches_per_pcg_iter": per_iter,
           "reference": REF_AMS,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(row)
    hold(sol["true_relres"] > 1e-8,
         f"maxwell (a): true relres {sol['true_relres']:.3e}")
    hold_iters("a", sol["iters_all_solves"], REF_AMS, n)
    return {"ams": ams, "row": row}


def ads_row(n: int, solves: int = 3) -> dict:
    """(b): ADS-PCG with the inner AMS on rt0_3d(n), beta 1."""
    torch.cuda.reset_peak_memory_stats()
    (A, C, Pi_f, G, Pi_e), gen_s = timed(lambda: rt0_3d(n))
    ads, setup_s = timed(lambda: ADS().setup(A, C, Pi_f, G=G, Pi_e=Pi_e))
    A_op = sparse_op_from_scipy(A)
    sol = aux_solve(A_op, ads.precondition, solves)
    per_iter = launches_per_iter(ads.precondition, A_op)
    row = {"phase": "maxwell", "run": "b", "case": f"ADS-PCG rt0_3d({n})",
           "dtype": "float64", "faces": A.shape[0], "face_nnz": A.nnz,
           "edges": C.shape[1], "A_format": type(A_op).__name__,
           "gen_s": gen_s, "setup_s": setup_s,
           **sub_amg_facts("bpi", ads.bpi),
           **sub_amg_facts("inner_bg", ads.bc_ams.bg),
           **sub_amg_facts("inner_bpi", ads.bc_ams.bpi),
           **sol, "launches_per_pcg_iter": per_iter,
           "reference": REF_ADS,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(row)
    hold(sol["true_relres"] > 1e-8,
         f"maxwell (b): true relres {sol['true_relres']:.3e}")
    hold_iters("b", sol["iters_all_solves"], REF_ADS, n)
    return {"ads": ads, "A_op": A_op, "row": row}


def maxwell_row(n: int, solves: int = 1) -> dict:
    """(c): SStructMaxwell-PCG on maxwell_3d(n), beta 1."""
    torch.cuda.reset_peak_memory_stats()
    A, G, _ = maxwell_3d(n)
    mx, setup_s = timed(lambda: SStructMaxwell().setup(A, G))
    A_op = sparse_op_from_scipy(A)
    sol = aux_solve(A_op, mx.precondition, solves)
    row = {"phase": "maxwell", "run": "c", "case": f"SStructMaxwell-PCG "
           f"maxwell_3d({n})", "dtype": "float64", "edges": A.shape[0],
           "edge_levels": mx.level_sizes,
           "level_formats": [type(lvl["A"]).__name__ for lvl in mx.levels],
           "setup_s": setup_s, **sol,
           "launches_per_pcg_iter": launches_per_iter(mx.precondition,
                                                      A_op),
           "reference": REF_MAXWELL,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(row)
    hold(sol["true_relres"] > 1e-8,
         f"maxwell (c): true relres {sol['true_relres']:.3e}")
    hold_iters("c", sol["iters_all_solves"], REF_MAXWELL, n)
    return row


def ame_row(n: int) -> dict:
    """(d): AME, the 3 smallest non-gradient eigenpairs of maxwell_3d(n)
    (a cut of scale: LOBPCG projects every column with up to 15 nodal
    PCG steps, so the row is launch-bound)."""
    A, G, Pi = maxwell_3d(n)
    reset_counts()
    ame, setup_s = timed(lambda: AME().setup(A, G, Pi))
    res, solve_s = timed(lambda: ame.solve(3, tol=1e-6, max_iter=100))
    launches = read_counts()
    lam = res.eigenvalues.cpu().numpy()
    ref_lam = np.array(REF_AME["eigenvalues"])
    rel = np.abs(lam - ref_lam) / np.abs(ref_lam)
    row = {"phase": "maxwell", "run": "d", "case": f"AME maxwell_3d({n})",
           "dtype": "float64", "edges": A.shape[0], "setup_s": setup_s,
           "solve_s": solve_s, "iters": res.iters,
           "eigenvalues": lam.tolist(), "reference": REF_AME,
           "eigenvalue_rel_err": rel.tolist(),
           "resnorms": res.resnorms.cpu().numpy().tolist(),
           "launches": launches}
    emit(row)
    hold(res.iters != REF_AME["iters"] or rel.max() > 1e-6,
         f"maxwell (d): {res.iters} iterations and eigenvalues {lam}, "
         f"the reference's {REF_AME}")
    return row


def aux_ops(prefix: str, obj) -> list:
    """The CSR and DIA operators of an AMS or ADS: its transfers, its
    sub-hierarchies' A, P and R (an ADS's inner AMS too)."""
    ops = []
    for name in ("A_op", "G", "Gt", "Pi", "Pit", "C", "Ct"):
        m = getattr(obj, name, None)
        if isinstance(m, (CsrMatrix, DiaMatrix)):
            ops.append((f"{prefix} {name}", m))
    for name in ("bg", "bpi", "bc_amg"):
        amg = getattr(obj, name, None)
        if amg is not None:
            ops += [(f"{prefix} {name} {label}", m) for label, m in
                    hierarchy_ops(amg, (CsrMatrix, DiaMatrix))]
    if getattr(obj, "bc_ams", None) is not None:
        ops += aux_ops(f"{prefix} inner", obj.bc_ams)
    return ops


def api_rows(gen) -> list:
    """(f): the ex_capi flow at CAPI_GRID^3, a save_amg/load_amg round
    trip at CKPT_GRID^3, ir_solve with an f32 inner AMG-PCG at
    IR_GRID^3, and every ported example at its test size."""
    rows = []
    set_config(Config(real_dtype=F64, device="cuda"))

    def capi(A, b):
        precond = H.HYPRE_BoomerAMGCreate()
        H.HYPRE_BoomerAMGSetCoarsenType(precond, 6)
        H.HYPRE_BoomerAMGSetRelaxType(precond, 6)
        H.HYPRE_BoomerAMGSetNumSweeps(precond, 1)
        H.HYPRE_BoomerAMGSetTol(precond, 0.0)
        H.HYPRE_BoomerAMGSetMaxIter(precond, 1)
        solver = H.HYPRE_ParCSRPCGCreate()
        H.HYPRE_PCGSetMaxIter(solver, 1000)
        H.HYPRE_PCGSetTol(solver, 1e-7)
        H.HYPRE_PCGSetPrecond(solver, precond_handle=precond)
        H.HYPRE_ParCSRPCGSetup(solver, A, b)
        x = H.HYPRE_ParCSRPCGSolve(solver, A, b)
        return precond, solver, x

    for n in sorted({REF_CAPI[0], CAPI_GRID}):
        A = laplacian(n, n, n)
        b = np.ones(A.shape[0])
        reset_counts()
        (precond, solver, x), wall_s = timed(lambda: capi(A, b))
        launches = read_counts()
        it = H.HYPRE_PCGGetNumIterations(solver)
        true_rel = float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))
        rows.append({
            "phase": "maxwell", "run": "f capi", "grid": [n, n, n],
            "levels": precond.amg.level_sizes, "wall_s": wall_s,
            "iters": it, "reference": REF_CAPI,
            "relres": H.HYPRE_PCGGetFinalRelativeResidualNorm(solver),
            "true_relres": true_rel, "launches": launches})
        emit(rows[-1])
        hold(true_rel > 1e-6, f"maxwell (f capi): relres {true_rel:.3e}")
        hold_iters("f capi", [it], REF_CAPI, n)
        del precond, solver, A

    n = CKPT_GRID
    A = laplacian(n, n, n)
    amg, setup_s = timed(lambda: BoomerAMG(AmgConfig(interp_type=6))
                         .setup(A))
    op = sparse_op_from_scipy(A)
    bt = torch.ones(A.shape[0], dtype=F64, device="cuda")
    r1 = pcg(op, bt, M=amg, tol=1e-8, max_iter=100)
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "amg.npz")
        _, save_s = timed(lambda: save_amg(amg, path))
        size_mb = Path(path).stat().st_size / 1e6
        amg2, load_s = timed(lambda: load_amg(path))
    r2 = pcg(op, bt, M=amg2, tol=1e-8, max_iter=100)
    same = bool(torch.equal(r1.x, r2.x))
    rows.append({"phase": "maxwell", "run": "f checkpoint",
                 "grid": [n, n, n], "levels": amg.level_sizes,
                 "level_formats": amg2.level_formats, "setup_s": setup_s,
                 "save_s": save_s, "load_s": load_s, "file_mb": size_mb,
                 "iters": [r1.iters, r2.iters],
                 "reference_iters": REF_CKPT, "x_bit_for_bit": same,
                 "true_relres": aux_true_relres(op, bt, r2.x)})
    emit(rows[-1])
    hold(r1.iters != r2.iters or not same or r1.iters != REF_CKPT,
         f"maxwell (f checkpoint): iterations {r1.iters}/{r2.iters}, x "
         f"equal {same}, the reference's {REF_CKPT}")
    del amg, amg2, op, r1, r2

    n = IR_GRID
    A = laplacian(n, n, n)
    b = np.ones(A.shape[0])
    set_config(Config(real_dtype=torch.float32, device="cuda"))
    amg32, setup_s = timed(lambda: BoomerAMG(AmgConfig(interp_type=6))
                           .setup(A))
    op32 = sparse_op_from_scipy(A)

    def inner(r32):
        res = pcg(op32, torch.as_tensor(r32, device="cuda"), M=amg32,
                  tol=1e-6, max_iter=50)
        return res.x, res.iters

    reset_counts()
    out, ir_s = timed(lambda: ir_solve(
        lambda v: stencil_apply_f64((n, n, n), LAPLACE_7PT, v), b, inner,
        tol=1e-8))
    launches = read_counts()
    set_config(Config(real_dtype=F64, device="cuda"))
    true_rel = float(np.linalg.norm(b - A @ out["x"]) / np.linalg.norm(b))
    rows.append({"phase": "maxwell", "run": "f ir_solve", "grid": [n] * 3,
                 "inner_dtype": "float32", "inner_format":
                 type(op32).__name__, "setup_s": setup_s, "wall_s": ir_s,
                 "outer_iters": out["outer_iters"],
                 "inner_iters_total": out["inner_iters_total"],
                 "reference": REF_IR, "relres": out["relres"],
                 "true_relres_f64": true_rel, "launches": launches})
    emit(rows[-1])
    hold(out["relres"] > 1e-8 or true_rel > 1.1e-8
         or out["outer_iters"] != REF_IR["outer_iters"],
         f"maxwell (f ir_solve): {out['outer_iters']} outer and "
         f"{out['inner_iters_total']} inner iterations, relres "
         f"{out['relres']:.3e} (true {true_rel:.3e}), the reference's "
         f"{REF_IR}")
    del amg32, op32, A

    got = {}
    with contextlib.redirect_stdout(io.StringIO()):
        reset_counts()
        t0 = time.perf_counter()
        got["ex5"] = ex5.main(n=20).iters
        got["ex11"] = ex11.main(n=16, m=2).iters
        got["ex_struct"] = ex_struct.main(n=16).iters
        got["ex3_pfmg"] = ex3_pfmg.main(n=32)
        got["ex15_ams"] = ex15_ams.main(n=6)
        got["ex9_systems"] = [ex9_systems.main(n=24),
                              ex9_systems.main(n=48)]
        ex_lobpcg.main(n=16, nev=3)
        got["ex6_multibox"] = ex6_multibox.main(n=12)[0]
        got["ex_capi"] = ex_capi.main(n=20)
        wall_s = time.perf_counter() - t0
        launches = read_counts()
    rows.append({"phase": "maxwell", "run": "f examples", "iters": got,
                 "reference_iters": REF_EXAMPLES, "wall_s": wall_s,
                 "launches": launches})
    emit(rows[-1])
    hold(got != REF_EXAMPLES,
         f"maxwell (f examples): {got}, the reference's {REF_EXAMPLES}")
    return rows


def phase_maxwell(gen) -> dict:
    """The auxiliary-space rows (a)-(d), the checks (e) and the API rows
    (f) on the card; each row's objects are dropped before the next."""
    t0 = time.perf_counter()
    n_held = REF_AMS[0]
    if n_held != AMS_GRID:
        ams_row(n_held, solves=0)
    a = ams_row(AMS_GRID)
    checks = phase_ops_checks(aux_ops("ams", a["ams"]), gen,
                              f"ex15 AMS maxwell_3d({AMS_GRID})")
    r = torch.ones(a["ams"].A_op.shape[0], dtype=F64, device="cuda")

    def run():
        a["ams"].precondition(r)
        matvec(a["ams"].A_op, r)
        return {}

    phase_profile(f"ex15 AMS-PCG maxwell_3d({AMS_GRID})", run,
                  "one AMS application and one A x")
    hold(a["row"]["launches"]["csr_spmv"] == 0
         or a["row"]["launches"]["dia_matvec"] == 0,
         "maxwell (a): K2 or K3 not launched on the AMS path")
    del a["ams"], r
    torch.cuda.empty_cache()
    if REF_ADS[0] != ADS_GRID:
        ads_row(REF_ADS[0], solves=0)
    b = ads_row(ADS_GRID)
    ads_ops = aux_ops("ads", b["ads"])
    if isinstance(b["A_op"], (CsrMatrix, DiaMatrix)):
        ads_ops.append(("ads A_op", b["A_op"]))
    checks_b = phase_ops_checks(ads_ops, gen, f"ADS rt0_3d({ADS_GRID})")
    for k, v in checks_b.items():
        checks[k] = max(checks.get(k, 0.0), v)
    hold(b["row"]["launches"]["csr_spmv"] == 0,
         "maxwell (b): K2 not launched on the ADS path")
    rb = torch.ones(b["A_op"].shape[0], dtype=F64, device="cuda")

    def run_b():
        b["ads"].precondition(rb)
        matvec(b["A_op"], rb)
        return {}

    phase_profile(f"ADS-PCG rt0_3d({ADS_GRID})", run_b,
                  "one ADS application and one A x")
    b_row = b["row"]
    del b, rb
    torch.cuda.empty_cache()
    if REF_MAXWELL[0] != MAXWELL_GRID:
        maxwell_row(REF_MAXWELL[0], solves=0)
    c = maxwell_row(MAXWELL_GRID)
    torch.cuda.empty_cache()
    d = ame_row(AME_GRID)
    f = api_rows(gen)
    emit({"phase": "maxwell", "run": "all",
          "wall_s": time.perf_counter() - t0})
    return {"a": a["row"], "b": b_row, "c": c, "d": d, "f": f,
            "errs": checks}


# ---------------------------------------------------------------------------
# distributed: the ParCSR layer on stacked shards (and NCCL at world size 1)
# ---------------------------------------------------------------------------

# dryrun_multichip(8) at 12^3: MULTICHIP_r05.json (the reference on 8
# virtual devices) and `python tools/par_reference_counts.py card`
REF_PAR_DRYRUN = {"pcg": 15, "relres": 6.8887290404738325e-09, "gmres_w": 13,
                  "dist_pcg": 12, "levels": [1728, 597, 126, 24, 2]}
PAR_SHARDS = 8
PAR_GRID = 256               # out.14 on 8 stacked shards, not cut
PAR_SETUP_GRID = 128         # setup_distributed and ParIJ (item (d), (e))


def par_solves(pamg, n_rows: int, plain, max_iter: int = 100) -> dict:
    """One warm-up and three timed ParBoomerAMG-PCG solves (b = ones,
    scaled a little each time) on the card, sharded; the true relative
    residual of the last with A x by `plain` on the global x."""
    b = torch.ones(n_rows, dtype=F64, device="cuda")
    part = pamg.fine_part
    b_sh = torch.zeros(part.n_padded, dtype=F64, device="cuda")
    b_sh[:n_rows] = b
    b_sh = b_sh.reshape(part.n_shards, part.n_local)
    warm = pamg.solve_sharded(b_sh, tol=1e-8, max_iter=max_iter)
    iters, times = [warm.iters], []
    for t in range(3):
        bt = b_sh * (1.0 + 0.0137 * (t + 1))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = pamg.solve_sharded(bt, tol=1e-8, max_iter=max_iter)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        iters.append(res.iters)
    x = res.x.reshape(-1)[:n_rows]
    if not bool(torch.isfinite(x).all()):
        raise AssertionError("distributed solution is not finite")
    bg = bt.reshape(-1)[:n_rows]
    true_relres = float(torch.linalg.vector_norm(bg - plain(x))
                        / torch.linalg.vector_norm(bg))
    solve_s = statistics.median(times)
    return {"iters": res.iters, "iters_all_solves": iters,
            "relres": res.relres, "true_relres": true_relres,
            "solve_s": solve_s, "solve_times_s": times,
            "per_iter_ms": solve_s / max(res.iters, 1) * 1e3}


def par_ops(pamg) -> list:
    """Every stacked block of a ParBoomerAMG hierarchy: diag and offd of
    each A, P and R, and the two-stage triangles."""
    ops = []
    for l, lvl in enumerate(pamg.hierarchy.levels):
        for name in ("A", "P", "R"):
            M = getattr(lvl, name)
            if M is not None:
                ops += [(f"{name}{l}.{blk}", C) for blk, C in M.blocks()
                        if C.nnz]
        for name in ("L", "U"):
            if getattr(lvl, name) is not None:
                ops.append((f"{name}{l}", getattr(lvl, name)))
    return ops


def par_launches_per_iter(pamg) -> dict:
    part = pamg.fine_part
    r = torch.ones((part.n_shards, part.n_local), dtype=F64, device="cuda")
    reset_counts()
    pamg.precondition(r)
    pamg.fine_matvec(r)
    torch.cuda.synchronize()
    out = read_counts()
    reset_counts()
    return out


def par_dryrun_rows() -> dict:
    """(a) the dryrun analog at 12^3 on 8 stacked shards, held to the
    reference's counts, and the V-PCG at 2, 4 and 8 shards: its launches
    a PCG iteration must not depend on the shard count."""
    from hypre_tpu_torch.examples.ex_multichip import dryrun_multichip

    out = dryrun_multichip(PAR_SHARDS)
    ref = REF_PAR_DRYRUN
    bad = [k for k in ("gmres_w", "dist_pcg", "levels")
           if out[k] != ref[k]]
    if out["pcg"] != ref["pcg"] or out["single_pcg"] != ref["pcg"]:
        bad.append("pcg")
    if abs(out["relres"] - ref["relres"]) > 1e-3 * ref["relres"]:
        bad.append("relres")
    per_iter = {}
    A = laplacian(12, 12, 12)
    for ns in (2, 4, 8):
        pamg = ParBoomerAMG(ns, AmgConfig()).setup(A)
        _, it, _ = pamg.solve_pcg(np.ones(A.shape[0]), tol=1e-8)
        if it != ref["pcg"]:
            bad.append(f"pcg at {ns} shards: {it}")
        per_iter[ns] = par_launches_per_iter(pamg)
    if len({json.dumps(v, sort_keys=True) for v in per_iter.values()}) != 1:
        bad.append("launches a PCG iteration differ with the shard count")
    row = {"phase": "distributed", "row": "a", "case":
           "dryrun_multichip at 12^3, 8 stacked shards", **out,
           "launches_per_pcg_iter_by_shards": per_iter,
           "reference": ref}
    emit(row)
    hold(bool(bad), f"distributed (a) differs from the reference: {bad}")
    return row


def par_out14(main_out: dict, gen) -> dict:
    """(c) out.14 at full width on 8 stacked shards through the entry
    points, the main path's configuration and stencil fine level."""
    n = PAR_GRID
    A = laplacian(n, n, n)
    cfg = AmgConfig(interp_type=6, relax_type=18)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    pamg = ParBoomerAMG(PAR_SHARDS, cfg).setup(
        A, fine_stencil=((n, n, n), LAPLACE_7PT))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_launches = read_counts()
    del A
    op = stencil_op((n, n, n), LAPLACE_7PT, dtype=F64)
    reset_counts()
    sol = par_solves(pamg, n ** 3, lambda x: stencil_matvec_plain(op, x))
    launches = read_counts()
    per_iter = par_launches_per_iter(pamg)
    row = {"phase": "distributed", "row": "c", "grid": [n, n, n],
           "shards": PAR_SHARDS, "levels": pamg.level_sizes,
           "operator_complexity": round(pamg.operator_complexity, 3),
           "setup_s": setup_s, "setup_stats": pamg.setup_stats, **sol,
           "launches_setup": setup_launches, "launches": launches,
           "launches_per_pcg_iter": per_iter,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "single_device_main_path": {
               k: main_out[k] for k in ("iters", "setup_s", "solve_s",
                                        "per_iter_ms", "peak_mem_gb")}}
    emit(row)
    hold(pamg.level_sizes != REF_LEVELS or round(
        pamg.operator_complexity, 3) != REF_OPERATOR_COMPLEXITY,
        "distributed (c): hierarchy differs from the reference's")
    hold(sol["iters"] != main_out["iters"],
         f"distributed (c): {sol['iters']} iterations, the single-device "
         f"main path {main_out['iters']}")
    hold(sol["true_relres"] > 1e-8,
         f"distributed (c): true relres {sol['true_relres']:.3e}")
    hold(launches["csr_spmv"] == 0, "distributed (c): K2 not launched")
    errs = phase_ops_checks(par_ops(pamg), gen, "distributed out.14, "
                            f"{PAR_SHARDS} stacked shards")
    return {"row": row, "errs": errs, "launches": launches}


def par_setup_rows(gen) -> dict:
    """(e) ParIJ: the 128^3 Laplacian assembled from per-shard
    off-process entries, exactly scipy's; (d) setup_distributed on it
    (7-pt, interp 6, relax 18): C/F splits equal to the single-device
    device setup's at every level, the PCG count within 1."""
    from hypre_tpu_torch.parallel.ij_par import ParIJMatrix
    from hypre_tpu_torch.parallel.par_setup import pardell_to_scipy

    n = PAR_SETUP_GRID
    A = laplacian(n, n, n)
    Ac = A.tocoo()
    t0 = time.perf_counter()
    ij = ParIJMatrix(A.shape[0], PAR_SHARDS)
    # every entry inserted by the shard after its owner: all off-process
    owner = Ac.row * PAR_SHARDS // A.shape[0]
    for s in range(PAR_SHARDS):
        sel = owner == s
        ij.add_to_values((s + 1) % PAR_SHARDS, Ac.row[sel], Ac.col[sel],
                         Ac.data[sel])
    M = ij.assemble()
    torch.cuda.synchronize()
    assemble_s = time.perf_counter() - t0
    B = pardell_to_scipy(M)
    exact = B.shape == A.shape and B.nnz == A.nnz and \
        abs(B - A).max() == 0
    row_e = {"phase": "distributed", "row": "e", "grid": [n, n, n],
             "assemble_s": assemble_s, "nnz": B.nnz, "exact": bool(exact)}
    emit(row_e)
    hold(not exact, "distributed (e): ParIJ assembly differs from scipy's")
    del B, Ac
    cfg = AmgConfig(interp_type=6, relax_type=18)
    A = A.tocsr()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    pamg = ParBoomerAMG(PAR_SHARDS, cfg).setup_distributed(
        M, fine_stencil=((n, n, n), LAPLACE_7PT))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_launches = read_counts()
    del M
    op = stencil_op((n, n, n), LAPLACE_7PT, dtype=F64)
    reset_counts()
    sol = par_solves(pamg, n ** 3, lambda x: stencil_matvec_plain(op, x))
    launches = read_counts()
    # the single-device device setup of the same operator, its slots in
    # the same (ascending column) order: setup_device(stencil=...) puts
    # them in stencil-arm order, which changes the order of ext+i's sums
    t0 = time.perf_counter()
    damg = BoomerAMG(cfg).setup_device(A)
    torch.cuda.synchronize()
    dev_setup_s = time.perf_counter() - t0
    dev_res = pcg(damg.hierarchy.levels[0].A,
                  torch.ones(n ** 3, dtype=F64, device="cuda"), M=damg,
                  tol=1e-8, max_iter=100)
    # the device setup's C/F splits, level by level
    dev_cf = []
    for item in dev.iter_device_hierarchy(
            dev.dell_from_scipy(A, torch.float64, "cuda"), cfg):
        if isinstance(item, tuple):
            dev_cf.append(item[3])
    cf_equal = len(dev_cf) == len(pamg.level_cf) and all(
        torch.equal(cp, cd) for cp, cd in zip(pamg.level_cf, dev_cf))
    row_d = {"phase": "distributed", "row": "d", "grid": [n, n, n],
             "shards": PAR_SHARDS, "levels": pamg.level_sizes,
             "device_setup_levels": damg.level_sizes,
             "cf_equal_every_level": bool(cf_equal),
             "setup_s": setup_s, "device_setup_s": dev_setup_s, **sol,
             "device_setup_iters": dev_res.iters,
             "launches_setup": setup_launches, "launches": launches,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(row_d)
    hold(not cf_equal, "distributed (d): C/F splits differ from the "
         "single-device device setup's")
    hold(abs(sol["iters"] - dev_res.iters) > 1,
         f"distributed (d): {sol['iters']} iterations, device setup "
         f"{dev_res.iters}")
    hold(sol["true_relres"] > 1e-8,
         f"distributed (d): true relres {sol['true_relres']:.3e}")
    errs = phase_ops_checks(par_ops(pamg), gen, "distributed setup "
                            f"{n}^3, {PAR_SHARDS} stacked shards")
    return {"d": row_d, "e": row_e, "errs": errs, "launches": launches}


# (f): `python tools/par_reference_counts.py card_struct 128` (the
# reference's CG + PFMG at 128^3, tol 1e-6; AMG-DD at 64^3 with one FAC
# cycle: with two it diverges from 24^3 on, in the reference too)
PAR_STRUCT_GRID = 128
PAR_SMG_GRID = 64
PAR_AMGDD_GRID = 64
REF_PAR_PFMG_CG = (128, 29)
REF_PAR_AMGDD = (64, 56)
LAP7Z = [((0, 0, 0), 6.0), ((0, 0, -1), -1.0), ((0, 0, 1), -1.0),
         ((0, -1, 0), -1.0), ((0, 1, 0), -1.0),
         ((-1, 0, 0), -1.0), ((1, 0, 0), -1.0)]


def par_cycle_comm(par, b) -> dict:
    """Exchanges and all_gathers (entries each) of one cycle."""
    comm = par.comm
    comm.exchanges, comm.all_gathers, comm.gathered = 0, 0, []
    par.cycle(b)
    torch.cuda.synchronize()
    return {"exchanges": comm.exchanges, "all_gathers": comm.all_gathers,
            "gathered_entries": list(comm.gathered),
            "sharded_levels": par.n_sharded, "levels": len(par.levels)}


def par_struct_rows(gen) -> dict:
    """(f) the z-slab struct solvers and AMG-DD on 8 stacked shards:
    CG + ParPFMG at 128^3 (the reference's count), CG + ParSMG at 32^3
    (OUT3_HELD, the reference's) and 64^3 (the single-device count),
    ParSysPFMG on the struct phase's 2 x 80^3 system (REF_G["sys"]),
    AMG-DD at 64^3 (REF_PAR_AMGDD) with one composite gather an outer
    iteration."""
    from hypre_tpu_torch.parallel.amgdd import AmgDD
    from hypre_tpu_torch.struct import SMG
    from hypre_tpu_torch.struct.par_struct import (
        ParPFMG, ParSMG, ParSysPFMG, par_struct_pcg,
    )
    from hypre_tpu_torch.struct.smg import SmgConfig

    rows = {}
    n = PAR_STRUCT_GRID
    A = struct_matrix_from_stencil((n, n, n), LAP7Z)
    par, setup_s = timed(lambda: ParPFMG(PAR_SHARDS, PfmgConfig()).setup(A))
    ones = torch.ones((n, n, n), dtype=F64, device="cuda")
    res, solve_s = timed(lambda: par_struct_pcg(par, ones, tol=1e-6,
                                                max_iter=100))
    tr = struct_true_relres(A, ones, res.x)
    rows["pfmg_cg"] = {"grid": [n, n, n], "setup_s": setup_s,
                       "solve_s": solve_s, "iters": res.iters,
                       "relres": res.relres, "true_relres": tr,
                       "slab_planes": [p.slabs.nzl if p.slabs else None
                                       for p in par.levels],
                       "per_cycle": par_cycle_comm(par, par.to_level0(
                           ones[None]))}
    hold(res.iters != REF_PAR_PFMG_CG[1] or tr > 1e-6,
         f"distributed (f) CG+ParPFMG: {res.iters} iterations (reference "
         f"{REF_PAR_PFMG_CG[1]}), true relres {tr:.3e}")
    del par, A, ones
    for m, ref in ((OUT3_HELD[0], OUT3_HELD[1]), (PAR_SMG_GRID, None)):
        A = struct_matrix_from_stencil((m, m, m), LAP7Z)
        ones = torch.ones((m, m, m), dtype=F64, device="cuda")
        ps, setup_s = timed(lambda: ParSMG(PAR_SHARDS, SmgConfig()).setup(A))
        res, solve_s = timed(lambda: par_struct_pcg(ps, ones, tol=1e-6,
                                                    max_iter=100))
        if ref is None:
            one = SMG(SmgConfig()).setup(A)
            ref = pcg(lambda v: struct_matvec(A, v), ones,
                      M=one.precondition, tol=1e-6, max_iter=100).iters
            del one
        tr = struct_true_relres(A, ones, res.x)
        rows[f"smg_cg_{m}"] = {"grid": [m, m, m], "setup_s": setup_s,
                               "solve_s": solve_s, "iters": res.iters,
                               "held_to": ref, "true_relres": tr,
                               "per_cycle": par_cycle_comm(
                                   ps, ps.to_level0(ones[None]))}
        hold(res.iters != ref or tr > 1e-6,
             f"distributed (f) CG+ParSMG at {m}^3: {res.iters} iterations, "
             f"held to {ref}; true relres {tr:.3e}")
        del ps, A, ones
    blocks = sys_coupled_system(SYS_GRID)
    ps, setup_s = timed(lambda: ParSysPFMG(PAR_SHARDS, PfmgConfig()).setup(
        blocks, 2, (SYS_GRID,) * 3))
    b = torch.ones((2,) + (SYS_GRID,) * 3, dtype=F64, device="cuda")
    (x, it, rel), solve_s = timed(lambda: ps.solve(b, tol=STRUCT_TOL))
    tr = float(torch.linalg.vector_norm(b - sys_matvec(
        ps.sys_h.levels[0], x)) / torch.linalg.vector_norm(b))
    rows["sys_pfmg"] = {"grid": [2] + [SYS_GRID] * 3, "setup_s": setup_s,
                        "solve_s": solve_s, "iters": it, "relres": rel,
                        "true_relres": tr, "held_to": REF_G["sys"][0],
                        "per_cycle": par_cycle_comm(ps, ps.to_level0(b))}
    hold(it != REF_G["sys"][0] or tr > STRUCT_TOL,
         f"distributed (f) ParSysPFMG: {it} iterations (reference "
         f"{REF_G['sys'][0]}), true relres {tr:.3e}")
    del ps, blocks, b, x
    n = PAR_AMGDD_GRID
    A = laplacian(n, n, n)
    dd, setup_s = timed(lambda: AmgDD(
        PAR_SHARDS, AmgConfig(interp_type=6, relax_type=18), padding=1,
        fac_cycles=1).setup(A))
    dd.composite_gathers = 0
    (x, it, rel), solve_s = timed(lambda: dd.solve(np.ones(A.shape[0]),
                                                   tol=1e-8, max_iter=200))
    tr = float(np.linalg.norm(1.0 - A @ x) / np.sqrt(A.shape[0]))
    rows["amgdd"] = {"grid": [n, n, n], "setup_s": setup_s,
                     "solve_s": solve_s, "iters": it, "relres": rel,
                     "true_relres": tr, "composite_gathers":
                         dd.composite_gathers,
                     "composite_sizes": [l.m for l in dd.levels],
                     "held_to": REF_PAR_AMGDD[1]}
    hold(it != REF_PAR_AMGDD[1] or dd.composite_gathers != it
         or tr > 1e-7, f"distributed (f) AMG-DD: {it} iterations (reference "
         f"{REF_PAR_AMGDD[1]}), {dd.composite_gathers} composite gathers, "
         f"true relres {tr:.3e}")
    ops = [(f"amgdd {name}{l}", getattr(lvl, name))
           for l, lvl in enumerate(dd.levels) for name in ("A", "P", "R")
           if getattr(lvl, name) is not None]
    errs = phase_ops_checks(ops, gen, f"AMG-DD {n}^3, {PAR_SHARDS} stacked "
                            "shards")
    del dd
    emit({"phase": "distributed", "row": "f", **rows})
    return {"rows": rows, "errs": errs}


def par_nccl_row() -> dict:
    """(g) the DistComm executor on a world-size-1 NCCL group: (a)'s
    V-PCG equal to the stacked run with 1 shard."""
    import socket

    import torch.distributed as dist

    from hypre_tpu_torch.parallel.comm import DistComm, StackedComm

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        A = laplacian(12, 12, 12)
        b = np.ones(A.shape[0])
        xd, itd, reld = ParBoomerAMG(DistComm(), AmgConfig()).setup(
            A).solve_pcg(b, tol=1e-8)
        xs, its, rels = ParBoomerAMG(StackedComm(1), AmgConfig()).setup(
            A).solve_pcg(b, tol=1e-8)
    finally:
        dist.destroy_process_group()
    row = {"phase": "distributed", "row": "g", "backend": "nccl",
           "world_size": 1, "iters": itd, "relres": reld,
           "stacked_1_shard_iters": its, "stacked_relres": rels,
           "x_max_abs_diff": float(np.abs(xd - xs).max())}
    emit(row)
    hold(itd != its or not np.array_equal(xd, xs),
         "distributed (g): NCCL DistComm differs from the stacked run")
    return row


def phase_distributed(gen, main_out: dict) -> dict:
    """The distributed layer on the card: (a) the dryrun analog, (b)
    ex_multichip, (c) out.14 on 8 stacked shards, (e)/(d) ParIJ and the
    distributed setup at 128^3, (f) struct and AMG-DD, (g) NCCL."""
    from hypre_tpu_torch.examples import ex_multichip

    t0 = time.perf_counter()
    set_config(Config(real_dtype=F64, device="cuda"))
    a = par_dryrun_rows()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _, it_b, rel_b = ex_multichip.main(24)
    emit({"phase": "distributed", "row": "b", "case": "ex_multichip 24^3",
          "stdout": out.getvalue().splitlines()})
    hold(rel_b > 1e-8, f"distributed (b): relres {rel_b:.3e}")
    c = par_out14(main_out, gen)
    torch.cuda.empty_cache()
    de = par_setup_rows(gen)
    torch.cuda.empty_cache()
    f = par_struct_rows(gen)
    torch.cuda.empty_cache()
    g = par_nccl_row()
    errs = {k: max(c["errs"][k], de["errs"][k], f["errs"][k])
            for k in c["errs"]}
    emit({"phase": "distributed", "run": "all",
          "wall_s": time.perf_counter() - t0})
    return {"a": a, "c": c["row"], "errs": errs,
            "launches": c["launches"], "g": g, "f": f["rows"]}



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    card = phase_device()
    phase_build()
    phase_synthetic_checks(gen)
    main_path = phase_main_path()
    k2_err = phase_hierarchy_checks(main_path["amg"], gen,
                                    "out.14 host setup")["csr_spmv"]
    timing = phase_timing(main_path["amg"], main_path["op"], card["peaks"],
                          gen)
    op = main_path["op"]
    x = torch.randn(op.n_rows, generator=gen, dtype=F64, device="cuda")
    k1_err = check_stencil(op, x)["max_abs_err"]
    del x
    profile_solve(main_path["amg"], op)
    phase_small_input()
    host_setup_s = main_path["out"]["setup_s"]
    # the device path's own memory: drop the host hierarchy first
    del main_path["amg"], main_path["op"], op
    torch.cuda.empty_cache()
    device_path = phase_device_setup(host_setup_s)
    del device_path["amg"]
    torch.cuda.empty_cache()
    phase_device_setup_parity()
    timing["btake_rows"] = phase_btake_timing(card["peaks"],
                                              device_path["launches"])
    ij_runs = phase_ij_driver()
    ij_path = f"ij -n {IJ_GRID} {IJ_GRID} {IJ_GRID} -solver 1"
    ij_errs = phase_hierarchy_checks(ij_runs["a"]["out"]["amg"], gen,
                                     ij_path)
    profile_iteration(ij_runs["a"]["out"]["amg"], ij_runs["a"]["out"]["op"],
                      ij_path)
    phase_golden_rows("solvers")
    ij_a = ij_runs["a"]["row"]
    timing["dia_matvec"] = phase_dia_timing(
        ij_runs["a"]["out"]["amg"], card["peaks"], gen,
        ij_a["launches_per_pcg_iter"]["dia_matvec"])
    del ij_runs["a"]["out"], ij_runs["b"]["out"]
    torch.cuda.empty_cache()
    breadth = phase_amg_breadth(gen)
    solvers = phase_ij_solvers(gen, card["peaks"])
    struct = phase_struct(card["peaks"], gen)
    aux = phase_maxwell(gen)
    dist = phase_distributed(gen, main_path["out"])
    aux_launches = {f"launches_maxwell_{tag}": aux[tag]["launches"]
                    for tag in ("a", "b", "c")}
    aux_per_iter = {f"launches_per_pcg_iter_maxwell_{tag}":
                    aux[tag]["launches_per_pcg_iter"]
                    for tag in ("a", "b", "c")}
    out22 = {f"launches_out22_{tag}_{when}": breadth[tag][f"launches_{when}"]
             for tag in ("a", "b") for when in ("setup", "solves")}
    kernels = []
    for name, route_src, replaces, err, launches, other in (
            # K1, K2: the out.14 host path's run (K2 also serves the ij
            # runs); K3: the ij driver's run (a); K4: the device path's
            # setup, the only path that gathers
            ("stencil_matvec", "hypre_tpu_torch/csrc/stencil_matvec.cu",
             "hypre_tpu/ops/stencil_pallas.py:123",
             max(k1_err, breadth["errs"]["stencil_matvec"]),
             main_path["launches"]["stencil_matvec"],
             {"launches_device_path": device_path["out"]["launches_solves"][
                 "stencil_matvec"]}),
            ("csr_spmv", "hypre_tpu_torch/csrc/csr_spmv.cu",
             "hypre_tpu/ops/gstell.py:719",
             max(k2_err, ij_errs["csr_spmv"], breadth["errs"]["csr_spmv"],
                 struct["errs"]["csr_spmv"], dist["errs"]["csr_spmv"]),
             main_path["launches"]["csr_spmv"],
             {"launches_device_path": device_path["out"]["launches_solves"][
                 "csr_spmv"], "launches_ij_driver_a": ij_a["launches"][
                 "csr_spmv"],
              # the distributed phase's (c): out.14 on 8 stacked shards
              "launches_distributed": dist["launches"]["csr_spmv"],
              "launches_per_pcg_iter_distributed": dist["c"][
                  "launches_per_pcg_iter"]["csr_spmv"],
              "max_abs_err_distributed": dist["errs"]["csr_spmv"],
              "max_rel_err_distributed": dist["errs"]["csr_spmv rel"]}),
            ("dia_matvec", "hypre_tpu_torch/csrc/dia_matvec.cu",
             "hypre_tpu/ops/dia_pallas.py:105",
             max(timing["dia_matvec"]["max_abs_err"],
                 ij_errs["dia_matvec"], struct["errs"]["dia_matvec"]),
             ij_a["launches"]["dia_matvec"],
             {"launches_ij_driver_b": ij_runs["b"]["row"]["launches"][
                 "dia_matvec"]}),
            ("btake_rows", "hypre_tpu_torch/csrc/btake.cu",
             "hypre_tpu/ops/btake.py:285",
             max(timing["btake_rows"]["max_abs_err"],
                 breadth["errs"]["btake_rows"]),
             device_path["launches"]["btake_rows"],
             {"launches_device_path": device_path["launches"]["btake_rows"]}),
            # K2-NV: LOBPCG's block products, the ij_solvers (b) run
            ("csr_spmm", "hypre_tpu_torch/csrc/csr_spmv.cu",
             "hypre_tpu/ops/formats.py:238", solvers["spmm_err"],
             solvers["b"]["launches"]["csr_spmm"],
             {"timed_nv": solvers["spmm_timing"]["nv"]})):
        t = timing[name] if name in timing else solvers["spmm_timing"]
        row = {
            "name": name, "route": "cuda", "source": route_src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": t["ms"], "kernel_ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "share_of_bound": t["bound_ms"] / t["kernel_ms"]}
        if "per_pcg_iter" in t:
            row["launches_per_pcg_iter"] = t["per_pcg_iter"]
        row.update(other)
        if name not in ("dia_matvec", "csr_spmm"):
            row.update({k: v[name] for k, v in out22.items()})
        if name in ("csr_spmv", "dia_matvec"):
            # the maxwell phase's (a) AMS, (b) ADS and (c) Maxwell runs;
            # ex15's B_Pi carries entries near 1e31 (the reference's ext+i
            # on the shifted, rank-deficient Pi^T A Pi), so its checks'
            # absolute errors are large at a relative error near 1e-16
            row.update({k: v[name] for k, v in aux_launches.items()})
            row.update({k: v[name] for k, v in aux_per_iter.items()})
            row["max_abs_err_maxwell"] = aux["errs"][name]
            row["max_rel_err_maxwell"] = aux["errs"][f"{name} rel"]
        kernels.append(row)
    emit({"kernels": kernels})
    emit({"phase": "done", "wall_s": time.perf_counter() - t_start})
    print(card["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card["name"],
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
