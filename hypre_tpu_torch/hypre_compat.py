"""HYPRE C-API compatibility shim.

Port of hypre_tpu/hypre_compat.py.  Maps the reference's
`HYPRE_BoomerAMGSet*` / `HYPRE_ParCSRPCG*` call surface (ref:
src/parcsr_ls/HYPRE_parcsr_amg.c, src/parcsr_ls/HYPRE_parcsr_pcg.c,
src/HYPRE.h) onto hypre_tpu_torch objects, so code written against
hypre's C API ports line-for-line:

    solver = HYPRE_BoomerAMGCreate()
    HYPRE_BoomerAMGSetStrongThreshold(solver, 0.5)
    HYPRE_BoomerAMGSetRelaxType(solver, 18)
    HYPRE_BoomerAMGSetup(solver, A, b, x)       # A: scipy CSR
    x = HYPRE_BoomerAMGSolve(solver, A, b, x)

Every setter name below is the reference's, verbatim; each writes the
corresponding AmgConfig field (see solvers/amg.py for the field-level
reference citations).  Setters whose hypre semantics have no knob here
raise KeyError loudly instead of silently accepting.

A is a scipy CSR matrix and b a host array, as in the reference; the
setup runs on the host and the solve on the configured device, and the
Solve calls return x as a host numpy array.  Two departures of the
reference are kept as they are: HYPRE_BoomerAMGGetNumIterations returns
0 (BoomerAMG keeps no last iteration count), and HYPRE_PCGSetPrecond
takes a handle or, failing that, the solve callable.  A HYPRE_* name
with no knob here raises ``UnknownSetter``, which is both the KeyError
promised above and the AttributeError that the reference's module
raises for a name it lacks.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np

from hypre_tpu_torch.solvers.amg import AmgConfig, BoomerAMG

# HYPRE setter name -> (AmgConfig field, optional value transform)
_COARSEN_NAMES = {0: "cljp", 3: "rs3", 6: "falgout", 8: "pmis",
                  10: "hmis", 21: "cgc", 22: "cgc"}
_AMG_SETTERS = {
    "HYPRE_BoomerAMGSetTol": ("_tol", None),
    "HYPRE_BoomerAMGSetMaxIter": ("_max_iter", None),
    "HYPRE_BoomerAMGSetMaxLevels": ("max_levels", None),
    "HYPRE_BoomerAMGSetMaxCoarseSize": ("max_coarse_size", None),
    "HYPRE_BoomerAMGSetStrongThreshold": ("strong_threshold", None),
    "HYPRE_BoomerAMGSetMaxRowSum": ("max_row_sum", None),
    "HYPRE_BoomerAMGSetCoarsenType": (
        "coarsen_type", lambda v: _COARSEN_NAMES.get(int(v), "pmis")),
    "HYPRE_BoomerAMGSetInterpType": ("interp_type", int),
    "HYPRE_BoomerAMGSetTruncFactor": ("trunc_factor", None),
    "HYPRE_BoomerAMGSetPMaxElmts": ("p_max_elmts", int),
    "HYPRE_BoomerAMGSetRelaxType": ("relax_type", int),
    "HYPRE_BoomerAMGSetRelaxWt": ("relax_weight", None),
    "HYPRE_BoomerAMGSetNumSweeps": ("num_sweeps", int),
    "HYPRE_BoomerAMGSetRelaxOrder": ("relax_order", int),
    "HYPRE_BoomerAMGSetCycleType": (
        "cycle_type", lambda v: {1: "V", 2: "W"}.get(int(v), "V")),
    "HYPRE_BoomerAMGSetAggNumLevels": ("agg_num_levels", int),
    "HYPRE_BoomerAMGSetAggInterpType": ("agg_interp_type", int),
    "HYPRE_BoomerAMGSetAggTruncFactor": ("agg_trunc_factor", None),
    "HYPRE_BoomerAMGSetAggPMaxElmts": ("agg_p_max_elmts", int),
    "HYPRE_BoomerAMGSetAggP12TruncFactor": (
        "agg_p12_trunc_factor", None),
    "HYPRE_BoomerAMGSetAggP12MaxElmts": ("agg_p12_max_elmts", int),
    "HYPRE_BoomerAMGSetNumPaths": ("num_paths", int),
    "HYPRE_BoomerAMGSetRestriction": ("restr_type", int),
    "HYPRE_BoomerAMGSetAdditive": ("additive", int),
    "HYPRE_BoomerAMGSetSimple": ("simple", int),
    "HYPRE_BoomerAMGSetAddLastLvl": ("add_last_lvl", int),
    "HYPRE_BoomerAMGSetSeed": ("seed", int),
    "HYPRE_BoomerAMGSetChebyOrder": ("cheby_order", int),
    "HYPRE_BoomerAMGSetChebyFraction": ("cheby_fraction", None),
    "HYPRE_BoomerAMGSetChebyEigEst": ("cheby_eig_iters", int),
    "HYPRE_BoomerAMGSetGSMG": ("gsmg", int),
    "HYPRE_BoomerAMGSetNumSamples": ("num_samples", int),
    "HYPRE_BoomerAMGSetNumFunctions": ("num_functions", int),
    "HYPRE_BoomerAMGSetNodal": ("nodal", int),
    "HYPRE_BoomerAMGSetNodalDiag": ("nodal_diag", int),
    "HYPRE_BoomerAMGSetDofFunc": ("dof_func", np.asarray),
    "HYPRE_BoomerAMGSetPrintLevel": ("print_level", int),
}


class _AmgHandle:
    """The HYPRE_Solver handle: config fields + solve-phase knobs."""

    def __init__(self):
        self.fields = {}
        self._tol = 1e-7          # HYPRE_BoomerAMGSetTol default
        self._max_iter = 20       # par_amg.c default as a solver
        self.amg: BoomerAMG | None = None

    def config(self) -> AmgConfig:
        valid = {f.name for f in dataclasses.fields(AmgConfig)}
        return AmgConfig(**{k: v for k, v in self.fields.items()
                            if k in valid})


def HYPRE_BoomerAMGCreate() -> _AmgHandle:
    return _AmgHandle()


def HYPRE_BoomerAMGDestroy(solver: _AmgHandle):
    solver.amg = None
    return 0


def HYPRE_BoomerAMGSetup(solver: _AmgHandle, A, b=None, x=None):
    solver.amg = BoomerAMG(solver.config()).setup(A)
    return 0


def HYPRE_BoomerAMGSolve(solver: _AmgHandle, A, b, x=None):
    xr, _, _ = solver.amg.solve(np.asarray(b), x0=x,
                                tol=solver._tol,
                                max_iter=solver._max_iter)
    return xr.cpu().numpy()


def HYPRE_BoomerAMGGetNumIterations(solver: _AmgHandle):
    return getattr(solver.amg, "last_iters", 0)


def _make_setter(hname, field, xform):
    def setter(solver: _AmgHandle, value):
        v = xform(value) if xform else value
        if field.startswith("_"):
            setattr(solver, field, v)
        else:
            solver.fields[field] = v
        return 0
    setter.__name__ = hname
    return setter


class UnknownSetter(KeyError, AttributeError):
    """A HYPRE_* call that has no knob in this shim."""


def __getattr__(name: str):
    if name.startswith("HYPRE_"):
        raise UnknownSetter(f"{name}: hypre_tpu_torch has no knob for it")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


_mod = sys.modules[__name__]
for _hname, (_field, _xf) in _AMG_SETTERS.items():
    setattr(_mod, _hname, _make_setter(_hname, _field, _xf))


# -- ParCSR Krylov surface (HYPRE_parcsr_pcg.c / _gmres.c) -----------

class _KrylovHandle:
    def __init__(self, kind):
        self.kind = kind
        self.tol = 1e-8
        self.max_iter = 1000
        self.k_dim = 5
        self.precond = None       # (_AmgHandle) or callable
        self.num_iterations = 0
        self.final_rel_res = 0.0


def HYPRE_ParCSRPCGCreate(comm=None) -> _KrylovHandle:
    return _KrylovHandle("pcg")


def HYPRE_ParCSRGMRESCreate(comm=None) -> _KrylovHandle:
    return _KrylovHandle("gmres")


def HYPRE_PCGSetTol(s, v):
    s.tol = float(v)
    return 0


def HYPRE_PCGSetMaxIter(s, v):
    s.max_iter = int(v)
    return 0


HYPRE_GMRESSetTol = HYPRE_PCGSetTol
HYPRE_GMRESSetMaxIter = HYPRE_PCGSetMaxIter


def HYPRE_GMRESSetKDim(s, v):
    s.k_dim = int(v)
    return 0


def HYPRE_PCGSetPrecond(s, solve_fn=None, setup_fn=None,
                        precond_handle=None):
    s.precond = precond_handle if precond_handle is not None \
        else solve_fn
    return 0


HYPRE_GMRESSetPrecond = HYPRE_PCGSetPrecond


def _solve_krylov(s: _KrylovHandle, A, b, x=None):
    from hypre_tpu_torch.ops.formats import sparse_op_from_scipy
    from hypre_tpu_torch.solvers.krylov import pcg
    from hypre_tpu_torch.solvers.krylov_more import gmres

    op = sparse_op_from_scipy(A)
    M = None
    if isinstance(s.precond, _AmgHandle):
        if s.precond.amg is None:
            HYPRE_BoomerAMGSetup(s.precond, A)
        M = s.precond.amg
    elif s.precond is not None:
        M = s.precond
    if s.kind == "pcg":
        res = pcg(op, np.asarray(b), x0=x, M=M, tol=s.tol,
                  max_iter=s.max_iter)
    else:
        res = gmres(op, np.asarray(b), x0=x, M=M, tol=s.tol,
                    max_iter=s.max_iter, k_dim=s.k_dim)
    s.num_iterations = int(res.iters)
    s.final_rel_res = float(res.relres)
    return res.x.cpu().numpy()


def HYPRE_ParCSRPCGSetup(s, A, b=None, x=None):
    s._A = A
    return 0


HYPRE_ParCSRGMRESSetup = HYPRE_ParCSRPCGSetup


def HYPRE_ParCSRPCGSolve(s, A, b, x=None):
    return _solve_krylov(s, A, b, x)


HYPRE_ParCSRGMRESSolve = HYPRE_ParCSRPCGSolve


def HYPRE_PCGGetNumIterations(s):
    return s.num_iterations


def HYPRE_PCGGetFinalRelativeResidualNorm(s):
    return s.final_rel_res


HYPRE_GMRESGetNumIterations = HYPRE_PCGGetNumIterations
HYPRE_GMRESGetFinalRelativeResidualNorm = \
    HYPRE_PCGGetFinalRelativeResidualNorm
